"""Build and load the port's CUDA kernels (``miniworld_tpu_torch/csrc``).

The kernels (the render's stages, the mesh entities' rows, and the
reset's maze generation and placement) are compiled at first use with
``nvcc`` for Hopper (``sm_90a``), one nvcc process per source, all
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``: a build of seconds, with no PyTorch
headers.
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when it is not 0, and counts
the launch in ``LAUNCHES``. The wrappers (render/raycast.py,
render/topview.py, render/visibility.py, ops/place.py, ops/mazegen.py)
launch through it.

The library lands in ``build/kernels/`` at the repository root (listed
in .gitignore), or in ``$MINIWORLD_TORCH_BUILD_DIR``; its file name
carries a hash of the sources and flags, so an edit rebuilds. A failed
build raises: there is no fallback to the plain versions on the card.
``build`` also makes variants with other compile-time constants (nvcc
``-D`` defines, e.g. tri_pass.cu's tile), which ``library`` puts in
place of the default one for a measurement.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
SOURCES = ("tri_pass.cu", "entity_pass.cu", "pixel_epilogue.cu", "place.cu", "mazegen.cu",
           "tri_pass_ortho.cu", "topview_epilogue.cu", "visible_ents.cu", "mesh_rows.cu")
# included by the sources; part of the build's hash
HEADERS = ("rng.cuh", "texel.cuh", "maze_row.cuh")
# -fmad=false: no multiply-add contraction, so every hit-test boundary
# (u >= 0, cov <= det, the r gates, the slab ties) rounds exactly as
# the plain PyTorch version does and winners agree pixel for pixel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_CAM = [_P] * 7  # origin, fwd, right, up, tan_xy, xbase, ybase
ENTRY_POINTS = {
    # verts9, attr, layout_id, camera, mesh_v9, mesh_attr, verts9_alt,
    # attr_alt, pg_wall, wall_open, slot_key, slot_tex, slot_tex_alt,
    # row_code, B, S, N, W, H, n_walls, all_quads, tri_chunk, n_sched, f32,
    # t, attr_out, stream, n_live (last: a library built without it takes
    # the same list and ignores it)
    "mw_tri_pass": [_P, _P, _P, *_CAM, _P] + [_P] * 9 + [_I] * 10 + [_P, _P, _P, _I],
    # out: TILE_W, TILE_H, PIX_PER_THREAD
    "mw_tri_pass_config": [_P],
    # ent_pos, ent_size, ent_dir, ent_height, ent_color, flags, camera,
    # B, E, W, H, has_sphere, has_box, t, col, nrm, stream
    "mw_entity_pass": [_P] * 6 + _CAM + [_I] * 6 + [_P, _P, _P, _P],
    # t_tri, attr, t_ent, col_ent, n_ent, fourier table, u8 atlas,
    # tex_map, lights, camera, B, W, H (the samples' image), A, K,
    # has_ent, ss, gain, nearest, f32, T, R, rgb, depth, stream
    "mw_pixel_epilogue": [_P] * 9 + _CAM + [_I] * 12 + [_P, _P, _P],
    # seeds, layout_id, 6 rule rows, radius, slot_mask, 7 room tensors,
    # room_weight, room_seg_wall, wall_open, B, E, R, V, NS, W, budget,
    # ent_pos, ent_dir, agent_pos, agent_dir, stream
    "mw_place": [_P] * 20 + [_I] * 7 + [_P] * 5,
    # seeds, layout_id, 6 rule rows, radius, obstacle xz, radius and mask,
    # 7 room tensors, room_weight, room_seg_wall, wall_open, B, O, R, V,
    # NS, W, budget, pos, dir, stream
    "mw_place_one": [_P] * 22 + [_I] * 7 + [_P] * 3,
    # seeds, nbr_cell, nbr_wall, B, N, W, walls, stream
    "mw_mazegen": [_P, _P, _P, _I, _I, _I, _P, _P],
    # rows, row_id, row_code, tile_off, tile_rows, xs, zs, layout_id,
    # wall_open, B, Sc, W, H, NW, t, row, stream
    "mw_tri_pass_ortho": [_P] * 9 + [_I] * 5 + [_P] * 3,
    # t_tri, row, bank_attr, layout_id, xs, zs, 6 entity tensors, table,
    # atlas, tex_map, lights, marker, B, W, H, S, E, A, K, gain, nearest,
    # T, R, rgb, depth, stream
    "mw_topview_epilogue": [_P] * 17 + [_I] * 11 + [_P] * 3,
    # rows, row_code, layout_id, wall_open, camera, ent_pos, ent_alive, B,
    # Sr, E, W, H, NW, visible, stream
    "mw_visible_ents": [_P] * 4 + _CAM + [_P] * 2 + [_I] * 6 + [_P] * 2,
    # the same, then stats (6 u64: envs staged, pairs kept, slab tests,
    # occlusion scans, rows scanned, rows staged), stream
    "mw_visible_ents_stats": [_P] * 4 + _CAM + [_P] * 2 + [_I] * 6 + [_P] * 3,
    # proto_mesh, proto_mesh_mask, proto_shape, proto_static, proto_height,
    # proto_colorable, tex_slot_base, layout_id, ent_proto, ent_alive,
    # ent_height, ent_dir, ent_pos, ent_color, B, E, L, P, M, T, lid64,
    # fourier, verts9, attrs, valid, stream
    "mw_entity_mesh_rows": [_P] * 14 + [_I] * 8 + [_P] * 4,
}

_LIB = None
BUILD_INFO: dict = {}

# Kernel launches per wrapper — the render's stages and the reset's
# maze generation and placement; chip_smoke.py reads them to show that a
# run went through the kernels. Only ``launch`` increments. The mesh
# pass runs inside the tri_pass launch: a launch with mesh rows counts
# under both names; so does a tri_pass launch with the texture-variant
# override ("tri_pass_override"), a tri_pass launch over more than one
# chunk, the multi-chunk kernel's ("tri_pass_multi"), over a paired
# procgen bank also "tri_pass_paired_chunks", a
# tri_pass launch over each env's schedule of chunks ("tri_pass_sched"), a
# tri_pass launch with the float32 attribute carry ("tri_pass_f32"), a
# tri_pass launch over a procgen super bank's dense rows, each env's
# killed by its maze ("tri_pass_active"), and a pixel_epilogue launch of its supersample=2 instance
# ("pixel_epilogue_ss2"), of its glyph instance ("pixel_epilogue_gain"),
# of its nearest-texture instance ("pixel_epilogue_nearest") or reading
# the float32 carry ("pixel_epilogue_f32"). The top view's kernels
# (render/topview.py) count under "tri_pass_ortho" and "topview_epilogue"
# (its nearest-texture instance also under "topview_epilogue_nearest"),
# the visibility query (render/visibility.py) under "visible_ents", the
# in-step placement (CollectHealth's respawn, ops/place.place_one) under
# "place_one", the mesh entities' world-space rows (render/raycast.
# entity_mesh_rows) under "entity_mesh_rows".
LAUNCHES = {"tri_pass": 0, "entity_pass": 0, "pixel_epilogue": 0,
            "entity_mesh_pass": 0, "place": 0, "mazegen": 0,
            "tri_pass_override": 0, "pixel_epilogue_ss2": 0,
            "tri_pass_paired_chunks": 0, "tri_pass_sched": 0, "pixel_epilogue_gain": 0,
            "tri_pass_f32": 0, "pixel_epilogue_nearest": 0, "pixel_epilogue_f32": 0,
            "tri_pass_ortho": 0, "topview_epilogue": 0, "topview_epilogue_nearest": 0,
            "visible_ents": 0, "tri_pass_multi": 0, "place_one": 0, "entity_mesh_rows": 0,
            "tri_pass_active": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> str:
    return os.environ.get(
        "MINIWORLD_TORCH_BUILD_DIR",
        os.path.join(os.path.dirname(_PKG), "build", "kernels"),
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the miniworld_tpu_torch kernels")


def _digest(defines, sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for name in sources + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(defines: tuple = (), sources: tuple = SOURCES):
    """(library, build info) of ``sources`` compiled with the extra nvcc
    ``defines`` ("-DNAME=VALUE"), built unless an equal build exists
    (raises if it cannot be). Argument types are set for every entry
    point the library exports."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"libminiworld_kernels_{_digest(defines, sources)}.so")
    flags = NVCC_FLAGS + tuple(defines)
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(lib_path):
        nvcc = _nvcc()
        tmp = f"{lib_path}.{os.getpid()}"
        objs = [f"{tmp}.{os.path.splitext(name)[0]}.o" for name in sources]
        procs = [
            subprocess.Popen([nvcc, *flags, "-c", "-o", obj, os.path.join(CSRC_DIR, name)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(sources, objs)
        ]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        failed = [name for name, proc in zip(sources, procs) if proc.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}.tmp", *objs],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = ["link"]
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(f"{tmp}.tmp", lib_path)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in ENTRY_POINTS.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.mw_error_string.argtypes = [ctypes.c_int]
    lib.mw_error_string.restype = ctypes.c_char_p
    return lib, dict(path=lib_path, seconds=time.perf_counter() - t0, log=log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (raises if it cannot be)."""
    global _LIB
    if _LIB is None:
        _LIB, info = build()
        BUILD_INFO.update(info)
    return _LIB


@contextlib.contextmanager
def library(lib: ctypes.CDLL):
    """Launch through ``lib`` (a ``build`` with other defines) inside the
    block, through the default library again after it."""
    global _LIB
    saved, _LIB = load(), lib
    try:
        yield
    finally:
        _LIB = saved


def error_string(err: int) -> str:
    return load().mw_error_string(err).decode()


def is_cuda(*tensors) -> bool:
    """True when every tensor is on the card, False when every one is on
    the CPU (the wrapper then takes its plain version); raises on a mix."""
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed devices: {sorted(devs)}")


def check(t: torch.Tensor, name: str, dtype, shape):
    """Pointer to ``t`` after checking its dtype, shape and layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return ctypes.c_void_p(t.data_ptr())


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def launch(entry: str, counters, *args):
    """Launch ``entry`` of the kernel library; on success add one to
    ``LAUNCHES[c]`` for ``counters``, a name or a tuple of names."""
    err = getattr(load(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} ({error_string(err)})")
    for c in (counters,) if isinstance(counters, str) else counters:
        LAUNCHES[c] += 1
