"""Build and load the port's CUDA kernels (``miniworld_tpu_torch/csrc``).

The three render kernels are compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with ``ctypes``: a build of seconds, with no PyTorch headers.
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; the wrappers in render/raycast.py raise when it
is not 0.

The library lands in ``build/kernels/`` at the repository root (listed
in .gitignore), or in ``$MINIWORLD_TORCH_BUILD_DIR``; its file name
carries a hash of the sources and flags, so an edit rebuilds. A failed
build raises: there is no fallback to the plain versions on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
SOURCES = ("tri_pass.cu", "entity_pass.cu", "pixel_epilogue.cu")
# -fmad=false: no multiply-add contraction, so every hit-test boundary
# (u >= 0, cov <= det, the r gates, the slab ties) rounds exactly as
# the plain PyTorch version does and winners agree pixel for pixel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_CAM = [_P] * 7  # origin, fwd, right, up, tan_xy, xbase, ybase
ENTRY_POINTS = {
    # verts9, attr, layout_id, camera, B, S, W, H, all_quads, t, attr_out, stream
    "mw_tri_pass": [_P, _P, _P, *_CAM, _I, _I, _I, _I, _I, _P, _P, _P],
    # ent_pos, ent_size, ent_dir, ent_height, ent_color, flags, camera,
    # B, E, W, H, has_sphere, has_box, t, col, nrm, stream
    "mw_entity_pass": [_P] * 6 + _CAM + [_I] * 6 + [_P, _P, _P, _P],
    # t_tri, attr, t_ent, col_ent, n_ent, atlas, lights, camera,
    # B, W, H, A, K, has_ent, rgb, depth, stream
    "mw_pixel_epilogue": [_P] * 7 + _CAM + [_I] * 6 + [_P, _P, _P],
}

_LIB = None
BUILD_INFO: dict = {}


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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (raises if it cannot be)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"libminiworld_kernels_{_digest()}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[os.path.join(CSRC_DIR, s) for s in SOURCES]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mw_error_string.argtypes = [ctypes.c_int]
    lib.mw_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(path=lib_path, seconds=time.perf_counter() - t0, log=log)
    _LIB = lib
    return lib


def error_string(err: int) -> str:
    return load().mw_error_string(err).decode()
