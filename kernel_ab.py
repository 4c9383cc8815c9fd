"""Kernel times of other libraries beside this tree's, on one card.

    python3 kernel_ab.py [--unequal] OTHER_CSRC [OTHER_CSRC ...]

Builds the render kernels (tri_pass.cu, entity_pass.cu,
pixel_epilogue.cu, topview_epilogue.cu, tri_pass_ortho.cu) from each
other directory of sources (another commit's miniworld_tpu_torch/csrc,
or a copy of this one with a constant changed), then times each kernel
at the main paths' shapes chip_smoke.py times them at, in the order this
tree, the others, the others reversed, this tree (CUDA events, 30
launches after chip_smoke.py's warm-up), and holds every other
library's result equal to this one's. The inputs come
from this tree's package; the other sources' C entry points must take
the same arguments (tri_pass_ortho's its tile lists at the other
source's TILE_W x TILE_H, read from its #defines). Prints each build's
spilling kernels and the registers of the kernels it redesigned, one
[ab] line a case and other library, and the card's nvidia-smi name and
power limit; exits non-zero on a difference, or without a CUDA card.
With --unequal it times the other builds whatever they return and prints
equal=False where they differ: an ablation (a copy with one stage taken
out) says what that stage costs.
"""

from __future__ import annotations

import os
import re
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("tri_pass.cu", "entity_pass.cu", "pixel_epilogue.cu", "tri_pass_ortho.cu",
           "topview_epilogue.cu")


def main(other_dirs, unequal=False):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from miniworld_tpu_torch import MiniWorldVec
    from miniworld_tpu_torch.render import cuda_build, raycast as rc
    from miniworld_tpu_torch.render import topview as tv

    smi = cs.phase_device()
    t0 = time.perf_counter()
    cuda_build.load()
    log = os.path.join(cuda_build.build_dir(), "kernel_build.log")  # chip_smoke's copy
    if not cuda_build.BUILD_INFO.get("log") and os.path.exists(log):
        with open(log) as f:
            cuda_build.BUILD_INFO["log"] = f.read()
    say_ptxas("this", cuda_build.BUILD_INFO.get("log", ""))
    here, others, tiles = cuda_build.CSRC_DIR, [], []
    try:
        for d in other_dirs:
            cuda_build.CSRC_DIR = os.path.abspath(d)
            lib, info = cuda_build.build((), SOURCES)
            others.append(lib)
            tiles.append(ortho_tile(d))
            say_ptxas(d, info["log"])
    finally:
        cuda_build.CSRC_DIR = here
    cs.say("ab-build", seconds=f"{time.perf_counter() - t0:.1f}", others=",".join(other_dirs))

    def ab(label, run, other_run=None):
        """Times ``run`` through each library; ``other_run(i)`` is the
        call for other library i where its inputs differ."""
        ref = run()
        order = [None, *range(len(others)), *reversed(range(len(others))), None]
        times, equal = {i: [] for i in order}, {}
        for i in order:
            if i is None:
                times[i].append(cs.cuda_ms(run, 30))
                continue
            fn = run if other_run is None else (lambda i=i: other_run(i))
            with cuda_build.library(others[i]):
                out = fn()
                equal[i] = all(torch.equal(a, b) for a, b in zip(out, ref))
                if not (equal[i] or unequal):
                    raise AssertionError(f"{label}: {other_dirs[i]}'s result differs")
                times[i].append(cs.cuda_ms(fn, 30))
        for i, d in enumerate(other_dirs):
            cs.say("ab", case=label, other=d, this_ms=",".join(f"{t:.4f}" for t in times[None]),
                   other_ms=",".join(f"{t:.4f}" for t in times[i]), equal=equal[i])

    w, h = cs.W, cs.H

    def env(env_id, n, **kw):
        return MiniWorldVec(env_id, n, obs_width=w, obs_height=h, device="cuda", **kw)

    def epi_args(e, state, ss, nearest=False):
        cam = rc.camera_grid(state, w * ss, h * ss)
        rows, paired = rc.static_rows(e._bank, state, cam, e._pg_wall, e.plan)
        mesh = (rc.entity_mesh_rows(e._bank, state, fourier=not nearest)[:2]
                if e._shapes_present[2] else None)
        carry = rc.attr_carry_dtype(state.tex_map.shape[1]) if nearest else torch.bfloat16
        t_tri, attr = rc.tri_pass(*rows, cam, e._all_quads, mesh, paired, e.tri_chunk, None,
                                  carry)
        ent = (None,) * 3
        if e._shapes_present[0] or e._shapes_present[1]:
            ent = rc.entity_pass(state.ent_pos, state.ent_size, state.ent_dir,
                                 state.ent_height, state.ent_color,
                                 rc.entity_flags(e._bank, state), cam, *e._shapes_present[:2])
        return (t_tri, attr, *ent, e._atlas, cam, state.light_pos, state.light_color,
                state.light_ambient, state.sky_color, e.fourier_k)

    gen = torch.Generator().manual_seed(2468)
    # tri_pass: the multi-chunk kernel (Sidewalk, 3 chunks; the Maze's
    # paired bank at supersample=2, 2 chunks of 496), the single chunk
    side = env(cs.SIDE_ID, cs.B)
    st = cs.spread_states(side, gen, (-2.5, 0.5), (5.5, 11.5))
    tri = (side._bank.tri_verts9, side._bank.tri_attr, st.layout_id,
           rc.camera_grid(st, w, h), side._all_quads)
    ab(f"tri_pass multi {cs.SIDE_ID} B={cs.B}", lambda: rc.tri_pass(*tri, None, None, 1024))
    maze_ss = env(cs.MAZE_ID, cs.B_MAZE, supersample=2)
    ms_state = cs.random_maze_states(maze_ss, gen)
    bank = maze_ss._bank
    cam2 = rc.camera_grid(ms_state, 2 * w, 2 * h)
    tri2 = (bank.pg_verts9, bank.pg_attr, ms_state.layout_id, cam2, maze_ss._all_quads)
    paired = (bank.pg_verts9_alt, bank.pg_attr_alt, maze_ss._pg_wall, ms_state.wall_open)
    ab(f"tri_pass multi paired {cs.MAZE_ID} ss=2 B={cs.B_MAZE}",
       lambda: rc.tri_pass(*tri2, None, paired, maze_ss.tri_chunk))
    maze = env(cs.MAZE_ID, cs.B_MAZE)
    m_state = cs.random_maze_states(maze, gen)
    cam1 = rc.camera_grid(m_state, w, h)
    tri1 = (maze._bank.pg_verts9, maze._bank.pg_attr, m_state.layout_id, cam1, maze._all_quads)
    paired1 = (maze._bank.pg_verts9_alt, maze._bank.pg_attr_alt, maze._pg_wall,
               m_state.wall_open)
    ab(f"tri_pass single paired {cs.MAZE_ID} B={cs.B_MAZE}",
       lambda: rc.tri_pass(*tri1, None, paired1))
    # entity_pass and the epilogue's instances
    args = epi_args(maze_ss, ms_state, 2)
    ab(f"entity_pass {cs.MAZE_ID} ss=2 B={cs.B_MAZE}",
       lambda: rc.entity_pass(ms_state.ent_pos, ms_state.ent_size, ms_state.ent_dir,
                              ms_state.ent_height, ms_state.ent_color,
                              rc.entity_flags(bank, ms_state), cam2,
                              *maze_ss._shapes_present[:2]))
    ab(f"pixel_epilogue SS=2 {cs.MAZE_ID} B={cs.B_MAZE}",
       lambda: rc.pixel_epilogue(*args, table=maze_ss._fourier_table, ss=2))
    pick_ss = env(cs.PICK_ID, cs.B_PICK, supersample=2)
    p_args = epi_args(pick_ss, cs.facing_states(pick_ss, gen, (0.5, 0.5), (11.5, 11.5)), 2)
    ab(f"pixel_epilogue SS=2 {cs.PICK_ID} B={cs.B_PICK}",
       lambda: rc.pixel_epilogue(*p_args, table=pick_ss._fourier_table, ss=2))
    hall_ss = env(cs.ENV_ID, cs.B, supersample=2)
    h_args = epi_args(hall_ss, cs.spread_states(hall_ss, gen, (-0.5, -1.5), (10.5, 1.5)), 2)
    ab(f"pixel_epilogue SS=2 {cs.ENV_ID} B={cs.B}",
       lambda: rc.pixel_epilogue(*h_args, table=hall_ss._fourier_table, ss=2))
    sign = env(cs.SIGN_ID, cs.B)
    s_state = cs.sign_states(sign, gen)
    for ss in (1, 2):
        s_args = epi_args(sign, s_state, ss)
        ab(f"pixel_epilogue GAIN SS={ss} {cs.SIGN_ID} B={cs.B}",
           lambda s_args=s_args, ss=ss: rc.pixel_epilogue(*s_args, True,
                                                          table=sign._fourier_table, ss=ss))
    m_args = epi_args(maze, m_state, 1)
    ab(f"pixel_epilogue SS=1 {cs.MAZE_ID} B={cs.B_MAZE}",
       lambda: rc.pixel_epilogue(*m_args, table=maze._fourier_table))
    sw_args = epi_args(side, st, 1)
    ab(f"pixel_epilogue SS=1 {cs.SIDE_ID} B={cs.B}",
       lambda: rc.pixel_epilogue(*sw_args, table=side._fourier_table))
    pick = env(cs.PICK_ID, cs.B_PICK)
    pk_args = epi_args(pick, cs.facing_states(pick, gen, (0.5, 0.5), (11.5, 11.5)), 1)
    ab(f"pixel_epilogue SS=1 {cs.PICK_ID} B={cs.B_PICK}",
       lambda: rc.pixel_epilogue(*pk_args, table=pick._fourier_table))
    maze_n = env(cs.MAZE_ID, cs.B_MAZE, tex_mode="nearest")
    n_state = cs.random_maze_states(maze_n, gen)
    n_args = epi_args(maze_n, n_state, 1, nearest=True)
    ab(f"pixel_epilogue NEAREST F32 {cs.MAZE_ID} B={cs.B_MAZE}",
       lambda: rc.pixel_epilogue(*n_args, tex_map=n_state.tex_map))
    maze_top = env(cs.MAZE_ID, cs.B_MAZE, view="top")
    scan, _, top_epi, _ = cs.top_stage_check(f"{cs.MAZE_ID} top B={cs.B_MAZE}", maze_top,
                                             cs.view_states(maze_top, gen))
    st_other = {t: tv.top_statics(maze_top._bank, w, h, device="cuda", tile=t)
                for t in set(tiles)}
    ab(f"tri_pass_ortho {cs.MAZE_ID} B={cs.B_MAZE}", lambda: tv.tri_pass_ortho(*scan),
       lambda i: tv.tri_pass_ortho(st_other[tiles[i]], *scan[1:]))
    ab(f"topview_epilogue {cs.MAZE_ID} B={cs.B_MAZE}",
       lambda: tv.topview_epilogue(*top_epi, table=maze_top._fourier_table))
    print(smi)


def ortho_tile(csrc):
    """(TILE_W, TILE_H) of tri_pass_ortho.cu in the sources at ``csrc``."""
    with open(os.path.join(csrc, "tri_pass_ortho.cu")) as f:
        text = f.read()
    return tuple(int(re.search(rf"#define {k} (\d+)", text).group(1))
                 for k in ("TILE_W", "TILE_H"))


def say_ptxas(build, log):
    """One [ab-build] line: the build's spilling kernels and the registers
    of the redesigned ones (the multi-chunk tri_pass, the top view's two,
    the SS=2 epilogue), from its ptxas -v log."""
    import chip_smoke as cs

    fn, spills, regs = "", [], []
    for ln in log.splitlines():
        fn = ln.split("'")[1] if "Compiling entry" in ln else fn
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and m.group(1, 2) != ("0", "0"):
            spills.append(f"{fn}: {ln.strip()}")
        r = re.search(r"Used (\d+) registers", ln)
        if r and any(k in fn for k in ("tri_pass_multi", "tri_pass_ortho", "topview_epilogue",
                                        "pixel_epilogue_ss2")):
            regs.append(f"{fn}: {r.group(1)}")
    cs.say("ab-build", build=build, spills=repr(" | ".join(spills)),
           registers=repr(" | ".join(regs)))


if __name__ == "__main__":
    args = sys.argv[1:]
    flag = "--unequal" in args
    dirs = [a for a in args if a != "--unequal"]
    if not dirs:
        raise SystemExit(__doc__)
    main(dirs, flag)
