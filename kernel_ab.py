"""Kernel times of other libraries beside this tree's, on one card.

    python3 kernel_ab.py [--unequal] [--visible-ents | --tri-pass] OTHER_CSRC [OTHER_CSRC ...]

Builds the kernel library from each other directory of sources
(another commit's miniworld_tpu_torch/csrc, or a copy of this one with a
constant changed), then times visible_ents (PickupObjects B=4096 and the
8x8 procgen Maze B=8192 at chip_smoke.py's [visible-ents] states, and its
worst case: each Maze box just behind a closed wall, close enough to
fill much of the view; with --visible-ents nothing else), the render
kernels, entity_pass, the mesh rows (CollectHealth B=1024) and mazegen
at the main paths' shapes chip_smoke.py times them at, in the order this
tree, the others, the others reversed, this tree (CUDA events, 30
launches after chip_smoke.py's warm-up; for visible_ents, entity_pass,
the mesh rows and mazegen, whose wrappers' host work can outlast the
kernel, also the kernel alone under torch.profiler, device_ms), and
holds every other library's result equal to this one's (entity_pass's
colour and normal where its t is finite: the only part its contract
defines). The inputs come from this tree's package; the other sources'
C entry points must take the same arguments (tri_pass_ortho's its tile
lists at the other source's TILE_W x TILE_H, read from its #defines).
Prints each build's spilling kernels, the registers of the kernels it
redesigned and the stack frames of mazegen's instances, one [ab] line a
case and other library, and the card's nvidia-smi name and power limit;
exits non-zero on a difference, or without a CUDA card. Last, the Maze
8x8 procgen main paths at B=8192 (80x60, and supersample=2) run through
each library in the same order: chip_smoke.py's rollouts ([main-path]
env-steps/s) and profile (device busy a step), the same Python driving
each library's kernels.
With --unequal it times the other builds whatever they return and prints
equal=False where they differ: an ablation (a copy with one stage taken
out) says what that stage costs. With --tri-pass it times tri_pass alone
(tri_pass_cases): every float32-carry and ACTIVE instance at chip_smoke.py's
[f32-dense] shapes, each beside the same launch in the bf16 carry on the
same inputs, and the bf16 one-chunk, paired and multi-chunk launches
(~3 min on an H100 with three other builds, most of it their builds and the
envs' banks).
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(other_dirs, unequal=False, vis_only=False, tri_only=False):
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
            lib, info = cuda_build.build()
            others.append(lib)
            tiles.append(ortho_tile(d))
            say_ptxas(d, info["log"])
    finally:
        cuda_build.CSRC_DIR = here
    cs.say("ab-build", seconds=f"{time.perf_counter() - t0:.1f}", others=",".join(other_dirs))

    def all_equal(out, ref):
        return all(torch.equal(a, b) for a, b in zip(out, ref))

    def ent_equal(out, ref):  # t everywhere, colour and normal where t is finite
        hit = torch.isfinite(ref[0])
        return torch.equal(out[0], ref[0]) and all(
            torch.equal(a[hit], b[hit]) for a, b in zip(out[1:], ref[1:]))

    def ab(label, run, other_run=None, same=all_equal, kernel=None):
        """Times ``run`` through each library; ``other_run(i)`` is the
        call for other library i where its inputs differ; ``same(out,
        ref)`` says whether another library's result equals this one's.
        With ``kernel`` (a kernel's name) also the device time of that
        kernel alone (torch.profiler; the events' time includes the
        wrapper's host work where the host is the slower side)."""
        ref = run()
        order = [None, *range(len(others)), *reversed(range(len(others))), None]
        times, dev, equal = {i: [] for i in order}, {i: [] for i in order}, {}

        def timed(i, fn):
            times[i].append(cs.cuda_ms(fn, 30))
            if kernel is not None:
                dev[i].append(cs.kernel_ms(fn, 30, kernel))

        for i in order:
            if i is None:
                timed(i, run)
                continue
            fn = run if other_run is None else (lambda i=i: other_run(i))
            with cuda_build.library(others[i]):
                out = fn()
                equal[i] = same(out if isinstance(out, tuple) else (out,),
                                ref if isinstance(ref, tuple) else (ref,))
                if not (equal[i] or unequal):
                    raise AssertionError(f"{label}: {other_dirs[i]}'s result differs")
                timed(i, fn)

        def fmt(ts):
            return ",".join(cs.fmt_ms(t) for t in ts)

        for i, d in enumerate(other_dirs):
            extra = ({"this_device_ms": fmt(dev[None]), "other_device_ms": fmt(dev[i])}
                     if kernel is not None else {})
            cs.say("ab", case=label, other=d, this_ms=fmt(times[None]),
                   other_ms=fmt(times[i]), **extra, equal=equal[i])

    w, h = cs.W, cs.H

    def env(env_id, n, **kw):
        return MiniWorldVec(env_id, n, obs_width=w, obs_height=h, device="cuda", **kw)

    if tri_only:
        tri_pass_cases(ab, env)
        print(smi)
        return

    # visible_ents at [visible-ents]' main-path states, and its worst case:
    # each box just behind a closed wall, close enough to fill much of the
    # view (nearly every pixel's ray reaches the occlusion scan)
    from miniworld_tpu_torch.render import visibility as vis

    vis_gen = torch.Generator().manual_seed(2020)
    pick = env(cs.PICK_ID, cs.B_PICK)
    maze = env(cs.MAZE_ID, cs.B_MAZE)
    for label, args in (
            (f"visible_ents {cs.PICK_ID} B={cs.B_PICK}",
             cs.vis_args(pick, cs.facing_states(pick, vis_gen, (0.5, 0.5), (11.5, 11.5)))),
            (f"visible_ents {cs.MAZE_ID} B={cs.B_MAZE}",
             cs.vis_args(maze, cs.random_maze_states(maze, vis_gen, seed=13))),
            (f"visible_ents {cs.MAZE_ID} B={cs.B_MAZE} behind a wall, close",
             cs.vis_args(maze, cs.behind_wall_states(maze, vis_gen, (0.05, 0.1), (0.0, 0.05))))):
        ab(label, lambda args=args: vis.visible_ents(*args), kernel="visible_ents_kernel")
        cs.say("vis-cull", case=label, **cs.vis_stats(args))
    if vis_only:
        print(smi)
        return

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
    m_state = cs.random_maze_states(maze, gen)
    cam1 = rc.camera_grid(m_state, w, h)
    tri1 = (maze._bank.pg_verts9, maze._bank.pg_attr, m_state.layout_id, cam1, maze._all_quads)
    paired1 = (maze._bank.pg_verts9_alt, maze._bank.pg_attr_alt, maze._pg_wall,
               m_state.wall_open)
    ab(f"tri_pass single paired {cs.MAZE_ID} B={cs.B_MAZE}",
       lambda: rc.tri_pass(*tri1, None, paired1))
    # entity_pass (the Maze at 160x120 and 80x60 samples, PickupObjects'
    # spheres) and the epilogue's instances
    def ent_run(e, state, cam):
        return lambda: rc.entity_pass(state.ent_pos, state.ent_size, state.ent_dir,
                                      state.ent_height, state.ent_color,
                                      rc.entity_flags(e._bank, state), cam,
                                      *e._shapes_present[:2])

    args = epi_args(maze_ss, ms_state, 2)
    ab(f"entity_pass {cs.MAZE_ID} ss=2 B={cs.B_MAZE}", ent_run(maze_ss, ms_state, cam2),
       same=ent_equal, kernel="entity_pass_kernel")
    ab(f"entity_pass {cs.MAZE_ID} B={cs.B_MAZE}", ent_run(maze, m_state, cam1), same=ent_equal,
       kernel="entity_pass_kernel")
    pk_state = cs.facing_states(pick, gen, (0.5, 0.5), (11.5, 11.5))
    ab(f"entity_pass {cs.PICK_ID} B={cs.B_PICK}",
       ent_run(pick, pk_state, rc.camera_grid(pk_state, w, h)), same=ent_equal,
       kernel="entity_pass_kernel")
    # the mesh rows at the CollectHealth path's batch
    health = env(cs.HEALTH_ID, cs.B)
    h_state = cs.mesh_states(health, gen)
    ab(f"entity_mesh_rows {cs.HEALTH_ID} B={cs.B}",
       lambda: rc.entity_mesh_rows(health._bank, h_state), kernel="mesh_rows_kernel")
    # mazegen at the Maze procgen path's resets, and at one env an SM
    from miniworld_tpu_torch.ops import mazegen, rng as rng_ops

    seed = rng_ops.sub(rng_ops.cheap_seed(rng_ops.split(rng_ops.key_data(13, "cuda"),
                                                          cs.B_MAZE)), 17)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    chain_seed = seed[:n_sm].contiguous()
    ab(f"mazegen {cs.MAZE_ID} B={cs.B_MAZE}", lambda: mazegen.gen_walls(seed, 8, 8),
       kernel="mazegen_kernel")
    ab(f"mazegen {cs.MAZE_ID} B={n_sm} (chain)", lambda: mazegen.gen_walls(chain_seed, 8, 8),
       kernel="mazegen_kernel")
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
    # the Maze paths end to end through each library
    for e, label in ((maze, f"{cs.MAZE_ID} B={cs.B_MAZE}"),
                     (maze_ss, f"{cs.MAZE_ID} ss=2 B={cs.B_MAZE}")):
        for i in [None, *range(len(others)), *reversed(range(len(others))), None]:
            with contextlib.nullcontext() if i is None else cuda_build.library(others[i]):
                name = "this" if i is None else other_dirs[i]
                state = cs.rollouts(e, f"ab {label} {name}", cs.HORIZON, cs.TRIALS)[4]
                cs.phase_profile(e, state)
    print(smi)


def tri_pass_cases(ab, env):
    """[ab] lines of tri_pass alone: the bf16 multi-chunk (Sidewalk), paired
    multi-chunk (the Maze's at supersample=2) and paired one-chunk (the
    Maze) launches; then each float32-carry and ACTIVE route of
    chip_smoke.py's [f32-dense] at its path's shapes and states
    (view_states; f32_route), beside the same launch in the bf16 carry on
    the same inputs (ids above 256 rounded: a time, not a render); ACTIVE
    also beside the paired launch on the same states."""
    import chip_smoke as cs
    from miniworld_tpu_torch import MiniWorldVec
    from miniworld_tpu_torch.render import raycast as rc

    gen = torch.Generator().manual_seed(2468)
    side = env(cs.SIDE_ID, cs.B)
    st = cs.spread_states(side, gen, (-2.5, 0.5), (5.5, 11.5))
    tri = (side._bank.tri_verts9, side._bank.tri_attr, st.layout_id,
           rc.camera_grid(st, cs.W, cs.H), side._all_quads)
    ab(f"tri_pass multi {cs.SIDE_ID} B={cs.B}", lambda: rc.tri_pass(*tri, None, None, 1024))
    maze_ss = env(cs.MAZE_ID, cs.B_MAZE, supersample=2)
    for label, e in ((f"tri_pass multi paired {cs.MAZE_ID} ss=2 B={cs.B_MAZE}", maze_ss),
                     (f"tri_pass single paired {cs.MAZE_ID} B={cs.B_MAZE}",
                      env(cs.MAZE_ID, cs.B_MAZE))):
        tri_e, mesh, paired, tc, override, carry, active = cs.f32_route(
            e, cs.random_maze_states(e, gen))
        ab(label, lambda a=(tri_e, paired, tc): rc.tri_pass(*a[0], None, a[1], a[2]))
    del maze_ss
    maze = env(cs.MAZE_ID, cs.B_MAZE)
    with cs.shared_banks():
        with cs.transformed_banks(cs.widened):
            routes = [("maze8x8-procgen widened dr", env(cs.MAZE_ID, cs.B_MAZE, domain_rand=True)),
                      ("sidewalk widened dr", env(cs.SIDE_ID, cs.B, domain_rand=True)),
                      ("maze8x8-bank widened dr ss=2",
                       MiniWorldVec(cs.MAZE_ID, cs.B, obs_width=2 * cs.W, obs_height=2 * cs.H,
                                    supersample=2, procgen=False, device="cuda",
                                    domain_rand=True)),
                      ("sign widened", env(cs.SIGN_ID, cs.B))]
        with cs.transformed_banks(cs.raised):
            routes += [("pickupobjects nearest raised", env(cs.PICK_ID, cs.B, tex_mode="nearest")),
                       ("threerooms tri_chunk=16 nearest raised",
                        env(cs.THREE_ID, cs.B, tex_mode="nearest", tri_chunk=16))]
        routes.append(("maze8x8-procgen nearest", env(cs.MAZE_ID, cs.B_MAZE, tex_mode="nearest")))
        with cs.transformed_banks(cs.dense):
            routes += [("maze8x8-procgen dense", env(cs.MAZE_ID, cs.B_MAZE)),
                       ("maze8x8-procgen dense dr", env(cs.MAZE_ID, cs.B_MAZE, domain_rand=True)),
                       ("maze8x8-procgen dense nearest",
                        env(cs.MAZE_ID, cs.B_MAZE, tex_mode="nearest")),
                       ("maze8x8-procgen dense ss=2", env(cs.MAZE_ID, cs.B, supersample=2))]
        with cs.transformed_banks(cs.dense_widened):
            routes.append(("maze8x8-procgen dense widened dr ss=2",
                           env(cs.MAZE_ID, cs.B, supersample=2, domain_rand=True)))
    for label, e in routes:
        state = cs.view_states(e, gen)
        tri_e, mesh, paired, tc, override, carry, active = cs.f32_route(e, state)
        cam = tri_e[3]
        case = (f"tri_pass {label} B={e.num_envs} samples={cam.width}x{cam.height} "
                f"S={tri_e[0].shape[2]}"
                + ("" if active is None else f" n_live={rc.live_row_bound(active[0])}"))
        dts = (carry,) if carry == torch.bfloat16 else (carry, torch.bfloat16)
        for dt in dts:
            ab(f"{case} carry={str(dt)[6:]}",
               lambda dt=dt, a=(tri_e, mesh, paired, tc, override, active):
               rc.tri_pass(*a[0], a[1], a[2], a[3], a[4], dt, a[5]))
        if active is not None and e.supersample == 1:  # the paired launch on the same states
            rows, paired_m = rc.static_rows(maze._bank, state, cam, maze._pg_wall, maze.plan)
            ab(f"tri_pass paired, the states of {label} B={e.num_envs}",
               lambda a=(rows, cam, paired_m): rc.tri_pass(*a[0], a[1], maze._all_quads, None,
                                                          a[2], maze.tri_chunk))


def ortho_tile(csrc):
    """(TILE_W, TILE_H) of tri_pass_ortho.cu in the sources at ``csrc``."""
    with open(os.path.join(csrc, "tri_pass_ortho.cu")) as f:
        text = f.read()
    return tuple(int(re.search(rf"#define {k} (\d+)", text).group(1))
                 for k in ("TILE_W", "TILE_H"))


def say_ptxas(build, log):
    """One [ab-build] line: the build's spilling kernels, the registers of
    the redesigned ones (the multi-chunk tri_pass, the top view's two, the
    SS=2 epilogue, entity_pass, mazegen) and mazegen's stack frames, from
    its ptxas -v log."""
    import chip_smoke as cs

    props = cs.ptxas_props(log)
    spills = [f"{fn}: {spill} bytes" for fn, (_, spill, _) in props.items() if spill]
    regs = [f"{fn}: {r}" for fn, (_, _, r) in props.items()
            if any(k in fn for k in ("tri_pass_multi", "tri_pass_ortho", "topview_epilogue",
                                     "pixel_epilogue_ss2", "entity_pass", "mazegen",
                                     "visible_ents"))]
    frames = [f"{fn}: {frame}" for fn, (frame, _, _) in props.items() if "mazegen" in fn]
    cs.say("ab-build", build=build, spills=repr(" | ".join(spills)),
           registers=repr(" | ".join(regs)), mazegen_stack_frames=repr(" | ".join(frames)))


if __name__ == "__main__":
    args = sys.argv[1:]
    flags = ("--unequal", "--visible-ents", "--tri-pass")
    dirs = [a for a in args if a not in flags]
    if not dirs:
        raise SystemExit(__doc__)
    main(dirs, "--unequal" in args, "--visible-ents" in args, "--tri-pass" in args)
