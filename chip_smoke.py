"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the kernels of ``miniworld_tpu_torch`` from
``miniworld_tpu_torch/csrc`` with nvcc (one process per source), holds
each against its plain PyTorch version on the card — at Hallway's and
PickupObjects' shapes and on wide synthetic cases — then drives the
port's main paths and checks what comes out: the Hallway fused rollout
at B=1024 and the PickupObjects one at B=4096 (80x60 RGB-D, random
policy), each against its plain path, and short FourRooms and TMaze
rollouts. One line per phase; the JSON summary of the kernels and the
card's ``nvidia-smi`` name and power limit come before the last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises, so the script exits non-zero and prints no
result; so does a machine without CUDA, or a directory without the
package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
ENV_ID = "MiniWorld-Hallway-v0"
PICK_ID = "MiniWorld-PickupObjects-v0"
B, W, H = 1024, 80, 60  # Hallway, and the FourRooms / TMaze / parity rollouts
B_PICK = 4096  # PickupObjects, the reference's BASELINE batch for it
HORIZON = 30
TRIALS = 2  # Hallway; PickupObjects runs PICK_TRIALS
PICK_TRIALS = 3
SHORT_HORIZON = 20  # FourRooms, TMaze and the PickupObjects parity rollouts

# the card's published peaks (H100 SXM data sheet) for the bound column
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# kernel vs plain on the card: both sides compute the same float32
# operations in the same order (the library is built with -fmad=false),
# so winners, depths and u8 colors are expected to agree exactly; the
# stated limits leave room for a differently rounded math-library call.
MAX_WINNER_DIFF_FRAC = 1e-4  # pixels whose winning prim / entity differs
MAX_T_REL_ERR = 1e-6  # hit distance, where the winners agree
MAX_RGB_ERR = 1  # u8 levels
MAX_RGB_DIFF_FRAC = 1e-4  # pixels whose color differs at all

KERNELS = {
    "tri_pass": ("miniworld_tpu_torch/csrc/tri_pass.cu",
                 "miniworld_tpu/render/raycast.py:158"),
    "entity_pass": ("miniworld_tpu_torch/csrc/entity_pass.cu",
                    "miniworld_tpu/render/raycast.py:912"),
    "pixel_epilogue": ("miniworld_tpu_torch/csrc/pixel_epilogue.cu",
                       "miniworld_tpu/render/raycast.py:1244"),
    "entity_mesh_pass": ("miniworld_tpu_torch/csrc/entity_mesh_pass.cu",
                         "miniworld_tpu/render/raycast.py:838"),
    "place": ("miniworld_tpu_torch/csrc/place.cu",
              "miniworld_tpu/ops/place.py:65"),
}


def say(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over ``iters`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        nvidia_smi=repr(smi))
    return smi


def phase_build():
    from miniworld_tpu_torch.render import cuda_build

    t0 = time.perf_counter()
    cuda_build.load()
    secs = time.perf_counter() - t0
    log = cuda_build.BUILD_INFO.get("log", "")
    with open(os.path.join(cuda_build.build_dir(), "kernel_build.log"), "w") as f:
        f.write(log)
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    say("build", seconds=f"{secs:.2f}", arch="sm_90a",
        sources=",".join(cuda_build.SOURCES), ptxas=repr(" | ".join(regs)))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version


def random_hallway_states(env, gen):
    """Hallway states at B envs with agents spread over the hallway,
    random yaw, the goal box where reset put it."""
    state, _ = env.reset(seed=7)
    n = env.num_envs
    u = torch.rand((n, 3), generator=gen).to(env.device)
    pos = torch.stack([-0.5 + 11.0 * u[:, 0], torch.zeros_like(u[:, 0]),
                       -1.5 + 3.0 * u[:, 1]], dim=1)
    return state.replace(pos=pos, dir=(u[:, 2] * 2.0 - 1.0) * math.pi)


def wide_inputs(dev, gen, n=64, S=64, E=4, L=2, A=6, K=16):
    """Synthetic wide case: S prims of mixed kind around each camera,
    E entities of mixed shape (some inactive), slots incl. -1 and A."""
    from miniworld_tpu_torch.ops import geom
    from miniworld_tpu_torch.render import raycast as rc

    def rnd(*shape):
        return torch.rand(shape, generator=gen)

    v0 = torch.stack([rnd(L, S) * 12 - 6, rnd(L, S) * 3, rnd(L, S) * 12 - 6], 1)
    e1 = (rnd(L, 3, S) - 0.5) * 4
    e2 = (rnd(L, 3, S) - 0.5) * 4
    verts9 = torch.cat([v0, v0 + e1, v0 + e2], 1).contiguous()  # (L, 9, S)
    attr = (rnd(L, S, 16) - 0.5) * 2
    attr[:, :, 11:14] = rnd(L, S, 3)
    slot = torch.randint(-1, A + 1, (L, S), generator=gen).float()
    attr[:, :, 14] = slot
    attr[:, :, 15] = (rnd(L, S) > 0.5).float()
    layout_id = torch.randint(0, L, (n,), generator=gen, dtype=torch.int32)
    yaw = (rnd(n) * 2 - 1) * math.pi
    pitch = (rnd(n) - 0.5) * 20
    fwd, up, right = [t.to(dev) for t in geom.cam_basis(yaw, pitch)]
    origin = torch.stack([rnd(n) * 4 - 2, 1.5 + rnd(n) * 0.2, rnd(n) * 4 - 2], 1)
    tan_y = torch.full((n,), math.tan(math.radians(30.0)))
    xbase = 2.0 * (torch.arange(W, dtype=torch.float32) + 0.5) * (1.0 / W) - 1.0
    ybase = 1.0 - 2.0 * (torch.arange(H, dtype=torch.float32) + 0.5) * (1.0 / H)
    cam = rc.Camera(origin.to(dev), fwd, right, up, (tan_y * (W / H)).to(dev),
                    tan_y.to(dev), xbase.to(dev), ybase.to(dev))
    ent_pos = torch.stack([rnd(n, E) * 8 - 4, rnd(n, E) * 0.5, rnd(n, E) * 8 - 4], -1)
    ent_size = 0.3 + rnd(n, E, 3)
    ent_dir = (rnd(n, E) * 2 - 1) * math.pi
    ent_height = 0.3 + rnd(n, E)
    ent_color = rnd(n, E, 3)
    kind = torch.randint(0, 2, (n, E), generator=gen)
    active = rnd(n, E) > 0.2
    flags = (active.to(torch.uint8) * rc.ENT_ACTIVE
             + (kind == 0).to(torch.uint8) * rc.ENT_SPHERE
             + (kind == 1).to(torch.uint8) * rc.ENT_BOX)
    ents = [t.to(dev).contiguous() for t in
            (ent_pos, ent_size, ent_dir, ent_height, ent_color, flags)]
    atlas = rnd(A, 4 + 8 * K)
    atlas[:, 3:3 + 2 * K] = torch.randint(-8, 9, (A, 2 * K), generator=gen).float()
    atlas[:, -1] = 1.0
    lights = [torch.tensor(v).expand(n, 3).contiguous().to(dev) for v in
              ([0.0, 2.5, 0.0], [0.7, 0.7, 0.7], [0.45, 0.45, 0.45], [0.25, 0.82, 1.0])]
    return (verts9.to(dev), attr.to(dev), layout_id.to(dev), cam, ents,
            atlas.to(dev), lights, K)


def compare_hits(t_k, t_p, same):
    """Winner-differs pixel count and fraction, and the max abs / rel
    error of the hit distance t where the winners (``same``) agree."""
    both_miss = torch.isinf(t_k) & torch.isinf(t_p)
    same = same & (both_miss | (torch.isfinite(t_k) & torch.isfinite(t_p)))
    fin = same & ~both_miss
    diff = (t_k - t_p).abs()[fin]
    rel = (diff / t_p[fin].abs()) if diff.numel() else diff
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float(rel.max()) if rel.numel() else 0.0
    return int((~same).sum()), 1.0 - float(same.float().mean()), abs_err, rel_err


def check_stage(name, case, n_differ, differ, abs_err, rel_err):
    say("kernel-vs-plain", kernel=name, case=case, winner_differs_px=n_differ,
        winner_differs=f"{differ:.3e}", t_max_abs_err=f"{abs_err:.3e}",
        t_max_rel_err=f"{rel_err:.3e}")
    if differ > MAX_WINNER_DIFF_FRAC or rel_err > MAX_T_REL_ERR:
        raise AssertionError(f"{name} ({case}): kernel disagrees with plain "
                             f"(winner differs {differ:.3e}, rel err {rel_err:.3e})")


def run_stage_checks(tri_args, ent_args, epi_rest, case, timings=None, mesh=None):
    """Each render stage's kernel against its plain version on one set of
    inputs; ``mesh`` = (verts9, attrs) adds the mesh-entity pass, whose
    (kernel) result seeds both tri_pass versions. With ``timings`` each
    stage is also timed, kernel and plain, by CUDA events."""
    from miniworld_tpu_torch.render import raycast as rc

    verts9, attr, layout_id, cam, all_quads = tri_args
    out = {}
    seed = None
    if mesh is not None:
        m_k = rc.entity_mesh_pass(*mesh, cam)
        m_p = rc.entity_mesh_pass_plain(*mesh, cam)
        n_differ, differ, abs_err, rel_err = compare_hits(
            m_k[0], m_p[0], (m_k[1] == m_p[1]).all(-1))
        check_stage("entity_mesh_pass", case, n_differ, differ, abs_err, rel_err)
        out["entity_mesh_pass"] = abs_err
        seed = m_k
    t_k, a_k = rc.tri_pass(verts9, attr, layout_id, cam, all_quads, seed)
    t_p, a_p = rc.tri_pass_plain(verts9, attr, layout_id, cam, all_quads, seed)
    n_differ, differ, abs_err, rel_err = compare_hits(t_k, t_p, (a_k == a_p).all(-1))
    check_stage("tri_pass" + (" seeded" if seed else ""), case, n_differ, differ,
                abs_err, rel_err)
    out["tri_pass"] = abs_err

    ent, has_sphere, has_box = ent_args
    e_k = rc.entity_pass(*ent, cam, has_sphere, has_box)
    e_p = rc.entity_pass_plain(*ent, cam, has_sphere, has_box)
    same = (e_k[1] == e_p[1]).all(-1) & (e_k[2] == e_p[2]).all(-1)
    n_differ, differ, abs_err, rel_err = compare_hits(e_k[0], e_p[0], same)
    check_stage("entity_pass", case, n_differ, differ, abs_err, rel_err)
    out["entity_pass"] = abs_err

    atlas, lights, k_terms = epi_rest
    # both epilogue versions read the kernels' hit results
    rgb_k, d_k = rc.pixel_epilogue(t_k, a_k, *e_k, atlas, cam, *lights, k_terms)
    rgb_p, d_p = rc.pixel_epilogue_plain(t_k, a_k, *e_k, atlas, cam, *lights, k_terms)
    diff = (rgb_k.int() - rgb_p.int()).abs()
    rgb_err = int(diff.max())
    n_rgb = int((diff.amax(-1) > 0).sum())
    frac = n_rgb / diff[..., 0].numel()
    d_err = float(((d_k - d_p).abs() / d_p.abs()).max())
    say("kernel-vs-plain", kernel="pixel_epilogue", case=case, max_rgb_err=rgb_err,
        rgb_differs_px=n_rgb, rgb_differs=f"{frac:.3e}",
        depth_max_rel_err=f"{d_err:.3e}")
    if rgb_err > MAX_RGB_ERR or frac > MAX_RGB_DIFF_FRAC or d_err > MAX_T_REL_ERR:
        raise AssertionError(f"pixel_epilogue ({case}): kernel disagrees with plain")
    out["pixel_epilogue"] = float(rgb_err)

    if timings is not None:  # at the main path's shapes
        if mesh is not None:
            timings["entity_mesh_pass"] = (
                cuda_ms(lambda: rc.entity_mesh_pass(*mesh, cam), 50),
                cuda_ms(lambda: rc.entity_mesh_pass_plain(*mesh, cam), 5))
        timings["tri_pass"] = (
            cuda_ms(lambda: rc.tri_pass(verts9, attr, layout_id, cam, all_quads, seed), 50),
            cuda_ms(lambda: rc.tri_pass_plain(verts9, attr, layout_id, cam, all_quads, seed),
                    5))
        timings["entity_pass"] = (
            cuda_ms(lambda: rc.entity_pass(*ent, cam, has_sphere, has_box), 50),
            cuda_ms(lambda: rc.entity_pass_plain(*ent, cam, has_sphere, has_box), 5))
        timings["pixel_epilogue"] = (
            cuda_ms(lambda: rc.pixel_epilogue(t_k, a_k, *e_k, atlas, cam, *lights,
                                              k_terms), 50),
            cuda_ms(lambda: rc.pixel_epilogue_plain(t_k, a_k, *e_k, atlas, cam,
                                                    *lights, k_terms), 5))
    return out, (t_k, a_k, e_k)


def wide_mesh_rows(cam, gen, n_rows=1000):
    """Synthetic mesh rows beside wide_inputs' prims: 1000 triangles per
    env (close to the z-key's 1024-row budget) around each camera, 20%
    of them inactive (all-zero vertices, as entity_mesh_rows leaves
    them), 10% pushed far behind the camera, slots incl. -1 and 6."""
    dev = cam.origin.device
    b = cam.origin.shape[0]

    def rnd(*shape):
        return torch.rand(shape, generator=gen)

    v0 = torch.stack([rnd(b, n_rows) * 12 - 6, rnd(b, n_rows) * 3,
                      rnd(b, n_rows) * 12 - 6], 1)
    e1 = (rnd(b, 3, n_rows) - 0.5) * 2
    e2 = (rnd(b, 3, n_rows) - 0.5) * 2
    verts9 = torch.cat([v0, v0 + e1, v0 + e2], 1)  # (b, 9, n)
    behind = (rnd(b, 1, n_rows) < 0.1).expand(b, 9, n_rows)
    verts9 = torch.where(behind, verts9 - 400.0 * cam.fwd.cpu().repeat(1, 3)[:, :, None],
                         verts9)
    inactive = (rnd(b, 1, n_rows) < 0.2).expand(b, 9, n_rows)
    verts9 = torch.where(inactive, torch.zeros_like(verts9), verts9)
    attrs = (rnd(b, n_rows, 16) - 0.5) * 2
    attrs[:, :, 11:14] = rnd(b, n_rows, 3)
    attrs[:, :, 14] = torch.randint(-1, 7, (b, n_rows), generator=gen).float()
    attrs[:, :, 15] = 1.0
    return verts9.to(dev).contiguous(), attrs.to(dev).contiguous()


def facing_states(env, gen, lo, hi, seed=7):
    """States from a reset with the agents spread uniformly over the box
    [lo, hi] (x, z), env i looking towards its entity slot i mod E, so
    most frames show entities against walls, floor and sky."""
    state, _ = env.reset(seed=seed)
    n = env.num_envs
    u = torch.rand((n, 2), generator=gen).to(env.device)
    pos = torch.stack([lo[0] + (hi[0] - lo[0]) * u[:, 0], torch.zeros_like(u[:, 0]),
                       lo[1] + (hi[1] - lo[1]) * u[:, 1]], dim=1)
    slot = torch.arange(n, device=env.device) % state.ent_pos.shape[1]
    target = state.ent_pos[torch.arange(n, device=env.device), slot]
    # forward is (cos d, 0, -sin d)
    yaw = torch.atan2(-(target[:, 2] - pos[:, 2]), target[:, 0] - pos[:, 0])
    return state.replace(pos=pos, dir=yaw)


def stage_inputs(env, state):
    from miniworld_tpu_torch.render import raycast as rc

    cam = rc.camera_grid(state, W, H)
    tri = (env._bank.tri_verts9, env._bank.tri_attr, state.layout_id, cam, env._all_quads)
    ent = ((state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
            state.ent_color, rc.entity_flags(env._bank, state)), *env._shapes_present[:2])
    epi = (env._atlas, (state.light_pos, state.light_color, state.light_ambient,
                        state.sky_color), env.fourier_k)
    return cam, tri, ent, epi


def phase_kernels(hall, pick):
    """Every kernel against its plain version: Hallway's shapes and the
    wide case (the Hallway slice's checks), then PickupObjects' shapes
    at B=4096 with the mesh pass seeding tri_pass, timed there, and a
    wide mesh case."""
    from miniworld_tpu_torch.render import raycast as rc

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1234)
    state = random_hallway_states(hall, gen)
    _, tri, ent, epi = stage_inputs(hall, state)
    errs, _ = run_stage_checks(
        tri, ent, epi, f"hallway B={B} HW={W * H} S={tri[0].shape[2]} "
        f"E={state.ent_pos.shape[1]}")
    verts9, attr, layout_id, wcam, ents, atlas, lights, k_terms = wide_inputs(dev, gen)
    wide_case = (verts9, attr, layout_id, wcam, False), (ents, True, True), (atlas, lights,
                                                                             k_terms)
    wide, _ = run_stage_checks(*wide_case, "wide B=64 S=64 mixed-kind E=4 spheres+boxes slot<0")
    errs = {k: max(errs[k], wide[k]) for k in errs}

    # PickupObjects at the main path's shapes: spheres analytic, boxes
    # and keys as mesh rows seeding tri_pass
    state = facing_states(pick, gen, (0.5, 0.5), (11.5, 11.5))
    cam, tri, ent, epi = stage_inputs(pick, state)
    rows9, row_attrs, valid = rc.entity_mesh_rows(pick._bank, state)
    timings = {}
    p_errs, outs = run_stage_checks(
        tri, ent, epi, f"pickupobjects B={B_PICK} HW={W * H} S={tri[0].shape[2]} "
        f"E*M={rows9.shape[2]}", timings, mesh=(rows9, row_attrs))
    mesh_t = rc.entity_mesh_pass_plain(rows9, row_attrs, cam)[0]
    say("pickup-scene", px_hit=f"{float(torch.isfinite(outs[0]).float().mean()):.3f}",
        px_mesh_hit=f"{float(torch.isfinite(mesh_t).float().mean()):.4f}",
        frames_showing_mesh=f"{float(torch.isfinite(mesh_t).any(1).float().mean()):.3f}",
        live_mesh_rows=int(valid.sum()))
    errs = {k: max(errs.get(k, 0.0), v) for k, v in p_errs.items()}
    mesh = wide_mesh_rows(wcam, gen)
    w_errs, _ = run_stage_checks(
        *wide_case, "wide-mesh B=64 E*M=1000 (20% inactive, 10% behind) seeding S=64",
        mesh=mesh)
    errs = {k: max(errs[k], v) for k, v in w_errs.items()}
    work = stage_work(pick, state, tri, ent, (rows9, valid), outs)
    return errs, timings, work


def stage_work(env, state, tri, ent, mesh, outs):
    """(bytes, float operations) each render stage must move and do on
    these inputs: each input read once, each output written once;
    operations counted per (row, pixel) pair that the data needs (live
    mesh rows, active entities, textured pixels). Per-pair counts:
    separable hit test 22 (three 2-term contractions 12, 1/t 1, coverage
    3, gates 6), triangle-only 20, analytic sphere 20, box slab 45,
    Fourier texel 41 per term (phase 3, cos/sin 20, anti-aliasing 6,
    amplitudes 12) plus 60 per pixel for uv, lighting and the pack."""
    from miniworld_tpu_torch.render.raycast import ENT_ACTIVE, ENT_BOX, ENT_SPHERE

    b, hw = state.pos.shape[0], W * H
    cam_b = b * 14 * 4 + (W + H) * 4
    verts9, attr, _, _, _ = tri
    L, _, S = verts9.shape
    rows9, valid = mesh
    n_rows = rows9.shape[2]
    t_k, a_k, e_k = outs
    work = {
        "entity_mesh_pass": (b * n_rows * (9 + 16) * 4 + cam_b + b * hw * 36,
                             int(valid.sum()) * hw * 20),
        "tri_pass": (L * S * (9 + 16) * 4 + b * 4 + cam_b + b * hw * 36 * 2,
                     b * hw * (S * 22 + 1)),
    }
    flags = ent[0][5]
    E = flags.shape[1]
    active = (flags & ENT_ACTIVE) != 0
    n_sph = int((active & ((flags & ENT_SPHERE) != 0)).sum())
    n_box = int((active & ((flags & ENT_BOX) != 0)).sum())
    work["entity_pass"] = (b * E * 45 + cam_b + b * hw * 28,
                           hw * (n_sph * 20 + n_box * 45))
    k = env.fourier_k
    textured = int((torch.isfinite(t_k) & (a_k[..., 14].float() >= 0)).sum())
    work["pixel_epilogue"] = (b * hw * (36 + 28) + env._atlas.numel() * 4 + b * 48 + cam_b
                              + b * hw * 7, textured * k * 41 + b * hw * 60)
    return work


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# the placement kernel


def capture_place_args(env, seed):
    """The inputs a reset gives ``place_all`` (captured from env.reset)."""
    from miniworld_tpu_torch.ops import place as place_ops

    captured = {}
    orig = place_ops.place_all

    def capture(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return orig(*args, **kwargs)

    place_ops.place_all = capture
    try:
        env.reset(seed=seed)
    finally:
        place_ops.place_all = orig
    return captured["args"], captured["kwargs"]


def phase_place(pick, four, timings):
    """place kernel vs place_all_plain from real reset inputs: positions
    and directions must be equal, env for env."""
    from miniworld_tpu_torch.ops import place as place_ops

    errs = 0.0
    work = None
    for env, seed in ((pick, 11), (four, 12)):
        args, kwargs = capture_place_args(env, seed)
        k_out = place_ops.place_all(*args, **kwargs)
        p_out = place_ops.place_all_plain(*args, **kwargs)
        n = env.num_envs
        differ = torch.zeros(n, dtype=torch.bool, device=env.device)
        for a, b in zip(k_out, p_out):
            differ |= (a != b).reshape(n, -1).any(dim=1)
            errs = max(errs, float((a - b).abs().max()))
        say("kernel-vs-plain", kernel="place", case=f"{env.spec.gym_id} B={n} "
            f"E+1={args[4].shape[1]} R={env._bank.room_mask.shape[1]} budget={kwargs['budget']}",
            envs_differ=int(differ.sum()), max_abs_err=f"{errs:.3e}")
        if bool(differ.any()):
            raise AssertionError(f"place ({env.spec.gym_id}): {int(differ.sum())} envs differ")
        if env is pick:
            timings["place"] = (cuda_ms(lambda: place_ops.place_all(*args, **kwargs), 50),
                                cuda_ms(lambda: place_ops.place_all_plain(*args, **kwargs), 5))
            seeds, bank, _, _, radius, slot_mask = args
            E, R = slot_mask.shape[1], bank.room_mask.shape[1]
            V, ns = bank.room_outline.shape[2], bank.room_segs.shape[3]
            budget = kwargs["budget"]
            room_bytes = sum(t.numel() * t.element_size() for t in (
                bank.room_mask, bank.room_area, bank.room_aabb, bank.room_outline,
                bank.room_norms, bank.room_vmask, bank.room_segs))
            # per try: room draw 2R, bbox and position 10, outline 4V,
            # walls 20 per segment, entities 8 per slot
            work = (n * (E + 1) * 44 + n * 4 + n * E + room_bytes + n * (4 * E + 4) * 4,
                    n * (E + 1) * (budget + 1) * (2 * R + 10 + 4 * V + 20 * ns + 8 * E))
    return errs, work


# ---------------------------------------------------------------------------
# the main paths


def rollouts(env, label, horizon, trials, warmup=True):
    """Reset, a warm-up rollout, then ``trials`` timed rollouts; returns
    (env-steps/s, per-trial outs, last obs, kernel launches of the timed
    trials)."""
    from miniworld_tpu_torch.render import cuda_build

    state, obs = env.reset(seed=0)
    if warmup:
        gen = torch.Generator(device=env.device).manual_seed(100)
        state, obs, _ = env.rollout(state, obs, gen, horizon)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    times, outs = [], []
    for trial in range(trials):
        gen = torch.Generator(device=env.device).manual_seed(1000 + trial)
        t0 = time.perf_counter()
        state, obs, out = env.rollout(state, obs, gen, horizon)
        torch.cuda.synchronize()
        out = {k: v.cpu().numpy() for k, v in out.items()}  # host fetch fence
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = dict(cuda_build.LAUNCHES)
    rate = env.num_envs * horizon * trials / sum(times)
    say("main-path", path=label, env=env.spec.gym_id, B=env.num_envs, obs=f"{W}x{H}",
        horizon=horizon, trials=trials, env_steps_per_s=f"{rate:.1f}",
        trial_s=",".join(f"{t:.4f}" for t in times), launches=launches)
    return rate, outs, obs, launches


def check_rollout(env, outs, obs, launches, horizon, trials, kernels):
    """Checksums vary across trials, each of ``kernels`` launched at least
    once per step, outputs of the right shape, depth in (NEAR, FAR]."""
    from miniworld_tpu_torch.render import raycast as rc

    sums = [int(o["obs_sum"].sum()) for o in outs]
    if len(set(sums)) != len(sums):
        raise AssertionError(f"obs checksums do not vary across trials: {sums}")
    for k in kernels:
        if launches[k] < horizon * trials:
            raise AssertionError(f"kernel {k} launched {launches[k]} times in "
                                 f"{trials} rollouts of {horizon} steps")
    for o in outs:
        for k in ("reward", "dones", "obs_sum"):
            if o[k].shape != (horizon,):
                raise AssertionError(f"{k} shape {o[k].shape}")
    rgb, depth = obs
    if rgb.shape != (env.num_envs, H, W, 3) or rgb.dtype != torch.uint8:
        raise AssertionError(f"rgb {tuple(rgb.shape)} {rgb.dtype}")
    d = depth.float()
    if not (bool(torch.isfinite(d).all()) and float(d.min()) > rc.NEAR
            and float(d.max()) <= rc.FAR):
        raise AssertionError("depth outside (NEAR, FAR]")
    say("main-path-check", env=env.spec.gym_id, checksums=sums,
        rewards=",".join(f"{o['reward'].sum():.4f}" for o in outs),
        dones=",".join(str(int(o["dones"].sum())) for o in outs))


def compare_paths(outs, plain_outs, label):
    """Kernel and plain rollouts step the same envs through the same
    episodes: rewards and dones equal, checksums within 1e-4."""
    for o_k, o_p in zip(outs, plain_outs):
        if not (np.array_equal(o_k["reward"], o_p["reward"])
                and np.array_equal(o_k["dones"], o_p["dones"])):
            raise AssertionError(f"{label}: kernel and plain paths disagree on rewards/dones")
    worst = max(float((np.abs(a["obs_sum"] - b["obs_sum"])
                       / np.maximum(b["obs_sum"], 1)).max())
                for a, b in zip(outs, plain_outs))
    if worst > 1e-4:
        raise AssertionError(f"{label}: obs checksums differ by {worst:.3e}")
    say("main-path-parity", env=label, paths="kernels vs plain", rewards_dones="equal",
        obs_sum_max_rel_diff=f"{worst:.3e}")


def host_ms(fn, iters: int) -> float:
    """Mean host-clock time of fn() over ``iters`` runs, fenced by
    torch.cuda.synchronize() (includes launch overhead)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_breakdown(env, render_iters=10):
    """Where a rollout step's time goes: the step with its auto-reset
    (placement by the kernel, then by place_all_plain), and the render
    with the kernels and with the plain versions."""
    state, _ = env.reset(seed=0)
    acts = env.sample_actions(torch.Generator(device=env.device).manual_seed(5))
    step_ms = host_ms(lambda: env._step_batch(state, acts), 10)
    render_ms = host_ms(lambda: env.render(state), render_iters)
    env.use_kernels = False
    try:
        step_plain_ms = host_ms(lambda: env._step_batch(state, acts), 5)
        plain_ms = host_ms(lambda: env.render(state), 3)
    finally:
        env.use_kernels = True
    say("breakdown", env=env.spec.gym_id, B=env.num_envs,
        step_and_reset_ms=f"{step_ms:.3f}", step_and_reset_plain_place_ms=f"{step_plain_ms:.3f}",
        render_kernels_ms=f"{render_ms:.3f}", render_plain_ms=f"{plain_ms:.3f}")
    phase_profile(env, state)


def phase_profile(env, state, steps=3):
    """torch.profiler over a few kernel-path rollout steps: device events
    and device-busy time per step, and the wall time under the profiler
    (the idle share is 1 - busy / wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=env.device).manual_seed(9)
    obs = env.render(state)
    env.rollout(state, obs, gen, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        env.rollout(state, obs, gen, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / steps if events else None
    say("profile", env=env.spec.gym_id, B=env.num_envs, steps=steps,
        device_events_per_step=len(events) // steps if events else "not measured",
        device_busy_ms_per_step=f"{busy_ms:.3f}" if busy_ms is not None else "not measured",
        wall_ms_per_step_under_profiler=f"{wall_ms:.3f}",
        idle_share=f"{1.0 - busy_ms / wall_ms:.3f}" if busy_ms is not None else "not measured")


def kernel_and_plain(env, horizon, trials, kernels):
    """The env's rollouts with the kernels, then with every stage plain
    (no launch allowed), compared."""
    rate, outs, obs, launches = rollouts(env, "kernels", horizon, trials)
    check_rollout(env, outs, obs, launches, horizon, trials, kernels)
    env.use_kernels = False
    try:
        plain_rate, plain_outs, _, plain_launches = rollouts(env, "plain", horizon, trials)
    finally:
        env.use_kernels = True
    if any(plain_launches.values()):
        raise AssertionError(f"plain path launched kernels: {plain_launches}")
    compare_paths(outs, plain_outs, env.spec.gym_id)
    return rate, plain_rate


def phase_main(hall, pick, pick_small, four, tmaze):
    hall_kernels = ("tri_pass", "entity_pass", "pixel_epilogue", "place")
    rates = {}
    rates["hallway"] = kernel_and_plain(hall, HORIZON, TRIALS, hall_kernels)
    phase_breakdown(hall)

    # the PickupObjects main path: B=4096, all five kernels every step
    rate, outs, obs, launches = rollouts(pick, "kernels", HORIZON, PICK_TRIALS)
    check_rollout(pick, outs, obs, launches, HORIZON, PICK_TRIALS, list(KERNELS))
    total_reward = sum(float(o["reward"].sum()) for o in outs)
    if not total_reward > 0.0:
        raise AssertionError("no pickup rewarded in the PickupObjects rollouts")
    rates["pickupobjects"] = (rate, None)
    pick_launches = launches
    rates["pickupobjects_b1024"] = kernel_and_plain(pick_small, SHORT_HORIZON, TRIALS,
                                                    list(KERNELS))
    for env in (four, tmaze):
        r, outs, obs, launches = rollouts(env, "kernels", SHORT_HORIZON, TRIALS)
        check_rollout(env, outs, obs, launches, SHORT_HORIZON, TRIALS, hall_kernels)
        rates[env.spec.name.lower()] = (r, None)
    phase_breakdown(pick, render_iters=5)
    return pick_launches, rates


def main():
    smi = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    from miniworld_tpu_torch import MiniWorldVec

    def env(env_id, n):
        return MiniWorldVec(env_id, n, obs_width=W, obs_height=H, device=DEVICE)

    hall, pick = env(ENV_ID, B), env(PICK_ID, B_PICK)
    pick_small = env(PICK_ID, B)
    four, tmaze = env("MiniWorld-FourRooms-v0", B), env("MiniWorld-TMaze-v0", B)
    errs, timings, work = phase_kernels(hall, pick)
    errs["place"], work["place"] = phase_place(pick, four, timings)
    for k, (ms, plain) in timings.items():
        say("kernel-time", kernel=k, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            shapes=f"{PICK_ID} B={B_PICK} HW={W * H}")
    launches, rates = phase_main(hall, pick, pick_small, four, tmaze)
    kernels = []
    for k, (src, rep) in KERNELS.items():
        bound_ms, bound_by = bound(*work[k])
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": int(launches[k]), "max_abs_err": errs[k],
            "ms": timings[k][0], "plain_ms": timings[k][1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    print(json.dumps({
        "kernels": kernels,
        "env_steps_per_s": {k: {"kernels": v[0], "plain": v[1]} for k, v in rates.items()},
    }))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
