"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the render kernels of ``miniworld_tpu_torch`` from
``miniworld_tpu_torch/csrc`` with nvcc, holds each against its plain
PyTorch version on the card, then drives the port's main path — the
Hallway fused rollout at B=1024, 80x60 RGB-D — and checks what comes
out. One line per phase; the line before the last is a JSON summary of
the kernels, and the last line is
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
B, W, H = 1024, 80, 60
HORIZON = 50
TRIALS = 3

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


def run_stage_checks(tri_args, ent_args, epi_rest, case, timings):
    from miniworld_tpu_torch.render import raycast as rc

    verts9, attr, layout_id, cam, all_quads = tri_args
    t_k, a_k = rc.tri_pass(verts9, attr, layout_id, cam, all_quads)
    t_p, a_p = rc.tri_pass_plain(verts9, attr, layout_id, cam, all_quads)
    n_differ, differ, abs_err, rel_err = compare_hits(t_k, t_p, (a_k == a_p).all(-1))
    check_stage("tri_pass", case, n_differ, differ, abs_err, rel_err)
    out = {"tri_pass": abs_err}

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
        timings["tri_pass"] = (
            cuda_ms(lambda: rc.tri_pass(verts9, attr, layout_id, cam, all_quads), 50),
            cuda_ms(lambda: rc.tri_pass_plain(verts9, attr, layout_id, cam, all_quads), 10))
        timings["entity_pass"] = (
            cuda_ms(lambda: rc.entity_pass(*ent, cam, has_sphere, has_box), 50),
            cuda_ms(lambda: rc.entity_pass_plain(*ent, cam, has_sphere, has_box), 10))
        timings["pixel_epilogue"] = (
            cuda_ms(lambda: rc.pixel_epilogue(t_k, a_k, *e_k, atlas, cam, *lights,
                                              k_terms), 50),
            cuda_ms(lambda: rc.pixel_epilogue_plain(t_k, a_k, *e_k, atlas, cam,
                                                    *lights, k_terms), 10))
    return out


def phase_kernels():
    from miniworld_tpu_torch import MiniWorldVec
    from miniworld_tpu_torch.render import raycast as rc

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1234)
    env = MiniWorldVec(ENV_ID, B, obs_width=W, obs_height=H, device=dev)
    state = random_hallway_states(env, gen)
    cam = rc.camera_grid(state, W, H)
    timings = {}
    hall = run_stage_checks(
        (env._bank.tri_verts9, env._bank.tri_attr, state.layout_id, cam, env._all_quads),
        ((state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
          state.ent_color, rc.entity_flags(env._bank, state)),
         *env._shapes_present[:2]),
        (env._atlas, (state.light_pos, state.light_color, state.light_ambient,
                      state.sky_color), env.fourier_k),
        f"hallway B={B} HW={W * H} S={env._bank.tri_verts9.shape[2]} "
        f"E={state.ent_pos.shape[1]}",
        timings,
    )
    verts9, attr, layout_id, wcam, ents, atlas, lights, k_terms = wide_inputs(dev, gen)
    wide = run_stage_checks(
        (verts9, attr, layout_id, wcam, False), (ents, True, True),
        (atlas, lights, k_terms), "wide B=64 S=64 mixed-kind E=4 spheres+boxes slot<0", None,
    )
    errs = {k: max(hall[k], wide[k]) for k in hall}
    for k, (ms, plain) in timings.items():
        say("kernel-time", kernel=k, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            shapes=f"B={B} HW={W * H}")
    return errs, timings


# ---------------------------------------------------------------------------
# phase 4: the main path


def rollouts(env, label):
    """Reset, a warm-up rollout, then TRIALS timed rollouts; returns
    (env-steps/s, per-trial outs, last obs)."""
    from miniworld_tpu_torch.render import raycast as rc

    state, obs = env.reset(seed=0)
    gen = torch.Generator(device=env.device).manual_seed(100)
    state, obs, _ = env.rollout(state, obs, gen, HORIZON)
    torch.cuda.synchronize()
    rc.reset_launch_counts()
    times, outs = [], []
    for trial in range(TRIALS):
        gen = torch.Generator(device=env.device).manual_seed(1000 + trial)
        t0 = time.perf_counter()
        state, obs, out = env.rollout(state, obs, gen, HORIZON)
        torch.cuda.synchronize()
        out = {k: v.cpu().numpy() for k, v in out.items()}  # host fetch fence
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = dict(rc.LAUNCHES)
    rate = B * HORIZON * TRIALS / sum(times)
    say("main-path", path=label, env=ENV_ID, B=B, obs=f"{W}x{H}", horizon=HORIZON,
        trials=TRIALS, env_steps_per_s=f"{rate:.1f}",
        trial_s=",".join(f"{t:.4f}" for t in times), launches=launches)
    return rate, outs, obs, launches


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


def phase_breakdown(env, plain):
    """Where a rollout step's time goes: the plain-torch step with its
    auto-reset, and the render on each path."""
    state, _ = env.reset(seed=0)
    acts = env.sample_actions(torch.Generator(device=env.device).manual_seed(5))
    step_ms = host_ms(lambda: env._step_batch(state, acts), 10)
    render_ms = host_ms(lambda: env.render(state), 10)
    plain_ms = host_ms(lambda: plain.render(state), 5)
    say("breakdown", B=B, step_and_reset_ms=f"{step_ms:.3f}",
        render_kernels_ms=f"{render_ms:.3f}", render_plain_ms=f"{plain_ms:.3f}")


def phase_main():
    from miniworld_tpu_torch import MiniWorldVec
    from miniworld_tpu_torch.render import raycast as rc

    env = MiniWorldVec(ENV_ID, B, obs_width=W, obs_height=H, with_depth=True,
                       device=DEVICE)
    rate, outs, (rgb, depth), launches = rollouts(env, "kernels")
    sums = [int(o["obs_sum"].sum()) for o in outs]
    if len(set(sums)) != len(sums):
        raise AssertionError(f"obs checksums do not vary across trials: {sums}")
    for k in rc.LAUNCHES:
        if launches[k] < HORIZON * TRIALS:
            raise AssertionError(f"kernel {k} launched {launches[k]} times in "
                                 f"{TRIALS} rollouts of {HORIZON} steps")
    for o in outs:
        for k in ("reward", "dones", "obs_sum"):
            if o[k].shape != (HORIZON,):
                raise AssertionError(f"{k} shape {o[k].shape}")
    if rgb.shape != (B, H, W, 3) or rgb.dtype != torch.uint8:
        raise AssertionError(f"rgb {tuple(rgb.shape)} {rgb.dtype}")
    d = depth.float()
    if not (bool(torch.isfinite(d).all()) and float(d.min()) > rc.NEAR
            and float(d.max()) <= rc.FAR):
        raise AssertionError("depth outside (NEAR, FAR]")
    say("main-path-check", checksums=sums,
        rewards=",".join(f"{o['reward'].sum():.4f}" for o in outs),
        dones=",".join(str(int(o["dones"].sum())) for o in outs))

    plain = MiniWorldVec(ENV_ID, B, obs_width=W, obs_height=H, with_depth=True,
                         device=DEVICE, use_kernels=False)
    plain_rate, plain_outs, _, plain_launches = rollouts(plain, "plain")
    if any(plain_launches.values()):
        raise AssertionError(f"plain path launched kernels: {plain_launches}")
    # the two paths step the same envs through the same episodes
    for o_k, o_p in zip(outs, plain_outs):
        if not (np.array_equal(o_k["reward"], o_p["reward"])
                and np.array_equal(o_k["dones"], o_p["dones"])):
            raise AssertionError("kernel and plain paths disagree on rewards/dones")
        rel = np.abs(o_k["obs_sum"] - o_p["obs_sum"]) / np.maximum(o_p["obs_sum"], 1)
        if rel.max() > 1e-4:
            raise AssertionError(f"obs checksums differ by {rel.max():.3e}")
    worst = max(float((np.abs(a["obs_sum"] - b["obs_sum"])
                       / np.maximum(b["obs_sum"], 1)).max())
                for a, b in zip(outs, plain_outs))
    say("main-path-parity", paths="kernels vs plain", rewards_dones="equal",
        obs_sum_max_rel_diff=f"{worst:.3e}")
    phase_breakdown(env, plain)
    return launches, rate, plain_rate


def main():
    smi = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    errs, timings = phase_kernels()
    launches, rate, plain_rate = phase_main()
    summary = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(launches[k]), "max_abs_err": errs[k],
         "ms": timings[k][0], "plain_ms": timings[k][1]}
        for k, (src, rep) in KERNELS.items()
    ], "env_steps_per_s": {"kernels": rate, "plain": plain_rate}}
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
