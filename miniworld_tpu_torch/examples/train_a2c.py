"""End-to-end A2C training on the PyTorch port: thousands of envs
stepping and rendering on the card feed an actor-critic learner whose
gradients are averaged over every rank of a ``torch.distributed`` group.
The twin of the JAX package's examples/train_a2c.py: the same flags and
JSONL rows, ``--device`` (default cuda) in place of the mesh's platform.

    python -m miniworld_tpu_torch.examples.train_a2c \\
        --env MiniWorld-OneRoomS6Fast-v0 --num-envs 1024 --obs 80x60

Over several cards, one process each (the env batch splits over the
ranks; gradients all-reduce over NCCL):

    torchrun --nproc-per-node 4 -m miniworld_tpu_torch.examples.train_a2c

``--refresh-layouts-every N`` swaps in a fresh layout bank every N
iterations (``MiniWorldVec.prepare_bank`` in a background thread, then
``install_bank``); ``--procgen`` mazes make a fresh maze every reset.
"""

from __future__ import annotations

import argparse
import json
import time


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="MiniWorld-OneRoomS6Fast-v0")
    p.add_argument("--num-envs", type=int, default=512)
    p.add_argument("--horizon", type=int, default=16)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--obs", default="64x48")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs and the learner (cuda: the card, as "
                        "LOCAL_RANK picks under a launcher; cpu on request)")
    p.add_argument("--checkpoint", default=None,
                   help="directory to save params+env state each 50 iters (torch.save, one "
                        "file a rank)")
    p.add_argument("--metrics", default=None, help="path for per-iteration JSONL metrics")
    p.add_argument("--log-every", type=int, default=50,
                   help="iterations between metric fetches (each fetch waits for the card)")
    p.add_argument("--refresh-layouts-every", type=int, default=0,
                   help="swap in a freshly generated layout bank every N iterations "
                        "(procedural envs: the training distribution grows without bound, "
                        "like the reference's per-reset generation); each bank is prepared "
                        "in a background thread while the previous iterations run")
    return p


def run(args, make_step, extra=(), env_kwargs=None):
    """Train with ``make_step(env) -> (step, init)``; ``extra`` names the
    step's metrics beyond the A2C ones (PPO's approx_kl, clip_frac),
    ``env_kwargs`` go to the env's constructor."""
    import torch

    from miniworld_tpu_torch import MiniWorldVec
    from miniworld_tpu_torch.ops.rng import key_data, split
    from miniworld_tpu_torch.parallel import init_multihost, rank, world_size
    from miniworld_tpu_torch.utils import checkpoint

    obs_w, obs_h = map(int, args.obs.split("x"))
    init_multihost(args.device)
    n_dev, me = world_size(), rank()
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    num_envs = (args.num_envs // n_dev) * n_dev
    lead = me == 0
    if lead:
        print(f"devices: {n_dev} x {device.type}, envs: {num_envs}")

    env = MiniWorldVec(args.env, num_envs // n_dev, obs_width=obs_w, obs_height=obs_h,
                       device=device, **(env_kwargs or {}))
    step, init = make_step(env)
    tstate, state, obs, depth = init(key_data(args.seed, device))

    metrics_f = open(args.metrics, "w") if args.metrics and lead else None
    key = key_data(args.seed + 1, device)
    names = ("loss", "reward", "return_mean", "dones") + tuple(extra)
    t0 = time.perf_counter()
    steps_done = 0
    last_t, last_steps = t0, 0
    pending = []  # (iter, metrics): fetched in batches, each fetch a sync

    def drain(now):
        nonlocal last_t, last_steps
        if not pending:
            return
        span = max(now - last_t, 1e-9)
        span_steps = steps_done - last_steps
        # one host transfer for the whole window
        vals = torch.stack([torch.stack([m[k].to(torch.float64) for k in names])
                            for _, m in pending]).cpu().tolist()
        for (it_, _), v in zip(pending, vals):
            m = dict(zip(names, v))
            row = {
                "iter": it_,
                "loss": m["loss"],
                "reward": m["reward"],
                "reward_per_step": m["reward"] / (args.horizon * num_envs),
                "return_mean": m["return_mean"],
                "episodes": int(m["dones"]),
                "env_steps": (it_ + 1) * args.horizon * num_envs,
                "env_steps_per_s": span_steps / span,
                "env_steps_per_s_per_chip": span_steps / span / n_dev,
                "resets_per_s": int(m["dones"]) * len(pending) / span,
            }
            row.update({k: m[k] for k in extra})
            if metrics_f:
                metrics_f.write(json.dumps(row) + "\n")
        if metrics_f:
            metrics_f.flush()
        it_, m = pending[-1][0], dict(zip(names, vals[-1]))
        # the window's rate, not the cumulative one: the first window holds
        # the kernels' build
        sps = span_steps / span
        if lead:
            print(f"iter {it_:4d}  loss {m['loss']:8.4f}  reward/iter {m['reward']:8.1f}  "
                  + "".join(f"{k} {m[k]:7.4f}  " for k in extra)
                  + f"episodes {int(m['dones']):5d}  {sps:,.0f} env-steps/s")
        pending.clear()
        last_t, last_steps = now, steps_done

    # procgen envs make a fresh maze every reset: nothing to refresh
    every = 0 if env.procgen else args.refresh_layouts_every
    if lead and args.refresh_layouts_every and env.procgen:
        print("--refresh-layouts-every ignored: the env generates a fresh maze every reset")
    pool = refresh = None
    if every:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(1)
        refresh = pool.submit(env.prepare_bank, args.seed + 1000)
    try:
        for it in range(args.iters):
            key, k = split(key, 2)
            tstate, state, obs, depth, metrics = step(tstate, state, obs, depth, k)
            steps_done += args.horizon * num_envs
            pending.append((it, metrics))
            if every and it % every == every - 1:
                # the bank was compiled off-thread; auto-resets move the
                # episodes onto the new layouts as they end
                env.install_bank(refresh.result())
                refresh = pool.submit(env.prepare_bank, args.seed + 1000 + it + 1)
            if it % args.log_every == args.log_every - 1 or it == args.iters - 1:
                drain(time.perf_counter())
            if args.checkpoint and it and it % 50 == 0:
                checkpoint.save(f"{args.checkpoint}/it{it:06d}.rank{me}.pt",
                                {"train_state": tstate, "env_state": state})
                if lead:
                    print(f"checkpointed at iter {it}")
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if metrics_f:
            metrics_f.close()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def main():
    p = parser(__doc__)
    p.add_argument("--procgen", action="store_true",
                   help="maze-grid envs: generate a fresh maze on the device at every reset "
                        "(reference reset semantics, miniworld/envs/maze.py:100-149) instead "
                        "of cycling a compiled layout bank")
    args = p.parse_args()

    from miniworld_tpu_torch.parallel import make_train_step

    run(args, lambda env: make_train_step(env, horizon=args.horizon, lr=args.lr,
                                          gamma=args.gamma),
        env_kwargs={"procgen": True} if args.procgen else None)


if __name__ == "__main__":
    main()
