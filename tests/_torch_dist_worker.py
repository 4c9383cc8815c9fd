"""One rank of the port's data-parallel A2C step over a gloo group on a
FileStore (no network), for tests/test_torch_parallel.py:

    python tests/_torch_dist_worker.py RANK WORLD STORE IN OUT

``IN`` (torch.save, written by the test) holds the JAX package's
parameters as the port's state dict, this rank's env state, the step's
key seed and JAX's actions for this rank's rollout; the rank steps its
4 envs with a policy that follows those actions (counting the draws of
its own that differ), and writes to ``OUT`` its rollout's outputs, the
parameters and Adam state after the step, the metrics, its share of the
global reset from ``init``, the ``torch.distributed`` collectives that
its sharded rollout and its train step called, and what
``shard_env_batch`` and ``replicate`` gave it. Imports torch and
the port only.
"""

from __future__ import annotations

import itertools
import sys

import torch
import torch.distributed as dist

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "barrier", "send",
               "recv", "scatter", "gather")


def count_collectives(counts: dict, set_attr=setattr) -> None:
    """Wrap each collective of ``torch.distributed`` to count its calls
    (``set_attr``: pytest's ``monkeypatch.setattr`` to undo it after a
    test)."""
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)

        set_attr(dist, name, wrapped)


def main(rank: int, world: int, store_path: str, in_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    from miniworld_tpu_torch import MiniWorldVec
    from miniworld_tpu_torch.ops import rng as trng
    from miniworld_tpu_torch.parallel import dist as pdist
    from miniworld_tpu_torch.parallel import learner as TL, make_sharded_rollout, make_train_step
    from miniworld_tpu_torch.parallel import train as TT
    from miniworld_tpu_torch.utils import checkpoint

    inp = checkpoint.restore(in_path)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        env = MiniWorldVec(inp["env_id"], inp["b_local"], obs_width=inp["w"], obs_height=inp["h"],
                           device="cpu")
        step, init = make_train_step(env, horizon=inp["horizon"])
        _, init_state, _, _ = init(trng.key_data(inp["init_seed"]))

        # the mesh helpers: this rank's slice of a global batch, rank 0's
        # values on every rank
        shard = pdist.shard_env_batch({"ids": torch.arange(inp["b_local"] * world)})
        replicated = pdist.replicate({"t": torch.full((3,), float(rank) + 1.0)})

        counts = {}
        count_collectives(counts)
        sharded = make_sharded_rollout(env, inp["horizon"])
        s, o, d = sharded.init(trng.key_data(inp["init_seed"]))
        sharded.step(s, o, d, trng.key_data(inp["key_seed"]))
        rollout_calls = dict(counts)
        counts.clear()

        net = TL.ActorCritic((inp["h"], inp["w"], 3), inp["num_actions"])
        net.load_state_dict(inp["params"])
        tstate = {"params": net, "opt": TL.adam_init(net)}
        state = inp["state"]
        obs, depth = env._obs(state)[0]
        record = {"draws": 0, "differ": 0}
        factory, t_call = TT._policy_factory, itertools.count()

        def following(params, continuous):
            pol = factory(params, continuous)

            def policy(o, d, key):
                got = pol(o, d, key)
                want = inp["actions"][next(t_call)].to(got.dtype)
                record["draws"] += got.shape[0]
                record["differ"] += int((got != want).sum())
                return want
            return policy

        TT._policy_factory = following
        seen, orig = [], env.rollout

        def rollout(*a, **kw):
            seen.append(orig(*a, **kw))
            return seen[-1]

        env.rollout = rollout
        tstate, state, obs, depth, metrics = step(tstate, state, obs, depth,
                                                  trng.key_data(inp["key_seed"]))
        checkpoint.save(out_path, {
            "outs": seen[0][2], "params": tstate["params"], "opt": tstate["opt"],
            "metrics": metrics, "init_state": init_state, "record": record,
            "rollout_collectives": rollout_calls, "step_collectives": dict(counts),
            "shard": shard["ids"], "replicated": replicated["t"]})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
