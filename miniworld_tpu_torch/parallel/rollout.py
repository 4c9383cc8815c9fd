"""Rollout-only data parallelism: experience generation over the ranks
with no learner attached.

Counterpart of ``miniworld_tpu/parallel/rollout.py``: the deployment
shape for dataset generation, evaluation or the actor side of a
disaggregated learner. Each rank steps and renders its own shard of the
global env batch; envs are independent, so the rollout calls no
collective (the tests count ``torch.distributed``'s calls). Collectives
belong to the learner's gradient average (parallel/learner.py) only.
"""

from __future__ import annotations

from types import SimpleNamespace

from miniworld_tpu_torch.ops import rng as rng_ops
from miniworld_tpu_torch.parallel import dist


def make_sharded_rollout(env, horizon: int, *, policy=None):
    """Build the rank's rollout of its shard (``env`` holds the rank's
    envs, ``num_envs`` = B / world size). Returns a namespace with:

      init(key) -> (state, obs, depth)     the rank's share of the
        global reset ``split(key, B)``
      step(state, obs, depth, key) -> (state, obs, depth, outs)
        ``horizon`` steps of ``MiniWorldVec.rollout`` with the rank
        folded into the key (distinct randomness per shard); ``outs``
        holds this rank's per-step sums, (horizon,) each

    (Learners that need stacked per-env observations and actions go
    through make_train_step / make_ppo_step instead.)
    """

    def init(key):
        state, obs = dist.reset_shard(env, key)
        obs, depth = obs if env.with_depth else (obs, None)
        return state, obs, depth

    def step(state, obs, depth, key):
        key = rng_ops.fold_in(key.to(env.device), dist.rank())
        state, obs, outs = env.rollout(state, (obs, depth) if env.with_depth else obs, key,
                                       horizon, policy=policy)
        obs, depth = obs if env.with_depth else (obs, None)
        return state, obs, depth, outs

    return SimpleNamespace(init=init, step=step)
