"""One A2C step (``make_train_step``) and one PPO step (``make_ppo_step``,
horizon 4, 2 epochs of 2 minibatches) of the port against the JAX
package's at ``make_mesh(1)``, from the same converted parameters and
reset key, on OneRoomS6Fast B=8 at 32x24, under the whole-step rules of
tests/_torch_train.py: the rollout's actions (following JAX's where a
categorical draw differed; the count is asserted and printed), rewards,
dones and stacked observations, the loss and metrics within the
forward's tolerance, the parameters within 2 * lr. The port's ``init``
resets the same envs as JAX's (states within FLOAT_ATOL).
"""

import jax
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.parallel import make_mesh, make_ppo_step as j_ppo, make_train_step as j_a2c
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.ops import rng as trng
from miniworld_tpu_torch.parallel import make_ppo_step, make_train_step

from _torch_parity import assert_states_match, to_port_state
from _torch_train import (
    MAX_PARAM_DIFF, assert_metrics, assert_rollout_outs, capture_rollouts, follow,
    jax_policy_rollout, max_param_diff, port_tstate,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

ENV_ID = "MiniWorld-OneRoomS6Fast-v0"
B, W, H, HORIZON = 8, 32, 24, 4
# a draw whose two best candidates nearly tie may differ (tests/test_torch_rng.py)
MAX_DIFFERING_DRAWS = 2


@pytest.fixture(scope="module")
def envs():
    return (JaxVec(ENV_ID, num_envs=B, obs_width=W, obs_height=H),
            MiniWorldVec(ENV_ID, B, obs_width=W, obs_height=H, device="cpu"))


@pytest.fixture(scope="module")
def start(envs):
    """JAX's init from key(0) (parameters, reset, render) and its
    policy rollout, shared by both steps."""
    jenv, _ = envs
    _, init = j_a2c(jenv, make_mesh(1), horizon=HORIZON)
    return init(jax.random.key(0)), jax_policy_rollout(jenv, HORIZON)


def _run(monkeypatch, envs, start, kind):
    jenv, env = envs
    (j_ts, j_state, j_obs, j_depth), j_rollout = start
    key = jax.random.key(1)
    if kind == "a2c":
        j_step, _ = j_a2c(jenv, make_mesh(1), horizon=HORIZON)
        step, init = make_train_step(env, horizon=HORIZON)
        k_roll = jax.random.fold_in(key, 0)
    else:
        j_step, _ = j_ppo(jenv, make_mesh(1), horizon=HORIZON, epochs=2, minibatches=2)
        step, init = make_ppo_step(env, horizon=HORIZON, epochs=2, minibatches=2)
        k_roll = jax.random.split(jax.random.fold_in(key, 0))[0]
    j_outs = j_rollout(j_ts["params"], j_state, j_obs, j_depth, k_roll)
    j_new, *_, j_m = j_step(j_ts, j_state, j_obs, j_depth, key)

    # the port's init resets the same envs; the step starts from JAX's
    # parameters and state (the reset's one-ulp placements, ROADMAP C1)
    _, t_state0, _, _ = init(trng.key_data(0))
    assert_states_match(j_state, t_state0)
    ts = port_tstate(j_ts, (H, W, 3), env._action_table.shape[0])
    state = to_port_state(j_state)
    obs, depth = env._obs(state)[0]
    record = follow(monkeypatch, [j_outs["actions"]])
    seen = capture_rollouts(monkeypatch, env)
    ts, state, obs, depth, m = step(ts, state, obs, depth, trng.key_data(1))
    print(f"{kind}: {record['differ']} of {record['draws']} categorical draws differed")
    assert record["draws"] == B * HORIZON and record["differ"] <= MAX_DIFFERING_DRAWS
    assert_rollout_outs(j_outs, seen[0])
    assert_metrics(j_m, m, np.log(env._action_table.shape[0]))
    diff = max_param_diff(j_new["params"], ts["params"])
    print(f"{kind}: parameters within {diff:.3e} of JAX's ({MAX_PARAM_DIFF:.1e} allowed)")
    assert diff <= MAX_PARAM_DIFF
    assert int(ts["opt"]["t"]) == int(j_new["opt"]["t"]) == (1 if kind == "a2c" else 4)
    return j_new, ts


def test_a2c_step(monkeypatch, envs, start):
    _run(monkeypatch, envs, start, "a2c")


def test_ppo_step(monkeypatch, envs, start):
    _run(monkeypatch, envs, start, "ppo")
