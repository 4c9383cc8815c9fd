"""Shared helpers of the trainer parity tests (tests/test_torch_train*.py,
tests/test_torch_parallel.py): JAX's rollout under its learner's policy,
a port policy that follows JAX's actions, and the whole-step rules.

Whole-step rules (the port's trainer against the JAX package's):
rewards, dones and the actions taken equal (the port's categorical draw
may differ where two candidates nearly tie: it then follows JAX's action
and the count of such draws is reported), the stacked observations by
the render rules (tests/_torch_parity.py), the loss and float metrics
within two bf16 ulps of their value (the forward's tolerance), the
parameters after the step within 2 * lr: the first Adam steps move every
parameter by about lr whatever the size of its gradient, so a gradient
near 0 whose sign bf16 rounding flips moves it the other way.
"""

from __future__ import annotations

import itertools

import jax
import numpy as np
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.parallel import train as JT
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.ops import rng as trng
from miniworld_tpu_torch.convert import params_from_jax, params_to_jax
from miniworld_tpu_torch.parallel import learner as TL
from miniworld_tpu_torch.parallel import train as TT

from _torch_parity import assert_images_match, assert_states_match, to_port_state

LR = 3e-4
MAX_PARAM_DIFF = 2 * LR


def bf16_tol(x) -> float:
    """Two bf16 ulps of |x| (at least of 2**-20)."""
    x = max(float(np.abs(np.asarray(x)).max()), 2.0 ** -20)
    return 2 * 2.0 ** (np.floor(np.log2(x)) - 7)


def port_tstate(j_tstate, obs_shape, num_actions, continuous=False):
    """The port's train state holding a JAX train state's parameters and
    a fresh Adam state (as JAX's init makes)."""
    net = TL.ActorCritic(obs_shape, num_actions, continuous=continuous)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, j_tstate["params"])))
    return {"params": net, "opt": TL.adam_init(net)}


def jax_policy_rollout(jenv, horizon: int, continuous=False):
    """jit of JAX's rollout_fn under its learner's policy, the parameters
    an argument: ``fn(params, state, obs, depth, key) -> outs``."""

    def run(params, bank, atlas, state, obs, depth, key):
        fn = jenv.rollout_fn(horizon, policy=JT._policy_factory(params, continuous),
                             return_obs=True, return_actions=True)
        return fn(bank, atlas, state, obs, depth, key)[3]

    jitted = jax.jit(run)
    return lambda params, state, obs, depth, key: jitted(params, jenv._bank, jenv._atlas, state,
                                                         obs, depth, key)


def follow(monkeypatch, jax_actions_per_call: list):
    """Make the port's learner policy return JAX's actions: call c of the
    policy in rollout r returns ``jax_actions_per_call[r][c]``. Returns a
    record of the draws and of those whose port value differed."""
    record = {"draws": 0, "differ": 0}
    factory = TT._policy_factory
    calls = {"rollout": -1}

    def patched(params, continuous):
        calls["rollout"] += 1
        r, t = calls["rollout"], itertools.count()
        pol = factory(params, continuous)

        def policy(obs, depth, key):
            got = pol(obs, depth, key)
            want = torch.from_numpy(np.array(jax_actions_per_call[r][next(t)]))
            record["draws"] += got.shape[0]
            same = (got == want) if got.dim() == 1 else (got == want).all(-1)
            record["differ"] += int((~same).sum())
            return want.to(got.dtype)
        return policy

    monkeypatch.setattr(TT, "_policy_factory", patched)
    return record


def capture_rollouts(monkeypatch, env):
    """Record the outs of every ``env.rollout`` call."""
    seen = []
    orig = env.rollout

    def rollout(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[2])
        return out

    monkeypatch.setattr(env, "rollout", rollout)
    return seen


def assert_rollout_outs(j_outs, t_outs, continuous=False):
    """Actions, rewards, done masks and per-step sums equal; the stacked
    observations by the render rules."""
    for k in ("rewards", "done_mask", "reward", "dones"):
        np.testing.assert_array_equal(t_outs[k].numpy(), np.asarray(j_outs[k]), err_msg=k)
    got, want = t_outs["actions"].numpy(), np.asarray(j_outs["actions"])
    if continuous:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
    j_img, t_img = j_outs["obs"], t_outs["obs"]
    if isinstance(j_img, dict):
        np.testing.assert_array_equal(t_img["goal"].numpy(), np.asarray(j_img["goal"]))
        j_img, t_img = j_img["obs"], t_img["obs"]
    T, B = t_img.shape[:2]
    assert tuple(j_img.shape) == tuple(t_img.shape)
    assert_images_match(np.asarray(j_img).reshape(T * B, *j_img.shape[2:]),
                        np.asarray(j_outs["depth"]).reshape(T * B, *j_img.shape[2:4], 1),
                        t_img.reshape(T * B, *t_img.shape[2:]),
                        t_outs["depth"].reshape(T * B, *t_img.shape[2:4], 1))


def assert_metrics(j_m, t_m, logp_scale: float):
    """Dones equal, the float metrics within two bf16 ulps of their value;
    PPO's ``approx_kl``, a mean difference of log-probs, within two bf16
    ulps of the log-probs' size ``logp_scale`` (log A for A actions at
    near-uniform logits)."""
    assert set(t_m) == set(j_m)
    for k, v in j_m.items():
        v = np.asarray(v)
        if k == "dones":
            assert int(t_m[k]) == int(v)
        else:
            tol = bf16_tol(logp_scale if k == "approx_kl" else v)
            np.testing.assert_allclose(float(t_m[k]), float(v), rtol=0, atol=tol, err_msg=k)


def max_param_diff(j_params, net) -> float:
    want = jax.tree.map(np.asarray, j_params)
    got = params_to_jax(net)
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def check_rollout_policy(env_id, b, w, h, horizon):
    """``MiniWorldVec.rollout(policy=..., return_obs=True,
    return_actions=True)`` with the random policy passed explicitly,
    against JAX's ``rollout_fn`` from the same state and key: the stacked
    outputs by ``assert_rollout_outs``, the per-step sums equal, the
    final states within FLOAT_ATOL, each step's policy key the first of
    two splits of ``split(key, horizon)[t]``; ``policy=None`` gives the
    same sums and state from actions drawn before the loop, and stacks
    nothing."""
    jenv = JaxVec(env_id, num_envs=b, obs_width=w, obs_height=h)
    env = MiniWorldVec(env_id, b, obs_width=w, obs_height=h, device="cpu")
    j_state, (j_obs, j_depth) = jenv.reset(jax.random.key(3))
    fn = jax.jit(jenv.rollout_fn(horizon, policy=lambda o, d, k: jenv.sample_actions(k, b),
                                 return_obs=True, return_actions=True))
    j_state2, _, _, j_outs = fn(jenv._bank, jenv._atlas, j_state, j_obs, j_depth,
                                jax.random.key(7))

    state = to_port_state(j_state)
    obs = env._obs(state)[0]
    key = trng.key_data(7)
    seen = []

    def policy(o, d, k):  # the random policy, passed explicitly
        assert isinstance(o, dict) == (env_id == "MiniWorld-Sign-v0") and d.shape[-1] == 1
        seen.append(k)
        return env.sample_actions(k, b)

    t_state2, t_obs2, t_outs = env.rollout(state, obs, key, horizon, policy=policy,
                                           return_obs=True, return_actions=True)
    assert len(seen) == horizon
    assert_rollout_outs(j_outs, t_outs)
    assert set(t_outs) == set(j_outs)
    for k in ("reward", "dones", "obs_sum"):
        np.testing.assert_array_equal(t_outs[k].numpy(), np.asarray(j_outs[k]), err_msg=k)
    assert_states_match(j_state2, t_state2)
    # policy=None: the actions drawn before the loop are the same ones, and
    # nothing else is stacked
    t_state3, t_obs3, plain = env.rollout(state, obs, key, horizon)
    assert set(plain) == {"reward", "dones", "obs_sum"}
    for k in plain:
        np.testing.assert_array_equal(plain[k].numpy(), t_outs[k].numpy(), err_msg=k)
    for a, b in zip(t_state3.tensors().values(), t_state2.tensors().values()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(torch.stack(seen).numpy(),
                                  trng.split(trng.split(key, horizon), 2)[:, 0].numpy())
