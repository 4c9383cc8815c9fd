"""The port's trainer pieces against the JAX package's, on the CPU:
``discounted_returns`` and ``gae`` (rtol 1e-6, atol 1e-6, and the two
cases of tests/test_train.py), ``MiniWorldVec.rollout(policy=...,
return_obs=True, return_actions=True)`` against JAX's ``rollout_fn``
with the random policy passed explicitly (OneRoomS6Fast B=8 at 32x24;
Sign's dict observations in tests/test_torch_train_sign.py): actions, rewards and done masks equal,
the stacked observations by the render rules, ``policy=None`` giving
what it gave before; the Gaussian head's A2C and PPO steps after
``set_discrete_actions(None)`` (the counterpart of
tests/test_train.py::test_continuous_gaussian_head); a checkpoint round
trip, exact.
"""

import numpy as np
import pytest
import torch

from miniworld_tpu.parallel.train import discounted_returns as j_returns, gae as j_gae
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.ops import rng as trng
from miniworld_tpu_torch.parallel import make_ppo_step, make_train_step
from miniworld_tpu_torch.parallel.train import discounted_returns, gae
from miniworld_tpu_torch.state import EnvState
from miniworld_tpu_torch.utils import checkpoint

from _torch_train import check_rollout_policy
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H, HORIZON = 8, 32, 24, 4


def _returns_inputs(seed, T=6, b=5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (T, b)).astype(np.float32), rng.random((T, b)) < 0.3,
            rng.normal(size=(T, b)).astype(np.float32), rng.normal(size=b).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_returns_and_gae(seed):
    rewards, dones, values, boot = _returns_inputs(seed)
    want = np.asarray(j_returns(rewards, dones, boot, 0.99))
    got = discounted_returns(*[torch.from_numpy(a) for a in (rewards, dones, boot)], 0.99)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = np.asarray(j_gae(rewards, dones, values, boot, 0.99, 0.95))
    got = gae(*[torch.from_numpy(a) for a in (rewards, dones, values, boot)], 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_discounted_returns_cut_at_done():
    ret = discounted_returns(torch.tensor([[1.0], [1.0], [1.0]]),
                             torch.tensor([[False], [True], [False]]), torch.tensor([10.0]), 0.5)
    # t=2: 1 + 0.5*10 = 6 ; t=1: done -> 1 ; t=0: 1 + 0.5*1 = 1.5
    np.testing.assert_allclose(ret[:, 0].numpy(), [1.5, 1.0, 6.0])


def test_gae_matches_direct_recursion():
    rewards, dones, values, boot = _returns_inputs(3, T=5, b=4)
    gamma, lam = 0.9, 0.8
    adv = gae(*[torch.from_numpy(a) for a in (rewards, dones, values, boot)], gamma, lam).numpy()
    v_next = np.concatenate([values[1:], boot[None]], axis=0)
    nonterm = 1.0 - dones.astype(np.float32)
    delta = rewards + gamma * nonterm * v_next - values
    want = np.zeros((5, 4), np.float32)
    acc = np.zeros(4, np.float32)
    for t in reversed(range(5)):
        acc = delta[t] + gamma * lam * nonterm[t] * acc
        want[t] = acc
    np.testing.assert_allclose(adv, want, rtol=1e-5, atol=1e-6)


def test_rollout_policy():
    check_rollout_policy("MiniWorld-OneRoomS6Fast-v0", B, W, H, HORIZON)


def _params_delta(a: dict, net) -> float:
    return max(float((a[n] - p.detach()).abs().max()) for n, p in net.named_parameters())


def _snapshot(net) -> dict:
    return {n: p.detach().clone() for n, p in net.named_parameters()}


def test_continuous_gaussian_head():
    """Without a discrete table the trainers use the Gaussian head: 6-D
    Box actions, finite loss and diagnostics, every parameter updated by
    A2C and PPO, ``log_std`` included."""
    env = MiniWorldVec("MiniWorld-OneRoomS6Fast-v0", B, obs_width=W, obs_height=H, device="cpu")
    env.set_discrete_actions(None)
    with pytest.raises(ValueError, match=r"\(n, 6\)"):
        env.set_discrete_actions(np.zeros((3, 2)))
    assert env.sample_actions(trng.key_data(0)).shape == (B, 6)
    step, init = make_train_step(env, horizon=3)
    ts, state, obs, depth = init(trng.key_data(0))
    assert ts["params"].continuous and ts["params"].pi.w.shape == (256, 6)
    before = _snapshot(ts["params"])
    ts, state2, obs, depth, m = step(ts, state, obs, depth, trng.key_data(1))
    assert np.isfinite(float(m["loss"]))
    assert _params_delta(before, ts["params"]) > 0
    assert float((ts["params"].log_std - before["log_std"]).abs().max()) > 0
    assert not torch.equal(state.pos, state2.pos)

    pstep, pinit = make_ppo_step(env, horizon=4, epochs=2, minibatches=2)
    ts, state, obs, depth = pinit(trng.key_data(2))
    before = _snapshot(ts["params"])
    ts, _, _, _, m = pstep(ts, state, obs, depth, trng.key_data(3))
    for k in ("loss", "approx_kl", "clip_frac", "return_mean"):
        assert np.isfinite(float(m[k])), k
    assert 0.0 <= float(m["clip_frac"]) <= 1.0
    assert _params_delta(before, ts["params"]) > 0


def test_checkpoint_round_trip(tmp_path):
    env = MiniWorldVec("MiniWorld-OneRoomS6Fast-v0", 4, obs_width=W, obs_height=H, device="cpu")
    step, init = make_train_step(env, horizon=2)
    ts, state, obs, depth = init(trng.key_data(0))
    ts, state, obs, depth, _ = step(ts, state, obs, depth, trng.key_data(1))
    path = str(tmp_path / "ckpt" / "it000001.pt")
    checkpoint.save(path, {"train_state": ts, "env_state": state})
    fresh, _, _, _ = init(trng.key_data(5))
    back = checkpoint.restore(path, like={"train_state": fresh})
    assert back["train_state"]["params"] is fresh["params"]
    for (n, a), (_, b) in zip(ts["params"].state_dict().items(),
                              back["train_state"]["params"].state_dict().items()):
        assert torch.equal(a, b), n
    for part in ("m", "v"):
        for n, a in ts["opt"][part].items():
            assert torch.equal(a, back["train_state"]["opt"][part][n]), (part, n)
    assert torch.equal(ts["opt"]["t"], back["train_state"]["opt"]["t"])
    restored = back["env_state"]
    assert isinstance(restored, EnvState)
    for (n, a), b in zip(state.tensors().items(), restored.tensors().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    # the restored run goes on exactly as the saved one
    ts2, state2, *_ , m2 = step(ts, state, obs, depth, trng.key_data(2))
    back_ts = back["train_state"]
    _, state3, *_, m3 = step(back_ts, restored, obs, depth, trng.key_data(2))
    assert float(m2["loss"]) == float(m3["loss"])
    assert torch.equal(state2.pos, state3.pos)
    # without a template the module comes back as its state dict
    assert isinstance(checkpoint.restore(path)["train_state"]["params"], dict)


@pytest.mark.parametrize("off", [0, 1, 5, 23, 24, 47])
def test_rolled_slice(off):
    """PPO's minibatch of the rolled transitions, taken without rolling
    them: equal to ``torch.roll(x, off, 0)[start:start + size]``."""
    from miniworld_tpu_torch.parallel.train import _rolled_slice

    x = torch.arange(48 * 3).reshape(48, 3)
    rolled = torch.roll(x, off, 0)
    for start in range(0, 48, 12):
        assert torch.equal(_rolled_slice(x, off, start, 12), rolled[start:start + 12])
