"""The port's actor-critic learner (miniworld_tpu_torch/parallel/
learner.py) against the JAX package's (miniworld_tpu/parallel/
learner.py), from the same converted parameters, on the CPU, at 80x60
and 32x24 (odd and even sides under SAME padding), both heads:
categorical (3 actions) and diagonal Gaussian (6-D, ``log_std``).

Tolerances:
  * ``forward``: logits and value within two bf16 ulps of the largest
    |value| of each (FWD_BF16_ULPS);
  * the parameter round trip through ``convert``: exact;
  * ``init_params`` from the same key: every weight within NORMAL_ULPS
    (rng.normal's bound, tests/test_torch_rng.py) plus one rounding of
    the He scale, biases and ``log_std`` exact;
  * ``a2c_loss`` / ``ppo_loss`` with the same forward outputs fed in:
    relative 1e-6, PPO's ``aux`` included;
  * the losses through the whole forward: within the forward's
    tolerance of their value;
  * gradients per leaf: within GRAD_RTOL of the leaf's largest |g| for
    weights and the heads' biases; the conv biases within
    CONV_BIAS_GRAD_RTOL, because the JAX package's gradient sums their
    bf16 cotangent over N x H x W with bf16 roundings on the way, where
    autograd accumulates in float32 (the worst leaf here, PPO's conv0
    bias at 80x60, came within 0.43 of its largest value);
  * ``adam_update`` with the same gradients: within one float32 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu.parallel import learner as JL
from miniworld_tpu_torch.convert import (
    opt_from_jax, opt_to_jax, params_from_jax, params_to_jax,
)
from miniworld_tpu_torch.ops import rng as trng
from miniworld_tpu_torch.parallel import learner as TL

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

SHAPES = [(60, 80), (24, 32)]
HEADS = [False, True]  # continuous
N = 12
FWD_BF16_ULPS = 2
NORMAL_ULPS = 3
GRAD_RTOL = 2e-2
CONV_BIAS_GRAD_RTOL = 0.5


def _num_actions(cont):
    return 6 if cont else 3


@pytest.fixture(scope="module")
def nets():
    """(H, W, continuous) -> (JAX params, the port's module holding them)."""
    out = {}
    for (h, w) in SHAPES:
        for cont in HEADS:
            jp = JL.init_params(jax.random.key(5), (h, w, 3), _num_actions(cont), continuous=cont)
            net = TL.ActorCritic((h, w, 3), _num_actions(cont), continuous=cont)
            net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
            out[h, w, cont] = (jp, net)
    return out


def _batch(h, w, cont, seed=2):
    rng = np.random.default_rng(seed)
    a = _num_actions(cont)
    rgb = rng.integers(0, 256, size=(N, h, w, 3), dtype=np.uint8)
    dep = rng.uniform(0.1, 30.0, size=(N, h, w, 1)).astype(np.float32)
    acts = (rng.uniform(-1, 1, size=(N, a)).astype(np.float32) if cont
            else rng.integers(0, a, size=N).astype(np.int32))
    rets = rng.normal(size=N).astype(np.float32)
    old_logp = rng.normal(-1.0, 0.3, size=N).astype(np.float32)
    adv = rng.normal(size=N).astype(np.float32)
    return rgb, dep, acts, rets, old_logp, adv


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _bf16_ulp(x) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _ulps(a, b) -> int:
    """Largest distance in float32 ulps (ordered integer view)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max(initial=0))


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("cont", HEADS)
@pytest.mark.parametrize("hw", SHAPES)
def test_forward(nets, hw, cont):
    jp, net = nets[(*hw, cont)]
    rgb, dep = _batch(*hw, cont)[:2]
    j_out, j_val = jax.jit(JL.forward)(jp, rgb, dep)
    with torch.no_grad():
        t_out, t_val = TL.forward(net, *_t(rgb, dep))
    assert t_out.dtype == torch.float32 and t_val.shape == (N,)
    for want, got in ((np.asarray(j_out), t_out.numpy()), (np.asarray(j_val), t_val.numpy())):
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_BF16_ULPS * _bf16_ulp(want))


@pytest.mark.parametrize("cont", HEADS)
@pytest.mark.parametrize("hw", SHAPES)
def test_param_round_trip(nets, hw, cont):
    jp, net = nets[(*hw, cont)]
    back = params_to_jax(net)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jp))
    got = _flat(back)
    for k, want in _flat(jp).items():
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert net.conv0.w.shape[1:] == (4, 3, 3)  # OIHW


@pytest.mark.parametrize("cont", HEADS)
@pytest.mark.parametrize("hw", SHAPES)
def test_init_params(hw, cont):
    a = _num_actions(cont)
    want = _flat(JL.init_params(jax.random.key(9), (*hw, 3), a, continuous=cont))
    got = _flat(params_to_jax(TL.init_params(trng.key_data(9), (*hw, 3), a, continuous=cont)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k.endswith(".w"):
            assert _ulps(got[k], w) <= NORMAL_ULPS + 1, k
        else:  # biases 0, log_std -0.5
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("cont", HEADS)
def test_losses_same_forward(monkeypatch, cont):
    """The losses and PPO's aux from the same forward outputs."""
    rng = np.random.default_rng(4)
    a = _num_actions(cont)
    out = rng.normal(size=(N, a)).astype(np.float32)
    val = rng.normal(size=N).astype(np.float32)
    _, dep, acts, rets, old_logp, adv = _batch(24, 32, cont)
    log_std = np.full(a, -0.5, np.float32) + rng.normal(0, 0.1, a).astype(np.float32)
    jp = {"log_std": jnp.asarray(log_std)} if cont else {}
    net = TL.ActorCritic((24, 32, 3), a, continuous=cont)
    if cont:
        net.log_std.data.copy_(torch.from_numpy(log_std))
    monkeypatch.setattr(JL, "forward", lambda p, r, d: (jnp.asarray(out), jnp.asarray(val)))
    monkeypatch.setattr(TL, "forward", lambda p, r, d: (torch.from_numpy(out), torch.from_numpy(val)))
    want = float(JL.a2c_loss(jp, None, None, acts, rets))
    got = float(TL.a2c_loss(net, None, None, *_t(acts, rets)).detach())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    j_loss, j_aux = JL.ppo_loss(jp, None, None, acts, old_logp, adv, rets)
    t_loss, t_aux = TL.ppo_loss(net, None, None, *_t(acts, old_logp, adv, rets))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    assert set(t_aux) == set(j_aux)
    for k in j_aux:
        np.testing.assert_allclose(float(t_aux[k]), float(j_aux[k]), rtol=1e-6,
                                   err_msg=k)


def _check_grads(want_tree, got: dict):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        tol = CONV_BIAS_GRAD_RTOL if (k.startswith("conv") and k.endswith(".b")) else GRAD_RTOL
        err = float(np.abs(got[k].detach().numpy() - w).max())
        assert err <= tol * float(np.abs(w).max()), (k, err, float(np.abs(w).max()))


@pytest.mark.parametrize("cont", HEADS)
@pytest.mark.parametrize("hw", SHAPES)
def test_grads(nets, hw, cont):
    jp, net = nets[(*hw, cont)]
    rgb, dep, acts, rets, old_logp, adv = _batch(*hw, cont)
    j_loss, j_g = jax.jit(jax.value_and_grad(JL.a2c_loss))(jp, rgb, dep, acts, rets)
    loss = TL.a2c_loss(net, *_t(rgb, dep, acts, rets))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0,
                               atol=FWD_BF16_ULPS * _bf16_ulp(np.asarray(j_loss)))
    _check_grads(j_g, TL.loss_grads(net, loss))
    (j_loss, _), j_g = jax.jit(jax.value_and_grad(JL.ppo_loss, has_aux=True))(
        jp, rgb, dep, acts, old_logp, adv, rets)
    loss, _ = TL.ppo_loss(net, *_t(rgb, dep, acts, old_logp, adv, rets))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0,
                               atol=FWD_BF16_ULPS * _bf16_ulp(np.asarray(j_loss)))
    _check_grads(j_g, TL.loss_grads(net, loss))


@pytest.mark.parametrize("cont", HEADS)
def test_adam(nets, cont):
    """Four Adam steps from zeros with the same gradients, as the JAX
    package's adam_update: parameters, moments and t within one ulp."""
    jp, _ = nets[(24, 32, cont)]
    net = TL.ActorCritic((24, 32, 3), _num_actions(cont), continuous=cont)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    j_opt, t_opt = JL.adam_init(jp), TL.adam_init(net)
    rng = np.random.default_rng(6)
    update = jax.jit(JL.adam_update)
    for i in range(4):
        g_np = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 10.0 ** rng.uniform(-6, 0))
                            .astype(np.float32), jax.tree.map(np.asarray, jp))
        jp, j_opt = update(jp, g_np, j_opt)
        net, t_opt = TL.adam_update(net, params_from_jax(g_np), t_opt)
        for k, w in _flat(jp).items():
            assert _ulps(_flat(params_to_jax(net))[k], w) <= 1, (i, k)
        j_np = jax.tree.map(np.asarray, j_opt)
        back = opt_to_jax(t_opt)
        assert int(back["t"]) == int(j_np["t"]) == i + 1
        for part in ("m", "v"):
            for k, w in _flat(j_np[part]).items():
                assert _ulps(_flat(back[part])[k], w) <= 1, (i, part, k)
    # the state converts both ways
    again = opt_from_jax(jax.tree.map(np.asarray, j_opt))
    assert int(again["t"]) == 4 and set(again["m"]) == set(t_opt["m"])
