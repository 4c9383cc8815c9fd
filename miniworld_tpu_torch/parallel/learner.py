"""A compact actor-critic learner for batched RGB-D observations.

Counterpart of ``miniworld_tpu/parallel/learner.py``: a small bf16 CNN
torso with policy and value heads, the A2C and PPO losses and Adam. The
network is an ``nn.Module`` whose parameter names are the JAX package's
param dict flattened with dots (``conv0.w``, ..., ``fc.b``, ``pi.w``,
``v.w``, ``log_std``), so ``convert.params_from_jax`` / ``params_to_jax``
move parameters across one for one. Conv weights are OIHW here (HWIO in
JAX); the activations are flattened in NHWC order, as JAX flattens them,
so ``fc.w`` is the same matrix in both.

Gradients come from autograd. Under a ``torch.distributed`` group of
more than one rank, ``grad_step`` and ``ppo_grad_step`` all-reduce the
gradients, the loss and PPO's diagnostics to their mean (JAX's
``pmean`` over the mesh axis) before the Adam update, so every rank
applies the same update.

The casts follow the JAX forward step by step (learner.py:92-115): the
image scaled in bf16 (XLA's ``* (1/255)`` in f32, rounded once), depth
scaled in f32 then rounded, convolutions and their biases in bf16, the
fc layer's product in f32 from bf16 operands, the heads likewise. The
convolutions and dots are library calls (cuDNN and cuBLAS on the card):
the JAX package computes them outside any kernel too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from miniworld_tpu_torch.ops import geom, rng as rng_ops
from miniworld_tpu_torch.parallel import dist

_LOG_2PI = math.log(2.0 * math.pi)
_BF16 = torch.bfloat16
_INV_255 = 1.0 / 255.0  # XLA's constant for `/ 255.0` (a product in f32)
_INV_100 = 1.0 / 100.0


class ActorCritic(nn.Module):
    """He-init CNN torso (3x3 stride-2 convs, SAME padding) + policy and
    value heads (JAX learner.py:27-68). ``continuous=True``: the pi head
    emits Gaussian means and a state-independent ``log_std`` vector is a
    parameter."""

    def __init__(self, obs_shape, num_actions: int, channels=(16, 32, 32),
                 hidden: int = 256, continuous: bool = False, device=None):
        super().__init__()
        h, w, c = obs_shape
        in_c = c + 1  # RGB + depth
        self.n_convs = len(channels)
        for i, out_c in enumerate(channels):
            self.add_module(f"conv{i}", _Dense((out_c, in_c, 3, 3), out_c, device))
            in_c = out_c
            h, w = -(-h // 2), -(-w // 2)
        self.fc = _Dense((h * w * in_c, hidden), hidden, device)
        self.pi = _Dense((hidden, num_actions), num_actions, device)
        self.v = _Dense((hidden, 1), 1, device)
        self.continuous = bool(continuous)
        if continuous:
            self.log_std = nn.Parameter(torch.full((num_actions,), -0.5, device=device))

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor):
        """(B, H, W, 3) u8 + (B, H, W, 1) f32 -> (logits (B, A) f32,
        value (B,) f32)."""
        x = torch.cat([(rgb.to(_BF16).float() * _INV_255).to(_BF16),
                       (depth * _INV_100).to(_BF16)], dim=-1)
        x = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC batch
        for i in range(self.n_convs):
            p = getattr(self, f"conv{i}")
            # SAME at stride 2, kernel 3: an even side is padded (0, 1),
            # an odd one (1, 1); the bias is added in bf16 after the
            # conv's own bf16 rounding, as JAX adds it
            x = F.pad(x, (x.shape[3] % 2, 1, x.shape[2] % 2, 1))
            x = F.conv2d(x, p.w.to(_BF16), stride=2) + p.b.to(_BF16)[:, None, None]
            x = torch.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # JAX's NHWC flatten
        x = torch.relu(_dot_f32(x, self.fc.w) + self.fc.b)
        x = x.to(_BF16)
        logits = _dot_f32(x, self.pi.w) + self.pi.b
        value = (_dot_f32(x, self.v.w) + self.v.b)[:, 0]
        return logits, value


class _Dense(nn.Module):
    """One layer's ``w`` and ``b``, the JAX dict's leaf names."""

    def __init__(self, w_shape, n_out: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(w_shape, device=device))
        self.b = nn.Parameter(torch.zeros((n_out,), device=device))


def _dot_f32(x_bf16: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w.astype(bf16), preferred_element_type=f32)``: bf16
    operands, products and sums in f32 (a product of two bf16 values is
    exact in f32)."""
    return torch.matmul(x_bf16.float(), w.to(_BF16).float())


def init_params(key: torch.Tensor, obs_shape, num_actions: int, channels=(16, 32, 32),
                hidden: int = 256, continuous: bool = False, device=None) -> ActorCritic:
    """The JAX package's ``init_params`` from key data (2,): weights drawn
    with ``rng.normal`` from ``split(key, n_convs + 3)`` (HWIO draws for
    the convs, stored OIHW), biases 0, ``log_std`` -0.5."""
    key = key.to(device)
    net = ActorCritic(obs_shape, num_actions, channels, hidden, continuous, device)
    ks = rng_ops.split(key, len(channels) + 3)
    in_c = obs_shape[2] + 1
    with torch.no_grad():
        for i, out_c in enumerate(channels):
            w = rng_ops.normal(ks[i], (3, 3, in_c, out_c)) * math.sqrt(2.0 / (9 * in_c))
            getattr(net, f"conv{i}").w.copy_(w.permute(3, 2, 0, 1))
            in_c = out_c
        flat = net.fc.w.shape[0]
        net.fc.w.copy_(rng_ops.normal(ks[-3], (flat, hidden)) * math.sqrt(2.0 / flat))
        net.pi.w.copy_(rng_ops.normal(ks[-2], (hidden, num_actions)) * 0.01)
        net.v.w.copy_(rng_ops.normal(ks[-1], (hidden, 1)) * 0.01)
    return net


def forward(params: ActorCritic, rgb: torch.Tensor, depth: torch.Tensor):
    """(B, H, W, 3) u8 + (B, H, W, 1) f32 -> (logits (B, A), value (B,))."""
    return params(rgb, depth)


def gaussian_sample(params: ActorCritic, mean: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The diagonal-Gaussian policy's draw: ``mean + exp(log_std) * eps``,
    eps ``rng.normal(key, mean.shape)``."""
    return mean + torch.exp(params.log_std) * rng_ops.normal(key, tuple(mean.shape))


def gaussian_logp(params: ActorCritic, mean: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """(B, A) mean + actions -> (B,) joint log-density."""
    log_std = params.log_std
    z = (actions - mean) * torch.exp(-log_std)
    return -0.5 * torch.sum(z * z + 2.0 * log_std + _LOG_2PI, dim=-1)


def gaussian_entropy(params: ActorCritic) -> torch.Tensor:
    """() closed-form entropy of the diagonal Gaussian head."""
    return 0.5 * torch.sum(2.0 * params.log_std + _LOG_2PI + 1.0)


def logp_entropy(params: ActorCritic, out: torch.Tensor, actions: torch.Tensor):
    """(log-prob of ``actions`` (B,), entropy ()) under the head: the
    Gaussian one with ``log_std``, else categorical over ``out``."""
    if params.continuous:
        return gaussian_logp(params, out, actions), gaussian_entropy(params)
    logp = torch.log_softmax(out, dim=1)
    act_logp = torch.gather(logp, 1, actions.long()[:, None])[:, 0]
    return act_logp, -torch.mean(torch.sum(torch.exp(logp) * logp, dim=1))


def a2c_loss(params: ActorCritic, rgb, depth, actions, returns) -> torch.Tensor:
    """Advantage actor-critic loss for one batch of transitions (JAX
    learner.py:119-136); the advantage stops the value's gradient."""
    out, value = forward(params, rgb, depth)
    act_logp, ent = logp_entropy(params, out, actions)
    adv = returns - value.detach()
    pg = -torch.mean(act_logp * adv)
    vf = 0.5 * torch.mean((returns - value) ** 2)
    return pg + vf - 0.01 * ent


def ppo_loss(params: ActorCritic, rgb, depth, actions, old_logp, adv, returns, *,
             clip_eps: float = 0.2, vf_coef: float = 0.5, ent_coef: float = 0.01):
    """Clipped-surrogate PPO loss on one minibatch (JAX learner.py:
    178-206): returns (loss, aux) with ``approx_kl`` (E[old_logp - logp])
    and ``clip_frac``. ``old_logp`` and ``adv`` carry no gradient."""
    out, value = forward(params, rgb, depth)
    logp, ent = logp_entropy(params, out, actions)
    ratio = torch.exp(logp - old_logp)
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    pg = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
    vf = 0.5 * torch.mean((returns - value) ** 2)
    aux = {
        "approx_kl": torch.mean(old_logp - logp).detach(),
        "clip_frac": torch.mean(((ratio - 1.0).abs() > clip_eps).to(torch.float32)),
    }
    return pg + vf_coef * vf - ent_coef * ent, aux


def adam_init(params: ActorCritic) -> dict:
    """Adam's state: first and second moments per parameter name (the JAX
    dict's leaves), zeros, and the step count ``t`` (int32)."""
    return {
        "m": {n: torch.zeros_like(p) for n, p in params.named_parameters()},
        "v": {n: torch.zeros_like(p) for n, p in params.named_parameters()},
        "t": torch.zeros((), dtype=torch.int32, device=next(params.parameters()).device),
    }


def adam_update(params: ActorCritic, grads: dict, opt: dict, *, lr: float = 3e-4,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """The JAX package's Adam (learner.py:151-162), not torch.optim.Adam's:
    ``p - lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)``, eps
    on the uncorrected ``sqrt(v)``. Updates ``params`` in place; returns
    (params, the new state)."""
    t = opt["t"] + 1
    tf = t.to(torch.float32)
    m = {n: b1 * opt["m"][n] + (1 - b1) * g for n, g in grads.items()}
    v = {n: b2 * opt["v"][n] + (1 - b2) * g * g for n, g in grads.items()}
    scale = lr * geom.sqrt(1 - torch.pow(torch.tensor(b2, device=tf.device), tf)) / (
        1 - torch.pow(torch.tensor(b1, device=tf.device), tf))
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.sub_(scale * m[n] / (geom.sqrt(v[n]) + eps))
    return params, {"m": m, "v": v, "t": t}


def loss_grads(params: ActorCritic, loss: torch.Tensor) -> dict:
    """Parameter name -> d loss / d parameter (autograd; JAX's grad)."""
    named = dict(params.named_parameters())
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def grad_step(params: ActorCritic, opt: dict, rgb, depth, actions, returns, *,
              lr: float = 3e-4):
    """One A2C Adam step on a batch of (obs, action, return) transitions;
    gradients and loss averaged over the ranks of a process group.
    Returns (params, opt, loss)."""
    loss = a2c_loss(params, rgb, depth, actions, returns)
    grads = loss_grads(params, loss)
    names = list(grads)
    reduced = dist.all_mean([grads[n] for n in names] + [loss.detach()])
    params, opt = adam_update(params, dict(zip(names, reduced[:-1])), opt, lr=lr)
    return params, opt, reduced[-1]


def ppo_grad_step(params: ActorCritic, opt: dict, rgb, depth, actions, old_logp, adv, returns,
                  *, lr: float = 3e-4, clip_eps: float = 0.2, vf_coef: float = 0.5,
                  ent_coef: float = 0.01):
    """One PPO Adam step on a minibatch; gradients, loss and diagnostics
    averaged over the ranks of a process group. Returns (params, opt,
    loss, aux)."""
    loss, aux = ppo_loss(params, rgb, depth, actions, old_logp, adv, returns,
                         clip_eps=clip_eps, vf_coef=vf_coef, ent_coef=ent_coef)
    grads = loss_grads(params, loss)
    names = list(grads)
    reduced = dist.all_mean([grads[n] for n in names]
                            + [loss.detach(), aux["approx_kl"], aux["clip_frac"]])
    params, opt = adam_update(params, dict(zip(names, reduced[:len(names)])), opt, lr=lr)
    loss, kl, clip = reduced[len(names):]
    return params, opt, loss, {"approx_kl": kl, "clip_frac": clip}
