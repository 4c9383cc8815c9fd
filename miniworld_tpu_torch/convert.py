"""Carry banks, atlases, env states and learner parameters across to the
PyTorch port.

The JAX package's objects arrive here as numpy arrays — a ``Layout``
whose fields are numpy (``miniworld_tpu.MiniWorldVec._bank_np``), the
Fourier table, an ``EnvState``'s leaves plus
``jax.random.key_data(state.rng)``, the learner's param dict and Adam
state — so this module, like the rest of the port, imports no jax. The
port's own constructor uses the same functions to move its host-built
bank to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from miniworld_tpu_torch.scene.compile import Layout
from miniworld_tpu_torch.state import EnvState

_U32_FIELDS = ("tri_slots",)


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:  # u32 words live in int64 (ops/rng.py)
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


def layout_from_numpy(bank_np, device="cpu") -> Layout:
    """The port's ``Layout`` of tensors from any dataclass bank whose
    fields are numpy arrays or None (matched by field name)."""
    have = {f.name for f in dataclasses.fields(bank_np)}
    out = {}
    for f in dataclasses.fields(Layout):
        v = getattr(bank_np, f.name) if f.name in have else None
        out[f.name] = None if v is None else _tensor(v, device)
    return Layout(**out)


def atlas_from_numpy(tex_np, device="cpu") -> torch.Tensor:
    """(A, 4+8K) float32 Fourier table on ``device``."""
    return torch.from_numpy(np.array(tex_np, dtype=np.float32, order="C")).to(device)


def state_from_numpy(fields: dict, rng_key_data, device="cpu") -> EnvState:
    """A batched ``EnvState`` from per-field numpy arrays (B, ...).

    ``fields`` maps EnvState field names to arrays (``task`` a dict of
    arrays; ``rng`` and absent optional fields skipped);
    ``rng_key_data`` is the (B, 2) uint32 threefry key data.
    """
    kw = {}
    for f in dataclasses.fields(EnvState):
        if f.name == "rng":
            continue
        v = fields.get(f.name)
        if f.name == "task":
            kw["task"] = {k: _tensor(a, device) for k, a in (v or {}).items()}
        elif v is None:
            kw[f.name] = None
        else:
            t = _tensor(v, device)
            if f.name in _U32_FIELDS:
                t = t.to(torch.int64)
            kw[f.name] = t
    kw["rng"] = _tensor(np.asarray(rng_key_data, np.uint32), device)
    return EnvState(**kw)


def state_to_numpy(state: EnvState) -> dict:
    """Field name -> numpy array for every tensor field (``task.*`` keys
    for task entries), for comparisons with the JAX package."""
    return {k: v.detach().cpu().numpy() for k, v in state.tensors().items()}


# -- learner parameters (parallel/learner.py) ---------------------------------


def _leaf_from_jax(name: str, a) -> np.ndarray:
    a = np.asarray(a, np.float32)
    if name.startswith("conv") and name.endswith(".w"):
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return np.array(a, order="C", copy=True)


def _leaf_to_jax(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name.startswith("conv") and name.endswith(".w"):
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return np.ascontiguousarray(a)


def _flat_names(tree: dict) -> dict:
    """{"conv0": {"w": a, ...}, "log_std": a} -> {"conv0.w": a, ..., "log_std": a}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _nested(flat: dict) -> dict:
    out = {}
    for name, a in flat.items():
        if "." in name:
            k, kk = name.split(".", 1)
            out.setdefault(k, {})[kk] = a
        else:
            out[name] = a
    return out


def params_from_jax(params_np: dict, device="cpu") -> dict:
    """The learner module's state dict from the JAX package's param dict
    (leaves as numpy): names flattened with dots, conv weights from HWIO
    to OIHW; ``fc.w`` unchanged, since the module flattens its
    activations in JAX's NHWC order."""
    return {n: torch.from_numpy(_leaf_from_jax(n, a)).to(device)
            for n, a in _flat_names(params_np).items()}


def params_to_jax(module) -> dict:
    """The JAX package's param dict (numpy leaves) of a learner module."""
    return _nested({n: _leaf_to_jax(n, p) for n, p in module.named_parameters()})


def opt_from_jax(opt_np: dict, device="cpu") -> dict:
    """Adam's state (``m``, ``v`` per parameter name, ``t``) from the JAX
    package's ``adam_init`` / ``adam_update`` pytree."""
    return {"m": params_from_jax(opt_np["m"], device), "v": params_from_jax(opt_np["v"], device),
            "t": torch.tensor(int(np.asarray(opt_np["t"])), dtype=torch.int32, device=device)}


def opt_to_jax(opt: dict) -> dict:
    """The JAX package's Adam pytree (numpy leaves) of the port's state."""
    return {k: _nested({n: _leaf_to_jax(n, t) for n, t in opt[k].items()}) for k in ("m", "v")} | {
        "t": np.asarray(int(opt["t"]), np.int32)}
