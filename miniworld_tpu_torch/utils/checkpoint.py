"""Checkpoint and resume of learner state and env state with
``torch.save`` (the JAX package's utils/checkpoint.py, which uses
orbax).

A tree of dicts, lists, tensors and numbers is saved as it is; an
``nn.Module`` as its state dict and an ``EnvState`` as its fields, each
marked so that ``restore`` rebuilds it. Thousands of envs mid-episode
and the learner restore exactly.
"""

from __future__ import annotations

import dataclasses
import os

import torch
from torch import nn

from miniworld_tpu_torch.state import EnvState

_MODULE = "__module_state__"
_ENV = "__env_state__"


def _plain(tree):
    if isinstance(tree, nn.Module):
        return {_MODULE: {k: v.detach().clone() for k, v in tree.state_dict().items()}}
    if isinstance(tree, EnvState):
        return {_ENV: {f.name: _plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def _rebuild(plain, like):
    if isinstance(plain, dict) and _MODULE in plain:
        if isinstance(like, nn.Module):
            like.load_state_dict(plain[_MODULE])
            return like
        return plain[_MODULE]
    if isinstance(plain, dict) and _ENV in plain:
        return EnvState(**{k: _rebuild(v, None) for k, v in plain[_ENV].items()})
    if isinstance(plain, dict):
        return {k: _rebuild(v, like.get(k) if isinstance(like, dict) else None)
                for k, v in plain.items()}
    if isinstance(plain, (list, tuple)):
        return type(plain)(_rebuild(v, None) for v in plain)
    return plain


def save(path: str, tree) -> None:
    """Save a tree (e.g. ``{"train_state": tstate, "env_state": state}``)
    to ``path``, written beside it first and then renamed into place, so
    a crash mid-write leaves the last checkpoint whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(_plain(tree), tmp)
    os.replace(tmp, path)


def restore(path: str, like=None, map_location=None):
    """The tree saved at ``path``. Modules found at the same place in
    ``like`` are loaded in place and returned; without one a module comes
    back as its state dict. ``map_location`` as for ``torch.load``."""
    plain = torch.load(path, map_location=map_location, weights_only=True)
    return _rebuild(plain, like)
