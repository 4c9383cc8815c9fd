"""Data parallelism over ``torch.distributed``, in place of the JAX
package's device mesh (``miniworld_tpu/parallel/mesh.py``).

The env batch is the parallel axis, as there: each rank (one process,
one card) holds a contiguous slice of the global batch of B envs, steps
and renders it with no communication, and the learner all-reduces its
gradients (parallel/learner.py). A launcher such as ``torchrun`` sets
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; without them the program is one process with the whole
batch.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from miniworld_tpu_torch.ops import rng as rng_ops
from miniworld_tpu_torch.state import EnvState


def init_multihost(device="cuda"):
    """Initialize the default process group (no-op when single).

    The JAX package's fail-fast contract (mesh.py:33-56): when the
    environment says this IS a multi-process launch (``MASTER_ADDR`` set,
    or ``WORLD_SIZE`` above 1), a failed initialization raises at once
    instead of degrading to a single-process run that would train on a
    fraction of the batch. Only the unconfigured single process carries
    on quietly. The backend is NCCL for a CUDA device (the process takes
    the card ``LOCAL_RANK``), gloo for the CPU.
    """
    if dist.is_available() and dist.is_initialized():
        return  # already initialized by the caller
    configured = bool(os.environ.get("MASTER_ADDR")) or int(os.environ.get("WORLD_SIZE", "1")) > 1
    if not configured:
        return  # no cluster configured: normal single-process run
    cuda = torch.device(device).type == "cuda"
    try:
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend="nccl" if cuda else "gloo", init_method="env://")
    except Exception as e:
        raise RuntimeError(
            "multi-process init failed with a launcher configured "
            f"(fail-fast, refusing single-process fallback): {e}") from e


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def shard_slice(num_envs_global: int) -> slice:
    """This rank's contiguous slice of a global batch of envs, the shard
    the JAX package's ``shard_env_batch`` puts on its device."""
    n, r = world_size(), rank()
    if num_envs_global % n:
        raise ValueError(f"{num_envs_global} envs do not split over {n} ranks")
    b = num_envs_global // n
    return slice(r * b, (r + 1) * b)


def shard_env_batch(tree):
    """This rank's slice of a tree (tensors, dicts, an ``EnvState``)
    whose leading axis is the global env batch: the shard the JAX
    package's ``shard_env_batch`` puts on the rank's device."""
    if isinstance(tree, torch.Tensor):
        return tree[shard_slice(tree.shape[0])]
    if isinstance(tree, EnvState):
        return dataclasses.replace(tree, **{f.name: shard_env_batch(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: shard_env_batch(v) for k, v in tree.items()}
    return tree  # None fields


def replicate(tree):
    """Every rank holds rank 0's values of a tree's tensors (an
    ``nn.Module``'s parameters and buffers, dicts of tensors), broadcast
    in place: the JAX package's ``replicate``. Unchanged with one rank."""
    if world_size() == 1:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict().values())
    elif isinstance(tree, dict):
        tensors = [v for v in tree.values() if isinstance(v, torch.Tensor)]
    else:
        tensors = [tree]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return tree


def reset_shard(env, key: torch.Tensor):
    """(state, obs) of this rank's envs after the global reset from key
    data (2,): the JAX package resets all B envs from ``split(key, B)``
    and shards them; here each rank resets its own slice of those keys.
    ``env`` holds the rank's envs (``num_envs`` = B / world size)."""
    keys = rng_ops.split(key.to(env.device), env.num_envs * world_size())
    return env.reset_keys(shard_env_batch(keys))


def _all_reduce(tensors: list, dtype, mean: bool) -> list:
    n = world_size()
    if n == 1:
        return tensors
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat)
    if mean:
        flat /= n
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def all_mean(tensors: list) -> list:
    """Each float32 tensor's mean over the ranks (the JAX package's
    ``pmean``: the sum over ranks, then divided by their number), all in
    one all-reduce; the tensors as they are with one rank."""
    return _all_reduce(tensors, torch.float32, mean=True)


def all_sum(tensors: list) -> list:
    """Each tensor's sum over the ranks (``psum``) in one all-reduce, in
    float64, exact for a step's counts and float32 sums over two ranks;
    unchanged with one rank."""
    return _all_reduce(tensors, torch.float64, mean=False)
