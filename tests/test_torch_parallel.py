"""The port's data parallelism over ``torch.distributed``
(miniworld_tpu_torch/parallel/dist.py, rollout.py), on the CPU with gloo
groups on a FileStore under the test's tmp_path (no network):

  * ``init_multihost``'s fail-fast contract (the counterpart of
    tests/test_train.py::test_multihost_init_fail_fast);
  * a one-rank group's A2C step equals the step without a group;
  * the sharded rollout calls no collective, the train step does;
    ``shard_env_batch`` gives each rank its slice, ``replicate`` rank 0's
    values;
  * two ranks of 4 envs each (two processes, 32x24, horizon 3) take the
    A2C step of the JAX package's ``make_mesh(2)`` over the same 8 envs,
    under the whole-step rules of tests/_torch_train.py, every rank's
    parameters equal after the step.
"""

import copy
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.parallel import make_mesh, make_train_step as j_a2c
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.convert import params_from_jax
from miniworld_tpu_torch.ops import rng as trng
from miniworld_tpu_torch.parallel import dist as pdist, make_sharded_rollout, make_train_step
from miniworld_tpu_torch.state import EnvState
from miniworld_tpu_torch.utils import checkpoint

from _torch_dist_worker import count_collectives
from _torch_parity import assert_states_match, to_port_state
from _torch_train import (
    MAX_PARAM_DIFF, assert_metrics, assert_rollout_outs, jax_policy_rollout, max_param_diff,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

ENV_ID = "MiniWorld-OneRoomS6Fast-v0"
W, H, HORIZON = 32, 24, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multihost_init_fail_fast(monkeypatch):
    """With a launcher configured (MASTER_ADDR, or WORLD_SIZE > 1), a
    failed init raises instead of degrading to one process; without one,
    the single process stays quiet and no group is made."""
    calls = []

    def boom(*a, **kw):
        calls.append(kw)
        raise RuntimeError("injected: rendezvous unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    with pytest.raises(RuntimeError, match="fail-fast"):
        pdist.init_multihost(device="cpu")
    assert calls[-1]["backend"] == "gloo"
    monkeypatch.delenv("MASTER_ADDR")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="fail-fast"):
        pdist.init_multihost(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    pdist.init_multihost(device="cpu")  # must not raise
    monkeypatch.delenv("WORLD_SIZE")
    pdist.init_multihost(device="cpu")
    assert len(calls) == 2 and not dist.is_initialized()
    assert (pdist.rank(), pdist.world_size(), pdist.shard_slice(8)) == (0, 1, slice(0, 8))


def _snapshot(ts):
    return {"params": copy.deepcopy(ts["params"]), "opt": copy.deepcopy(ts["opt"])}


def test_one_rank_group(tmp_path, monkeypatch):
    """A one-rank gloo group changes nothing: the A2C step equals the one
    without a group, bit for bit; its sharded rollout calls no
    collective."""
    env = MiniWorldVec(ENV_ID, 4, obs_width=W, obs_height=H, device="cpu")
    step, init = make_train_step(env, horizon=2)
    ts, state, obs, depth = init(trng.key_data(0))
    ts2 = _snapshot(ts)
    want = step(ts, state, obs, depth, trng.key_data(1))
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        assert pdist.world_size() == 1
        assert pdist.shard_env_batch(state) is not state
        assert torch.equal(pdist.shard_env_batch(state).pos, state.pos)
        t = torch.arange(3.0)
        assert pdist.replicate(t) is t and torch.equal(t, torch.arange(3.0))
        got = step(ts2, state, obs, depth, trng.key_data(1))
        counts = {}
        count_collectives(counts, monkeypatch.setattr)
        sharded = make_sharded_rollout(env, 2)
        s, o, d = sharded.init(trng.key_data(0))
        sharded.step(s, o, d, trng.key_data(1))
        assert counts == {}
    finally:
        dist.destroy_process_group()
    for (n, a), b in zip(want[0]["params"].state_dict().items(),
                         got[0]["params"].state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(want[1].tensors().values(), got[1].tensors().values()):
        assert torch.equal(a, b)
    for k in want[4]:
        assert torch.equal(want[4][k], got[4][k]), k


def _slice_state(state: EnvState, sl: slice) -> EnvState:
    fields = {}
    for k, v in vars(state).items():
        if k == "task":
            fields[k] = {kk: vv[sl].clone() for kk, vv in v.items()}
        else:
            fields[k] = None if v is None else v[sl].clone()
    return EnvState(**fields)


def test_two_rank_a2c_step(tmp_path):
    """Two processes of 4 envs against the JAX package's make_mesh(2)
    step over 8 envs, from the same parameters, state and key."""
    jenv = JaxVec(ENV_ID, num_envs=8, obs_width=W, obs_height=H)
    j_step, j_init = j_a2c(jenv, make_mesh(2), horizon=HORIZON)
    j_ts, j_state, j_obs, j_depth = j_init(jax.random.key(0))
    j_new, *_, j_m = j_step(j_ts, j_state, j_obs, j_depth, jax.random.key(1))
    # each shard's rollout: the rank folded into the key, its 4 envs
    roll = jax_policy_rollout(jenv, HORIZON)
    take = lambda x, r: jax.tree.map(lambda a: a[4 * r:4 * r + 4], x)  # noqa: E731
    j_outs = [roll(j_ts["params"], take(j_state, r), take(j_obs, r), take(j_depth, r),
                   jax.random.fold_in(jax.random.key(1), r)) for r in range(2)]

    state = to_port_state(j_state)
    params = params_from_jax(jax.tree.map(np.asarray, j_ts["params"]))
    num_actions = params["pi.w"].shape[1]
    procs, outs = [], []
    env_vars = dict(os.environ, PYTHONPATH=ROOT, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    for r in range(2):
        checkpoint.save(str(tmp_path / f"in{r}.pt"), {
            "env_id": ENV_ID, "b_local": 4, "w": W, "h": H, "horizon": HORIZON,
            "num_actions": num_actions, "init_seed": 0, "key_seed": 1, "params": params,
            "state": _slice_state(state, slice(4 * r, 4 * r + 4)),
            "actions": torch.from_numpy(np.array(j_outs[r]["actions"]))})
        outs.append(str(tmp_path / f"out{r}.pt"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "_torch_dist_worker.py"), str(r), "2",
             str(tmp_path / "store"), str(tmp_path / f"in{r}.pt"), outs[-1]],
            env=env_vars, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        try:
            log, _ = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, log.decode()[-3000:]
    res = [checkpoint.restore(o) for o in outs]

    for r, got in enumerate(res):
        # the rank's share of the global reset, and its rollout
        assert_states_match(take(j_state, r), got["init_state"])
        print(f"rank {r}: {got['record']['differ']} of {got['record']['draws']} draws differed")
        assert got["record"]["draws"] == 4 * HORIZON and got["record"]["differ"] <= 2
        assert_rollout_outs(j_outs[r], got["outs"])
        assert torch.equal(got["shard"], torch.arange(4 * r, 4 * r + 4))
        assert torch.equal(got["replicated"], torch.ones(3))  # rank 0's
        assert got["rollout_collectives"] == {}
        assert got["step_collectives"] == {"all_reduce": 3}  # gradients + loss, 2 for metrics
        assert_metrics(j_m, got["metrics"], np.log(num_actions))
        diff = max_param_diff(j_new["params"], _module(got["params"], num_actions))
        print(f"rank {r}: parameters within {diff:.3e} of JAX's")
        assert diff <= MAX_PARAM_DIFF
    for k, a in res[0]["params"].items():
        assert torch.equal(a, res[1]["params"][k]), k


def _module(state_dict, num_actions):
    from miniworld_tpu_torch.parallel.learner import ActorCritic

    net = ActorCritic((H, W, 3), num_actions)
    net.load_state_dict(state_dict)
    return net
