"""Layout-bank refresh and the bank options of the port's MiniWorldVec
(``prepare_bank``, ``install_bank``, ``refresh_layouts``; ``bank_seed``,
``place_budget``, ``fourier_k``) against the JAX package's: the refreshed
bank's arrays, the installed plan kept, and the rollout after a refresh
(tests/test_refresh.py's two banks: MazeS3 with 4 layouts, a full scan;
the 4x4 Maze with 4 layouts, packed PVS)."""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

from _torch_parity import one_torch_thread, reset_and_steps  # noqa: F401
from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.envs import make_spec as jax_make_spec
from miniworld_tpu_torch import MiniWorldVec, make_spec

B, W, H = 4, 32, 24
SPECS = {
    "fullscan": ("MiniWorld-MazeS3-v0", dict(num_layouts=4)),
    "packed": ("MiniWorld-Maze-v0", dict(num_rows=4, num_cols=4, num_layouts=4)),
}


def _assert_banks_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if a is None:
            assert b is None, f.name
            continue
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == a.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)


def _plan(env):
    return {k: v for k, v in env.plan.items() if k != "chunk_vis"}


@pytest.fixture(scope="module", params=sorted(SPECS))
def envs(request):
    env_id, kw = SPECS[request.param]
    jenv = JaxVec(jax_make_spec(env_id, **kw), num_envs=B, obs_width=W, obs_height=H,
                  procgen=False)
    env = MiniWorldVec(make_spec(env_id, **kw), B, obs_width=W, obs_height=H, device="cpu",
                       procgen=False)
    return request.param, jenv, env


def test_refresh_matches_jax(envs):
    """Two refreshes: each bank equal to the JAX package's refreshed one,
    the plan unchanged (packed PVS keeps its chunk, its length and its
    chunk count); then a reset and steps on the new layouts match."""
    kind, jenv, env = envs
    plan0 = _plan(env)
    assert plan0["kind"] == ("packed_pvs" if kind == "packed" else "dense")
    assert (env.tri_chunk, plan0.get("sched_len")) == (jenv.tri_chunk, jenv._sched_len)
    shapes0 = env._bank.tri_verts9.shape, env._bank.room_segs.shape
    for seed in (101, 202):
        jenv.refresh_layouts(seed)
        env.refresh_layouts(seed)
        _assert_banks_equal(env._bank_np, jenv._bank_np)
        assert _plan(env) == plan0
        assert (env._bank.tri_verts9.shape, env._bank.room_segs.shape) == shapes0
        assert (env.tri_chunk, env.plan.get("sched_len")) == (jenv.tri_chunk, jenv._sched_len)
    reset_and_steps(None, B, W, H, steps=4, seed=5, envs=(jenv, env))


def test_prepare_install_in_a_thread(envs):
    """prepare_bank runs off-thread (no state touched): the bank it
    returns equals one prepared on the main thread, and install_bank
    swaps it in, as the JAX package's refresh_layouts does."""
    _, jenv, env = envs
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("bank", env.prepare_bank(303)))
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and "bank" in out
    _assert_banks_equal(out["bank"][0], env.prepare_bank(303)[0])
    np.testing.assert_array_equal(out["bank"][1], env.prepare_bank(303)[1])
    env.install_bank(out["bank"])
    jenv.install_bank(jenv.prepare_bank(303))
    _assert_banks_equal(env._bank_np, jenv._bank_np)
    bank_np, tex_np = out["bank"]
    with pytest.raises(ValueError):
        env.install_bank((bank_np, tex_np[:-1]))


def test_procgen_refresh_is_a_no_op():
    """Procgen resets already make a fresh maze each: refresh_layouts
    leaves the bank alone, install_bank refuses."""
    env = MiniWorldVec("MiniWorld-MazeS3-v0", 2, obs_width=W, obs_height=H, device="cpu")
    bank = env._bank
    env.refresh_layouts(7)
    assert env._bank is bank
    with pytest.raises(ValueError):
        env.install_bank(env.prepare_bank(7))


@pytest.mark.parametrize("bank_seed", [0, 9])
def test_bank_seed(bank_seed):
    """bank_seed builds the JAX package's layouts for that seed."""
    spec_kw = dict(num_layouts=3)
    jenv = JaxVec(jax_make_spec("MiniWorld-MazeS3-v0", **spec_kw), num_envs=2, obs_width=W,
                  obs_height=H, procgen=False, bank_seed=bank_seed)
    env = MiniWorldVec(make_spec("MiniWorld-MazeS3-v0", **spec_kw), 2, obs_width=W,
                       obs_height=H, device="cpu", procgen=False, bank_seed=bank_seed)
    _assert_banks_equal(env._bank_np, jenv._bank_np)


def test_place_budget():
    """place_budget replaces the spec's placement tries (None: the
    spec's), and resets place as the JAX package's do at that budget."""
    hall = MiniWorldVec("MiniWorld-Hallway-v0", 2, obs_width=W, obs_height=H, device="cpu")
    assert hall.place_budget == make_spec("MiniWorld-Hallway-v0").place_budget
    assert make_spec("MiniWorld-RoomObjects-v0").place_budget == 48
    env = MiniWorldVec("MiniWorld-PickupObjects-v0", 8, obs_width=W, obs_height=H,
                       device="cpu", place_budget=2)
    jenv = JaxVec("MiniWorld-PickupObjects-v0", num_envs=8, obs_width=W, obs_height=H,
                  place_budget=2)
    assert env.place_budget == jenv.place_budget == 2
    reset_and_steps(None, 8, W, H, steps=2, seed=3, envs=(jenv, env))


def test_fourier_k():
    """fourier_k sets the Fourier table's terms (None: the spec's, else
    16): the JAX package's table at that K, and renders that match."""
    env = MiniWorldVec("MiniWorld-Hallway-v0", 2, obs_width=W, obs_height=H, device="cpu",
                       fourier_k=8)
    jenv = JaxVec("MiniWorld-Hallway-v0", num_envs=2, obs_width=W, obs_height=H, fourier_k=8)
    assert env.fourier_k == jenv.fourier_k == 8
    want = np.asarray(jenv._atlas)
    assert tuple(env._atlas.shape) == want.shape == (want.shape[0], 4 + 8 * 8)
    np.testing.assert_allclose(env._atlas.numpy(), want, rtol=0, atol=1e-6)
    reset_and_steps(None, 2, W, H, steps=2, seed=1, envs=(jenv, env))
    from miniworld_tpu_torch.vector import _fourier_k

    assert _fourier_k(make_spec("MiniWorld-Sign-v0"), None) == 64  # Sign's own K
    assert _fourier_k(make_spec("MiniWorld-Hallway-v0"), None) == 16


def test_trainer_refresh_flag(monkeypatch):
    """The A2C twin's --refresh-layouts-every N installs a bank prepared
    off-thread every N iterations (a layout bank: procgen off), and
    ignores the flag for a procgen env."""
    from miniworld_tpu_torch.examples import train_a2c
    from miniworld_tpu_torch.parallel import make_train_step

    installs = []
    orig = MiniWorldVec.install_bank
    monkeypatch.setattr(MiniWorldVec, "install_bank",
                        lambda self, prepared: installs.append(1) or orig(self, prepared))
    argv = ["--env", "MiniWorld-MazeS3-v0", "--num-envs", "4", "--obs", f"{W}x{H}", "--iters",
            "2", "--horizon", "2", "--refresh-layouts-every", "1", "--device", "cpu"]
    args = train_a2c.parser("").parse_args(argv)
    for kw, want in (({"procgen": False}, 2), (None, 0)):
        installs.clear()
        train_a2c.run(args, lambda env: make_train_step(env, horizon=args.horizon),
                      env_kwargs=kw)
        assert len(installs) == want, kw
