"""The port's periphery against the JAX package's: the gymnasium wrappers
on the port's adapter, the batched wrapper functions on tensors, the
HUD, the LeRobot writer and the headless recorder
(miniworld_tpu_torch/wrappers.py, hud.py, io/lerobot.py,
manual_control.py)."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from miniworld_tpu import hud as jhud
from miniworld_tpu import wrappers as jwrappers
from miniworld_tpu.gym_env import MiniWorldGym as JaxGym
from miniworld_tpu_torch import hud, wrappers
from miniworld_tpu_torch.gym_env import MiniWorldGym
from miniworld_tpu_torch.ops import rng as rng_ops

W, H = 32, 24


@pytest.fixture(scope="module")
def envs():
    """(JAX adapter, port adapter) on OneRoomS6Fast, as tests/test_periphery.py."""
    return (JaxGym("OneRoomS6Fast", obs_width=W, obs_height=H),
            MiniWorldGym("OneRoomS6Fast", obs_width=W, obs_height=H, device="cpu"))


@pytest.mark.parametrize("wrapper", ["PyTorchObsWrapper", "GreyscaleWrapper"])
def test_observation_wrappers(envs, wrapper):
    """The wrapped observations and spaces equal the JAX wrappers' on
    the same episode."""
    jw = getattr(jwrappers, wrapper)(envs[0])
    tw = getattr(wrappers, wrapper)(envs[1])
    assert tw.observation_space == jw.observation_space
    j_obs, _ = jw.reset(seed=0)
    t_obs, _ = tw.reset(seed=0)
    np.testing.assert_array_equal(t_obs, j_obs)
    for a in (2, 2, 0):
        np.testing.assert_array_equal(tw.step(a)[0], jw.step(a)[0])
    assert t_obs.shape == ((3, W, H) if wrapper == "PyTorchObsWrapper" else (H, W, 1))


def test_stochastic_action_wrapper(envs):
    """The substitution draws from the env's seeded np_random: the same
    trajectory as the JAX wrapper's."""
    jw = jwrappers.StochasticActionWrapper(envs[0], prob=0.5, random_action=1)
    tw = wrappers.StochasticActionWrapper(envs[1], prob=0.5, random_action=1)
    jw.reset(seed=4)
    tw.reset(seed=4)
    for _ in range(8):
        j = jw.step(2)
        t = tw.step(2)
        assert t[1:4] == j[1:4]
        np.testing.assert_array_equal(envs[1].agent_pos, envs[0].agent_pos)
    assert envs[1].agent_dir == envs[0].agent_dir


def test_batched_wrapper_fns():
    """greyscale_obs exact; pytorch_obs the same transpose;
    stochastic_actions the same keep mask from the same key, and the
    second split handed to sample_fn."""
    rng = np.random.default_rng(0)
    obs = rng.integers(0, 256, (4, H, W, 3), dtype=np.uint8)
    np.testing.assert_array_equal(wrappers.greyscale_obs(torch.from_numpy(obs)).numpy(),
                                  np.asarray(jwrappers.greyscale_obs(jnp.asarray(obs))))
    np.testing.assert_array_equal(wrappers.pytorch_obs(torch.from_numpy(obs)).numpy(),
                                  np.asarray(jwrappers.pytorch_obs(jnp.asarray(obs))))
    b = 64
    acts = np.arange(b, dtype=np.int32)
    for seed in (0, 5):
        seen = []

        def t_sample(k):
            seen.append(k.tolist())
            return torch.full((b,), -1, dtype=torch.int32)

        got = wrappers.stochastic_actions(rng_ops.key_data(seed), torch.from_numpy(acts),
                                          t_sample, prob=0.7)
        want = jwrappers.stochastic_actions(jax.random.key(seed), jnp.asarray(acts),
                                            lambda k: jnp.full((b,), -1, jnp.int32), prob=0.7)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        k2 = jax.random.split(jax.random.key(seed))[1]
        assert seen == [np.asarray(jax.random.key_data(k2)).astype(np.int64).tolist()]
        assert 0 < int((got.numpy() == -1).sum()) < b
    vec = rng.uniform(-1, 1, (b, 6)).astype(np.float32)
    got = wrappers.stochastic_actions(rng_ops.key_data(3), torch.from_numpy(vec),
                                      lambda k: torch.zeros((b, 6)), prob=0.5)
    want = jwrappers.stochastic_actions(jax.random.key(3), jnp.asarray(vec),
                                        lambda k: jnp.zeros((b, 6)), prob=0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hud():
    """Layout, hit test, drawn controls and the composed human frame
    equal the JAX package's."""
    labels = [n for n, _ in hud.DEFAULT_CONTROLS]
    assert hud.DEFAULT_CONTROLS == jhud.DEFAULT_CONTROLS
    for w, h in ((80, 60), (32, 24)):
        boxes = hud.control_layout(w, h, labels)
        assert boxes == jhud.control_layout(w, h, labels)
        for name, (x0, y0, x1, y1) in boxes.items():
            assert hud.hit_test(boxes, (x0 + x1) // 2, (y0 + y1) // 2) == name
        assert hud.hit_test(boxes, 0, 0) is jhud.hit_test(boxes, 0, 0) is None
        frame = np.random.default_rng(w).integers(0, 256, (h, w, 3), dtype=np.uint8)
        for hover in (None, labels[2]):
            np.testing.assert_array_equal(hud.draw_controls(frame, boxes, hover=hover),
                                          jhud.draw_controls(frame, boxes, hover=hover))
    obs = np.full((60, 80, 3), 40, np.uint8)
    tv = np.full((30, 40, 3), 200, np.uint8)
    for args in ((obs, tv, (4.25, -0.4, 1.57)), (obs, None, None), (obs, tv, None)):
        np.testing.assert_array_equal(hud.compose_human_frame(*args),
                                      jhud.compose_human_frame(*args))


def _assert_same_tree(a, b):
    """Two dataset directories hold the same files: JSON equal, parquet
    tables equal, anything else byte for byte."""
    import pyarrow.parquet as pq

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(a) == files(b) and files(a)
    for rel in files(a):
        pa_, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".json"):
            with open(pa_) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif rel.endswith(".parquet"):
            assert pq.read_table(pa_).equals(pq.read_table(pb)), rel
        elif rel.endswith(".npz"):
            with np.load(pa_) as za, np.load(pb) as zb:
                assert sorted(za.files) == sorted(zb.files), rel
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=rel)
        else:
            with open(pa_, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_lerobot_writer_same_files(tmp_path):
    """The same episodes (and a batch split on its done mask, and an
    appended episode) give the same dataset files as the JAX package's
    writer."""
    pytest.importorskip("pyarrow")
    from miniworld_tpu.io import lerobot as jlerobot
    from miniworld_tpu_torch.io import lerobot

    def write(mod, root):
        rng = np.random.default_rng(1)
        dm = mod.DatasetManager(root, fps=10)
        for n, task in ((5, "a"), (3, "b")):
            ep = mod.Episode(task=task)
            for t in range(n):
                ep.add(frame=rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                       action=np.array([t, 0.5], np.float32),
                       state=rng.normal(size=3).astype(np.float32), reward=float(t),
                       done=t == n - 1)
            dm.add_episode(ep)
        dones = np.zeros((6, 2), bool)
        dones[2, 0] = True
        dm.add_batch(rng.integers(0, 256, (6, 2, 8, 8, 3), dtype=np.uint8),
                     rng.normal(size=(6, 2, 2)).astype(np.float32),
                     rng.normal(size=(6, 2)).astype(np.float32), dones)
        dm.finalize()
        dm2 = mod.DatasetManager(root, fps=10, append=True)
        with mod.EpisodeWriter(dm2) as w:
            for _ in range(3):
                w.add_sample(np.zeros((8, 8, 3), np.uint8), [0.0, 1.0], reward=1.0)
        dm2.finalize()
        info = {"agent": {"pos": [1.0, 0.0, 2.0], "dir": 0.5, "cam_pitch": -3.0},
                "b": np.array([7.0, 8.0]), "a": 5.0}
        return mod.build_state_vector(info)

    np.testing.assert_array_equal(write(lerobot, tmp_path / "port"),
                                  write(jlerobot, tmp_path / "jax"))
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_scripted_control_records(tmp_path, envs):
    """ScriptedControl drives the port's adapter and records what the
    JAX package's records driving its own, file for file; the random
    policy records every step."""
    pytest.importorskip("pyarrow")
    from miniworld_tpu.manual_control import ScriptedControl as JaxScripted
    from miniworld_tpu_torch.manual_control import ScriptedControl, project_discrete

    def policy(obs):
        return int(obs[..., 0].sum()) % 3

    ScriptedControl(envs[1], policy, str(tmp_path / "port"), fps=10).run(num_steps=8, seed=2)
    JaxScripted(envs[0], policy, str(tmp_path / "jax"), fps=10).run(num_steps=8, seed=2)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    ScriptedControl(envs[1], "random", str(tmp_path / "rand"), fps=10).run(num_steps=6, seed=0)
    info = json.loads((tmp_path / "rand" / "meta" / "info.json").read_text())
    assert info["total_frames"] == 6
    table = envs[1]._discrete_actions
    assert project_discrete(np.array([0, 0, 1, 0, 0, 0], np.float32), table) == 1
