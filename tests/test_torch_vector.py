"""The port's Hallway slice as a whole against the JAX package: reset and
10 steps at B=8, 80x60, plus the port's own rollout, its import
hygiene and its refusals."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu_torch import MiniWorldVec, make_spec
from miniworld_tpu_torch.render import cuda_build, raycast as trc

from _torch_parity import (
    ENV_ID, H, W, assert_images_match, assert_states_match, to_port_state,
)

B = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_env():
    return MiniWorldVec(ENV_ID, B, obs_width=W, obs_height=H, device="cpu")


def test_reset_and_ten_steps(port_env):
    jenv = JaxVec(ENV_ID, num_envs=B, obs_width=W, obs_height=H)
    jstate, (j_rgb, j_depth) = jenv.reset(jax.random.key(21))
    tstate, (t_rgb, t_depth) = port_env.reset(21)
    assert_states_match(jstate, tstate)
    assert_images_match(j_rgb, j_depth, t_rgb, t_depth)
    # half the envs start 1.5 m in front of the goal box, facing it, so
    # walking forward ends their episodes and auto-resets them
    box = np.asarray(jstate.ent_pos)[:, 0]
    near = np.arange(B) < B // 2
    pos = np.where(near[:, None], box - [1.5, 0.0, 0.0], np.asarray(jstate.pos))
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                            dir=jnp.where(jnp.asarray(near), 0.0, jstate.dir))
    tstate = to_port_state(jstate)
    rng = np.random.default_rng(21)
    dones = 0
    for _ in range(10):
        acts = rng.integers(0, 6, B).astype(np.int32)
        acts[near] = 2  # forward
        jstate, (j_rgb, j_depth), j_r, j_d, j_info = jenv.step(jstate, jnp.asarray(acts))
        tstate, (t_rgb, t_depth), t_r, t_d, t_info = port_env.step(
            tstate, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        np.testing.assert_array_equal(tstate.step_count.numpy(), np.asarray(jstate.step_count))
        np.testing.assert_array_equal(tstate.layout_id.numpy(), np.asarray(jstate.layout_id))
        for k in ("termination", "truncation"):
            np.testing.assert_array_equal(t_info[k].numpy(), np.asarray(j_info[k]))
        assert_states_match(jstate, tstate)
        assert_images_match(j_rgb, j_depth, t_rgb, t_depth)
        dones += int(t_d.sum())
    assert dones >= B // 2, dones
    assert t_rgb.shape == (B, H, W, 3) and t_depth.shape == (B, H, W, 1)


def test_rollout(port_env):
    state, obs = port_env.reset(0)
    outs = []
    for seed in (1, 2):
        gen = torch.Generator().manual_seed(seed)
        s, o, out = port_env.rollout(state, obs, gen, 4)
        assert set(out) == {"reward", "dones", "obs_sum"}
        for v in out.values():
            assert v.shape == (4,)
        assert o[0].shape == (B, H, W, 3) and o[1].shape == (B, H, W, 1)
        assert s.step_count.shape == (B,)
        outs.append(out["obs_sum"])
    assert not torch.equal(outs[0], outs[1]), "obs_sum must follow the generator"
    # same generator seed, same trajectory
    s, o, again = port_env.rollout(state, obs, torch.Generator().manual_seed(1), 4)
    assert torch.equal(again["obs_sum"], outs[0])


def test_without_depth():
    env = MiniWorldVec(ENV_ID, 2, obs_width=16, obs_height=12, with_depth=False,
                       device="cpu")
    _, obs = env.reset(0)
    assert isinstance(obs, torch.Tensor) and obs.shape == (2, 12, 16, 3)


def test_imports_no_jax_flax_pil():
    """The port runs a reset and a step without jax, flax or Pillow."""
    code = (
        "import sys, torch\n"
        "import miniworld_tpu_torch as m\n"
        "env = m.MiniWorldVec('MiniWorld-Hallway-v0', 2, obs_width=16, obs_height=12,"
        " device='cpu')\n"
        "state, obs = env.reset(0)\n"
        "env.step(state, torch.tensor([2, 0]))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'PIL', 'miniworld_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        MiniWorldVec(ENV_ID, 2, obs_width=16, obs_height=12, device="cuda")


def test_device_is_required():
    with pytest.raises(TypeError):
        MiniWorldVec(ENV_ID, 2)  # no default device


def test_unported_env_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        make_spec("MiniWorld-Maze-v0")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit, no kernels: the build raises instead of falling back."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(cuda_build, "_LIB", None)
    monkeypatch.setenv("MINIWORLD_TORCH_BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.load()


def test_wrappers_take_plain_on_cpu(port_env):
    """For CPU tensors each wrapper returns its plain version's result
    and launches nothing."""
    state, _ = port_env.reset(5)
    bank = port_env._bank
    cam = trc.camera_grid(state, W, H)
    trc.reset_launch_counts()
    t1, a1 = trc.tri_pass(bank.tri_verts9, bank.tri_attr, state.layout_id, cam, True)
    t2, a2 = trc.tri_pass_plain(bank.tri_verts9, bank.tri_attr, state.layout_id, cam, True)
    assert torch.equal(t1, t2) and torch.equal(a1, a2)
    ents = (state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
            state.ent_color, trc.entity_flags(bank, state))
    e1 = trc.entity_pass(*ents, cam, False, True)
    e2 = trc.entity_pass_plain(*ents, cam, False, True)
    assert all(torch.equal(x, y) for x, y in zip(e1, e2))
    lights = (state.light_pos, state.light_color, state.light_ambient, state.sky_color)
    r1 = trc.pixel_epilogue(t1, a1, *e1, port_env._atlas, cam, *lights, 16)
    r2 = trc.pixel_epilogue_plain(t1, a1, *e1, port_env._atlas, cam, *lights, 16)
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))
    assert not any(trc.LAUNCHES.values())


@pytest.mark.parametrize("kwargs", [
    {"domain_rand": True}, {"supersample": 2}, {"procgen": True},
    {"tex_mode": "nearest"}, {"view": "top"},
])
def test_unported_statics_raise(kwargs):
    with pytest.raises(NotImplementedError, match="not ported"):
        MiniWorldVec(ENV_ID, 2, obs_width=16, obs_height=12, device="cpu", **kwargs)
