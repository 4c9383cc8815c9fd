"""The float32 attribute carry against the JAX package on the CPU: a
Fourier atlas of more than 256 rows (``vector.widen_atlas``: the catalog
tiled, every slot's base moved into the last copy) with the texture
variant override in one chunk and over several, on a paired procgen
maze and with Sign's glyphs; more than 256 layout-local slot ids in
nearest mode (``vector.raise_slot_ids``) with mesh rows, in one chunk and
over a schedule; a Fourier table of K = 6 terms. Both packages install
the same transform of their own banks (``_torch_parity.installed_pair``).

Tolerances: rewards, dones and the rollouts' checksums exact; states
within FLOAT_ATOL (1e-5); renders under the _torch_parity rules (winner
differs on at most 0.1% of the pixels, depth within rtol 1e-5 and RGB
within 2 u8 levels where it agrees).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import vector as tvector
from miniworld_tpu_torch.envs import make_spec
from miniworld_tpu_torch.ops import rng as trng
from miniworld_tpu_torch.render import raycast as trc

from _torch_parity import installed_pair, reset_and_steps
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H = 4, 32, 24
STEPS = 3


def _widen(bank, tex):
    return tvector.widen_atlas(bank, tex)


def _raise(bank, tex):
    return tvector.raise_slot_ids(bank), tex


# id, constructor arguments, the bank transform, what the render plans
CASES = {
    "hallway-dr": ("MiniWorld-Hallway-v0", dict(domain_rand=True), _widen, "single"),
    "sidewalk-dr": ("MiniWorld-Sidewalk-v0", dict(domain_rand=True), _widen, "multi"),
    "mazes3-dr": ("MiniWorld-MazeS3-v0", dict(domain_rand=True), _widen, "paired"),
    "sign": ("MiniWorld-Sign-v0", {}, _widen, "mesh"),
    "pickup-nearest": ("MiniWorld-PickupObjects-v0", dict(tex_mode="nearest"), _raise, "mesh"),
    "threerooms-nearest-16": ("MiniWorld-ThreeRooms-v0", dict(tex_mode="nearest", tri_chunk=16),
                              _raise, "sched"),
    "hallway-k6": ("MiniWorld-Hallway-v0", dict(fourier_k=6), _widen, "single"),
}


def _plan(env):
    if env._pg_wall is not None:
        return "paired"
    if env._bank.pvs_v9_rows is not None and env.plan["nc"] > 1:
        return "sched"
    if env._shapes_present[2]:
        return "mesh"
    return "multi" if env._bank.tri_verts9.shape[2] > env.tri_chunk else "single"


# the cases with mesh rows run in tests/test_torch_f32_mesh.py
MESH_CASES = ("sign", "pickup-nearest", "threerooms-nearest-16")


def check_f32_case(case):
    """Reset and steps through the float32 carry: both packages carry
    float32 rows (every carried id above 256), the port plans the route
    the case is for, and its episodes and renders follow the JAX
    package's."""
    env_id, kw, transform, route = CASES[case]
    jenv, env = installed_pair(env_id, B, W, H, transform, **kw)
    jstate, _ = jenv.reset(jax.random.key(0))
    tstate, _ = env.reset(0)
    if env.tex_mode == "nearest":
        n_ids, j_tex = tstate.tex_map.shape[1], {"mode": "nearest", "atlas": jenv._atlas}
        assert n_ids > 256
    else:
        n_ids, j_tex = env._atlas.shape[0], {"mode": "fourier", "coeffs": jenv._atlas}
        assert n_ids > 256 and env._fourier_table.shape[1] == trc.fourier_row_floats(env.fourier_k)
    assert trc.attr_carry_dtype(n_ids) == torch.float32
    # the JAX function reads one env's state (its tex_map is (T,))
    one_env = SimpleNamespace(tex_map=np.asarray(jstate.tex_map)[0])
    assert jrc.attr_carry_dtype(j_tex, one_env) == jax.numpy.float32
    assert _plan(env) == route, env.plan
    reset_and_steps(env_id, B, W, H, STEPS, 5, envs=(jenv, env))


@pytest.mark.parametrize("case", [c for c in CASES if c not in MESH_CASES])
def test_f32_carry_matches_jax(case):
    """check_f32_case: the Fourier atlas above 256 rows, and K = 6."""
    check_f32_case(case)


@pytest.mark.parametrize("case", ["hallway-dr", "hallway-k6"])
def test_f32_rollout_matches_jax(case):
    """A 4-step rollout from one key through the float32 carry: rewards,
    dones and checksums equal the JAX package's ``rollout``."""
    env_id, kw, transform, _ = CASES[case]
    jenv, env = installed_pair(env_id, 8, W, H, transform, **kw)
    jstate, jobs = jenv.reset(jax.random.key(3))
    tstate, tobs = env.reset(3)
    _, _, j_out = jenv.rollout(jstate, jobs, jax.random.key(7), 4)
    _, _, t_out = env.rollout(tstate, tobs, trng.key_data(7), 4)
    for k in ("reward", "dones", "obs_sum"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]).astype(
            t_out[k].numpy().dtype), err_msg=k)


def test_fourier_table_any_k():
    """A Fourier table of K = 6 terms: rows of 4 + 9K = 58 floats and two
    zeros, so that each row starts on 16 bytes; K a multiple of 4 keeps
    its 4 + 9K."""
    _, tex = tvector.build_bank(make_spec("MiniWorld-Hallway-v0"), fourier_k=6)
    table = trc.fourier_table(torch.from_numpy(tex), 6)
    assert table.shape == (tex.shape[0], 60) and trc.fourier_row_floats(6) == 60
    assert bool((table[:, 58:] == 0).all())
    assert trc.fourier_row_floats(16) == 4 + 9 * 16
