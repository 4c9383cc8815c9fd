"""A procgen super bank without its paired rows against the JAX package
on the CPU: MazeS3 with ``pg_*`` dropped renders its dense rows, each
env's killed by its maze (the JAX package's ``tri_active``,
raycast.py:321-356, 483-485, 1220-1227), with and without domain
randomisation. The install plans as JAX's ``_install_bank``; reset,
steps and a rollout follow the JAX package's; the plain scan over
several chunks (tri_chunk=16, which no plan of this bank reaches) equals
JAX's ``_tri_pass`` on every pixel.

Tolerances: banks, ints, bools, ``wall_open``, rewards, dones and the
rollout's checksums exact, and the chunked scan's t and attributes on
every pixel; states within FLOAT_ATOL (1e-5); renders under the
_torch_parity rules (winner differs on at most 0.1% of the pixels, depth
within rtol 1e-5 and RGB within 2 u8 levels where it agrees).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import vector as jvector
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import vector as tvector
from miniworld_tpu_torch.convert import layout_from_numpy
from miniworld_tpu_torch.ops import mazegen, rng as trng
from miniworld_tpu_torch.render import raycast as trc

from _torch_parity import drop_paired, installed_pair, reset_and_steps, to_port_state
from test_torch_chunks import _jax_cameras, _port_camera
from test_torch_maze import _assert_layouts_equal
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

ENV_ID = "MiniWorld-MazeS3-v0"
B, W, H = 4, 32, 24


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "domain_rand"])
def dense(request):
    """(JAX env, port env) of MazeS3 procgen with the paired rows dropped."""
    return installed_pair(ENV_ID, B, W, H, drop_paired, domain_rand=request.param)


def test_dense_install_plans_as_jax(dense):
    """The installed bank, chunk and plan are the JAX package's (one dense
    chunk, no schedule), and each row's code kills exactly the rows that
    JAX's ``tri_active_base + wall_open @ tri_wall_onehot`` kills."""
    jenv, env = dense
    _assert_layouts_equal(env._bank_np, jenv._bank_np)
    assert env.tri_chunk == jenv.tri_chunk and env.plan["kind"] == "dense"
    assert jenv._chunk_vis is None and not jenv._pvs_packed
    assert env._pg_wall is None and env._bank.pg_verts9 is None
    walls = np.stack([mazegen.host_gen_walls(np.random.default_rng(i), 3, 3)
                      for i in range(16)]).astype(np.float32)
    bank = env._bank_np
    act = bank.tri_active_base[0][None] + walls @ bank.tri_wall_onehot[0]
    assert set(np.unique(act)) <= {0.0, 1.0}
    live = trc.row_live(env._row_code[0].expand(16, -1), torch.from_numpy(walls))
    np.testing.assert_array_equal(live.numpy(), act > 0.5)


def test_dense_reset_and_steps(dense):
    """Reset and 4 steps: rewards, dones and states as JAX's, renders
    under the parity rules."""
    reset_and_steps(ENV_ID, B, W, H, 4, 9, envs=dense)


def test_dense_rollout(dense):
    """A 3-step rollout from one key: rewards, dones and checksums equal
    the JAX package's ``rollout``."""
    jenv, env = dense
    jstate, jobs = jenv.reset(jax.random.key(2))
    tstate, tobs = env.reset(2)
    _, _, j_out = jenv.rollout(jstate, jobs, jax.random.key(6), 3)
    _, _, t_out = env.rollout(tstate, tobs, trng.key_data(6), 3)
    for k in ("reward", "dones", "obs_sum"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]).astype(
            t_out[k].numpy().dtype), err_msg=k)


def test_dense_chunks_match_jax(dense):
    """The dense rows repadded to chunks of 16 (7 chunks): JAX's
    ``_tri_pass`` with ``tri_active`` and the port's tri_pass_chunked
    with ``active`` give equal t and attributes on every pixel, with each
    env's texture variants on the domain_rand bank; the wrapper takes the
    same plain scan for CPU tensors."""
    jenv, env = dense
    override = env.domain_rand
    tc = 16
    jb = jax.tree.map(jnp.asarray, jvector._repad_for_chunks(jenv._bank_np, tc))
    tb_np = tvector._repad_for_chunks(env._bank_np, tc)
    tb = layout_from_numpy(tb_np)
    n_rows = tb.tri_verts9.shape[2]
    assert n_rows % tc == 0 and n_rows // tc > 1
    jstate, _ = jenv.reset(jax.random.key(11))
    rng = np.random.default_rng(3)
    jstate = jstate.replace(dir=jnp.asarray(rng.uniform(-np.pi, np.pi, B), jnp.float32))
    origin, rays = _jax_cameras(jstate, W, H)

    def one(s, o, r):
        act = jb.tri_active_base[0] + s.wall_open @ jb.tri_wall_onehot[0]
        return jrc._tri_pass(jb.tri_verts9, jb.tri_attr, s.layout_id, o, r, tc,
                             slot_key=s.tri_slots if override else None,
                             tex_banks=(jb.tri_tex, jb.tri_tex_base, jb.tri_tex_count),
                             dr_active=override, tri_active=act, all_quads=env._all_quads)

    t_j, a_j = jax.jit(jax.vmap(one))(jstate, origin, rays)
    cam, _ = _port_camera(jstate, W, H)
    ts = to_port_state(jstate)
    active = (trc.wall_codes(tb), ts.wall_open)
    ov = None
    if override:
        tex = np.stack([tb_np.tri_tex.astype(np.float32), tb_np.tri_tex_base,
                        tb_np.tri_tex_count, np.zeros_like(tb_np.tri_tex_base)], -1)
        ov = (ts.tri_slots, torch.from_numpy(tex), None)
    t_t, a_t = trc.tri_pass_chunked(tb.tri_verts9, tb.tri_attr, ts.layout_id, cam, tc,
                                    env._all_quads, ov, None, active=active)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(a_t.float().numpy(), np.asarray(a_j.astype(jnp.float32)))
    assert np.isfinite(np.asarray(t_j)).mean() > 0.5
    t_w, a_w = trc.tri_pass(tb.tri_verts9, tb.tri_attr, ts.layout_id, cam, env._all_quads,
                            None, None, tc, ov, active=active)
    assert torch.equal(t_w, t_t) and torch.equal(a_w, a_t)
    # without the kill the scan sees the closed walls' quads in every env
    t_all, _ = trc.tri_pass_chunked(tb.tri_verts9, tb.tri_attr, ts.layout_id, cam, tc,
                                    env._all_quads, ov, None)
    assert not torch.equal(t_all, t_t)
