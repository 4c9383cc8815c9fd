"""The 8x8 Maze's full layout bank (``procgen=False``, 64 layouts), whose
chunk plan is packed per-room PVS: the port's plan and installed packed
bank equal the JAX package's at the three (B, W, H) of
tests/test_torch_chunks.py. The bank takes about a minute to build, so
it is built once, by the port (tests/test_torch_maze.py holds the two
builds equal), and given to both packages' constructors."""

import dataclasses

import numpy as np
import pytest

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu import vector as jvector
from miniworld_tpu.scene.compile import Layout as JaxLayout
from miniworld_tpu_torch import vector as tvector
from miniworld_tpu_torch.envs import make_spec

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

SIZES = [(8, 80, 60), (1024, 80, 60), (1024, 160, 120)]
PACKED = ("pvs_verts9", "pvs_attr", "pvs_tri_tex", "pvs_tri_tex_base", "pvs_tri_tex_count",
          "pvs_room_base", "pvs_room_nchunks", "pvs_v9_rows", "pvs_attr_rows", "tri_attr",
          "tri_verts9", "tri_mask")


@pytest.fixture(scope="module")
def maze64():
    return tvector.build_bank(make_spec("MiniWorld-Maze-v0"))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "B%d-%dx%d" % s)
def test_maze_bank_plan_matches_jax(maze64, size, monkeypatch):
    b, w, h = size
    bank_np, tex_np = maze64
    j_bank = JaxLayout(**{f.name: getattr(bank_np, f.name) for f in dataclasses.fields(bank_np)})
    monkeypatch.setattr(jvector, "build_bank", lambda *a, **k: (j_bank, tex_np, None))
    jenv = JaxVec("MiniWorld-Maze-v0", num_envs=b, obs_width=w, obs_height=h, procgen=False)
    got, statics = tvector.install_statics(bank_np, tex_np, b, w * h)
    plan = statics["plan"]
    assert jenv._pvs_packed and plan["kind"] == "packed_pvs"
    assert (plan["cap"], plan["tri_chunk"], plan["sched_len"]) == (
        jenv._chunk_cap, jenv.tri_chunk, jenv._sched_len) and plan["sched_len"] == 1
    for name in PACKED:
        np.testing.assert_array_equal(getattr(got, name), getattr(jenv._bank_np, name),
                                      err_msg=name)
