"""The port's host side builds the JAX package's bank and atlas, for
every ported env: the layout bank field by field exactly, the Fourier
atlas within 1e-6, every texture tile byte for byte (zlib + numpy PNG
reader and bilinear resize against Pillow), and the same chunk plans."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu import vector as jvector
from miniworld_tpu.envs import make_spec as jax_make_spec
from miniworld_tpu.render.textures import _load_tile
from miniworld_tpu_torch import vector as tvector
from miniworld_tpu_torch.envs import make_spec
from miniworld_tpu_torch.scene.compile import Layout
from miniworld_tpu_torch.utils import image

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

TEXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "miniworld_tpu", "assets", "textures", "*.png")))
FIELDS = [f.name for f in dataclasses.fields(Layout)]
ENV_IDS = ["MiniWorld-Hallway-v0", "MiniWorld-FourRooms-v0", "MiniWorld-TMaze-v0",
           "MiniWorld-PickupObjects-v0", "MiniWorld-OneRoom-v0", "MiniWorld-OneRoomS6-v0",
           "MiniWorld-OneRoomS6Fast-v0", "MiniWorld-YMaze-v0", "MiniWorld-YMazeLeft-v0",
           "MiniWorld-YMazeRight-v0", "MiniWorld-WallGap-v0", "MiniWorld-NavigateWallGap-v0",
           "MiniWorld-Sidewalk-v0", "MiniWorld-GreenKey-v0", "MiniWorld-ThreeRooms-v0",
           "MiniWorld-Sign-v0", "MiniWorld-RoomObjects-v0", "MiniWorld-PutNext-v0"]


@pytest.fixture(scope="module", params=ENV_IDS)
def banks(request):
    jenv = JaxVec(request.param, num_envs=2, obs_width=80, obs_height=60)
    bank_np, tex_np = tvector.build_bank(make_spec(request.param))
    bank_np, statics = tvector.install_statics(bank_np, tex_np, 2, 80 * 60)
    return jenv, bank_np, tex_np, statics


@pytest.mark.parametrize("name", FIELDS)
def test_bank_field_exact(banks, name):
    jenv, bank_np, _, _ = banks
    want, got = getattr(jenv._bank_np, name), getattr(bank_np, name)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_statics_match(banks):
    jenv, _, _, statics = banks
    assert statics["tri_chunk"] == jenv.tri_chunk
    assert statics["all_quads"] == jenv._all_quads
    assert statics["shapes_present"] == jenv._shapes_present
    assert statics["has_gain"] == jenv._tex_has_gain
    assert jenv._chunk_vis is None and not jenv._pvs_packed


def test_atlas(banks):
    jenv, _, tex_np, _ = banks
    want = np.asarray(jenv._atlas)
    assert tex_np.shape == want.shape and want.shape[1] == 4 + 8 * (jenv.spec.fourier_k or 16)
    np.testing.assert_allclose(tex_np, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("path", TEXTURES, ids=os.path.basename)
def test_texture_tile_bytes(path):
    want = _load_tile(path, 256)
    got = image.resize_bilinear(image.read_png_rgb(path), 256, 256)
    assert got.dtype == np.uint8 and got.shape == (256, 256, 3)
    assert got.tobytes() == want


@pytest.mark.parametrize("env_id", ["MiniWorld-FourRooms-v0", "MiniWorld-ThreeRooms-v0"])
def test_chunk_planners(env_id):
    """Multi-room banks (the later slices): the port's planners pick the
    JAX package's plans given the same per-chunk overhead."""
    bank_np, _, _ = jvector.build_bank(jax_make_spec(env_id))
    over = jvector._CHUNK_OVERHEAD_TRIS
    j_vis, j_k, j_len = jvector.plan_culling(bank_np, 128)
    t_vis, t_k, t_len = tvector.plan_culling(bank_np, 128, over)
    assert (t_k, t_len) == (j_k, j_len)
    assert (t_vis is None) == (j_vis is None)
    if j_vis is not None:
        np.testing.assert_array_equal(t_vis, j_vis)
    j_packed = jvector.plan_packed_pvs(bank_np, 1024)
    t_packed = tvector.plan_packed_pvs(bank_np, 1024, over)
    assert t_packed[1:] == j_packed[1:]
    if j_packed[0] is not None:
        for k, v in j_packed[0].items():
            np.testing.assert_array_equal(t_packed[0][k], v)
    for chunk in (16, 32):
        np.testing.assert_array_equal(tvector._chunk_visibility(bank_np, chunk),
                                      jvector._chunk_visibility(bank_np, chunk))
        j_rep = jvector._repad_for_chunks(bank_np, 48)
        t_rep = tvector._repad_for_chunks(bank_np, 48)
        for f in dataclasses.fields(j_rep):
            a, b = getattr(j_rep, f.name), getattr(t_rep, f.name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
