"""The mesh entities' world-space rows on the port against the JAX
package on the CPU, exactly: ``entity_mesh_rows_plain`` (the plain
version of the mesh_rows kernel) equals ``entity_mesh_rows(...,
return_valid=True)`` in vertices, attributes and the live-row mask on
PickupObjects (keys, a duckie and balls beside them), CollectHealth (18
medkits), Sign (three layouts, the mesh keys beside the static sign) and
ThreeRooms (its duckie), in Fourier and nearest mode.

The states are drawn with numpy from each bank's own slot tables (every
env its own layout, entities' prototypes, positions, yaws, heights and
colours, about a fifth of the entities dead), so the rows cover live,
dead, static and non-mesh entities and the padding rows without a JAX
reset to compile. The wrapper's routing is checked on the CPU: it takes
the plain version there, ``render_rgbd`` launches nothing, and on CUDA
tensors it hands the kernel the arguments its entry point declares.
"""

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.convert import layout_from_numpy
from miniworld_tpu_torch.render import cuda_build, raycast as trc

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B = 8
IDS = ("MiniWorld-PickupObjects-v0", "MiniWorld-CollectHealth-v0", "MiniWorld-Sign-v0",
       "MiniWorld-ThreeRooms-v0")


class MeshState(NamedTuple):
    """The state fields the mesh rows read."""

    layout_id: np.ndarray  # (B,) i32
    ent_pos: np.ndarray  # (B, E, 3) f32
    ent_dir: np.ndarray  # (B, E) f32
    ent_alive: np.ndarray  # (B, E) bool
    ent_proto: np.ndarray  # (B, E) i32
    ent_color: np.ndarray  # (B, E, 3) f32
    ent_height: np.ndarray  # (B, E) f32


def draw_states(bank_np, seed: int) -> MeshState:
    """B states from the bank's slot tables: each env a random layout,
    each slot one of its prototypes (pads clamped to 0, as the reset
    does), the rest uniform draws."""
    rng = np.random.default_rng(seed)
    L, E, C = bank_np.slot_protos.shape
    lid = rng.integers(0, L, B).astype(np.int32)
    lid[:min(L, B)] = np.arange(min(L, B))  # every layout present
    pick = rng.integers(0, C, (B, E))
    proto = np.maximum(bank_np.slot_protos[lid[:, None], np.arange(E)[None, :], pick], 0)
    ext = bank_np.extents[lid]  # (B, 4) min_x, max_x, min_z, max_z
    pos = np.stack([rng.uniform(ext[:, 0:1], ext[:, 1:2], (B, E)),
                    rng.uniform(0.0, 0.5, (B, E)),
                    rng.uniform(ext[:, 2:3], ext[:, 3:4], (B, E))], -1)
    height = bank_np.proto_height[lid[:, None], proto] * rng.uniform(0.7, 1.3, (B, E))
    alive = rng.uniform(size=(B, E)) > 0.2
    alive[:, 0] = True
    return MeshState(lid, pos.astype(np.float32),
                     rng.uniform(-np.pi, np.pi, (B, E)).astype(np.float32), alive,
                     proto.astype(np.int32), rng.uniform(0.0, 1.0, (B, E, 3)).astype(np.float32),
                     height.astype(np.float32))


def port_state(st: MeshState, layout_dtype=torch.int32):
    """The port's EnvState fields of ``st`` (only the mesh rows' are read)."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in st._asdict().items()}
    out["layout_id"] = out["layout_id"].to(layout_dtype)
    return SimpleNamespace(**out)


@pytest.fixture(scope="module")
def banks():
    """env id -> (JAX bank, the port's Layout, the numpy bank)."""
    out = {}
    for env_id in IDS:
        jenv = JaxVec(env_id, num_envs=B, obs_width=32, obs_height=24)
        out[env_id] = (jenv._bank, layout_from_numpy(jenv._bank_np), jenv._bank_np)
    return out


@pytest.mark.parametrize("fourier", [True, False], ids=["fourier", "nearest"])
@pytest.mark.parametrize("env_id", IDS)
def test_entity_mesh_rows_plain(banks, env_id, fourier):
    """Vertices (inactive rows zeroed), the composed affine-uv rows,
    normal, tint, slot (atlas base in Fourier mode, layout-local in
    nearest mode) and the live-row mask, bit for bit."""
    jbank, tbank, bank_np = banks[env_id]
    st = draw_states(bank_np, seed=len(env_id) + fourier)

    def one(s):
        return jrc.entity_mesh_rows(jbank, s.layout_id, s, fourier, return_valid=True)

    jv, ja, jval = jax.jit(jax.vmap(one))(MeshState(*(jnp.asarray(v) for v in st)))
    tv9, ta, tval = trc.entity_mesh_rows_plain(tbank, port_state(st), fourier)
    jv9 = np.asarray(jv).reshape(B, -1, 9).transpose(0, 2, 1)
    np.testing.assert_array_equal(tv9.numpy(), jv9)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    n_live = int(tval.sum())
    assert 0 < n_live < tval.numel()  # live rows and inactive or padding rows
    assert (tv9.numpy()[:, :, ~tval.numpy().any(0)] == 0).all()
    # an int64 layout_id gives the same rows
    rows64 = trc.entity_mesh_rows_plain(tbank, port_state(st, torch.int64), fourier)
    for a, b in zip(rows64, (tv9, ta, tval)):
        assert torch.equal(a, b)


def test_entity_mesh_rows_cpu_takes_plain(banks, monkeypatch):
    """On CPU tensors the wrapper is the plain version, whatever
    ``use_kernels`` says, and launches nothing."""
    _, tbank, bank_np = banks["MiniWorld-CollectHealth-v0"]
    st = port_state(draw_states(bank_np, seed=3))
    want = trc.entity_mesh_rows_plain(tbank, st)
    calls = []
    plain = trc.entity_mesh_rows_plain
    monkeypatch.setattr(trc, "entity_mesh_rows_plain",
                        lambda *a: calls.append(1) or plain(*a))
    cuda_build.reset_launch_counts()
    for use_kernels in (True, False):
        got = trc.entity_mesh_rows(tbank, st, True, use_kernels)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert len(calls) == 2 and cuda_build.LAUNCHES["entity_mesh_rows"] == 0


def test_entity_mesh_rows_kernel_args(banks, monkeypatch):
    """On CUDA tensors the wrapper launches ``mw_entity_mesh_rows`` once,
    counted under "entity_mesh_rows", with as many arguments as its entry
    point declares and the outputs' shapes and dtypes (the launch itself
    is replaced here: there is no card), for int32 and int64 layout ids."""
    _, tbank, bank_np = banks["MiniWorld-Sign-v0"]
    seen = []

    def fake_launch(entry, counters, *args):
        seen.append((entry, counters, args))

    monkeypatch.setattr(trc, "is_cuda", lambda *t: True)
    monkeypatch.setattr(trc, "launch", fake_launch)
    monkeypatch.setattr(trc, "stream", lambda: ctypes.c_void_p(0))
    L, P, M = tbank.proto_mesh.shape[:3]
    for dtype, lid64 in ((torch.int32, 0), (torch.int64, 1)):
        st = port_state(draw_states(bank_np, seed=5), dtype)
        E = st.ent_proto.shape[1]
        v9, attrs, valid = trc.entity_mesh_rows(tbank, st, fourier=False)
        entry, counters, args = seen[-1]
        assert entry == "mw_entity_mesh_rows" and counters == "entity_mesh_rows"
        assert len(args) == len(cuda_build.ENTRY_POINTS[entry])
        ints = [a.value for a in args if isinstance(a, ctypes.c_int)]
        assert ints == [B, E, L, P, M, tbank.tex_slot_base.shape[1], lid64, 0]
        assert v9.shape == (B, 9, E * M) and attrs.shape == (B, E * M, trc.ATTR_DIM)
        assert valid.shape == (B, E * M) and valid.dtype == torch.bool
    with pytest.raises(TypeError, match="layout_id"):
        trc.entity_mesh_rows(tbank, port_state(draw_states(bank_np, seed=5), torch.int16))


def test_render_rgbd_cpu_takes_plain_rows(monkeypatch):
    """``render_rgbd(use_kernels=True)`` on CPU tensors builds the mesh
    rows with the plain version and launches nothing: the same frame as
    ``use_kernels=False``."""
    env = MiniWorldVec("MiniWorld-ThreeRooms-v0", 2, obs_width=16, obs_height=12, device="cpu")
    state, _ = env.reset(seed=4)
    calls = []
    plain = trc.entity_mesh_rows_plain
    monkeypatch.setattr(trc, "entity_mesh_rows_plain",
                        lambda *a: calls.append(1) or plain(*a))
    frames = []
    for use_kernels in (True, False):
        cuda_build.reset_launch_counts()
        env.use_kernels = use_kernels
        frames.append(env.render(state))
        assert not any(cuda_build.LAUNCHES.values())
    assert len(calls) == 2
    for a, b in zip(*frames):
        assert torch.equal(a, b)
