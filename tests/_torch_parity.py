"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages run on the CPU in one process; data crosses between them
as numpy arrays through ``miniworld_tpu_torch.convert``.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from miniworld_tpu_torch.convert import state_from_numpy, state_to_numpy

ENV_ID = "MiniWorld-Hallway-v0"
W, H = 80, 60

# Tolerances of the parity contract (ROADMAP queue A):
FLOAT_ATOL = 1e-5  # state floats
DEPTH_RTOL = 1e-5  # depth, where both pick the same winner
MAX_WINNER_DIFF = 1e-3  # fraction of pixels whose winner differs
MAX_RGB_DIFF = 2  # u8 levels, on pixels whose winner agrees


def jax_state_arrays(state) -> tuple[dict, np.ndarray]:
    """(field -> numpy, key data) of a batched JAX EnvState."""
    fields = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "rng" or v is None:
            continue
        if f.name == "task":
            fields["task"] = {k: np.asarray(a) for k, a in v.items()}
        else:
            fields[f.name] = np.asarray(v)
    return fields, np.asarray(jax.random.key_data(state.rng))


def to_port_state(state):
    """The port's EnvState holding the same values as a JAX EnvState."""
    fields, key_data = jax_state_arrays(state)
    return state_from_numpy(fields, key_data)


def assert_states_match(jstate, tstate, atol: float = FLOAT_ATOL):
    """Ints, bools and key data exact; floats within ``atol``."""
    fields, key_data = jax_state_arrays(jstate)
    port = state_to_numpy(tstate)
    np.testing.assert_array_equal(port["rng"], key_data.astype(np.int64))
    for name, want in fields.items():
        if name == "task":
            continue
        got = port[name]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def assert_images_match(j_rgb, j_depth, t_rgb, t_depth):
    """Depth equality (rtol DEPTH_RTOL) stands for 'same winner': it may
    fail on at most MAX_WINNER_DIFF of the pixels, and RGB is within
    MAX_RGB_DIFF u8 levels everywhere else. Returns the stats."""
    j_rgb = np.asarray(j_rgb).astype(np.int32)
    j_depth = np.asarray(j_depth)[..., 0]
    t_rgb = t_rgb.numpy().astype(np.int32)
    t_depth = t_depth.numpy()[..., 0]
    assert t_rgb.shape == j_rgb.shape and t_depth.shape == j_depth.shape
    same = np.isclose(t_depth, j_depth, rtol=DEPTH_RTOL, atol=0)
    differ = 1.0 - same.mean()
    rgb_err = int(np.abs(t_rgb - j_rgb).max(-1)[same].max(initial=0))
    assert differ <= MAX_WINNER_DIFF, f"winner differs on {differ:.4%} of pixels"
    assert rgb_err <= MAX_RGB_DIFF, f"rgb differs by {rgb_err} levels"
    return differ, rgb_err
