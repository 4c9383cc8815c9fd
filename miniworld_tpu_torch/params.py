"""Domain-randomization parameter registry.

Jax-free copy of the numpy part of ``miniworld_tpu/params.py`` (the
counterpart of the reference's DomainParams, miniworld/params.py:7-130):
named parameters with (default, min, max) and host-side uniform
sampling, where a ``None`` rng yields the default. The JAX package's
device-side ``jax_sample*`` helpers have no counterpart here: the
port runs without domain randomization so far.

The registry is immutable-by-copy like the reference: ``no_random()``
and ``set()`` return/modify copies so env-specific overrides (e.g.
OneRoomS6Fast, envs/oneroom.py:80-83) compose the same way.
"""

from __future__ import annotations

from copy import deepcopy
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Param:
    default: np.ndarray | float
    min: np.ndarray | float
    max: np.ndarray | float
    type: str = "float"


class DomainParams:
    """Named simulation parameters with randomization ranges."""

    def __init__(self):
        self.params: dict[str, Param] = {}

    def copy(self) -> "DomainParams":
        return deepcopy(self)

    def no_random(self) -> "DomainParams":
        """Copy with all ranges collapsed to the defaults."""
        c = self.copy()
        for name, p in c.params.items():
            c.params[name] = Param(p.default, p.default, p.default, p.type)
        return c

    def set(self, name, default, min=None, max=None, type="float"):
        if isinstance(default, list):
            default = np.array(default, dtype=float)
        if isinstance(min, list):
            min = np.array(min, dtype=float)
        if isinstance(max, list):
            max = np.array(max, dtype=float)
        if min is None:
            min = default
        if max is None:
            max = default
        if isinstance(default, np.ndarray):
            assert np.all(max >= default) and np.all(default >= min)
        else:
            assert max >= default >= min
        self.params[name] = Param(default, min, max, type)

    def get_max(self, name):
        return self.params[name].max

    def get_default(self, name):
        return self.params[name].default

    # -- host-side sampling (numpy Generator; parity with reference) ----

    def sample(self, rng: np.random.Generator | None, name: str):
        """Uniform sample in [min, max]; default when rng is None.

        Matches DomainParams.sample (miniworld/params.py:85-103)
        including its rng consumption (one ``uniform``/``integers`` call
        per parameter).
        """
        p = self.params[name]
        if rng is None:
            return p.default
        if p.type == "float":
            return rng.uniform(p.min, p.max)
        elif p.type == "int":
            return rng.integers(p.min, p.max + 1)
        raise AssertionError(p.type)

    def sample_many(self, rng, target_obj, names):
        for name in names:
            setattr(target_obj, name, self.sample(rng, name))


def make_default_params() -> DomainParams:
    """The 13 default simulation parameters (miniworld/params.py:115-130)."""
    p = DomainParams()
    p.set("sky_color", [0.25, 0.82, 1], [0.1, 0.1, 0.1], [1.0, 1.0, 1.0])
    p.set("light_pos", [0, 2.5, 0], [-40, 2.5, -40], [40, 5, 40])
    p.set("light_color", [0.7, 0.7, 0.7], [0.45, 0.45, 0.45], [0.8, 0.8, 0.8])
    p.set("light_ambient", [0.45, 0.45, 0.45], [0.35, 0.35, 0.35], [0.55, 0.55, 0.55])
    p.set("obj_color_bias", [0, 0, 0], [-0.2, -0.2, -0.2], [0.2, 0.2, 0.2])
    p.set("forward_step", 0.15, 0.12, 0.17)
    p.set("forward_drift", 0, -0.05, 0.05)
    p.set("turn_step", 15, 10, 20)
    p.set("bot_radius", 0.4, 0.38, 0.42)
    p.set("cam_pitch", 0, -5, 5)
    p.set("cam_fov_y", 60, 55, 65)
    p.set("cam_height", 1.5, 1.45, 1.55)
    p.set("cam_fwd_disp", 0, -0.05, 0.10)
    return p


DEFAULT_PARAMS = make_default_params()
