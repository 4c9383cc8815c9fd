"""Observation and action wrappers (reference: miniworld/wrappers.py:7-69).

Counterpart of ``miniworld_tpu/wrappers.py``. Two families:
  * gymnasium wrappers for the single-env adapter (gym_env.py): the
    reference classes, same names, same math;
  * functions on the batched tensors of the vectorized engine
    (vector.py), which a gymnasium wrapper cannot wrap.

The gymnasium wrappers need gymnasium; the batched functions do not.
"""

from __future__ import annotations

import numpy as np
import torch

from miniworld_tpu_torch.ops import rng as rng_ops

try:
    import gymnasium as gym
    from gymnasium import spaces
except ModuleNotFoundError:  # the batched functions work without it
    gym = spaces = None

# luma weights (wrappers.py:37-41)
_LUMA = (0.30, 0.59, 0.11)


if gym is not None:

    class PyTorchObsWrapper(gym.ObservationWrapper):
        """HWC uint8 -> CWH transpose (wrappers.py:7-24)."""

        def __init__(self, env):
            super().__init__(env)
            obs_shape = self.observation_space.shape
            self.observation_space = spaces.Box(
                self.observation_space.low.flatten()[0],
                self.observation_space.high.flatten()[0],
                [obs_shape[2], obs_shape[1], obs_shape[0]],
                dtype=self.observation_space.dtype,
            )

        def observation(self, observation):
            return observation.transpose(2, 1, 0)

    class GreyscaleWrapper(gym.ObservationWrapper):
        """RGB -> single-channel greyscale (wrappers.py:27-46)."""

        def __init__(self, env):
            super().__init__(env)
            obs_shape = self.observation_space.shape
            self.observation_space = spaces.Box(
                self.observation_space.low.flatten()[0],
                self.observation_space.high.flatten()[0],
                [obs_shape[0], obs_shape[1], 1],
                dtype=self.observation_space.dtype,
            )

        def observation(self, obs):
            obs = (
                _LUMA[0] * obs[:, :, 0]
                + _LUMA[1] * obs[:, :, 1]
                + _LUMA[2] * obs[:, :, 2]
            )
            return np.expand_dims(obs, axis=2).astype(self.observation_space.dtype)

    class StochasticActionWrapper(gym.ActionWrapper):
        """epsilon-random action substitution (wrappers.py:48-69).

        With probability ``prob`` the agent's action passes through;
        otherwise ``random_action`` is executed when given, else a sample
        from the action space. Draws come from the env's seeded
        ``np_random`` so trajectories reproduce under a fixed seed.
        """

        def __init__(self, env, prob: float = 0.9, random_action=None):
            super().__init__(env)
            self.prob = prob
            self.random_action = random_action

        def action(self, action):
            if self.np_random.uniform() < self.prob:
                return action
            if self.random_action is None:
                return self.action_space.sample()
            return self.random_action


# -- batched counterparts, on the engine's tensors ------------------------


def pytorch_obs(obs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, W, H); same transpose as PyTorchObsWrapper."""
    return obs.permute(0, 3, 2, 1)


def greyscale_obs(obs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 -> (B, H, W, 1) u8 with the reference luma weights,
    in float32 as the JAX package computes it."""
    f = obs.to(torch.float32)
    g = _LUMA[0] * f[..., 0] + _LUMA[1] * f[..., 1] + _LUMA[2] * f[..., 2]
    return g[..., None].to(obs.dtype)


def stochastic_actions(key: torch.Tensor, actions: torch.Tensor, sample_fn,
                       prob: float = 0.9) -> torch.Tensor:
    """With probability ``prob`` keep each env's action, else substitute
    a random one: ``key`` is (2,) key data (``ops.rng.key_data``), split
    in two as ``jax.random.split``; the first draws the (B,) uniforms of
    the keep mask (``jax.random.uniform``), the second goes to
    ``sample_fn`` (e.g. ``MiniWorldVec.sample_actions``), whose (B, ...)
    actions stand in where the mask is off."""
    k1, k2 = rng_ops.split(key, 2).unbind(0)
    n = actions.shape[0]
    keep = rng_ops.uniform(k1, (n,), 0.0, 1.0).to(actions.device) < prob
    rand = sample_fn(k2)
    return torch.where(keep.reshape((n,) + (1,) * (actions.dim() - 1)), actions, rand)
