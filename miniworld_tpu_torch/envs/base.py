"""Environment specifications for the PyTorch port.

Counterpart of ``miniworld_tpu/envs/base.py``. An ``EnvSpec`` declares
the world builder (host-side numpy, shared logic with the JAX package)
and the per-step task logic twice: as functions over a batched
``EnvState`` for the vectorized engine (vector.py), and as float64
numpy hooks (``host_*``) for the single-env gymnasium adapter
(gym_env.py), which follow the reference env's ``step`` overrides
operation by operation. The port carries all 27 ids of the JAX
package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from miniworld_tpu_torch.ops import geom, physics
from miniworld_tpu_torch.params import DEFAULT_PARAMS, DomainParams
from miniworld_tpu_torch.state import EnvState, StepResult


class Ctx(NamedTuple):
    """Inputs to a spec's transition function (batched over envs)."""

    prev: EnvState  # state before physics
    state: EnvState  # state after physics
    res: StepResult
    action: torch.Tensor  # (B, 6) clipped continuous action
    action_idx: torch.Tensor  # (B,) i32 discrete action index, or -1
    truncated: torch.Tensor  # (B,) bool — step limit reached this step
    bank: Any = None  # the layout bank (scene/compile.Layout of tensors)
    # False: the task's own kernels (CollectHealth's placement) take their
    # plain versions, as the env's render and reset do
    use_kernels: bool = True


def default_discrete_actions() -> np.ndarray:
    """turn-/turn+/fwd+/fwd-/strafe-/strafe+ (miniworld.py:642-652)."""
    acts = np.zeros((6, 6), dtype=np.float32)
    acts[0, 2] = -1.0  # turn left
    acts[1, 2] = +1.0  # turn right
    acts[2, 0] = +1.0  # forward
    acts[3, 0] = -1.0  # back
    acts[4, 1] = -1.0  # strafe left
    acts[5, 1] = +1.0  # strafe right
    return acts


def action_from_components(forward=0.0, strafe=0.0, turn=0.0, pitch=0.0,
                           pickup=0.0, drop=0.0) -> np.ndarray:
    """The action vector from its components (miniworld.py:620-640)."""
    return np.array([forward, strafe, turn, pitch, pickup, drop], dtype=np.float32)


@dataclass
class EnvSpec:
    """Base spec; concrete envs subclass and override hooks."""

    name: str = "Base"
    gym_id: str = ""
    max_episode_steps: int = 1500
    params: DomainParams = field(default_factory=lambda: DEFAULT_PARAMS)
    # (D, 6) table for discrete envs, None for the raw 6-D Box space
    discrete_actions: np.ndarray | None = None
    num_layouts: int = 1  # layout bank size (procedural envs > 1)
    obs_width: int = 80
    obs_height: int = 60
    # Sign wraps observations in {"obs": image, "goal": int}
    dict_obs: bool = False
    # CameraControl: ``apply_action`` replaces the agent's physics
    override_physics: bool = False
    agent_radius: float = 0.4  # Agent bounding radius (entity.py:470)
    place_budget: int = 16  # on-device placement retry budget (ops/place.py)
    fourier_k: int = 0  # 0 = the global default (textures.FOURIER_TERMS)
    # MiniWorldVec(procgen=None) follows this: True for the Maze family,
    # whose resets generate a fresh maze on the device
    procgen_default: bool = False

    @property
    def max_forward_step(self) -> float:
        return float(self.params.get_max("forward_step"))

    def build(self, world, rng: np.random.Generator | None,
              layout_rng: np.random.Generator | None = None,
              layout_idx: int = 0):
        """Populate the world (record mode: ``rng`` is None)."""
        raise NotImplementedError

    def post_reset(self, bank, state: EnvState, key: torch.Tensor) -> EnvState:
        """Adjust a freshly reset batch (CameraControl's wall); ``key``
        (B, 2) is each env's second split of its reset key."""
        return state

    def post_render(self, rgb: torch.Tensor, state: EnvState) -> torch.Tensor:
        """Overlay on the observation's image (CameraControl's crosshair)."""
        return rgb

    def init_task(self) -> dict:
        """Initial per-episode task state (concrete values)."""
        return {}

    def transition(self, ctx: Ctx):
        """Returns (reward (B,) f32, termination (B,) bool, new_state)."""
        b = ctx.state.pos.shape[0]
        dev = ctx.state.pos.device
        return (torch.zeros(b, dtype=torch.float32, device=dev),
                torch.zeros(b, dtype=torch.bool, device=dev), ctx.state)

    def apply_action(self, bank, state: EnvState, action: torch.Tensor) -> EnvState:
        """The step's own physics for an ``override_physics`` spec."""
        raise NotImplementedError

    def info(self, ctx: Ctx) -> dict:
        """Extra per-step info entries ((B, ...) tensors)."""
        return {}

    # ---- host-side hooks of the gymnasium adapter (gym_env.py) ---------
    # float64 numpy, the reference env ``step`` overrides line for line

    def host_reset(self, env, rng) -> dict:
        """Per-episode host task state; runs at the end of reset."""
        return {}

    def host_transition(self, env, action, reward, termination):
        """The reference env's ``step`` override (after base physics)."""
        return reward, termination

    def host_info(self, env) -> dict:
        return {}

    def host_apply_action(self, env, action):
        """The step's own physics for an ``override_physics`` spec."""
        raise NotImplementedError

    def host_post_render(self, rgb: np.ndarray, env) -> np.ndarray:
        """Overlay on one (H, W, 3) u8 observation image."""
        return rgb

    def reward(self, state: EnvState) -> torch.Tensor:
        """Sparse reward shape (miniworld.py:1095-1100),
        1 - 0.2 * step_count / max_episode_steps.

        Evaluated as XLA compiles the JAX package's expression — the
        division becomes a multiply by the float32 reciprocal and the two
        constants fold into one — so rewards agree bit for bit."""
        c = np.float32(np.float32(0.2) * np.float32(1.0 / self.max_episode_steps))
        return 1.0 - state.step_count.to(torch.float32) * float(c)

    def near(self, state: EnvState, idx0: int, idx1: int | None = None) -> torch.Tensor:
        """(B,) entity ``idx0`` near entity ``idx1`` (None: the agent)."""
        return physics.near(state, idx0, idx1, max_forward_step=self.max_forward_step)

    def near_agent(self, state: EnvState, idx0: int) -> torch.Tensor:
        return self.near(state, idx0)

    def agent_in_room(self, bank, state: EnvState, room_idx: int) -> torch.Tensor:
        """(B,) bool: the agent strictly inside room ``room_idx`` of its
        layout (Room.point_inside; sidewalk.py:99)."""
        lid = state.layout_id.long()
        return geom.point_inside_convex(
            state.pos[:, [0, 2]], bank.room_outline[lid, room_idx],
            bank.room_norms[lid, room_idx], bank.room_vmask[lid, room_idx],
        )


class GoToEnvSpec(EnvSpec):
    """'Near the goal entity -> reward and terminate' (hallway.py:67-74)."""

    goal_slot: int = 0

    def transition(self, ctx: Ctx):
        reached = self.near_agent(ctx.state, self.goal_slot)
        reward = torch.where(reached, self.reward(ctx.state),
                             torch.zeros_like(ctx.state.dir))
        return reward, reached, ctx.state

    def host_transition(self, env, action, reward, termination):
        if env.near(env.entities[self.goal_slot]):
            reward += env._reward()
            termination = True
        return reward, termination


DIR_QUARTER = (-math.pi / 4, math.pi / 4)
