"""Wall-mounted camera control: CameraControl (pan, tilt, zoom) and
CameraControlClick (click to aim).

Counterpart of ``miniworld_tpu/envs/cameracontrol.py`` (reference
envs/cameracontrol.py and envs/cameracontrolclick.py): the "agent" is a
fixed camera on a random wall of an 8 m room, 0.1 m from it; an action
moves the camera, not the body (``override_physics``), and the episode
ends when the green key is centred in the view. Every observation
carries a red crosshair (``post_render``).

The arithmetic follows XLA:CPU's lowering of the JAX package's step
program, so rewards and ``info`` agree bit for bit on the CPU:
``arccos(x)`` is XLA's expansion ``atan2(sqrt((1 - x)(1 + x)), x)``,
a division by a constant a product with its float32 reciprocal, and
the transcendental functions the C library's (``ops/geom.py``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from miniworld_tpu_torch.envs.base import Ctx, EnvSpec
from miniworld_tpu_torch.ops import geom, rng as rng_ops
from miniworld_tpu_torch.state import EnvState

WALL_OFFSET = 0.1
CAMERA_HEIGHT = 1.5
_F32 = np.float32


def _wall_pose_host(wall: int, size: float):
    """Float64 camera position and yaw on wall 0..3 for the gymnasium
    adapter, which keeps the mount's exact float64 position
    (cameracontrol.py:152-179)."""
    center = size / 2
    poses = [
        [size - WALL_OFFSET, CAMERA_HEIGHT, center],
        [center, CAMERA_HEIGHT, WALL_OFFSET],
        [WALL_OFFSET, CAMERA_HEIGHT, center],
        [center, CAMERA_HEIGHT, size - WALL_OFFSET],
    ]
    yaws = [math.pi, -math.pi / 2, 0.0, math.pi / 2]
    return np.array(poses[wall], dtype=np.float64), yaws[wall]


def _wall_pose(wall: torch.Tensor, size: float):
    """(B, 3) camera positions and (B,) yaws for walls 0..3
    (cameracontrol.py:152-179): east looking west, north looking south,
    west looking east, south looking north."""
    center = size / 2
    poses = torch.tensor([[size - WALL_OFFSET, CAMERA_HEIGHT, center],
                          [center, CAMERA_HEIGHT, WALL_OFFSET],
                          [WALL_OFFSET, CAMERA_HEIGHT, center],
                          [center, CAMERA_HEIGHT, size - WALL_OFFSET]],
                         dtype=torch.float32, device=wall.device)
    yaws = torch.tensor([math.pi, -math.pi / 2, 0.0, math.pi / 2], dtype=torch.float32,
                        device=wall.device)
    return poses[wall.long()], yaws[wall.long()]


@functools.lru_cache(maxsize=None)
def crosshair_mask(height: int, width: int, device=None) -> torch.Tensor:
    """(H, W, 1) bool: the crosshair's pixels (cameracontrol.py:302-331):
    two bars 3 pixels thick, each arm 20 long 4 from the centre, and a
    dot of radius 3. Built once per image size and device."""
    cx, cy = width // 2, height // 2
    ys = torch.arange(height, device=device)[:, None]
    xs = torch.arange(width, device=device)[None, :]
    gap, length, half_t = 4, 20, 1
    horiz = ((ys - cy).abs() <= half_t) & (((xs >= cx - length - gap) & (xs <= cx - gap))
                                            | ((xs >= cx + gap) & (xs <= cx + length + gap)))
    vert = ((xs - cx).abs() <= half_t) & (((ys >= cy - length - gap) & (ys <= cy - gap))
                                          | ((ys >= cy + gap) & (ys <= cy + length + gap)))
    dot = (xs - cx) ** 2 + (ys - cy) ** 2 <= 9
    return (horiz | vert | dot)[:, :, None]


def draw_crosshair(rgb: torch.Tensor) -> torch.Tensor:
    """The (B, H, W, 3) u8 images with the red crosshair drawn over them:
    one ``torch.where`` against the size's mask."""
    mask = crosshair_mask(rgb.shape[1], rgb.shape[2], rgb.device)
    red = torch.tensor([255, 0, 0], dtype=rgb.dtype, device=rgb.device)
    return torch.where(mask, red, rgb)


def _acos(x: torch.Tensor) -> torch.Tensor:
    """float32 arccos as XLA expands ``jnp.arccos`` (chlo.acos):
    atan2(sqrt((1 - x) (1 + x)), x)."""
    return geom.atan2(geom.sqrt((1.0 - x) * (x + 1.0)), x)


@dataclass
class CameraControl(EnvSpec):
    """Discrete pan / tilt / zoom camera centring a green key
    (envs/cameracontrol.py:24-331): Discrete(6), no 6-D table."""

    name: str = "CameraControl"
    gym_id: str = "MiniWorld-CameraControl-v0"
    max_episode_steps: int = 500
    size: float = 8
    pan_speed: float = 5.0
    tilt_speed: float = 5.0
    zoom_speed: float = 2.0
    center_threshold: float = 0.15
    min_fov: float = 20.0
    max_fov: float = 90.0
    override_physics: bool = True
    num_actions: int = 6  # pan left, pan right, tilt up, tilt down, zoom in, zoom out
    key_slot: int = 0
    # HUD buttons -> discrete actions (cameracontrol.py:125-132)
    control_action_map = {
        "pan_left": 0, "pan_right": 1, "tilt_up": 2, "tilt_down": 3,
        "zoom_in": 4, "zoom_out": 5,
    }

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        world.add_rect_room(min_x=0, max_x=self.size, min_z=0, max_z=self.size)
        world.place(world.proto_id("key", "green"))
        world.place(world.proto_id("ball", "red"))
        world.place(world.proto_id("box", "blue"))
        world.place_agent_at(pos=np.array([0.5, 0, 0.5]), direction=0.0)
        if rng is not None:
            self._eager_wall = int(rng.integers(0, 4))  # cameracontrol.py:155

    def init_task(self):
        return {"camera_wall": np.int32(0)}

    def post_reset(self, bank, state: EnvState, key: torch.Tensor) -> EnvState:
        """A wall drawn per env (``randint(key, (), 0, 4)``); the camera on
        it, level, at fov 60 and height 1.5, whatever domain
        randomisation drew."""
        wall = rng_ops.randint(key, 1, 4)[:, 0]
        pos, yaw = _wall_pose(wall, self.size)
        pos = pos.clone()
        pos[:, 1] = 0.0
        zero = torch.zeros_like(yaw)
        return state.replace(
            pos=pos, dir=yaw, cam_pitch=zero, cam_fov_y=torch.full_like(yaw, 60.0),
            cam_height=torch.full_like(yaw, CAMERA_HEIGHT), cam_fwd_disp=zero.clone(),
            task={"camera_wall": wall.to(torch.int32)},
        )

    def apply_action(self, bank, state: EnvState, action: torch.Tensor) -> EnvState:
        """(B,) ids in [0, 6) (cameracontrol.py:199-211): pan 5 degrees,
        tilt 5 within +-89, zoom 2 within [20, 90]."""
        a = action.to(torch.int32)
        rad = torch.tensor(_F32(self.pan_speed * math.pi / 180.0), device=a.device)
        zero = torch.zeros_like(rad)
        yaw = state.dir + torch.where(a == 0, rad, zero) - torch.where(a == 1, rad, zero)
        pitch, fov = state.cam_pitch, state.cam_fov_y
        pitch = torch.where(a == 2, torch.clamp(pitch + self.tilt_speed, max=89.0), pitch)
        pitch = torch.where(a == 3, torch.clamp(pitch - self.tilt_speed, min=-89.0), pitch)
        fov = torch.where(a == 4, torch.clamp(fov - self.zoom_speed, min=self.min_fov), fov)
        fov = torch.where(a == 5, torch.clamp(fov + self.zoom_speed, max=self.max_fov), fov)
        return state.replace(dir=yaw, cam_pitch=pitch, cam_fov_y=fov)

    def _key_centered(self, state: EnvState):
        """((B,) centred, (B,) normalised angle from the view's centre,
        at most 1) (cameracontrol.py:246-290)."""
        b = torch.arange(state.pos.shape[0], device=state.pos.device)
        key_pos = state.ent_pos[b, self.key_slot].clone()
        key_pos[:, 1] = state.ent_height[b, self.key_slot] * 0.5
        cam_pos = state.pos.clone()
        cam_pos[:, 1] = state.cam_height
        to_key = key_pos - cam_pos
        sq = to_key * to_key
        dist = geom.sqrt(sq[:, 0] + sq[:, 1] + sq[:, 2])
        to_key_n = to_key / torch.clamp(dist, min=1e-9)[:, None]
        deg = float(_F32(math.pi / 180.0))
        pitch_rad = state.cam_pitch * deg
        cp = geom.cos(pitch_rad)
        cam_dir = torch.stack([cp * geom.cos(state.dir), geom.sin(pitch_rad),
                               -cp * geom.sin(state.dir)], dim=-1)
        p = cam_dir * to_key_n
        dot = torch.clamp(p[:, 0] + p[:, 1] + p[:, 2], -1.0, 1.0)
        angle = _acos(dot)
        half_fov = (state.cam_fov_y * 0.5) * deg
        nd = angle / half_fov
        centered = (nd <= self.center_threshold) | (dist < 0.01)
        return centered, torch.clamp(nd, max=1.0)

    def transition(self, ctx: Ctx):
        centered, _ = self._key_centered(ctx.state)
        reward = torch.where(centered, self.reward(ctx.state), torch.zeros_like(ctx.state.dir))
        return reward, centered, ctx.state

    def post_render(self, rgb: torch.Tensor, state: EnvState) -> torch.Tensor:
        return draw_crosshair(rgb)

    def info(self, ctx: Ctx):
        centered, nd = self._key_centered(ctx.state)
        return {
            "camera_yaw": ctx.state.dir,
            "camera_pitch": ctx.state.cam_pitch,
            "camera_fov": ctx.state.cam_fov_y,
            "camera_wall": ctx.state.task["camera_wall"],
            "key_centered": centered,
            "distance_from_center": nd,
        }

    # ---- host side (the gymnasium adapter), float64 ---------------------

    def host_reset(self, env, rng):
        wall = self._eager_wall
        pos, yaw = _wall_pose_host(wall, self.size)
        env.agent_pos = pos * np.array([1.0, 0.0, 1.0])
        env.agent_dir = float(yaw)
        env.cam_pitch = 0.0
        env.cam_fov_y = 60.0
        env.cam_height = CAMERA_HEIGHT
        env.cam_fwd_disp = 0.0
        return {"camera_wall": wall}

    def host_apply_action(self, env, action):
        """cameracontrol.py:199-211."""
        a = int(action)
        if a == 0:
            env.agent_dir += self.pan_speed * math.pi / 180.0
        elif a == 1:
            env.agent_dir -= self.pan_speed * math.pi / 180.0
        elif a == 2:
            env.cam_pitch = min(89.0, env.cam_pitch + self.tilt_speed)
        elif a == 3:
            env.cam_pitch = max(-89.0, env.cam_pitch - self.tilt_speed)
        elif a == 4:
            env.cam_fov_y = max(self.min_fov, env.cam_fov_y - self.zoom_speed)
        elif a == 5:
            env.cam_fov_y = min(self.max_fov, env.cam_fov_y + self.zoom_speed)

    def _host_key_centered(self, env):
        key = env.entities[self.key_slot]
        key_pos = key.pos.copy()
        key_pos[1] = key.height / 2
        cam_pos = env.agent_pos.copy()
        cam_pos[1] = env.cam_height
        to_key = key_pos - cam_pos
        dist = np.linalg.norm(to_key)
        if dist < 0.01:
            return True, 0.0
        to_key_n = to_key / dist
        pitch_rad = math.radians(env.cam_pitch)
        cam_dir = np.array([
            math.cos(pitch_rad) * math.cos(env.agent_dir),
            math.sin(pitch_rad),
            -math.cos(pitch_rad) * math.sin(env.agent_dir),
        ])
        angle = math.acos(float(np.clip(np.dot(cam_dir, to_key_n), -1, 1)))
        nd = angle / math.radians(env.cam_fov_y / 2)
        return nd <= self.center_threshold, min(nd, 1.0)

    def host_transition(self, env, action, reward, termination):
        centered, _ = self._host_key_centered(env)
        if centered:
            reward += env._reward()
            termination = True
        return reward, termination

    def host_info(self, env):
        centered, nd = self._host_key_centered(env)
        return {
            "camera_yaw": env.agent_dir,
            "camera_pitch": env.cam_pitch,
            "camera_fov": env.cam_fov_y,
            "camera_wall": env.task["camera_wall"],
            "key_centered": centered,
            "distance_from_center": nd,
        }

    def host_post_render(self, rgb, env):
        """The crosshair over one (H, W, 3) u8 image."""
        return draw_crosshair(torch.from_numpy(np.ascontiguousarray(rgb))[None])[0].numpy()


@dataclass
class CameraControlClick(CameraControl):
    """Click to aim: Box(2) click coordinates in [0, 1]
    (envs/cameracontrolclick.py:44-217)."""

    name: str = "CameraControlClick"
    gym_id: str = "MiniWorld-CameraControlClick-v0"
    movement_scale: float = 0.5
    num_actions: int = 0  # continuous Box(2)
    click_action: bool = True

    def apply_action(self, bank, state: EnvState, action: torch.Tensor) -> EnvState:
        """(B, 2) clicks: a pan and tilt toward the click, scaled by the
        fov; none within 0.01 of the centre."""
        action = action.to(torch.float32)
        dx = action[:, 0] - 0.5
        dy = action[:, 1] - 0.5
        distance = geom.sqrt(dx * dx + dy * dy)
        safe = torch.clamp(distance, min=1e-9)
        dir_x, dir_y = dx / safe, dy / safe
        fov_scale = state.cam_fov_y * float(_F32(1.0 / 60.0))
        pan = -dir_x * (self.pan_speed * self.movement_scale) * fov_scale
        tilt = -dir_y * (self.tilt_speed * self.movement_scale) * fov_scale
        move = distance > 0.01
        zero = torch.zeros_like(pan)
        # pan * pi / 180 as XLA folds it: one product with f32(pi) * f32(1 / 180)
        rad = float(_F32(_F32(math.pi) * _F32(1.0 / 180.0)))
        yaw = state.dir + torch.where(move, pan * rad, zero)
        pitch = torch.clamp(state.cam_pitch + torch.where(move, tilt, zero), -89.0, 89.0)
        return state.replace(dir=yaw, cam_pitch=pitch)

    def host_apply_action(self, env, action):
        """cameracontrolclick.py:157-217."""
        dx = float(action[0]) - 0.5
        dy = float(action[1]) - 0.5
        distance = math.sqrt(dx * dx + dy * dy)
        if distance <= 0.01:
            return
        dir_x, dir_y = dx / distance, dy / distance
        fov_scale = env.cam_fov_y / 60.0
        pan = -dir_x * self.pan_speed * self.movement_scale * fov_scale
        tilt = -dir_y * self.tilt_speed * self.movement_scale * fov_scale
        env.agent_dir += pan * math.pi / 180.0
        env.cam_pitch = float(np.clip(env.cam_pitch + tilt, -89.0, 89.0))
