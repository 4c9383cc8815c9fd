"""Gymnasium adapter of the PyTorch port: one env, the reference's API.

Counterpart of ``miniworld_tpu/gym_env.py`` and a drop-in for the
reference's ``MiniWorldEnv`` (miniworld/miniworld.py:438-813): the same
observation and action spaces, the same ``reset(seed)`` / ``step``
contract and ``info`` dict. Physics runs on the host in float64 numpy,
line for line the JAX package's transcription of the reference (its op
order and its ``np_random`` consumption), so trajectories, rewards and
terminations replay the recorded goldens bit for bit. Each observation
is rendered on the env's torch device (the CUDA card unless the caller
asks for the CPU) in exact-texel mode (``tex_mode="nearest"``), through
the same kernels as the vectorized engine at a batch of one.

``SingleEnv`` holds all of it and needs no gymnasium; ``MiniWorldGym``
is that class as a ``gymnasium.Env`` (spaces, EzPickle), defined where
gymnasium is installed.

The render follows the JAX adapter's plan (``_jitted_render``:
``render_rgbd`` at its defaults, ``tri_chunk=128``): the world's prims,
bucketed to 64, in chunks of 128 whose last start is clamped, because
the split decides quantized-depth ties; dynamic mesh entities seed the
competition, over more than one chunk through a schedule of the
clamped chunks (``raycast.static_rows``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from miniworld_tpu_torch.convert import layout_from_numpy
from miniworld_tpu_torch.render.raycast import camera_grid, chunk_starts, render_rgbd
from miniworld_tpu_torch.render.textures import FOURIER_TERMS, TextureCatalog
from miniworld_tpu_torch.render.topview import ortho_grid_single, render_top_view, top_statics
from miniworld_tpu_torch.render.visibility import vis_statics, visible_ents, visible_ents_plain
from miniworld_tpu_torch.scene.compile import compile_world
from miniworld_tpu_torch.scene.entities import SHAPE_MESH_TRIS
from miniworld_tpu_torch.scene.world import World
from miniworld_tpu_torch.state import EnvState

try:
    import gymnasium as gym
    from gymnasium import spaces
except ModuleNotFoundError:  # SingleEnv works without it
    gym = spaces = None

# One texture catalog for every env of the process, like the reference's
# Texture.tex_cache (opengl.py:142-145); the u8 atlas of its first n
# textures is built once per (n, device).
_CATALOG = TextureCatalog()
_ATLAS_CACHE: dict = {}
# the JAX adapter's render chunk (render_rgbd's default tri_chunk)
TRI_CHUNK = 128


def _bucket(n: int, q: int) -> int:
    return max(((n + q - 1) // q) * q, q)


def _bucket_sizes(sizes: dict) -> dict:
    """The JAX adapter's padded sizes of a world's layout
    (miniworld_tpu/gym_env.py:61-67)."""
    quanta = dict(S=64, W=32, NS=16, R=8, V=4, P=4, M=8, E=4, C=2, T=8)
    return {k: _bucket(v, quanta.get(k, 1)) for k, v in sizes.items()}


def _np_random(seed: Optional[int]):
    """gymnasium's ``seeding.np_random``: (Generator(PCG64(SeedSequence(
    seed))), the sequence's entropy)."""
    if seed is not None and not (isinstance(seed, (int, np.integer)) and seed >= 0):
        raise ValueError(f"seed must be a non-negative int or None, got {seed!r}")
    seq = np.random.SeedSequence(seed)
    return np.random.Generator(np.random.PCG64(seq)), seq.entropy


def intersect_circle_segs(point, radius, segs) -> bool:
    """Float64 transcription of miniworld/math.py:30-62."""
    if len(segs) == 0:
        return False
    a = segs[:, 0, :]
    b = segs[:, 1, :]
    ab = b - a
    ap = point[None, :] - a
    t = np.clip(
        np.sum(ap * ab, axis=1) / np.sum(ab * ab, axis=1), 0.0, 1.0
    )
    c = a + t[:, None] * ab
    return bool(np.any(np.linalg.norm(c - point[None, :], axis=1) < radius))


class HostEntity:
    """Mutable per-episode entity record (reference Entity analog)."""

    __slots__ = ("pos", "dir", "radius", "height", "color", "proto_id",
                 "static", "pickable", "alive", "size_mul", "slot_idx")

    def __init__(self, pos, direction, radius, height, color, proto_id,
                 static, pickable, size_mul, slot_idx):
        self.pos = np.asarray(pos, dtype=np.float64)
        self.dir = float(direction)
        self.radius = float(radius)
        self.height = float(height)
        self.color = np.asarray(color, dtype=np.float64)
        self.proto_id = int(proto_id)
        self.static = bool(static)
        self.pickable = bool(pickable)
        self.alive = True
        self.size_mul = float(size_mul)
        self.slot_idx = int(slot_idx)


class RenderStatics(NamedTuple):
    """What an episode's renders share, made once a reset: the world's
    padded layout as a bank of one on the device, the u8 atlas, the
    chunk plan (None: one chunk), whether dynamic mesh entities seed the
    competition, and the entity count E the state is padded to."""

    bank: object
    atlas: torch.Tensor
    plan: Optional[dict]
    mesh: bool
    n_ents: int


def render_statics(world, device, tri_chunk: int = TRI_CHUNK) -> RenderStatics:
    """Compile ``world``, pad it to the JAX adapter's buckets and upload
    it as a bank of one layout (miniworld_tpu/gym_env.py:439-457).

    The prims render in chunks of ``tri_chunk`` (JAX ``render_rgbd``'s
    argument, ``TRI_CHUNK`` in its adapter) from ``chunk_starts`` (the
    last start clamped). With dynamic mesh entities over more than
    one chunk, the chunks are laid out as rows of one chunk each
    (``pvs_v9_rows`` / ``pvs_attr_rows``) and scanned in order through a
    "dense" schedule seeded by the mesh pass, as the JAX scan seeds its
    carry with it."""
    lay = compile_world(world)
    lay = lay.pad_to(_bucket_sizes(lay.sizes))
    bank_np = dataclasses.replace(
        lay, **{f.name: np.asarray(getattr(lay, f.name))[None]
                for f in dataclasses.fields(lay) if getattr(lay, f.name) is not None})
    mesh = bool((lay.proto_shape == SHAPE_MESH_TRIS).any())
    n_rows = lay.tri_verts9.shape[1]
    plan = None
    if n_rows > tri_chunk:
        starts = chunk_starts(n_rows, tri_chunk)
        plan = dict(kind="dense", tri_chunk=tri_chunk, nc=len(starts), chunk_starts=starts)
        if mesh:
            bank_np = dataclasses.replace(
                bank_np,
                pvs_v9_rows=np.stack([lay.tri_verts9[:, s:s + tri_chunk].reshape(-1)
                                      for s in starts]),
                pvs_attr_rows=np.stack([lay.tri_attr[s:s + tri_chunk].reshape(-1)
                                        for s in starts]))
    device = torch.device(device)
    key = (len(_CATALOG.paths), str(device))
    if key not in _ATLAS_CACHE:
        _ATLAS_CACHE[key] = torch.from_numpy(
            np.ascontiguousarray(_CATALOG.build_atlas(), np.uint8)).to(device)
    return RenderStatics(layout_from_numpy(bank_np, device), _ATLAS_CACHE[key], plan, mesh,
                         _bucket(len(world.slots), 4))


class SingleEnv:
    """One env over an ``EnvSpec`` (or an id), stepped on the host and
    rendered on ``device``: the gymnasium adapter without gymnasium.

    ``skip_obs``: zero observations instead of renders (renders consume
    no rng, so trajectories are unchanged). ``view="top"``: observations
    are the orthographic top view with the agent marker, an extension of
    the reference, whose reset and step observations are always
    first-person (``view`` routes only its human render window,
    miniworld.py:1692-1695); the top view itself renders as the
    reference's (miniworld.py:1147-1166). ``use_kernels=False`` renders
    with the plain PyTorch versions of the kernels on any device."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 30}

    def __init__(
        self,
        spec,
        obs_width: int = 80,
        obs_height: int = 60,
        domain_rand: bool = False,
        render_mode: Optional[str] = None,
        max_episode_steps: Optional[int] = None,
        show_controls: bool = False,
        skip_obs: bool = False,
        view: str = "agent",
        device="cuda",
        use_kernels: bool = True,
        **spec_kwargs,
    ):
        if view not in ("agent", "top"):  # miniworld.py:524-526
            raise ValueError(f"view must be 'agent' or 'top', got {view!r}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no CUDA device")
        if isinstance(spec, str):
            from miniworld_tpu_torch.envs import make_spec

            spec = make_spec(spec, **spec_kwargs)
        self.view = view
        self.device = device
        self.use_kernels = use_kernels
        self.spec_def = spec
        self.obs_width = obs_width
        self.obs_height = obs_height
        self.domain_rand = domain_rand
        self.render_mode = render_mode
        self.max_episode_steps = max_episode_steps or spec.max_episode_steps
        self.params = spec.params
        self._discrete_actions = (None if spec.discrete_actions is None
                                  else np.asarray(spec.discrete_actions))
        self.show_controls = show_controls
        self.skip_obs = skip_obs
        self.agent_radius = spec.agent_radius  # entity.py:455-529
        self._np_random = None
        self._np_random_seed = None
        self._statics = None
        self._top_cache: dict = {}
        self.world: World | None = None
        self.step_count = 0

    # -- rng (gymnasium.Env's) -------------------------------------------------

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random, self._np_random_seed = _np_random(None)
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator):
        self._np_random, self._np_random_seed = value, -1

    # -- reset ---------------------------------------------------------------

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._np_random, self._np_random_seed = _np_random(seed)
        rng = self.np_random
        rand = rng if self.domain_rand else None
        self.step_count = 0

        # fresh Agent defaults (entity.py:455-474)
        self.cam_height = 1.5
        self.cam_fwd_disp = 0.0
        self.cam_pitch = 0.0
        self.cam_fov_y = 60.0
        self.carrying: HostEntity | None = None

        # world build == reference _gen_world (rng consumed identically)
        world = World(_CATALOG, rng=rng)
        world.agent_radius = self.agent_radius
        world.set_eager_static_rand(rand)
        self.spec_def.build(world, rng)
        world.gen_static_data(rand=rand)
        self.world = world
        self.max_forward_step = float(self.params.get_max("forward_step"))

        # episode params (miniworld.py:586-592); defaults when rand None
        for name in ["sky_color", "light_pos", "light_color", "light_ambient"]:
            setattr(self, name, np.asarray(self.params.sample(rand, name), dtype=np.float64))

        # entity instantiation in placement order
        self.entities: list[HostEntity] = []
        for i, slot in enumerate(world.slots):
            proto = world.protos[slot.proto_id]
            self.entities.append(HostEntity(
                slot.pos, slot.dir, proto.radius * slot.size_mul,
                proto.height * slot.size_mul, proto.color, slot.proto_id,
                proto.static, proto.pickable, slot.size_mul, i,
            ))
        if world.agent_slot is None or world.agent_slot.pos is None:
            raise RuntimeError(f"{self.spec_def.name}: the world placed no agent")
        self.agent_pos = np.asarray(world.agent_slot.pos, dtype=np.float64)
        self.agent_dir = float(world.agent_slot.dir)

        # per-entity randomization in entity order (miniworld.py:598-599):
        # Box consumes obj_color_bias (entity.py:405-407); TextFrame
        # re-rolls per-char texture variants (entity.py:287-299); the
        # agent — appended by place_agent — consumes 4 camera params
        # (entity.py:519-529).
        for ent, slot in zip(self.entities, world.slots):
            proto = world.protos[ent.proto_id]
            if proto.colorable:
                bias = self.params.sample(rand, "obj_color_bias")
                ent.color = np.clip(proto.color + bias, 0, 1)
            char_slots = getattr(slot, "char_tex_slots", None)
            if char_slots is not None and rand is not None:
                for cs in char_slots:
                    world._sample_tex_variant(cs, rand)
        if world.agent_in_entities:
            for name in ["cam_height", "cam_fwd_disp", "cam_pitch", "cam_fov_y"]:
                setattr(self, name, float(self.params.sample(rand, name)))

        # floorplan extents (miniworld.py:601-605)
        self.min_x = min(r.min_x for r in world.rooms)
        self.max_x = max(r.max_x for r in world.rooms)
        self.min_z = min(r.min_z for r in world.rooms)
        self.max_z = max(r.max_z for r in world.rooms)

        self.wall_segs = world._wall_segs  # (N,2,2) XZ float64
        # a fresh world: its bank, plan and the top view's and the
        # visibility query's statics are made again, once
        self._statics = None
        self._top_cache = {}
        self.__dict__.pop("_vis", None)

        # spec-level per-episode host state (health, camera wall, ...)
        self.task = self.spec_def.host_reset(self, rng)

        obs = self.render_obs()
        return self._wrap_obs(obs), {"agent": self._get_agent_state()}

    # -- reference step transcription ------------------------------------

    @property
    def dir_vec(self):
        return np.array([math.cos(self.agent_dir), 0.0, -math.sin(self.agent_dir)])

    @property
    def right_vec(self):
        return np.array([math.sin(self.agent_dir), 0.0, math.cos(self.agent_dir)])

    def intersect(self, ent, pos, radius):
        """miniworld.py:1020-1046; ``ent`` may be None (the agent)."""
        p = np.array([pos[0], pos[2]])
        if intersect_circle_segs(p, radius, self.wall_segs):
            return True
        for ent2 in self.entities:
            if ent2 is ent or not ent2.alive:
                continue
            d = np.linalg.norm(np.array([ent2.pos[0], ent2.pos[2]]) - p)
            if d < radius + ent2.radius:
                return ent2
        # the agent participates in entity collision when it's not the
        # query subject (reference keeps the agent in self.entities)
        if ent is not None:
            d = np.linalg.norm(np.array([self.agent_pos[0], self.agent_pos[2]]) - p)
            if d < radius + self.agent_radius:
                return True
        return None

    def near(self, ent0, ent1=None):
        """miniworld.py:1048-1058."""
        p1, r1 = (
            (self.agent_pos, self.agent_radius)
            if ent1 is None else (ent1.pos, ent1.radius)
        )
        dist = np.linalg.norm(ent0.pos - p1)
        return dist < ent0.radius + r1 + 1.1 * self.max_forward_step

    def _get_carry_pos(self, agent_pos, ent):
        """miniworld.py:677-689."""
        dist = self.agent_radius + ent.radius + self.max_forward_step
        pos = agent_pos + self.dir_vec * 1.05 * dist
        y_pos = max(self.cam_height - ent.height - 0.3, 0)
        return pos + np.array([0.0, 1.0, 0.0]) * y_pos

    def move_agent(self, fwd_dist, strafe_dist) -> bool:
        """miniworld.py:691-717."""
        next_pos = (
            self.agent_pos + self.dir_vec * fwd_dist + self.right_vec * strafe_dist
        )
        if self.intersect(None, next_pos, self.agent_radius):
            return False
        if self.carrying is not None:
            next_carrying_pos = self._get_carry_pos(next_pos, self.carrying)
            if self.intersect(self.carrying, next_carrying_pos, self.carrying.radius):
                return False
            self.carrying.pos = next_carrying_pos
            self.carrying.dir = self.agent_dir
        self.agent_pos = next_pos
        return True

    def _update_agent_orientation(self, yaw_delta, pitch_delta) -> bool:
        """miniworld.py:719-745."""
        orig_dir, orig_pitch = self.agent_dir, self.cam_pitch
        self.agent_dir += yaw_delta
        self.cam_pitch = float(np.clip(self.cam_pitch + pitch_delta, -89.0, 89.0))
        if self.carrying is not None:
            pos = self._get_carry_pos(self.agent_pos, self.carrying)
            if self.intersect(self.carrying, pos, self.carrying.radius):
                self.agent_dir, self.cam_pitch = orig_dir, orig_pitch
                return False
            self.carrying.pos = pos
            self.carrying.dir = self.agent_dir
        return True

    def _get_agent_state(self):
        """miniworld.py:666-675."""
        return {
            "pos": self.agent_pos.copy(),
            "dir": self.agent_dir,
            "cam_pitch": self.cam_pitch,
        }

    def _reward(self):
        """miniworld.py:1095-1100."""
        return 1.0 - 0.2 * (self.step_count / self.max_episode_steps)

    def step(self, action):
        self.step_count += 1
        rand = self.np_random if self.domain_rand else None
        spec = self.spec_def
        # env step overrides in the reference see the ORIGINAL action
        # (e.g. Sign's end-action scalar check, sign.py:170)
        orig_action = action

        if spec.override_physics:
            spec.host_apply_action(self, action)
        else:
            fwd_step = self.params.sample(rand, "forward_step")
            fwd_drift = self.params.sample(rand, "forward_drift")
            turn_step = self.params.sample(rand, "turn_step")

            if np.isscalar(action) or np.ndim(action) == 0:
                if self._discrete_actions is None:
                    raise ValueError(
                        f"Scalar action {action!r} passed to an env with a "
                        "continuous Box(6) action space; pass a 6-vector or "
                        "install a mapping with set_discrete_actions()."
                    )
                action_idx = int(action)
                if not 0 <= action_idx < len(self._discrete_actions):
                    raise ValueError(
                        f"Discrete action {action_idx} outside valid range"
                    )
                action = self._discrete_actions[action_idx]
            action = np.asarray(action, dtype=np.float32)
            # NaN/inf actions would silently corrupt the agent pose
            # (np.clip passes NaN through)
            action = np.nan_to_num(action, nan=0.0, posinf=1.0, neginf=-1.0)
            # the action vector STAYS float32 through the step math —
            # the reference clips against its float32 Box bounds and
            # multiplies f32 components into the f64 step sizes
            # (miniworld.py:778-787); bit-parity requires the same
            # f32-rounded deltas
            action = np.clip(
                action,
                np.array([-1, -1, -1, -1, 0, 0], np.float32),
                np.array([1, 1, 1, 1, 1, 1], np.float32),
            )

            yaw_delta = action[2] * turn_step * math.pi / 180
            pitch_delta = action[3] * turn_step
            self._update_agent_orientation(yaw_delta, pitch_delta)

            forward_dist = action[0] * fwd_step
            strafe_dist = action[1] * fwd_step + fwd_drift
            self.move_agent(forward_dist, strafe_dist)

            if action[4] > 0.5:  # pickup (miniworld.py:789-793)
                test_pos = self.agent_pos + self.dir_vec * 1.5 * self.agent_radius
                ent = self.intersect(None, test_pos, 1.2 * self.agent_radius)
                if (
                    self.carrying is None
                    and isinstance(ent, HostEntity)
                    and not ent.static
                ):
                    self.carrying = ent
            if action[5] > 0.5 and self.carrying is not None:  # drop
                self.carrying.pos[1] = 0
                self.carrying = None

        obs = self.render_obs()

        truncation = self.step_count >= self.max_episode_steps
        # env-specific task logic (reference env step overrides)
        reward, termination = spec.host_transition(self, orig_action, 0.0, False)
        info = {"agent": self._get_agent_state()}
        info.update(spec.host_info(self))
        return self._wrap_obs(obs), reward, termination, truncation, info

    # -- rendering --------------------------------------------------------

    def render_statics(self) -> RenderStatics:
        """This episode's ``RenderStatics``, made at its first render."""
        if self._statics is None:
            self._statics = render_statics(self.world, self.device)
        return self._statics

    def render_state(self) -> EnvState:
        """The current pose and entities as a batch-of-one ``EnvState``
        on the device (miniworld_tpu/gym_env.py:459-503): entities padded
        to the episode's E, nothing carried (a carried entity is drawn
        where the host put it), layout 0, ``tex_map`` the world's slot
        table (the nearest-mode texels resolve each slot through it)."""
        st = self.render_statics()
        n = st.n_ents
        ent = np.zeros((n, 12), np.float32)  # pos 3, dir, color 3, size 3, radius, height
        alive = np.zeros(n, bool)
        proto = np.zeros(n, np.int32)
        for i, e in enumerate(self.entities):
            ent[i, 0:3] = e.pos
            ent[i, 3] = e.dir
            ent[i, 4:7] = e.color
            ent[i, 7:10] = self.world.protos[e.proto_id].size * e.size_mul
            ent[i, 10] = e.radius
            ent[i, 11] = e.height
            alive[i] = e.alive
            proto[i] = e.proto_id
        cam = np.array([self.agent_dir, self.cam_pitch, self.cam_height, self.cam_fov_y,
                        self.cam_fwd_disp], np.float32)
        dev = self.device

        def f32(a, shape):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32).reshape(shape)).to(dev)

        ent_t = f32(ent, (1, n, 12))
        cam_t = f32(cam, (5, 1))
        lights = f32(np.stack([self.sky_color, self.light_pos, self.light_color,
                               self.light_ambient]), (4, 1, 3))
        zero_i = torch.zeros(1, dtype=torch.int32, device=dev)
        return EnvState(
            pos=f32(self.agent_pos, (1, 3)), dir=cam_t[0], cam_pitch=cam_t[1],
            cam_height=cam_t[2], cam_fov_y=cam_t[3], cam_fwd_disp=cam_t[4],
            carrying=torch.full((1,), -1, dtype=torch.int32, device=dev),
            ent_pos=ent_t[:, :, 0:3].contiguous(), ent_dir=ent_t[:, :, 3].contiguous(),
            ent_alive=torch.from_numpy(alive[None]).to(dev),
            ent_proto=torch.from_numpy(proto[None]).to(dev),
            ent_color=ent_t[:, :, 4:7].contiguous(), ent_size=ent_t[:, :, 7:10].contiguous(),
            ent_radius=ent_t[:, :, 10].contiguous(), ent_height=ent_t[:, :, 11].contiguous(),
            step_count=torch.full((1,), self.step_count, dtype=torch.int32, device=dev),
            rng=torch.zeros((1, 2), dtype=torch.int64, device=dev), layout_id=zero_i,
            sky_color=lights[0], light_pos=lights[1], light_color=lights[2],
            light_ambient=lights[3],
            tex_map=torch.from_numpy(np.asarray(self.world.tex_map, np.int32)[None]).to(dev),
            tri_slots=torch.zeros(1, dtype=torch.int64, device=dev),
        )

    def render_agent_view(self):
        """((H, W, 3) u8, (H, W, 1) f32) tensors on the device: the
        agent's view before the spec's overlay."""
        st = self.render_statics()
        rgb, depth = render_rgbd(
            st.bank, self.render_state(), st.atlas, width=self.obs_width,
            height=self.obs_height, k_terms=FOURIER_TERMS, shapes_present=(True, True, st.mesh),
            use_kernels=self.use_kernels, plan=st.plan, tex_mode="nearest")
        return rgb[0], depth[0]

    def render_obs(self, depth: bool = False):
        """First-person RGB (miniworld.py:1260-1303); exact textures.

        With ``view="top"`` the observation is the orthographic top
        view including the agent marker, rendered as the reference's top
        view (miniworld.py:1147-1166): an extension, as the reference's
        observations are always first-person (miniworld.py:1692-1695);
        ``depth=True`` then returns the vertical hit distance from the
        top camera plane.
        """
        if self.skip_obs:
            rgb = np.zeros((self.obs_height, self.obs_width, 3), np.uint8)
            if depth:
                return rgb, np.zeros((self.obs_height, self.obs_width, 1), np.float32)
            return rgb
        if self.view == "top":
            return self.render_top_view(render_agent=True, with_depth=depth)
        rgb, d = self.render_agent_view()
        rgb = np.asarray(self.spec_def.host_post_render(rgb.cpu().numpy(), self))
        if depth:
            return rgb, d.cpu().numpy()
        return rgb

    def render_depth(self):
        """RGB-D observation (miniworld.py:1305-1318); depth in meters."""
        return self.render_obs(depth=True)

    def render_top_view(self, width: int | None = None, height: int | None = None,
                        render_agent: bool = True, return_scale: bool = False,
                        with_depth: bool = False):
        """Orthographic top-down map view (miniworld.py:1171-1258).

        ``render_agent`` toggles the red agent triangle;
        ``return_scale=True`` additionally returns the reference's
        world→pixel mapping dict (miniworld.py:1245-1256):
        ``{"x_scale", "z_scale", "x_offset", "z_offset"}``;
        ``with_depth=True`` returns (rgb, depth) for the view="top"
        observation path. The view spans the rooms' extents, the bank's
        ``extents`` (scene/compile.py), in the pixel grid of the JAX
        adapter's program (``topview.ortho_grid_single``); its statics
        are made once per episode and size.
        """
        w = width or self.obs_width
        h = height or self.obs_height
        st = self.render_statics()
        if (w, h) not in self._top_cache:
            self._top_cache[w, h] = top_statics(
                st.bank, w, h, grid=ortho_grid_single(st.bank.extents, w, h))
        rgb, d = render_top_view(
            st.bank, self.render_state(), st.atlas, width=w, height=h,
            agent_radius=self.agent_radius, render_agent=render_agent,
            statics=self._top_cache[w, h], tex_mode="nearest", use_kernels=self.use_kernels)
        img = rgb[0].cpu().numpy()
        if with_depth:
            if return_scale:
                raise ValueError("return_scale and with_depth are exclusive")
            return img, d[0].cpu().numpy()
        if not return_scale:
            return img
        # world→pixel scale of the aspect-fit view (miniworld.py:1192-
        # 1254): 1-unit margin, then the narrow extent is widened to
        # match the frame-buffer aspect.
        min_x, max_x = self.min_x - 1.0, self.max_x + 1.0
        min_z, max_z = self.min_z - 1.0, self.max_z + 1.0
        aspect = (max_x - min_x) / (max_z - min_z)
        fb_aspect = w / h
        if aspect > fb_aspect:
            h_diff = (max_x - min_x) / fb_aspect - (max_z - min_z)
            min_z -= h_diff / 2
            max_z += h_diff / 2
        elif aspect < fb_aspect:
            w_diff = (max_z - min_z) * fb_aspect - (max_x - min_x)
            min_x -= w_diff / 2
            max_x += w_diff / 2
        x_scale = w / (max_x - min_x)
        z_scale = h / (max_z - min_z)
        scale = {
            "x_scale": x_scale,
            "z_scale": z_scale,
            "x_offset": int(0 - min_x * x_scale),
            "z_offset": int(0 - min_z * z_scale),
        }
        return img, scale

    def set_discrete_actions(self, actions=None):
        """Install (or reset) a discrete action mapping at runtime
        (miniworld.py:654-664). ``actions`` is a list of 6-D vectors;
        None installs the default 6-move table."""
        from miniworld_tpu_torch.envs.base import default_discrete_actions

        table = (default_discrete_actions() if actions is None
                 else np.asarray(actions, dtype=np.float32))
        if table.ndim != 2 or table.shape[1] != 6:
            raise ValueError(f"a discrete action table is (n, 6), got {table.shape}")
        self._discrete_actions = table

    @property
    def control_boxes(self):
        """name -> pixel rect of clickable HUD buttons
        (miniworld.py:1389-1391, 1500-1504)."""
        from miniworld_tpu_torch import hud

        amap = getattr(self.spec_def, "control_action_map", None)
        labels = list(amap) if amap else [n for n, _ in hud.DEFAULT_CONTROLS]
        return hud.control_layout(self.obs_width, self.obs_height, labels)

    def control_action(self, name):
        """Action for a clicked HUD button, or None."""
        from miniworld_tpu_torch import hud

        amap = getattr(self.spec_def, "control_action_map", None)
        if amap:
            return amap[name]  # discrete action index
        for label, (comp, val) in hud.DEFAULT_CONTROLS:
            if label == name:
                vec = np.zeros(6, np.float32)
                vec[comp] = val
                if self._discrete_actions is not None:
                    from miniworld_tpu_torch.manual_control import project_discrete

                    return project_discrete(vec, self._discrete_actions)
                return vec
        return None

    @functools.cached_property
    def _vis(self):
        """visible_ents' statics of this episode's world (``vis_statics``)."""
        return vis_statics(self.render_statics().bank)

    def get_visible_ents(self):
        """Entities visible from the camera (miniworld.py:1576-1670): the
        set of HostEntity objects, like the reference's set of Entity
        instances (render/visibility.py at the observation's size)."""
        state = self.render_state()
        cam = camera_grid(state, self.obs_width, self.obs_height)
        f = visible_ents if self.use_kernels else visible_ents_plain
        mask = f(self._vis, state.layout_id, None, cam, state.ent_pos,
                 state.ent_alive)[0].cpu().numpy()
        return {e for e, v in zip(self.entities, mask) if v}

    def render(self):
        if self.render_mode == "rgb_array":
            frame = self.render_obs()
            if self.show_controls:
                from miniworld_tpu_torch import hud

                frame = hud.draw_controls(frame, self.control_boxes)
            return frame
        if self.render_mode == "human":
            # Interactive window with pose readout + top-view PiP, the
            # reference's human render (miniworld.py:1678-1790: agent
            # view into vis_fb, obs thumbnail, pose text). Composed
            # with the pygame/hud stack since there is no GL here.
            from miniworld_tpu_torch import hud

            frame = hud.compose_human_frame(
                self.render_obs(),
                self.render_top_view(),
                pose=(self.agent_pos[0], self.agent_pos[2],
                      math.degrees(self.agent_dir)),
            )
            if self.show_controls:
                frame = hud.draw_controls(frame, self.control_boxes)
            self._blit_human(frame)
            return None
        return None

    def _blit_human(self, frame: np.ndarray):
        """Push a frame to the lazily-created pygame window. Uses the
        SDL dummy driver automatically when no display is available
        (headless CI), where the window is a no-op surface."""
        import os

        import pygame

        if not hasattr(self, "_pygame_screen"):
            if "DISPLAY" not in os.environ and "SDL_VIDEODRIVER" not in os.environ:
                os.environ["SDL_VIDEODRIVER"] = "dummy"
            pygame.init()
            h, w = frame.shape[:2]
            scale = max(1, 600 // max(h, 1))
            self._pygame_scale = scale
            self._pygame_screen = pygame.display.set_mode((w * scale, h * scale))
            pygame.display.set_caption(f"miniworld: {self.spec_def.name}")
        surf = pygame.surfarray.make_surface(np.transpose(frame, (1, 0, 2)))
        if self._pygame_scale > 1:
            surf = pygame.transform.scale(surf, self._pygame_screen.get_size())
        self._pygame_screen.blit(surf, (0, 0))
        pygame.display.flip()
        pygame.event.pump()

    def close(self):
        if hasattr(self, "_pygame_screen"):
            import pygame

            pygame.display.quit()
            del self._pygame_screen

    def _wrap_obs(self, obs):
        if self.spec_def.dict_obs:
            return {"obs": obs, "goal": int(self.spec_def.goal)}
        return obs


if gym is not None:

    class MiniWorldGym(SingleEnv, gym.Env, gym.utils.EzPickle):
        """``SingleEnv`` as a gymnasium env: the reference's spaces, and
        EzPickle like the reference envs (miniworld/envs/*.py call
        EzPickle.__init__): pickling stores the constructor arguments and
        rebuilds a fresh env, whose world, agent and render caches start
        again at its next reset. ``device`` is one of those arguments: an
        env pickled on one device is rebuilt on the same one."""

        def __init__(self, spec, obs_width: int = 80, obs_height: int = 60,
                     domain_rand: bool = False, render_mode: Optional[str] = None,
                     max_episode_steps: Optional[int] = None, show_controls: bool = False,
                     skip_obs: bool = False, view: str = "agent", device="cuda",
                     use_kernels: bool = True, **spec_kwargs):
            gym.utils.EzPickle.__init__(
                self, spec, obs_width=obs_width, obs_height=obs_height,
                domain_rand=domain_rand, render_mode=render_mode,
                max_episode_steps=max_episode_steps, show_controls=show_controls,
                skip_obs=skip_obs, view=view, device=str(device), use_kernels=use_kernels,
                **spec_kwargs)
            SingleEnv.__init__(
                self, spec, obs_width=obs_width, obs_height=obs_height,
                domain_rand=domain_rand, render_mode=render_mode,
                max_episode_steps=max_episode_steps, show_controls=show_controls,
                skip_obs=skip_obs, view=view, device=device, use_kernels=use_kernels,
                **spec_kwargs)
            spec = self.spec_def
            # the 6-D continuous base action space (miniworld.py:483-487)
            # with the spec's discrete table over it (miniworld.py:654-664)
            if self._discrete_actions is not None:
                self.action_space = spaces.Discrete(len(self._discrete_actions))
            elif getattr(spec, "num_actions", 0):
                self.action_space = spaces.Discrete(spec.num_actions)
            elif getattr(spec, "click_action", False):
                self.action_space = spaces.Box(0.0, 1.0, (2,), np.float32)
            else:
                self.action_space = spaces.Box(
                    low=np.array([-1, -1, -1, -1, 0, 0], np.float32),
                    high=np.array([1, 1, 1, 1, 1, 1], np.float32),
                    shape=(6,), dtype=np.float32,
                )
            img_space = spaces.Box(0, 255, (obs_height, obs_width, 3), dtype=np.uint8)
            if spec.dict_obs:
                self.observation_space = spaces.Dict(obs=img_space, goal=spaces.Discrete(2))
            else:
                self.observation_space = img_space

        def set_discrete_actions(self, actions=None):
            SingleEnv.set_discrete_actions(self, actions)
            self.action_space = spaces.Discrete(len(self._discrete_actions))


def __getattr__(name):
    if name == "MiniWorldGym":
        raise ImportError("MiniWorldGym needs gymnasium, which is not installed; "
                          "SingleEnv is the same env without it")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def register_gym(prefix: str = ""):
    """Register all env ids with gymnasium (envs/__init__.py:52-185).

    With the default empty prefix the ids match the reference exactly
    (``MiniWorld-Hallway-v0`` ...), so downstream code can switch from
    the reference package by changing only the import. The port's envs
    render on the card unless ``gym.make(..., device="cpu")``.
    """
    import gymnasium

    from miniworld_tpu_torch.envs import SPEC_CLASSES

    for cls in SPEC_CLASSES:
        inst = cls()
        gym_id = prefix + inst.gym_id
        if gym_id in gymnasium.registry:
            continue
        gymnasium.register(
            id=gym_id,
            entry_point="miniworld_tpu_torch.gym_env:MiniWorldGym",
            kwargs={"spec": inst.name},
        )
