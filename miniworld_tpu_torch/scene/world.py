"""World builder: rooms + portals + entity slots -> compiled layout.

Jax-free copy of ``miniworld_tpu/scene/world.py`` (same names, same
output) for the PyTorch port. It replaces the reference's world-building
API (MiniWorldEnv.add_rect_room / add_room / connect_rooms /
place_entity / place_agent, miniworld/miniworld.py:815-1018). Env
definitions call the same-shaped methods; the builder operates in one
of two modes:

  * **record mode** (``rng=None``): placements are recorded as rules
    (room constraint, bbox overrides, direction range, prototype
    choices) and executed *on device* at reset time — the vectorized
    path.
  * **eager mode** (``rng`` = numpy Generator): placements are sampled
    immediately with the exact rejection-sampling loop and rng
    consumption order of the reference, so the gymnasium adapter
    produces bit-identical layouts/poses to the reference under the
    same seed.

Compilation pads everything to fixed shapes so layouts are stackable
into banks (procedural envs like Maze pre-generate a bank of layouts;
each env instance gathers its layout by index on device).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from miniworld_tpu_torch.render.textures import TextureCatalog
from miniworld_tpu_torch.scene.room import Room, TriBatch
from miniworld_tpu_torch.scene import entities as ent_lib
from miniworld_tpu_torch.scene.entities import Proto

# Max placement alternatives per slot (TMaze/YMaze choose between two
# goal arms with one random bit; tmaze.py:72-75).
MAX_ALTS = 2


@dataclass
class PlacementRule:
    room_idx: int = -1  # -1 = sample room proportionally to area
    min_x: float = math.nan  # nan = use room bbox
    max_x: float = math.nan
    min_z: float = math.nan
    max_z: float = math.nan
    pos: np.ndarray | None = None  # exact position, skips sampling
    dir: float | None = None  # fixed direction
    dir_lo: float = -math.pi  # uniform range when dir is None
    dir_hi: float = math.pi


@dataclass
class EntitySlot:
    proto_ids: list  # choices, sampled uniformly at reset
    rules: list  # 1..MAX_ALTS PlacementRules, chosen uniformly
    size_lo: float = 1.0  # uniform size multiplier (PutNext boxes)
    size_hi: float = 1.0
    # eager-mode sampled results
    pos: np.ndarray | None = None
    dir: float | None = None
    proto_id: int | None = None
    size_mul: float = 1.0


class World:
    """Builder for one layout of one environment class."""

    def __init__(self, catalog: TextureCatalog, rng: np.random.Generator | None = None,
                 max_forward_step: float = 0.17):
        self.catalog = catalog
        self.rng = rng
        self.eager = rng is not None
        self.max_forward_step = max_forward_step

        self.rooms: list[Room] = []
        self.protos: list[Proto] = []
        self._proto_cache: dict = {}
        self.slots: list[EntitySlot] = []
        self.agent_slot: EntitySlot | None = None
        self.agent_radius = 0.4  # Agent bounding radius (entity.py:470)

        self.static_tris = TriBatch()  # baked static entities
        # Per-layout texture slots: (atlas_base, n_variants), registered
        # in reference Texture.get order so eager-mode variant sampling
        # consumes the rng identically.
        self.tex_slots: list = []
        self._tex_slot_cache: dict = {}
        self.tex_map: list = []  # eager-mode chosen atlas index per slot

        # set once static data is generated (eager mode collision)
        self._room_tris: TriBatch | None = None
        self._wall_segs: np.ndarray | None = None
        self._room_probs: np.ndarray | None = None

    # -- textures -------------------------------------------------------

    def tex_slot(self, tex_name: str, tag=None) -> int:
        """Layout-local texture slot (unique per tag) for a texture name."""
        key = (tex_name, tag)
        if key in self._tex_slot_cache:
            return self._tex_slot_cache[key]
        from miniworld_tpu_torch.utils.assets import texture_variant_paths

        paths = texture_variant_paths(tex_name)
        base = self.catalog.add_path(paths[0])
        for p in paths[1:]:
            self.catalog.add_path(p)
        slot = len(self.tex_slots)
        self.tex_slots.append((base, len(paths)))
        self.tex_map.append(base)
        self._tex_slot_cache[key] = slot
        return slot

    def tex_slot_path(self, path: str) -> int:
        """Slot for a single texture file (mesh textures)."""
        key = ("__path__", path)
        if key in self._tex_slot_cache:
            return self._tex_slot_cache[key]
        base = self.catalog.add_path(path)
        slot = len(self.tex_slots)
        self.tex_slots.append((base, 1))
        self.tex_map.append(base)
        self._tex_slot_cache[key] = slot
        return slot

    def _sample_tex_variant(self, slot: int, rand):
        """Eager-mode variant choice (miniworld/opengl.py:136-140)."""
        base, count = self.tex_slots[slot]
        if rand is not None:
            self.tex_map[slot] = base + int(rand.integers(0, count))
        else:
            self.tex_map[slot] = base

    # -- rooms ----------------------------------------------------------

    def add_rect_room(self, min_x, max_x, min_z, max_z, **kwargs) -> Room:
        """Axis-aligned room, CCW outline (miniworld.py:815-835)."""
        outline = np.array(
            [[max_x, max_z], [max_x, min_z], [min_x, min_z], [min_x, max_z]],
            dtype=np.float64,
        )
        return self.add_room(outline=outline, **kwargs)

    def add_room(self, outline=None, **kwargs) -> Room:
        assert self._wall_segs is None, "cannot add rooms after static data is generated"
        room = Room(outline, **kwargs)
        self.rooms.append(room)
        return room

    def connect_rooms(self, room_a: Room, room_b: Room, min_x=None, max_x=None,
                      min_z=None, max_z=None, max_y=None):
        """Connect two rooms along facing edges (miniworld.py:851-920).

        Punches a portal in each room; when the portal edges don't
        touch, a junction room is created spanning the gap.
        """
        def find_facing_edges():
            for idx_a in range(room_a.num_walls):
                norm_a = room_a.edge_norms[idx_a]
                for idx_b in range(room_b.num_walls):
                    norm_b = room_b.edge_norms[idx_b]
                    if np.dot(norm_a, norm_b) > -0.9:
                        continue
                    d = room_b.outline[idx_b] - room_a.outline[idx_a]
                    if np.dot(norm_a, d) > 0.05:
                        continue
                    return idx_a, idx_b
            return None, None

        idx_a, idx_b = find_facing_edges()
        assert idx_a is not None, "matching edges not found in connect_rooms"

        start_a, end_a = room_a.add_portal(
            edge=idx_a, min_x=min_x, max_x=max_x, min_z=min_z, max_z=max_z, max_y=max_y
        )
        start_b, end_b = room_b.add_portal(
            edge=idx_b, min_x=min_x, max_x=max_x, min_z=min_z, max_z=max_z, max_y=max_y
        )

        a = room_a.outline[idx_a] + room_a.edge_dirs[idx_a] * start_a
        b = room_a.outline[idx_a] + room_a.edge_dirs[idx_a] * end_a
        c = room_b.outline[idx_b] + room_b.edge_dirs[idx_b] * start_b
        d = room_b.outline[idx_b] + room_b.edge_dirs[idx_b] * end_b

        # Directly touching portals need no junction room.
        if np.linalg.norm(a - d) < 0.001:
            return

        len_a = np.linalg.norm(b - a)
        len_b = np.linalg.norm(d - c)

        outline = np.stack([c, b, a, d])
        outline = np.stack([outline[:, 0], outline[:, 2]], axis=1)
        max_y = max_y if max_y is not None else room_a.wall_height

        room = Room(
            outline,
            wall_height=max_y,
            wall_tex=room_a.wall_tex_name,
            floor_tex=room_a.floor_tex_name,
            ceil_tex=room_a.ceil_tex_name,
            no_ceiling=room_a.no_ceiling,
        )
        self.rooms.append(room)
        room.add_portal(1, start_pos=0, end_pos=len_a)
        room.add_portal(3, start_pos=0, end_pos=len_b)

    # -- static data ----------------------------------------------------

    def gen_static_data(self, rand=None):
        """Generate room triangles + collision segments (+ texture
        variants in eager mode; miniworld.py:1070-1086)."""
        if self._wall_segs is not None:
            return
        from miniworld_tpu_torch.render.textures import TEX_DENSITY, texture_pixel_size
        from miniworld_tpu_torch.utils.assets import texture_variant_paths

        def uv_mul(name):
            w, h = texture_pixel_size(texture_variant_paths(name)[0])
            return TEX_DENSITY / w, TEX_DENSITY / h

        tris = TriBatch()
        segs = []
        self._room_tri_counts = []  # per-room triangle count, in room order
        for ri, room in enumerate(self.rooms):
            # Slot registration (and eager variant sampling) in the
            # reference's Texture.get order: wall, floor, ceil — three
            # rng draws per room with domain randomization on
            # (miniworld.py:296-298). Slots are PER (room, role), like
            # the reference's per-room Texture.get calls, so each room
            # randomizes its texture variants independently. The
            # renderer never indexes this table per pixel; variant
            # draws reach it as a per-triangle atlas index instead
            # (EnvState.tri_slots).
            wall_s = self.tex_slot(room.wall_tex_name, tag=("room", ri, 0))
            self._sample_tex_variant(wall_s, rand)
            floor_s = self.tex_slot(room.floor_tex_name, tag=("room", ri, 1))
            self._sample_tex_variant(floor_s, rand)
            ceil_s = self.tex_slot(room.ceil_tex_name, tag=("room", ri, 2))
            self._sample_tex_variant(ceil_s, rand)

            slot_map = {
                room.wall_tex_name: wall_s,
                room.floor_tex_name: floor_s,
                room.ceil_tex_name: ceil_s,
            }
            # When wall/floor/ceil share a name the last registration
            # wins in slot_map; disambiguate with a closure over roles.
            def tex_slot_fn(name, _m=(wall_s, floor_s, ceil_s), _room=room):
                if name == _room.wall_tex_name:
                    return _m[0]
                if name == _room.floor_tex_name:
                    return _m[1]
                return _m[2]

            room_tris, room_segs = room.gen_static(tex_slot_fn, uv_mul)
            self._room_tri_counts.append(len(room_tris))
            tris.extend(room_tris)
            if len(room_segs):
                segs.append(room_segs)

        self._room_tris = tris
        self._wall_segs = (
            np.concatenate(segs) if segs else np.zeros((0, 2, 2))
        )
        areas = np.array([r.area for r in self.rooms], dtype=np.float64)
        self._room_probs = areas / areas.sum()

    # -- entity prototypes ----------------------------------------------

    def proto_id(self, kind: str, *args) -> int:
        """Intern a prototype; kinds: box/ball/key/mesh."""
        key = (kind,) + tuple(
            tuple(a) if isinstance(a, (list, np.ndarray)) else a for a in args
        )
        if key in self._proto_cache:
            return self._proto_cache[key]
        if kind == "box":
            proto = ent_lib.box_proto(*args)
        elif kind == "ball":
            proto = ent_lib.ball_proto(*args)
        elif kind == "key":
            proto = ent_lib.key_proto(*args, slot_fn=self.tex_slot_path)
        elif kind == "mesh":
            proto = ent_lib.mesh_box_proto(*args, slot_fn=self.tex_slot_path)
        else:
            raise ValueError(kind)
        pid = len(self.protos)
        self.protos.append(proto)
        self._proto_cache[key] = pid
        return pid

    # -- placement ------------------------------------------------------

    def _intersect_host(self, pos, radius, skip_slot=None) -> bool:
        """Eager-mode collision: walls + already-placed entities.

        Mirrors MiniWorldEnv.intersect (miniworld.py:1020-1046) with the
        Y coordinate ignored.
        """
        p = np.array([pos[0], pos[2]])
        segs = self._wall_segs
        if len(segs):
            a_ = segs[:, 0, :]
            b_ = segs[:, 1, :]
            ab = b_ - a_
            ap = p[None, :] - a_
            t = np.clip(
                np.sum(ap * ab, axis=1) / np.sum(ab * ab, axis=1), 0.0, 1.0
            )
            c_ = a_ + t[:, None] * ab
            if np.any(np.linalg.norm(c_ - p[None, :], axis=1) < radius):
                return True
        for i, s in enumerate(self.slots):
            if s is skip_slot or s.pos is None:
                continue
            r2 = self.protos[s.proto_id].radius * s.size_mul
            if np.linalg.norm(np.array([s.pos[0], s.pos[2]]) - p) < radius + r2:
                return True
        return False

    def _place_eager(self, slot: EntitySlot, rule: PlacementRule, radius: float):
        """Reference rejection-sampling loop (miniworld.py:946-988)."""
        rng = self.rng
        if rule.pos is not None:
            slot.dir = (
                rule.dir if rule.dir is not None
                else float(rng.uniform(-math.pi, math.pi))
            )
            slot.pos = np.asarray(rule.pos, dtype=np.float64)
            return
        while True:
            if rule.room_idx >= 0:
                r = self.rooms[rule.room_idx]
            else:
                r = self.rooms[int(rng.choice(len(self.rooms), p=self._room_probs))]
            lx = r.min_x if math.isnan(rule.min_x) else rule.min_x
            hx = r.max_x if math.isnan(rule.max_x) else rule.max_x
            lz = r.min_z if math.isnan(rule.min_z) else rule.min_z
            hz = r.max_z if math.isnan(rule.max_z) else rule.max_z
            pos = rng.uniform(
                low=[lx - radius, 0, lz - radius], high=[hx + radius, 0, hz + radius]
            )
            if not r.point_inside(pos):
                continue
            if self._intersect_host(pos, radius, skip_slot=slot):
                continue
            if rule.dir is not None:
                d = rule.dir
            elif rule.dir_lo != -math.pi or rule.dir_hi != math.pi:
                d = float(rng.uniform(rule.dir_lo, rule.dir_hi))
            else:
                d = float(rng.uniform(-math.pi, math.pi))
            slot.pos = pos
            slot.dir = d
            return

    def place(self, proto_ids, rules=None, size_lo=1.0, size_hi=1.0, **rule_kwargs):
        """Place a dynamic (or colliding static) entity slot.

        ``proto_ids`` may be an int or a list of candidate prototype
        ids (uniform choice at reset). ``rules`` may give explicit
        alternatives; otherwise one rule is built from ``rule_kwargs``
        (room/pos/dir/min_x/... like the reference place_entity).
        """
        if isinstance(proto_ids, int):
            proto_ids = [proto_ids]
        if rules is None:
            rules = [self._make_rule(**rule_kwargs)]
        assert 1 <= len(rules) <= MAX_ALTS
        slot = EntitySlot(proto_ids=list(proto_ids), rules=rules,
                          size_lo=size_lo, size_hi=size_hi)
        self.slots.append(slot)

        if self.eager:
            # Eager (parity) builders must resolve all randomness
            # themselves in the reference's rng consumption order.
            assert len(proto_ids) == 1 and len(rules) == 1 and size_lo == size_hi
            self.gen_static_data(rand=self._eager_static_rand)
            slot.proto_id = proto_ids[0]
            slot.size_mul = float(size_lo)
            radius = self.protos[slot.proto_id].radius * slot.size_mul
            self._place_eager(slot, rules[0], radius)
        return len(self.slots) - 1

    def _make_rule(self, room=None, pos=None, dir=None, dir_range=None,
                   min_x=None, max_x=None, min_z=None, max_z=None) -> PlacementRule:
        rule = PlacementRule()
        if room is not None:
            rule.room_idx = self.rooms.index(room) if isinstance(room, Room) else int(room)
        if pos is not None:
            rule.pos = np.asarray(pos, dtype=np.float64)
        if dir is not None:
            rule.dir = float(dir)
        if dir_range is not None:
            rule.dir_lo, rule.dir_hi = float(dir_range[0]), float(dir_range[1])
        for name, v in (("min_x", min_x), ("max_x", max_x), ("min_z", min_z), ("max_z", max_z)):
            if v is not None:
                setattr(rule, name, float(v))
        return rule

    # Whether place_agent was used (the reference then appends the
    # agent to the entity list and randomizes its camera params with the
    # other entities; CameraControl sets the pose directly instead).
    agent_in_entities = False

    def place_agent(self, **rule_kwargs):
        """Agent placement — always last (miniworld.py:994-1018)."""
        rule = self._make_rule(**rule_kwargs)
        slot = EntitySlot(proto_ids=[], rules=[rule])
        self.agent_slot = slot
        self.agent_in_entities = True
        if self.eager:
            self.gen_static_data(rand=self._eager_static_rand)
            self._place_eager(slot, rule, self.agent_radius)
        return slot

    def place_agent_at(self, pos, direction):
        """Direct agent pose assignment (cameracontrol.py:146-147)."""
        rule = self._make_rule(pos=pos, dir=direction)
        slot = EntitySlot(proto_ids=[], rules=[rule])
        slot.pos = np.asarray(pos, dtype=np.float64)
        slot.dir = float(direction)
        self.agent_slot = slot
        self.agent_in_entities = False
        return slot

    # Eager-mode hook: whether texture variants consume the rng (set by
    # the adapter when domain randomization is on).
    _eager_static_rand = None

    def set_eager_static_rand(self, rand):
        self._eager_static_rand = rand

    # -- static entity baking -------------------------------------------

    def bake_mesh(self, mesh_name: str, height: float, pos, direction=None):
        """Static MeshEnt: bake triangles AND add a collision slot.

        ``direction=None`` mirrors the reference's
        ``place_entity(ent, pos=...)`` with no ``dir``: one np_random
        uniform is consumed for the orientation (miniworld.py:946-952)
        — essential for eager-mode rng parity (Sidewalk's cones). The
        slot is placed FIRST so the draw lands at the reference's
        sequence position; baking then uses the resolved direction.
        In record mode (layout banks) an unspecified direction bakes at
        0 — per-episode rotation of a static mesh cannot be baked, and
        the only users (cones) are rotationally symmetric.
        """
        pid = self.proto_id("mesh", mesh_name, height, True)
        # Static entities still occupy space (they live in the entity
        # list and block movement/placement; miniworld.py:1034-1044).
        idx = self.place(pid, pos=np.asarray(pos, dtype=np.float64), dir=direction)
        if self.eager:
            bake_dir = self.slots[idx].dir
        else:
            bake_dir = 0.0 if direction is None else float(direction)
        ent_lib.bake_static_mesh(
            self.static_tris, mesh_name, height, pos, bake_dir,
            lambda path: self.tex_slot_path(path),
        )
        return idx

    def bake_image_frame(self, pos, direction, tex_name, width, depth=0.05):
        slot = self.tex_slot(tex_name, tag=("frame", len(self.slots)))
        if self.eager:
            self._sample_tex_variant(slot, None)  # ImageFrame never randomizes
        ent_lib.bake_image_frame(
            self.static_tris, pos, direction, tex_name, width, slot, depth
        )
        # zero-radius entity row (participates in lists but not collision)
        pid = self._zero_proto()
        return self.place(pid, pos=np.asarray(pos, dtype=np.float64), dir=direction)

    def bake_text_frame(self, pos, direction, text, height=0.15, depth=0.05):
        char_slots = []

        def slot_fn(name):
            s = self.tex_slot(name, tag=("textframe", len(self.slots), len(char_slots)))
            char_slots.append(s)
            return s

        ent_lib.bake_text_frame(self.static_tris, pos, direction, text, slot_fn, height, depth)
        pid = self._zero_proto()
        idx = self.place(pid, pos=np.asarray(pos, dtype=np.float64), dir=direction)
        self.slots[idx].char_tex_slots = char_slots
        return idx

    def _zero_proto(self) -> int:
        key = ("__zero__",)
        if key in self._proto_cache:
            return self._proto_cache[key]
        pid = len(self.protos)
        self.protos.append(
            Proto(shape=ent_lib.SHAPE_NONE, size=np.zeros(3), radius=0.0,
                  height=0.0, color=np.zeros(3), static=True, pickable=False)
        )
        self._proto_cache[key] = pid
        return pid
