"""Compile-time potentially-visible sets (PVS) over the room portal graph.

The reference renders the whole scene every frame (display list +
dynamic entities, miniworld/miniworld.py:1147-1169) — correct but
O(all triangles). The raycaster's cost is O(pixels x triangles), so
maze-scale scenes (Maze 8x8: ~1.8k triangles, 127 rooms) pay for
geometry the camera can never see. Because every MiniWorld world is a
set of CONVEX rooms connected by PORTALS punched into vertical walls
(miniworld/miniworld.py:123-271), visibility between rooms is a 2D
portal-stabbing problem on the floorplan: room B is visible from room A
iff a straight line in the XZ plane crosses a sequence of portal
segments leading from A to B.

This module computes, per layout at compile time, the conservative
room-to-room visibility matrix with the classic portal "anti-penumbra"
algorithm (Teller-style, as used by Quake's qvis, here in 2D):

  * depth 1 and 2 (the room itself, its portal neighbors, and their
    neighbors) are trivially fully visible;
  * deeper portals are clipped against the separating lines of the
    (source portal, current clipped portal) pair: a line through one
    endpoint of each, valid when the other endpoints straddle it.
    A candidate portal clipped to nothing prunes the search.

The result is CONSERVATIVE (never culls a visible room): dropping the
intermediate-portal constraints and skipping degenerate separating
lines can only enlarge the computed set. The renderer uses the PVS to
schedule triangle chunks per env (render/raycast.py); a missed cull
costs time, a false cull would cost pixels — so every choice here errs
toward inclusion.

Worlds with any open-air room (``no_ceiling=True`` — WallGap, Sidewalk,
CollectHealth) return the all-visible matrix: without a ceiling, tall
geometry is visible OVER walls and portal visibility is not a bound.
"""

from __future__ import annotations

import numpy as np

# Endpoint tolerance when pairing coincident portal segments of two
# rooms (connect_rooms punches matching portals into both rooms, or
# into each room and a junction room; scene/world.py:152-208).
_MATCH_TOL = 1e-3
# Minimum |cross| for a separating-line endpoint test; anything closer
# to collinear is skipped (no constraint => conservative).
_AREA_EPS = 1e-7
# Safety valve: a source room whose beam DFS exceeds this many steps
# falls back to all-visible for that room (pathological portal webs).
_MAX_STEPS_PER_ROOM = 100_000


def portal_connections(rooms):
    """Pair up coincident portal segments into room adjacencies.

    Returns [(room_i, room_j, p0, p1)] with p0/p1 the shared 2D (XZ)
    portal endpoints. Portals are matched geometrically so direct
    connections and junction-room chains need no builder bookkeeping.
    """
    segs = []  # (room_idx, p0 (2,), p1 (2,))
    for ri, room in enumerate(rooms):
        for e in range(room.num_walls):
            p_e0 = room.outline[e]
            d = room.edge_dirs[e]
            for p in room.portals[e]:
                a = (p_e0 + d * p["start_pos"])[[0, 2]]
                b = (p_e0 + d * p["end_pos"])[[0, 2]]
                segs.append((ri, a, b))

    conns = []
    for i in range(len(segs)):
        ri, a, b = segs[i]
        for j in range(i + 1, len(segs)):
            rj, c, d = segs[j]
            if rj == ri:
                continue
            if (
                np.linalg.norm(a - d) < _MATCH_TOL
                and np.linalg.norm(b - c) < _MATCH_TOL
            ) or (
                np.linalg.norm(a - c) < _MATCH_TOL
                and np.linalg.norm(b - d) < _MATCH_TOL
            ):
                conns.append((ri, rj, a.copy(), b.copy()))
    return conns


def _cross(o, a, b):
    """2D cross product (a - o) x (b - o)."""
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


def _penumbra_planes(src, cur):
    """Separating lines of two portal segments.

    A line through one endpoint of ``src`` and one of ``cur`` separates
    the portals when the two remaining endpoints straddle it; any
    sightline crossing both portals must then pass on the ``cur``-side
    of that line. Returns [(q, r, sign)] meaning keep
    sign * cross(q, r, x) >= 0. Degenerate (near-collinear) candidates
    are skipped — fewer constraints, conservative.
    """
    planes = []
    for i in (0, 1):
        for j in (0, 1):
            si, so = src[i], src[1 - i]
            cj, co = cur[j], cur[1 - j]
            fs = _cross(si, cj, so)
            fc = _cross(si, cj, co)
            if fs * fc < 0 and min(abs(fs), abs(fc)) > _AREA_EPS:
                planes.append((si, cj, 1.0 if fc > 0 else -1.0))
    return planes


def _clip_segment(p0, p1, planes):
    """Clip a segment to an intersection of half-planes; None if empty."""
    t0, t1 = 0.0, 1.0
    d = p1 - p0
    for q, r, s in planes:
        f0 = _cross(q, r, p0) * s
        f1 = _cross(q, r, p1) * s
        if f0 < 0 and f1 < 0:
            return None
        if f0 >= 0 and f1 >= 0:
            continue
        t = f0 / (f0 - f1)
        if f0 < 0:
            t0 = max(t0, t)
        else:
            t1 = min(t1, t)
        if t0 > t1:
            return None
    return p0 + t0 * d, p0 + t1 * d


def compute_room_pvs(rooms) -> np.ndarray:
    """(R, R) bool: pvs[a, b] = room b potentially visible from room a.

    All-visible when any room is open-air (see module docstring).
    """
    num_rooms = len(rooms)
    if any(r.no_ceiling for r in rooms):
        return np.ones((num_rooms, num_rooms), dtype=bool)

    adj = [[] for _ in range(num_rooms)]
    for ri, rj, a, b in portal_connections(rooms):
        adj[ri].append((rj, (a, b)))
        adj[rj].append((ri, (a, b)))

    vis = np.eye(num_rooms, dtype=bool)
    for source in range(num_rooms):
        steps = 0
        overflow = False

        def walk(room, portals, path):
            """``portals``: the clipped portal chain crossed so far; a
            candidate next portal must intersect the anti-penumbra of
            EVERY (earlier portal, last portal) pair — each pair's
            separating lines are necessary conditions on any common
            stabbing line, so the intersection is still conservative
            but far tighter than first-vs-last alone on long chains."""
            nonlocal steps, overflow
            cur = portals[-1]
            planes = []
            for prev in portals[:-1]:
                planes.extend(_penumbra_planes(prev, cur))
            for nxt, (a, b) in adj[room]:
                if nxt in path or overflow:
                    continue
                steps += 1
                if steps > _MAX_STEPS_PER_ROOM:
                    overflow = True
                    return
                clipped = _clip_segment(a, b, planes)
                if clipped is None:
                    continue
                vis[source, nxt] = True
                walk(nxt, portals + [clipped], path | {nxt})

        for n0, seg0 in adj[source]:
            vis[source, n0] = True
            # A single crossed portal imposes no separating lines, so
            # every portal of the neighbor is fully reachable (depth 2
            # is always fully visible: a segment from any point of the
            # entry portal to any point of a second portal crosses the
            # convex neighbor's interior).
            walk(n0, [seg0], {source, n0})
        if overflow:
            vis[source, :] = True
    return vis
