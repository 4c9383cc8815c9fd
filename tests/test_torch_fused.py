"""The plain pieces behind the fused tri_pass launch and the warp-per-env
placement kernel, on the CPU.

tri_pass with mesh rows: the kernel stages a mesh row as a triangle row
(kind 1.0) and culls it with the static rows' rule, then seeds the
static competition with the mesh winner in registers. Checked here: the
triangle-row keys equal the mesh pass's (coverage u + v, bit for bit,
also at the coverage edge), the cull keeps every (mesh row, tile) with a
hit, and the fused composition (with a torch copy of the kernel's
per-pixel select) equals the mesh pass seeding ``tri_pass_plain``,
quantized-depth ties included.

place: the kernel sums each env's room weights once and draws a room by
binary search. ``_room_search`` (a plain copy of it) equals
``sample_room`` and the JAX package's ``sample_room`` on edge cases, and
the sequential CDF equals ``torch.cumsum`` on the ported banks' rooms.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from miniworld_tpu.ops import place as jplace
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.ops import place as tplace
from miniworld_tpu_torch.render import raycast as trc
from test_torch_cull import B, H, TILE, W, _check_cull
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

PICK_ID = "MiniWorld-PickupObjects-v0"


@pytest.fixture(scope="module")
def pickup():
    """PickupObjects states facing their entities (chip_smoke's views),
    their cameras and mesh rows."""
    env = MiniWorldVec(PICK_ID, B, obs_width=W, obs_height=H, device="cpu")
    state = chip_smoke.facing_states(env, torch.Generator().manual_seed(7), (0.5, 0.5),
                                     (11.5, 11.5))
    cam = trc.camera_grid(state, W, H)
    rows9, row_attrs, valid = trc.entity_mesh_rows(env._bank, state)
    return env, state, cam, (rows9, row_attrs), valid


def _edge_rows(cam, n_rows=256, seed=3):
    """Staged triangle rows at the coverage edge: at one random pixel per
    row u + v lands on det to the ulp (v constant, set to det - u there,
    then moved by -1, 0 or +1 ulp), r inside the NEAR/FAR gates."""
    rng = np.random.default_rng(seed)
    xv, yv = cam.xv(), cam.yv()
    n = xv.shape[0]
    rows = torch.zeros((n, n_rows, trc.ROW_FIELDS))
    coef = torch.from_numpy(rng.uniform(-1, 1, (n, n_rows, 6)).astype(np.float32))
    coef[..., 0] = coef[..., 0].abs() + 0.5  # det > 0 around the pixel
    rows[..., 0:6] = coef
    p = torch.from_numpy(rng.integers(0, xv.shape[1], (n, n_rows)))
    x, y = torch.gather(xv, 1, p), torch.gather(yv, 1, p)
    det = (rows[..., 0] + rows[..., 1] * x) + rows[..., 2] * y
    u = (rows[..., 3] + rows[..., 4] * x) + rows[..., 5] * y
    u = torch.clamp(u, min=0.0)
    rows[..., 3] = torch.where(u <= det, u, det * 0.5) - rows[..., 4] * x - rows[..., 5] * y
    u = (rows[..., 3] + rows[..., 4] * x) + rows[..., 5] * y
    v = det - u
    step = torch.from_numpy(rng.integers(-1, 2, (n, n_rows)))
    v = torch.where(step > 0, torch.nextafter(v, torch.full_like(v, np.inf)),
                    torch.where(step < 0, torch.nextafter(v, torch.full_like(v, -np.inf)), v))
    rows[..., 6] = v  # v = a_v at every pixel
    t = torch.from_numpy(rng.uniform(1.0, 10.0, (n, n_rows)).astype(np.float32))
    rows[..., trc._R_INV] = 1.0 / (det * t)
    rows[..., trc._R_KIND] = 1.0
    return rows, p


def test_triangle_row_keys_equal_mesh_pass_keys(pickup):
    """(a) Mesh rows staged as triangle rows give the mesh pass's keys:
    coverage max(u, v) + 1 * min(u, v) is u + v bit for bit."""
    _, _, cam, (rows9, row_attrs), valid = pickup
    xv, yv = cam.xv(), cam.yv()
    want = trc._row_keys(trc._stage(rows9, row_attrs[:, :, 15], cam), xv, yv, False,
                         all_tris=True)
    got = trc._row_keys(trc.stage_mesh_rows(rows9, cam), xv, yv, all_quads=False)
    assert torch.equal(got, want)
    assert (want > 0).any(), "the meshes are not in view"
    key_max, _ = trc._chunk_compete(rows9, row_attrs, cam, xv, yv, False, all_tris=True)
    assert torch.equal(got.amax(1), key_max)

    rows, p = _edge_rows(cam)
    got = trc._row_keys(rows, xv, yv, all_quads=False)
    want = trc._row_keys(rows, xv, yv, False, all_tris=True)
    assert torch.equal(got, want)
    at_edge = torch.gather(got, 2, p[:, :, None])[..., 0] > 0  # (B, N) at the row's pixel
    assert 0.1 < float(at_edge.float().mean()) < 0.9, "the edge pixels all hit or all miss"


def test_cull_keeps_every_mesh_hit(pickup):
    """(b) On PickupObjects' mesh rows, facing the entities."""
    _, _, cam, (rows9, _), valid = pickup
    hits, _ = _check_cull(trc.stage_mesh_rows(rows9, cam), cam, False, TILE)
    assert hits.any(2)[valid].float().mean() > 0.05, "few live mesh rows in view"


@pytest.mark.parametrize("tile", [TILE, (8, 6)])
def test_cull_keeps_every_grazing_mesh_hit(tile):
    """(b) Triangle rows through tile-corner pixel centres, det near
    1e-12, r at the NEAR and FAR gates (chip_smoke.grazing_case, each
    env's rows its own, as mesh rows are)."""
    verts9, _, _, cam = chip_smoke.grazing_case(B, tile, n_rows=256)
    hits, _ = _check_cull(trc.stage_mesh_rows(verts9, cam), cam, False, tile)
    style = torch.arange(verts9.shape[2]) % 4  # corner, corner, tiny, near/far
    for k in range(4):
        assert hits.any(2)[:, style == k].float().mean() > 0.1, k


def _fused_like_kernel(verts9, attr, layout_id, cam, all_quads, mesh):
    """The tri_pass kernel's two competitions per pixel, in torch: the
    mesh key over triangle rows, turned into the seed key through t,
    the static key over the layout's rows, the seed kept unless a static
    row's key is strictly greater; kept pixels take the mesh winner's
    attribute row by index (zeros where the mesh missed)."""
    rows9, row_attrs = mesh
    xv, yv = cam.xv(), cam.yv()
    mkey = trc._row_keys(trc.stage_mesh_rows(rows9, cam), xv, yv, all_quads=False).amax(1)
    seed_key = trc._seed_key(trc._t_from_key(mkey))
    skey = trc._row_keys(trc.stage_rows(verts9, attr, layout_id, cam), xv, yv,
                         all_quads).amax(1)
    keep_seed = ~(skey > seed_key)
    m_attr = trc._gather_rows(row_attrs, (mkey & trc._IDX_MASK).long()).to(torch.bfloat16)
    m_attr = torch.where((mkey > 0)[:, :, None], m_attr, torch.zeros_like(m_attr))
    s_attr = trc._gather_rows(attr[layout_id.long()],
                              (skey & trc._IDX_MASK).long()).to(torch.bfloat16)
    key = torch.where(keep_seed, seed_key, skey)
    return (trc._t_from_key(key), torch.where(keep_seed[:, :, None], m_attr, s_attr),
            mkey, seed_key, skey)


def test_fused_equals_seeded_composition(pickup):
    """(c) The kernel's per-pixel select equals the mesh pass seeding
    tri_pass_plain, and so does the wrapper with mesh rows on the CPU,
    with some mesh rows copied from static triangles so that the two
    competitions tie in quantized depth: there the seed (the mesh row)
    wins."""
    env, state, cam, (rows9, row_attrs), valid = pickup
    bank = env._bank
    lid = state.layout_id.long()
    v9s = bank.tri_verts9[lid]  # (B, 9, S): a copy as a mesh row ties on its triangle half
    rows9, row_attrs = rows9.clone(), row_attrs.clone()
    n_tie = 0
    for b in range(B):
        free = (~valid[b]).nonzero()[:, 0]
        k = min(len(free), v9s.shape[2])
        rows9[b, :, free[:k]] = v9s[b, :, :k]
        row_attrs[b, free[:k]] = torch.rand((k, 16), generator=torch.Generator().manual_seed(b))
        n_tie += k
    assert n_tie > 0
    mesh = (rows9, row_attrs)
    args = (bank.tri_verts9, bank.tri_attr, state.layout_id, cam, env._all_quads)
    composed = trc.tri_pass_plain(*args, seed=trc.entity_mesh_pass_plain(*mesh, cam))
    t_k, a_k, mkey, seed_key, skey = _fused_like_kernel(*args, mesh)
    for got in (trc.tri_pass(*args, mesh=mesh), (t_k, a_k)):
        assert torch.equal(got[0], composed[0]) and torch.equal(got[1], composed[1])
    # ties: the seed's and the static winner's depth bits equal, both
    # hits; the output carries the mesh row
    tie = (seed_key > 0) & (skey > 0) & ((seed_key & ~trc._IDX_MASK)
                                         == (skey & ~trc._IDX_MASK))
    assert int(tie.sum()) > 100, "no quantized-depth ties between mesh and static rows"
    m_attr = trc._gather_rows(row_attrs, (mkey & trc._IDX_MASK).long()).to(torch.bfloat16)
    assert torch.equal(a_k[tie], m_attr[tie])


def _room_cdf(room_mask, room_area, room_weight):
    """(B, R) running sums of the room draw weights (``sample_room``'s
    probs) in room order, one float32 addition at a time, as the place
    kernel sums them once per env."""
    probs = torch.where(room_mask, room_area, torch.zeros_like(room_area))
    if room_weight is not None:
        probs = probs * room_weight
    sums, c = [], torch.zeros_like(probs[:, 0])
    for r in range(probs.shape[1]):
        c = c + probs[:, r]
        sums.append(c)
    return torch.stack(sums, dim=1)


def _room_search(u, room_mask, room_area, room_weight):
    """Plain copy of the place kernel's room draw (place.cu
    ``room_search``): over ``_room_cdf``, the binary search for the first
    room r with u * total < cdf[r], 0 where there is none."""
    cdf = _room_cdf(room_mask, room_area, room_weight)
    n, R = cdf.shape
    thr = u * cdf[:, -1]
    lo = torch.zeros(n, dtype=torch.long)
    hi = torch.full_like(lo, R)
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) >> 1
        below = thr < torch.gather(cdf, 1, torch.clamp(mid, max=R - 1)[:, None])[:, 0]
        hi = torch.where(active & below, mid, hi)
        lo = torch.where(active & ~below, mid + 1, lo)
    return torch.where(lo < R, lo, torch.zeros_like(lo))


def _jax_sample_room(u, mask, area, weight):
    def one(u1, m1, a1, w1):
        return jplace.sample_room(u1, SimpleNamespace(room_mask=m1, room_area=a1), w1)

    out = jax.vmap(one)(jnp.asarray(u.numpy()), jnp.asarray(mask.numpy()),
                        jnp.asarray(area.numpy()), jnp.asarray(weight.numpy()))
    return torch.from_numpy(np.asarray(out).astype(np.int64))


def _room_case(case, rng):
    """(u (n,), mask (n, R), area (n, R), weight (n, R)) of one edge
    case. Areas and weights lie on a 1/8 grid, as the banks' room areas
    do, so every order of summation gives the same CDF (cumsum in the
    JAX package, torch and the kernel round alike); the search is what
    is compared."""
    n = 512
    R = {"r1": 1, "r176": 176}.get(case, 12)
    area = torch.from_numpy(rng.integers(1, 64, (n, R)) / 8.0).float()
    mask = torch.from_numpy(rng.uniform(size=(n, R)) < 0.9)
    weight = torch.ones((n, R))
    u = torch.from_numpy(rng.integers(0, 1 << 24, n) / float(1 << 24)).float()
    if case == "plateaus":  # runs of closed junctions: weight 0
        weight = torch.from_numpy(rng.uniform(size=(n, R)) < 0.4).float()
        weight[:, :3] = 0.0
    elif case == "u0":
        u = torch.zeros(n)
    elif case == "u_max":
        u = torch.full((n,), np.nextafter(np.float32(1.0), np.float32(0.0)))
        weight[:, -2:] = 0.0  # the last rooms with weight are not the last rooms
    elif case == "all_zero":
        weight = torch.zeros((n, R))
    elif case == "at_entry":  # u * total equal to a CDF entry
        weight[:, 1::3] = 0.0
        cdf = _room_cdf(mask, area, weight)
        k = torch.from_numpy(rng.integers(0, R, n))
        total = cdf[:, -1]
        u = torch.gather(cdf, 1, k[:, None])[:, 0] / total
        on_entry = u * total == torch.gather(cdf, 1, k[:, None])[:, 0]
        assert float(on_entry.float().mean()) > 0.5
    return u, mask, area, weight


@pytest.mark.parametrize("case", ["random", "plateaus", "u0", "u_max", "at_entry",
                                  "all_zero", "r1", "r176"])
def test_room_search_equals_sample_room(case):
    """(d) The kernel's binary search over its CDF equals sample_room."""
    rng = np.random.default_rng(["random", "plateaus", "u0", "u_max", "at_entry",
                                 "all_zero", "r1", "r176"].index(case))
    u, mask, area, weight = _room_case(case, rng)
    got = _room_search(u, mask, area, weight)
    want = tplace.sample_room(u, mask, area, weight)
    assert torch.equal(got, want)
    assert torch.equal(got, _jax_sample_room(u, mask, area, weight))
    if case == "all_zero":
        assert not got.any()
    if case == "r176":
        assert len(set(got.tolist())) > 50


@pytest.mark.parametrize("env_id", [PICK_ID, "MiniWorld-FourRooms-v0", "MiniWorld-Maze-v0"])
def test_room_cdf_on_banks(env_id):
    """The kernel's sequential CDF equals torch.cumsum on the rooms a
    reset samples from (the Maze with each env's room weights), and its
    search equals sample_room there."""
    env = MiniWorldVec(env_id, B, obs_width=16, obs_height=12, device="cpu")
    args, kwargs = chip_smoke.capture_place_args(env, 5)
    bank, layout_id = args[1], args[2].long()
    mask, area = bank.room_mask[layout_id], bank.room_area[layout_id]
    weight = kwargs["room_weight"]
    probs = torch.where(mask, area, torch.zeros_like(area))
    if weight is not None:
        probs = probs * weight
    assert torch.equal(_room_cdf(mask, area, weight), torch.cumsum(probs, 1))
    u = torch.rand((64, B), generator=torch.Generator().manual_seed(2))
    for row in u:
        assert torch.equal(_room_search(row, mask, area, weight),
                           tplace.sample_room(row, mask, area, weight))


def test_first_passing_try_sets_the_pose():
    """``_place_all_plain``'s first passing try per slot (the tries that
    chip_smoke's place bound counts) is the try the pose comes from:
    with any budget k, an env whose every slot passed before try k gets
    the positions of the full budget (the directions draw from row
    budget + 1), and the first slot (nothing placed before it) first
    passes at the same try, or exhausts budget k."""
    env = MiniWorldVec("MiniWorld-Maze-v0", 32, obs_width=16, obs_height=12, device="cpu")
    args, kwargs = chip_smoke.capture_place_args(env, 5)
    budget = kwargs["budget"]
    *want, first = tplace._place_all_plain(*args, **kwargs)
    assert bool((first < budget).all(1).any()) and len(set(first[:, 0].tolist())) > 2
    for k in range(budget + 1):
        *got, first_k = tplace._place_all_plain(*args, **{**kwargs, "budget": k})
        sure = (first < k).all(1)
        for a, b in ((got[0], want[0]), (got[2], want[2])):  # positions
            assert torch.equal(a[sure], b[sure]), k
        assert torch.equal(first_k[sure], first[sure])
        assert torch.equal(first_k[:, 0], torch.clamp(first[:, 0], max=k))
