"""The tile-pruned searches of the port (`ops/pruned_knn.py`,
`ops/clustered_knn.py`) against the JAX package's, on the CPU.

The tables must equal the JAX package's (the partition entry for entry, the
listed tables bit for bit, the pruned tables to 1e-6: their tile means are
sums whose order differs). The searches are the port's plain versions, the
CPU path of the CUDA kernels, against the JAX package's Pallas kernels in
interpret mode. All are exact searches, so ids are equal; a disagreement is
allowed only where the float64 distances of the two picks are a float32
near-tie (1e-6 relative). The tie rules are pinned on constructed exact ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.ops import pruned_knn as jax_knn
from dual_space_nerf_tpu.ops.clustered_knn import build_face_clusters as jax_clusters
from dual_space_nerf_tpu_torch.data.synthetic import make_scene
from dual_space_nerf_tpu_torch.ops import pruned_knn as knn
from dual_space_nerf_tpu_torch.ops.clustered_knn import build_face_clusters
from torch_port_common import PRUNED_TIE_KINDS, plan_rows, pruned_ties

BLOCK_P = 256


class Mesh:
    """Centroids and tables of a capsule mesh of F = 2 * (n_theta * n_phi) faces."""

    def __init__(self, n_theta, n_phi):
        scene = make_scene(n_theta=n_theta, n_phi=n_phi)
        tris = scene.verts_world[scene.faces]
        self.cents = (((tris[:, 0] + tris[:, 1]) + tris[:, 2]) * np.float32(1 / 3)).astype(np.float32)
        self.tiles = knn.build_face_tiles(self.cents)
        clusters = build_face_clusters(self.cents)
        self.clusters = clusters
        self.perm = clusters[clusters >= 0].astype(np.int64)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(30, 40)  # F = 2400: 32 kd-leaf tiles of 75 faces, five 512-face tiles


@pytest.fixture(scope="module")
def small_mesh():
    return Mesh(6, 8)  # F = 96: a single tile in either search


def _points(kind, cents, n, rng):
    lo, hi = cents.min(0), cents.max(0)
    if kind == "surface":
        pts = cents[rng.integers(0, len(cents), n)] + 0.03 * rng.standard_normal((n, 3))
    elif kind == "box":
        pts = lo - 0.2 + (hi - lo + 0.4) * rng.random((n, 3))
    else:  # "far": a cloud several mesh sizes away, where cancellation would bite
        pts = hi + 5.0 + 0.5 * rng.standard_normal((n, 3))
    pts = torch.from_numpy(pts.astype(np.float32))
    return pts[knn.morton_order(pts)].numpy()  # spatially coherent blocks


def _assert_exact(ids, other, pts, cents, what):
    """ids == other, but for float32 near-ties; both are nearest in float64."""
    d2 = ((pts[:, None].astype(np.float64) - cents[None].astype(np.float64)) ** 2).sum(-1)
    rows = np.arange(len(pts))
    best = d2.min(1)
    for name, x in (("port", ids), (what, other)):
        assert np.all(d2[rows, x] - best <= 1e-6 * best), name
    assert (ids != other).sum() <= max(1, len(pts) // 200), what


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["mesh", "small_mesh"])
def test_partition_tables_equal_jax(which, request):
    m = request.getfixturevalue(which)
    np.testing.assert_array_equal(m.tiles, np.asarray(jax_knn.build_face_tiles(m.cents)))
    np.testing.assert_array_equal(m.clusters, np.asarray(jax_clusters(m.cents).table))
    assert m.tiles.dtype == np.int32 and m.tiles.shape[1] == 128
    assert sorted(m.tiles[m.tiles >= 0]) == list(range(len(m.cents)))


@pytest.mark.parametrize("which", ["mesh", "small_mesh"])
def test_listed_tables_equal_jax_bit_for_bit(which, request):
    m = request.getfixturevalue(which)
    got = knn.listed_tables(torch.from_numpy(m.cents), torch.from_numpy(m.tiles))
    want = jax_knn.listed_tables_np(m.cents, m.tiles)
    for name, a, b in zip(("cent_t", "tile_c", "tile_r", "perm_pad"), got, want):
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    np.testing.assert_array_equal(
        knn.slot_perm_from_tiles(torch.from_numpy(m.tiles)).numpy(),
        np.asarray(jax_knn.slot_perm_from_tiles(jnp.asarray(m.tiles))),
    )


def test_pruned_tables_match_jax(mesh):
    got = knn.pruned_tables(torch.from_numpy(mesh.cents), torch.from_numpy(mesh.perm))
    want = jax_knn.pruned_tables(jnp.asarray(mesh.cents), jnp.asarray(mesh.perm))
    assert got[3] == want[3] == 5
    for name, a, b in zip(("cent_t", "tile_c", "tile_r"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6, err_msg=name)


def test_morton_order_matches_jax(mesh, rng_np):
    pts = rng_np.standard_normal((500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        knn.morton_order(torch.from_numpy(pts)).numpy(), np.asarray(jax_knn.morton_order(jnp.asarray(pts)))
    )


# --------------------------------------------------------------------------
# the searches against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["wide", "slim", "tighten"])
@pytest.mark.parametrize("kind,n", [("surface", 600), ("box", 300), ("far", 300),
                                    ("surface", 1), ("surface", 127)])
def test_listed_search_matches_pallas_interpret(mesh, rng_np, kind, n, variant):
    pts = _points(kind, mesh.cents, n, rng_np)
    opts = {"slim": variant == "slim", "tighten": variant == "tighten"}
    for return_slots in (False, True):
        ids = knn.pruned_search_listed(
            torch.from_numpy(pts), torch.from_numpy(mesh.cents), torch.from_numpy(mesh.tiles),
            block_p=BLOCK_P, plan_p=128, return_slots=return_slots, **opts).numpy()
        ref = np.asarray(jax_knn.pruned_search_listed(
            jnp.asarray(pts), jnp.asarray(mesh.cents), jnp.asarray(mesh.tiles), interpret=True,
            block_p=BLOCK_P, plan_p=128, return_slots=return_slots, **opts))
        assert ids.dtype == np.int32 and ids.shape == (n,)
        if return_slots:  # slot ids of both sides name faces through the same map
            perm = knn.slot_perm_from_tiles(torch.from_numpy(mesh.tiles)).numpy()
            assert np.all(mesh.tiles.reshape(-1)[ids] >= 0)  # never a padded slot
            ids, ref = perm[ids], perm[ref]
        _assert_exact(ids, ref, pts, mesh.cents, "pallas")


@pytest.mark.parametrize("kind,n", [("surface", 600), ("box", 300), ("far", 300),
                                    ("surface", 1), ("surface", 127)])
def test_pruned_search_matches_pallas_interpret(mesh, rng_np, kind, n):
    pts = _points(kind, mesh.cents, n, rng_np)
    ids = knn.pruned_search_presorted(
        torch.from_numpy(pts), torch.from_numpy(mesh.cents), torch.from_numpy(mesh.perm),
        block_p=128).numpy()
    ref = np.asarray(jax_knn.pruned_search_presorted(
        jnp.asarray(pts), jnp.asarray(mesh.cents), jnp.asarray(mesh.perm), interpret=True,
        block_p=128))
    assert ids.dtype == np.int32 and ids.shape == (n,)
    _assert_exact(ids, ref, pts, mesh.cents, "pallas")


@pytest.mark.parametrize("search", ["listed", "slim", "tighten", "pruned", "pruned_morton"])
def test_single_tile_mesh(small_mesh, rng_np, search):
    m = small_mesh
    assert m.tiles.shape[0] == 1
    pts = _points("surface", m.cents, 300, rng_np)
    tp, tc = torch.from_numpy(pts), torch.from_numpy(m.cents)
    if search == "pruned":
        ids = knn.pruned_search_presorted(tp, tc, torch.from_numpy(m.perm), block_p=128)
    elif search == "pruned_morton":
        ids = knn.nearest_face_pruned(tp.flip(0), tc, torch.from_numpy(m.perm)).flip(0)
    else:
        ids = knn.pruned_search_listed(tp, tc, torch.from_numpy(m.tiles), block_p=BLOCK_P,
                                       slim=search == "slim", tighten=search == "tighten")
    d2 = ((pts[:, None].astype(np.float64) - m.cents[None].astype(np.float64)) ** 2).sum(-1)
    _assert_exact(ids.numpy(), d2.argmin(1), pts, m.cents, "float64 argmin")


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("plan_p", [128, 256])
def test_plan_never_drops_the_nearest_tile(mesh, rng_np, plan_p):
    """Every point's true nearest centroid (float64) lies in a listed tile of
    its row: near the surface, across the box, and on a far cloud, where an
    expanded-form distance would cancel."""
    tables = knn.listed_tables(torch.from_numpy(mesh.cents), torch.from_numpy(mesh.tiles))
    tile_of_face = np.empty(len(mesh.cents), np.int64)
    t_idx, _ = np.nonzero(mesh.tiles >= 0)
    tile_of_face[mesh.tiles[mesh.tiles >= 0]] = t_idx
    for kind in ("surface", "box", "far"):
        pts = _points(kind, mesh.cents, 2 * plan_p, rng_np)
        order, counts, lbs = knn.listed_plan(torch.from_numpy(pts), tables[1], tables[2],
                                             mesh.tiles.shape[0], plan_p)
        d2 = ((pts[:, None].astype(np.float64) - mesh.cents[None].astype(np.float64)) ** 2).sum(-1)
        assert counts.min() >= 1
        assert bool((lbs[:, 1:] >= lbs[:, :-1]).all())  # sorted lower bounds
        for row in range(2):
            listed = set(order[row, : int(counts[row])].tolist())
            need = set(tile_of_face[d2[row * plan_p:(row + 1) * plan_p].argmin(1)].tolist())
            assert need <= listed, (kind, row)
        if kind == "far":  # a far cloud sees the mesh as one lump: most tiles listed
            assert counts.float().mean() > 4


def _rank_rule(keys):
    """The plan kernel's order in closed form (`csrc/listed_plan.cu`), for
    one row's keys (inf where a tile is not listed): a listed tile's rank is
    the number of listed tiles with a smaller key, or an equal key and a
    smaller id; an unlisted tile's is the number of listed tiles plus the
    number of unlisted tiles with a smaller id."""
    listed = np.isfinite(keys)
    n_listed = int(listed.sum())
    below = np.cumsum(listed) - listed  # listed tiles with a smaller id
    listed_keys = keys[listed]          # in id order
    j = np.arange(n_listed)
    order = np.full(len(keys), -1, np.int64)
    lbs = np.full(len(keys), np.nan, np.float32)
    for t, k in enumerate(keys):
        if listed[t]:
            rank = int(((listed_keys < k) | ((listed_keys == k) & (j < below[t]))).sum())
        else:
            rank = n_listed + t - int(below[t])
        order[rank], lbs[rank] = t, k
    return order, n_listed, lbs


@pytest.mark.parametrize("n_tiles", [1, 100, 128])
@pytest.mark.parametrize("kind", ["ties", "all", "one"])
def test_plan_rank_rule_is_the_stable_sort(kind, n_tiles):
    """The closed-form rank of the plan kernel gives `listed_plan_plain`'s
    stable sort: order, counts and lbs, on rows with key ties, on rows with
    every tile listed and on rows with one."""
    tile_c, tile_r, pts = (torch.from_numpy(a) for a in plan_rows(kind, n_tiles, 128, 4))
    order, counts, lbs = (a.numpy() for a in knn.listed_plan(pts, tile_c, tile_r, n_tiles, 128))
    ties = 0
    for row in range(order.shape[0]):
        keys = np.empty(n_tiles, np.float32)
        keys[order[row]] = lbs[row]  # the row's keys in tile order
        got_order, got_count, got_lbs = _rank_rule(keys)
        np.testing.assert_array_equal(got_order, order[row])
        np.testing.assert_array_equal(got_lbs, lbs[row])
        assert got_count == counts[row]
        finite = keys[np.isfinite(keys)]
        ties += len(finite) - len(np.unique(finite))
    if kind == "all":
        assert (counts == n_tiles).all()
    elif kind == "one":
        assert (counts == 1).all()
    elif n_tiles > 1:
        assert ties > 0  # the planted copies tie


# --------------------------------------------------------------------------
# tie rules
# --------------------------------------------------------------------------
def _tie_tables(n=128):
    """Two tiles of n slots on the planes x = 1 and x = -1, mirror images of
    each other: every point on x = 0 is at exactly the same float32 distance
    from slot (0, lane) and slot (1, lane)."""
    left = np.random.default_rng(7).random((n, 3)).astype(np.float32)
    left[:, 0] = 1.0
    right = left * np.float32([-1.0, 1.0, 1.0])
    return left, right


@pytest.mark.parametrize("first", [0, 1])
def test_listed_tie_rules(first):
    """wide: the lane stays with the tile visited FIRST; slim: the smallest
    slot id, whatever the visit order."""
    left, right = _tie_tables()
    cent_t = torch.from_numpy(np.concatenate([left, right]).T.copy())
    pts = torch.zeros((128, 3))
    pts[:, 1:] = torch.from_numpy(left[:, 1:])  # point i is nearest to lane i of both tiles
    order = torch.tensor([[first, 1 - first]], dtype=torch.int32)
    counts = torch.tensor([2], dtype=torch.int32)
    lbs = torch.zeros((1, 2))
    lane = np.arange(128)
    for tighten in (False, True):
        wide = knn.listed_search_plain(pts, cent_t, order, counts, lbs, 128, tighten=tighten)
        np.testing.assert_array_equal(wide.numpy(), first * 128 + lane)
    slim = knn.listed_search_plain(pts, cent_t, order, counts, lbs, 128, slim=True)
    np.testing.assert_array_equal(slim.numpy(), lane)


def test_listed_wide_tie_across_lanes_takes_the_smallest_slot():
    """Two different lanes at the minimum: the smaller slot id wins, also
    when the tile holding it is visited second."""
    cents = np.full((256, 3), 50.0, np.float32)
    cents[5] = [1.0, 0.0, 0.0]         # tile 0, lane 5
    cents[128 + 9] = [-1.0, 0.0, 0.0]  # tile 1, lane 9
    cent_t = torch.from_numpy(cents.T.copy())
    pts = torch.zeros((128, 3))
    counts = torch.tensor([2], dtype=torch.int32)
    for first in (0, 1):
        order = torch.tensor([[first, 1 - first]], dtype=torch.int32)
        for slim in (False, True):
            ids = knn.listed_search_plain(pts, cent_t, order, counts, torch.zeros((1, 2)), 128, slim=slim)
            assert ids.unique().tolist() == [5]


def test_pruned_tie_rule_seed_tile_first():
    """The seed tile (smallest lower bound) is visited first and keeps its
    lanes on an exact tie, even when it is not tile 0."""
    left, right = _tie_tables(512)
    for seed_tile in (0, 1):
        tiles = [left, right] if seed_tile == 0 else [right, left]
        cents = torch.from_numpy(np.concatenate(tiles))
        cent_t, tile_c, tile_r, n_tiles = knn.pruned_tables(cents, torch.arange(1024))
        pts = torch.zeros((128, 3))
        pts[:, 1:] = torch.from_numpy(left[:128, 1:])
        # both tiles are equally far: nudge the block towards the seed tile
        # by one point that is not on the mirror plane
        pts[127] = torch.from_numpy(tiles[seed_tile][127])
        ids, visits = knn.pruned_search_plain(pts, cent_t, tile_c, tile_r, n_tiles, 128,
                                              with_visits=True)
        assert int(visits[0]) == 2
        np.testing.assert_array_equal(ids[:127].numpy(), seed_tile * 512 + np.arange(127))


def _pruned_closed_form(pts, cent_t, tile_c, tile_r, n_tiles, block_p, tighten=1, chunk=16):
    """The pruned kernel's tie rule in closed form (`csrc/pruned_knn.cu`),
    streamed as the kernel streams it: per block the plain version's
    sphere, bounds, seed and visits; per visited tile and chunk of ``chunk``
    lanes, each point's chunk minimum m against its running best. m < best
    records the chunk; m == best, in a tile before the seed while the seed
    holds the id, gives the id to the chunk's first lane at m that the seed
    does not hold (d2(t0, l) != best). At the end the id is the first slot
    at best from the recorded one to the end of its chunk. Returns (ids,
    visits per block)."""
    bf = knn._BLOCK_F
    cents = cent_t.T.reshape(n_tiles, bf, 3)
    tc, tr = tile_c[0:3, :n_tiles].T, tile_r[0, :n_tiles]
    ids, visits = [], []
    for p in pts.reshape(-1, block_p, 3):
        ctr = 0.5 * (p.amin(0) + p.amax(0))
        rho = torch.sqrt(knn._d2(p, ctr).amax())
        lb = (torch.sqrt(knn._d2(tc, ctr)) - tr) - rho
        t0 = int(knn._first_argmin(lb))
        best = torch.full((block_p,), float("inf"))
        slot = torch.full((block_p,), t0 * bf, dtype=torch.int64)
        seed_d2 = knn._d2(p[:, None], cents[t0][None])                  # (P, 512)
        thresh, seen = float("inf"), 0
        for t in [t0] + [t for t in range(n_tiles) if t != t0]:
            if t != t0 and not bool(lb[t] < thresh):
                continue
            seen += 1
            d2 = knn._d2(p[:, None], cents[t][None])                    # (P, 512)
            for c in range(0, bf, chunk):
                dc = d2[:, c:c + chunk]
                m = dc.amin(1)
                if t < t0:  # the seed holds the id: a free lane at a tie takes it
                    free = (dc == m[:, None]) & (seed_d2[:, c:c + chunk] != m[:, None])
                    first_free = t * bf + c + free.int().argmax(1)
                    take = (m == best) & (slot >= t0 * bf) & free.any(1)
                    slot = torch.where(take, first_free, slot)
                better = m < best
                slot = torch.where(better, t * bf + c, slot)
                best = torch.minimum(best, m)
            if t == t0 or (tighten > 0 and (t + 1) % tighten == 0):
                thresh = float(torch.sqrt(best.amax()))
        # the first slot at best from the recorded one to the end of its chunk
        lanes = slot[:, None] + torch.arange(chunk)
        d2 = knn._d2(p[:, None], cent_t.T[lanes.clamp(max=n_tiles * bf - 1)])
        hit = (d2 == best[:, None]) & (lanes < (slot // chunk + 1)[:, None] * chunk)
        ids.append(torch.where(hit.any(1), lanes.gather(1, hit.int().argmax(1, keepdim=True))[:, 0], slot))
        visits.append(seen)
    return torch.cat(ids).to(torch.int32), torch.tensor(visits, dtype=torch.int32)


@pytest.mark.parametrize("chunk", [1, 16])
@pytest.mark.parametrize("kind", PRUNED_TIE_KINDS)
def test_pruned_closed_form_tie_rule_on_planted_ties(kind, chunk):
    """The kernel's streamed tie rule equals `pruned_search_plain`'s per-lane
    running minimum on planted exact ties: the seed tile (tile 2) holding a
    lane that tile 0 ties, ties across lanes of two non-seed tiles, the seed
    at one lane and a smaller slot at another, and a tie that a later strict
    improvement cancels; per lane (chunk 1) and per chunk of 16 lanes, as the
    kernel takes them (`csrc/pruned_knn.cu`: kChunk)."""
    pts, cents, want = (torch.from_numpy(a) for a in pruned_ties(kind))
    tabs = knn.pruned_tables(cents, torch.arange(cents.shape[0]))
    plain, visits = knn.pruned_search_plain(pts, *tabs, 128, with_visits=True)
    got, got_visits = _pruned_closed_form(pts, *tabs, 128, chunk=chunk)
    assert visits.tolist() == got_visits.tolist() == [4]  # the seed, then every other tile
    np.testing.assert_array_equal(plain.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("tighten", [0, 1, 2])
@pytest.mark.parametrize("order", ["identity", "kd"])
def test_pruned_closed_form_tie_rule_on_quantised_clouds(order, tighten):
    """The same on seeded points and centroids on a 1/4 grid (every
    centroid position ~4 times over 4 tiles), where exact ties are common:
    ids equal `pruned_search_plain`'s, in random tiles (every tile visited)
    and in kd tiles (some skipped)."""
    rng = np.random.default_rng(11 + tighten)
    cents = (rng.integers(0, 8, (4 * 512, 3)) * 0.25).astype(np.float32)
    pts = (rng.integers(0, 29, (512, 3)) * 0.0625 - 0.0625).astype(np.float32)
    pts = torch.from_numpy(pts)[knn.morton_order(torch.from_numpy(pts))]
    if order == "kd":
        clusters = build_face_clusters(cents)
        perm = torch.from_numpy(clusters[clusters >= 0].astype(np.int64))
    else:
        perm = torch.arange(cents.shape[0])
    tabs = knn.pruned_tables(torch.from_numpy(cents), perm)
    plain, visits = knn.pruned_search_plain(pts, *tabs, 128, tighten=tighten, with_visits=True)
    got, got_visits = _pruned_closed_form(pts, *tabs, 128, tighten=tighten)
    np.testing.assert_array_equal(got_visits.numpy(), visits.numpy())
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    # exact ties across visited slots are common here
    d2 = knn._d2(pts[:, None], torch.from_numpy(cents)[perm][None])
    assert int(((d2 == d2.amin(1, keepdim=True)).sum(1) > 1).sum()) > 100
    if order == "identity":
        assert bool((visits == 4).all())


def test_search_knobs_are_read_at_call_time(mesh, rng_np, monkeypatch):
    pts = torch.from_numpy(_points("surface", mesh.cents, 300, rng_np))
    args = (pts, torch.from_numpy(mesh.cents), torch.from_numpy(mesh.tiles))
    base = knn.pruned_search_listed(*args)
    monkeypatch.setenv("DSNERF_KNN_SLIM", "1")
    monkeypatch.setenv("DSNERF_KNN_PLAN_P", "256")
    assert torch.equal(knn.pruned_search_listed(*args), base)  # exact either way
    monkeypatch.setenv("DSNERF_KNN_PLAN_P", "100")
    with pytest.raises(ValueError, match="divisor"):
        knn.pruned_search_listed(*args)
    monkeypatch.setenv("DSNERF_KNN_PLAN_P", "64")  # divides 2048, but not a whole thread block
    with pytest.raises(ValueError, match="multiple of 128"):
        knn.pruned_search_listed(*args)
    monkeypatch.delenv("DSNERF_KNN_PLAN_P")
    monkeypatch.setenv("DSNERF_KNN_TIGHTEN", "yes")
    with pytest.raises(ValueError, match="'0' or '1'"):
        knn.pruned_search_listed(*args)
