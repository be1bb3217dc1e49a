"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where `torch.cuda.is_available()` is false.
This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from dual_space_nerf_tpu_torch.data.synthetic import make_scene
from dual_space_nerf_tpu_torch.ops import (
    GG_KERNEL,
    PRUNED_KERNEL,
    build_face_clusters,
    build_face_tiles,
    face_centroids,
    gg_near_far_cuda,
    gg_near_far_plain,
    listed_tables,
    nearest_face_cuda,
    nearest_face_plain,
    pruned_knn,
)
from torch_port_common import PRUNED_TIE_KINDS, plan_rows, pruned_ties

RAY_TILE, VERT_TILE = 32, 1024  # csrc/gg_near_far.cu: rays a block (one a lane), vertices staged a pass
PRUNED_PTS = 4  # csrc/pruned_knn.cu: points a thread where block_p is a multiple of 32 * 4, else 1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def scene():
    return make_scene()  # V = 6890, F = 13,776


def _rays(scene, r, dev):
    rng = np.random.default_rng(1)
    eye = (-scene.R.T @ scene.T).ravel()
    tgt = scene.verts_world[rng.integers(0, len(scene.verts_world), r)]
    tgt = tgt + 0.05 * rng.standard_normal((r, 3))
    tgt[: r // 4] += 50.0  # misses keep their near/far
    d = (tgt - eye).astype(np.float32)
    o = np.broadcast_to(eye, (r, 3)).astype(np.float32)
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (
        o, d, np.full(r, 0.5, np.float32), np.full(r, 4.0, np.float32), scene.verts_world)]


@pytest.mark.parametrize("r", [1, 5500, 8191, 8192, 8193])
def test_gg_kernel_equals_plain(dev, scene, r):
    args = _rays(scene, r, dev)
    n_k, f_k = gg_near_far_cuda(*args)
    n_p, f_p = gg_near_far_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(n_k, n_p) and torch.equal(f_k, f_p)  # the same roundings


@pytest.mark.parametrize("r", [RAY_TILE - 1, RAY_TILE, RAY_TILE + 1, 2 * RAY_TILE + 1])
def test_gg_kernel_ray_tiles(dev, scene, r):
    """Ray counts around the block's tile of rays."""
    assert GG_KERNEL.extra_function("gg_near_far_ray_tile", [])() == RAY_TILE
    args = _rays(scene, r, dev)
    n_k, f_k = gg_near_far_cuda(*args)
    n_p, f_p = gg_near_far_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(n_k, n_p) and torch.equal(f_k, f_p)


def _pixel_rays(scene, h, w, dev, fov=0.6):
    """Scanline-ordered rays of an h x w pinhole grid aimed at the mesh's
    centre: adjacent rays are adjacent pixels, as in a render chunk, so the
    cull drops most vertices of a ray tile."""
    eye = (-scene.R.T @ scene.T).ravel()
    fwd = scene.verts_world.mean(0) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    v, u = np.meshgrid(np.linspace(-fov, fov, h), np.linspace(-fov, fov, w), indexing="ij")
    d = (fwd + u.reshape(-1, 1) * right + v.reshape(-1, 1) * up).astype(np.float32)
    r = d.shape[0]
    o = np.broadcast_to(eye, (r, 3)).astype(np.float32)
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (
        o, d, np.full(r, 0.5, np.float32), np.full(r, 4.0, np.float32), scene.verts_world)]


@pytest.mark.parametrize("gamma", [0.02, 0.05, 0.2])
def test_gg_kernel_cull_on_pixel_rays(dev, scene, gamma):
    """On coherent pixel rays, where the cull drops most vertices of a ray
    tile, the same bits as the plain version."""
    args = _pixel_rays(scene, 96, 128, dev)
    n_k, f_k = gg_near_far_cuda(*args, gamma)
    n_p, f_p = gg_near_far_plain(*args, gamma)
    torch.cuda.synchronize()
    assert torch.equal(n_k, n_p) and torch.equal(f_k, f_p)
    assert int((n_k != args[2]).sum()) > 100  # some rays hit the body


@pytest.mark.parametrize("v", [1, VERT_TILE - 1, VERT_TILE, VERT_TILE + 1, 6890])
def test_gg_kernel_vertex_counts(dev, scene, v):
    """Vertex counts around the block's staged tile."""
    assert GG_KERNEL.extra_function("gg_near_far_vertex_pass", [])() == VERT_TILE
    args = _rays(scene, 777, dev)
    args[4] = args[4][:v].contiguous()
    if v == 1:  # aim some rays at the one vertex
        args[1][::3] = args[4][0] - args[0][0]
    n_k, f_k = gg_near_far_cuda(*args)
    n_p, f_p = gg_near_far_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(n_k, n_p) and torch.equal(f_k, f_p)


@pytest.mark.parametrize("gamma", [1e-6, 100.0])
def test_gg_kernel_no_sphere_and_every_sphere(dev, scene, gamma):
    """Rays that touch no sphere keep near/far; with a gamma larger than the
    scene every ray is inside every sphere."""
    args = _rays(scene, 1000, dev)
    n_k, f_k = gg_near_far_cuda(*args, gamma)
    n_p, f_p = gg_near_far_plain(*args, gamma)
    torch.cuda.synchronize()
    assert torch.equal(n_k, n_p) and torch.equal(f_k, f_p)
    hit = (n_k != args[2]) | (f_k != args[3])
    assert bool(hit.all()) if gamma > 1 else int(hit.sum()) < 1000


def test_gg_kernel_two_calls_give_the_same_bits(dev, scene):
    args = _rays(scene, 8192, dev)
    a = gg_near_far_cuda(*args)
    b = gg_near_far_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _world_centroids(scene, dev):
    verts = torch.as_tensor(scene.verts_world, device=dev)
    return face_centroids(verts, torch.as_tensor(scene.faces.astype(np.int64), device=dev))


def _points_near(cents, n, dev, seed=0, scale=0.05):
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, cents.shape[0], (n,), device=dev, generator=g)
    return cents[idx] + scale * torch.randn(n, 3, dtype=torch.float32, device=dev, generator=g)


# the brute-force kernel's block (4 points x 256 threads) and tile of centroids
_NF_BLOCK, _NF_TILE = 1024, 1024


@pytest.mark.parametrize("n", [1, 1000, _NF_BLOCK - 1, _NF_BLOCK, _NF_BLOCK + 1, 352_000, 524_288])
def test_nearest_face_kernel_equals_plain(dev, scene, n):
    cents = _world_centroids(scene, dev)
    pts = _points_near(cents, n, dev)
    ids_k = nearest_face_cuda(pts, cents)
    ids_p = nearest_face_plain(pts, cents)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)


@pytest.mark.parametrize("f", [1, 2, 7, 9, _NF_TILE - 1, _NF_TILE, _NF_TILE + 1, 3 * _NF_TILE + 5, 13_776])
@pytest.mark.parametrize("n", [5000, 352_000])
def test_nearest_face_kernel_face_counts(dev, scene, f, n):
    """Face counts at the chunk (8), the tile and the split edges; the
    split (chosen by `face_splits`, 3 ranges at 352,000 points) included."""
    cents = _world_centroids(scene, dev)[:f].contiguous()
    pts = _points_near(cents, n, dev, seed=f)
    ids_k = nearest_face_cuda(pts, cents)
    ids_p = nearest_face_plain(pts, cents)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 7, 8])
def test_nearest_face_every_split_gives_the_same_ids(dev, scene, splits):
    from dual_space_nerf_tpu_torch.ops.nearest_face import _nearest_face_launch

    cents = _world_centroids(scene, dev)
    pts = _points_near(cents, 100_003, dev, seed=3)
    ids_k = _nearest_face_launch(pts, cents, splits)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, nearest_face_plain(pts, cents))


def _duplicated_centroids(scene, dev):
    """The world centroids with copies planted across the kernel's edges:
    each pair (a, b), a < b, gets cents[b] = cents[a], so every point is
    exactly as far from both and must take a. The pairs straddle a chunk
    (7 | 8), a tile (1023 | 1024) and the 3-way face split's edges (4592
    and 9184), lie inside one chunk, and lie far apart in other ranges."""
    cents = _world_centroids(scene, dev).clone()
    pairs = [(7, 8), (16, 19), (1023, 1024), (2000, 2001), (4591, 4592), (9183, 9184),
             (100, 13_775), (5000, 13_000)]
    for a, b in pairs:
        cents[b] = cents[a]
    return cents, pairs


@pytest.mark.parametrize("n", [5000, 352_000, 524_288])
def test_nearest_face_ties_go_to_the_smallest_index(dev, scene, n):
    cents, pairs = _duplicated_centroids(scene, dev)
    pts = _points_near(cents, n, dev, seed=5, scale=0.002)
    # every fourth point sits on a duplicated centroid, ties at d2 = 0 too
    planted = torch.tensor([a for a, _ in pairs], device=dev)
    pts[::4] = cents[planted[torch.arange(pts[::4].shape[0], device=dev) % len(pairs)]]
    ids_k = nearest_face_cuda(pts, cents)
    ids_p = nearest_face_plain(pts, cents)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)
    losers = torch.tensor([b for _, b in pairs], device=dev)
    assert not bool(torch.isin(ids_k, losers).any())
    assert bool(torch.isin(planted, ids_k).all())


def test_nearest_face_two_calls_give_the_same_ids(dev, scene):
    cents, _ = _duplicated_centroids(scene, dev)
    for n in (352_000, 524_288):
        pts = _points_near(cents, n, dev, seed=9, scale=0.01)
        assert torch.equal(nearest_face_cuda(pts, cents), nearest_face_cuda(pts, cents))


def _search_inputs(scene, n, dev):
    """Morton-sorted near-surface points, centroids and the searches' tables."""
    verts = torch.as_tensor(scene.verts_world, device=dev)
    cents = face_centroids(verts, torch.as_tensor(scene.faces.astype(np.int64), device=dev))
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, cents.shape[0], (n,), device=dev, generator=g)
    pts = cents[idx] + 0.05 * torch.randn(n, 3, dtype=torch.float32, device=dev, generator=g)
    pts = pts[pruned_knn.morton_order(pts)].contiguous()
    cano = scene.verts_cano[scene.faces.astype(np.int64)].mean(axis=1)
    clusters = build_face_clusters(cano)
    tiles = torch.as_tensor(build_face_tiles(cano), device=dev)
    perm = torch.as_tensor(clusters[clusters >= 0].astype(np.int64), device=dev)
    return pts, cents, tiles, perm


@pytest.mark.parametrize("n,plan_p", [(128, 128), (2048, 128), (2048, 512), (2048, 2048),
                                      (524_288, 128), (524_288, 1024)])
def test_listed_plan_kernel_equals_plain(dev, scene, n, plan_p):
    """Lists, counts and sorted lower bounds, bit for bit."""
    pts, cents, tiles, _ = _search_inputs(scene, n, dev)
    _, tile_c, tile_r, _ = listed_tables(cents, tiles)
    got = pruned_knn.listed_plan(pts, tile_c, tile_r, tiles.shape[0], plan_p)
    want = pruned_knn.listed_plan_plain(pts, tile_c, tile_r, tiles.shape[0], plan_p)
    torch.cuda.synchronize()
    for name, a, b in zip(("order", "counts", "lbs"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(got[1].min()) >= 1


@pytest.mark.parametrize("plan_p", [128, 512, 2048])
@pytest.mark.parametrize("n_tiles", [1, 100, 128])
@pytest.mark.parametrize("kind", ["ties", "all", "one"])
def test_listed_plan_kernel_planted_rows(dev, kind, n_tiles, plan_p):
    """Planted key ties (broken by tile id), rows with every tile listed and
    rows with one, bit for bit against the plain version."""
    tile_c, tile_r, pts = (torch.as_tensor(a, device=dev) for a in plan_rows(kind, n_tiles, plan_p, 5))
    got = pruned_knn.listed_plan(pts, tile_c, tile_r, n_tiles, plan_p)
    want = pruned_knn.listed_plan_plain(pts, tile_c, tile_r, n_tiles, plan_p)
    torch.cuda.synchronize()
    for name, a, b in zip(("order", "counts", "lbs"), got, want):
        assert torch.equal(a, b), name
    if kind != "ties":
        assert bool((got[1] == (n_tiles if kind == "all" else 1)).all())


@pytest.mark.parametrize("rows", [1, 10, 4097])
def test_listed_plan_kernel_row_counts(dev, scene, rows):
    """Every entry of every row is written (outputs prefilled with -1)."""
    pts, cents, tiles, _ = _search_inputs(scene, rows * 128, dev)
    _, tile_c, tile_r, _ = listed_tables(cents, tiles)
    t = tiles.shape[0]
    order = torch.full((rows, t), -1, dtype=torch.int32, device=dev)
    counts = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    lbs = torch.full((rows, t), -1.0, dtype=torch.float32, device=dev)
    pruned_knn.launch_plan(pts, tile_c, tile_r, order, counts, lbs, 128)
    want = pruned_knn.listed_plan_plain(pts, tile_c, tile_r, t, 128)
    torch.cuda.synchronize()
    for name, a, b in zip(("order", "counts", "lbs"), (order, counts, lbs), want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n", [128, 2048, 524_288])
@pytest.mark.parametrize("variant", ["wide", "tighten", "slim"])
@pytest.mark.parametrize("plan_p", [128, 512])
def test_listed_kernels_equal_plain(dev, scene, n, variant, plan_p):
    if n % plan_p:
        pytest.skip("n is not a whole number of plan rows")
    pts, cents, tiles, _ = _search_inputs(scene, n, dev)
    cent_t, tile_c, tile_r, perm_pad = listed_tables(cents, tiles)
    order, counts, lbs = pruned_knn.listed_plan(pts, tile_c, tile_r, tiles.shape[0], plan_p)
    args = (pts, cent_t, order, counts, lbs, plan_p, variant == "slim", variant == "tighten")
    ids_k = pruned_knn.listed_search(*args)
    ids_p = pruned_knn.listed_search_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)
    # and the search is exact: the brute-force kernel's faces, but for near-ties
    assert int((perm_pad[ids_k.long()] != nearest_face_cuda(pts, cents)).sum()) <= max(1, n // 5000)


def _planted_lists(scene, dev, n, plan_p, seed):
    """Inputs for the listed kernels that no plan would give: visit lists
    of every length from 1 to all tiles (both ends present), tiles in random
    order, sorted random lower bounds, and centroid copies planted across
    tiles, each source slot copied to the same lane of another tile and to
    another lane of a third. Each row's points lie on or within 1e-3 of one
    source, so exact ties meet the tie rules."""
    rng = np.random.default_rng(seed)
    cents = _world_centroids(scene, dev)
    tiles_np = build_face_tiles(cents.cpu().numpy())
    t = tiles_np.shape[0]
    cent_t = listed_tables(cents, torch.as_tensor(tiles_np, device=dev))[0].clone()
    src = rng.choice(np.flatnonzero(tiles_np.reshape(-1) >= 0), 64, replace=False)
    for a in src:
        ta, la = divmod(int(a), 128)
        for lane in (la, (la + 1 + int(rng.integers(127))) % 128):
            tb = (ta + 1 + int(rng.integers(t - 1))) % t
            cent_t[:, tb * 128 + lane] = cent_t[:, a]
    rows = n // plan_p
    row_src = torch.as_tensor(src[np.arange(rows) % len(src)], device=dev)
    pts = cent_t.T[row_src].repeat_interleave(plan_p, 0)
    noise = torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device=dev)
    noise[::8] = 0.0
    pts = (pts + 1e-3 * noise).contiguous()
    counts = rng.integers(1, t + 1, rows)
    counts[::7], counts[3::7] = 1, t
    order = np.argsort(rng.random((rows, t)), axis=1)
    lbs = np.sort(rng.uniform(0.0, 1e-2, (rows, t)), axis=1)
    as_dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    return (pts, cent_t, as_dev(order, torch.int32), as_dev(counts, torch.int32),
            as_dev(lbs, torch.float32))


@pytest.mark.parametrize("variant", ["wide", "tighten", "slim"])
@pytest.mark.parametrize("plan_p", [128, 512])
def test_listed_kernels_follow_any_list(dev, scene, variant, plan_p):
    """2048 blocks with rows of count 1 and of every tile, planted ties:
    every slot id equals the plain version's."""
    inputs = _planted_lists(scene, dev, 262_144, plan_p, seed=plan_p)
    counts = inputs[3]
    assert int(counts.min()) == 1 and int(counts.max()) == inputs[2].shape[1]
    args = (*inputs, plan_p, variant == "slim", variant == "tighten")
    ids_k = pruned_knn.listed_search(*args)
    ids_p = pruned_knn.listed_search_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)


def test_listed_tie_rules_part_on_planted_ties(dev, scene):
    """The planted copies do reach the tie branches: the wide rule (first
    visited tile per lane) and the slim rule (smallest slot) name different
    slots at some points, and each kernel equals its plain version there;
    two calls give the same ids."""
    inputs = _planted_lists(scene, dev, 262_144, 128, seed=7)
    wide = pruned_knn.listed_search(*inputs, 128, False, False)
    slim = pruned_knn.listed_search(*inputs, 128, True, False)
    torch.cuda.synchronize()
    assert int((wide != slim).sum()) > 0
    assert torch.equal(wide, pruned_knn.listed_search_plain(*inputs, 128, False, False))
    assert torch.equal(slim, pruned_knn.listed_search_plain(*inputs, 128, True, False))
    assert torch.equal(wide, pruned_knn.listed_search(*inputs, 128, False, False))


@pytest.mark.parametrize("n", [128, 2048, 6144, 524_288])
@pytest.mark.parametrize("block_p", [96, 128, 256, 512, 1024])
@pytest.mark.parametrize("tighten", [0, 1, 2])
def test_pruned_kernel_equals_plain(dev, scene, n, block_p, tighten):
    """Every block size the sweep of `chip_smoke.py` times (and 96: one
    point a thread), tighten 0, 1 and 2: ids equal the plain version's."""
    if n % block_p:
        pytest.skip("n is not a whole number of blocks")
    ppt = PRUNED_KERNEL.extra_function("pruned_knn_points_per_thread", [ctypes.c_int])(block_p)
    assert ppt == (PRUNED_PTS if block_p % (32 * PRUNED_PTS) == 0 else 1)
    pts, cents, _, perm = _search_inputs(scene, n, dev)
    tabs = pruned_knn.pruned_tables(cents, perm)
    ids_k = pruned_knn.pruned_search(pts, *tabs, block_p, tighten=tighten)
    ids_p = pruned_knn.pruned_search_plain(pts, *tabs, block_p, tighten=tighten)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)
    assert int((perm[ids_k.long()] != nearest_face_cuda(pts, cents)).sum()) <= max(1, n // 5000)


@pytest.mark.parametrize("block_p", [128, 512])
@pytest.mark.parametrize("kind", PRUNED_TIE_KINDS)
def test_pruned_kernel_planted_ties(dev, kind, block_p):
    """Planted exact ties (`pruned_ties`: the seed tile 2 holding a lane that
    tile 0 ties, ties across lanes of non-seed tiles, a tie that a later
    strict improvement cancels): the kernel's ids are the plain version's
    and the expected ones, at tighten 0, 1 and 2."""
    pts, cents, want = (torch.as_tensor(a, device=dev) for a in pruned_ties(kind))
    pts = pts.repeat(block_p // 128, 1).contiguous()
    tabs = pruned_knn.pruned_tables(cents, torch.arange(cents.shape[0], device=dev))
    for tighten in (0, 1, 2):
        ids_k = pruned_knn.pruned_search(pts, *tabs, block_p, tighten=tighten)
        ids_p = pruned_knn.pruned_search_plain(pts, *tabs, block_p, tighten=tighten)
        torch.cuda.synchronize()
        assert torch.equal(ids_k, ids_p)
        assert torch.equal(ids_k, want.repeat(block_p // 128))


def test_pruned_kernel_one_tile(dev):
    """A mesh of 96 faces, one tile of 512 slots (416 padded): only the seed
    is visited."""
    small = make_scene(n_theta=6, n_phi=8)
    pts, cents, _, perm = _search_inputs(small, 2048, dev)
    tabs = pruned_knn.pruned_tables(cents, perm)
    assert tabs[3] == 1
    for block_p, tighten in ((128, 1), (512, 0), (96, 1)):
        pts_b = pts[: 2048 // block_p * block_p].contiguous()
        ids_k = pruned_knn.pruned_search(pts_b, *tabs, block_p, tighten=tighten)
        torch.cuda.synchronize()
        assert torch.equal(ids_k, pruned_knn.pruned_search_plain(pts_b, *tabs, block_p, tighten=tighten))
        assert int((perm[ids_k.long()].int() != nearest_face_plain(pts_b, cents)).sum()) <= 1


def _quantised_cloud(dev, n, f, seed):
    """Morton-sorted points and centroids on a 1/4 grid (centroid positions
    repeat, so exact ties are common), and the pruned tables in the
    centroids' own order: every tile spans the grid, so every block visits
    every tile."""
    rng = np.random.default_rng(seed)
    cents = torch.as_tensor(rng.integers(0, 8, (f, 3)) * 0.25, dtype=torch.float32, device=dev)
    pts = torch.as_tensor(rng.integers(0, 29, (n, 3)) * 0.0625 - 0.0625, dtype=torch.float32, device=dev)
    pts = pts[pruned_knn.morton_order(pts)].contiguous()
    return pts, cents, pruned_knn.pruned_tables(cents, torch.arange(f, device=dev))


@pytest.mark.parametrize("block_p", [128, 512, 1024])
def test_pruned_kernel_quantised_cloud_visits_every_tile(dev, block_p):
    pts, cents, tabs = _quantised_cloud(dev, 65_536, 13_776, seed=block_p)
    for tighten in (0, 1):
        ids_k = pruned_knn.pruned_search(pts, *tabs, block_p, tighten=tighten)
        ids_p, visits = pruned_knn.pruned_search_plain(pts, *tabs, block_p, tighten=tighten,
                                                       with_visits=True)
        torch.cuda.synchronize()
        assert bool((visits == tabs[3]).all())
        assert torch.equal(ids_k, ids_p)


def test_pruned_kernel_two_calls_give_the_same_ids(dev, scene):
    """Where a race in the copy ring would show: the same ids twice, on the
    quantised cloud (every tile visited) and on the mesh's points (tiles
    skipped, candidates dropped by the tightened threshold)."""
    pts, _, tabs = _quantised_cloud(dev, 524_288, 13_776, seed=3)
    assert torch.equal(pruned_knn.pruned_search(pts, *tabs), pruned_knn.pruned_search(pts, *tabs))
    pts, cents, _, perm = _search_inputs(scene, 524_288, dev)
    tabs = pruned_knn.pruned_tables(cents, perm)
    for tighten in (0, 1):
        a = pruned_knn.pruned_search(pts, *tabs, tighten=tighten)
        assert torch.equal(a, pruned_knn.pruned_search(pts, *tabs, tighten=tighten))


def test_searches_pad_ragged_tails_on_the_card(dev, scene):
    pts, cents, tiles, perm = _search_inputs(scene, 1000, dev)
    brute = nearest_face_cuda(pts, cents)
    for ids in (pruned_knn.pruned_search_listed(pts, cents, tiles),
                pruned_knn.pruned_search_listed(pts, cents, tiles, slim=True),
                pruned_knn.pruned_search_presorted(pts, cents, perm),
                pruned_knn.nearest_face_pruned(pts.flip(0).contiguous(), cents, perm).flip(0)):
        assert ids.shape == (1000,) and int((ids != brute).sum()) <= 1


def test_kernels_reject_what_they_do_not_take(dev, scene):
    args = _rays(scene, 16, dev)
    with pytest.raises(TypeError):
        gg_near_far_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        gg_near_far_cuda(args[0], args[1].t().contiguous().t(), *args[2:])
    with pytest.raises(ValueError):
        gg_near_far_cuda(args[0], args[1], args[2], args[3], args[4].cpu())
    pts = torch.zeros(4, 3, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        nearest_face_cuda(pts, torch.zeros(0, 3, dtype=torch.float32, device=dev))
    with pytest.raises(TypeError):
        nearest_face_cuda(pts.half(), torch.zeros(2, 3, dtype=torch.float32, device=dev))
    spts, cents, tiles, perm = _search_inputs(scene, 256, dev)
    with pytest.raises(TypeError):
        pruned_knn.pruned_search_listed(spts.double(), cents, tiles)
    with pytest.raises(ValueError):
        pruned_knn.pruned_search_listed(spts, cents, tiles, plan_p=64)  # not a thread block
    with pytest.raises(ValueError):
        pruned_knn.pruned_search_listed(spts, cents, tiles, tables=tuple(
            t.cpu() for t in listed_tables(cents, tiles)))
    tabs = listed_tables(cents, tiles)
    with pytest.raises(ValueError):  # 4096-point rows do not fit the plan kernel's shared memory
        pruned_knn.listed_plan(spts.repeat(16, 1), tabs[1], tabs[2], tiles.shape[0], 4096)
    with pytest.raises(ValueError):
        pruned_knn.pruned_search_presorted(spts, cents, perm, block_p=48)
    with pytest.raises(ValueError):
        pruned_knn.pruned_search_presorted(spts, cents, perm, block_f=256)
    cent_t, tile_c, tile_r, n_tiles = pruned_knn.pruned_tables(cents, perm)
    shifted = torch.empty(cent_t.numel() + 1, dtype=torch.float32, device=dev)[1:].view_as(cent_t)
    shifted.copy_(cent_t)
    with pytest.raises(ValueError):  # the kernel copies 16 bytes at a time
        pruned_knn.pruned_search(spts, shifted, tile_c, tile_r, n_tiles, 128)


def _fused_inputs(n, dev, seed=0):
    """A randomly initialised SpaceNet's packed weights and seeded inputs on
    the card: pe of points near the origin, cp, and the three cotangents."""
    from dual_space_nerf_tpu_torch.models import DualSpaceNeRF
    from dual_space_nerf_tpu_torch.ops import fused_mlp as fm
    from dual_space_nerf_tpu_torch.ops.posenc import posenc

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full FP32
    model = DualSpaceNeRF(max_frames=4, generator=torch.Generator().manual_seed(seed)).to(dev)
    w = {k: v.detach() for k, v in fm.pack(fm.nerf_params(model.nerf)).items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *s: torch.randn(*s, dtype=torch.float32, device=dev, generator=g)
    x = fm.build_x(posenc(0.3 * rand(n, 3), 10), rand(n, 24))
    return fm, w, x, rand(n), rand(n, 3), rand(n, fm.PE)


def _close(got, want, tol, keep=None):
    if keep is not None:
        got, want = got[keep], want[keep]
    return float((got - want).abs().max()) <= tol * (float(want.abs().max()) + 1e-12)


_TILE = 64  # both fused kernels' tile of points (`csrc/fused_mlp_tiled.cuh`: P)


@pytest.mark.parametrize("n", [1, _TILE - 1, _TILE, _TILE + 1, 100, 100 * _TILE, 88_000])
@pytest.mark.parametrize("with_color", [True, False])
def test_fused_kernels_match_plain(dev, n, with_color):
    """Forward within 1e-5 and backward within 2e-5 of the reference's
    max-abs scale (the bands of the CPU tests against the JAX package), on
    the kernels' tile edges and on fewer tiles (100) than the persistent
    grid has blocks. Points with a pre-activation within 1e-6 of a ReLU's
    kink (relative to the layer's largest) may take the mask the other way
    in either order of the sums: their mask-dependent outputs are left out
    and their cotangents zeroed, so that they add nothing to the gradients."""
    fm, w, x, sbar, ebar, gbar = _fused_inputs(n, dev)
    assert fm.BWD_KERNEL.extra_function("fused_mlp_bwd_tile", [ctypes.c_int])(0) == _TILE
    assert fm.FWD_KERNEL.extra_function("fused_mlp_fwd_tile", [ctypes.c_int])(0) == _TILE
    assert fm._blocks(fm.BWD_KERNEL, "fused_mlp_bwd_blocks", dev, with_color) > 100
    keep = fm.kink_distances(w, x).amin(1) > 1e-6
    assert float(keep.float().mean()) > 0.8
    got = fm.fused_fwd(w, x, with_color)
    want = fm.fused_fwd_plain(w, x, with_color)
    torch.cuda.synchronize()
    assert _close(got[0], want[0], 1e-5)  # sigma and essence are continuous
    if with_color:
        assert _close(got[1], want[1], 1e-5)
        assert _close(got[2], want[2], 1e-5, keep)
    sbar = sbar * keep
    eb, gb = (ebar * keep[:, None], gbar * keep[:, None]) if with_color else (None, None)
    xbar, gpe, grads = fm.fused_bwd(w, x, sbar, eb, gb, with_color)
    xbar_p, gpe_p, grads_p = fm.fused_bwd_plain(w, x, sbar, eb, gb, with_color)
    torch.cuda.synchronize()
    assert _close(xbar, xbar_p, 2e-5, keep)
    if with_color:
        assert _close(gpe, gpe_p, 2e-5, keep)
    for k, v in grads_p.items():
        assert _close(grads[k].reshape(v.shape), v, 2e-5), k


@pytest.mark.parametrize("n", [5000, 100_003])
def test_fused_backward_is_deterministic(dev, n):
    fm, w, x, sbar, ebar, gbar = _fused_inputs(n, dev, seed=1)
    a = fm.fused_bwd(w, x, sbar, ebar, gbar, True)
    b = fm.fused_bwd(w, x, sbar, ebar, gbar, True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


@pytest.mark.parametrize("production,fused", [(True, True), (True, False), (False, True)])
def test_train_step_gives_the_same_bits_twice(dev, production, fused):
    """Two train steps from the same state, batch and draws (1024 rays of the
    512x512 train item, the train config's paths): every gradient bit for
    bit. The production path's tail completion gathers each sample's color
    from a selected sample; its backward is a reduction of a fixed order
    (`renderer/pipeline.py::_TakeSelected`), not take_along_dim's atomic
    scatter-add, which made two runs part in the last bits."""
    from dual_space_nerf_tpu_torch.data import SyntheticDataset, item_to_mesh, item_to_train_batch
    from dual_space_nerf_tpu_torch.evaluation.golden import train_cfg, trained_model
    from dual_space_nerf_tpu_torch.renderer import RenderSettings
    from dual_space_nerf_tpu_torch.training import create_train_state, draw_randoms, make_train_step

    ds = SyntheticDataset(split="train", nrays=1024, n_frames=1, n_views=1, h=512, w=512)
    item = ds[0]
    batch = item_to_train_batch(item, 1024, dev)
    mesh = item_to_mesh(item, ds.faces, ds.canonical_vertex, dev)
    cfg = train_cfg(production, fused)
    settings = RenderSettings.from_cfg(cfg)
    draws = draw_randoms(1024, settings.n_samples, torch.Generator(device=dev).manual_seed(1), dev)
    grads = []
    for _ in range(2):
        model = trained_model(cfg.MODEL.MAX_FRAMES).to(dev)
        make_train_step(settings, device=dev)(create_train_state(model, cfg), batch, mesh, draws)
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


@pytest.mark.parametrize("n", [5000, 100_003])
@pytest.mark.parametrize("with_color", [True, False])
def test_fused_forward_is_deterministic(dev, n, with_color):
    fm, w, x, *_ = _fused_inputs(n, dev, seed=1)
    a = fm.fused_fwd(w, x, with_color)
    b = fm.fused_fwd(w, x, with_color)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b) if u is not None)


@pytest.mark.parametrize("n", [5000, 100_003])
def test_fused_forward_gpe_is_the_backwards(dev, n):
    """Both kernels compute gpe with the same routines of the tiled core on
    the same rows: the same bits at every point, kinks included."""
    fm, w, x, sbar, ebar, gbar = _fused_inputs(n, dev, seed=2)
    _, _, gpe_f = fm.fused_fwd(w, x, True)
    _, gpe_b, _ = fm.fused_bwd(w, x, sbar, ebar, gbar, True)
    torch.cuda.synchronize()
    assert torch.equal(gpe_f, gpe_b)


@pytest.mark.parametrize("n", [1, _TILE + 1, 100, 100 * _TILE, 88_000])
@pytest.mark.parametrize("with_color", [True, False])
def test_fast_fused_kernels_match_fast_plain(dev, n, with_color):
    """The `_fast` entry points (bf16 products on the tensor cores), on the
    tile edges and at the step's color pass, against the oracle of their
    plain versions (``order="exact"``: every sum in float64, rounded once)
    as `fused_mlp.check_fast_kernels` holds them: the points beyond the
    float32 pair's bands (forward 1e-5, backward 2e-5) at most twice the
    plain float32 orders' count and under 5%, the weight gradients with
    those points' cotangents zeroed, the weight-gradient pass on the
    kernel's own operands within 2e-5, the forward's gpe equal to the
    backward's, two launches equal, and a grid of 7 blocks giving the same
    per-point bits. The fast kernel is not the float32 one."""
    fm, w, x, sbar, ebar, gbar = _fused_inputs(n, dev, seed=3)
    if not with_color:
        ebar = gbar = None
    assert fm.BWD_KERNEL.extra_function("fused_mlp_bwd_fast_record", [ctypes.c_int])(
        int(with_color)) == fm.record_rows(with_color)["rows"] * _TILE
    fm.check_fast_kernels(w, x, (sbar, ebar, gbar), with_color)
    assert not _close(fm.fused_fwd(w, x, with_color, fast=True)[0], fm.fused_fwd(w, x, with_color)[0], 1e-5)


def test_fused_fast_production_step(dev):
    """One production step (313_tpu.yml, the listed search, FUSED_MLP on,
    FUSED_FAST) on the synthetic train item: finite loss and gradients,
    within 0.25 of the float32 fused step's gradients per tensor (bfloat16
    operands; the JAX package's own band between its fast and exact pair,
    `tests/test_fused_mlp.py`), and the fast pair launched twice each, the
    float32 pair never."""
    from dual_space_nerf_tpu_torch.data import SyntheticDataset, item_to_mesh, item_to_train_batch
    from dual_space_nerf_tpu_torch.evaluation.golden import train_cfg
    from dual_space_nerf_tpu_torch.models import DualSpaceNeRF
    from dual_space_nerf_tpu_torch.ops import KERNELS
    from dual_space_nerf_tpu_torch.renderer import RenderSettings
    from dual_space_nerf_tpu_torch.training import create_train_state, draw_randoms, make_train_step

    ds = SyntheticDataset(split="train", nrays=5500, n_frames=1, n_views=1, h=512, w=512)
    item = ds[0]
    batch = item_to_train_batch(item, 5500, dev)
    mesh = item_to_mesh(item, ds.faces, ds.canonical_vertex, dev)
    grads = {}
    for fast in (False, True):
        cfg = train_cfg(production=True, fused=True)
        cfg.MODEL.FUSED_FAST = fast
        settings = RenderSettings.from_cfg(cfg)
        assert settings.fused_fast is fast
        model = DualSpaceNeRF(max_frames=cfg.MODEL.MAX_FRAMES,
                              generator=torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, cfg)
        randoms = draw_randoms(5500, settings.n_samples, torch.Generator(device=dev).manual_seed(0), dev)
        for k in KERNELS:
            k.launches = 0
        metrics = make_train_step(settings, device=dev)(state, batch, mesh, randoms)
        torch.cuda.synchronize()
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
        grads[fast] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        launched = {k.name: k.launches for k in KERNELS}
        pair = ("fused_mlp_fwd_fast", "fused_mlp_bwd_fast") if fast else ("fused_mlp_fwd", "fused_mlp_bwd")
        want = {"gg_near_far": 1, "listed_plan": 1, "listed_knn": 1, pair[0]: 2, pair[1]: 2}
        assert launched == {k.name: want.get(k.name, 0) for k in KERNELS}
    ratios = {}
    for n, g in grads[True].items():
        assert torch.isfinite(g).all(), n
        ratios[n] = float((g - grads[False][n]).abs().max()) / (float(grads[False][n].abs().max()) + 1e-12)
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= 0.25, (worst, ratios[worst])


# ---------------------------------------------------------------------------
# the real-data pipeline on the card's machine
# ---------------------------------------------------------------------------
def test_jpeg_decoder_builds_and_matches_the_cpu_checksum(dev):
    """The host JPEG decoder (`csrc/jpeg_decode.c`) built with the card
    machine's C compiler decodes the committed tree's 48 JPEGs to the bytes
    that `tests/test_torch_port_data.py` holds to cv2 (their checksum)."""
    import glob
    import hashlib

    from dual_space_nerf_tpu_torch.utils.image_io import imread
    from torch_port_common import COLD_TREE, COLD_TREE_JPEG_SHA256

    digest = hashlib.sha256()
    paths = sorted(glob.glob(f"{COLD_TREE}/**/*.jpg", recursive=True))
    assert len(paths) == 48
    for path in paths:
        img = imread(path)
        assert img.shape == (1024, 1024, 3) and img.dtype == np.uint8
        digest.update(img.tobytes())
    assert digest.hexdigest() == COLD_TREE_JPEG_SHA256


def test_zju_item_through_one_fused_production_step(dev):
    """A `Mocap` item decoded from the committed tree (ratio 0.5, 5500
    rays), its mesh from the stand-in SMPL topology and the tree's canonical
    vertices, through one production step with the fused kernels: finite
    loss and PSNR, and the kernels of the step launched (GG, the plan and
    the listed search once, the fused pair twice each)."""
    from dual_space_nerf_tpu_torch.data import item_to_mesh, item_to_train_batch
    from dual_space_nerf_tpu_torch.data.zju import Mocap
    from dual_space_nerf_tpu_torch.evaluation.golden import train_cfg
    from dual_space_nerf_tpu_torch.models import DualSpaceNeRF
    from dual_space_nerf_tpu_torch.ops import KERNELS
    from dual_space_nerf_tpu_torch.renderer import RenderSettings
    from dual_space_nerf_tpu_torch.training import create_train_state, draw_randoms, make_train_step
    from torch_port_common import COLD_TREE

    cfg = train_cfg(production=True, fused=True)
    ds = Mocap("CoreView_313", 0.5, 5500, 0, 15, (0, 1, 2), data_dir=os.path.dirname(COLD_TREE))
    item = ds[5]
    assert item["img"].shape == (512, 512, 3)
    faces = make_scene(h=8, w=8).faces
    batch = item_to_train_batch(item, 5500, dev)
    mesh = item_to_mesh(item, faces, ds.canonical_vertex, dev)
    model = DualSpaceNeRF(max_frames=cfg.MODEL.MAX_FRAMES, code_dim=cfg.MODEL.CODE_DIM,
                          backbone_dim=cfg.MODEL.BACKBONE_DIM,
                          generator=torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, cfg)
    settings = RenderSettings.from_cfg(cfg)
    randoms = draw_randoms(5500, settings.n_samples, torch.Generator(device=dev).manual_seed(0), dev)
    for k in KERNELS:
        k.launches = 0
    metrics = make_train_step(settings, device=dev)(state, batch, mesh, randoms)
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    launched = {k.name: k.launches for k in KERNELS}
    want = {"gg_near_far": 1, "listed_plan": 1, "listed_knn": 1, "fused_mlp_fwd": 2, "fused_mlp_bwd": 2}
    assert launched == {k.name: want.get(k.name, 0) for k in KERNELS}
