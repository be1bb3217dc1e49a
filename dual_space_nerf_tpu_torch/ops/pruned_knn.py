"""Tile-pruned exact nearest-face searches: tables, visit plan, kernel
wrappers and plain versions.

Replaces the JAX package's `ops/pruned_knn.py`, whose three TPU kernels
become three CUDA kernels:

- `_listed_kernel`      -> `csrc/listed_knn.cu`      (`LISTED_KERNEL`)
- `_listed_kernel_slim` -> `csrc/listed_knn_slim.cu` (`LISTED_SLIM_KERNEL`)
- `_pruned_kernel`      -> `csrc/pruned_knn.cu`      (`PRUNED_KERNEL`)

**Listed search** (`pruned_search_listed`): the centroids sit in kd-leaf
tiles of 128 slots (`build_face_tiles`, `listed_tables`). A visit plan
(`listed_plan`; plain XLA ahead of the kernel in the JAX package, here a
fourth CUDA kernel, `csrc/listed_plan.cu`, `LISTED_PLAN_KERNEL`, because as
plain torch ops it costs eight times the search it feeds) lists for every
row of ``plan_p`` consecutive points the
tiles that can hold the nearest centroid of one of them: per point,
u_p = min over tiles of the distance to the tile's witness centroid is an
upper bound on the nearest distance, and a tile is listed iff some point has
dist(p, tile AABB) <= u_p. The kernel walks the list. The search is exact
whatever the plan's granularity; finer rows list fewer tiles.

**Pruned search** (`pruned_search_presorted`): 512-face tiles in kd order
with bounding spheres (`pruned_tables`); the kernel bounds each block of
``block_p`` points by a sphere and skips tiles by sphere-to-sphere distance.
Its kernel (`csrc/pruned_knn.cu`) holds 4 points a thread, copies the next
candidate tile ahead with `cp.async` into a 2-stage ring, and runs the
chunked `fminf` with the per-lane tie rule in closed form.

Both want spatially coherent consecutive points (the renderer's blocked
layout, or `morton_order`). All three kernels are bound by operations on the
H100; the sources' headers say what the designs do about it. Each visited
pair costs 9 FP32 operations that may not fuse into an FMA (the tie rule),
so the floor is 9 issued instructions a pair at 33.5e12 a second (0.185 ms
for the render's 6.9e8 listed pairs), twice the 67 TFLOP/s bound. The
listed kernel (`csrc/listed_knn.cuh`) gives a plan row's 128-point block to
one warp, 4 points a lane: it reads the row's list into shared memory once,
copies the listed tiles ahead with `cp.async` into a 2-stage ring, and runs
a chunked `fminf` so that the tie branch runs only when a chunk reaches the
running best; the blocks take the rows longest list first (a counting sort
launched ahead of the search, into scratch the wrapper allocates).

Every search has a plain PyTorch version of the same function (same visit
lists, same tie rule, same rounding order: d2 = (dx*dx + dy*dy) + dz*dz, one
rounding per operation), vectorised over the rows; CPU tensors take it, CUDA
tensors launch the kernel or raise.

Tie rules, as in the JAX package: the wide listed kernel and the pruned
kernel give each lane (slot position within its tile) to the first-visited
tile and then take the smallest id among the lanes at the minimum; the slim
listed kernel takes the smallest slot id among all visited slots at the
minimum.

Environment knobs, read when a search is called: `DSNERF_KNN_PLAN_P`
(points per plan row), `DSNERF_KNN_TIGHTEN` (0/1, in-kernel threshold of the
wide listed kernel), `DSNERF_KNN_SLIM` (0/1, the slim kernel).
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np
import torch

from .clustered_knn import kd_partition
from .cuda_build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
LISTED_KERNEL = CudaKernel(
    "listed_knn.cu", "listed_knn_launch",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], includes=("listed_knn.cuh",),
)
LISTED_SLIM_KERNEL = CudaKernel(
    "listed_knn_slim.cu", "listed_knn_slim_launch",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], includes=("listed_knn.cuh",),
)
LISTED_PLAN_KERNEL = CudaKernel(
    "listed_plan.cu", "listed_plan_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
)
PRUNED_KERNEL = CudaKernel(
    "pruned_knn.cu", "pruned_knn_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)

# points per thread block of the listed kernels (one warp, 4 points a
# lane): a plan row is a whole number of them, and the in-kernel threshold
# is taken over each
LISTED_BLOCK_P = 128
_BLOCK_F_LISTED = 128    # slots per kd-leaf tile
_BLOCK_P_LISTED = 2048   # the tail is padded to a multiple of this
_PLAN_P_LISTED = 128     # points per plan row (DSNERF_KNN_PLAN_P)
_TIGHTEN_LISTED = False  # DSNERF_KNN_TIGHTEN
_SLIM_LISTED = False     # DSNERF_KNN_SLIM
_LISTED_MAX_TILES = 4096  # tile ids (and lower bounds) a listed block keeps in shared memory

_BLOCK_P = 512           # points per block of the pruned search
_BLOCK_F = 512           # faces per tile of the pruned search
_TIGHTEN = 1             # tighten after every visited tile; 0 = seed only
_PRUNED_MAX_TILES = 1024  # lower bounds the pruned kernel keeps in shared memory

_PAD = 1e15              # padded centroids: d2 ~ 1e30, finite, never the minimum
_NO_ID = 2 ** 30
# elements of the largest temporaries of the plan and the plain versions
_PLAN_ELEMS = 1 << 27
_PLAIN_PAIRS = 1 << 26

_log = logging.getLogger(__name__)


def _env_int(name: str, default: int, must_divide: int) -> int:
    """Integer knob from the environment: a positive divisor of
    ``must_divide``. Logs when it overrides the default."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer; expected a positive divisor of {must_divide}"
        ) from None
    if value < 1 or must_divide % value:
        raise ValueError(f"{name}={value} must be a positive divisor of {must_divide}")
    if value != default:
        _log.warning("%s=%d overrides the default %d", name, value, default)
    return value


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    if raw not in ("0", "1"):
        raise ValueError(f"{name}={raw!r} must be '0' or '1'")
    value = raw == "1"
    if value != default:
        _log.warning("%s=%s overrides the default %s", name, raw, default)
    return value


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum over the last axis, stated explicitly
    (the same on every device)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    return torch.where(x == x.amin(-1, keepdim=True), idx, n).amin(-1)


def _d2(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(dx*dx + dy*dy) + dz*dz with d = p - c over broadcast (..., 3)
    operands, in place on fresh tensors: one rounding per operation."""
    dx = p[..., 0] - c[..., 0]
    dy = p[..., 1] - c[..., 1]
    dz = p[..., 2] - c[..., 2]
    return dx.mul_(dx).add_(dy.mul_(dy)).add_(dz.mul_(dz))


def _check_points(name: str, pts: torch.Tensor) -> None:
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.shape[0] == 0:
        raise ValueError(f"{name}: pts must be (n, 3) with n > 0, got {tuple(pts.shape)}")
    if pts.dtype != torch.float32:
        raise TypeError(f"{name}: pts must be float32, got {pts.dtype}")
    if pts.shape[0] * 3 >= 2 ** 31:
        raise ValueError(f"{name}: the kernel indexes with 32-bit ints")


def _check_table(name: str, what: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _pad_edge(pts: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad (n, 3) points to a multiple by repeating the last one: the tail
    block's bounds stay tight (zero padding would drag them to the origin)."""
    n = pts.shape[0]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return pts.contiguous()
    return torch.cat([pts, pts[-1:].expand(n_pad - n, 3)]).contiguous()


# --------------------------------------------------------------------------
# listed search: tables
# --------------------------------------------------------------------------
def build_face_tiles(centroids, block_f: int = _BLOCK_F_LISTED) -> np.ndarray:
    """kd-leaf tile table of the listed search (host side, once per mesh):
    (T, block_f) int32 face ids, -1 padded, T a power of two with every leaf
    <= block_f faces."""
    pts = np.asarray(centroids)
    f = pts.shape[0]
    t = 1
    while -(-f // t) > block_f:
        t *= 2
    leaves = kd_partition(np.arange(f), pts, t)
    table = np.full((len(leaves), block_f), -1, np.int32)
    for i, leaf in enumerate(leaves):
        if len(leaf) > block_f:
            raise ValueError(f"kd leaf of {len(leaf)} faces exceeds the tile width {block_f}")
        table[i, : len(leaf)] = leaf
    return table


def listed_tables(centroids: torch.Tensor, tile_table: torch.Tensor):
    """The listed search's tables for one centroid set under a tile table:

    - cent_t (3, T*BF): the centroids by tile slot, padded slots at 1e15;
    - tile_c (8, T_pad): rows 0:3 the tiles' AABB lo, rows 3:6 the AABB hi;
    - tile_r (8, T_pad): rows 0:3 the WITNESS centroid of each tile, the
      member closest to the AABB midpoint;
    - perm_pad (T*BF,) int32: slot -> face id (padded slots -> face 0).

    tile_c and tile_r feed only the visit plan; the kernel reads cent_t.
    Exact IEEE float32 operations with a fixed order, so the result equals
    the JAX package's `listed_tables_np` bit for bit on every device."""
    t, bf = tile_table.shape
    dev = centroids.device
    valid = tile_table >= 0                                     # (T, BF)
    safe = tile_table.clamp_min(0).long()
    big = torch.tensor(_PAD, dtype=torch.float32, device=dev)
    cents = torch.where(valid[..., None], centroids.to(torch.float32)[safe], big)
    cent_t = cents.reshape(t * bf, 3).T.contiguous()            # (3, T*BF)

    lo = cents.amin(1)                                          # (T, 3)
    hi = torch.where(valid[..., None], cents, -big).amax(1)
    hi = torch.where(hi <= -big, big, hi)  # all-padded tiles: lo = hi = 1e15
    mid = 0.5 * (lo + hi)
    diff = torch.where(valid[..., None], cents, torch.zeros_like(big)) - mid[:, None]
    d2 = diff * diff
    r2 = (d2[..., 0] + d2[..., 1]) + d2[..., 2]
    w_idx = _first_argmin(torch.where(valid, r2, torch.inf))    # (T,)
    witness = cents[torch.arange(t, device=dev), w_idx]         # (T, 3)

    t_pad = -(-t // 128) * 128
    tile_c = torch.full((8, t_pad), _PAD, dtype=torch.float32, device=dev)
    tile_c[0:3, :t] = lo.T
    tile_c[3:6, :t] = hi.T
    tile_r = torch.full((8, t_pad), _PAD, dtype=torch.float32, device=dev)
    tile_r[0:3, :t] = witness.T
    perm_pad = torch.where(valid, safe, 0).reshape(t * bf).to(torch.int32)
    return cent_t, tile_c, tile_r, perm_pad


def slot_perm_from_tiles(tile_table: torch.Tensor) -> torch.Tensor:
    """(T*BF,) int64 slot -> face id, matching `return_slots=True` results
    (`listed_tables`' perm_pad): padded slots map to face 0 and are never
    returned."""
    return tile_table.clamp_min(0).reshape(-1).long()


# --------------------------------------------------------------------------
# listed search: visit plan
# --------------------------------------------------------------------------
def listed_plan_plain(pts: torch.Tensor, tile_c: torch.Tensor, tile_r: torch.Tensor,
                      n_tiles: int, plan_p: int):
    """Visit plan of the listed search for (N, 3) points, N a multiple of
    plan_p, in plain PyTorch: per row of plan_p consecutive points,

    - order (rows, T) int32: tile ids sorted by the row's squared lower
      bound, the listed tiles first;
    - counts (rows,) int32: the number of listed tiles (>= 1);
    - lbs (rows, T) float32: the sorted squared lower bounds (inf where not
      listed).

    A tile is listed for a row iff some point p of it has
    dist2(p, tile AABB) <= u_p^2, u_p the distance to the nearest witness
    centroid. The witness distances are direct differences (no expanded
    form, so no cancellation and no need for a matrix product at full
    precision); u_p is still inflated by 1 + 1e-5 and 1e-6 as in the JAX
    package, past the rounding of either side, so that the tile of a true
    nearest centroid is never planned away."""
    n = pts.shape[0]
    if n % plan_p:
        raise ValueError(f"listed_plan: {n} points are not a multiple of plan_p={plan_p}")
    rows = n // plan_p
    dev = pts.device
    lo, hi, wit = tile_c[0:3, :n_tiles], tile_c[3:6, :n_tiles], tile_r[0:3, :n_tiles]
    order = torch.empty((rows, n_tiles), dtype=torch.int32, device=dev)
    lbs = torch.empty((rows, n_tiles), dtype=torch.float32, device=dev)
    counts = torch.empty((rows,), dtype=torch.int32, device=dev)
    step = max(1, _PLAN_ELEMS // (plan_p * n_tiles))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        p = pts[r0 * plan_p:r1 * plan_p]
        d = None
        for dim in range(3):
            e = p[:, dim:dim + 1] - wit[dim]                    # (m, T)
            e.mul_(e)
            d = e if d is None else d.add_(e)
        u = d.amin(1, keepdim=True).sqrt_()
        u = u * (1.0 + 1e-5) + 1e-6
        u2 = u * u                                              # (m, 1)
        lb2 = None
        for dim in range(3):
            x = p[:, dim:dim + 1]
            # distance to the interval [lo, hi] along this axis
            e = torch.clamp(x, min=lo[dim], max=hi[dim]).sub_(x)
            e.mul_(e)
            lb2 = e if lb2 is None else lb2.add_(e)
        visit = (lb2 <= u2).reshape(r1 - r0, plan_p, n_tiles).any(1)
        key = lb2.reshape(r1 - r0, plan_p, n_tiles).amin(1)
        key = torch.where(visit, key, torch.inf)
        lbs[r0:r1], idx = torch.sort(key, dim=1, stable=True)
        order[r0:r1] = idx.to(torch.int32)
        counts[r0:r1] = visit.sum(1, dtype=torch.int32)
    return order, counts, lbs


def listed_plan(pts: torch.Tensor, tile_c: torch.Tensor, tile_r: torch.Tensor,
                n_tiles: int, plan_p: int):
    """The visit plan (`listed_plan_plain`: order, counts, lbs). CPU tensors
    take the plain version; CUDA tensors launch `csrc/listed_plan.cu`, a
    block a row, which takes only the witnesses and tiles the row's bounding
    box cannot rule out and writes the same plan bit for bit without the
    (N, T) temporaries (or raise)."""
    if pts.device.type == "cpu":
        return listed_plan_plain(pts, tile_c, tile_r, n_tiles, plan_p)
    if pts.device.type != "cuda":
        raise ValueError(f"listed_plan: unsupported device {pts.device}")
    name = "listed_plan"
    dev = pts.device
    n = pts.shape[0]
    _check_points(name, pts)
    if not pts.is_contiguous():
        raise ValueError(f"{name}: pts must be contiguous")
    if plan_p < 1 or n % plan_p:
        raise ValueError(f"{name}: {n} points are not a multiple of plan_p={plan_p}")
    t_pad = tile_c.shape[1]
    _check_table(name, "tile_c", tile_c, (8, t_pad), torch.float32, dev)
    _check_table(name, "tile_r", tile_r, (8, t_pad), torch.float32, dev)
    if not 1 <= n_tiles <= t_pad:
        raise ValueError(f"{name}: {n_tiles} tiles for tables of {t_pad} columns")
    if not LISTED_PLAN_KERNEL.extra_function("listed_plan_fits", [_I, _I])(plan_p, n_tiles):
        raise ValueError(
            f"{name}: plan_p={plan_p} with {n_tiles} tiles exceeds the kernel's shared memory"
        )
    rows = n // plan_p
    order = torch.empty((rows, n_tiles), dtype=torch.int32, device=dev)
    counts = torch.empty((rows,), dtype=torch.int32, device=dev)
    lbs = torch.empty((rows, n_tiles), dtype=torch.float32, device=dev)
    launch_plan(pts, tile_c, tile_r, order, counts, lbs, plan_p)
    return order, counts, lbs


def launch_plan(pts, tile_c, tile_r, order, counts, lbs, plan_p: int) -> None:
    """One bare launch of the plan kernel into preallocated outputs, without
    the wrapper's checks (`listed_plan` makes them)."""
    dev = pts.device
    with torch.cuda.device(dev):
        LISTED_PLAN_KERNEL.launch(
            pts.data_ptr(), tile_c.data_ptr(), tile_r.data_ptr(), order.data_ptr(),
            counts.data_ptr(), lbs.data_ptr(), pts.shape[0], plan_p, order.shape[1],
            tile_c.shape[1], stream_ptr(dev),
        )


# --------------------------------------------------------------------------
# listed search: plain version and kernel wrapper
# --------------------------------------------------------------------------
def listed_search_plain(pts, cent_t, order, counts, lbs, plan_p: int,
                        slim: bool = False, tighten: bool = False) -> torch.Tensor:
    """The listed kernels' function in plain PyTorch: (N,) int32 slot ids.

    Steps through the visit lists, all rows at once; a row whose list has
    ended is masked. wide (slim=False): a (points, 128) running minimum per
    lane with the id of the tile that set it first, decoded once at the end,
    the formulation of the JAX package's kernel; ``tighten`` stops the list
    of each group of `LISTED_BLOCK_P` points once the next lower bound
    exceeds every point's best. slim: one running best per point, on a tie
    the smaller slot id."""
    n = pts.shape[0]
    bf = _BLOCK_F_LISTED
    rows, g = n // plan_p, plan_p // LISTED_BLOCK_P
    dev = pts.device
    cents = cent_t.T.reshape(-1, bf, 3)                         # (T, BF, 3)
    lane = torch.arange(bf, dtype=torch.int32, device=dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_PAIRS // (plan_p * bf))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        r = r1 - r0
        p = pts[r0 * plan_p:r1 * plan_p].reshape(r, g, LISTED_BLOCK_P, 1, 3)
        cnt = counts[r0:r1]
        alive = torch.ones((r, g), dtype=torch.bool, device=dev)
        best = ids = None
        for v in range(int(cnt.max())):
            t = order[r0:r1, v]                                 # (r,)
            d2 = _d2(p, cents[t.long()][:, None, None])         # (r, g, 128, BF)
            tile = t[:, None, None, None]
            if slim:
                vmin = d2.amin(-1)                              # (r, g, 128)
                vid = torch.where(d2 <= vmin[..., None], tile * bf + lane, _NO_ID).amin(-1)
            if v == 0:
                best, ids = (vmin, vid) if slim else (d2, tile.expand_as(d2).contiguous())
                continue
            alive = alive & (v < cnt)[:, None]
            if slim:
                lt = alive[..., None] & (vmin < best)
                eq = alive[..., None] & (vmin == best)
                ids = torch.where(lt, vid, torch.where(eq, torch.minimum(vid, ids), ids))
                best = torch.where(lt, vmin, best)
            else:
                if tighten:
                    thresh = best.amin(-1).amax(-1)             # (r, g)
                    alive = alive & (lbs[r0:r1, v][:, None] <= thresh)
                m = alive[..., None, None] & (d2 < best)
                best = torch.where(m, d2, best)
                ids = torch.where(m, tile, ids)
        if not slim:
            # per point the minimum over lanes, then the smallest slot id
            # among the lanes that reach it
            pmin = best.amin(-1, keepdim=True)
            ids = torch.where(best <= pmin, ids * bf + lane, _NO_ID).amin(-1)
        out[r0 * plan_p:r1 * plan_p] = ids.reshape(-1)
    return out


def _listed_search_cuda(pts, cent_t, order, counts, lbs, plan_p, slim, tighten):
    name = "listed_search"
    dev = pts.device
    n = pts.shape[0]
    _check_points(name, pts)
    if not pts.is_contiguous():
        raise ValueError(f"{name}: pts must be contiguous")
    rows, n_tiles = order.shape
    n_slots = cent_t.shape[1]
    _check_table(name, "cent_t", cent_t, (3, n_slots), torch.float32, dev)
    _check_table(name, "order", order, (n // plan_p, n_tiles), torch.int32, dev)
    _check_table(name, "counts", counts, (rows,), torch.int32, dev)
    _check_table(name, "lbs", lbs, (rows, n_tiles), torch.float32, dev)
    if n_tiles * _BLOCK_F_LISTED > n_slots:
        raise ValueError(f"{name}: {n_tiles} tiles do not fit {n_slots} centroid slots")
    if cent_t.data_ptr() % 16 or n_slots % 4:
        raise ValueError(f"{name}: cent_t rows must be 16-byte aligned (the kernel copies 16 bytes at a time)")
    if n_tiles > _LISTED_MAX_TILES:
        raise ValueError(f"{name}: {n_tiles} tiles exceed the {_LISTED_MAX_TILES} a block lists in shared memory")
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    row_of_rank = torch.empty((rows,), dtype=torch.int32, device=dev)  # the kernel's row order
    args = (pts.data_ptr(), cent_t.data_ptr(), order.data_ptr(), counts.data_ptr(),
            lbs.data_ptr(), row_of_rank.data_ptr(), out.data_ptr(), n, plan_p, n_tiles, n_slots)
    with torch.cuda.device(dev):
        if slim:
            LISTED_SLIM_KERNEL.launch(*args, stream_ptr(dev))
        else:
            LISTED_KERNEL.launch(*args, int(bool(tighten)), stream_ptr(dev))
    return out


def listed_search(pts, cent_t, order, counts, lbs, plan_p: int,
                  slim: bool = False, tighten: bool = False) -> torch.Tensor:
    """Walk a visit plan (`listed_plan`): (N,) int32 slot ids. N is a
    multiple of plan_p, plan_p of `LISTED_BLOCK_P`. CPU tensors take the
    plain version; CUDA tensors launch the wide or the slim kernel (or
    raise). The slim kernel has no threshold: ``tighten`` is ignored."""
    if plan_p % LISTED_BLOCK_P or pts.shape[0] % plan_p:
        raise ValueError(
            f"listed_search: plan_p={plan_p} must be a multiple of {LISTED_BLOCK_P} "
            f"and divide n={pts.shape[0]}"
        )
    if pts.device.type == "cpu":
        return listed_search_plain(pts, cent_t, order, counts, lbs, plan_p, slim, tighten)
    if pts.device.type != "cuda":
        raise ValueError(f"listed_search: unsupported device {pts.device}")
    return _listed_search_cuda(pts, cent_t, order, counts, lbs, plan_p, slim, tighten)


def pruned_search_listed(
    pts_sorted: torch.Tensor,
    centroids: torch.Tensor,
    tile_table: torch.Tensor,
    block_p: int = _BLOCK_P_LISTED,
    plan_p: int | None = None,
    tighten: bool | None = None,
    slim: bool | None = None,
    return_slots: bool = False,
    tables: tuple | None = None,
) -> torch.Tensor:
    """List-driven exact nearest-face search for spatially coherent points:
    pts_sorted (N, 3), centroids (F, 3), tile_table (T, 128) int32
    (`build_face_tiles`) -> (N,) int32 face ids.

    return_slots=True returns tile-slot ids (tile * 128 + lane) instead:
    callers that only gather per-face rows permute their tables once by
    `slot_perm_from_tiles` and skip the translation. Ties are the same
    either way. tables: optional precomputed `listed_tables(centroids,
    tile_table)`; the results are identical. plan_p, tighten, slim: None
    reads `DSNERF_KNN_PLAN_P` / `DSNERF_KNN_TIGHTEN` / `DSNERF_KNN_SLIM`, else
    the module defaults. The tail is padded to block_p by repeating the last
    point; plan_p is clamped to block_p and must divide it."""
    _check_points("pruned_search_listed", pts_sorted)
    if plan_p is None:
        plan_p = _env_int("DSNERF_KNN_PLAN_P", _PLAN_P_LISTED, _BLOCK_P_LISTED)
    if tighten is None:
        tighten = _env_bool("DSNERF_KNN_TIGHTEN", _TIGHTEN_LISTED)
    if slim is None:
        slim = _env_bool("DSNERF_KNN_SLIM", _SLIM_LISTED)
    plan_p = min(plan_p, block_p)
    if block_p % plan_p:
        raise ValueError(f"pruned_search_listed: plan_p={plan_p} must divide block_p={block_p}")
    if tile_table.shape[1] != _BLOCK_F_LISTED:
        raise ValueError(
            f"pruned_search_listed: tiles of {tile_table.shape[1]} slots, expected {_BLOCK_F_LISTED}"
        )
    if tables is None:
        tables = listed_tables(centroids, tile_table)
    cent_t, tile_c, tile_r, perm_pad = tables
    for t in (tile_table, *tables):
        if t.device != pts_sorted.device:
            raise ValueError(
                f"pruned_search_listed: a table is on {t.device}, the points on {pts_sorted.device}"
            )
    n = pts_sorted.shape[0]
    pts_p = _pad_edge(pts_sorted, block_p)
    order, counts, lbs = listed_plan(pts_p, tile_c, tile_r, tile_table.shape[0], plan_p)
    slots = listed_search(pts_p, cent_t, order, counts, lbs, plan_p, slim, tighten)[:n]
    if return_slots:
        return slots
    return perm_pad[slots.long()]


# --------------------------------------------------------------------------
# pruned search
# --------------------------------------------------------------------------
def pruned_tables(centroids: torch.Tensor, face_perm: torch.Tensor, block_f: int = _BLOCK_F):
    """The pruned search's tables for one centroid set in kd order:
    (cent_t (3, F_pad) padded at 1e15, tile_c (8, T_pad) rows 0:3 the tiles'
    mean centers, tile_r (8, T_pad) row 0 their radii, n_tiles)."""
    f = centroids.shape[0]
    dev = centroids.device
    f_pad = -(-f // block_f) * block_f
    n_tiles = f_pad // block_f
    cent_perm = centroids.to(torch.float32)[face_perm.long()]
    cent_full = torch.full((f_pad, 3), _PAD, dtype=torch.float32, device=dev)
    cent_full[:f] = cent_perm
    cent_t = cent_full.T.contiguous()
    cent_full = cent_full.reshape(n_tiles, block_f, 3)
    t_valid = (torch.arange(f_pad, device=dev) < f).reshape(n_tiles, block_f)
    counts = t_valid.sum(-1).clamp_min(1)[:, None]
    centers = torch.where(t_valid[..., None], cent_full, 0.0).sum(1) / counts
    r2 = ((cent_full - centers[:, None]) ** 2).sum(-1)
    radius = torch.sqrt(torch.where(t_valid, r2, 0.0).amax(-1))

    t_pad = -(-n_tiles // 128) * 128
    tile_c = torch.full((8, t_pad), _PAD, dtype=torch.float32, device=dev)
    tile_c[0:3, :n_tiles] = centers.T
    tile_r = torch.zeros((8, t_pad), dtype=torch.float32, device=dev)
    tile_r[0, :n_tiles] = radius
    return cent_t, tile_c, tile_r, n_tiles


def pruned_search_plain(pts, cent_t, tile_c, tile_r, n_tiles: int, block_p: int,
                        block_f: int = _BLOCK_F, tighten: int = _TIGHTEN,
                        with_visits: bool = False):
    """The pruned kernel's function in plain PyTorch: (N,) int32 kd-order
    ids (and, with_visits, the tiles visited per block), N a multiple of
    block_p. Every block at once: its sphere (bounding-box midpoint, farthest
    point), the tiles' lower bounds, the seed tile, then the tiles in index
    order under the tightened threshold, with a (points, block_f) running
    minimum per lane decoded at the end."""
    n = pts.shape[0]
    dev = pts.device
    blocks = n // block_p
    cents = cent_t.T.reshape(n_tiles, block_f, 3)
    tc = tile_c[0:3, :n_tiles].T                                # (T, 3)
    tr = tile_r[0, :n_tiles]
    lane = torch.arange(block_f, dtype=torch.int32, device=dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    visits = torch.empty((blocks,), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_PAIRS // (block_p * block_f))
    for b0 in range(0, blocks, step):
        b1 = min(blocks, b0 + step)
        p = pts[b0 * block_p:b1 * block_p].reshape(b1 - b0, block_p, 3)
        ctr = 0.5 * (p.amin(1) + p.amax(1))                     # (b, 3)
        rho = torch.sqrt(_d2(p, ctr[:, None]).amax(1))          # (b,)
        lb = (torch.sqrt(_d2(tc[None], ctr[:, None])) - tr) - rho[:, None]
        t0 = _first_argmin(lb)                                  # (b,)
        pp = p[:, :, None]                                      # (b, P, 1, 3)
        best = _d2(pp, cents[t0][:, None])                      # (b, P, BF)
        ids = t0.to(torch.int32)[:, None, None].expand_as(best).contiguous()
        thresh = torch.sqrt(best.amin(-1).amax(-1))             # (b,)
        seen = torch.ones_like(t0, dtype=torch.int32)
        for t in range(n_tiles):
            act = (t0 != t) & (lb[:, t] < thresh)
            if not bool(act.any()):
                continue
            d2 = _d2(pp, cents[t])
            m = act[:, None, None] & (d2 < best)
            best = torch.where(m, d2, best)
            ids = torch.where(m, t, ids)
            seen += act
            if tighten > 0 and (t + 1) % tighten == 0:
                thresh = torch.where(act, torch.sqrt(best.amin(-1).amax(-1)), thresh)
        pmin = best.amin(-1, keepdim=True)
        ids = torch.where(best <= pmin, ids * block_f + lane, _NO_ID).amin(-1)
        out[b0 * block_p:b1 * block_p] = ids.reshape(-1)
        visits[b0:b1] = seen
    return (out, visits) if with_visits else out


def _pruned_search_cuda(pts, cent_t, tile_c, tile_r, n_tiles, block_p, block_f, tighten):
    name = "pruned_search"
    dev = pts.device
    n = pts.shape[0]
    _check_points(name, pts)
    if not pts.is_contiguous():
        raise ValueError(f"{name}: pts must be contiguous")
    if block_f != _BLOCK_F:
        raise ValueError(f"{name}: the kernel's tiles hold {_BLOCK_F} faces, got block_f={block_f}")
    if block_p % 32 or not 32 <= block_p <= 1024:
        raise ValueError(f"{name}: block_p={block_p} must be a multiple of 32 in [32, 1024]")
    if not 1 <= n_tiles <= _PRUNED_MAX_TILES:
        raise ValueError(f"{name}: {n_tiles} tiles, the kernel takes 1..{_PRUNED_MAX_TILES}")
    t_pad = tile_c.shape[1]
    _check_table(name, "cent_t", cent_t, (3, n_tiles * block_f), torch.float32, dev)
    _check_table(name, "tile_c", tile_c, (8, t_pad), torch.float32, dev)
    _check_table(name, "tile_r", tile_r, (8, t_pad), torch.float32, dev)
    if t_pad < n_tiles:
        raise ValueError(f"{name}: tile tables of {t_pad} columns for {n_tiles} tiles")
    if cent_t.data_ptr() % 16:
        raise ValueError(f"{name}: cent_t must be 16-byte aligned (the kernel copies 16 bytes at a time)")
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    launch_pruned(pts, cent_t, tile_c, tile_r, n_tiles, out, block_p, tighten)
    return out


def launch_pruned(pts, cent_t, tile_c, tile_r, n_tiles: int, out, block_p: int = _BLOCK_P,
                  tighten: int = _TIGHTEN) -> None:
    """One bare launch of the pruned kernel into a preallocated ``out``,
    without the wrapper's checks (`pruned_search` makes them)."""
    dev = pts.device
    with torch.cuda.device(dev):
        PRUNED_KERNEL.launch(
            pts.data_ptr(), cent_t.data_ptr(), tile_c.data_ptr(), tile_r.data_ptr(),
            out.data_ptr(), pts.shape[0], block_p, n_tiles, n_tiles * _BLOCK_F, tile_c.shape[1],
            int(tighten), stream_ptr(dev),
        )


def pruned_search(pts, cent_t, tile_c, tile_r, n_tiles: int, block_p: int = _BLOCK_P,
                  block_f: int = _BLOCK_F, tighten: int = _TIGHTEN) -> torch.Tensor:
    """The pruned search over `pruned_tables`: (N,) int32 kd-order ids, N a
    multiple of block_p. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if pts.shape[0] % block_p:
        raise ValueError(f"pruned_search: n={pts.shape[0]} is not a multiple of block_p={block_p}")
    if pts.device.type == "cpu":
        return pruned_search_plain(pts, cent_t, tile_c, tile_r, n_tiles, block_p, block_f, tighten)
    if pts.device.type != "cuda":
        raise ValueError(f"pruned_search: unsupported device {pts.device}")
    return _pruned_search_cuda(pts, cent_t, tile_c, tile_r, n_tiles, block_p, block_f, tighten)


def pruned_search_presorted(
    pts_sorted: torch.Tensor,
    centroids: torch.Tensor,
    face_perm: torch.Tensor,
    block_p: int = _BLOCK_P,
    block_f: int = _BLOCK_F,
    tighten: int = _TIGHTEN,
) -> torch.Tensor:
    """Sphere-pruned exact search for spatially coherent points: pts_sorted
    (N, 3), centroids (F, 3), face_perm (F,) the kd order of the faces ->
    (N,) int32 face ids. The caller owns the sort."""
    _check_points("pruned_search_presorted", pts_sorted)
    n = pts_sorted.shape[0]
    cent_t, tile_c, tile_r, n_tiles = pruned_tables(centroids, face_perm, block_f)
    local = pruned_search(
        _pad_edge(pts_sorted, block_p), cent_t, tile_c, tile_r, n_tiles, block_p, block_f, tighten
    )[:n]
    return face_perm[local.long()].to(torch.int32)


def morton_order(pts: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts (N, 3) points along a 30-bit Morton curve of
    their bounding box (stable)."""
    mn = pts.amin(0)
    span = (pts.amax(0) - mn).clamp_min(1e-9)
    q = ((pts - mn) / span * 1023.0).clamp(0, 1023).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.argsort(code, stable=True)


def nearest_face_pruned(pts: torch.Tensor, centroids: torch.Tensor,
                        face_perm: torch.Tensor) -> torch.Tensor:
    """The pruned search for points in any order: Morton-sorts them, searches,
    and returns (N,) int32 face ids in the callers' order."""
    order = morton_order(pts)
    ids = pruned_search_presorted(pts[order].contiguous(), centroids, face_perm)
    out = torch.empty_like(ids)
    out[order] = ids
    return out
