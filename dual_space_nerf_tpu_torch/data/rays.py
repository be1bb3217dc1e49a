"""Host-side ray generation and importance pixel sampling (numpy), as the
JAX package's `data/rays.py`.

The ZJU and H36M conventions differ and both are kept: ZJU keeps ray_d
un-normalized and `get_near_far_zju` is the reference's slab test over an
AABB inflated by 1 cm, keeping rays that hit it exactly twice; H36M
normalizes ray_d (`sample_rays(normalize_dirs=True)`) and
`get_near_far_h36m` is the standard tmin/tmax slab test. The projected-box mask
of the importance sampler is drawn here without cv2 (the card's machine has
none): `fill_poly` follows `cv2.fillPoly` (8-connected, no sub-pixel shift)
step for step: the edge lines by OpenCV's `clipLine` and Bresenham
iterator, the interior by its fixed-point scanline fill, with the edges
that leave the image taken through their clipped end points. The masks equal
cv2's (OpenCV 5.0) pixel for pixel on the synthetic cameras, whose box
corners project partly outside the image, on polygons inside the image and
on polygons whose vertices lie up to 40 pixels outside it
(`tests/test_torch_port_train.py`).
"""

from __future__ import annotations

import numpy as np


def get_rays(H, W, K, R, T, normalize: bool = False):
    """Per-pixel camera rays in world space: returns (ray_o, ray_d) (H, W, 3)."""
    rays_o = -(R.T @ T).ravel()
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = xy1 @ np.linalg.inv(K).T
    pixel_world = (pixel_camera - T.ravel()) @ R
    rays_d = pixel_world - rays_o[None, None]
    if normalize:
        rays_d = rays_d / np.linalg.norm(rays_d, axis=2, keepdims=True)
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o, rays_d


def get_near_far_zju(bounds, ray_o, ray_d):
    """AABB intersection, ZJU flavor. Returns (near, far, mask_at_box);
    near/far only for the rays in the mask."""
    bounds = bounds + np.array([-0.01, 0.01])[:, None]
    nominator = bounds[None] - ray_o[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        # axis-parallel rays yield inf/nan planes that the box test rejects
        d_intersect = (nominator / ray_d[:, None]).reshape(-1, 6)
        p_intersect = d_intersect[..., None] * ray_d[:, None] + ray_o[:, None]
    mn = bounds.ravel()[:3]
    mx = bounds.ravel()[3:]
    eps = 1e-6
    ok = np.ones(p_intersect.shape[:2], dtype=bool)
    for a in range(3):
        ok &= (p_intersect[..., a] >= mn[a] - eps) & (
            p_intersect[..., a] <= mx[a] + eps
        )
    mask_at_box = ok.sum(-1) == 2
    p_intervals = p_intersect[mask_at_box][ok[mask_at_box]].reshape(-1, 2, 3)
    ro = ray_o[mask_at_box]
    rd = ray_d[mask_at_box]
    norm_ray = np.linalg.norm(rd, axis=1)
    d0 = np.linalg.norm(p_intervals[:, 0] - ro, axis=1) / norm_ray
    d1 = np.linalg.norm(p_intervals[:, 1] - ro, axis=1) / norm_ray
    return np.minimum(d0, d1), np.maximum(d0, d1), mask_at_box


def get_near_far_h36m(bounds, ray_o, ray_d):
    """Slab-test AABB intersection, H36M flavor. Returns (near, far,
    mask_at_box); near/far only for the rays in the mask."""
    norm_d = np.linalg.norm(ray_d, axis=-1, keepdims=True)
    viewdir = ray_d / norm_d
    viewdir[(viewdir < 1e-5) & (viewdir > -1e-10)] = 1e-5
    viewdir[(viewdir > -1e-5) & (viewdir < 1e-10)] = -1e-5
    tmin = (bounds[:1] - ray_o[:1]) / viewdir
    tmax = (bounds[1:2] - ray_o[:1]) / viewdir
    t1 = np.minimum(tmin, tmax)
    t2 = np.maximum(tmin, tmax)
    near = np.max(t1, axis=-1)
    far = np.min(t2, axis=-1)
    mask_at_box = near < far
    near = near[mask_at_box] / norm_d[mask_at_box, 0]
    far = far[mask_at_box] / norm_d[mask_at_box, 0]
    return near, far, mask_at_box


def project(xyz: np.ndarray, K: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """World points (N, 3) -> pixel coords (N, 2)."""
    cam = xyz @ RT[:, :3].T + RT[:, 3:].T
    pix = cam @ K.T
    return pix[:, :2] / pix[:, 2:]


def get_rays_at(coords, K, R, T, normalize: bool = False):
    """Camera rays for (N, 2) pixel coords in (row, col) order: `get_rays`'s
    arithmetic at the sampled pixels only."""
    rays_o = -(R.T @ T).ravel()
    xy1 = np.stack(
        [
            coords[:, 1].astype(np.float32),
            coords[:, 0].astype(np.float32),
            np.ones(len(coords), np.float32),
        ],
        axis=1,
    )
    pixel_camera = xy1 @ np.linalg.inv(K).T
    pixel_world = (pixel_camera - T.ravel()) @ R
    rays_d = pixel_world - rays_o[None]
    if normalize:
        rays_d = rays_d / np.linalg.norm(rays_d, axis=1, keepdims=True)
    return np.broadcast_to(rays_o, rays_d.shape), rays_d


def get_bound_corners(bounds: np.ndarray) -> np.ndarray:
    mn, mx = bounds[0], bounds[1]
    return np.array(
        [
            [mn[0], mn[1], mn[2]], [mn[0], mn[1], mx[2]],
            [mn[0], mx[1], mn[2]], [mn[0], mx[1], mx[2]],
            [mx[0], mn[1], mn[2]], [mx[0], mn[1], mx[2]],
            [mx[0], mx[1], mn[2]], [mx[0], mx[1], mx[2]],
        ]
    )


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's `clipLine` to the image rectangle: (x1, y1, x2, y2, inside),
    the end points as it leaves them (each moved along the line with a
    truncating integer step, the second from the first's clipped position;
    moved part way, or not at all, when nothing is inside) and whether any
    of the line is inside."""
    right, bottom = w - 1, h - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    trunc = lambda v: int(v)  # C's (int64)(double): toward zero
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += trunc(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += trunc(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += trunc(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += trunc(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return x1, y1, x2, y2, (c1 | c2) == 0


def _line8(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    """OpenCV's 8-connected line: clipped to the image first, then walked
    from left to right: count = major + 1 pixels; the minor coordinate steps
    while err = major - 2 minor (then updated by -2 minor, + 2 major on a
    minor step) is negative."""
    h, w = mask.shape
    if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
        x0, y0, x1, y1, inside = _clip_line(w, h, x0, y0, x1, y1)
        if not inside:
            return
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    for _ in range(major + 1):
        if 0 <= x < w and 0 <= y < h:
            mask[y, x] = 1
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if vert:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_poly(mask: np.ndarray, pts: np.ndarray) -> None:
    """`cv2.fillPoly(mask, [pts], 1)` for integer (x, y) vertices: the edge
    lines, then the scanline fill between the edges' fixed-point x (OpenCV
    4.x's `CollectPolyEdges` and `FillEdgeCollection`)."""
    h, w = mask.shape
    edges = []
    x0, y0 = int(pts[-1][0]), int(pts[-1][1])
    for px, py in pts:
        x1, y1 = int(px), int(py)
        _line8(mask, x0, y0, x1, y1)
        # the edge's fixed-point line: where the edge leaves the image,
        # through the x that `clipLine` leaves in its end points (also when
        # nothing is inside), and through their y unless they share one
        c0 = (x0 << _XY_SHIFT, y0)
        c1 = (x1 << _XY_SHIFT, y1)
        if not (all(0 <= v < w for v in (x0, x1)) and all(0 <= v < h for v in (y0, y1))):
            cx0, cy0, cx1, cy1, _ = _clip_line(w, h, x0, y0, x1, y1)
            if cy0 == cy1:
                cy0, cy1 = y0, y1
            c0 = (cx0 << _XY_SHIFT, cy0)
            c1 = (cx1 << _XY_SHIFT, cy1)
        if y0 != y1:
            e = _Edge()
            e.dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            if y0 < y1:
                e.y0, e.y1, e.x = y0, y1, c0[0] + (y0 - c0[1]) * e.dx
            else:
                e.y0, e.y1, e.x = y1, y0, c1[0] + (y1 - c1[1]) * e.dx
            e.next = None
            edges.append(e)
        x0, y0 = x1, y1
    if len(edges) < 2:
        return
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    y_min, y_max = min(e.y0 for e in edges), max(e.y1 for e in edges)
    x_min = min(min(e.x for e in edges), min(ends))
    x_max = max(max(e.x for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << _XY_SHIFT):
        return
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    total = len(edges)
    sentinel = _Edge()
    sentinel.y0 = 1 << 62
    edges.append(sentinel)
    head = _Edge()
    head.next = None
    i, e = 0, edges[0]
    for y in range(e.y0, min(y_max, h)):
        prelast, last, draw = head, head.next, False
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next  # the edge ends at this row
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                prelast.next, e.next = e, last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    a, b = keep_prelast.x, prelast.x
                    lo, hi = (b, a) if a > b else (a, b)
                    xa, xb = (lo + _XY_ONE - 1) >> _XY_SHIFT, hi >> _XY_SHIFT
                    if xa < w and xb >= 0:
                        mask[y, max(xa, 0):min(xb, w - 1) + 1] = 1
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # keep the active edges in x order (OpenCV's bubble sort is stable)
        active = []
        node = head.next
        while node is not None:
            active.append(node)
            node = node.next
        active.sort(key=lambda n: n.x)
        prev = head
        for node in active:
            prev.next = node
            prev = node
        prev.next = None


def get_bound_2d_mask(bounds, K, pose, H, W) -> np.ndarray:
    """The screen-space hull of the 3D AABB, as the JAX package rasters it
    with `cv2.fillPoly` (`data/rays.py:84-93`)."""
    corners_2d = np.round(project(get_bound_corners(bounds), K, pose)).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    for quad in (
        [0, 1, 3, 2, 0], [4, 5, 7, 6, 5], [0, 1, 5, 4, 0],
        [2, 3, 7, 6, 2], [0, 2, 6, 4, 0], [1, 3, 7, 5, 1],
    ):
        fill_poly(mask, corners_2d[quad])
    return mask


class SamplePools:
    """Per-frame static inputs of `sample_rays`: the projected-box mask and
    the body/face/in-box pixel pools (int32), cacheable across epochs."""

    __slots__ = ("bound_mask", "coord_body", "coord_face", "coord_bound")

    def __init__(self, bound_mask, coord_body, coord_face, coord_bound):
        self.bound_mask = bound_mask
        self.coord_body = coord_body
        self.coord_face = coord_face
        self.coord_bound = coord_bound


def build_sample_pools(H, W, K, R, T, bounds, mask=None, face_mask=None, coords=True):
    """`SamplePools` of one frame; coords=False builds only the box mask."""
    pose = np.concatenate([R, T], axis=1)
    bound_mask = get_bound_2d_mask(bounds, K, pose, H, W)
    if not coords:
        return SamplePools(bound_mask, None, None, None)
    coord_body = np.argwhere(mask != 0).astype(np.int32) if mask is not None else None
    coord_face = (np.argwhere(face_mask == 2).astype(np.int32)
                  if face_mask is not None else np.zeros((0, 2), np.int32))
    coord_bound = np.argwhere(bound_mask == 1).astype(np.int32)
    return SamplePools(bound_mask, coord_body, coord_face, coord_bound)


def sample_rays(img, K, R, T, bounds, mask=None, nrays=500, *, face_mask=None,
                rng: np.random.Generator | None = None, body_ratio=0.6, face_ratio=0.05,
                normalize_dirs=False, near_far=get_near_far_zju,
                pools: SamplePools | None = None):
    """Rays of the image that hit the AABB.

    nrays > 0: importance-sample until exactly nrays box-hitting rays are
    collected, 60% on the body, 5% on the face, the rest inside the
    projected box, drawing from ``rng`` (the JAX package's `sample_rays`
    draw for draw). nrays <= 0: every ray that hits the box.
    Returns (rgb, ray_o, ray_d, near, far, coord, mask_at_box, bound_mask)."""
    rng = rng or np.random.default_rng()
    H, W = img.shape[:2]
    if pools is None:
        pools = build_sample_pools(H, W, K, R, T, bounds, mask=mask, face_mask=face_mask,
                                   coords=nrays > 0)
    bound_mask = pools.bound_mask
    if nrays <= 0:
        ray_o_all, ray_d_all = get_rays(H, W, K, R, T, normalize=normalize_dirs)
        rgb = img.reshape(-1, 3).astype(np.float32)
        ray_o = ray_o_all.reshape(-1, 3).astype(np.float32)
        ray_d = ray_d_all.reshape(-1, 3).astype(np.float32)
        near, far, mask_at_box = near_far(bounds, ray_o, ray_d)
        coord = np.argwhere(mask_at_box.reshape(H, W))
        return (rgb[mask_at_box], ray_o[mask_at_box], ray_d[mask_at_box],
                near.astype(np.float32), far.astype(np.float32), coord, mask_at_box, bound_mask)

    nsampled = 0
    outs = {k: [] for k in ("ray_o", "ray_d", "rgb", "near", "far", "coord", "mab")}
    while nsampled < nrays:
        n_body = int((nrays - nsampled) * body_ratio)
        n_face = int((nrays - nsampled) * face_ratio)
        n_rand = (nrays - nsampled) - n_body - n_face
        parts = []
        if pools.coord_body is not None and len(pools.coord_body):
            parts.append(pools.coord_body[rng.integers(0, len(pools.coord_body), n_body)])
        if len(pools.coord_face) > 0:
            parts.append(pools.coord_face[rng.integers(0, len(pools.coord_face), n_face)])
        parts.append(pools.coord_bound[rng.integers(0, len(pools.coord_bound), n_rand)])
        coord = np.concatenate(parts, axis=0)
        ro, rd = get_rays_at(coord, K, R, T, normalize=normalize_dirs)
        rgb = img[coord[:, 0], coord[:, 1]]
        near, far, mab = near_far(bounds, ro, rd)
        outs["ray_o"].append(ro[mab])
        outs["ray_d"].append(rd[mab])
        outs["rgb"].append(rgb[mab])
        outs["near"].append(near)
        outs["far"].append(far)
        outs["coord"].append(coord[mab])
        outs["mab"].append(mab[mab])
        nsampled += len(near)
    cat = lambda k: np.concatenate(outs[k])
    return (cat("rgb").astype(np.float32), cat("ray_o").astype(np.float32),
            cat("ray_d").astype(np.float32), cat("near").astype(np.float32),
            cat("far").astype(np.float32), cat("coord"), cat("mab"), bound_mask)
