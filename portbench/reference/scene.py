"""The benchmark's scene generator, frozen: a capsule avatar at SMPL's sizes
(V=6890, F=13,776) on a ring of pinhole cameras, in numpy.

Everything a cell feeds the program and the reference comes from here and
from ``--seed``: the canonical and posed meshes of each frame, the joint
rotations, the cameras, ground-truth images splatted from a smooth emission
field, and the rays of a train item or of a whole image. The same seed
gives the same items, whatever thread or order asks for them.

The generator follows the port's synthetic scene (capsule mesh, z-shear
pose, look-at ring cameras, vertex splatting, the ZJU convention of
un-normalised ray directions with near/far from the body's box inflated by
1 cm) but is a copy of its own: a later change to the program cannot move
the benchmark's inputs.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


def rng(*keys: int) -> np.random.Generator:
    """A generator that depends on the keys alone (any whole numbers)."""
    return np.random.default_rng([int(k) & _MASK64 for k in keys])


def capsule_mesh(n_theta: int = 82, n_phi: int = 84, radius: float = 0.3,
                 half_len: float = 0.6) -> tuple[np.ndarray, np.ndarray]:
    """Closed capsule along z: V = n_theta * n_phi + 2 vertices, F = 2V - 4
    faces (6890 / 13,776 at the defaults). float32 (V, 3), int32 (F, 3)."""
    thetas = np.linspace(0, np.pi, n_theta + 2)[1:-1]
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    x = radius * np.sin(tt) * np.cos(pp)
    y = radius * np.sin(tt) * np.sin(pp)
    z = radius * np.cos(tt) + np.sign(np.cos(tt)) * half_len
    ring = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 0.0, radius + half_len]], ring,
                            [[0.0, 0.0, -radius - half_len]]]).astype(np.float32)

    def vid(i, j):
        return 1 + i * n_phi + (j % n_phi)

    faces = [[0, vid(0, j), vid(0, j + 1)] for j in range(n_phi)]
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a, b, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)
            faces += [[a, b, c], [b, d, c]]
    last = len(verts) - 1
    faces += [[last, vid(n_theta - 1, j + 1), vid(n_theta - 1, j)] for j in range(n_phi)]
    return verts, np.asarray(faces, np.int32)


def posed_frame(verts_cano: np.ndarray, seed: int, frame: int, n_frames: int):
    """The posed mesh (V, 3) float32 and the 24 joint rotation vectors
    (24, 3) float32 of one frame: a z-dependent shear that sways with the
    frame, a small drift, and joint rotations drawn from the seed."""
    phase = 2.0 * np.pi * frame / max(n_frames, 1)
    out = verts_cano.astype(np.float64)
    out[:, 0] += (0.35 + 0.15 * np.sin(phase)) * np.tanh(2.0 * verts_cano[:, 2])
    out += np.array([0.1 + 0.03 * np.cos(phase), -0.05, 0.02])
    poses = 0.1 * rng(seed, 1, frame).standard_normal((24, 3))
    return out.astype(np.float32), poses.astype(np.float32)


def body_bounds(verts_world: np.ndarray) -> np.ndarray:
    """The world box of the body, 10 cm beyond its vertices: (2, 3)."""
    return np.stack([verts_world.min(0) - 0.1, verts_world.max(0) + 0.1]).astype(np.float32)


def ring_camera(view: int, n_ring: int, size: int, dist: float, height: float,
                focal_scale: float):
    """(K, R, T) of camera ``view`` of ``n_ring`` evenly spaced on a circle
    of radius ``dist`` at ``height``, looking at the origin; world to
    camera x = R p + T, z forward, square images of ``size`` pixels."""
    angle = 2.0 * np.pi * view / n_ring
    eye = np.array([dist * np.cos(angle), dist * np.sin(angle), height])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    T = (-R @ eye)[:, None]
    f = focal_scale * size
    K = np.array([[f, 0.0, size / 2.0], [0.0, f, size / 2.0], [0.0, 0.0, 1.0]])
    return K, R, T


def pixel_rays(coords: np.ndarray, K, R, T) -> tuple[np.ndarray, np.ndarray]:
    """World rays through pixels ``coords`` (N, 2) as (row, col): origin at
    the camera centre and un-normalised direction (the ZJU convention: a
    sample at depth z lies at o + z d). float32 (N, 3) each."""
    centre = -(R.T @ T).ravel()
    pix = np.stack([coords[:, 1], coords[:, 0], np.ones(len(coords))], axis=1).astype(np.float64)
    cam = pix @ np.linalg.inv(K).T
    world = (cam - T.ravel()) @ R
    ray_d = world - centre
    ray_o = np.broadcast_to(centre, ray_d.shape)
    return np.ascontiguousarray(ray_o, np.float32), np.ascontiguousarray(ray_d, np.float32)


def box_near_far(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """Slab test against the box inflated by 1 cm: (near, far, hit) with
    near/far in units of the direction's length, for every ray."""
    lo = bounds[0].astype(np.float64) - 0.01
    hi = bounds[1].astype(np.float64) + 0.01
    d = ray_d.astype(np.float64)
    d = np.where(np.abs(d) < 1e-12, 1e-12, d)
    t1 = (lo - ray_o) / d
    t2 = (hi - ray_o) / d
    near = np.minimum(t1, t2).max(axis=1)
    far = np.maximum(t1, t2).min(axis=1)
    hit = (near < far) & (far > 0)
    return np.maximum(near, 0.0).astype(np.float32), far.astype(np.float32), hit


def emission(verts_cano: np.ndarray) -> np.ndarray:
    """Ground-truth colour of each canonical vertex: a smooth sine field."""
    return (0.5 + 0.5 * np.sin(3.0 * verts_cano + np.array([0.0, 2.1, 4.2]))).astype(np.float32)


def splat_image(verts_world, colors, K, R, T, size: int, radius: int = 2):
    """z-buffered 5x5 splats of the vertex colours: (img (H, W, 3) float32,
    mask (H, W) uint8)."""
    cam = verts_world @ R.T + T.ravel()
    z = cam[:, 2]
    pix = cam @ K.T
    pix = (pix[:, :2] / pix[:, 2:]).astype(np.int64)
    img = np.zeros((size, size, 3), np.float32)
    zbuf = np.full((size, size), np.inf)
    order = np.argsort(-z)
    ys, xs, zs, cs = pix[order, 1], pix[order, 0], z[order], colors[order]
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            yy = np.clip(ys + dy, 0, size - 1)
            xx = np.clip(xs + dx, 0, size - 1)
            win = zs <= zbuf[yy, xx]
            img[yy[win], xx[win]] = cs[win]
            zbuf[yy[win], xx[win]] = zs[win]
    mask = (zbuf < np.inf).astype(np.uint8)
    return img * mask[..., None], mask


def tile_order(coord: np.ndarray) -> np.ndarray:
    """Rays in 16x16 pixel-tile order (row-major tiles, stable): the order
    in which a train batch's rays are laid out."""
    n_tile_cols = int(coord[:, 1].max()) // 16 + 1
    key = (coord[:, 0] // 16) * (n_tile_cols * 16) + (coord[:, 1] // 16) * 16 + (coord[:, 0] % 16)
    return np.argsort(key, kind="stable")


class CapsuleScene:
    """The frames and cameras of one cell, from the seed and the traffic's
    scene parameters (``scene`` block of a traffic file)."""

    def __init__(self, seed: int, scene: dict):
        self.seed = int(seed)
        self.p = dict(scene)
        self.verts_cano, self.faces = capsule_mesh()
        self.colors = emission(self.verts_cano)

    def frame(self, frame: int):
        return posed_frame(self.verts_cano, self.seed, frame, self.p["n_frames"])

    def camera(self, view: int):
        p = self.p
        return ring_camera(view, p["n_ring"], p["size"], p["dist"], p["height"], p["focal_scale"])

    def _view(self, frame: int, view: int) -> dict:
        verts, poses = self.frame(frame)
        K, R, T = self.camera(view)
        img, mask = splat_image(verts, self.colors, K, R, T, self.p["size"])
        return {"verts": verts, "poses": poses, "K": K, "R": R, "T": T, "img": img,
                "mask": mask, "bounds": body_bounds(verts)}

    def _box_rect(self, v: dict) -> tuple[int, int, int, int]:
        """The pixel rectangle (rows r0..r1, cols c0..c1, inclusive) that
        holds the box's projection: every pixel whose ray hits it."""
        lo, hi = v["bounds"][0] - 0.011, v["bounds"][1] + 0.011
        corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])])
        cam = corners @ v["R"].T + v["T"].ravel()
        pix = cam @ v["K"].T
        pix = pix[:, :2] / pix[:, 2:]
        size = self.p["size"]
        c0, r0 = np.clip(np.floor(pix.min(0)).astype(int) - 1, 0, size - 1)
        c1, r1 = np.clip(np.ceil(pix.max(0)).astype(int) + 1, 0, size - 1)
        return int(r0), int(r1), int(c0), int(c1)

    def _box_pixels(self, v: dict) -> tuple:
        """Every pixel whose ray hits the box, in scanline order: (coords
        (n, 2) as (row, col), the (H*W,) hit mask, ray_o, ray_d, near, far)."""
        size = self.p["size"]
        r0, r1, c0, c1 = self._box_rect(v)
        rows, cols = np.meshgrid(np.arange(r0, r1 + 1), np.arange(c0, c1 + 1), indexing="ij")
        coords = np.stack([rows.ravel(), cols.ravel()], axis=1)
        o, d = pixel_rays(coords, v["K"], v["R"], v["T"])
        near, far, hit = box_near_far(v["bounds"], o, d)
        mask = np.zeros((size, size), bool)
        mask[coords[hit, 0], coords[hit, 1]] = True
        return coords[hit], mask.ravel(), o[hit], d[hit], near[hit], far[hit]

    def train_item(self, frame: int, view: int, nrays: int, epoch: int, index: int,
                   body_share: float) -> dict:
        """``nrays`` rays of one image, all hitting the box: a share on the
        body's mask (where its ray hits the box), the rest anywhere in the box (drawn in its projected
        rectangle, those that miss it drawn again), in tile order."""
        v = self._view(frame, view)
        body = np.argwhere(v["mask"] != 0)
        body = body[box_near_far(v["bounds"], *pixel_rays(body, v["K"], v["R"], v["T"]))[2]]
        g = rng(self.seed, 2, epoch, index)
        n_body = int(nrays * body_share)
        parts = [body[g.integers(0, len(body), n_body)]]
        r0, r1, c0, c1 = self._box_rect(v)
        need = nrays - n_body
        while need > 0:
            cand = np.stack([g.integers(r0, r1 + 1, 2 * need), g.integers(c0, c1 + 1, 2 * need)], 1)
            o, d = pixel_rays(cand, v["K"], v["R"], v["T"])
            hit = box_near_far(v["bounds"], o, d)[2]
            parts.append(cand[hit][:need])
            need -= len(parts[-1])
        coord = np.concatenate(parts)
        coord = coord[tile_order(coord)]
        ray_o, ray_d = pixel_rays(coord, v["K"], v["R"], v["T"])
        near, far, hit = box_near_far(v["bounds"], ray_o, ray_d)
        if not hit.all():
            raise AssertionError("train_item: a sampled ray misses the box")
        return {
            "ray_o": ray_o, "ray_d": ray_d, "near": near, "far": far,
            "rgb": v["img"][coord[:, 0], coord[:, 1]],
            "occupancy": v["mask"][coord[:, 0], coord[:, 1]].astype(np.float32),
            "coord": coord, "frame": int(frame), "poses": v["poses"], "xyz": v["verts"],
            "bounds": v["bounds"], "cam_ind": int(view),
        }

    def image_item(self, frame: int, view: int) -> dict:
        """Every ray of one image that hits the box, in scanline order."""
        v = self._view(frame, view)
        coord, hit, ray_o, ray_d, near, far = self._box_pixels(v)
        return {
            "img": v["img"], "mask_at_box": hit, "coord": coord,
            "ray_o": ray_o, "ray_d": ray_d, "near": near, "far": far,
            "frame": int(frame), "poses": v["poses"], "xyz": v["verts"],
            "bounds": v["bounds"], "cam_ind": int(view),
        }
