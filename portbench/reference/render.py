"""The dual-space render of a batch of rays in plain PyTorch, float32.

Per ray: near/far tightened to the union of 5 cm spheres around the posed
vertices (GG sampling); 64 depths between them (stratified by the given
uniforms in training); each sample's nearest posed face by centroid
distance; the sample carried to the canonical mesh through that face
(barycentric coordinates and signed height); SpaceNet's density, essence
and density normal there; the normal carried back to the posed mesh through
the nearest canonical face (or, with face reuse, the posed search's face);
the lighting MLP; alpha compositing with zero density where the sample
lies too far off its face.

With ``shade_topk`` K > 0 only the K samples of a ray with the largest
compositing weights (ties to the earlier sample) get the colour chain, and
every other sample takes the colour of the nearest selected sample of its
ray (ties to the earlier of the K): the production configuration.

With ``n_fine`` > 0 (``FINE_RAY_SAMPLING``) the hierarchical pass of NeRF
(arXiv:2003.08934, section 5.2) follows: ``n_fine`` more depths per ray
drawn by inverse transform from the coarse pass's weights, and the whole
render again (`render_z`) on the sorted union of both sets of depths.
Where this departs from the published code:

- upstream's fine path does not run (its ``can_render.py`` fails on it), so
  the pass is written from NeRF's equations;
- one set of networks serves both passes, as in the program: upstream's
  ``SAME_SPACENET`` option (a second SpaceNet for the fine pass) is read
  by neither.

Nothing here comes from the program: searches are brute force over every
face, slice by slice.
"""

from __future__ import annotations

import dataclasses

import torch

from . import networks as nets

# samples x faces per slice of the brute-force search, and samples x
# vertices per slice of the sphere test
_SEARCH_PAIRS = 1 << 25
_GG_PAIRS = 1 << 24


@dataclasses.dataclass(frozen=True)
class Settings:
    n_samples: int = 64
    n_fine: int = 0
    shade_topk: int = 0
    reuse_warp_faces: bool = False
    gg_gamma: float = 0.05
    raw_noise_std: float = 1.0

    @classmethod
    def from_model_block(cls, model: dict) -> "Settings":
        """From a configuration's MODEL block (the published keys)."""
        if model.get("sample_points_mode") != "GG":
            raise ValueError("reference: GG sampling only")
        return cls(n_samples=int(model["COARSE_RAY_SAMPLING"]),
                   n_fine=max(int(model.get("FINE_RAY_SAMPLING", -1)), 0),
                   shade_topk=max(int(model.get("SHADE_TOPK", 0)), 0),
                   reuse_warp_faces=bool(model.get("REUSE_WARP_FACES", False)),
                   raw_noise_std=float(model.get("raw_noise_std", 1.0)))


def dot3(a, b):
    """(ax bx + ay by) + az bz over the last axis, each operation rounded
    once, left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def near_far_spheres(ray_o, ray_d, near, far, verts, gamma: float):
    """Each ray's depths where it passes within ``gamma`` of some vertex
    (in units of |ray_d|); rays that pass near none keep near/far.

    The squared distance to a vertex is |v - o|^2 - t^2 with t the depth
    along the unit ray: a difference of two numbers near (2.5 m)^2, whose
    rounding moves near/far of a ray that grazes a sphere by up to ~1e-4
    of their value; the sums are therefore taken in one stated order."""
    r = ray_o.shape[0]
    norm = torch.sqrt(dot3(ray_d, ray_d))
    unit = ray_d / norm[:, None]
    lo = torch.full((r,), float("inf"), device=ray_o.device)
    hi = torch.full((r,), float("-inf"), device=ray_o.device)
    step = max(1, _GG_PAIRS // verts.shape[0])
    for a in range(0, r, step):
        rel = verts[None] - ray_o[a:a + step, None]                   # (r, V, 3)
        t = dot3(rel, unit[a:a + step, None])                         # along the ray
        d2 = dot3(rel, rel) - t * t                                   # squared distance
        inside = d2 < gamma * gamma
        half = torch.sqrt(torch.clamp(gamma * gamma - d2, min=0.0))
        lo[a:a + step] = torch.where(inside, t - half, float("inf")).amin(1)
        hi[a:a + step] = torch.where(inside, t + half, float("-inf")).amax(1)
    lo, hi = lo / norm, hi / norm
    hit = torch.isfinite(lo) & (lo < hi)
    return torch.where(hit, lo, near), torch.where(hit, hi, far)


def depths(near, far, n: int, u=None):
    """n evenly spaced depths per ray, or with uniforms u (r, n) one drawn
    in each of the n strata between the midpoints."""
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    z = near[:, None] * (1.0 - t) + far[:, None] * t
    if u is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], dim=-1)
    lower = torch.cat([z[:, :1], mids], dim=-1)
    return lower + (upper - lower) * u


def nearest_face(pts, centroids) -> torch.Tensor:
    """Index of the nearest centroid of each point (first on a tie)."""
    out = torch.empty(pts.shape[0], dtype=torch.long, device=pts.device)
    step = max(1, _SEARCH_PAIRS // centroids.shape[0])
    for a in range(0, pts.shape[0], step):
        diff = pts[a:a + step, None, :] - centroids[None]
        out[a:a + step] = dot3(diff, diff).argmin(1)
    return out


def _frame(tri):
    """Unit normal and the two edges from the first corner, of triangles
    (n, 3, 3)."""
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = torch.linalg.cross(e1, e2, dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12), e1, e2


def to_face(p, tri):
    """(u, v, h): p = tri0 + u (tri2 - tri0) + v (tri1 - tri0) + h n."""
    n, e1, e2 = _frame(tri)
    h = ((p - tri[:, 0]) * n).sum(-1)
    q = p - h[:, None] * n - tri[:, 0]
    d00, d01, d11 = (e2 * e2).sum(-1), (e2 * e1).sum(-1), (e1 * e1).sum(-1)
    d02, d12 = (e2 * q).sum(-1), (e1 * q).sum(-1)
    inv = 1.0 / (d00 * d11 - d01 * d01)
    return (d11 * d02 - d01 * d12) * inv, (d00 * d12 - d01 * d02) * inv, h


def from_face(u, v, h, tri):
    n, e1, e2 = _frame(tri)
    return tri[:, 0] + u[:, None] * e2 + v[:, None] * e1 + h[:, None] * n


def off_face(u, v, h):
    """Samples that lie too far off their face, which get no density."""
    bad = lambda x: (x < -4.0) | (x > 5.0)
    return bad(u) | bad(v) | (h.abs() > 0.1)


def _unit(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-24)


def composite(rgb, sigma, z, ray_d, noise=None):
    """Volume rendering: (colour (r, 3), depth (r,), acc (r,), weights (r, S))."""
    dist = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    dist = dist * torch.linalg.norm(ray_d, dim=-1, keepdim=True)
    if noise is not None:
        sigma = sigma + noise
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dist)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)
    wts = alpha * trans[:, :-1]
    return (wts[..., None] * rgb).sum(1), (wts * z).sum(1), wts.sum(1), wts


def _color_chain(w, s: Settings, pts_w, dir_w, fw, mesh, code, pose_feat, train: bool):
    """Density, colour and the off-face mask of points with known posed faces."""
    faces, vw, vc, cents_c = mesh
    tri_w, tri_c = vw[faces[fw]], vc[faces[fw]]
    u, v, h = to_face(pts_w, tri_w)
    pts_c = from_face(u, v, h, tri_c)
    fc = fw if s.reuse_warp_faces else nearest_face(pts_c, cents_c)
    sigma, ess, normal_c = nets.color_pass(w, pts_c, code, pose_feat, create_graph=train)
    t_c, t_w = vc[faces[fc]], vw[faces[fc]]
    u0, v0, h0 = to_face(pts_c, t_c)
    u1, v1, h1 = to_face(pts_c + normal_c, t_c)
    normal_w = _unit(from_face(u1, v1, h1, t_w) - from_face(u0, v0, h0, t_w))
    return sigma, nets.lighting(w, normal_w, pts_w, dir_w, ess), off_face(u, v, h)


def importance_depths(z, weights, n: int, u=None):
    """``n`` more depths per ray from the coarse pass's depths z (r, S) and
    compositing weights (r, S), by inverse transform sampling (NeRF,
    section 5.2): the edges are the midpoints of z, the interval between
    two edges has the weight of the sample inside it (``weights[:, 1:-1]``)
    plus 1e-5, and the i-th of the n depths lies where the CDF reaches
    (i + u_i) / n, with u_i = 1/2 at eval or the given uniforms u (r, n) in
    training. No gradient flows through them."""
    z, weights = z.detach(), weights.detach()
    r = z.shape[0]
    edges = 0.5 * (z[:, 1:] + z[:, :-1])                                     # (r, S-1)
    mass = weights[:, 1:-1] + 1e-5                                          # (r, S-2)
    pdf = mass / mass.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)   # (r, S-1)
    strata = torch.arange(n, dtype=z.dtype, device=z.device)
    u = ((strata + 0.5) / n).expand(r, n) if u is None else (strata + u) / n
    # the interval of each u: the last edge whose CDF is at or below it
    at = (cdf[:, None, :] <= u[:, :, None]).sum(-1)                         # (r, n)
    lo = torch.clamp(at - 1, 0, cdf.shape[1] - 2)
    hi = torch.clamp(at, 1, cdf.shape[1] - 1)
    c_lo, c_hi = torch.gather(cdf, 1, lo), torch.gather(cdf, 1, hi)
    e_lo, e_hi = torch.gather(edges, 1, lo), torch.gather(edges, 1, hi)
    span = c_hi - c_lo
    t = (u - c_lo) / torch.where(span < 1e-10, 1.0, span)
    return e_lo + t * (e_hi - e_lo)


def render(w: dict, rays: dict, mesh: dict, s: Settings, train: bool = False, randoms=None) -> dict:
    """Render rays (``ray_o``, ``ray_d``, ``near``, ``far`` on one device;
    ``frame``, ``body_pose`` (23, 3)) of one frame's ``mesh`` (``faces``,
    ``verts_world``, ``verts_cano``). ``train``: keep the graph, and take
    ``randoms`` = (uniforms, standard normals), both (r, S), and with the
    fine pass its (uniforms (r, n_fine), standard normals (r, S + n_fine)).
    Returns color (r, 3), depth (r,), acc (r,), weights (r, S); with the
    fine pass also fine_color, fine_depth, fine_acc, fine_weights."""
    with torch.set_grad_enabled(train):
        with torch.no_grad():
            near, far = near_far_spheres(rays["ray_o"], rays["ray_d"], rays["near"], rays["far"],
                                         mesh["verts_world"], s.gg_gamma)
        u, noise = (randoms[0], randoms[1] * s.raw_noise_std) if train else (None, None)
        z = depths(near, far, s.n_samples, u)
        out = render_z(w, rays, mesh, s, z, noise, train)
        if s.n_fine > 0:
            u_fine, noise_fine = (randoms[2], randoms[3] * s.raw_noise_std) if train else (None, None)
            z_fine = importance_depths(z, out["weights"], s.n_fine, u_fine)
            z_all = torch.sort(torch.cat([z, z_fine], -1), -1).values
            fine = render_z(w, rays, mesh, s, z_all, noise_fine, train)
            out.update({"fine_" + k: v for k, v in fine.items()})
    return out


def render_z(w: dict, rays: dict, mesh: dict, s: Settings, z, noise=None, train: bool = False) -> dict:
    """Everything after the depths: the rays' samples at depths z (r, S'),
    their searches, warps and networks, and the composite with the sigma
    noise (r, S') of a training step, if any. Returns color (r, 3), depth
    (r,), acc (r,), weights (r, S')."""
    ray_o, ray_d = rays["ray_o"], rays["ray_d"]
    r, n_s = z.shape
    faces = mesh["faces"].long()
    vw, vc = mesh["verts_world"], mesh["verts_cano"]
    cents_w, cents_c = vw[faces].mean(1), vc[faces].mean(1)
    code = w["nerf.embedding.weight"][int(rays["frame"])]
    pose_feat = nets.pose_feature(w, rays["body_pose"])
    pts = ray_o[:, None] + ray_d[:, None] * z[..., None]                   # (r, S', 3)
    dirs = ray_d[:, None].expand(r, n_s, 3)
    fw = nearest_face(pts.reshape(-1, 3), cents_w).reshape(r, n_s)
    m = (faces, vw, vc, cents_c)
    k = s.shade_topk
    if not 0 < k < n_s:
        sigma, color, off = _color_chain(w, s, pts.reshape(-1, 3), dirs.reshape(-1, 3),
                                         fw.reshape(-1), m, code, pose_feat, train)
        sigma = torch.where(off, 0.0, sigma).reshape(r, n_s)
        color = color.reshape(r, n_s, 3)
    else:
        tri_w, tri_c = vw[faces[fw.reshape(-1)]], vc[faces[fw.reshape(-1)]]
        uu, vv, hh = to_face(pts.reshape(-1, 3), tri_w)
        sig = nets.density_pass(w, from_face(uu, vv, hh, tri_c), code, pose_feat)
        sigma = torch.where(off_face(uu, vv, hh), 0.0, sig).reshape(r, n_s)
        wsel = composite(torch.zeros(r, n_s, 3, device=z.device), sigma.detach(), z, ray_d,
                         noise)[3]
        top = torch.sort(wsel, dim=-1, descending=True, stable=True).indices[:, :k]   # (r, K)
        gather = lambda x: torch.gather(x, 1, top[..., None].expand(r, k, x.shape[-1]))
        _, col_sel, _ = _color_chain(w, s, gather(pts).reshape(-1, 3),
                                     gather(dirs).reshape(-1, 3),
                                     torch.gather(fw, 1, top).reshape(-1), m, code,
                                     pose_feat, train)
        col_sel = col_sel.reshape(r, k, 3)
        # each sample: the nearest selected sample along the ray, the
        # earlier of the K on a tie
        gap = (torch.arange(n_s, device=z.device)[None, :, None] - top[:, None, :]).abs()
        nearest = (gap * k + torch.arange(k, device=z.device)).argmin(-1)          # (r, S')
        color = torch.gather(col_sel, 1, nearest[..., None].expand(r, n_s, 3))
    rgb, depth, acc, wts = composite(color, sigma, z, ray_d, noise)
    return {"color": rgb, "depth": depth, "acc": acc, "weights": wts}
