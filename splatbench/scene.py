"""Synthetic scenes made from a configuration file's `scene` and a seed:
the Gaussians of a trained model on the device, the cameras, and the
ground-truth images on the host, where a dataset keeps them.

The scene is a set of surfaces (a horizontal disc, spheres, axis-aligned
boxes) with a smooth random colour field over space. Gaussians sit on
the surfaces, each coloured by the field at its centre, oriented at
random, with three axes whose geometric mean is the scale that
init_model's mean distance to the 3 nearest neighbours gives on a
surface sampled at that density (0.729 / sqrt of the points per unit
area, with a log-normal spread), each axis spread log-normally about
it, as a trained model's Gaussians are stretched. The ground truth
of a camera is the field at the nearest surface along each pixel's ray
(the training background where a ray meets none), with pixel noise: the
scene that the Gaussians model, seen from that camera. Everything random
comes from the seed; the cameras come from the configuration alone.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

SH_C0 = 0.28209479177387814
KNN3_MEAN = 0.729  # E[mean distance to the 3 nearest] * sqrt(density)
WAVES = 12  # sine waves per colour channel


def _gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 7919 + stream) % (1 << 63))


def _area(s: Dict) -> float:
    if s["kind"] == "disc":
        return math.pi * s["radius"] ** 2
    if s["kind"] == "sphere":
        return 4.0 * math.pi * s["radius"] ** 2
    ext = np.subtract(s["max"], s["min"])
    return 2.0 * float(ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])


def _sample(s: Dict, n: int, gen, device) -> torch.Tensor:
    """n points uniform on surface `s`."""
    c = torch.tensor(s.get("center", [0.0, 0.0, 0.0]), device=device)
    if s["kind"] == "disc":
        u = torch.rand((2, n), generator=gen, device=device)
        r = s["radius"] * torch.sqrt(u[0])
        th = 2.0 * math.pi * u[1]
        return torch.stack([r * torch.cos(th), r * torch.sin(th),
                            torch.zeros_like(r)], -1) + c
    if s["kind"] == "sphere":
        d = torch.randn((n, 3), generator=gen, device=device)
        return c + s["radius"] * d / torch.linalg.norm(d, dim=-1,
                                                       keepdim=True)
    lo = torch.tensor(s["min"], device=device)
    hi = torch.tensor(s["max"], device=device)
    ext = (hi - lo).tolist()
    faces = torch.tensor([ext[1] * ext[2], ext[0] * ext[2],
                          ext[0] * ext[1]] * 2, device=device)
    face = torch.multinomial(faces, n, replacement=True, generator=gen)
    p = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=device)
    axis = face % 3
    side = torch.where(face < 3, lo[axis], hi[axis])
    return p.scatter(1, axis[:, None], side[:, None])


def _morton(p: torch.Tensor) -> torch.Tensor:
    """Order of the points along a 30-bit Morton curve over their
    bounding box (init_model keeps the points in Morton order)."""
    lo, hi = p.min(0).values, p.max(0).values
    q = ((p - lo) / torch.clamp(hi - lo, min=1e-12) * 1023).to(torch.int64)
    code = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(code)


class ColourField:
    """A smooth random colour per point of space: per channel the
    sigmoid of a sum of sine waves, half at each of the scene's two
    frequencies (cycles per unit)."""

    def __init__(self, freqs, seed: int, device):
        g = _gen(seed, 1, device)
        k = torch.tensor([freqs[0]] * (WAVES // 2) + [freqs[1]] * (WAVES // 2),
                         device=device)
        self.w = (2.0 * math.pi * k[None, :, None]
                  * torch.randn((3, WAVES, 3), generator=g, device=device)
                  / math.sqrt(3.0))
        self.phase = 2.0 * math.pi * torch.rand((3, WAVES), generator=g,
                                                device=device)
        self.amp = 1.5 * math.sqrt(2.0 / WAVES) * torch.randn(
            (3, WAVES), generator=g, device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 3) points -> (..., 3) colours in (0, 1)."""
        arg = torch.einsum("...k,cwk->...cw", x, self.w) + self.phase
        return torch.sigmoid((self.amp * torch.sin(arg)).sum(-1))


def make_params(scene: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The Gaussians' six parameter tensors on `device`, as a trained
    model holds them (features_rest (N, 15, 3) for SH degree 3)."""
    n = int(scene["n_gaussians"])
    shares = np.array([s["share"] for s in scene["surfaces"]], float)
    counts = np.floor(shares / shares.sum() * n).astype(int)
    counts[0] += n - counts.sum()
    gen = _gen(seed, 0, device)
    pts, log_scale = [], []
    for s, m in zip(scene["surfaces"], counts):
        pts.append(_sample(s, int(m), gen, device))
        spacing = KNN3_MEAN / math.sqrt(m / _area(s))
        log_scale.append(torch.full((int(m),), math.log(spacing),
                                    device=device))
    means = torch.cat(pts)
    log_scale = torch.cat(log_scale)
    order = _morton(means)
    means, log_scale = means[order].contiguous(), log_scale[order]
    log_scale = log_scale + scene["scale_spread"] * torch.randn(
        (n,), generator=gen, device=device)
    u = torch.rand((3, n), generator=gen, device=device)
    quats = torch.stack([torch.sqrt(1 - u[0]) * torch.sin(2 * math.pi * u[1]),
                         torch.sqrt(1 - u[0]) * torch.cos(2 * math.pi * u[1]),
                         torch.sqrt(u[0]) * torch.sin(2 * math.pi * u[2]),
                         torch.sqrt(u[0]) * torch.cos(2 * math.pi * u[2])], -1)
    # each axis spread about the Gaussian's scale, the log-volume kept
    axes = torch.randn((n, 3), generator=gen, device=device)
    axes = scene["axis_spread"] * (axes - axes.mean(1, keepdim=True))
    colour = ColourField(scene["colour_frequencies"], seed, device)(means)
    bases = (scene["sh_degree"] + 1) ** 2
    op = float(scene["opacity"])
    return {
        "means": means,
        "scales": (log_scale[:, None] + axes).contiguous(),
        "quats": quats.contiguous(),
        "features_dc": ((colour - 0.5) / SH_C0).contiguous(),
        "features_rest": torch.zeros((n, bases - 1, 3), device=device),
        "opacities": torch.full((n, 1), math.log(op / (1.0 - op)),
                                device=device),
    }


def _look_at(pos, target) -> np.ndarray:
    """Camera-to-world (4, 4), OpenGL axes (x right, y up, looking down
    -z), world z up."""
    pos, target = np.asarray(pos, float), np.asarray(target, float)
    fwd = target - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, pos
    return c2w.astype(np.float32)


def camera_poses(scene: Dict) -> List[np.ndarray]:
    """The configuration's camera-to-world poses: an orbit around the
    target (`orbit`), or a spiral over the upper hemisphere looking at
    it (`hemisphere`)."""
    rig = scene["cameras"]
    n, target = int(rig["count"]), rig["target"]
    poses = []
    for i in range(n):
        if rig["kind"] == "orbit":
            az = 2.0 * math.pi * i / n
            h = rig["height"] + rig["height_wobble"] * math.sin(3.0 * az)
            pos = [target[0] + rig["radius"] * math.cos(az),
                   target[1] + rig["radius"] * math.sin(az), h]
        else:
            lo, hi = (math.sin(math.radians(e)) for e in rig["elevation"])
            el = math.asin(lo + (hi - lo) * (i + 0.5) / n)
            az = i * math.pi * (3.0 - math.sqrt(5.0))
            pos = [rig["radius"] * math.cos(el) * math.cos(az),
                   rig["radius"] * math.cos(el) * math.sin(az),
                   rig["radius"] * math.sin(el)]
        poses.append(_look_at(pos, target))
    return poses


def _hit(s: Dict, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Distance along unit rays (o, d (..., 3)) to surface `s`; inf where
    the ray misses it."""
    eps = 1e-4
    inf = torch.full(d.shape[:-1], math.inf, device=d.device)
    if s["kind"] == "disc":
        c = torch.tensor(s["center"], device=d.device)
        t = (c[2] - o[2]) / torch.where(d[..., 2].abs() < 1e-12,
                                        torch.full_like(inf, 1e-12),
                                        d[..., 2])
        p = o + t[..., None] * d
        ok = (t > eps) & (((p[..., :2] - c[:2]) ** 2).sum(-1)
                          <= s["radius"] ** 2)
        return torch.where(ok, t, inf)
    if s["kind"] == "sphere":
        oc = o - torch.tensor(s["center"], device=d.device)
        b = (d * oc).sum(-1)
        disc = b * b - ((oc * oc).sum() - s["radius"] ** 2)
        root = torch.sqrt(torch.clamp(disc, min=0.0))
        t1, t2 = -b - root, -b + root
        t = torch.where(t1 > eps, t1, t2)
        return torch.where((disc >= 0) & (t > eps), t, inf)
    lo = torch.tensor(s["min"], device=d.device)
    hi = torch.tensor(s["max"], device=d.device)
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    ta, tb = (lo - o) * inv, (hi - o) * inv
    t_near = torch.minimum(ta, tb).amax(-1)
    t_far = torch.maximum(ta, tb).amin(-1)
    t = torch.where(t_near > eps, t_near, t_far)
    return torch.where((t_far >= t_near) & (t > eps), t, inf)


def make_images(scene: Dict, poses, seed: int, background,
                device) -> List[np.ndarray]:
    """Each camera's ground truth (H, W, 3) float32 on the host: the
    colour field at the nearest surface along each pixel's ray, the
    background where there is none, plus Gaussian pixel noise."""
    w, h = scene["width"], scene["height"]
    field = ColourField(scene["colour_frequencies"], seed, device)
    gen = _gen(seed, 2, device)
    bg = torch.tensor(background, device=device)
    px = (torch.arange(w, device=device) + 0.5 - scene["cx"]) / scene["fx"]
    py = (torch.arange(h, device=device) + 0.5 - scene["cy"]) / scene["fy"]
    # gsplat camera axes (x right, y down, z forward) to OpenGL's
    d_cam = torch.stack([px[None, :].expand(h, w), -py[:, None].expand(h, w),
                         -torch.ones((h, w), device=device)], -1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    out = []
    for pose in poses:
        c2w = torch.from_numpy(pose).to(device)
        d = d_cam @ c2w[:3, :3].T
        o = c2w[:3, 3]
        t = torch.stack([_hit(s, o, d) for s in scene["surfaces"]]).amin(0)
        hit = torch.isfinite(t)
        p = o + torch.where(hit, t, 0.0)[..., None] * d
        img = torch.where(hit[..., None], field(p), bg)
        img = img + scene["pixel_noise"] * torch.randn(
            img.shape, generator=gen, device=device)
        out.append(torch.clamp(img, 0.0, 1.0).cpu().numpy())
    return out
