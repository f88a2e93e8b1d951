"""Plain PyTorch reference of OpenSplat's forward render (model.cpp:83-225
with gsplat's project_gaussians, compute_sh_color and rasterize_gaussians):
camera matrices, EWA projection, SH colours, tile binning by (tile,
depth) and front-to-back alpha compositing with the per-pixel stop.

It is written from those semantics alone and imports nothing of the
program. Each tile's depth-sorted records are composited in rounds of
CHUNK records; the transmittance before each record is a cumulative
product within the round, carried from round to round. The gradient of
the rendered image is taken round by round, back to front, by running
each round again under autograd, so the memory is one round's and not
the whole image's. Float32 throughout; the matrix products follow
torch's TF32 switches, which the caller sets.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import torch

BLOCK = 16  # tile side (gsplat BLOCK_X = BLOCK_Y)
PIX = BLOCK * BLOCK
CHUNK = 128  # records of a tile composited in one round
MAX_BLOCK_ELEMS = 1 << 25  # (tile, pixel, record) elements a round block
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_MIN = 1e-4
CLIP_Z = 0.01
Z_NEAR, Z_FAR = 0.001, 1000.0
BLUR = 0.3  # added to the 2D covariance's diagonal
# The conic's off-diagonal B enters sigma once, as B dx dy. OpenSplat's
# gsplat-cpu backward (gsplat_cpu.cpp:267-376, the conformance target
# that BASELINE.json names) returns its gradient in the symmetric-entry
# convention, 0.5 sum v_sigma dx dy, half the derivative, and its
# projection takes it on by autograd as the derivative; the reference
# does the same. (gsplat's CUDA backward doubles it back in
# cov2d_to_conic_vjp.)
CONIC_B = 3  # index of B among the nine fields

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@dataclass
class Camera:
    cam_to_world: torch.Tensor  # (4, 4) float32, OpenGL axes
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def view_matrices(cam: Camera, device):
    """(world-to-camera rotation, translation, full projection (4, 4),
    camera centre) with gsplat's y/z flip and OpenSplat's OpenGL
    projection (z_near 0.001, z_far 1000)."""
    c2w = cam.cam_to_world.to(device=device, dtype=torch.float32)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=device))
    rot = (c2w[:3, :3] @ flip).T
    trans = -rot @ c2w[:3, 3]
    view = torch.eye(4, device=device)
    view[:3, :3] = rot
    view[:3, 3] = trans
    fov_x = 2.0 * math.atan(cam.width / (2.0 * cam.fx))
    fov_y = 2.0 * math.atan(cam.height / (2.0 * cam.fy))
    top = Z_NEAR * math.tan(0.5 * fov_y)
    right = Z_NEAR * math.tan(0.5 * fov_x)
    proj = torch.zeros((4, 4), device=device)
    proj[0, 0] = Z_NEAR / right
    proj[1, 1] = Z_NEAR / top
    proj[2, 2] = (Z_FAR + Z_NEAR) / (Z_FAR - Z_NEAR)
    proj[2, 3] = -Z_FAR * Z_NEAR / (Z_FAR - Z_NEAR)
    proj[3, 2] = 1.0
    return rot, trans, proj @ view, c2w[:3, 3]


def quat_rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz -> (N, 3, 3), normalised first."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def project(params: Dict[str, torch.Tensor], cam: Camera):
    """EWA projection (gsplat project_gaussians_forward): pixel centres,
    conics (a, b, c of the inverse 2D covariance), camera z, the 3-sigma
    radius, the tile bounding box and the visibility mask."""
    means = params["means"]
    dev = means.device
    rot, trans, full, _ = view_matrices(cam, dev)
    p = means @ rot.T + trans
    z = p[:, 2]
    lim_x = 1.3 * 0.5 * cam.width / cam.fx
    lim_y = 1.3 * 0.5 * cam.height / cam.fy
    # a Gaussian behind the clip plane takes no part: its terms are
    # evaluated at depth 1, so they stay finite and its gradient is 0
    front = z > CLIP_Z
    z_safe = torch.where(front, z, torch.ones_like(z))
    tx = z * torch.clamp(p[:, 0] / z_safe, -lim_x, lim_x)
    ty = z * torch.clamp(p[:, 1] / z_safe, -lim_y, lim_y)
    zero = torch.zeros_like(z)
    jac = torch.stack([cam.fx / z_safe, zero, -cam.fx * tx / (z_safe * z_safe),
                       zero, cam.fy / z_safe, -cam.fy * ty / (z_safe * z_safe)],
                      -1).reshape(-1, 2, 3)
    t_mat = jac @ rot  # (N, 2, 3)
    m = (t_mat @ quat_rotation(params["quats"])) * torch.exp(
        params["scales"])[:, None, :]
    cov = m @ m.transpose(1, 2)
    a = cov[:, 0, 0] + BLUR
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + BLUR
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)
    hom = means @ full[:, :3].T + full[:, 3]
    w = torch.where(front[:, None], hom[:, 3:4] + 1e-6,
                    torch.ones_like(hom[:, 3:4]))
    ndc = hom[:, :2] / w
    xys = torch.stack([0.5 * cam.width * ndc[:, 0] + cam.cx - 0.5,
                       0.5 * cam.height * ndc[:, 1] + cam.cy - 0.5], -1)
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(lam))
        tiles_x = (cam.width + BLOCK - 1) // BLOCK
        tiles_y = (cam.height + BLOCK - 1) // BLOCK
        cx_t, cy_t = xys[:, 0] / BLOCK, xys[:, 1] / BLOCK
        r_t = radius / BLOCK
        # C int casts truncate toward zero (gsplat get_bbox)
        x0 = torch.clamp((cx_t - r_t).to(torch.int64), 0, tiles_x)
        x1 = torch.clamp((cx_t + r_t + 1.0).to(torch.int64), 0, tiles_x)
        y0 = torch.clamp((cy_t - r_t).to(torch.int64), 0, tiles_y)
        y1 = torch.clamp((cy_t + r_t + 1.0).to(torch.int64), 0, tiles_y)
        mask = front & det_ok & ((x1 - x0) * (y1 - y0) > 0)
    return dict(xys=xys, conics=conics, depth=z.detach(), mask=mask,
                bbox=(x0, x1, y0, y1), tiles=(tiles_x, tiles_y))


def sh_colours(params: Dict[str, torch.Tensor], cam: Camera) -> torch.Tensor:
    """Degree-3 SH colour toward the camera (model.cpp:176-192): view
    directions from the detached means, clamp(sum + 0.5, min=0)."""
    means = params["means"].detach()
    centre = view_matrices(cam, means.device)[3]
    d = means - centre
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    basis = torch.stack([
        torch.full_like(x, SH_C0),
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy)], -1)
    coeffs = torch.cat([params["features_dc"][:, None, :],
                        params["features_rest"]], 1)
    return torch.clamp(torch.einsum("nb,nbc->nc", basis, coeffs) + 0.5,
                       min=0.0)


@dataclass
class Binned:
    gid: torch.Tensor  # (R,) Gaussian of each record, by (tile, depth)
    start: torch.Tensor  # (T,) first record of each tile
    count: torch.Tensor  # (T,) records of each tile


def bin_records(proj) -> Binned:
    """(Gaussian, tile) records over each visible Gaussian's tile
    bounding box, sorted by tile, then camera depth, then Gaussian."""
    x0, x1, y0, y1 = proj["bbox"]
    tiles_x, tiles_y = proj["tiles"]
    vis = torch.nonzero(proj["mask"]).squeeze(1)
    nx = (x1 - x0)[vis]
    n = nx * (y1 - y0)[vis]
    total = int(n.sum())
    dev = vis.device
    owner = torch.repeat_interleave(torch.arange(vis.numel(), device=dev), n)
    first = torch.cumsum(n, 0) - n
    local = torch.arange(total, device=dev) - first[owner]
    tile = ((y0[vis][owner] + local // nx[owner]) * tiles_x
            + x0[vis][owner] + local % nx[owner])
    gid = vis[owner]
    depth_bits = proj["depth"][gid].contiguous().view(torch.int32).to(
        torch.int64)
    order = torch.sort((tile << 32) | depth_bits, stable=True).indices
    n_tiles = tiles_x * tiles_y
    count = torch.bincount(tile, minlength=n_tiles)
    return Binned(gid=gid[order], start=torch.cumsum(count, 0) - count,
                  count=count)


def _pixel_xy(tiles: torch.Tensor, tiles_x: int):
    p = torch.arange(PIX, device=tiles.device)
    px = (tiles % tiles_x)[:, None] * BLOCK + p % BLOCK
    py = (tiles // tiles_x)[:, None] * BLOCK + p // BLOCK
    return px.to(torch.float32), py.to(torch.float32)


def _round_terms(fields, px, py, valid, t_start, done):
    """One round of compositing for a block of tiles: fields (B, K) each
    of x, y, A, B, C, opacity, r, g, b; pixels (B, 256). Returns the
    colour added (B, 256, 3), the transmittance after the round, the
    masks `used` (alpha counts at the pixel) and `inc` (before the
    pixel's stop), all (B, 256, K)."""
    x, y, ca, cb, cc, op, cr, cg, cbl = (f[:, None, :] for f in fields)
    dx = x - px[:, :, None]
    dy = y - py[:, :, None]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    raw = op * torch.exp(-sigma)
    used = (valid[:, None, :] & (sigma >= 0.0) & (raw >= ALPHA_MIN)
            & ~done[:, :, None])
    alpha = torch.where(used, torch.clamp(raw, max=ALPHA_MAX), 0.0)
    after = t_start[:, :, None] * torch.cumprod(1.0 - alpha, -1)
    inc = (after > T_MIN).detach()
    a_eff = torch.where(inc, alpha, 0.0)
    keep = torch.cumprod(1.0 - a_eff, -1)
    before = t_start[:, :, None] * torch.cat(
        [torch.ones_like(keep[..., :1]), keep[..., :-1]], -1)
    w = a_eff * before
    colour = torch.stack([(w * cr).sum(-1), (w * cg).sum(-1),
                          (w * cbl).sum(-1)], -1)
    return colour, t_start * keep[..., -1], used, inc


@dataclass
class Work:
    """What a view needs of the rasterizers (yardstick/counts.py)."""
    visible: int
    pairs: int
    replay: int
    n_tiles: int


class Raster:
    """The composited image of one view, kept so that its gradient can
    be taken round by round."""

    def __init__(self, binned: Binned, fields, tiles_x: int, tiles_y: int,
                 width: int, height: int, background: torch.Tensor,
                 count_work: bool = False):
        self.b = binned
        self.fields = fields  # per Gaussian: x, y, A, B, C, op, r, g, b
        self.tiles_x, self.tiles_y = tiles_x, tiles_y
        self.width, self.height = width, height
        self.background = background
        n_tiles = tiles_x * tiles_y
        dev = background.device
        longest = int(binned.count.max()) if binned.count.numel() else 0
        self.rounds: List[list] = []
        t_px = torch.ones((n_tiles, PIX), device=dev)
        done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=dev)
        colour = torch.zeros((n_tiles, PIX, 3), device=dev)
        pairs = torch.zeros((n_tiles, PIX), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for r0 in range(0, longest, CHUNK):
                blocks = []
                for tiles in self._blocks(r0):
                    idx, valid = self._records(tiles, r0)
                    f = [v[self.b.gid[idx]] for v in fields]
                    px, py = _pixel_xy(tiles, tiles_x)
                    t0, d0 = t_px[tiles], done[tiles]
                    col, t1, used, inc = _round_terms(f, px, py, valid, t0,
                                                      d0)
                    blocks.append((tiles, t0, d0))
                    colour[tiles] += col
                    t_px[tiles] = t1
                    done[tiles] = d0 | ~inc[..., -1]
                    if count_work:
                        inside = ((px < width) & (py < height))[..., None]
                        needed = (used & inside
                                  & (inc | _first_false(inc))).any(1)
                        pairs[tiles] += (needed[:, None, :] & inc).sum(-1)
                self.rounds.append(blocks)
        self.final_t = t_px
        self.tile_rgb = colour + t_px[..., None] * background
        self.work = None
        if count_work:
            px, py = _pixel_xy(torch.arange(n_tiles, device=dev), tiles_x)
            inside = (px < width) & (py < height)
            pairs = torch.where(inside, pairs, 0)
            self.work = dict(pairs=int(pairs.sum()),
                             replay=int(pairs.amax(1).sum()),
                             n_tiles=n_tiles)

    def _blocks(self, r0: int):
        active = torch.nonzero(self.b.count > r0).squeeze(1)
        per = max(1, MAX_BLOCK_ELEMS // (PIX * CHUNK))
        return torch.split(active, per)

    def _records(self, tiles, r0):
        k = torch.arange(r0, r0 + CHUNK, device=tiles.device)
        valid = k[None, :] < self.b.count[tiles][:, None]
        idx = self.b.start[tiles][:, None] + torch.where(valid, k, 0)
        return idx, valid

    def image(self) -> torch.Tensor:
        """(H, W, 3) of the tiles, cropped."""
        return tiles_to_image(self.tile_rgb, self.tiles_x, self.tiles_y,
                              self.height, self.width)

    def backward(self, grad_image: torch.Tensor):
        """Gradients (per Gaussian) of the nine fields from the image's
        gradient (H, W, 3), round by round from the last."""
        g_tiles = image_to_tiles(grad_image, self.tiles_x, self.tiles_y,
                                 self.height, self.width)
        g_t = (g_tiles * self.background).sum(-1)  # d/d final T
        grads = [torch.zeros_like(v) for v in self.fields]
        for r, blocks in reversed(list(enumerate(self.rounds))):
            r0 = r * CHUNK
            for tiles, t0, d0 in blocks:
                idx, valid = self._records(tiles, r0)
                gid = self.b.gid[idx]
                f = [v[gid].requires_grad_(True) for v in self.fields]
                t_in = t0.clone().requires_grad_(True)
                px, py = _pixel_xy(tiles, self.tiles_x)
                col, t1, _, _ = _round_terms(f, px, py, valid, t_in, d0)
                outs = torch.autograd.grad(
                    [col, t1], f + [t_in], [g_tiles[tiles], g_t[tiles]],
                    allow_unused=True)
                flat = gid[valid]
                for j, (acc, gf) in enumerate(zip(grads, outs[:-1])):
                    if gf is not None:
                        if j == CONIC_B:
                            gf = 0.5 * gf
                        acc.index_add_(0, flat, gf[valid])
                g_t[tiles] = outs[-1]
        return grads


def _first_false(inc: torch.Tensor) -> torch.Tensor:
    """The stopping record: the first position where `inc` is False."""
    prev = torch.cat([torch.ones_like(inc[..., :1]), inc[..., :-1]], -1)
    return prev & ~inc


def tiles_to_image(tiled, tiles_x, tiles_y, height, width):
    img = tiled.reshape(tiles_y, tiles_x, BLOCK, BLOCK, -1).permute(
        0, 2, 1, 3, 4).reshape(tiles_y * BLOCK, tiles_x * BLOCK, -1)
    return img[:height, :width]


def image_to_tiles(img, tiles_x, tiles_y, height, width):
    pad = img.new_zeros((tiles_y * BLOCK, tiles_x * BLOCK, img.shape[-1]))
    pad[:height, :width] = img
    return pad.reshape(tiles_y, BLOCK, tiles_x, BLOCK, -1).permute(
        0, 2, 1, 3, 4).reshape(tiles_y * tiles_x, PIX, -1)


def render(params: Dict[str, torch.Tensor], alive: torch.Tensor,
           cam: Camera, background: torch.Tensor,
           count_work: bool = False):
    """(image (H, W, 3) unclamped, raster, projected fields): the forward
    render, keeping what its gradient needs. The fields are functions of
    `params` under autograd where they require grad."""
    proj = project(params, cam)
    proj["mask"] = proj["mask"] & alive
    colours = sh_colours(params, cam)
    opac = torch.sigmoid(params["opacities"]).reshape(-1)
    fields = [proj["xys"][:, 0], proj["xys"][:, 1], proj["conics"][:, 0],
              proj["conics"][:, 1], proj["conics"][:, 2], opac,
              colours[:, 0], colours[:, 1], colours[:, 2]]
    binned = bin_records(proj)
    raster = Raster(binned, [f.detach() for f in fields], *proj["tiles"],
                    cam.width, cam.height, background, count_work)
    if count_work:
        raster.work["visible"] = int(proj["mask"].sum())
    return raster.image(), raster, fields
