#!/usr/bin/env python3
"""On-card smoke test of opensplat_tpu_torch: build, check, train, time.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. print the card's name and power limit (nvidia-smi), build the
     CUDA kernels from opensplat_tpu_torch/csrc into opensplat_tpu_torch/
     _build/ (timed), and print the build of expand, raster_fwd,
     raster_bwd and the bench's kbench_fwd as the CUDA runtime reports
     it (records or Gaussians per CTA, registers, shared memory, resident
     CTAs per SM);
  2. hold each kernel against its plain PyTorch version on the card, on
     the 16384-Gaussian 256 px scene of bench.py and at 250 px (tiles
     padded past the image's edge), raster_bwd also against the direct
     nine-term sums in float64 (as in every such check below), the
     segment sum on segments of 0 to 6000 rows, and the expansion on
     Gaussians that span every tile beside zero-count ones (exact);
  3. train the bench.py headline model through Trainer.run_step: 131072
     Gaussians from init_model, 512x512, SH degree 3 from step 3, three
     cameras, 20 steps. Every loss must be finite, the last below the
     first, and each kernel's launch counter must advance once per step.
     The kernels are timed with CUDA events around each launch over the
     last 10 steps (the table's ms, the median; it holds the host's
     launch gap) and by torch.profiler over three more steps (the
     table's device_ms: device time per recorded launch, printed with
     the launches the trace recorded);
  4. at the main path's shapes (the trained state, camera 0) hold each
     kernel against its plain version again; run expand twice,
     raster_fwd twice, and raster_bwd then segment_sum twice, and
     require bitwise-equal outputs; time the plain versions and segment
     sum's library yardsticks (torch.segment_reduce and index_add_,
     never called by the port; by CUDA events, the table's library_ms
     is the faster; device time printed beside);
     print the tile balance (records replayed per tile: max, p50, p99;
     raster_fwd and raster_bwd, each on the longest tile alone against
     all tiles); and compute each kernel's bound from this run's data;
  5. refine on the card: a fresh 131072-Gaussian 512 px SH 3 model from
     the same scene at capacity = point count, 60 steps of
     Trainer.run_step with warmup 20, refine every 10 and an alpha reset
     every 3 refines (step 40 resets alpha, step 50 densifies with the
     huge-cull and must grow capacity). Losses finite, each kernel
     launched once per step at every capacity, n_alive as counted, and
     Trainer.render gives a finite 512x512 image; then each kernel
     against its plain version at the grown capacity;
  6. the forward-kernel ablation bench: each variant of
     csrc/raster_fwd_variants.cu against its plain version on a 64-tile
     stream, on uneven tile ranges (an empty tile, a 40-record one, one
     over four 256-chunks, one ending at the stream's end), on 257 tiles
     whose starts fall at every residue mod 256, on 64 tiles of records
     made to test the kernel's warp cull (scales 0.02-40 px, aspect up
     to 30, conics it cannot bound, opacities at 1/255), and on the
     bench's default stream (1024 tiles x 1074 records, 32 tiles a
     row); the `full` kernel against the forward that runs (raster_fwd,
     zero background) on the 64-tile and the bench stream; then `python
     -m opensplat_tpu_torch.tools.kbench_raster`'s run at that stream,
     timing every variant beside the main path's forward kernel, and
     the (warp, record) steps `full` takes there.
The line before the last is the {"kernels": [...]} table; the last line
is {"ok": true, "device": {...}}. Without a CUDA card it exits non-zero
and prints no result. It imports nothing of JAX or opensplat_tpu.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets, dense): device memory bytes/s and
# float32 operations/s outside the tensor cores, by card name.
PEAKS = {
    "H100 PCIe": (2.0e12, 51.2e12),
    "H100 NVL": (3.9e12, 60.0e12),
    "H100": (3.35e12, 67.0e12),  # SXM (HBM3)
    "H200": (4.8e12, 67.0e12),
}
# float32 operations per unit of work, counted from the kernels' code
OPS_PER_CANDIDATE = 70  # expansion: tile math + the 4-edge cull bound
OPS_PER_PAIR_FWD = 20  # forward: sigma, exp, alpha, stop test, composite
OPS_PER_PAIR_BWD = 45  # backward: replay + the nine gradient terms
OPS_PER_RECORD_SUM = 9  # segment sum: nine adds per record

KERNELS = {
    "expand": ("opensplat_tpu_torch/csrc/expand.cu",
               "opensplat_tpu/ops/pallas/expand.py:110"),
    "raster_fwd": ("opensplat_tpu_torch/csrc/raster_fwd.cu",
                   "opensplat_tpu/ops/pallas/raster.py:248"),
    "raster_bwd": ("opensplat_tpu_torch/csrc/raster_bwd.cu",
                   "opensplat_tpu/ops/pallas/raster.py:423"),
    "segsum": ("opensplat_tpu_torch/csrc/segsum.cu",
               "opensplat_tpu/ops/pallas/segsum.py:59"),
    "kbench_fwd": ("opensplat_tpu_torch/csrc/raster_fwd_variants.cu",
                   "tools/kbench_raster.py:74"),
}


# each kernel's __global__ function, as the profiler names it
KERNEL_FUNCS = {"expand": "expand_kernel", "raster_fwd": "raster_fwd_kernel",
                "raster_bwd": "raster_bwd_kernel", "segsum": "segsum_kernel",
                "kbench_fwd": "kbench_fwd_kernel"}


class Camera:
    def __init__(self, eye, size, image):
        self.cam_to_world = np.eye(4, dtype=np.float32)
        self.cam_to_world[:3, 3] = eye
        self.fx = self.fy = 0.9 * size
        self.cx = self.cy = size / 2.0
        self.width = self.height = size
        self._image = image

    def get_image(self, factor):
        assert factor == 1
        return self._image


def make_scene(n_points, size, seed, device):
    """bench.py's scene: points uniform in [-1.5, 1.5]^3, random colours
    and ground truth, camera at z = +6 with fx = fy = 0.9 * size, plus two
    cameras at small offsets."""
    from opensplat_tpu_torch.models.gaussians import init_model

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n_points, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (n_points, 3)).astype(np.uint8)
    state = init_model(pts, rgb, sh_degree=3, capacity=n_points, seed=seed,
                       device=device)
    gt = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    cams = [Camera(e, size, gt) for e in
            ((0.0, 0.0, 6.0), (0.1, 0.0, 6.0), (0.0, 0.1, 6.0))]
    return state, cams


def stage_inputs(state, cam, sh_deg, seed):
    """The four kernels' inputs for one render of `cam`, built with the
    port's own stages (projection, SH, binning, forward kernel)."""
    import torch

    from opensplat_tpu_torch.models.splat_model import DEFAULT_BACKGROUND
    from opensplat_tpu_torch.ops.binning import bin_gaussians, num_tiles
    from opensplat_tpu_torch.ops.camera import camera_matrices
    from opensplat_tpu_torch.ops.kernels import raster
    from opensplat_tpu_torch.ops.projection import project_gaussians
    from opensplat_tpu_torch.ops.sh import spherical_harmonics

    dev = state.device
    p = state.params
    h = w = cam.width
    with torch.no_grad():
        c2w = torch.as_tensor(cam.cam_to_world, device=dev)
        viewmat, proj_m, cam_pos = camera_matrices(c2w, cam.fx, cam.fy, w, h)
        opac = torch.sigmoid(p.opacities).reshape(-1).contiguous()
        proj = project_gaussians(
            p.means, torch.exp(p.scales), 1.0,
            p.quats / torch.linalg.norm(p.quats, dim=-1, keepdim=True),
            viewmat, proj_m, cam.fx, cam.fy, cam.cx, cam.cy, h, w,
            valid_mask=state.alive, opacities=opac)
        vd = p.means - cam_pos
        vd = vd / torch.clamp(torch.linalg.norm(vd, dim=-1, keepdim=True),
                              min=1e-12)
        colors = torch.clamp(spherical_harmonics(
            sh_deg, vd, torch.cat([p.features_dc[:, None], p.features_rest],
                                  1)) + 0.5, min=0.0).contiguous()
        binned = bin_gaussians(proj, h, w, opac)
        tb_x, tb_y = num_tiles(h, w)
        cnt = proj.num_tiles_hit.to(torch.int32).contiguous()
        starts = (torch.cumsum(cnt.long(), 0) - cnt.long()).contiguous()
        s_max = torch.log(torch.clamp(opac, min=1e-12) / (1.0 / 255.0))
        expand_args = (cnt, starts, binned.n_cands,
                       proj.tile_min.contiguous(), proj.tile_max.contiguous(),
                       proj.depths.contiguous(), proj.xys.contiguous(),
                       proj.conics.contiguous(), s_max.contiguous(), tb_x,
                       tb_x * tb_y)
        bg = torch.tensor(DEFAULT_BACKGROUND, device=dev)
        fwd_args = (binned.gauss_ids, binned.tile_start, binned.tile_end,
                    proj.xys.contiguous(), proj.conics.contiguous(), opac,
                    colors, bg, h, w)
        img, final_t, fidx = raster.rasterize_forward(*fwd_args)
        gen = torch.Generator(device=dev).manual_seed(seed)
        v_img = torch.randn((h, w, 3), generator=gen, device=dev)
        v_ft = torch.randn((h, w), generator=gen, device=dev)
        bwd_args = fwd_args[:8] + (final_t, fidx, v_img, v_ft,
                                   binned.cand_index, h, w)
    return dict(expand=expand_args, fwd=fwd_args, bwd=bwd_args,
                binned=binned, fidx=fidx, img=img)


def check_kernels(inp, label):
    """Each kernel against its plain version on the same inputs; raises
    on disagreement. Returns {kernel: max_abs_err} and the gradient rows."""
    import torch

    from opensplat_tpu_torch.ops.kernels import expand, raster, segsum

    errs = {}
    with torch.no_grad():
        k = expand.expand(*inp["expand"])
        q = expand.expand_plain(*inp["expand"])
        for name, a, b in zip(("keys", "gids", "kept"), k, q):
            if not torch.equal(a, b):
                raise AssertionError(f"[{label}] expand: {name} differ in "
                                     f"{int((a != b).sum())} places")
        errs["expand"] = 0.0
        b = inp["binned"]
        ks, _ = torch.sort(k[0], stable=True)
        qs, _ = torch.sort(q[0], stable=True)
        if not torch.equal(ks, qs):
            raise AssertionError(f"[{label}] expand: sorted streams differ")

        img_k, ft_k, fi_k = raster.rasterize_forward(*inp["fwd"])
        img_p, ft_p, fi_p = raster.rasterize_forward_plain(*inp["fwd"])
        e_img = float((img_k - img_p).abs().max())
        e_ft = float((ft_k - ft_p).abs().max())
        agree = float((fi_k == fi_p).float().mean())
        if not (e_img <= 1e-4 and e_ft <= 1e-5 and agree >= 0.999):
            raise AssertionError(
                f"[{label}] raster_fwd: image err {e_img} (atol 1e-4), "
                f"final_T err {e_ft} (atol 1e-5), final_idx agreement "
                f"{agree} (>= 0.999)")
        errs["raster_fwd"] = e_img

        g_k = raster.rasterize_backward(*inp["bwd"])
        g_p = raster.rasterize_backward_plain(*inp["bwd"])
        scale = float(g_p.abs().max()) + 1e-30
        bad = (g_k - g_p).abs() > 1e-3 * g_p.abs() + 1e-5 * scale
        if bool(bad.any()):
            raise AssertionError(
                f"[{label}] raster_bwd: {int(bad.sum())} of {bad.numel()} "
                f"gradient values outside rtol 1e-3, atol 1e-5*max|g|")
        errs["raster_bwd"] = float((g_k - g_p).abs().max())
        # the moment form shared by kernel and plain version, against the
        # direct nine-term sums in float64, at the same tolerance
        g_d = raster.rasterize_backward_direct(*inp["bwd"])
        scale = float(g_d.abs().max()) + 1e-30
        diff = (g_k.double() - g_d).abs()
        bad = diff > 1e-3 * g_d.abs() + 1e-5 * scale
        if bool(bad.any()):
            raise AssertionError(
                f"[{label}] raster_bwd: {int(bad.sum())} of {bad.numel()} "
                f"gradient values outside rtol 1e-3, atol 1e-5*max|g| of "
                f"the direct float64 sums")
        errs["raster_bwd_direct"] = float(diff.max())

        args = (g_k, b.cand_start, b.cand_count)
        s_k = segsum.segment_sum(*args)
        s_p = segsum.segment_sum_plain(*args)
        sc = float(s_p.abs().max()) + 1e-30
        bad = (s_k - s_p).abs() > 1e-5 * s_p.abs() + 1e-6 * sc
        if bool(bad.any()):
            raise AssertionError(
                f"[{label}] segsum: {int(bad.sum())} values outside rtol "
                f"1e-5, atol 1e-6*max|s|")
        errs["segsum"] = float((s_k - s_p).abs().max())
    print(f"[{label}] kernels agree with their plain versions: "
          + json.dumps(errs), flush=True)
    return errs, g_k


def profile_steps(trainer, first_step, n, step_ms):
    """Where a step's device time goes: torch.profiler over n more steps,
    device time per step by kernel, and the device's busy share of the
    unprofiled steady step time `step_ms`. Returns {kernel: (device ms
    per recorded launch, launches recorded)} for the port's kernels the
    trace recorded."""
    from opensplat_tpu_torch.tools.profiling import device_rows

    step = [first_step]

    def one():
        trainer.run_step(step[0])
        step[0] += 1

    traced = device_rows(one, n)
    rows = [(key, t * k / n) for key, t, k in traced]
    busy = sum(ms for _, ms in rows)
    if busy == 0:
        print("step profile: device time not measured (no CUDA events)")
        return {}
    print(f"step profile: device busy {busy:.3f} ms of a {step_ms:.3f} ms "
          f"step ({100 * busy / step_ms:.1f}%, idle "
          f"{100 * (1 - busy / step_ms):.1f}%); top kernels, ms/step:")
    for key, ms in rows[:15]:
        print(f"  {ms:8.4f}  {key[:90]}")
    # the port's kernels launch once a step
    return {k: (t, c) for k, fn_name in KERNEL_FUNCS.items()
            for key, t, c in traced if fn_name in key}


def time_ms(fn, reps):
    import torch

    fn()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def bounds(inp, peak_bw, peak_ops):
    """(bound_ms, bound_by) per kernel from this run's data: bytes each
    input read once and each output written once over the memory rate,
    against the float32 operations the data needs over the peak rate."""
    from opensplat_tpu_torch.ops.kernels.raster import (pairs_replayed,
                                                        records_replayed)

    b = inp["binned"]
    c = inp["expand"][0].shape[0]
    h, w = inp["fwd"][8], inp["fwd"][9]
    n_tiles = b.tile_start.shape[0]
    n_cand = b.n_cands
    n_isect = int(b.n_isects)
    # records read: per tile up to its last pixel's stop; (pixel, record)
    # pairs: each pixel up to its own stop
    replay = records_replayed(b.tile_start, b.tile_end, inp["fidx"])
    pairs = pairs_replayed(b.tile_start, b.tile_end, inp["fidx"])
    print(f"raster work (main path): {replay} records replayed, {pairs} "
          f"(pixel, record) pairs needed, {256 * replay} in tiles that run "
          f"to their last pixel's stop", flush=True)
    table = c * 36  # xys, conics, opacity, colours
    work = {
        "expand": (c * 56 + n_cand * 12 + c * 4, n_cand * OPS_PER_CANDIDATE),
        "raster_fwd": (table + replay * 4 + n_tiles * 8 + h * w * 16
                       + n_tiles * 256 * 4, pairs * OPS_PER_PAIR_FWD),
        "raster_bwd": (table + replay * 4 + n_tiles * 8 + h * w * 20
                       + n_tiles * 256 * 4 + replay * 36,
                       pairs * OPS_PER_PAIR_BWD),
        "segsum": (n_isect * 36 + c * 12 + c * 36,
                   n_isect * OPS_PER_RECORD_SUM),
    }
    out = {}
    for k, (nbytes, ops) in work.items():
        tb = nbytes / peak_bw * 1e3
        to = ops / peak_ops * 1e3
        out[k] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def check_expand_stress(size=512, n=1500, seed=5, device="cuda"):
    """The expansion against its plain version, torch.equal, on the
    Gaussians that stress a row-parallel kernel: five spanning every tile
    of a `size` px frame (each more rows than a CTA has threads; two
    wide enough to keep most of them), a block whose rows are mostly
    theirs, 60% zero-count Gaussians, two with saturated means (kept
    without the cull), and small boxes between them. Random fields from
    a seeded numpy generator."""
    import torch

    from opensplat_tpu_torch.ops.binning import num_tiles
    from opensplat_tpu_torch.ops.kernels import expand

    rng = np.random.default_rng(seed)
    tb_x, tb_y = num_tiles(size, size)
    tmin = np.stack([rng.integers(0, tb_x, n), rng.integers(0, tb_y, n)], 1)
    ext = rng.integers(1, 4, (n, 2))
    tmax = np.minimum(tmin + ext, [tb_x, tb_y])
    zero = rng.uniform(size=n) < 0.6
    tmax[zero] = tmin[zero]
    span = [3, n // 5, n // 5 + 1, n // 5 + 2, n - 1]
    tmin[span] = 0
    tmax[span] = [tb_x, tb_y]
    zero[span] = False
    cnt = np.prod(tmax - tmin, 1).astype(np.int32)
    xys = rng.uniform(-20.0, size + 20.0, (n, 2)).astype(np.float32)
    xys[[7, n // 5 + 1]] = [1e5, -1e5]  # saturated quantised means
    a = np.exp(rng.uniform(np.log(0.002), np.log(2.0), (n, 2)))
    rho = rng.uniform(-0.9, 0.9, n)
    conics = np.stack([a[:, 0], rho * np.sqrt(a[:, 0] * a[:, 1]), a[:, 1]],
                      1).astype(np.float32)
    # two wide ones keep most of their rows, the rest cull most
    conics[span[:2]] = [2e-5, 0.0, 3e-5]
    xys[span[:2]] = size / 2.0
    opac = rng.uniform(0.005, 1.0, n).astype(np.float32)
    s_max = np.log(opac / np.float32(1.0 / 255.0)).astype(np.float32)
    depths = rng.uniform(0.5, 20.0, n).astype(np.float32)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    cnt_t = dev(cnt)
    starts = (torch.cumsum(cnt_t.long(), 0) - cnt_t.long()).contiguous()
    args = (cnt_t, starts, int(cnt.sum()), dev(tmin.astype(np.int32)),
            dev(tmax.astype(np.int32)), dev(depths), dev(xys), dev(conics),
            dev(s_max), tb_x, tb_x * tb_y)
    k = expand.expand(*args)
    q = expand.expand_plain(*args)
    for name, x, y in zip(("keys", "gids", "kept"), k, q):
        if not torch.equal(x, y):
            raise AssertionError(f"expand stress: {name} differ in "
                                 f"{int((x != y).sum())} places")
    kept = int(q[2].sum())
    if not 0 < kept < int(cnt.sum()):
        raise AssertionError("expand stress: the cull kept all or nothing")
    print(f"expand stress ({n} Gaussians at {size} px: {len(span)} spanning "
          f"all {tb_x * tb_y} tiles, {int(zero.sum())} with no rows, "
          f"{int(cnt.sum())} rows, {kept} kept) equals its plain version",
          flush=True)


def check_segsum_segments():
    """The segment sum against its plain version on segments of every
    kind: empty, short (one lane each), longer than a warp's 32 rows
    (summed by the whole warp) up to 6000 rows, lying between short
    ones. Random rows, a seeded generator; the tolerance of
    check_kernels."""
    import torch

    from opensplat_tpu_torch.ops.kernels import segsum

    gen = torch.Generator(device="cuda").manual_seed(4)
    counts = torch.randint(0, 12, (4099,), generator=gen, device="cuda")
    for g, n in ((5, 6000), (6, 33), (40, 32), (41, 500), (4098, 77)):
        counts[g] = n
    counts = counts.to(torch.int32)
    starts = torch.cumsum(counts.long(), 0) - counts.long()
    rows = torch.randn((int(counts.sum()), 9), generator=gen, device="cuda")
    s_k = segsum.segment_sum(rows, starts, counts)
    s_p = segsum.segment_sum_plain(rows, starts, counts)
    sc = float(s_p.abs().max())
    bad = (s_k - s_p).abs() > 1e-5 * s_p.abs() + 1e-6 * sc
    if bool(bad.any()):
        raise AssertionError(f"segsum on long segments: {int(bad.sum())} "
                             "values outside rtol 1e-5, atol 1e-6*max|s|")
    print("segsum on segments of 0-6000 rows agrees with its plain version: "
          f"max err {float((s_k - s_p).abs().max())}", flush=True)


def check_determinism(inp):
    """expand twice, raster_fwd twice, and raster_bwd followed by
    segment_sum twice, on the same inputs: the keys, gids and kept
    counts, the image, final T and final_idx, and the (C, 9) sums must be
    bitwise equal."""
    import torch

    from opensplat_tpu_torch.ops.kernels import expand, raster, segsum

    b = inp["binned"]
    with torch.no_grad():
        exp = [expand.expand(*inp["expand"]) for _ in range(2)]
        fwd = [raster.rasterize_forward(*inp["fwd"]) for _ in range(2)]
        runs = [segsum.segment_sum(raster.rasterize_backward(*inp["bwd"]),
                                   b.cand_start, b.cand_count)
                for _ in range(2)]
    named = (list(zip(("expand keys", "expand gids", "expand kept"), *exp))
             + list(zip(("raster_fwd image", "raster_fwd final T",
                         "raster_fwd final_idx"), *fwd))
             + [("raster_bwd -> segment_sum sums", *runs)])
    for name, x, y in named:
        if not torch.equal(x, y):
            raise AssertionError(
                f"not deterministic: {name} differ at {int((x != y).sum())} "
                f"of {x.numel()} places between two runs")
    print("determinism: expand, raster_fwd, and raster_bwd -> segment_sum "
          "each run twice; the keys, gids and kept counts, the image, "
          "final T and final_idx, and the (C, 9) sums are bitwise equal",
          flush=True)


def tile_balance(inp):
    """Records each tile replays (to its last pixel's stop): max, p50,
    p99 and mean; and the device time (torch.profiler, 10 calls each,
    with the launches recorded) of raster_fwd and raster_bwd, each with
    every tile but the longest emptied against all tiles: near it, the
    longest tile sets the kernel's time."""
    import torch

    from opensplat_tpu_torch.ops.kernels import raster
    from opensplat_tpu_torch.tools.profiling import device_ms

    b = inp["binned"]
    per_tile = raster._pixel_replay(b.tile_start, b.tile_end,
                                    inp["fidx"]).amax(1).double()
    q = torch.quantile(per_tile, torch.tensor(
        [0.5, 0.99], dtype=torch.float64, device=per_tile.device))
    longest = int(per_tile.argmax())
    only = torch.where(torch.arange(per_tile.numel(), device=per_tile.device)
                       == longest, b.tile_end, b.tile_start).contiguous()
    out = dict(tiles=per_tile.numel(), max=int(per_tile.max()),
               p50=float(q[0]), p99=float(q[1]),
               mean=float(per_tile.mean()),
               nonempty=int((per_tile > 0).sum()))

    def alone_and_all(fn, key, kernel):
        args = list(inp[key])
        args[2] = only
        with torch.no_grad():
            alone = device_ms(lambda: fn(*args), 10, kernel)
            every = device_ms(lambda: fn(*inp[key]), 10, kernel)
        return dict(longest_tile_alone_ms=alone[0], recorded_alone=alone[1],
                    all_tiles_ms=every[0], recorded_all=every[1])

    out["raster_fwd"] = alone_and_all(raster.rasterize_forward, "fwd",
                                      KERNEL_FUNCS["raster_fwd"])
    out["raster_bwd"] = alone_and_all(raster.rasterize_backward, "bwd",
                                      KERNEL_FUNCS["raster_bwd"])
    print("tile balance (records replayed per tile, main path; device ms "
          "of raster_fwd and raster_bwd on the longest tile alone and on "
          "all): " + json.dumps(out), flush=True)
    return out


def segsum_yardsticks(inp, rows):
    """The segment sum's library yardsticks on the main path's rows, each
    one PyTorch call the port never makes: torch.segment_reduce on the
    Gaussian-order rows, and index_add_ of the stream-order rows by
    gauss_id into a zeroed (C, 9). Also the whole reduction path from the
    rows to the (C, 9) sums, which is the segment-sum kernel alone (no
    sort). Each call timed by CUDA events (median of 20, the method of
    library_ms) and by torch.profiler (device time of every kernel it
    launches, 20 calls, with the launches recorded). Returns {call:
    events ms}."""
    import torch

    from opensplat_tpu_torch.ops.kernels import segsum
    from opensplat_tpu_torch.tools.profiling import device_ms

    b = inp["binned"]
    c = b.cand_count.shape[0]
    n_isect = int(b.n_isects)
    lengths = b.cand_count.long()
    stream_rows = rows[b.cand_index.long()][:n_isect].contiguous()
    gids = b.gauss_ids[:n_isect].long()
    calls = {
        "segment_reduce": lambda: torch.segment_reduce(
            rows, "sum", lengths=lengths, axis=0, unsafe=True),
        "index_add_": lambda: torch.zeros(
            (c, 9), device=rows.device).index_add_(0, gids, stream_rows),
        "reduction_path": lambda: segsum.segment_sum(
            rows, b.cand_start, b.cand_count),
    }
    events = {k: time_ms(fn, 20) for k, fn in calls.items()}
    device = {k: device_ms(fn, 20) for k, fn in calls.items()}
    print("segsum yardsticks, ms per call: CUDA events (median of 20) "
          + json.dumps(events) + "; device (torch.profiler, 20 calls: ms, "
          "launches recorded) " + json.dumps(device) + "; with its sort of "
          "gauss_ids the reduction path (rows -> (C, 9)) took ~0.16 ms "
          "(PERF.md §6: sort ~0.11 device + segsum 0.0529 by events)",
          flush=True)
    return events


def refine_phase(n_points, size, n_steps, device):
    """Phase 5: train a fresh model past warm-up through Trainer.run_step,
    refining at steps 30 (stats cleared), 40 (alpha reset), 50 (densify
    with the huge-cull; capacity must grow) and 60. Returns the trainer
    and its cameras."""
    import torch

    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.ops.kernels import expand, raster, segsum
    from opensplat_tpu_torch.train import Trainer

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    state, cams = make_scene(n_points, size, 0, device)
    cfg = TrainConfig(num_downscales=0, sh_degree_interval=1,
                      warmup_length=20, refine_every=10, reset_alpha_every=3)
    trainer = Trainer(state, cams, cfg, device=device)
    refines = []
    run_refine = trainer._refine

    def timed_refine(step):
        cap0 = trainer.state.alive.shape[0]
        trainer.refine_metrics = None
        sync()
        t0 = time.perf_counter()
        run_refine(step)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        st = trainer.state
        refines.append(dict(
            step=step, ms=ms, cap_before=cap0, cap_after=st.alive.shape[0],
            metrics=trainer.refine_metrics, n_alive=int(st.alive.sum()),
            max_opacity=float(st.params.opacities.max())))

    trainer._refine = timed_refine
    wrappers = (expand.expand, raster.rasterize_forward,
                raster.rasterize_backward, segsum.segment_sum)
    for fn in wrappers:
        fn.launches = 0
    losses = []
    grown_at = None
    sync()
    t_all = time.perf_counter()
    for step in range(1, n_steps + 1):
        before = [fn.launches for fn in wrappers]
        if grown_at is not None and step == grown_at + 1:
            sync()
            t_steady = time.perf_counter()
        losses.append(trainer.run_step(step).loss)
        after = [fn.launches for fn in wrappers]
        # (on CPU tensors, in a rehearsal, the wrappers count nothing)
        if cuda and [a - b for a, b in zip(after, before)] != [1] * 4:
            raise AssertionError(f"refine phase, step {step}: launches "
                                 f"{before} -> {after}, not one each")
        if refines and refines[-1]["step"] == step and grown_at is None \
                and refines[-1]["cap_after"] > refines[-1]["cap_before"]:
            grown_at = step
    sync()
    t_end = time.perf_counter()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"refine phase: nonfinite loss: {losses}")
    for r in refines:
        print(f"  refine at step {r['step']}: {r['ms']:.2f} ms, capacity "
              f"{r['cap_before']} -> {r['cap_after']}, metrics "
              f"{json.dumps(r['metrics'])}", flush=True)
        m = r["metrics"]
        if m is not None and m["n_alive"] != r["n_alive"]:
            raise AssertionError(f"refine at step {r['step']}: n_alive "
                                 f"{m['n_alive']} != {r['n_alive']} alive")
    dens = [r for r in refines if r["metrics"] and "n_splits" in r["metrics"]
            and r["metrics"]["n_splits"] + r["metrics"]["n_dups"] > 0
            and r["cap_after"] > r["cap_before"]]
    if not dens:
        raise AssertionError("refine phase: no densify added Gaussians and "
                             "grew capacity")
    reset_logit = float(np.log(np.float32(0.2) / np.float32(0.8)))
    resets = [r for r in refines if r["metrics"] == {
        "n_alive": r["n_alive"]} and r["max_opacity"] <= reset_logit + 1e-6]
    if not resets:
        raise AssertionError("refine phase: no alpha reset")
    counts = [fn.launches for fn in wrappers]
    img = trainer.render(cams[0], n_steps)
    if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("refine phase: render wrong shape or nonfinite")
    steady = n_steps - grown_at
    print(f"refine: {n_points} g, {size} px, {n_steps} steps in "
          f"{t_end - t_all:.2f} s; densify at step {dens[0]['step']} "
          f"({dens[0]['ms']:.2f} ms) grew capacity {dens[0]['cap_before']} "
          f"-> {dens[0]['cap_after']}; alpha reset at step "
          f"{resets[0]['step']} ({resets[0]['ms']:.2f} ms); steady "
          f"{steady / (t_end - t_steady):.3f} steps/s over the {steady} "
          f"steps after growth; loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"launches {counts} in {n_steps} steps; "
          f"render {tuple(img.shape)} finite", flush=True)
    return trainer, cams


def check_variants(stream, label):
    """Phase 6's agreement: each variant kernel against its plain version
    on `stream`. The kernel's running prefix and the plain version's
    cumulative sum round differently, so a pixel whose stop test sits on
    the threshold can stop one record apart in the two, and its colour
    and T then differ by that record's whole contribution: final_idx must
    agree on >= 99.9% of pixels, and rgb and T are held to their
    tolerances where it agrees (everywhere in nostop, which never
    stops). Prints every variant's reading, then raises if any failed.
    Returns {variant: max_abs_err over all pixels} and the `full`
    kernel's final_idx."""
    import torch

    from opensplat_tpu_torch.ops.kernels import raster_variants as rv
    from opensplat_tpu_torch.tools import kbench_raster as kb

    args = kb.variant_args(stream)
    errs, failed = {}, []
    with torch.no_grad():
        for name in rv.VARIANTS:
            acc_k, fi_k = rv.rasterize_variant(name, *args)
            acc_p, fi_p = rv.rasterize_variant_plain(name, *args)
            d = (acc_k - acc_p).abs()
            errs[name] = float(d.max())
            if name == "full":
                fidx_full = fi_k
            if name == "skeleton":
                ok = torch.equal(acc_k, acc_p)
                what = "exact"
            else:
                same = fi_k == fi_p  # (T, 256)
                agree = float(same.float().mean())
                d = torch.where(same[:, None, :], d, 0.0)
                # notrans's rgb goes negative and grows: relative to its
                # largest |value|
                rgb_tol = (1e-4 * float(acc_p[:, :3].abs().max())
                           if name == "notrans" else 2e-4)
                e_rgb = float(d[:, :3].max())
                e_t = float(d[:, 3].max())
                ok = e_rgb <= rgb_tol and e_t <= 1e-5 and agree >= 0.999
                what = (f"final_idx differs at {int((~same).sum())} of "
                        f"{same.numel()} pixels (agreement {agree}, >= "
                        f"0.999); where it agrees rgb err {e_rgb} (atol "
                        f"{rgb_tol:.3g}), T err {e_t} (atol 1e-5)")
            print(f"[{label}] kbench_fwd {name}: max err {errs[name]}; "
                  f"{what}", flush=True)
            if not ok:
                failed.append(name)
    if failed:
        raise AssertionError(f"[{label}] kbench_fwd variants {failed} "
                             f"disagree with their plain versions")
    return errs, fidx_full


def check_full_vs_real(stream, label):
    """Phase 6: the bench's `full` kernel against the forward that runs,
    raster.rasterize_forward (`real`: gauss_ids = arange, zero
    background), on `stream`. They composite alike; `full` takes sigma
    from tile-centred features, stops in log space and folds T every 256
    records, `real` takes sigma from the pixel's offsets and multiplies
    T record by record, so a stop on the threshold can fall one record
    apart: check_variants' tolerances (final_idx equal on >= 99.9% of
    pixels; where it agrees, rgb atol 2e-4 and T atol 1e-5). Raises on
    disagreement."""
    import torch

    from opensplat_tpu_torch.ops.kernels import raster
    from opensplat_tpu_torch.ops.kernels import raster_variants as rv
    from opensplat_tpu_torch.tools import kbench_raster as kb

    args = list(kb.real_args(stream))
    args[7] = torch.zeros(3, device=stream.xys.device)
    h, w = args[8], args[9]
    with torch.no_grad():
        img, final_t, fi_r = raster.rasterize_forward(*args)
        acc, fi_f = rv.rasterize_variant("full", *kb.variant_args(stream))
    rgb = raster.image_to_tiles(img, stream.tb_x, stream.tb_y, h, w)
    t_r = raster.image_to_tiles(final_t, stream.tb_x, stream.tb_y, h, w)
    same = fi_f == fi_r
    agree = float(same.float().mean())
    d_rgb = (acc[:, :3].transpose(1, 2) - rgb).abs().amax(-1)
    e_rgb = float(torch.where(same, d_rgb, 0.0).max())
    e_t = float(torch.where(same, (acc[:, 3] - t_r).abs(), 0.0).max())
    print(f"[{label}] kbench_fwd full against raster_fwd (real): final_idx "
          f"differs at {int((~same).sum())} of {same.numel()} pixels "
          f"(agreement {agree}, >= 0.999); where it agrees rgb err {e_rgb} "
          f"(atol 2e-4), T err {e_t} (atol 1e-5)", flush=True)
    if not (agree >= 0.999 and e_rgb <= 2e-4 and e_t <= 1e-5):
        raise AssertionError(f"[{label}] kbench_fwd full disagrees with "
                             "raster_fwd")


def kbench_bound(stream, fidx, peak_bw, peak_ops):
    """(bound_ms, bound_by) of one `full` call with final_idx `fidx`,
    counted as bounds() counts raster_fwd: the (pixel, record) pairs each
    pixel replays up to its own stop x OPS_PER_PAIR_FWD, against each
    record its tile replays read once (36 bytes), the tile ranges and
    the outputs (acc, final_idx) written once."""
    from opensplat_tpu_torch.ops.kernels import raster_variants
    from opensplat_tpu_torch.ops.kernels.raster import (pairs_replayed,
                                                        records_replayed)

    n_tiles = stream.tile_start.shape[0]
    replay = records_replayed(stream.tile_start, stream.tile_end, fidx)
    pairs = pairs_replayed(stream.tile_start, stream.tile_end, fidx)
    steps = raster_variants.warp_steps(
        stream.tile_start, stream.tile_end, stream.xys, stream.conics,
        stream.opac, stream.tb_x, fidx)
    print(f"kbench work (full): {replay} records replayed, {pairs} (pixel, "
          f"record) pairs needed, {256 * replay} in tiles that run to their "
          f"last pixel's stop; (warp, record) steps {json.dumps(steps)}",
          flush=True)
    nbytes = replay * 36 + n_tiles * 8 + n_tiles * 256 * (8 + 1) * 4
    tb = nbytes / peak_bw * 1e3
    to = pairs * OPS_PER_PAIR_FWD / peak_ops * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "opensplat_tpu_torch", "csrc")):
        print("chip_smoke: FAIL: opensplat_tpu_torch/ not found beside "
              "chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_all = time.perf_counter()

    # phase 1: the card, and the kernels' build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit
    kind = torch.cuda.get_device_name(0)
    peak = next((v for k, v in PEAKS.items() if k in kind), None)
    if peak is None:
        raise RuntimeError(f"no published peaks for {kind!r}")
    from opensplat_tpu_torch.ops.kernels import (_lib, expand, raster,
                                                 raster_variants, segsum)

    t0 = time.perf_counter()
    _lib.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_lib.build_seconds:.1f} s)", flush=True)
    for line in _lib.build_log.splitlines():
        if "registers" in line or line.startswith("---"):
            print("  " + line.strip())
    for name, info in (("expand", expand.kernel_info),
                       ("raster_fwd", raster.forward_kernel_info),
                       ("raster_bwd", raster.backward_kernel_info),
                       ("kbench_fwd", raster_variants.kernel_info)):
        print(f"{name} build (CUDA runtime): " + json.dumps(info()),
              flush=True)
    # warp_steps counts the bench kernel's steps by the module's constants
    kb_info = raster_variants.kernel_info()
    if (kb_info["records_per_chunk"], kb_info["records_per_alpha_block"]) != (
            raster_variants.K, raster_variants.ALPHA_BLOCK):
        raise AssertionError(f"kbench_fwd build {kb_info} differs from "
                             "raster_variants.K and ALPHA_BLOCK")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: kernels against plain versions on the 16384 / 256 px scene,
    # again at 250 px (tiles padded past the image's edge), and the
    # segment sum on segments long enough for its whole-warp path
    for size in (256, 250):
        st16, cams16 = make_scene(16384, size, 0, "cuda")
        check_kernels(stage_inputs(st16, cams16[0], 3, 1),
                      f"16384 g, {size} px")
    del st16, cams16
    check_segsum_segments()
    check_expand_stress()

    # phase 3: training through the normal entry point at full width
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.train import Trainer

    state, cams = make_scene(131072, 512, 0, "cuda")
    cfg = TrainConfig(num_downscales=0, sh_degree_interval=1,
                      capacity_round=131072)
    trainer = Trainer(state, cams, cfg, device="cuda")
    wrappers = {"expand": expand.expand,
                "raster_fwd": raster.rasterize_forward,
                "raster_bwd": raster.rasterize_backward,
                "segsum": segsum.segment_sum}
    n_steps = 20
    for fn in wrappers.values():
        fn.launches = 0
    _lib.TIMES.reset()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    torch.cuda.synchronize()
    t_train = time.perf_counter()
    t_steady = None
    for step in range(1, n_steps + 1):
        if step == n_steps - 9:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
            _lib.TIMES.enabled = True
        out = trainer.run_step(step)
        losses.append(out.loss)
        metrics = out.metrics
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    _lib.TIMES.enabled = False
    launches = {k: fn.launches for k, fn in wrappers.items()}
    kernel_ms = {k: statistics.median(v)
                 for k, v in _lib.TIMES.millis().items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"nonfinite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    for k, n in launches.items():
        if n != n_steps:
            raise AssertionError(f"{k}: {n} launches in {n_steps} steps")
    steps_per_s = 10 / (t_end - t_steady)
    print(f"train: 131072 g, 512 px, 20 steps in {t_end - t_train:.2f} s; "
          f"steady {steps_per_s:.3f} steps/s over the last 10; loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB", flush=True)
    print("demand (last step): " + json.dumps(
        {k: int(metrics[k]) for k in ("n_cands", "n_isects", "n_grads")}))
    print("kernel ms per step (median of the last 10, CUDA events): "
          + json.dumps({k: round(v, 4) for k, v in kernel_ms.items()}))
    missing = set(wrappers) - set(kernel_ms)
    if missing:
        raise AssertionError(f"no CUDA-event time for {sorted(missing)}")
    # the table's device_ms: each kernel's device time per recorded
    # launch (one launch a step), without the host's launch gap
    dev_ms = profile_steps(trainer, n_steps + 1, 3, 1e3 / steps_per_s)
    print("kernel device ms per launch (torch.profiler, 3 steps: ms, "
          "launches recorded): " + json.dumps(dev_ms), flush=True)

    # phase 4: main-path shapes — agreement, plain and library times, bounds
    inp = stage_inputs(trainer.state, cams[0], 3, 2)
    if inp["img"].shape != (512, 512, 3) or not bool(
            torch.isfinite(inp["img"]).all()):
        raise AssertionError("rendered image: wrong shape or nonfinite")
    errs, g_rec = check_kernels(inp, "131072 g, 512 px (main path)")
    check_determinism(inp)
    b = inp["binned"]
    sargs = (g_rec, b.cand_start, b.cand_count)
    plain = {
        "expand": lambda: expand.expand_plain(*inp["expand"]),
        "raster_fwd": lambda: raster.rasterize_forward_plain(*inp["fwd"]),
        "raster_bwd": lambda: raster.rasterize_backward_plain(*inp["bwd"]),
        "segsum": lambda: segsum.segment_sum_plain(*sargs),
    }
    plain_ms = {k: time_ms(fn, 5) for k, fn in plain.items()}
    yard = segsum_yardsticks(inp, g_rec)
    library_ms = min(yard["segment_reduce"], yard["index_add_"])
    tile_balance(inp)
    bnd = bounds(inp, *peak)

    # phase 5: refine past warm-up on the card, then the kernels against
    # their plain versions at the grown capacity, dead slots and all
    ref_trainer, ref_cams = refine_phase(131072, 512, 60, "cuda")
    st = ref_trainer.state
    cap, n_alive = st.alive.shape[0], int(st.alive.sum())
    check_kernels(stage_inputs(st, ref_cams[0], 3, 3),
                  f"grown capacity {cap}, {n_alive} alive")
    del ref_trainer, ref_cams, st

    # phase 6: the forward-kernel ablation bench — agreement on small
    # and uneven streams first, then at the bench's own default stream
    from opensplat_tpu_torch.tools import kbench_raster

    small = kbench_raster.make_stream(64, 1074, 8, device="cuda")
    check_variants(small, "64 tiles x 1074 records")
    check_variants(kbench_raster.uneven_stream("cuda"),
                   "uneven tiles over 1200 records")
    check_variants(kbench_raster.residue_stream("cuda"),
                   "257 tiles x 257 records (every start residue)")
    check_variants(kbench_raster.cull_stream(device="cuda"),
                   "64 tiles x 512 records (warp cull)")
    stream = kbench_raster.make_stream(device="cuda")
    bench_label = f"{stream.tile_start.shape[0]} tiles x 1074 records (bench)"
    v_errs, fidx_full = check_variants(stream, bench_label)
    check_full_vs_real(small, "64 tiles x 1074 records")
    check_full_vs_real(stream, bench_label)
    raster_variants.rasterize_variant.launches = 0
    bench = kbench_raster.main([])  # its default stream, median of 30
    launches["kbench_fwd"] = raster_variants.rasterize_variant.launches
    if launches["kbench_fwd"] == 0:
        raise AssertionError("the bench launched no variant kernel")
    print("kbench ms per call (median of 30, CUDA events): "
          + json.dumps({k: round(v[0], 4) for k, v in bench.items()})
          + "; device (torch.profiler, 10 calls: ms, launches recorded) "
          + json.dumps({k: v[2] for k, v in bench.items()}), flush=True)
    vargs = kbench_raster.variant_args(stream)
    bnd["kbench_fwd"] = kbench_bound(stream, fidx_full, *peak)
    plain_ms["kbench_fwd"] = time_ms(
        lambda: raster_variants.rasterize_variant_plain("full", *vargs), 3)
    dev_ms["kbench_fwd"] = bench["full"][2]
    kernel_ms["kbench_fwd"] = bench["full"][0]
    errs["kbench_fwd"] = v_errs["full"]

    table = []
    for k, (src, rep) in KERNELS.items():
        table.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[k], "max_abs_err": errs[k],
            "ms": kernel_ms[k], "plain_ms": plain_ms[k],
            "bound_ms": bnd[k][0], "bound_by": bnd[k][1],
            "library_ms": library_ms if k == "segsum" else None,
            "device_ms": dev_ms.get(k, (None,))[0],
        })
    for row in table:
        print(f"  {row['name']:<10} {row['ms']:.4f} ms  device "
              f"{row['device_ms']} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})  plain {row['plain_ms']:.3f} ms  "
              f"launches {row['launches']}")
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    if "jax" in sys.modules or "opensplat_tpu" in sys.modules:
        raise AssertionError("jax or opensplat_tpu was imported")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
