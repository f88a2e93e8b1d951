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
     require bitwise-equal outputs; time the plain versions (one call
     after a warm-up: the plain rasterizers take seconds) and segment
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
     the (warp, record) steps `full` takes there;
  7. the CLI end to end: tools/make_synthetic_project.py writes a
     nerfstudio project (16 cameras at 512 px, the GT rendered on the
     card, sparse.ply = 131072 GT means jittered), and
     opensplat_tpu_torch.cli.main trains it for 300 steps (256 px to
     step 100, then 512; SH degree 3 by step 300; warm-up and refine
     every 50, so step 100 densifies; a validation camera; checkpoints
     at 150 and 300; the oracle check), with every training kernel's
     counter set to 0 before and read after; it prints the load time,
     steps/s from the metrics file, the loss, the refines' Gaussians
     before and after, the validation loss and PSNR, the oracle PSNR
     (raises below 30 dB), the files written and the launches (raises
     below one a step). Then ckpt_300.npz and the scene are deleted and
     --auto-resume trains steps 151-300 again: the scene must equal the
     uninterrupted run's (alive masks equal, rtol 1e-5; it says whether
     bitwise). cv2 and PIL must not have been imported.
  8. the conformance renderers on phase 3's model (131072 Gaussians, 512
     px, SH degree 3) and camera 0: (a) render_forward's forward and
     backward with "fast", "tiled" and "dense", each timed (wall ms
     between CUDA events, with a synchronize), tiled held to fast by the
     JAX suite's renderer tolerance (tests/test_rasterize.py:33) and
     dense by its tiled-vs-dense tolerances (tests/
     test_rasterize_tiled.py:52-55, 88-91) on the image, final T and
     every leaf's gradient; dense runs at the headline only if an eighth
     of the Gaussians, timed first, extrapolates to 60 s or less, else
     on phase 2's 16384-Gaussian 256 px scene (printed); (b) tiled twice,
     bitwise equal, launching expand and segsum and neither raster
     kernel; (c) gsplat_compat.map_gaussian_to_intersects (full-bbox
     binning, one expand launch) torch.equal to its plain version, all
     sum(num_tiles_hit) keys kept; (d) render_depth in both modes:
     finite, alpha = 1 - the tiled final T; (e) Trainer(renderer=
     "tiled") 2 steps from phase 3's initial state, step 1's loss within
     rel 1e-3 of the fast Trainer's, steps/s; (f) cli.main --renderer
     tiled for 2 steps on phase 7's project: exit 0, finite losses, a
     scene.
  9. parallel/ on rank processes that share the card (gloo; this
     script's rank_* functions started by opensplat_tpu_torch/parallel/
     launch.py, each with a time limit) at the headline width (131072
     Gaussians, 512 px, SH degree 3): (a) DPTrainer on 2 ranks against
     DPTrainer on one NCCL rank (this process) with d_local 2, 20 steps
     through the step-20 densify; (b) on 2 ranks gs_render and one
     gs_train_step against render_image and train_step_impl, and
     GSTrainer through a refine that grows capacity against Trainer;
     (c) the hybrid on 2 x 2 ranks for 3 steps against (a)'s one-rank
     run; (d) MultiSceneTrainer with two scenes against two Trainers
     (bitwise; its batched step launches each training kernel once a
     step for both scenes), and multi_scene_cli --sharded over 2 ranks
     on phase 7's
     project and a second one at 256 px; (e) cli --distributed
     --data-parallel -1 over 2 ranks on phase 7's project. Tolerances:
     parallel_phase's docstring. Every rank must launch the four
     training kernels; a rank that fails, times out or misses a check
     fails the run. Steps/s per path is printed with the card; ranks
     that share a card measure correctness, not scaling.
 10. the port bench and the step profiler: (a) `python -m
     opensplat_tpu_torch.bench`, the default sweep (16384 Gaussians at
     256 px up to 1048576 at 1080 px): five lines, the 131072 / 512 px
     headline last with a sweep of four, every value finite and
     positive, every line naming this card; (b) the 1048576-Gaussian
     1080 px model (SH degree 3, the first full-width size whose edge
     tiles are padded): three train_steps, finite losses, each training
     kernel launched once a step, peak memory and demand, the tile
     balance and each kernel's bound from this run's data, and
     profile_step's anatomy at every sweep size; (c) the four training
     kernels against their plain versions at 1080 px, whole, at phase
     4's tolerances; (d) each parallel mode of the bench once at 131072
     Gaussians, 512 px, BENCH_ITERS=10 (DP 2, MP 2, the 2 x 2 hybrid,
     two scenes over 2 ranks), on gloo ranks sharing the card, each
     printing rank 0's one line.
 11. the batched multi-view step at the headline width on bench.py's
     scene with seeds 0-3: (a) for S = 2 and S = 4 scenes and D = 2
     cameras on one state, one launch of expand, raster_fwd, raster_bwd
     and segsum on the views' batch equals one launch a view bitwise,
     each counter advances by one per batched call, and the batched
     kernels agree with their batched plain versions at phase 4's
     tolerances; (b) 20 steps of multi_scene_train_step (S = 2, 4)
     against S train_step_impl calls, losses and states bitwise, and 20
     batched_train_steps (D = 2) against the loop formulation kept in
     the phase (loss rtol 1e-5, params rtol 2e-4 atol 1e-5), each
     kernel launched once a step; (c) host-clock scene-steps/s of the
     batched step beside S single steps, launches a step (the kernels;
     PyTorch's elementwise kernels by torch.profiler) and one
     BENCH_SCENES=2 bench line (s2-vmap); then tests/
     test_torch_grad_sanitize.py's degenerate splats through the CUDA
     raster_bwd, one view and a batch of two: every gradient finite.
 12. the SSIM kernel pair (csrc/ssim.cu) at 800 x 800 and 1297 x 840
     against its plain version and a float64 direct SSIM, timed beside
     its bound, its plain version and the parent's banded-GEMM SSIM,
     and untimed at tests/test_torch_ssim.py's small shapes and the
     downscaled training sizes; a 4-view main_loss launching each
     kernel entry once a view, with no cuBLAS kernel (ssim_phase).
The line before the last is the {"kernels": [...]} table (with each
training kernel's phase-7 launches as `cli_launches`, expand's and
segsum's over phase 8's tiled Trainer steps as `tiled_launches`, rank
0's launches on each phase-9 path as `parallel_launches`, and phase
10's three 1080 px steps' launches, device ms per launch and bound as
`sweep_launches`, `device_ms_1080` and `bound_ms_1080`, and phase 11's
launches over each path's 20 batched steps as `batched_launches`; the
`ssim` row is phase 12's at 800 x 800, its `library_ms` the banded-GEMM
SSIM's, its `garden` the 1297 x 840 figures, and its `cli_launches`,
`parallel_launches` and `batched_launches` the [forward, backward]
launches of phases 7, 9 and 11, one a view); the last line
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
    """bench.py's scene (bench.bench_scene): points uniform in
    [-1.5, 1.5]^3, random colours and ground truth, camera at z = +6 with
    fx = fy = 0.9 * size, plus two cameras at small offsets."""
    from opensplat_tpu_torch.bench import bench_scene
    from opensplat_tpu_torch.models.gaussians import init_model

    sc = bench_scene(n_points, size, seed)
    state = init_model(sc.pts, sc.rgb, sh_degree=3, capacity=n_points,
                       seed=seed, device=device)
    cams = [Camera(e, size, sc.gt) for e in
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
                binned=binned, fidx=fidx, img=img, proj=proj)


def check_kernels(inp, label, direct=True):
    """Each kernel against its plain version on the same inputs; raises
    on disagreement. Returns {kernel: max_abs_err} and the gradient rows.
    With `direct` raster_bwd is also held to the float64 direct sums."""
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
        if direct:
            g_d = raster.rasterize_backward_direct(*inp["bwd"])
            scale = float(g_d.abs().max()) + 1e-30
            diff = (g_k.double() - g_d).abs()
            bad = diff > 1e-3 * g_d.abs() + 1e-5 * scale
            if bool(bad.any()):
                raise AssertionError(
                    f"[{label}] raster_bwd: {int(bad.sum())} of "
                    f"{bad.numel()} gradient values outside rtol 1e-3, "
                    f"atol 1e-5*max|g| of the direct float64 sums")
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


def cli_phase(n_points, size, n_steps, device, tmp):
    """Phase 7: the CLI end to end. Writes a synthetic nerfstudio project
    into tmp/project (tools/make_synthetic_project.py: 16 cameras at
    `size` px, the GT rendered on `device`, sparse.ply = the n_points GT
    means jittered),
    trains it through opensplat_tpu_torch.cli.main for n_steps steps
    (256 then 512 px, SH degree 3 by the end, a densifying refine at a
    sixth of the steps, a validation camera, checkpoints every half,
    the oracle check), deletes the last checkpoint and the scene, runs
    again with --auto-resume and compares the scenes. Raises on a
    failed check; returns each training kernel's and SSIM entry's launch
    count over the first run."""
    import contextlib
    import io
    import shutil

    import torch

    from opensplat_tpu_torch import cli
    from opensplat_tpu_torch.io import load_ply
    from opensplat_tpu_torch.models.gaussians import PARAM_NAMES
    from opensplat_tpu_torch.tools.make_synthetic_project import make_project

    cuda = torch.device(device).type == "cuda"
    third, sixth, half = n_steps // 3, n_steps // 6, n_steps // 2
    wrappers = counted_wrappers()
    proj, out = os.path.join(tmp, "project"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    n_sparse = make_project(proj, cams=16, points=n_points, res=size,
                            sparse_frac=1.0, jitter=0.02, device=device,
                            verbose=False)
    print(f"cli: project written in {time.perf_counter() - t0:.2f} s "
          f"(16 cameras at {size} px, {n_sparse} sparse points, GT "
          f"rendered on {device})", flush=True)
    scene = os.path.join(out, "scene.ply")
    # a densifying refine needs step < n_steps / 2 (the reference's
    # stop_split_at): warm-up and refine interval a sixth of the run
    args = [proj, "-o", scene, "-n", str(n_steps), "--sh-degree", "3",
            "--sh-degree-interval", str(third), "--num-downscales", "1",
            "--resolution-schedule", str(third),
            "--warmup-length", str(sixth), "--refine-every", str(sixth),
            "--val", "--checkpoint-every", str(half), "--ckpt-dir", out]
    if not cuda:
        args.append("--cpu")

    def run(extra, label):
        """cli.main(args + extra): its stdout's lines and the wall
        time."""
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args + extra)
        lines = buf.getvalue().splitlines()
        if rc != 0:
            raise AssertionError(f"cli ({label}) returned {rc}:\n"
                                 + "\n".join(lines))
        return lines, time.perf_counter() - t

    def line(lines, part):
        found = [ln for ln in lines if part in ln]
        if not found:
            raise AssertionError(f"cli printed no {part!r} line:\n"
                                 + "\n".join(lines[-20:]))
        return found[0]

    for fn in wrappers.values():
        fn.launches = 0
    mfile = os.path.join(tmp, "metrics.jsonl")
    lines, wall = run(["--oracle-check", "--metrics-file", mfile], "run")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"cli: {line(lines, 'Using ')}; {line(lines, 'Loaded ')}; "
          f"{n_steps} steps in {wall:.2f} s (whole run)", flush=True)
    recs = [json.loads(r) for r in open(mfile)]
    steps = {r["step"]: r for r in recs if r["type"] == "step"}
    refines = [r for r in recs if r["type"] == "refine"]
    losses = [steps[k]["loss"] for k in sorted(steps)]
    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"cli: {len(losses)} step records, "
                             f"nonfinite: {not all(np.isfinite(losses))}")
    print("cli steps/s (metrics file, rolling 50 steps, every step "
          "read back) and the Gaussians alive at that step: "
          + json.dumps({
              f"{px} px, step {k}": {
                  "steps_per_sec": steps[k]["steps_per_sec"],
                  "n_gaussians": steps[k]["n_gaussians"]}
              for px, k in ((size // 2, third - 10),
                            (size, 2 * third - 10),
                            (size, n_steps - 10))}), flush=True)
    psnrs = [steps[k]["psnr"] for k in sorted(steps)]
    print(f"cli loss: steps 1-10 mean {np.mean(losses[:10]):.5f}, last "
          f"10 mean {np.mean(losses[-10:]):.5f}; train PSNR last 10 "
          f"mean {np.mean(psnrs[-10:]):.3f} dB")
    if not np.mean(losses[-10:]) < np.mean(losses[:10]):
        raise AssertionError("cli: the loss did not fall")
    dens = [r for r in refines
            if r.get("n_splits", 0) + r.get("n_dups", 0)]
    if not dens:
        raise AssertionError(f"cli: no densifying refine: {refines}")
    for r in refines:
        print(f"cli refine at step {r['step']}: Gaussians "
              f"{steps[r['step']]['n_gaussians']} -> {r['n_alive']}; "
              + json.dumps({k: v for k, v in r.items()
                            if k not in ("type", "step", "n_alive")}))
    print(f"cli Gaussians: {n_sparse} at step 1, "
          f"{steps[n_steps]['n_gaussians']} at step {n_steps}")
    val = line(lines, "validation loss:")
    vloss = float(val.split("validation loss:")[1].split()[0])
    vpsnr = float(val.split("(PSNR ")[1].split()[0])
    oracle = line(lines, "oracle-check")
    opsnr = float(oracle.split("PSNR ")[1].split()[0])
    print(f"cli validation: loss {vloss:.6f}, PSNR {vpsnr:.3f} dB "
          f"({val.split()[0]})")
    print(f"cli {oracle}", flush=True)
    if not (np.isfinite(vloss) and opsnr >= 30.0):
        raise AssertionError(f"cli: validation loss {vloss}, oracle "
                             f"PSNR {opsnr} dB (needs >= 30)")
    files = sorted(os.listdir(out))
    print("cli files: " + ", ".join(
        f"{f} ({os.path.getsize(os.path.join(out, f))} B)" for f in files))
    for f in ("scene.ply", "cameras.json", f"ckpt_{half}.npz",
              f"ckpt_{n_steps}.npz"):
        if f not in files:
            raise AssertionError(f"cli: {f} not written")
    print("cli kernel launches over the run (training steps, val and "
          "oracle renders): " + json.dumps(launches), flush=True)
    for k, n in launches.items():
        # (on CPU tensors, in a rehearsal, the wrappers count nothing)
        if cuda and n < n_steps:
            raise AssertionError(f"cli: {k} launched {n} times in "
                                 f"{n_steps} steps")

    # resume: the last checkpoint and the scene are gone (the crash)
    ref = os.path.join(tmp, "uninterrupted.ply")
    shutil.move(scene, ref)
    os.remove(os.path.join(out, f"ckpt_{n_steps}.npz"))
    lines, wall = run(["--auto-resume"], "resume")
    print(f"cli resume: {line(lines, 'Resuming from')}; "
          f"{n_steps - half} steps in {wall:.2f} s", flush=True)
    bitwise = open(ref, "rb").read() == open(scene, "rb").read()
    a, _ = load_ply(ref, device="cpu")
    b, _ = load_ply(scene, device="cpu")
    if not torch.equal(a.alive, b.alive):
        raise AssertionError("cli resume: alive masks differ")
    worst = {}
    for name in PARAM_NAMES:
        x, y = getattr(a.params, name), getattr(b.params, name)
        worst[name] = float((x - y).abs().max()) if x.numel() else 0.0
        if not torch.allclose(y, x, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"cli resume: {name} differs from the "
                                 f"uninterrupted run by {worst[name]}")
    print(f"cli resume: the scene equals the uninterrupted run's "
          f"({'bitwise' if bitwise else 'within rtol 1e-5'}; "
          f"{int(a.alive.sum())} Gaussians; max abs diff "
          + json.dumps(worst) + ")", flush=True)
    for mod in ("cv2", "PIL"):
        if mod in sys.modules:
            raise AssertionError(f"phase 7 imported {mod}")
    return launches


def bulk_close(got, want, rel_tol=1e-3, bulk=0.99, max_rel=0.05):
    """The JAX suite's renderer tolerance (tests/test_rasterize.py:33):
    rel_tol on `bulk` of the entries, max_rel everywhere (relative to
    max(|want|, 1e-3 of its scale)), norms within 2e-3. Returns the
    failure, or None, and (share within rel_tol, max rel)."""
    got = np.asarray(got, np.float64).reshape(np.shape(want))
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-12
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3 * scale)
    ok, worst = float((rel <= rel_tol).mean()), float(rel.max())
    n1, n2 = np.linalg.norm(got), np.linalg.norm(want)
    fail = None
    if ok < bulk:
        fail = f"only {ok:.4f} within rtol {rel_tol}"
    elif worst > max_rel:
        fail = f"max rel err {worst:.4f}"
    elif abs(n1 - n2) > 2e-3 * max(n2, 1e-12):
        fail = f"norms {n1} vs {n2}"
    return fail, (ok, worst)


def dense_close(got, want, kind):
    """The JAX suite's tolerances between its tiled and dense renderers
    (tests/test_rasterize_tiled.py:52-55, 88-91): images within 1e-3 on
    98% of pixels and 3e-2 everywhere, final T within 3e-2; gradients
    within 1e-2 (relative to max(|want|, 1e-2 of its scale)) on 97% and
    norms within 2e-2. Returns the failure, or None, and the readings."""
    got = np.asarray(got, np.float64).reshape(np.shape(want))
    want = np.asarray(want, np.float64)
    if kind == "image":
        d = np.abs(got - want).max(-1)
        ok, worst = float((d <= 1e-3).mean()), float(d.max())
        fail = (None if ok >= 0.98 and worst <= 3e-2
                else f"{1 - ok:.4f} of pixels off, max {worst}")
    elif kind == "final_T":
        ok, worst = 1.0, float(np.abs(got - want).max())
        fail = None if worst <= 3e-2 else f"max diff {worst}"
    else:
        scale = np.abs(want).max() + 1e-12
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2 * scale)
        ok, worst = float((rel <= 1e-2).mean()), float(rel.max())
        n1, n2 = np.linalg.norm(got), np.linalg.norm(want)
        fail = None
        if abs(n1 - n2) > 2e-2 * max(n2, 1e-9):
            fail = f"norms {n1} vs {n2}"
        elif ok < 0.97:
            fail = f"{1 - ok:.4f} off"
    return fail, (ok, worst)


def render_grads(params, alive, cam, sh_deg, renderer, seed):
    """render_forward with `renderer`, then the gradients of one fixed
    scalar of the image and final T (weights from `seed`) with respect to
    every parameter leaf. Returns (image, final T, {leaf: gradient}, the
    forward's ms, the backward's ms) — wall ms between CUDA events around
    each pass, with a synchronize (host clock on the CPU)."""
    import torch

    from opensplat_tpu_torch.models.gaussians import (PARAM_NAMES,
                                                      GaussianParams)
    from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                        render_forward)

    dev = alive.device
    h = w = cam.width
    gen = torch.Generator(device=dev).manual_seed(seed)
    w_img = torch.randn((h, w, 3), generator=gen, device=dev)
    w_t = torch.randn((h, w), generator=gen, device=dev)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.as_dict().items()}

    def fwd():
        return render_forward(
            GaussianParams(**leaves), alive,
            torch.as_tensor(cam.cam_to_world, device=dev), cam.fx, cam.fy,
            cam.cx, cam.cy, h, w, sh_deg,
            torch.tensor(DEFAULT_BACKGROUND, device=dev), renderer=renderer,
            device=dev)

    out, fwd_ms = wall_ms(fwd, dev)
    loss = torch.sum(out.rgb * w_img) + torch.sum(out.final_t * w_t)
    grads, bwd_ms = wall_ms(lambda: torch.autograd.grad(
        loss, [leaves[k] for k in PARAM_NAMES]), dev)
    return (out.rgb.detach(), out.final_t.detach(),
            dict(zip(PARAM_NAMES, grads)), fwd_ms, bwd_ms)


def wall_ms(fn, dev):
    """(fn(), its wall ms): CUDA events around it and a synchronize on
    the card, the host clock on the CPU."""
    import torch

    if torch.device(dev).type != "cuda":
        t = time.perf_counter()
        r = fn()
        return r, (time.perf_counter() - t) * 1e3
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    r = fn()
    e.record()
    torch.cuda.synchronize()
    return r, s.elapsed_time(e)


def hold(label, ref, other, check):
    """Image, final T and each leaf's gradient of `other` against `ref`
    (render_grads results) by `check` (bulk_close or dense_close);
    prints the readings, raises on a failure."""
    pairs = [("image", ref[0], other[0]), ("final_T", ref[1], other[1])]
    pairs += [(k, ref[2][k], other[2][k]) for k in ref[2]]
    readings, fails = {}, []
    for name, a, b in pairs:
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if check is dense_close:
            fail, r = dense_close(b, a, name if name in ("image", "final_T")
                                  else "grad")
        else:
            fail, r = bulk_close(b, a)
        readings[name] = [round(r[0], 5), float(f"{r[1]:.3g}")]
        if fail:
            fails.append(f"{name}: {fail}")
    print(f"conformance {label} (share within tolerance, worst): "
          + json.dumps(readings), flush=True)
    if fails:
        raise AssertionError(f"conformance {label}: " + "; ".join(fails))


def anisotropic(params, seed=1):
    """`params` with scales moved by uniform +-0.5 in log space (as
    tests/test_torch_train_step.py does), so that rotations carry real
    gradients: with isotropic scales the render does not depend on the
    rotation, and the quats' gradients are rounding noise."""
    import torch

    d = np.random.default_rng(seed).uniform(-0.5, 0.5, params.scales.shape)
    return type(params)(**{**params.as_dict(), "scales": params.scales
                           + torch.as_tensor(d.astype(np.float32),
                                             device=params.scales.device)})


def conformance_phase(state, cam, project, device, fresh_scene, card):
    """Phase 8: the conformance renderers (dense, tiled), render_depth,
    gsplat_compat's full-bbox binning, Trainer(renderer="tiled") and the
    CLI's --renderer tiled, on the card. `state` and `cam` are the
    headline model's; `project` phase 7's project; fresh_scene() makes
    phase 3's untrained state and cameras anew; `card` (nvidia-smi's
    name and power limit) is printed beside every time. Raises on a
    failed check;
    returns the expansion's and the segment sum's launches over the
    tiled Trainer's steps (this slice's main path)."""
    import contextlib
    import io

    import torch

    from opensplat_tpu_torch import cli, gsplat_compat
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.models.splat_model import render_depth
    from opensplat_tpu_torch.ops.camera import camera_matrices
    from opensplat_tpu_torch.ops.kernels import expand, raster, segsum
    from opensplat_tpu_torch.train import Trainer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    c = state.alive.shape[0]
    size = cam.width
    counted = {"expand": expand.expand, "segsum": segsum.segment_sum,
               "raster_fwd": raster.rasterize_forward,
               "raster_bwd": raster.rasterize_backward}

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counted.items()}

    # (a) each renderer's forward and backward, held to the fast path
    params = anisotropic(state.params)
    pa = (params, state.alive, cam, 3)
    fast = render_grads(*pa, "fast", 8)
    zero()
    tiled = render_grads(*pa, "tiled", 8)
    tiled_counts = read()
    clock = ("wall, CUDA events" if cuda else "wall, host clock") + (
        f"; {card}")
    for name, r in (("fast", fast), ("tiled", tiled)):
        print(f"conformance {name}: {c} g, {size} px, forward "
              f"{r[3]:.1f} ms, backward {r[4]:.1f} ms ({clock})", flush=True)
    hold(f"tiled against fast ({c} g, {size} px; rel 1e-3 on 99%, max rel "
         "0.05, norms 2e-3)", fast, tiled, bulk_close)
    # dense is O(N x pixels): time it on an eighth of the Gaussians first
    sub = c // 8
    est = render_grads(type(params)(**{
        k: v[:sub] for k, v in params.as_dict().items()}),
        state.alive[:sub], cam, 3, "dense", 8)
    est_s = (est[3] + est[4]) * (c / sub) / 1e3
    print(f"conformance dense: {sub} g at {size} px took "
          f"{est[3]:.0f} + {est[4]:.0f} ms; at {c} g about {est_s:.1f} s",
          flush=True)
    del est
    if est_s <= 60.0:
        dense = render_grads(*pa, "dense", 8)
        ref, label = fast, f"{c} g, {size} px"
    else:  # the cut: phase 2's scene
        small, small_cams = fresh_scene(16384, 256)
        sa = (anisotropic(small.params), small.alive, small_cams[0], 3)
        ref = render_grads(*sa, "fast", 8)
        dense = render_grads(*sa, "dense", 8)
        label = (f"16384 g, 256 px: cut from {c} g, {size} px, whose "
                 f"estimate {est_s:.1f} s exceeds 60 s")
        del small, small_cams
    print(f"conformance dense: {label}, forward {dense[3]:.1f} ms, backward "
          f"{dense[4]:.1f} ms ({clock})", flush=True)
    hold(f"dense against fast ({label}; the JAX suite's tiled-vs-dense "
         "tolerances)", ref, dense, dense_close)
    del dense, ref

    # (b) the tiled path twice: bitwise equal; it ran the two kernels
    zero()
    again = render_grads(*pa, "tiled", 8)
    counts_b = read()
    named = [("image", tiled[0], again[0]), ("final T", tiled[1], again[1])]
    named += [(f"grad {k}", tiled[2][k], again[2][k]) for k in tiled[2]]
    for name, x, y in named:
        if not torch.equal(x, y):
            raise AssertionError(
                f"tiled not deterministic: {name} differs at "
                f"{int((x != y).sum())} of {x.numel()} places")
    print("conformance determinism: tiled forward and backward run twice; "
          "image, final T and every leaf's gradient bitwise equal; "
          "launches in one run " + json.dumps(counts_b)
          + " (the first: " + json.dumps(tiled_counts) + ")", flush=True)
    if cuda and (counts_b["expand"] < 1 or counts_b["segsum"] < 1
                 or counts_b["raster_fwd"] or counts_b["raster_bwd"]):
        raise AssertionError(f"tiled path launches: {counts_b}")
    del again

    # (c) gsplat's full-bbox intersections against the plain version
    with torch.no_grad():
        p = params
        viewmat, full_proj, _ = camera_matrices(
            torch.as_tensor(cam.cam_to_world, device=dev), cam.fx, cam.fy,
            size, size)
        _, xys, depths, radii, _, nth = gsplat_compat.project_gaussians_forward(
            p.means, torch.exp(p.scales), 1.0,
            p.quats / torch.linalg.norm(p.quats, dim=-1, keepdim=True),
            viewmat, full_proj, cam.fx, cam.fy, cam.cx, cam.cy, size, size)
        cum = torch.cumsum(nth.long(), 0)
        total = int(cum[-1])
        tb = ((size + 15) // 16, (size + 15) // 16, 1)
        args = (c, total, xys, depths, radii, cum, tb)
        expand.expand.launches = 0
        keys, ids = gsplat_compat.map_gaussian_to_intersects(*args)
        n_exp = expand.expand.launches
        pk, pi = gsplat_compat.map_gaussian_to_intersects(
            *[a.cpu() if torch.is_tensor(a) else a for a in args])
        kept = int((keys >> 32 < tb[0] * tb[1]).sum())
    if not (torch.equal(keys.cpu(), pk) and torch.equal(ids.cpu(), pi)):
        raise AssertionError("map_gaussian_to_intersects differs from its "
                             "plain version")
    if kept != total or (cuda and n_exp != 1):
        raise AssertionError(f"full-bbox binning: {kept} keys kept of "
                             f"{total}, {n_exp} expand launches")
    print(f"conformance gsplat map_gaussian_to_intersects: {total} "
          f"intersections (= sum(num_tiles_hit)), keys and ids torch.equal "
          f"to the plain version; expand launched {n_exp}x", flush=True)

    # (d) render_depth in both modes: finite, alpha = 1 - tiled final T
    for mode in ("expected", "accumulated"):
        with torch.no_grad():
            (depth, alpha), ms = wall_ms(lambda: render_depth(
                params, state.alive,
                torch.as_tensor(cam.cam_to_world, device=dev), cam.fx,
                cam.fy, cam.cx, cam.cy, size, size, mode=mode, device=dev),
                dev)
        diff = float((alpha - (1.0 - tiled[1])).abs().max())
        if not (bool(torch.isfinite(depth).all()) and diff <= 1e-6):
            raise AssertionError(f"render_depth {mode}: finite "
                                 f"{bool(torch.isfinite(depth).all())}, "
                                 f"alpha off 1 - final T by {diff}")
        hit = depth[alpha > 0.5]
        print(f"conformance render_depth {mode}: {ms:.1f} ms ({clock}); "
              f"depth "
              f"{float(hit.min()):.4f}..{float(hit.max()):.4f} where alpha "
              f"> 0.5 ({hit.numel()} px); alpha vs 1 - final T max diff "
              f"{diff:.3g}", flush=True)
    del tiled, fast

    # (e) Trainer(renderer="tiled") from phase 3's initial state
    cfg = TrainConfig(num_downscales=0, sh_degree_interval=1,
                      capacity_round=131072)
    st_fast, cams_fast = fresh_scene(c, size)
    loss_fast = Trainer(st_fast, cams_fast, cfg, device=dev).run_step(1).loss
    del st_fast, cams_fast
    st, cams = fresh_scene(c, size)
    tr = Trainer(st, cams, cfg, renderer="tiled", device=dev)
    zero()
    losses = [tr.run_step(1).loss]

    _, ms = wall_ms(lambda: losses.append(tr.run_step(2).loss), dev)
    counts_e = read()
    rel = abs(losses[0] - loss_fast) / abs(loss_fast)
    print(f"conformance Trainer(renderer='tiled'): {c} g, {size} px, "
          f"losses {[round(v, 6) for v in losses]}; step 1 against the "
          f"fast Trainer's {loss_fast:.6f}: rel {rel:.3g}; step 2 at "
          f"{1e3 / ms:.3f} steps/s ({card}); launches "
          + json.dumps(counts_e),
          flush=True)
    if not (np.all(np.isfinite(losses)) and rel <= 1e-3):
        raise AssertionError(f"tiled Trainer: losses {losses}, step 1 rel "
                             f"{rel} against fast")
    if cuda and (counts_e["expand"] < 2 or counts_e["segsum"] < 2
                 or counts_e["raster_fwd"] or counts_e["raster_bwd"]):
        raise AssertionError(f"tiled Trainer launches: {counts_e}")
    del tr, st, cams

    # (f) the CLI with --renderer tiled on phase 7's project
    out = os.path.join(os.path.dirname(project), "tiled_out", "scene.ply")
    mfile = os.path.join(os.path.dirname(project), "tiled.jsonl")
    buf = io.StringIO()
    zero()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([project, "-o", out, "-n", "2", "--renderer", "tiled",
                       "--num-downscales", "1", "--sh-degree", "3",
                       "--metrics-file", mfile] + ([] if cuda else ["--cpu"]))
    wall = time.perf_counter() - t
    counts_f = read()
    losses = [json.loads(r)["loss"] for r in open(mfile)
              if json.loads(r)["type"] == "step"]
    if rc != 0 or not os.path.exists(out) or len(losses) != 2 or not all(
            np.isfinite(losses)):
        raise AssertionError(f"cli --renderer tiled: rc {rc}, losses "
                             f"{losses}, scene {os.path.exists(out)}:\n"
                             + buf.getvalue()[-2000:])
    if cuda and (counts_f["expand"] < 2 or counts_f["segsum"] < 2):
        raise AssertionError(f"cli --renderer tiled launches: {counts_f}")
    print(f"conformance cli --renderer tiled: 2 steps at {size // 2} px in "
          f"{wall:.2f} s (whole run; {card}), losses {[round(v, 6) for v in losses]},"
          f" scene {os.path.getsize(out)} B; launches "
          + json.dumps(counts_f), flush=True)
    return {k: counts_e[k] for k in ("expand", "segsum")}


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


# ---- phase 9: parallel/ over ranks that share the card --------------------

# the schedule of phase 9's trainers: SH degree 3 from step 3, a
# densifying refine at step 20 (past warm-up 10; 20 > 3 cameras + 10)
PAR_CFG = dict(num_downscales=0, sh_degree_interval=1, warmup_length=10,
               refine_every=10)


def training_wrappers():
    """The four training kernels' wrappers, by kernel name."""
    from opensplat_tpu_torch.ops.kernels import expand, raster, segsum

    return {"expand": expand.expand,
            "raster_fwd": raster.rasterize_forward,
            "raster_bwd": raster.rasterize_backward,
            "segsum": segsum.segment_sum}


def counted_wrappers():
    """training_wrappers() and the SSIM kernel pair's two entries, which
    launch once a view (S or D times a batched step), not once a step."""
    from opensplat_tpu_torch.ops.kernels import ssim

    return dict(training_wrappers(), ssim_fwd=ssim.ssim_forward,
                ssim_bwd=ssim.ssim_backward)


def drive(trainer, steps, snapshot_at=None):
    """trainer.run_step(1..steps) with every counted wrapper's counter set
    to 0 before and read after. Returns (losses, steady steps/s over the
    second half, host clock ending in a synchronize; launches; the state
    copied after step `snapshot_at`)."""
    import torch

    from opensplat_tpu_torch.models.gaussians import state_map

    wrappers = counted_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    cuda = trainer.state.device.type == "cuda"
    losses, snap, t0 = [], None, None
    for step in range(1, steps + 1):
        if step == steps // 2 + 1:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(trainer.run_step(step).loss)
        if step == snapshot_at:
            snap = state_map(lambda x: x.clone(), trainer.full_state())
    if cuda:
        torch.cuda.synchronize()
    sps = (steps - steps // 2) / (time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"nonfinite loss: {losses}")
    return losses, sps, {k: fn.launches for k, fn in wrappers.items()}, snap


def state_arrays(state, prefix=""):
    """A TrainState's parameters, alive mask and stats as numpy arrays."""
    out = {f"{prefix}{k}": v.detach().cpu().numpy()
           for k, v in state.params.as_dict().items()}
    out[f"{prefix}alive"] = state.alive.cpu().numpy()
    for k in ("xys_grad_norm", "vis_counts", "max_2d_size"):
        out[f"{prefix}{k}"] = getattr(state.stats, k).cpu().numpy()
    return out


def save_rank(path, model, **extra):
    """Rank 0 keeps the model's arrays, every rank their digest (so the
    replicas can be held equal to the bit) and `extra`."""
    import hashlib

    import torch.distributed as dist

    digest = hashlib.sha256()
    for k in sorted(model):
        digest.update(np.ascontiguousarray(model[k]).tobytes())
    keep = model if dist.get_rank() == 0 else {}
    np.savez(path.format(rank=dist.get_rank()), digest=digest.hexdigest(),
             **keep, **extra)


def rank_dp_gs(work, n_points, size, steps, device):
    """A rank of phase 9 (a) and (b), two gloo ranks: DPTrainer; then, on
    a 1 x 2 grid, gs_render, one gs_train_step and GSTrainer through a
    refine that grows capacity. Writes work/p9_{dp,gs,gst}_rank{r}.npz."""
    import torch

    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.models.gaussians import state_map
    from opensplat_tpu_torch.parallel.distributed import (
        initialize_from_env, rank_device)
    from opensplat_tpu_torch.parallel.dp_trainer import DPTrainer
    from opensplat_tpu_torch.parallel.gaussian_shard import (
        GSTrainer, gs_render, gs_train_step, shard_state, unshard_state)
    from opensplat_tpu_torch.parallel.mesh import make_mesh

    assert initialize_from_env(device=device)
    dev = rank_device(device)
    cfg = TrainConfig(**PAR_CFG)
    state, cams = make_scene(n_points, size, 0, dev)
    fresh = state_map(lambda x: x.clone(), state)
    tr = DPTrainer(state, cams, cfg, mesh=make_mesh(2, 1), device=dev)
    losses, sps, launches, _ = drive(tr, steps)
    save_rank(f"{work}/p9_dp_rank{{rank}}.npz", state_arrays(tr.state),
              losses=np.array(losses), sps=sps, launches=json.dumps(launches))

    mesh = make_mesh(1, 2)
    wrappers = counted_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    shard = shard_state(mesh, state_map(lambda x: x.clone(), fresh))
    cam = cams[0]
    c2w = torch.as_tensor(cam.cam_to_world, device=dev)
    rgb, v, _ = gs_render(shard, c2w, cam.fx, cam.fy, cam.cx, cam.cy, mesh,
                          size, size, 3)
    gt = torch.as_tensor(cam.get_image(1), device=dev)
    shard, m = gs_train_step(shard, c2w, cam.fx, cam.fy, cam.cx, cam.cy, gt,
                             cfg.lr_means, mesh, size, size, 3, cfg, True)
    step_launches = {k: fn.launches for k, fn in wrappers.items()}
    save_rank(f"{work}/p9_gs_rank{{rank}}.npz",
              dict(state_arrays(unshard_state(mesh, shard)),
                   rgb=rgb.cpu().numpy()),
              loss=float(m["loss"]), v=v, launches=json.dumps(step_launches))

    tr = GSTrainer(fresh, cams, cfg, mesh=mesh, device=dev)
    losses, sps, launches, _ = drive(tr, steps)
    full = tr.full_state()
    save_rank(f"{work}/p9_gst_rank{{rank}}.npz", state_arrays(full),
              losses=np.array(losses), sps=sps, launches=json.dumps(launches))


def rank_hybrid(work, n_points, size, steps, device):
    """A rank of phase 9 (c), four gloo ranks: GSTrainer on a 2 x 2
    (data, model) grid, the hybrid step (dpgs_train_step), `steps`
    steps. Writes work/p9_hy_rank{r}.npz."""
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.parallel.distributed import (
        initialize_from_env, rank_device)
    from opensplat_tpu_torch.parallel.gaussian_shard import GSTrainer
    from opensplat_tpu_torch.parallel.mesh import make_mesh

    assert initialize_from_env(device=device)
    dev = rank_device(device)
    state, cams = make_scene(n_points, size, 0, dev)
    tr = GSTrainer(state, cams, TrainConfig(**PAR_CFG), mesh=make_mesh(2, 2),
                   device=dev)
    losses, sps, launches, _ = drive(tr, steps)
    save_rank(f"{work}/p9_hy_rank{{rank}}.npz", state_arrays(tr.full_state()),
              losses=np.array(losses), sps=sps, launches=json.dumps(launches))


def rank_cli(module, argv):
    """A rank of a CLI run in phase 9: module.main(argv), then the four
    training kernels' and the SSIM entries' launches as a last JSON
    line."""
    import importlib

    wrappers = counted_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    rc = importlib.import_module(module).main(argv)
    print(json.dumps({"launches": {k: fn.launches
                                   for k, fn in wrappers.items()}}))
    sys.exit(rc)


def run_ranks_of(fn, world, args, timeout):
    """fn(*args) of this script in `world` gloo rank processes (parallel/
    launch.py: a file:// store, a hard time limit, every rank stopped
    when one fails). Returns each rank's output."""
    from opensplat_tpu_torch.parallel.launch import run_ranks

    code = f"import chip_smoke; chip_smoke.{fn}(*{args!r})"
    return run_ranks([sys.executable, "-c", code], world, backend="gloo",
                     timeout=timeout, cwd=REPO)


def load_ranks(work, tag, world):
    """Every rank's npz of `tag`, and a check that the replicas agree."""
    rs = [np.load(f"{work}/p9_{tag}_rank{r}.npz") for r in range(world)]
    digests = {str(r["digest"]) for r in rs}
    if len(digests) != 1:
        raise AssertionError(f"phase 9 {tag}: the ranks' models differ")
    return rs


def close(label, got, want, rtol, atol, phase=9):
    """Raise unless got is within rtol/atol of want; returns the worst
    absolute difference."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol,
                                                  atol=atol):
        bad = (np.abs(got - want) > atol + rtol * np.abs(want)).sum() \
            if got.shape == want.shape else "shape"
        raise AssertionError(f"phase {phase} {label}: {bad} entries "
                             f"outside rtol {rtol} atol {atol}")
    return float(np.abs(got - want).max()) if got.size else 0.0


def rank_launches(outs_or_npz, label, need):
    """Each rank's launch counts; raises if a training kernel or SSIM
    entry of a rank launched fewer than `need` times (none on the CPU,
    where the plain versions run)."""
    counts = []
    for item in outs_or_npz:
        if isinstance(item, str):
            last = [ln for ln in item.splitlines()
                    if ln.startswith('{"launches"')][-1]
            counts.append(json.loads(last)["launches"])
        else:
            counts.append(json.loads(str(item["launches"])))
    for r, c in enumerate(counts):
        for k, n in c.items():
            if n < need:
                raise AssertionError(f"phase 9 {label}: rank {r} launched "
                                     f"{k} {n} times (needs {need})")
    return counts


def parallel_phase(n_points, size, steps, device, work, project, smi):
    """Phase 9: parallel/ on ranks that share the card (gloo), each a
    process of this script (parallel/launch.py). (a) DPTrainer on 2
    ranks against DPTrainer on 1 NCCL rank (this process) with d_local
    2: losses rtol 5e-3 a step, final state rtol 5e-3 atol 5e-5, alive
    masks equal, through the step-20 densify. (b) On 2 ranks: gs_render
    against render_image (rtol 1e-5 atol 1e-5); one gs_train_step
    against train_step_impl (loss rtol 1e-5, params rtol 2e-4 atol
    1e-5, stats rtol 2e-4 atol 1e-8); GSTrainer through the step-20
    refine, which grows capacity, against Trainer (as (a)). (c)
    GSTrainer on 2 x 2 ranks (the hybrid) for 3 steps against (a)'s
    one-rank run after 3 steps (loss rtol 1e-5, params rtol 2e-4 atol
    1e-5, stats rtol 1e-4 atol 1e-6). (d) MultiSceneTrainer with two
    scenes against two Trainers, bitwise, `steps` steps in this
    process; multi_scene_cli --sharded on phase 7's project and a second
    one over 2 ranks at half size. (e) cli --distributed --data-parallel
    -1 on phase 7's project over 2 ranks. Every rank must launch every
    training kernel and SSIM entry (on a card). Ranks that share a card
    measure correctness, not scaling. Returns {kernel or SSIM entry:
    {path: rank 0's launches}}."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import torch.distributed as dist

    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.models.gaussians import state_map
    from opensplat_tpu_torch.parallel.distributed import initialize_from_env
    from opensplat_tpu_torch.parallel.dp_trainer import DPTrainer
    from opensplat_tpu_torch.parallel.mesh import make_mesh
    from opensplat_tpu_torch.parallel.multi_scene import MultiSceneTrainer
    from opensplat_tpu_torch.tools.make_synthetic_project import make_project
    from opensplat_tpu_torch.train import (Trainer, render_image,
                                           train_step_impl)

    cuda = torch.device(device).type == "cuda"
    need = 1 if cuda else 0
    t_phase = time.perf_counter()
    cfg = TrainConfig(**PAR_CFG)
    # the rank groups run one after another (the two CLIs together), so
    # that each group's steps/s is its own
    run_ranks_of("rank_dp_gs", 2, (work, n_points, size, steps, device),
                 600)
    run_ranks_of("rank_hybrid", 4, (work, n_points, size, 3, device), 600)

    # this process: the one-rank references, DP on one NCCL rank (gloo on
    # the CPU) with d_local 2
    initialize_from_env(f"file://{work}/p9_store", 1, 0,
                        backend="nccl" if cuda else "gloo", device=device)
    state, cams = make_scene(n_points, size, 0, device)
    fresh = state_map(lambda x: x.clone(), state)
    one = DPTrainer(state, cams, cfg, mesh=make_mesh(1, 1), d_local=2,
                    device=device)
    one_losses, one_sps, one_launches, at3 = drive(one, steps, snapshot_at=3)
    ref_tr = Trainer(state_map(lambda x: x.clone(), fresh), cams, cfg,
                     device=device)
    ref_losses, ref_sps, _, _ = drive(ref_tr, steps)
    cam = cams[0]
    c2w = torch.as_tensor(cam.cam_to_world, device=device)
    ref_rgb, _, _ = render_image(fresh.params, fresh.alive, c2w, cam.fx,
                                 cam.fy, cam.cx, cam.cy, size, size, 3,
                                 device=device)
    ref_step, ref_m = train_step_impl(
        state_map(lambda x: x.clone(), fresh), c2w, cam.fx, cam.fy, cam.cx,
        cam.cy, torch.as_tensor(cam.get_image(1), device=device),
        cfg.lr_means, size, size, 3, cfg, True)

    # (d) two scenes in one trainer against two Trainers, bitwise
    scenes = [make_scene(n_points, size, s, device) for s in (0, 1)]
    msc = MultiSceneTrainer([state_map(lambda x: x.clone(), st)
                             for st, _ in scenes], [c for _, c in scenes],
                            cfg, device=device)
    solo = [Trainer(st, c, cfg, device=device) for st, c in scenes]
    wrappers = counted_wrappers()
    ms_launches = dict.fromkeys(wrappers, 0)
    for step in range(1, steps + 1):
        before = {k: fn.launches for k, fn in wrappers.items()}
        per = msc.run_step(step).metrics["loss_per_scene"].tolist()
        for k, fn in wrappers.items():  # the batched step's alone
            ms_launches[k] += fn.launches - before[k]
        if per != [t.run_step(step).loss for t in solo]:
            raise AssertionError(f"phase 9 multi-scene: step {step} losses "
                                 f"{per} differ from the Trainers'")
    if cuda and any(n != (2 * steps if k.startswith("ssim") else steps)
                    for k, n in ms_launches.items()):
        raise AssertionError(f"phase 9 multi-scene: launches {ms_launches} "
                             f"in {steps} steps of both scenes (one a "
                             "step, SSIM's one a scene)")
    for got, t in zip(msc.scene_states(), solo):
        rows = t.state.alive.shape[0]
        if not torch.equal(got.alive[:rows], t.state.alive) or \
                got.alive[rows:].any():
            raise AssertionError("phase 9 multi-scene: alive masks differ")
        live = t.state.alive
        for k, v in t.state.params.as_dict().items():
            if not torch.equal(getattr(got.params, k)[:rows][live], v[live]):
                raise AssertionError(f"phase 9 multi-scene: {k} differs")
    print(f"parallel multi-scene: 2 scenes x {n_points} Gaussians, {size} "
          f"px, {steps} steps: losses and alive rows equal to two "
          f"Trainers' bitwise (capacity {msc.state.alive.shape[1]}); "
          f"launches of the batched steps (both scenes, one a step, "
          f"SSIM's one a scene) "
          f"{json.dumps(ms_launches)}", flush=True)
    dist.destroy_process_group()

    # (d) and (e): the CLIs over 2 ranks, at half size
    second = os.path.join(work, "project2")
    make_project(second, cams=16, points=n_points, res=size, seed=8,
                 sparse_frac=1.0, jitter=0.02, device=device, verbose=False)
    half = ["-d", "2"] + ([] if cuda else ["--cpu"])
    ms_out, cli_out = os.path.join(work, "p9_ms"), os.path.join(work,
                                                                 "p9_cli")
    pool = ThreadPoolExecutor(max_workers=2)
    ms_cli = pool.submit(run_ranks_of, "rank_cli", 2, (
        "opensplat_tpu_torch.multi_scene_cli",
        [project, second, "-o", ms_out, "-n", "6", "--sharded",
         "--sh-degree", "3", "--warmup-length", "100"] + half), 600)
    main_cli = pool.submit(run_ranks_of, "rank_cli", 2, (
        "opensplat_tpu_torch.cli",
        [project, "-o", os.path.join(cli_out, "scene.ply"), "-n", "6",
         "--distributed", "--data-parallel", "-1", "--num-downscales", "0",
         "--metrics-file", os.path.join(cli_out, "m.jsonl")] + half), 600)

    # (a)
    dp = load_ranks(work, "dp", 2)
    for i, (a, b) in enumerate(zip(dp[0]["losses"], one_losses)):
        close(f"dp loss step {i + 1}", a, b, 5e-3, 0)
    want = state_arrays(one.state)
    if not np.array_equal(dp[0]["alive"], want["alive"]):
        raise AssertionError("phase 9 dp: alive masks differ after the "
                             "refine")
    worst = {k: close(f"dp {k}", dp[0][k], want[k], 5e-3, 5e-5)
             for k in fresh.params.as_dict()}
    dp_launches = rank_launches(dp, "dp", need * steps)
    print(f"parallel dp: 2 gloo ranks vs 1 NCCL rank (d_local 2), "
          f"{n_points} Gaussians, {size} px, {steps} steps: losses within "
          f"rtol 5e-3, alive equal ({int(want['alive'].sum())} after the "
          f"step-20 refine, capacity {want['alive'].shape[0]}), worst param "
          f"diff {json.dumps(worst)}; launches per rank "
          f"{json.dumps(dp_launches)}", flush=True)

    # (b)
    gs = load_ranks(work, "gs", 2)
    err_rgb = close("gs_render", gs[0]["rgb"], ref_rgb.cpu().numpy(), 1e-5,
                    1e-5)
    rgb_bitwise = np.array_equal(gs[0]["rgb"], ref_rgb.cpu().numpy())
    close("gs loss", gs[0]["loss"], float(ref_m["loss"]), 1e-5, 0)
    want = state_arrays(ref_step)
    for k in fresh.params.as_dict():
        close(f"gs {k}", gs[0][k], want[k], 2e-4, 1e-5)
    for k in ("xys_grad_norm", "vis_counts", "max_2d_size"):
        close(f"gs {k}", gs[0][k], want[k], 2e-4, 1e-8)
    gs_launches = rank_launches(gs, "gs", need)
    gst = load_ranks(work, "gst", 2)
    for i, (a, b) in enumerate(zip(gst[0]["losses"], ref_losses)):
        close(f"GSTrainer loss step {i + 1}", a, b, 5e-3, 0)
    want = state_arrays(ref_tr.state)
    if not np.array_equal(gst[0]["alive"], want["alive"]):
        raise AssertionError("phase 9 GSTrainer: alive masks differ")
    if not want["alive"].shape[0] > n_points:
        raise AssertionError("phase 9 GSTrainer: the refine did not grow "
                             "capacity")
    for k in fresh.params.as_dict():
        close(f"GSTrainer {k}", gst[0][k], want[k], 5e-3, 5e-5)
    gst_launches = rank_launches(gst, "GSTrainer", need * steps)
    print(f"parallel gs: 2 ranks; gs_render vs render_image max abs "
          f"{err_rgb:.3g} ({'bitwise' if rgb_bitwise else 'not bitwise'}; "
          f"V {int(gs[0]['v'])} of {n_points // 2} rows a "
          f"shard); one gs_train_step vs train_step_impl within the JAX "
          f"suite's tolerances; GSTrainer {steps} steps vs Trainer: "
          f"losses within rtol 5e-3, alive equal, capacity {n_points} -> "
          f"{want['alive'].shape[0]} at the step-20 refine; launches per "
          f"rank (one step) {json.dumps(gs_launches)}, (GSTrainer) "
          f"{json.dumps(gst_launches)}", flush=True)

    # (c)
    hy = load_ranks(work, "hy", 4)
    for i, (a, b) in enumerate(zip(hy[0]["losses"], one_losses[:3])):
        close(f"hybrid loss step {i + 1}", a, b, 1e-5, 0)
    want = state_arrays(at3)
    # the grid rounds capacity to lcm(capacity_round, 2): rows past the
    # reference's are padding, dead
    rows = want["alive"].shape[0]
    if hy[0]["alive"][rows:].any():
        raise AssertionError("phase 9 hybrid: a padded row is alive")
    for k in fresh.params.as_dict():
        close(f"hybrid {k}", hy[0][k][:rows], want[k], 2e-4, 1e-5)
    for k in ("xys_grad_norm", "vis_counts", "max_2d_size"):
        close(f"hybrid {k}", hy[0][k][:rows], want[k], 1e-4, 1e-6)
    hy_launches = rank_launches(hy, "hybrid", need * 3)
    print(f"parallel hybrid: 2 x 2 gloo ranks, 3 steps vs 1-rank DP "
          f"(d_local 2) within the JAX suite's tolerances; launches per "
          f"rank {json.dumps(hy_launches)}", flush=True)

    # (d) multi_scene_cli and (e) cli
    ms_outs = ms_cli.result()
    plys = sorted(os.listdir(ms_out))
    if plys != ["project.ply", "project2.ply"] or \
            "Wrote" in ms_outs[1]:
        raise AssertionError(f"phase 9 multi_scene_cli wrote {plys}")
    ms_losses = [float(ln.split("mean loss ")[1].split()[0])
                 for ln in ms_outs[0].splitlines() if "mean loss" in ln]
    if len(ms_losses) < 1 or not np.isfinite(ms_losses).all():
        raise AssertionError(f"phase 9 multi_scene_cli losses {ms_losses}")
    ms_cli_launches = rank_launches(ms_outs, "multi_scene_cli", need * 6)
    cli_outs = main_cli.result()
    recs = [json.loads(r) for r in open(os.path.join(cli_out, "m.jsonl"))]
    cli_losses = [r["loss"] for r in recs if r["type"] == "step"]
    if len(cli_losses) != 6 or not np.isfinite(cli_losses).all():
        raise AssertionError(f"phase 9 cli losses {cli_losses}")
    if "Wrote" in cli_outs[1] or "scene.ply" not in os.listdir(cli_out):
        raise AssertionError("phase 9 cli: rank 0 alone writes the scene")
    cli_launches = rank_launches(cli_outs, "cli", need * 6)
    print(f"parallel multi_scene_cli --sharded: 2 ranks, 2 projects at "
          f"{size // 2} px, 6 steps: {plys} by rank 0, last mean loss "
          f"{ms_losses[-1]:.5f}; launches per rank "
          f"{json.dumps(ms_cli_launches)}", flush=True)
    print(f"parallel cli --distributed --data-parallel -1: 2 ranks at "
          f"{size // 2} px, 6 steps, losses {cli_losses[0]:.5f} -> "
          f"{cli_losses[-1]:.5f}, scene by rank 0; launches per rank "
          f"{json.dumps(cli_launches)}", flush=True)
    pool.shutdown()
    shutil.rmtree(ms_out)

    print(f"parallel steps/s ({smi}; ranks share one card, so these "
          f"measure correctness, not scaling): dp 2 gloo ranks "
          f"{float(dp[0]['sps']):.3f}, dp 1 {'NCCL' if cuda else 'gloo'} "
          f"rank d_local 2 "
          f"{one_sps:.3f}, Trainer {ref_sps:.3f}, GSTrainer 2 ranks "
          f"{float(gst[0]['sps']):.3f}, hybrid 2 x 2 "
          f"{float(hy[0]['sps']):.3f} (steady, over the second half of "
          f"the run, host clock)", flush=True)
    print(f"parallel phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    paths = {"dp": dp_launches[0], "dp_one_rank": one_launches,
             "gs_step": gs_launches[0], "gs_trainer": gst_launches[0],
             "hybrid": hy_launches[0], "multi_scene": ms_launches,
             "multi_scene_cli": ms_cli_launches[0], "cli": cli_launches[0]}
    return {k: {p: c[k] for p, c in paths.items()}
            for k in counted_wrappers()}


BENCH_MODES = (("dp", {"BENCH_DP": "2"}), ("mp", {"BENCH_MP": "2"}),
               ("hybrid", {"BENCH_DP": "2", "BENCH_MP": "2"}),
               ("scenes", {"BENCH_SCENES": "2", "BENCH_SCENES_SHARDED": "1"}))


def bench_lines(env, label, device_info):
    """`python -m opensplat_tpu_torch.bench` with the BENCH_* variables
    of `env` alone: its JSON lines, each printed (the sweep's last
    without its copy of the others), beside its stderr's `bench:` lines.
    Raises on a non-zero exit, a value that is not finite and positive,
    or a line whose device is not `device_info` (the card's name and
    power limit, or the CPU)."""
    e = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    e.update(env)
    out = subprocess.run([sys.executable, "-m", "opensplat_tpu_torch.bench"],
                         cwd=REPO, env=e, capture_output=True, text=True,
                         timeout=900)
    for ln in out.stderr.splitlines():
        if ln.startswith("bench:"):
            print(f"  {ln}")
    if out.returncode != 0:
        raise AssertionError(f"bench {label}: exit {out.returncode}\n"
                             + out.stderr[-6000:])
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    for rec in lines:
        v = rec["value"]
        if not (np.isfinite(v) and v > 0):
            raise AssertionError(f"bench {label}: {rec['metric']} = {v}")
        dev = rec["device"]
        if {k: dev.get(k) for k in device_info} != device_info:
            raise AssertionError(f"bench {label}: device {dev}, this run's "
                                 f"is {device_info}")
        short = {k: v for k, v in rec.items() if k != "sweep"}
        print(f"  bench {label}: {json.dumps(short)}"
              + (f" + sweep of {len(rec['sweep'])}" if "sweep" in rec
                 else ""), flush=True)
    return lines


def kernel_device_ms(rows):
    """{training kernel: (device ms per recorded launch, launches
    recorded)} from device_rows' rows; (None, 0) for one not recorded."""
    out = {}
    for k in training_wrappers():
        hit = [(t, c) for name, t, c in rows if KERNEL_FUNCS[k] in name]
        n = sum(c for _, c in hit)
        out[k] = (sum(t * c for t, c in hit) / n if n else None, n)
    return out


def big_model(n_points, size, device, peak, trace_dir, profile_sizes):
    """Phase 10 (b) and (c) at n_points Gaussians, size px: three
    train_steps of the bench model (bench.single_step), every training
    kernel launched once a step, finite losses, the peak memory and
    demand; at the trained state the tile balance (on a card), each
    kernel's bound, and each kernel against its plain version at phase
    4's tolerances on the whole frame (the plain rasterizers step every
    tile at once, record index by record index, so their time follows
    the longest tile and not the tile count: a subset of tiles that
    keeps the longest would save no time); then profile_step's anatomy
    at each of `profile_sizes`, which hold this size. Returns (launches,
    {kernel: (device ms per launch, launches recorded)} at this size,
    bounds, max abs errors)."""
    import torch

    from opensplat_tpu_torch import bench
    from opensplat_tpu_torch.tools.profile_step import anatomy

    cuda = torch.device(device).type == "cuda"
    state, step = bench.single_step(n_points, size, "fast", device)
    wrappers = training_wrappers()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    losses = []
    for _ in range(3):
        state, m = step(state)
        losses.append(float(m["loss"]))
    launches = {k: fn.launches for k, fn in wrappers.items()}
    if not np.isfinite(losses).all():
        raise AssertionError(f"sweep {size} px: losses {losses}")
    if cuda and set(launches.values()) != {3}:
        raise AssertionError(f"sweep {size} px: launches {launches} in 3 "
                             "steps")
    mem = (f"; peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
           "MiB" if cuda else "")
    print(f"sweep {n_points} g, {size} px: 3 train_steps, losses "
          f"{json.dumps(losses)}; launches {json.dumps(launches)}{mem}; "
          f"demand " + json.dumps({k: int(m[k]) for k in
                                   ("n_cands", "n_isects", "n_grads")}),
          flush=True)
    inp = stage_inputs(state, Camera((0.0, 0.0, 6.0), size, None), 3, 4)
    if cuda:
        tile_balance(inp)
    bnd = bounds(inp, *peak)
    print(f"sweep bounds at {size} px (ms, by): " + json.dumps(bnd))
    t0 = time.perf_counter()
    errs, _ = check_kernels(inp, f"{n_points} g, {size} px, whole frame")
    print(f"sweep kernels against their plain versions at {size} px: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del inp, state, step
    if cuda:
        torch.cuda.empty_cache()
    dev_ms, summary = None, {}
    for n, h in profile_sizes:
        prof = anatomy(n, h, "fast", torch.device(device), trace_dir)
        if (n, h) == (n_points, size):
            dev_ms = kernel_device_ms(prof["rows"])
        summary[f"{n}g@{h}px"] = {k: round(prof[k], 4) for k in (
            "busy_ms", "busy_share", "ssim_ms", "ssim_share")}
        summary[f"{n}g@{h}px"]["wall_ms"] = round(
            statistics.mean(prof["wall_ms"]), 3)
    print("anatomy summary (busy: device ms a step; share: of the "
          "unprofiled wall; ssim: SSIM forward + backward alone): "
          + json.dumps(summary), flush=True)
    return launches, dev_ms, bnd, errs


def sweep_phase(smi, peak, work):
    """Phase 10: the port bench and the step profiler on the card. (a)
    `python -m opensplat_tpu_torch.bench`, the default sweep: five lines,
    the headline last with a sweep of four, every value finite and
    positive, every line naming this card. (b, c) big_model at the
    largest sweep size, with the anatomy at every sweep size. (d) each
    parallel mode of the bench once at the
    headline size, BENCH_ITERS=10, on gloo ranks that share the card,
    rank 0's one line each. Returns big_model's launches, device ms and
    bounds."""
    import torch

    from opensplat_tpu_torch.bench import HEADLINE, SWEEP

    t_phase = time.perf_counter()
    name, limit = (x.strip() for x in smi.split(","))
    card = {"platform": "gpu", "name": name, "power_limit": limit}
    torch.cuda.empty_cache()  # room for the bench's processes
    lines = bench_lines({}, "sweep", card)
    if len(lines) != 5 or len(lines[-1].get("sweep", ())) != 4:
        raise AssertionError(f"bench sweep: {len(lines)} lines, the last "
                             "with a sweep of "
                             f"{len(lines[-1].get('sweep', ()))}")
    want = [f"train_steps_per_sec[fast,{n}g,{h}px]" for n, h in
            SWEEP + (HEADLINE,)]
    if [r["metric"] for r in lines] != want or \
            lines[-1]["sweep"] != lines[:4]:
        raise AssertionError("bench sweep: lines "
                             + json.dumps([r["metric"] for r in lines]))
    launches, dev_ms, bnd, errs = big_model(
        *SWEEP[-1], "cuda", peak, os.path.join(work, "trace"), SWEEP)
    torch.cuda.empty_cache()
    for label, env in BENCH_MODES:
        env = dict(env, BENCH_POINTS=str(HEADLINE[0]),
                   BENCH_RES=str(HEADLINE[1]), BENCH_ITERS="10")
        got = bench_lines(env, label, card)
        if len(got) != 1 or "ranks, gloo, sharing one card" not in \
                got[0]["unit"]:
            raise AssertionError(f"bench {label}: {got}")
    print(f"sweep phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, dev_ms, bnd, errs


# ---- phase 11: the batched multi-view step --------------------------------

def stage_views(pairs, sh_deg, seed, per_view_bg):
    """Phase 11's kernel inputs for V views: each (state, camera) pair
    staged alone (stage_inputs), and the V views as one batch: their
    fields concatenated view-major, binned as one stream, the forward run
    once over it. The background is (V, 3) with per_view_bg (the
    kernels' bg_stride 3), else the views' shared (3,)."""
    import torch

    from opensplat_tpu_torch.ops.binning import bin_gaussians
    from opensplat_tpu_torch.ops.kernels import raster
    from opensplat_tpu_torch.ops.projection import ProjectedGaussians

    views = [stage_inputs(st, cam, sh_deg, seed + i)
             for i, (st, cam) in enumerate(pairs)]
    nv = len(views)
    h, w = views[0]["fwd"][8:10]
    c = views[0]["fwd"][3].shape[0]
    with torch.no_grad():
        proj = ProjectedGaussians(*(torch.stack(f) for f in
                                    zip(*(v["proj"] for v in views))))
        opac = torch.stack([v["fwd"][5] for v in views])
        binned = bin_gaussians(proj, h, w, opac)

        def cat(key, i):
            return torch.cat([v[key][i] for v in views]).contiguous()

        cnt = cat("expand", 0)
        starts = (torch.cumsum(cnt.long(), 0) - cnt.long()).contiguous()
        ex = views[0]["expand"]
        expand_args = ((cnt, starts, binned.n_cands)
                       + tuple(cat("expand", i) for i in range(3, 9))
                       + (ex[9], ex[10], c))
        bg = views[0]["fwd"][7]
        if per_view_bg:
            bg = bg.repeat(nv, 1).contiguous()
        fwd_args = ((binned.gauss_ids, binned.tile_start, binned.tile_end)
                    + tuple(cat("fwd", i) for i in range(3, 7))
                    + (bg, h, w, nv))
        img, final_t, fidx = raster.rasterize_forward(*fwd_args)
        bwd_args = fwd_args[:8] + (
            final_t, fidx, torch.stack([v["bwd"][10] for v in views]),
            torch.stack([v["bwd"][11] for v in views]), binned.cand_index,
            h, w, nv)
    return views, dict(expand=expand_args, fwd=fwd_args, bwd=bwd_args,
                       binned=binned, fidx=fidx, img=img)


def check_batched_kernels(views, batch, label):
    """Each training kernel launched once on the V views' batch against
    one launch a view, bitwise: keys (a view's offset by its first tile;
    culled rows the batch's sentinel), gids (offset by the view's first
    Gaussian; culled ones V * C), kept counts, image, final T, final_idx
    (offset by the view's first record), gradient rows (at the view's
    first candidate row) and segment sums. Each counter must advance by
    one per batched call. Then the batched kernels against their batched
    plain versions at phase 4's tolerances (check_kernels, without the
    float64 direct sums). Returns check_kernels' errors."""
    import torch

    from opensplat_tpu_torch.ops.kernels import expand, raster, segsum

    wrappers = training_wrappers()
    nv, c = len(views), batch["fwd"][3].shape[0] // len(views)
    n_tiles = batch["expand"][10]
    b = batch["binned"]
    with torch.no_grad():
        before = {k: fn.launches for k, fn in wrappers.items()}
        kb, gb, keptb = expand.expand(*batch["expand"])
        img_b, ft_b, fi_b = raster.rasterize_forward(*batch["fwd"])
        rows_b = raster.rasterize_backward(*batch["bwd"])
        sums_b = segsum.segment_sum(rows_b, b.cand_start, b.cand_count)
        steps = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        if set(steps.values()) != {int(kb.is_cuda)}:
            raise AssertionError(f"[{label}] launches per batched call "
                                 f"{steps}")
        sent = ((nv * n_tiles) << 32) | expand.INT32_MAX
        row0 = 0
        for v, inp in enumerate(views):
            k, g, kept = expand.expand(*inp["expand"])
            vb = inp["binned"]
            rows = slice(row0, row0 + k.shape[0])
            keep = g < c
            same = {
                "keys": torch.equal(kb[rows], torch.where(
                    keep, k + ((v * n_tiles) << 32), torch.full_like(k, sent))),
                "gids": torch.equal(gb[rows], torch.where(keep, g + v * c,
                                                          nv * c)),
                "kept": torch.equal(keptb[v * c:(v + 1) * c], kept)}
            img, ft, fi = raster.rasterize_forward(*inp["fwd"])
            base = int(b.tile_start[v * n_tiles])
            same.update({
                "image": torch.equal(img_b[v], img),
                "final_t": torch.equal(ft_b[v], ft),
                "final_idx": torch.equal(
                    fi_b[v * n_tiles:(v + 1) * n_tiles],
                    torch.where(fi == raster.STOP_SENTINEL, fi, fi + base))})
            g_rows = raster.rasterize_backward(*inp["bwd"])
            same["rows"] = torch.equal(rows_b[rows], g_rows)
            same["sums"] = torch.equal(
                sums_b[v * c:(v + 1) * c],
                segsum.segment_sum(g_rows, vb.cand_start, vb.cand_count))
            if not all(same.values()):
                raise AssertionError(f"[{label}] view {v}: the batched "
                                     f"launch differs: {same}")
            row0 += k.shape[0]
    print(f"[{label}] one launch of each kernel for {nv} views equals the "
          f"views' own launches bitwise (keys, gids, kept, image, final T, "
          f"final_idx, rows, sums); {b.n_cands} candidate rows", flush=True)
    errs, _ = check_kernels(batch, label, direct=False)
    return errs


def clone_state(state):
    from opensplat_tpu_torch.models.gaussians import state_map

    return state_map(lambda x: x.clone(), state)


def states_equal(a, b):
    """Parameters, Adam moments and count, stats and alive mask equal to
    the bit (torch.equal)."""
    import torch

    from opensplat_tpu_torch.models.gaussians import PARAM_NAMES

    stats = ("xys_grad_norm", "vis_counts", "max_2d_size", "initialized")
    pairs = ([(a.alive, b.alive)]
             + [(getattr(a.params, k), getattr(b.params, k))
                for k in PARAM_NAMES]
             + [(a.opt.mu[k], b.opt.mu[k]) for k in PARAM_NAMES]
             + [(a.opt.nu[k], b.opt.nu[k]) for k in PARAM_NAMES]
             + [(getattr(a.stats, k), getattr(b.stats, k)) for k in stats])
    return a.opt.count == b.opt.count and all(
        torch.equal(x, y) for x, y in pairs)


def step_anatomy(fn, device):
    """One call of fn under torch.profiler: (PyTorch's elementwise
    kernels launched, as recorded: vectorized_elementwise_kernel and
    elementwise_kernel; the device ms of all kernels; kernel_device_ms of
    the training kernels). No device rows on the CPU."""
    import torch

    from opensplat_tpu_torch.tools import profiling

    rows = profiling.device_rows(fn, 1, device)
    if torch.device(device).type != "cuda":
        return 0, 0.0, {}
    elem = sum(n for name, _, n in profiling.by_stem(rows)
               if "elementwise_kernel" in name)
    return elem, sum(t * n for _, t, n in rows), kernel_device_ms(rows)


def multi_scene_steps(scenes, n_steps, sh_deg, cfg):
    """n_steps of multi_scene_train_step over the S scenes against S
    train_step_impl calls on clones, each scene seeing camera step % 3:
    every step's losses and the final states equal to the bit. Returns
    (the batched steps' launches, the single steps' launches, host
    seconds of the batched and the single steps over the second half,
    step_anatomy of one batched step and of S single steps)."""
    import torch

    from opensplat_tpu_torch.parallel.multi_scene import (
        multi_scene_train_step, stack_states, unstack_states)
    from opensplat_tpu_torch.train import train_step_impl

    s = len(scenes)
    singles = [clone_state(st) for st, _ in scenes]
    stacked = stack_states([clone_state(st) for st, _ in scenes])
    size = scenes[0][1][0].width
    dev = stacked.device
    wrappers = counted_wrappers()
    launches = {"batched": dict.fromkeys(wrappers, 0),
                "single": dict.fromkeys(wrappers, 0)}
    secs = {"batched": 0.0, "single": 0.0}

    def views(step):
        cams = [c[step % 3] for _, c in scenes]
        c2w = torch.as_tensor(np.stack([c.cam_to_world for c in cams]),
                              device=dev)
        gts = torch.stack([torch.as_tensor(c.get_image(1), device=dev)
                           for c in cams])
        return cams, c2w, gts

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run(kind, fn, step):
        before = {k: w.launches for k, w in wrappers.items()}
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        if step > n_steps // 2:
            secs[kind] += time.perf_counter() - t0
        for k, w in wrappers.items():
            launches[kind][k] += w.launches - before[k]
        return out

    def batched(step):
        cams, c2w, gts = views(step)
        return lambda: multi_scene_train_step(
            stacked, c2w, [c.fx for c in cams], [c.fy for c in cams],
            [c.cx for c in cams], [c.cy for c in cams], gts, cfg.lr_means,
            size, size, sh_deg, cfg, True)

    def single(step):
        cams, c2w, gts = views(step)
        return lambda: [train_step_impl(
            st, c2w[i], cams[i].fx, cams[i].fy, cams[i].cx, cams[i].cy,
            gts[i], cfg.lr_means, size, size, sh_deg, cfg, True)[1]
            for i, st in enumerate(singles)]

    for step in range(1, n_steps + 1):
        _, m = run("batched", batched(step), step)
        ms = run("single", single(step), step)
        got, want = m["loss"].tolist(), [float(x["loss"]) for x in ms]
        if got != want:
            raise AssertionError(f"multi-scene S={s} step {step}: losses "
                                 f"{got} against the single steps' {want}")
    for v, st in enumerate(unstack_states(stacked, s)):
        if not states_equal(st, singles[v]):
            raise AssertionError(f"multi-scene S={s}: scene {v}'s state "
                                 "differs from its single steps'")
    anatomy = (step_anatomy(batched(n_steps + 1), dev),
               step_anatomy(single(n_steps + 1), dev))
    return launches["batched"], launches["single"], secs, anatomy


def loop_camera_step(state, c2w, cams, gts, lr, size, sh_deg, cfg):
    """The camera batch as a loop (the port's formulation before the
    batched render): each camera rendered alone into one autograd graph,
    the losses summed over the cameras and divided by D, then Adam and
    the batched densify-stat fold. Returns (state, loss)."""
    import torch

    from opensplat_tpu_torch.models.gaussians import GaussianParams
    from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                        render_forward)
    from opensplat_tpu_torch.ops.ssim import main_loss
    from opensplat_tpu_torch.optim.adam import adam_update
    from opensplat_tpu_torch.parallel.sharded_train import (
        accumulate_stats_batched)
    from opensplat_tpu_torch.train import learning_rates, leaf_grads

    dev = state.device
    bg = torch.tensor(DEFAULT_BACKGROUND, device=dev)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in state.params.as_dict().items()}
    d = len(cams)
    shifts = torch.zeros((d,) + state.alive.shape + (2,), device=dev,
                         requires_grad=True)
    loss, radii = 0.0, []
    for i, cam in enumerate(cams):
        out = render_forward(GaussianParams(**leaves), state.alive, c2w[i],
                             cam.fx, cam.fy, cam.cx, cam.cy, size, size,
                             sh_deg, bg, xys_shift=shifts[i], device=dev)
        loss = loss + main_loss(out.rgb, gts[i], cfg.ssim_weight)
        radii.append(out.radii)
    loss = loss / d
    g_params, g_shifts = leaf_grads(loss, leaves, shifts)
    adam_update(state.params.as_dict(), g_params, state.opt,
                learning_rates(cfg, lr), state.alive)
    state.stats = accumulate_stats_batched(state.stats, g_shifts,
                                           torch.stack(radii), size, size)
    return state, loss.detach()


def camera_batch_steps(state, cams, n_steps, sh_deg, cfg):
    """n_steps of batched_train_step over D = len(cams) cameras of one
    state, each from the state the last batched step left, against the
    loop formulation (loop_camera_step) from a clone of the same state:
    loss rtol 1e-5, parameters rtol 2e-4 atol 1e-5
    (tests/test_torch_parallel.py:340-370). Returns the batched steps'
    launches and the worst parameter differences."""
    import torch

    from opensplat_tpu_torch.parallel.sharded_train import batched_train_step

    dev = state.device
    size = cams[0].width
    c2w = torch.as_tensor(np.stack([c.cam_to_world for c in cams]),
                          device=dev)
    gts = torch.stack([torch.as_tensor(c.get_image(1), device=dev)
                       for c in cams])
    wrappers = counted_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    counted = dict.fromkeys(wrappers, 0)
    worst = {}
    for step in range(1, n_steps + 1):
        ref, ref_loss = loop_camera_step(clone_state(state), c2w, cams, gts,
                                         cfg.lr_means, size, sh_deg, cfg)
        before = {k: fn.launches for k, fn in wrappers.items()}
        state, m = batched_train_step(
            state, c2w, [c.fx for c in cams], [c.fy for c in cams],
            [c.cx for c in cams], [c.cy for c in cams], gts, cfg.lr_means,
            size, size, sh_deg, cfg, True)
        for k, fn in wrappers.items():
            counted[k] += fn.launches - before[k]
        close(f"camera batch step {step} loss", float(m["loss"]),
              float(ref_loss), 1e-5, 0, phase=11)
        for k, v in state.params.as_dict().items():
            worst[k] = max(worst.get(k, 0.0), close(
                f"camera batch step {step} {k}", v.cpu().numpy(),
                getattr(ref.params, k).cpu().numpy(), 2e-4, 1e-5, phase=11))
    return counted, worst


def degenerate_check(device="cuda"):
    """tests/test_torch_grad_sanitize.py's state on the card (16 of 1024
    splats with log-scales (-15.1, -1.78, -8.55) and opacity logit 12,
    64 px): finite gradients for every leaf through render_forward +
    main_loss, one view and a batch of two cameras, raster_bwd launched
    once each."""
    import torch

    from opensplat_tpu_torch.models.gaussians import (PARAM_NAMES,
                                                      GaussianParams,
                                                      init_model)
    from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                        render_forward)
    from opensplat_tpu_torch.ops.kernels import raster
    from opensplat_tpu_torch.ops.ssim import main_loss

    rng = np.random.default_rng(0)
    n, size = 1024, 64
    pts = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                          rng.uniform(-8.0, -4.0, (n, 1))],
                         axis=-1).astype(np.float32)
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    state = init_model(pts, rgb, sh_degree=1, capacity=n, seed=0,
                       device=device)
    bad = torch.as_tensor(rng.choice(n, 16, replace=False), device=device)
    state.params.scales[bad] = torch.tensor([-15.1, -1.78, -8.55],
                                            device=device)
    state.params.opacities[bad] = 12.0
    gt = torch.as_tensor(np.random.default_rng(1).uniform(
        0, 1, (size, size, 3)).astype(np.float32), device=device)
    bg = torch.tensor(DEFAULT_BACKGROUND, device=device)
    need = 1 if torch.device(device).type == "cuda" else 0
    found = {}
    for views in (None, 2):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in state.params.as_dict().items()}
        c2w = torch.eye(4, device=device)
        f, cxy = 80.0, size / 2
        if views:
            c2w = c2w.repeat(views, 1, 1)
            c2w[1, 0, 3] = 0.05
            f, cxy = [f] * views, [cxy] * views
        raster.rasterize_backward.launches = 0
        out = render_forward(GaussianParams(**leaves), state.alive, c2w, f,
                             f, cxy, cxy, size, size, 1, bg, device=device)
        loss = main_loss(out.rgb, gt if views is None else
                         gt.expand(views, size, size, 3), 0.2).sum()
        grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_NAMES])
        if raster.rasterize_backward.launches != need:
            raise AssertionError("degenerate splats: raster_bwd launched "
                                 f"{raster.rasterize_backward.launches}")
        for k, g in zip(PARAM_NAMES, grads):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"degenerate splats ({views or 1} "
                                     f"views): nonfinite {k} gradients")
        found[views or 1] = float(grads[0].abs().max())
        if not found[views or 1] > 0:
            raise AssertionError("degenerate splats: zero means gradient")
    print("degenerate splats (16 of 1024, log-scales (-15.1, -1.78, "
          "-8.55), opacity logit 12): every leaf's gradient finite through "
          "the CUDA raster_bwd, one view and a batch of two; max |d means| "
          + json.dumps(found), flush=True)


def batched_phase(n_points, size, n_steps, smi, device="cuda"):
    """Phase 11: the batched multi-view step at the headline width
    (n_points Gaussians, size px, SH degree 3, bench.py's scene with
    seeds 0-3). (a) For S = 2 and S = 4 scenes and for D = 2 cameras on
    one state: check_batched_kernels. (b) n_steps of
    multi_scene_train_step (S = 2, 4) against S train_step_impl calls,
    bitwise (multi_scene_steps), each kernel launched once a step and
    each SSIM entry S times; n_steps batched_train_steps (D = 2,
    anisotropic scales so that the quats carry real gradients) against
    the loop formulation (camera_batch_steps), each kernel launched once
    a step and each SSIM entry twice. (c) Host-clock scene-steps/s of
    the batched step beside S single steps, launches a step of the four
    kernels and of PyTorch's elementwise kernels, and one BENCH_SCENES=2
    bench line, with the card. Then the degenerate splats
    (degenerate_check). Returns {kernel or SSIM entry: {path:
    launches}} of the batched steps."""
    import torch

    from opensplat_tpu_torch.config import TrainConfig

    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    need = n_steps if cuda else 0
    scenes = [make_scene(n_points, size, seed, device) for seed in range(4)]
    for s in (2, 4):
        views, batch = stage_views([(st, c[0]) for st, c in scenes[:s]], 3,
                                   10 * s, per_view_bg=True)
        check_batched_kernels(views, batch, f"{s} scenes x {n_points} g, "
                                            f"{size} px")
    st0, cams0 = scenes[0]
    views, batch = stage_views([(st0, cams0[0]), (st0, cams0[1])], 3, 50,
                               per_view_bg=False)
    check_batched_kernels(views, batch, f"2 cameras x {n_points} g, {size} "
                                        "px")
    del views, batch

    cfg = TrainConfig(num_downscales=0)
    out = {}
    for s in (2, 4):
        got, single, secs, (a_b, a_s) = multi_scene_steps(
            scenes[:s], n_steps, 3, cfg)
        if any(n != (s * need if k.startswith("ssim") else need)
               for k, n in got.items()):
            raise AssertionError(f"multi-scene S={s}: launches {got} in "
                                 f"{n_steps} batched steps")
        out[f"s{s}"] = got
        half = n_steps - n_steps // 2
        print(f"batched multi-scene S={s}: {n_steps} steps, losses and "
              f"states equal to {s} single steps' bitwise; launches "
              f"(batched) {json.dumps(got)}, (single) "
              f"{json.dumps(single)}; scene-steps/s (host clock, last "
              f"{half} steps) batched {s * half / secs['batched']:.3f}, "
              f"single {s * half / secs['single']:.3f}; torch.profiler, "
              f"one batched step against {s} single steps: elementwise "
              f"launches recorded {a_b[0]} against {a_s[0]}, device ms "
              f"{a_b[1]:.4f} against {a_s[1]:.4f}, each training kernel's "
              f"device ms per launch (launches recorded) "
              f"{json.dumps(a_b[2])} against {json.dumps(a_s[2])} "
              f"({smi})", flush=True)
    st_a = clone_state(st0)
    st_a.params = anisotropic(st_a.params)
    got, worst = camera_batch_steps(st_a, cams0[:2], n_steps, 3, cfg)
    if any(n != (2 * need if k.startswith("ssim") else need)
           for k, n in got.items()):
        raise AssertionError(f"camera batch: launches {got} in {n_steps} "
                             "steps")
    out["d2"] = got
    print(f"batched cameras D=2: {n_steps} batched_train_steps against the "
          f"loop formulation within loss rtol 1e-5, params rtol 2e-4 atol "
          f"1e-5 (worst {json.dumps(worst)}); launches {json.dumps(got)}",
          flush=True)
    del scenes, st0, st_a
    env = {"BENCH_SCENES": "2", "BENCH_POINTS": str(n_points),
           "BENCH_RES": str(size)}
    if cuda:
        torch.cuda.empty_cache()
        name, limit = (x.strip() for x in smi.split(","))
        card = {"platform": "gpu", "name": name, "power_limit": limit}
    else:
        env.update(BENCH_CPU="1", BENCH_ITERS="2")
        card = {"platform": "cpu"}
    line = bench_lines(env, "scenes-vmap", card)
    want = f"scene_steps_per_sec[fast,{n_points}g,{size}px,s2-vmap]"
    if len(line) != 1 or line[0]["metric"] != want:
        raise AssertionError(f"bench s2-vmap: {line}")
    degenerate_check(device)
    print(f"batched phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {k: {p: c[k] for p, c in out.items()} for k in counted_wrappers()}


# float32 operations SSIM needs per pixel and channel: five 11-tap
# separable blurs and the map forward, 242; the map's gradient and the
# three transposed blurs that reach the rendered image backward, 162
OPS_SSIM = 242 + 162
# bytes a pixel: both images read by the forward and again by the
# backward (2 x 24), the gradient written (12)
BYTES_SSIM = 60
# SSIM's sizes on the main path: lego (800 x 800), garden at images_4
SSIM_SIZES = ((800, 800), (840, 1297))
# held to the plain version too, untimed: tests/test_torch_ssim.py's
# shapes (images smaller than a 16 x 32 tile or the 11-tap window, ragged
# edge tiles) and the sizes num_downscales = 2 trains at first, lego's
# 200 and 400 px and garden's 324 x 210 and 648 x 420
SSIM_EDGE_SIZES = ((40, 56), (37, 29), (7, 9), (1, 16), (64, 48),
                   (200, 200), (400, 400), (210, 324), (420, 648))


def banded_gemm_ssim(rendered, gt):
    """The parent's SSIM, kept here as a yardstick only: the blur as two
    float32 matmuls with banded H x H and W x W matrices, at "highest"
    precision, differentiated by autograd."""
    import torch

    from opensplat_tpu_torch.ops.kernels.ssim import gauss_1d

    def band(n):
        g = torch.from_numpy(gauss_1d()).to(gt.device)
        i = torch.arange(n, device=gt.device)
        off = i[None, :] - i[:, None] + 5
        return torch.where((off >= 0) & (off < 11), g[off.clamp(0, 10)],
                           torch.zeros((), device=gt.device))

    h, w = gt.shape[0], gt.shape[1]
    bh, bw = band(h), band(w)

    def blur(img):
        t = (bh @ img.reshape(h, w * 3)).reshape(h, w, 3)
        return bw @ t

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        mu1, mu2 = blur(gt), blur(rendered)
        s11 = blur(gt * gt) - mu1 * mu1
        s22 = blur(rendered * rendered) - mu2 * mu2
        s12 = blur(gt * rendered) - mu1 * mu2
    finally:
        torch.set_float32_matmul_precision(prev)
    return (((2.0 * mu1 * mu2 + 0.01 ** 2) * (2.0 * s12 + 0.03 ** 2))
            / ((mu1 * mu1 + mu2 * mu2 + 0.01 ** 2)
               * (s11 + s22 + 0.03 ** 2))).mean()


def ssim_phase(peak, device="cuda"):
    """Phase 12: the SSIM kernel pair (csrc/ssim.cu) at lego's 800 x 800
    and garden's 1297 x 840, and at SSIM_EDGE_SIZES. Per size: the
    forward's value against the plain version's (rtol 1e-5: every
    pixel's map value takes the same steps, only the mean's order of
    summation differs), the gradient equal to the plain version's
    bitwise (the same steps in the same order), both against the float64
    direct SSIM (value rtol 1e-5, gradient 1e-4 of its largest entry:
    float32 against float64), two calls bitwise equal, one launch of
    each kernel entry a call. At the two main sizes besides: CUDA-event
    ms (median of 20) and device ms (torch.profiler, 20 calls) of
    forward + backward, the bound (bytes and operations over the card's
    peaks), the plain version's ms and the parent's banded-GEMM SSIM's
    (device ms too). Then main_loss on a batch of 4 views of 800 x 800,
    as a lego.scenes4 step takes it: 4 forward and 4 backward launches,
    no cuBLAS kernel in its device time, and each view equal to its own
    call bitwise. Returns the kernels table's row for 800 x 800, with
    the garden size's figures."""
    import torch

    from opensplat_tpu_torch.ops import ssim as tssim
    from opensplat_tpu_torch.ops.kernels import ssim as kssim
    from opensplat_tpu_torch.tools.profiling import device_rows

    info = kssim.kernel_info()
    print("ssim build (CUDA runtime): " + json.dumps(info), flush=True)
    if (info["tile_h"], info["tile_w"]) != (kssim.TILE_H, kssim.TILE_W):
        raise AssertionError("ssim: the kernel's tile differs from "
                             "kssim.TILE_H, TILE_W")

    def device_ms(fn, n=20):
        fn()
        return sum(ms * c for _, ms, c in device_rows(fn, n, device)) / n

    def images(h, w):
        gen = torch.Generator(device=device).manual_seed(h * w)
        gt = torch.rand((h, w, 3), generator=gen, device=device)
        img = (gt + 0.1 * torch.randn((h, w, 3), generator=gen,
                                      device=device)).clamp(0, 1)
        return gt, img, torch.ones((), device=device)

    def check(h, w):
        """The pair against the plain version and the float64 SSIM at
        h x w; returns the gradient's largest difference from the plain
        version's (0 when bitwise)."""
        gt, img, one = images(h, w)
        f0, b0 = kssim.ssim_forward.launches, kssim.ssim_backward.launches
        v_k = kssim.ssim_forward(gt, img)
        g_k = kssim.ssim_backward(gt, img, one)
        if (kssim.ssim_forward.launches - f0,
                kssim.ssim_backward.launches - b0) != (1, 1):
            raise AssertionError("ssim: a call did not count one launch")
        torch.cuda.synchronize()
        if not (torch.equal(v_k, kssim.ssim_forward(gt, img))
                and torch.equal(g_k, kssim.ssim_backward(gt, img, one))):
            raise AssertionError(f"ssim {w} x {h}: two calls differ")
        v_p = kssim.ssim_forward_plain(gt, img)
        g_p = kssim.ssim_backward_plain(gt, img, one)
        r = img.double().requires_grad_(True)
        v_d = kssim.ssim_direct(r, gt)
        v_d.backward()
        g_d = r.grad
        g_scale = float(g_d.abs().max())
        err_v = abs(float(v_k) - float(v_p))
        err_g = float((g_k - g_p).abs().max())
        err_vd = abs(float(v_k) - float(v_d.detach()))
        err_gd = float((g_k.double() - g_d).abs().max())
        print(f"ssim {w} x {h}: value {float(v_k):.8f}, plain "
              f"{float(v_p):.8f}, float64 {float(v_d.detach()):.8f}; "
              f"gradient max abs diff {err_g:.3e} from plain, {err_gd:.3e} "
              f"from float64 (largest entry {g_scale:.3e})", flush=True)
        if err_v > 1e-5 * abs(float(v_p)) or not torch.equal(g_k, g_p):
            raise AssertionError(f"ssim {w} x {h}: kernel differs from the "
                                 "plain version")
        if err_vd > 1e-5 * abs(float(v_d.detach())) or (
                err_gd > 1e-4 * g_scale):
            raise AssertionError(f"ssim {w} x {h}: kernel differs from the "
                                 "float64 direct SSIM")
        return err_g

    for h, w in SSIM_EDGE_SIZES:
        check(h, w)
    rows = {}
    for h, w in SSIM_SIZES:
        err_g = check(h, w)
        gt, img, one = images(h, w)
        leaf = img.clone().requires_grad_(True)

        def pair():
            (1.0 - tssim.ssim(leaf, gt)).backward()

        def plain():
            kssim.ssim_forward_plain(gt, img)
            kssim.ssim_backward_plain(gt, img, one)

        def gemm():
            (1.0 - banded_gemm_ssim(leaf, gt)).backward()

        npx = h * w
        tb = npx * BYTES_SSIM / peak[0] * 1e3
        to = npx * 3 * OPS_SSIM / peak[1] * 1e3
        rows[(h, w)] = {
            "ms": time_ms(pair, 20), "device_ms": device_ms(pair),
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "plain_ms": time_ms(plain, 5), "gemm_ms": time_ms(gemm, 5),
            "gemm_device_ms": device_ms(gemm, 5),
            "max_abs_err": err_g,
        }
        print(f"ssim {w} x {h} forward + backward: " + json.dumps(
            {k: v for k, v in rows[(h, w)].items()}), flush=True)
        del leaf, gt, img

    # a lego.scenes4 step's loss: 4 views of 800 x 800
    gen = torch.Generator(device=device).manual_seed(4)
    gts = torch.rand((4, 800, 800, 3), generator=gen, device=device)
    imgs = (gts + 0.1 * torch.randn(gts.shape, generator=gen,
                                    device=device)).clamp(0, 1)
    batch = imgs.clone().requires_grad_(True)
    losses = []

    def step_loss():
        batch.grad = None
        losses[:] = [tssim.main_loss(batch, gts, 0.2)]
        losses[0].sum().backward()

    f0, b0 = kssim.ssim_forward.launches, kssim.ssim_backward.launches
    step_loss()
    got = (kssim.ssim_forward.launches - f0,
           kssim.ssim_backward.launches - b0)
    if got != (4, 4):
        raise AssertionError(f"ssim: a 4-view loss launched {got}")
    blas = [k for k, _, _ in device_rows(step_loss, 1, device)
            if "gemm" in k.lower() or "gemv" in k.lower()]
    if blas:
        raise AssertionError(f"ssim: cuBLAS kernels in the loss: {blas}")
    for v in range(4):
        leaf = imgs[v].clone().requires_grad_(True)
        lv = tssim.main_loss(leaf, gts[v], 0.2)
        lv.backward()
        if not (torch.equal(losses[0][v].detach(), lv.detach())
                and torch.equal(batch.grad[v], leaf.grad)):
            raise AssertionError(f"ssim: view {v} of a batch differs from "
                                 "its own call")
    print("ssim: a 4-view main_loss launches 4 forward and 4 backward, no "
          "cuBLAS kernel; each view equals its own call bitwise", flush=True)
    lego = rows[SSIM_SIZES[0]]
    garden = rows[SSIM_SIZES[1]]
    return {
        "name": "ssim", "route": "cuda",
        "source": "opensplat_tpu_torch/csrc/ssim.cu", "replaces": None,
        "launches": got, "max_abs_err": lego["max_abs_err"],
        "ms": lego["ms"], "plain_ms": lego["plain_ms"],
        "bound_ms": lego["bound_ms"], "bound_by": lego["bound_by"],
        "library_ms": lego["gemm_ms"], "device_ms": lego["device_ms"],
        "garden": garden,
    }


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
    phase_s, mark = {}, [t_all]

    def done(phase):  # seconds each phase took, printed at the end
        now = time.perf_counter()
        phase_s[phase] = round(now - mark[0], 1)
        mark[0] = now

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

    done(1)
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

    done(2)
    # phase 3: training through the normal entry point at full width
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.train import Trainer

    state, cams = make_scene(131072, 512, 0, "cuda")
    cfg = TrainConfig(num_downscales=0, sh_degree_interval=1,
                      capacity_round=131072)
    trainer = Trainer(state, cams, cfg, device="cuda")
    wrappers = training_wrappers()
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

    done(3)
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
    # one timed call after a warm-up: the plain rasterizers take seconds
    plain_ms = {k: time_ms(fn, 1) for k, fn in plain.items()}
    yard = segsum_yardsticks(inp, g_rec)
    library_ms = min(yard["segment_reduce"], yard["index_add_"])
    tile_balance(inp)
    bnd = bounds(inp, *peak)

    done(4)
    # phase 5: refine past warm-up on the card, then the kernels against
    # their plain versions at the grown capacity, dead slots and all
    ref_trainer, ref_cams = refine_phase(131072, 512, 60, "cuda")
    st = ref_trainer.state
    cap, n_alive = st.alive.shape[0], int(st.alive.sum())
    check_kernels(stage_inputs(st, ref_cams[0], 3, 3),
                  f"grown capacity {cap}, {n_alive} alive")
    del ref_trainer, ref_cams, st

    done(5)
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

    done(6)
    # phase 7: the CLI end to end on a synthetic project at the headline
    # model's width, resume included; phase 8: the conformance renderers
    # on phase 3's model and camera, and on phase 7's project
    import tempfile

    del inp, g_rec, sargs, plain
    with tempfile.TemporaryDirectory() as work:
        cli_launches = cli_phase(131072, 512, 300, "cuda", work)
        done(7)
        tiled_launches = conformance_phase(
            trainer.state, cams[0], os.path.join(work, "project"), "cuda",
            lambda n, size: make_scene(n, size, 0, "cuda"), smi)
        done(8)
        # phase 9: parallel/ on ranks that share the card
        parallel_launches = parallel_phase(
            131072, 512, 20, "cuda", work, os.path.join(work, "project"), smi)
        done(9)
        # phase 10: the bench's sweep and modes, the 1080 px model
        del trainer, state
        os.makedirs(os.path.join(work, "trace"))
        sweep_launches, dev_1080, bnd_1080, _ = sweep_phase(smi, peak, work)
        done(10)
    # phase 11: the batched multi-view step, and the degenerate splats
    batched_launches = batched_phase(131072, 512, 20, smi)
    done(11)
    # phase 12: the SSIM kernel pair at the main path's sizes
    ssim_row = ssim_phase(peak)
    done(12)

    table = []
    for k, (src, rep) in KERNELS.items():
        table.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[k], "max_abs_err": errs[k],
            "ms": kernel_ms[k], "plain_ms": plain_ms[k],
            "bound_ms": bnd[k][0], "bound_by": bnd[k][1],
            "library_ms": library_ms if k == "segsum" else None,
            "device_ms": dev_ms.get(k, (None,))[0],
            "cli_launches": cli_launches.get(k),
            "tiled_launches": tiled_launches.get(k),
            "parallel_launches": parallel_launches.get(k),
            "sweep_launches": sweep_launches.get(k),
            "device_ms_1080": dev_1080.get(k, (None,))[0],
            "bound_ms_1080": bnd_1080.get(k, (None,))[0],
            "batched_launches": batched_launches.get(k),
        })
    def pair(by_path):  # {path: [forward, backward] launches}
        return {p: [n, by_path["ssim_bwd"][p]]
                for p, n in by_path["ssim_fwd"].items()}

    # the SSIM pair's launches on the main path's runs: phase 7's CLI,
    # phase 9's paths (rank 0's), phase 11's batched steps
    ssim_row.update(
        cli_launches=[cli_launches["ssim_fwd"], cli_launches["ssim_bwd"]],
        parallel_launches=pair(parallel_launches),
        batched_launches=pair(batched_launches))
    table.append(ssim_row)
    for row in table:
        print(f"  {row['name']:<10} {row['ms']:.4f} ms  device "
              f"{row['device_ms']} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})  plain {row['plain_ms']:.3f} ms  "
              f"launches {row['launches']}")
    print(f"total {time.perf_counter() - t_all:.1f} s; seconds by phase "
          + json.dumps(phase_s), flush=True)
    if "jax" in sys.modules or "opensplat_tpu" in sys.modules:
        raise AssertionError("jax or opensplat_tpu was imported")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
