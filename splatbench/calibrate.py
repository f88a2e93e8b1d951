"""Readings that the limits of limits/<cell>.json are set from, on the
card at the cell's own size, many seeds in one process:

    python3 splatbench/calibrate.py --workload <cell> --seeds 1-12 \
        [--control-seeds 1-3]

For each seed, the program's checked steps (the window's run_step calls,
as a run makes them) against the reference: the sound readings.
For each control seed also (a) the control, the reference computed with
TF32 allowed put in the program's place, and (b) the program with half
of the image left out of its loss (its rows' mean taken over the rest).
A state left unchanged reads 1 on grad_gap by construction and needs no
run. One JSON line a seed and reading; the limits are not read.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from splatbench import correctness, harness  # noqa: E402


def seeds(spec: str):
    """`lo-hi`, `lo-hi:step` (a cell of S scenes takes seed to seed + S - 1,
    so a step of S keeps the seeds' scenes apart), or a comma list of
    these."""
    out = []
    for part in spec.split(","):
        span, _, step = part.partition(":")
        lo, _, hi = span.partition("-")
        out += range(int(lo), int(hi or lo) + 1, int(step or 1))
    return out


def program_readings(cell, seed, dev, prog):
    """The program's checked steps at `seed`: (readings with the change
    norms, the views, the program's scenes without the trainer)."""
    job = harness.build(cell, seed, dev, prog)
    readings, views, after = harness.checked_steps(
        job, int(cell.traffic["first_step"]),
        int(cell.traffic["checked_steps"]))
    job.trainer = None
    gc.collect()
    torch.cuda.empty_cache()
    harness.program_changes(cell, job, dev, readings, after)
    return readings, views, job


def gaps(prog, ref):
    """The numbers compared, and grad_gap over whole groups beside."""
    return dict(correctness.compare(prog, ref),
                full_grad_gap=correctness.full_grad_gap(prog, ref))


def half_loss(train_mod):
    """main_loss over the first half of the rows: half of the batch
    left out, the mean taken over the rest."""
    full = train_mod.main_loss

    def loss(rendered, gt, w):
        h = gt.shape[-3] // 2
        return full(rendered[..., :h, :, :], gt[..., :h, :, :], w)
    return full, loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = harness.program()
    import opensplat_tpu_torch.train as train_mod
    controls = set(seeds(args.control_seeds)) if args.control_seeds else set()
    train = cell.config["train"]
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        readings, views, job = program_readings(cell, seed, dev, prog)
        t1 = time.perf_counter()
        ref = correctness.reference_readings(
            harness.reference_scenes(cell, job, dev, views), train)
        t2 = time.perf_counter()
        print(json.dumps({"cell": cell.name, "seed": seed, "kind": "sound",
                          "gaps": gaps(readings, ref),
                          "program": readings.numbers(),
                          "reference": ref.numbers(), "program_s": t1 - t0,
                          "reference_s": t2 - t1}), flush=True)
        if seed in controls:
            ctl = correctness.reference_readings(
                harness.reference_scenes(cell, job, dev, views), train,
                tf32=True)
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "kind": "control_tf32",
                              "gaps": gaps(ctl, ref),
                              "program": ctl.numbers()}), flush=True)
            full, loss = half_loss(train_mod)
            train_mod.main_loss = loss
            try:
                half, hviews, _ = program_readings(cell, seed, dev, prog)
            finally:
                train_mod.main_loss = full
            if hviews != views:
                raise RuntimeError("calibrate: the fault run drew other "
                                   "cameras")
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "kind": "fault_half_batch",
                              "gaps": gaps(half, ref),
                              "program": half.numbers()}), flush=True)
        del job
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
