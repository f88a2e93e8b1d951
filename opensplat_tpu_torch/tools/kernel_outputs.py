"""The four training kernels' outputs and device times on one set of
staged inputs, to hold two checkouts of the port to each other bit for
bit on the card.

    python opensplat_tpu_torch/tools/kernel_outputs.py stage IN.pt --tree A
    python opensplat_tpu_torch/tools/kernel_outputs.py run IN.pt OUT.pt --tree B
    python opensplat_tpu_torch/tools/kernel_outputs.py compare OUT1.pt OUT2.pt

`stage` trains chip_smoke.py's phase-3 model of checkout A (bench.py's
scene: 131072 Gaussians at 512 px, SH degree 3, 20 Trainer steps) and
saves chip_smoke.stage_inputs of its camera 0: the single-view
arguments of expand, raster_fwd and raster_bwd, and the segment sum's
(the staged backward's rows). `run` imports the port of checkout B,
calls each kernel once on those inputs, saves the outputs and prints
each kernel's device ms per launch (torch.profiler, 20 calls after a
warm-up). `compare` requires every output equal to the bit. The calls
use the single-view signatures every version of the port has kept, so
a checkout from before the view axis runs them too. The file runs as a
script, not with -m, so that `--tree` decides which port it imports.
"""
from __future__ import annotations

import argparse
import json
import sys

KERNELS = {"expand": "expand_kernel", "raster_fwd": "raster_fwd_kernel",
           "raster_bwd": "raster_bwd_kernel", "segsum": "segsum_kernel"}


def _cpu(args):
    import torch

    return [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]


def _cuda(args):
    import torch

    return [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]


def stage(path: str) -> None:
    import chip_smoke
    import torch
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.ops.kernels import raster
    from opensplat_tpu_torch.train import Trainer

    state, cams = chip_smoke.make_scene(131072, 512, 0, "cuda")
    trainer = Trainer(state, cams, TrainConfig(
        num_downscales=0, sh_degree_interval=1, capacity_round=131072),
        device="cuda")
    for step in range(1, 21):
        trainer.run_step(step)
    inp = chip_smoke.stage_inputs(trainer.state, cams[0], 3, 2)
    with torch.no_grad():
        rows = raster.rasterize_backward(*inp["bwd"])
    b = inp["binned"]
    torch.save({"expand": _cpu(inp["expand"]), "fwd": _cpu(inp["fwd"]),
                "bwd": _cpu(inp["bwd"]),
                "segsum": _cpu((rows, b.cand_start, b.cand_count))}, path)
    print(f"staged {b.n_cands} candidate rows, {b.gauss_ids.shape[0]} "
          f"records, to {path}", flush=True)


def run(inputs: str, path: str) -> dict:
    import torch
    from opensplat_tpu_torch.ops.kernels import expand, raster, segsum
    from opensplat_tpu_torch.tools import profiling

    inp = {k: _cuda(v) for k, v in torch.load(inputs).items()}
    calls = {
        "expand": lambda: expand.expand(*inp["expand"]),
        "raster_fwd": lambda: raster.rasterize_forward(*inp["fwd"]),
        "raster_bwd": lambda: raster.rasterize_backward(*inp["bwd"]),
        "segsum": lambda: segsum.segment_sum(*inp["segsum"]),
    }
    out, ms = {}, {}
    with torch.no_grad():
        for k, fn in calls.items():
            got = fn()
            out[k] = _cpu(got if isinstance(got, tuple) else (got,))
            ms[k] = profiling.device_ms(fn, 20, KERNELS[k])
    torch.save(out, path)
    print("device ms per launch (torch.profiler, 20 calls: ms, launches "
          "recorded): " + json.dumps(ms), flush=True)
    return ms


def compare(a: str, b: str) -> None:
    import torch

    x, y = torch.load(a), torch.load(b)
    same = {k: len(x[k]) == len(y[k]) and all(
        torch.equal(p, q) for p, q in zip(x[k], y[k])) for k in KERNELS}
    print(f"{a} against {b}, bitwise: " + json.dumps(same), flush=True)
    if not all(same.values()):
        raise SystemExit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=("stage", "run", "compare"))
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--tree", help="the checkout whose port (and, for "
                    "stage, chip_smoke.py) is imported")
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, args.tree)
    if args.cmd == "stage":
        stage(args.paths[0])
    elif args.cmd == "run":
        run(*args.paths[:2])
    else:
        compare(*args.paths[:2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
