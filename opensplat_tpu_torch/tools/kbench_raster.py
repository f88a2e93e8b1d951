"""Ablation bench of the forward rasterizer, on the card.

Counterpart of tools/kbench_raster.py (the JAX package's bench): times
the forward kernel's variants with pieces removed — the prefix over a
chunk (`nomatmul`), the transcendentals (`notrans`), the stop test and
its early exit (`nostop`), everything but the chunk loop and its loads
(`skeleton`) — beside `full` and the main path's forward kernel
(`real`, raster.rasterize_forward with gauss_ids = arange(I)), to locate
where a tile's time goes. The variants' kernel is
csrc/raster_fwd_variants.cu (ops/kernels/raster_variants.py).

Caveat, kept from the JAX package's notes: isolated kernel times locate
cost; only end-to-end numbers (steps/s of a training run) are trusted.
A variant's output is not an image: `notrans` goes negative and grows.

The stream is make_stream's of the JAX bench, from the same numpy draws
in the same order: n_tiles tiles of per_tile records each, positions,
conics, opacities and 10-bit colours shaped like a mid-training scene,
tile ranges unaligned to the 256-record chunks. The whole stream is
40 MB at the default size and stays in the 50 MB L2 cache between calls.

    python -m opensplat_tpu_torch.tools.kbench_raster          # on the card
    python -m opensplat_tpu_torch.tools.kbench_raster --cpu --tiles 16

Each line is ms per call, the median of --iters calls timed with CUDA
events (on the CPU: the host clock around the plain versions), on the
card also the device time per call (torch.profiler, 10 calls), and the
records the call replayed: per tile, up to its last pixel's stop (all of
the tile's records where a pixel never stops, and in nostop and
skeleton), summed over tiles. The variants change how far a tile
replays (notrans stops every pixel early, nomatmul later), so ms per
replayed (pixel, record) pair is the cost that compares across them.
"""
from __future__ import annotations

import argparse
import functools
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..models.splat_model import DEFAULT_BACKGROUND
from ..ops.kernels import raster, raster_variants
from .profiling import device_ms

BENCH_NAMES = raster_variants.VARIANTS + ("real",)
# each name's __global__ function, as torch.profiler names it
KERNELS = dict.fromkeys(raster_variants.VARIANTS, "kbench_fwd_kernel")
KERNELS["real"] = "raster_fwd_kernel"


@dataclass
class Stream:
    """Tile-sorted records in the port's per-record layout."""

    tile_start: torch.Tensor  # (T,) int32
    tile_end: torch.Tensor  # (T,) int32
    xys: torch.Tensor  # (I, 2) f32
    conics: torch.Tensor  # (I, 3) f32: A, B, C
    opac: torch.Tensor  # (I,) f32
    colors: torch.Tensor  # (I, 3) f32, in [0, 4]
    tb_x: int
    tb_y: int

    @property
    def n_records(self) -> int:
        return self.xys.shape[0]


def make_stream(n_tiles=1024, per_tile=1074, tb_x=32, seed=0,
                device="cuda") -> Stream:
    """make_stream of tools/kbench_raster.py: the same draws (x, y, s,
    C's factor, B, op, q, gid) from the same numpy generator, stored as
    float32 per-record tensors. The 10-bit colour q decodes as
    float32(q) * float32(4 / 1023), as the JAX kernels do; the gid plane
    is drawn to keep the order but is not read by the forward."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = n_tiles * per_tile
    tx = (np.arange(n_tiles) % tb_x) * 16
    ty = (np.arange(n_tiles) // tb_x) * 16
    tile_of = np.repeat(np.arange(n_tiles), per_tile)
    x = tx[tile_of] + rng.uniform(-6, 22, n)
    y = ty[tile_of] + rng.uniform(-6, 22, n)
    s = rng.uniform(0.8, 4.0, n)
    A = 1.0 / (s * s)
    C = 1.0 / (s * s) * rng.uniform(0.7, 1.4, n)
    B = rng.uniform(-0.2, 0.2, n) * np.sqrt(A * C)
    op = rng.uniform(0.03, 0.95, n)
    q = rng.integers(0, 1024, (n, 3))
    rng.integers(0, 131072, n)  # the gid plane
    colors = q.astype(np.float32) * np.float32(4.0 / 1023.0)
    tile_start = (np.arange(n_tiles) * per_tile).astype(np.int32)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return Stream(
        tile_start=t(tile_start, np.int32),
        tile_end=t(tile_start + per_tile, np.int32),
        xys=t(np.stack([x, y], 1)),
        conics=t(np.stack([A, B, C], 1)),
        opac=t(op),
        colors=t(colors),
        tb_x=tb_x,
        tb_y=(n_tiles + tb_x - 1) // tb_x,
    )


# tile ranges over make_stream(4, 300, 2)'s 1200 records that meet the
# kernel's 256-record chunk boundaries unevenly: a 40-record tile, one
# over four chunks, an empty one and one ending at the stream's end
UNEVEN = ([0, 40, 900, 900], [40, 900, 900, 1200])


def uneven_stream(device="cuda") -> Stream:
    """make_stream(4, 300, 2)'s records with the UNEVEN tile ranges."""
    st = make_stream(4, 300, 2, device=device)
    st.tile_start = torch.tensor(UNEVEN[0], dtype=torch.int32,
                                 device=st.xys.device)
    st.tile_end = torch.tensor(UNEVEN[1], dtype=torch.int32,
                               device=st.xys.device)
    return st


def residue_stream(device="cuda") -> Stream:
    """257 tiles of 257 records: tile t starts at 257 t, so the starts
    fall at every residue mod 256 (and mod 64), and the stream's 66049
    records end inside a 16-byte piece of every record tensor."""
    return make_stream(257, 257, 16, device=device)


def cull_records(n, seed):
    """n records around (0, 0) for the kernel's warp cull (warp_mask):
    half drawn like make_stream's, half adversarial — scales from 0.02
    to 40 px, aspect up to 30 at any rotation (the smallest and the
    thinnest fall outside the conics the cull bounds), one in eight of
    those with B^2 > A C (no ellipse at all), opacities at 1/255 (1 +-
    1e-3) and up. Numpy float64: xy (n, 2) within 40 px of the origin,
    conics (n, 3) = (A, B, C), op (n,)."""
    rng = np.random.default_rng(seed)
    m = n // 2
    s = np.concatenate([rng.uniform(0.8, 4.0, m),
                        np.exp(rng.uniform(np.log(0.02), np.log(40.0),
                                           n - m))])
    aspect = np.concatenate([rng.uniform(0.7, 1.4, m),
                             np.exp(rng.uniform(0.0, np.log(30.0), n - m))])
    theta = rng.uniform(0.0, np.pi, n)
    # conic = inverse covariance of axes (s, s * aspect) rotated by theta
    l1, l2 = 1.0 / s ** 2, 1.0 / (s * aspect) ** 2
    c, si = np.cos(theta), np.sin(theta)
    A = l1 * c * c + l2 * si * si
    C = l1 * si * si + l2 * c * c
    B = (l1 - l2) * c * si
    no_ellipse = np.arange(n) >= n - (n - m) // 8
    B = np.where(no_ellipse, 1.5 * np.sqrt(A * C), B)
    thresh = 1.0 / 255.0
    op = np.concatenate([rng.uniform(0.03, 0.95, m),
                         rng.choice([thresh * 0.999, thresh * 1.001,
                                     thresh * 1.5, 0.5, 0.999], n - m)])
    xy = rng.uniform(-40.0, 40.0, (n, 2))
    return xy, np.stack([A, B, C], 1), op


def cull_stream(n_tiles=64, per_tile=512, tb_x=8, seed=1,
                device="cuda") -> Stream:
    """n_tiles tiles of cull_records each, around the tile's own centre,
    with make_stream's 10-bit colours: the records that hold the
    kernel's warp cull to the plain version, which has none."""
    dev = resolve_device(device)
    n = n_tiles * per_tile
    xy, conics, op = cull_records(n, seed)
    tile_of = np.repeat(np.arange(n_tiles), per_tile)
    xy[:, 0] += (tile_of % tb_x) * 16 + 7.5
    xy[:, 1] += (tile_of // tb_x) * 16 + 7.5
    q = np.random.default_rng(seed + 1).integers(0, 1024, (n, 3))
    colors = q.astype(np.float32) * np.float32(4.0 / 1023.0)
    tile_start = (np.arange(n_tiles) * per_tile).astype(np.int32)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return Stream(
        tile_start=t(tile_start, np.int32),
        tile_end=t(tile_start + per_tile, np.int32),
        xys=t(xy), conics=t(conics), opac=t(op), colors=t(colors),
        tb_x=tb_x, tb_y=(n_tiles + tb_x - 1) // tb_x)


def variant_args(stream: Stream):
    return (stream.tile_start, stream.tile_end, stream.xys, stream.conics,
            stream.opac, stream.colors, stream.tb_x)


def real_args(stream: Stream):
    """raster.rasterize_forward's arguments: record i is Gaussian i."""
    dev = stream.xys.device
    ids = torch.arange(stream.n_records, dtype=torch.int32, device=dev)
    bg = torch.tensor(DEFAULT_BACKGROUND, dtype=torch.float32, device=dev)
    return (ids, stream.tile_start, stream.tile_end, stream.xys,
            stream.conics, stream.opac, stream.colors, bg, stream.tb_y * 16,
            stream.tb_x * 16)


def call(name: str, stream: Stream):
    """One call of `name` (a variant, or "real") on the stream."""
    if name == "real":
        return raster.rasterize_forward(*real_args(stream))
    return raster_variants.rasterize_variant(name, *variant_args(stream))


def _median_ms(fn, iters: int, cuda: bool) -> float:
    fn()  # warm-up (and the kernels' build on a first call)
    out = []
    if cuda:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
        if cuda:
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            out.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def run_bench(stream: Stream, names=BENCH_NAMES, iters: int = 30) -> dict:
    """{name: (ms per call, records replayed, device)}: CUDA events around
    each call on the card, the host clock on the CPU (plain versions);
    `device` is (device ms per call, launches recorded) by torch.profiler
    over 10 calls on the card, None on the CPU."""
    cuda = stream.xys.is_cuda
    out = {}
    for name in names:
        fn = functools.partial(call, name, stream)
        ms = _median_ms(fn, iters, cuda)
        dev = device_ms(fn, 10, KERNELS[name]) if cuda else None
        out[name] = (ms, raster.records_replayed(
            stream.tile_start, stream.tile_end, fn()[-1]), dev)
    return out


def main(argv=None) -> dict:
    """Prints one line per variant; returns run_bench's dict."""
    ap = argparse.ArgumentParser(
        prog="python -m opensplat_tpu_torch.tools.kbench_raster",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    ap.add_argument("--tiles", type=int, default=1024)
    ap.add_argument("--per-tile", type=int, default=1074)
    ap.add_argument("--tb-x", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--variants", default=",".join(BENCH_NAMES),
                    help="comma-separated subset of " + ",".join(BENCH_NAMES))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    bad = [n for n in names if n not in BENCH_NAMES]
    if bad:
        ap.error(f"unknown variants {bad}")
    dev = resolve_device("cpu" if args.cpu else "cuda")
    stream = make_stream(args.tiles, args.per_tile, args.tb_x, device=dev)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu, plain versions, host clock")
    times = run_bench(stream, names, args.iters)
    for name, (ms, replayed, dev) in times.items():
        pairs = max(256 * replayed, 1)
        ps = ms * 1e9 / pairs
        on_card = ""
        if dev is not None and dev[0] is not None:
            on_card = (f"; device {dev[0]:.4f} ms/call ({dev[1]} launches "
                       f"recorded), {dev[0] * 1e9 / pairs:.3f} ps per pair")
        print(f"{name:10s} {ms:9.4f} ms/call, {replayed} records replayed, "
              f"{ps:.3f} ps per (pixel, record) pair{on_card} ({args.tiles} "
              f"tiles, {stream.n_records} records; {where})", flush=True)
    return times


if __name__ == "__main__":
    main()
