"""Per-Gaussian segment sum of the per-record gradients (kernel 4).

Replaces opensplat_tpu/ops/pallas/segsum.py::_segsum_kernel
(pallas_segment_sum). CUDA source: csrc/segsum.cu — a warp per 32
Gaussians sums each one's contiguous segment of rows in a fixed order;
bound by bytes (see the source note there). `segment_sum_plain` is the
same function in plain PyTorch (each segment summed on its own in
float64, so a segment's sum does not depend on the rows before it: a
batch of views gives each view the sums of its own call); the wrapper
takes it only for CPU tensors.

The rows come in Gaussian order: the backward writes each record's row
at its candidate row (`BinnedGaussians.cand_index`), and Gaussian g's
candidate rows are cand_start[g] .. cand_start[g] + cand_count[g]
(ops/binning.py). Culled candidates are zero rows inside the segments.
"""
from __future__ import annotations

import torch

from . import _lib


def segment_sum_plain(rows, cand_start, cand_count):
    count = cand_count.long()
    seg = torch.repeat_interleave(torch.arange(count.shape[0],
                                               device=rows.device), count)
    first = torch.repeat_interleave(cand_start.long() - count.cumsum(0)
                                    + count, count)
    at = first + torch.arange(seg.shape[0], device=rows.device)
    out = rows.new_zeros((count.shape[0], rows.shape[1]), dtype=torch.float64)
    return out.index_add_(0, seg, rows[at].double()).to(torch.float32)


def segment_sum(rows, cand_start, cand_count):
    """Per-Gaussian (C, 9) sums of the rows (I, 9): Gaussian g sums rows
    cand_start[g] .. cand_start[g] + cand_count[g]. The kernel reads the
    rows coalesced when the segments are adjacent and in order
    (cand_start the exclusive cumsum of cand_count), as bin_gaussians
    makes them."""
    if not rows.is_cuda:
        return segment_sum_plain(rows, cand_start, cand_count)
    c = cand_count.shape[0]
    _lib.check(rows, "rows", torch.float32, (-1, 9))
    _lib.check(cand_start, "cand_start", torch.int64, (c,))
    _lib.check(cand_count, "cand_count", torch.int32, (c,))
    if rows.data_ptr() % 16:
        raise ValueError("rows: expected a 16-byte aligned tensor")
    out = torch.empty((c, 9), dtype=torch.float32, device=rows.device)
    p = _lib.ptr
    with _lib.timed("segsum"):
        _lib.launch("osk_segsum", c, p(cand_start), p(cand_count), p(rows),
                    p(out))
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
