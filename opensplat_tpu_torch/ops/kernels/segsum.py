"""Per-Gaussian segment sum of the per-record gradients (kernel 4).

Replaces opensplat_tpu/ops/pallas/segsum.py::_segsum_kernel
(pallas_segment_sum). CUDA source: csrc/segsum.cu — one warp per
Gaussian sums its records through the gid-order permutation in a fixed
order; bound by bytes (see the source note there). `segment_sum_plain`
is the same function in plain PyTorch (float64 prefix sums); the wrapper
takes it only for CPU tensors.

The permutation into Gaussian order is a stable torch.sort of the
tile-sorted gauss_ids (outside the kernel, as the JAX package's payload
sort is outside Pallas); Gaussian g's records are positions
[off[g], off[g] + kept[g]) of it, off being the exclusive cumsum of the
kept counts. Sentinel ids (C) sort past every segment.
"""
from __future__ import annotations

import torch

from . import _lib


def gid_order(gauss_ids: torch.Tensor, kept: torch.Tensor):
    """(perm (I,) int64 into Gaussian order, offsets (C,) int64)."""
    _, perm = torch.sort(gauss_ids, stable=True)
    offsets = torch.cumsum(kept.long(), 0) - kept.long()
    return perm, offsets


def segment_sum_plain(perm, offsets, kept, grads):
    n = int(kept.long().sum())
    cols = grads[perm[:n]].double().T.contiguous()  # (9, n): scan rows
    cs = torch.cat([cols.new_zeros((grads.shape[1], 1)), cols.cumsum(1)], 1)
    return (cs[:, offsets + kept.long()] - cs[:, offsets]).T.to(torch.float32)


def segment_sum_sorted(perm, offsets, kept, grads):
    """(C, 9) sums given the Gaussian-order permutation and segments."""
    if not grads.is_cuda:
        return segment_sum_plain(perm, offsets, kept, grads)
    c = kept.shape[0]
    _lib.check(perm, "perm", torch.int64, (-1,))
    _lib.check(offsets, "offsets", torch.int64, (c,))
    _lib.check(kept, "kept", torch.int32, (c,))
    _lib.check(grads, "grads", torch.float32, (-1, 9))
    out = torch.empty((c, 9), dtype=torch.float32, device=grads.device)
    p = _lib.ptr
    with _lib.timed("segsum"):
        _lib.launch("osk_segsum", c, p(offsets), p(kept), p(perm), p(grads),
                    p(out))
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0


def segment_sum(gauss_ids, kept, grads):
    """Per-Gaussian (C, 9) sums of the per-record gradients `grads`
    (I, 9), record i belonging to Gaussian gauss_ids[i]; `kept` (C,) int32
    holds each Gaussian's record count."""
    perm, offsets = gid_order(gauss_ids, kept)
    return segment_sum_sorted(perm, offsets, kept.contiguous(),
                              grads.contiguous())
