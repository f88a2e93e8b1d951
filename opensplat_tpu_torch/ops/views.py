"""Per-view operations of a batch of views, each the bits of its own call.

A batch of V views (V scenes, or V cameras over one state: the JAX
package's vmapped steps) runs most of the step as elementwise operations
over a leading view axis; those give every view's entries the bits of a
single-view call, on the card and in the plain versions. A GEMM, an
einsum or a whole-tensor reduction does not promise that: cuBLAS and
PyTorch's reductions pick their kernel, and with it the summation order,
from the shapes and from how the operands are aligned. Such operations
run here once a view (`per_view`), on each view's slice at an address as
aligned as a single view's own tensor, so a view of a batch takes the
single view's path. The view axis then costs V launches of these few
operations, while the kernels and the elementwise passes run once.
"""
from __future__ import annotations

import torch


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy where `t` is not as aligned as a fresh allocation
    (the caching allocator's 512 bytes on the card, 64 on the host), as
    a slice of a batch may not be."""
    align = 512 if t.is_cuda else 64
    return t if t.data_ptr() % align == 0 else t.clone()


class _AlignedGrad(torch.autograd.Function):
    """The identity, whose backward hands the gradient on `aligned`: a
    view's gradient arrives as a slice of the batch's."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return aligned(g)


def per_view(fn, views: int, *tensors):
    """torch.stack([fn(view v's slices) for v < views]): each tensor's
    leading axis is the views' (or 1: one tensor for every view), and
    every slice, and every gradient fn's backward receives, is
    `aligned`."""
    return torch.stack([
        _AlignedGrad.apply(fn(*(aligned(t[min(v, t.shape[0] - 1)])
                                for t in tensors)))
        for v in range(views)])
