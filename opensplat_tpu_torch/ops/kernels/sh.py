"""The render's spherical-harmonic colours, forward and the gradient of
the coefficients derived by hand (the SH kernel pair).

Replaces no Pallas kernel: the JAX package's SH (opensplat_tpu/ops/
sh.py) is jnp. CUDA source: csrc/sh.cu, a row's math csrc/sh_row.cuh —
one thread per (view, row) computes the view direction, the basis and
the clamped colour, reading features_dc and features_rest where they lie
(no `cat`); the forward keeps the clamp's mask, 3 bits a (view, row),
and the backward recomputes the basis from the mean and writes both
coefficient gradients as tensors of their own. ~434 B a row in all bound
both (see the source note).

The plain version is ops/sh.py::render_colours_plain, with autograd's
backward; ops/sh.py::render_colours takes it for CPU tensors and
`sh_colours` for CUDA tensors. The means are read at their own row
stride; each state's coefficient rows must be consecutive (a contiguous
copy is taken where they are not) and the colour gradient is read at its
own row stride: the rasterizer hands it as a column slice of its
gradient rows. One state's coefficients under V cameras are summed over
the views in view order inside the backward launch.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _lib
from .project import rows

BASES = (1, 4, 9, 16, 25)  # num_sh_bases of degrees 0..4: csrc/sh.cu's


def _run(entry: str, ptrs, ints) -> None:
    p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    i = (ctypes.c_int64 * len(ints))(*ints)
    _lib.launch(entry, *(ctypes.c_void_p(ctypes.addressof(x))
                         for x in (p, i)))


def run_forward(ptrs, ints) -> None:
    """One forward launch (csrc/sh.cu's FwdPtr pointers, FwdInt
    values)."""
    with _lib.timed("sh_fwd"):
        _run("osk_sh_fwd", ptrs, ints)
    run_forward.launches += 1


def run_backward(ptrs, ints) -> None:
    """One backward launch (csrc/sh.cu's BwdPtr pointers, BwdInt
    values)."""
    with _lib.timed("sh_bwd"):
        _run("osk_sh_bwd", ptrs, ints)
    run_backward.launches += 1


run_forward.launches = 0
run_backward.launches = 0


def check(n_used: int, means, cam_pos, features_dc, features_rest):
    """Raises unless the arguments are what the kernel takes: float32
    tensors on one CUDA device; means (1 or V, N, 3), cam_pos (V, 3),
    features_dc (1 or V, N, 3), features_rest (1 or V, N, B - 1, 3) of
    the same states, B in BASES, n_used bases of them used."""
    for name, t in (("means", means), ("cam_pos", cam_pos),
                    ("features_dc", features_dc),
                    ("features_rest", features_rest)):
        if t.dtype != torch.float32:
            raise TypeError(f"sh: {name}: expected torch.float32, got "
                            f"{t.dtype}")
    if cam_pos.dim() != 2 or cam_pos.shape[1] != 3:
        raise ValueError(f"sh: cam_pos: expected (V, 3), got "
                         f"{tuple(cam_pos.shape)}")
    views = cam_pos.shape[0]
    if means.dim() != 3 or means.shape[2] != 3:
        raise ValueError(f"sh: means: expected (1 or V, N, 3), got "
                         f"{tuple(means.shape)}")
    n = means.shape[1]
    if features_dc.dim() != 3 or tuple(features_dc.shape[1:]) != (n, 3):
        raise ValueError(f"sh: features_dc: expected (1 or V, {n}, 3), got "
                         f"{tuple(features_dc.shape)}")
    if (features_rest.dim() != 4 or features_rest.shape[1] != n
            or features_rest.shape[3] != 3
            or features_rest.shape[2] + 1 not in BASES):
        raise ValueError(f"sh: features_rest: expected (1 or V, {n}, B - 1, "
                         f"3) with B in {BASES}, got "
                         f"{tuple(features_rest.shape)}")
    for name, t in (("means", means), ("features_dc", features_dc),
                    ("features_rest", features_rest)):
        if t.shape[0] not in (1, views):
            raise ValueError(f"sh: {name}: {t.shape[0]} states for {views} "
                             "views")
    if features_dc.shape[0] != features_rest.shape[0]:
        raise ValueError("sh: features_dc and features_rest have "
                         f"{features_dc.shape[0]} and "
                         f"{features_rest.shape[0]} states")
    bases = features_rest.shape[2] + 1
    if not 1 <= n_used <= bases:
        raise ValueError(f"sh: {n_used} bases used of the coefficients' "
                         f"{bases}")
    dev = means.device
    for name, t in (("means", means), ("cam_pos", cam_pos),
                    ("features_dc", features_dc),
                    ("features_rest", features_rest)):
        if not t.is_cuda:
            raise ValueError(f"sh: {name}: expected a CUDA tensor, got "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"sh: {name} on {t.device}, means on {dev}")


def _view_stride(t: torch.Tensor) -> int:
    """Floats from one view's state to the next in a contiguous (1 or V,
    N, ...) tensor; 0 where one state serves every view."""
    return t[0].numel() if t.shape[0] > 1 else 0


class _SH(torch.autograd.Function):
    """rgb (V, N, 3) of V views; differentiable in features_dc and
    features_rest through the hand-derived backward."""

    @staticmethod
    def forward(ctx, features_dc, features_rest, means, cam_pos, n_used):
        views, n = cam_pos.shape[0], means.shape[1]
        dc = features_dc.detach().contiguous()
        rest = features_rest.detach().contiguous()
        m, s_means = rows(means.detach(), means.shape[0] * n, 3, "means")
        cam = cam_pos.detach().contiguous()
        dev = means.device
        rgb = torch.empty((views, n, 3), dtype=torch.float32, device=dev)
        mask = torch.empty((views, n), dtype=torch.uint8, device=dev)
        if n:
            run_forward(
                (m.data_ptr(), cam.data_ptr(), dc.data_ptr(),
                 rest.data_ptr(), rgb.data_ptr(), mask.data_ptr()),
                (n, views, rest.shape[2] + 1, n_used, s_means,
                 n * s_means if m.shape[0] > 1 else 0,
                 _view_stride(dc), _view_stride(rest)))
        ctx.save_for_backward(m, cam, mask)
        ctx.s_means, ctx.n_used = s_means, n_used
        ctx.shapes = (tuple(features_dc.shape), tuple(features_rest.shape))
        return rgb

    @staticmethod
    @once_differentiable
    def backward(ctx, v_rgb):
        if not any(ctx.needs_input_grad[:2]):
            return (None,) * 5
        m, cam, mask = ctx.saved_tensors
        dc_shape, rest_shape = ctx.shapes
        views, n = mask.shape
        states = dc_shape[0]
        dev = mask.device
        v_dc = torch.empty(dc_shape, dtype=torch.float32, device=dev)
        v_rest = torch.empty(rest_shape, dtype=torch.float32, device=dev)
        if n:
            g, s_g = rows(v_rgb, views * n, 3, "colour gradient")
            run_backward(
                (m.data_ptr(), cam.data_ptr(), mask.data_ptr(),
                 g.data_ptr(), v_dc.data_ptr(), v_rest.data_ptr()),
                (n, views, states, rest_shape[2] + 1, ctx.n_used,
                 ctx.s_means, n * ctx.s_means if m.shape[0] > 1 else 0,
                 s_g))
        need_dc, need_rest = ctx.needs_input_grad[:2]
        return (v_dc if need_dc else None, v_rest if need_rest else None,
                None, None, None)


def sh_colours(n_used: int, means: torch.Tensor, cam_pos: torch.Tensor,
               features_dc: torch.Tensor,
               features_rest: torch.Tensor) -> torch.Tensor:
    """ops/sh.py::render_colours_plain's contract on CUDA tensors (means
    (1 or V, N, 3), detached; cam_pos (V, 3); features_dc (1 or V, N, 3)
    and features_rest (1 or V, N, B - 1, 3)), with the first n_used =
    num_sh_bases(degrees_to_use) bases used: the clamped colours (V, N,
    3). One forward launch, and one backward launch when a gradient
    reaches the coefficients."""
    check(n_used, means, cam_pos, features_dc, features_rest)
    return _SH.apply(features_dc, features_rest, means, cam_pos, n_used)


def kernel_info() -> dict:
    """The block and what the CUDA runtime reports of both kernels' builds
    at SH degree 3 (registers, shared memory a CTA, resident CTAs an
    SM)."""
    return _lib.kernel_info(
        "osk_sh_info",
        ("threads", "fwd_registers", "fwd_smem_bytes", "fwd_ctas_per_sm",
         "bwd_registers", "bwd_smem_bytes", "bwd_ctas_per_sm"))
