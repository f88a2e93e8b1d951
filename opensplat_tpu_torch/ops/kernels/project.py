"""The EWA projection, forward and its backward derived by hand (the
projection kernel pair).

Replaces no Pallas kernel: the JAX package's projection is jnp. CUDA
source: csrc/project.cu, a row's math csrc/project_row.cuh — one thread
per (view, row) computes every output of `project_gaussians`; the
backward recomputes the forward in registers from the inputs and takes
the chain rule by hand, term for term as autograd takes it through the
plain version; ~230 B a row in all bound both (see the source note).

The plain version is ops/projection.py::_project_views, with autograd's
backward; `project_gaussians` takes it for CPU tensors and `project`
for CUDA tensors. Each Gaussian input and each output gradient is read
at its own row stride, without a copy where its rows lie at one stride
(`rows`): the rasterizer hands the gradients of xys and conics as column
slices of one row array. Per-view scalars (fx, fy, cx, cy and the FOV
limits) go into the launch's argument block as the float32 roundings
the plain version's per-view columns hold, so the card path uploads
nothing and each view's outputs are the bits of its own call; a batch
wider than MAX_VIEWS takes several launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _lib
from .adam import row_stride

MAX_VIEWS = 32  # csrc/project.cu
BLOCK = 16  # tile side (ops/projection.py BLOCK_X, BLOCK_Y)

# The entries' host arrays, in csrc/project.cu's order
FWD_PTRS = ("means", "scales", "quats", "viewmat", "projmat", "valid",
            "opac", "xys", "depths", "cam_depths", "radii", "conics",
            "cov2d", "num_tiles_hit", "tile_min", "tile_max", "mask",
            "front")
BWD_PTRS = ("means", "scales", "quats", "viewmat", "projmat", "v_xys",
            "v_depths", "v_cam_depths", "v_conics", "v_cov2d", "v_means",
            "v_scales", "v_quats")
INTS = ("n", "views", "tb_x", "tb_y", "s_means", "s_scales", "s_quats",
        "s_opac", "vs_means", "vs_scales", "vs_quats", "vs_opac",
        "vs_valid", "s_v_xys", "s_v_depths", "s_v_cam_depths", "s_v_conics",
        "s_v_cov2d")
FLOATS = ("glob", "clip", "half_w", "half_h", "row_off", "inv_alpha")
VIEW_FLOATS = ("fx", "fy", "cx", "cy", "lim_x", "lim_y")
# the forward's outputs: (trailing shape, dtype)
OUTPUTS = {
    "xys": ((2,), torch.float32), "depths": ((), torch.float32),
    "cam_depths": ((), torch.float32), "radii": ((), torch.int32),
    "conics": ((3,), torch.float32), "cov2d": ((3,), torch.float32),
    "num_tiles_hit": ((), torch.int32), "tile_min": ((2,), torch.int32),
    "tile_max": ((2,), torch.int32), "mask": ((), torch.bool),
    "front": ((), torch.bool),
}
# the differentiable outputs, in OUTPUTS' order, and their widths
GRADS = {"xys": 2, "depths": 1, "cam_depths": 1, "conics": 3, "cov2d": 3}


def _f32(x) -> float:
    return float(np.float32(float(x)))


class Setup(NamedTuple):
    """What a call's rows share: V views of N rows, the tile grid,
    FLOATS' values and VIEW_FLOATS' values a view, each the float32
    rounding of the Python value the plain version hands to PyTorch."""
    views: int
    n: int
    tb_x: int
    tb_y: int
    floats: Tuple[float, ...]
    view_floats: Tuple[Tuple[float, ...], ...]


def setup(views, n, glob_scale, fx, fy, cx, cy, img_height, img_width,
          clip_thresh, alpha_thresh, fov_width, fov_height,
          row_offset) -> Setup:
    """The call's Setup, each value computed from the same Python
    operands as in ops/projection.py::_project_views (fx, fy, cx, cy:
    V values each)."""
    fov_w = fov_width if fov_width is not None else img_width
    fov_h = fov_height if fov_height is not None else img_height
    if row_offset is None:
        half_w, half_h, row_off = 0.5 * img_width, 0.5 * img_height, 0
    else:
        half_w = 0.5 * (fov_width or img_width)
        half_h, row_off = 0.5 * fov_height, row_offset
    # PyTorch's CUDA division by a host scalar multiplies by its float32
    # reciprocal
    inv_alpha = float(np.float32(1.0) / np.float32(alpha_thresh))
    per_view = tuple(
        (_f32(x), _f32(y), _f32(u), _f32(v),
         _f32(1.3 * (0.5 * fov_w / x)), _f32(1.3 * (0.5 * fov_h / y)))
        for x, y, u, v in zip(fx, fy, cx, cy))
    if len(per_view) != views:
        raise ValueError(f"project: {views} views, {len(per_view)} values "
                         "of fx, fy, cx and cy")
    return Setup(views, n, (img_width + BLOCK - 1) // BLOCK,
                 (img_height + BLOCK - 1) // BLOCK,
                 tuple(_f32(x) for x in (glob_scale, clip_thresh, half_w,
                                         half_h, row_off)) + (inv_alpha,),
                 per_view)


def rows(t: torch.Tensor, n_rows: int, width: int,
         label: str) -> Tuple[torch.Tensor, int]:
    """`t` seen as n_rows rows of `width` float32s, and the stride in
    floats between them: `t` itself where its rows lie at one stride
    (ops/kernels/adam.py::row_stride), else a contiguous copy."""
    if t.numel() != n_rows * width:
        raise ValueError(f"project: {label}: {t.numel()} values, expected "
                         f"{n_rows} rows of {width}")
    if t.dtype != torch.float32:
        t = t.to(torch.float32)
    try:
        return t, row_stride(t, n_rows, label, writable=False)
    except ValueError:
        return t.contiguous(), width


class _Arg(NamedTuple):
    ptr: int  # a device address, 0 for none
    view_bytes: int  # from one view's rows to the next; 0: shared


def _state_arg(t, views, n, width, label):
    """A Gaussian input (1 or V states, N rows of `width`): the tensor the
    kernel reads (which the caller keeps alive), its _Arg and its row
    stride."""
    lead = t.numel() // (n * width)
    if lead not in (1, views):
        raise ValueError(f"project: {label}: {lead} states for {views} "
                         "views")
    t, stride = rows(t, lead * n, width, label)
    return t, _Arg(t.data_ptr(), 4 * n * stride if lead > 1 else 0), stride


def _launches(names, args, ints, st: Setup):
    """The host arrays of each launch: (pointers, ints, floats) in
    names', INTS' and FLOATS' order, MAX_VIEWS views a launch, every
    pointer moved on to the launch's first view."""
    out = []
    for v0 in range(0, st.views, MAX_VIEWS):
        nv = min(MAX_VIEWS, st.views - v0)
        ptrs = tuple(args[k].ptr + v0 * args[k].view_bytes
                     if args[k].ptr else 0 for k in names)
        i = dict(ints, n=st.n, views=nv, tb_x=st.tb_x, tb_y=st.tb_y)
        floats = st.floats + tuple(x for vf in st.view_floats[v0:v0 + nv]
                                   for x in vf)
        out.append((ptrs, tuple(i.get(k, 0) for k in INTS), floats))
    return out


def _out_arg(t: torch.Tensor) -> _Arg:
    """A contiguous (V, N, ...) output's _Arg."""
    return _Arg(t.data_ptr(), t.element_size() * t[0].numel())


def _inputs(means, scales, quats, viewmat, projmat, st: Setup):
    """The arguments both entries take: the Gaussians' rows and the
    view's matrices. Returns (the tensors read, _Args, ints)."""
    keep, args, ints = [], {}, {}
    for name, t, width in (("means", means, 3), ("scales", scales, 3),
                           ("quats", quats, 4)):
        t, args[name], ints["s_" + name] = _state_arg(t, st.views, st.n,
                                                      width, name)
        ints["vs_" + name] = args[name].view_bytes // 4
        keep.append(t)
    for name, m in (("viewmat", viewmat), ("projmat", projmat)):
        args[name] = _Arg(m.data_ptr(), 64)
    return keep, args, ints


def forward_launches(means, scales, quats, viewmat, projmat, valid, opac,
                     outs, st: Setup):
    """The forward's launches (`_launches`) and the tensors they read.
    means, scales, quats: (1 or V, N, 3 | 3 | 4); valid (1 or V, N)
    bool or None; opac (1 or V, N[, 1]) or None; outs: OUTPUTS' tensors,
    contiguous (V, N, ...)."""
    views, n = st.views, st.n
    if n == 0:
        return [], []
    keep, args, ints = _inputs(means, scales, quats, viewmat, projmat, st)
    args["valid"] = args["opac"] = _Arg(0, 0)
    ints["s_opac"] = 1
    if valid is not None:
        lead = valid.numel() // n
        if lead not in (1, views) or valid.numel() != lead * n:
            raise ValueError(f"project: valid_mask: shape "
                             f"{tuple(valid.shape)} for {views} views of "
                             f"{n}")
        valid = valid.reshape(lead, n).to(torch.bool).contiguous()
        keep.append(valid)
        ints["vs_valid"] = n if lead > 1 else 0
        args["valid"] = _Arg(valid.data_ptr(), ints["vs_valid"])
    if opac is not None:
        opac, args["opac"], ints["s_opac"] = _state_arg(
            opac.detach(), views, n, 1, "opacities")
        keep.append(opac)
        ints["vs_opac"] = args["opac"].view_bytes // 4
    for name, t in outs.items():
        args[name] = _out_arg(t)
    return _launches(FWD_PTRS, args, ints, st), keep


def backward_launches(means, scales, quats, viewmat, projmat, grads, outs,
                      st: Setup):
    """The backward's launches and the tensors they read. grads: the
    gradient of each of GRADS' outputs, or None; outs: v_means,
    v_scales, v_quats, each a contiguous (V, N, 3 | 3 | 4) tensor or
    None where not wanted."""
    if st.n == 0:
        return [], []
    keep, args, ints = _inputs(means, scales, quats, viewmat, projmat, st)
    for name, width in GRADS.items():
        g = grads.get(name)
        if g is None:
            args["v_" + name] = _Arg(0, 0)
            continue
        g, stride = rows(g, st.views * st.n, width, f"{name} gradient")
        keep.append(g)
        args["v_" + name] = _Arg(g.data_ptr(), 4 * st.n * stride)
        ints["s_v_" + name] = stride
    for name in ("means", "scales", "quats"):
        t = outs.get(name)
        args["v_" + name] = _Arg(0, 0) if t is None else _out_arg(t)
    return _launches(BWD_PTRS, args, ints, st), keep


def _run(entry: str, launches) -> None:
    for ptrs, ints, floats in launches:
        p = (ctypes.c_void_p * len(ptrs))(*ptrs)
        i = (ctypes.c_int64 * len(ints))(*ints)
        f = (ctypes.c_float * len(floats))(*floats)
        _lib.launch(entry, *(ctypes.c_void_p(ctypes.addressof(x))
                             for x in (p, i, f)))


def run_forward(launches) -> None:
    """The forward's launches (`forward_launches`), counted as one."""
    with _lib.timed("project_fwd"):
        _run("osk_project_fwd", launches)
    run_forward.launches += 1


def run_backward(launches) -> None:
    """The backward's launches (`backward_launches`), counted as one."""
    with _lib.timed("project_bwd"):
        _run("osk_project_bwd", launches)
    run_backward.launches += 1


run_forward.launches = 0
run_backward.launches = 0


def _matrices(viewmat, projmat, views, dev):
    out = []
    for name, m in (("viewmat", viewmat), ("projmat", projmat)):
        if m.device != dev:
            raise ValueError(f"project: {name} on {m.device}, the "
                             f"Gaussians on {dev}")
        if tuple(m.shape) != (views, 4, 4):
            raise ValueError(f"project: {name}: expected ({views}, 4, 4), "
                             f"got {tuple(m.shape)}")
        if m.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"project: {name} requires grad; the kernel "
                             "gives the view's matrices no gradient")
        out.append(m.detach().to(torch.float32).contiguous())
    return out


class _Project(torch.autograd.Function):
    """OUTPUTS' tensors of V views; differentiable in means, scales and
    quats through the hand-derived backward."""

    @staticmethod
    def forward(ctx, means, scales, quats, viewmat, projmat, valid, opac,
                st):
        dev = means.device
        outs = {k: torch.empty((st.views, st.n) + tail, dtype=dt,
                               device=dev)
                for k, (tail, dt) in OUTPUTS.items()}
        launches, keep = forward_launches(means, scales, quats, viewmat,
                                          projmat, valid, opac, outs, st)
        run_forward(launches)
        del keep
        ctx.save_for_backward(means, scales, quats, viewmat, projmat)
        ctx.st = st
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*(outs[k] for k in OUTPUTS
                                      if k not in GRADS))
        return tuple(outs.values())

    @staticmethod
    @once_differentiable
    def backward(ctx, *grad_outs):
        means, scales, quats, viewmat, projmat = ctx.saved_tensors
        st = ctx.st
        grads = {k: g for k, g in zip(OUTPUTS, grad_outs) if k in GRADS}
        want = ctx.needs_input_grad[:3]
        if not any(want) or all(g is None for g in grads.values()):
            return (None,) * 8
        dev = means.device
        outs = {name: torch.empty((st.views, st.n, w), dtype=torch.float32,
                                  device=dev) if need else None
                for name, w, need in zip(("means", "scales", "quats"),
                                         (3, 3, 4), want)}
        launches, keep = backward_launches(means, scales, quats, viewmat,
                                           projmat, grads, outs, st)
        run_backward(launches)
        del keep
        res = []
        for t, g in zip((means, scales, quats), outs.values()):
            if g is not None and t.shape[0] != st.views:
                g = g.sum(0, keepdim=True)  # one state, every view's rows
            res.append(None if g is None else g.view(t.shape))
        return tuple(res) + (None,) * 5


def project(means, scales, glob_scale, quats, viewmat, projmat, fx, fy, cx,
            cy, img_height, img_width, clip_thresh,
            valid_mask: Optional[torch.Tensor],
            opacities: Optional[torch.Tensor], alpha_thresh, fov_width,
            fov_height, row_offset):
    """ops/projection.py::_project_views' contract on CUDA tensors (means,
    scales, quats (1 or V, N, ...); viewmat, projmat (V, 4, 4); fx, fy,
    cx, cy V values each): OUTPUTS' tensors in order, each (V, N, ...),
    the last the in-front mask. One forward launch, and one backward
    launch when a gradient reaches means, scales or quats."""
    dev = means.device
    if not means.is_cuda:
        raise ValueError(f"project: expected CUDA tensors, got {dev}")
    views, n = viewmat.shape[0], means.shape[-2]
    for name, t in (("scales", scales), ("quats", quats)):
        if t.device != dev:
            raise ValueError(f"project: {name} on {t.device}, means on "
                             f"{dev}")
    for name, t in (("valid_mask", valid_mask), ("opacities", opacities)):
        if t is not None and t.device != dev:
            raise ValueError(f"project: {name} on {t.device}, means on "
                             f"{dev}")
    st = setup(views, n, glob_scale, fx, fy, cx, cy, img_height, img_width,
               clip_thresh, alpha_thresh, fov_width, fov_height, row_offset)
    vm, pm = _matrices(viewmat, projmat, views, dev)
    return _Project.apply(means, scales.to(torch.float32),
                          quats.to(torch.float32), vm, pm, valid_mask,
                          opacities, st)


def kernel_info() -> dict:
    """The block, the views a launch and what the CUDA runtime reports of
    both kernels' builds (registers, shared memory a CTA, resident CTAs
    an SM)."""
    return _lib.kernel_info(
        "osk_project_info",
        ("threads", "max_views", "fwd_registers", "fwd_smem_bytes",
         "fwd_ctas_per_sm", "bwd_registers", "bwd_smem_bytes",
         "bwd_ctas_per_sm"))
