"""Scene save/load: Inria-compatible .ply, .splat, debug .ply, and a
full-training-state checkpoint.

Counterpart of opensplat_tpu/io/scene_io.py. The writers gather the alive
rows to the host and write the JAX package's bytes exactly:
  - save dispatch by extension ... model.cpp:496-503
  - savePly (Inria layout, step embedded in the comment line,
    f_rest transposed (N,B-1,3)->(N,3*(B-1)), zero normals,
    --keep-crs un-normalization) ... model.cpp:505-562
  - saveSplat (quantized uint8 rgb/opacity/quat, importance-sorted by
    sum(exp(scales))/inv_sigmoid_denominator) ... model.cpp:564-598
  - saveDebugPly ... model.cpp:600-627
  - loadPly (strict header check, step parsed from the comment,
    fresh optimizer moments on resume) ... model.cpp:629-778

The checkpoint is an .npz under the JAX package's key names, plus `key`
= uint32 [0, seed] (the raw value of jax.random.PRNGKey(seed)), so each
package reads the other's checkpoints. The port derives refine's split
noise from (seed, step) (train.refine_generator), so the state, the step
and the sampler's draws are all a resume needs.
"""
from __future__ import annotations

import io as _io
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.gaussians import (PARAM_NAMES, DensifyStats, GaussianParams,
                                TrainState, round_capacity, zero_stats)
from ..ops.sh import SH_C0
from ..optim.adam import AdamState, adam_init

_COMMENT_PATTERN = "comment Generated by opensplat at iteration "


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _gather_alive(params: GaussianParams, alive) -> dict:
    """Compact alive rows to host numpy arrays."""
    idx = np.flatnonzero(_host(alive))
    d = {k: _host(v)[idx] for k, v in params.as_dict().items()}
    d["opacities"] = d["opacities"].reshape(-1, 1)
    return d


def save_scene(
    params: GaussianParams,
    alive,
    filename: str,
    step: int,
    keep_crs: bool = False,
    scale: float = 1.0,
    translation=np.zeros(3, np.float32),
):
    """Extension dispatch (model.cpp:496-503)."""
    if os.path.splitext(filename)[1] == ".splat":
        save_splat(params, alive, filename, keep_crs, scale, translation)
    else:
        save_ply(params, alive, filename, step, keep_crs, scale, translation)


def save_ply(
    params: GaussianParams,
    alive,
    filename: str,
    step: int,
    keep_crs: bool = False,
    scale: float = 1.0,
    translation=np.zeros(3, np.float32),
):
    """Inria-compatible binary PLY (model.cpp:505-562)."""
    d = _gather_alive(params, alive)
    n = d["means"].shape[0]
    n_rest = d["features_rest"].shape[1] * 3  # (B-1)*3 floats per point

    means = d["means"]
    scales = d["scales"]
    if keep_crs:  # un-normalize back to the input CRS (model.cpp:545,548)
        means = means / np.float32(scale) + np.asarray(translation, np.float32)
        scales = np.log(np.exp(scales) / np.float32(scale))
    # Inria layout: f_rest stored channel-major (N, 3*(B-1)) via
    # (N, B-1, 3) -> (N, 3, B-1) transpose (model.cpp:525)
    f_rest = np.ascontiguousarray(
        d["features_rest"].transpose(0, 2, 1)
    ).reshape(n, -1)

    header = [
        b"ply",
        b"format binary_little_endian 1.0",
        (_COMMENT_PATTERN + str(step)).encode(),
        b"element vertex " + str(n).encode(),
        b"property float x",
        b"property float y",
        b"property float z",
        b"property float nx",
        b"property float ny",
        b"property float nz",
    ]
    header += [b"property float f_dc_%d" % i for i in range(3)]
    header += [b"property float f_rest_%d" % i for i in range(n_rest)]
    header += [
        b"property float opacity",
        b"property float scale_0",
        b"property float scale_1",
        b"property float scale_2",
        b"property float rot_0",
        b"property float rot_1",
        b"property float rot_2",
        b"property float rot_3",
        b"end_header",
    ]

    body = np.concatenate(
        [
            means.astype("<f4"),
            np.zeros((n, 3), "<f4"),  # normals (model.cpp:543)
            d["features_dc"].astype("<f4"),
            f_rest.astype("<f4"),
            d["opacities"].astype("<f4"),
            scales.astype("<f4"),
            d["quats"].astype("<f4"),
        ],
        axis=1,
    )
    with open(filename, "wb") as f:
        f.write(b"\n".join(header) + b"\n")
        f.write(np.ascontiguousarray(body).tobytes())


def save_splat(
    params: GaussianParams,
    alive,
    filename: str,
    keep_crs: bool = False,
    scale: float = 1.0,
    translation=np.zeros(3, np.float32),
):
    """.splat format: f32 means+scales, u8 rgba + quat, importance-sorted
    (model.cpp:564-598)."""
    d = _gather_alive(params, alive)
    means = d["means"]
    scales = np.exp(d["scales"])
    if keep_crs:
        means = means / np.float32(scale) + np.asarray(translation, np.float32)
        scales = scales / np.float32(scale)
    rgbs = np.clip(d["features_dc"] * SH_C0 + 0.5, 0.0, 1.0)
    rgbs = (rgbs * 255.0).astype(np.uint8)
    inv_sigmoid_denom = 1.0 + np.exp(-d["opacities"][:, 0])
    opac_u8 = np.clip((1.0 / inv_sigmoid_denom) * 255.0, 0.0,
                      255.0).astype(np.uint8)
    quats_u8 = np.clip(d["quats"] * 128.0 + 128.0, 0.0, 255.0).astype(np.uint8)

    # big-and-opaque first (model.cpp:583-592)
    order = np.argsort(-(scales.sum(axis=1) / inv_sigmoid_denom), kind="stable")

    buf = _io.BytesIO()
    rec = np.zeros(
        len(order),
        dtype=np.dtype(
            [("pos", "<f4", 3), ("scale", "<f4", 3), ("rgba", "u1", 4),
             ("quat", "u1", 4)]
        ),
    )
    rec["pos"] = means[order]
    rec["scale"] = scales[order]
    rec["rgba"][:, :3] = rgbs[order]
    rec["rgba"][:, 3] = opac_u8[order]
    rec["quat"] = quats_u8[order]
    buf.write(rec.tobytes())
    with open(filename, "wb") as f:
        f.write(buf.getvalue())


def save_debug_ply(
    params: GaussianParams,
    alive,
    filename: str,
    step: int,
    keep_crs: bool = False,
    scale: float = 1.0,
    translation=np.zeros(3, np.float32),
):
    """Plain xyz+rgb PLY for inspection (model.cpp:600-627)."""
    d = _gather_alive(params, alive)
    n = d["means"].shape[0]
    means = d["means"]
    if keep_crs:
        means = means / np.float32(scale) + np.asarray(translation, np.float32)
    rgbs = np.clip(d["features_dc"] * SH_C0 + 0.5, 0.0, 1.0)
    rgbs = (rgbs * 255.0).astype(np.uint8)
    header = [
        b"ply",
        b"format binary_little_endian 1.0",
        (_COMMENT_PATTERN + str(step)).encode(),
        b"element vertex " + str(n).encode(),
        b"property float x",
        b"property float y",
        b"property float z",
        b"property uchar red",
        b"property uchar green",
        b"property uchar blue",
        b"end_header",
    ]
    rec = np.zeros(n, dtype=np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]))
    rec["xyz"] = means
    rec["rgb"] = rgbs
    with open(filename, "wb") as f:
        f.write(b"\n".join(header) + b"\n")
        f.write(rec.tobytes())


def load_ply(
    filename: str,
    keep_crs: bool = False,
    scale: float = 1.0,
    translation=np.zeros(3, np.float32),
    capacity: Optional[int] = None,
    capacity_mult: float = 1.5,
    capacity_round: int = 4096,
    device="cuda",
) -> Tuple[TrainState, int]:
    """Resume from an opensplat-style PLY (model.cpp:629-778).

    Returns (TrainState on `device` with fresh Adam moments — matching
    the reference, which never checkpoints optimizer state — and the
    embedded step)."""
    dev = resolve_device(device)
    with open(filename, "rb") as f:
        if f.readline().strip() != b"ply":
            raise RuntimeError("Invalid PLY file")
        if f.readline().strip() != b"format binary_little_endian 1.0":
            raise RuntimeError("Invalid PLY file")
        comment = f.readline().decode("ascii", "replace").strip()
        m = re.match(re.escape(_COMMENT_PATTERN.strip()) + r" ?(\d+)", comment)
        if m is None:
            if comment.startswith("comment Generated by opensplat"):
                raise RuntimeError(
                    "PLY file does not contain iteration count metadata"
                )
            raise RuntimeError("Invalid PLY file")
        step = int(m.group(1))
        el = f.readline().decode().strip()
        if not el.startswith("element vertex "):
            raise RuntimeError("Invalid PLY file")
        n = int(el[len("element vertex "):])

        props = []
        while True:
            line = f.readline().decode().strip()
            if line == "end_header":
                break
            props.append(line)
        for req in ("property float x", "property float y", "property float z",
                    "property float nx", "property float ny",
                    "property float nz"):
            if req not in props:
                raise RuntimeError(
                    "PLY file's header does not contain required "
                    f"property: {req}")
        n_dc = sum(1 for p in props if p.startswith("property float f_dc_"))
        n_rest = sum(1 for p in props
                     if p.startswith("property float f_rest_"))
        if n_rest % 3 != 0:
            raise RuntimeError("f_rest property count must be divisible by 3")

        floats_per_point = 14 + n_dc + n_rest
        data = np.frombuffer(
            f.read(4 * floats_per_point * n), "<f4"
        ).reshape(n, floats_per_point)

    o = 0
    means = data[:, o:o + 3].copy(); o += 3
    o += 3  # normals, discarded
    f_dc = data[:, o:o + n_dc].copy(); o += n_dc
    f_rest = data[:, o:o + n_rest].copy(); o += n_rest
    opac = data[:, o:o + 1].copy(); o += 1
    scales = data[:, o:o + 3].copy(); o += 3
    quats = data[:, o:o + 4].copy(); o += 4

    # channel-major (N, 3, B-1) back to (N, B-1, 3) (model.cpp:758)
    f_rest = f_rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    if keep_crs:  # model.cpp:748-751
        means = (means - np.asarray(translation, np.float32)) * np.float32(scale)
        scales = np.log(np.float32(scale) * np.exp(scales))

    if capacity is None:
        capacity = round_capacity(int(n * capacity_mult), capacity_round)
    if capacity < n:
        raise RuntimeError(f"capacity {capacity} < loaded point count {n}")
    c = capacity

    def pad(x):
        out = np.zeros((c,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    params = GaussianParams(means=pad(means), scales=pad(scales),
                            quats=pad(quats), features_dc=pad(f_dc),
                            features_rest=pad(f_rest), opacities=pad(opac))
    params.quats[n:, 0] = 1.0
    alive = torch.zeros((c,), dtype=torch.bool, device=dev)
    alive[:n] = True
    state = TrainState(
        params=params,
        alive=alive,
        opt=adam_init(params.as_dict()),  # fresh moments, like the reference
        stats=zero_stats(c, dev),
    )
    return state, step


def save_checkpoint(state: TrainState, step: int, filename: str,
                    sampler_draws: int = -1, seed: int = 42):
    """Full-TrainState checkpoint (params, alive, Adam moments and count,
    densify stats) with the step and the camera sampler's position
    (-1 = not recorded), under the JAX package's key names; `key` holds
    PRNGKey(seed)'s raw value for the JAX package's reader."""
    arrays = {
        "step": np.asarray(step, np.int64),
        "sampler_draws": np.asarray(sampler_draws, np.int64),
        "alive": _host(state.alive),
        "key": np.asarray([0, seed & 0xFFFFFFFF], np.uint32),
        "opt_count": np.asarray(state.opt.count, np.int32),
        "stats_xys_grad_norm": _host(state.stats.xys_grad_norm),
        "stats_vis_counts": _host(state.stats.vis_counts),
        "stats_max_2d_size": _host(state.stats.max_2d_size),
        "stats_initialized": _host(state.stats.initialized),
    }
    for name in PARAM_NAMES:
        arrays[f"p_{name}"] = _host(getattr(state.params, name))
        arrays[f"mu_{name}"] = _host(state.opt.mu[name])
        arrays[f"nu_{name}"] = _host(state.opt.nu[name])
    tmp = filename + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, filename)


def load_checkpoint(filename: str, device="cuda") -> Tuple[TrainState, int,
                                                          int]:
    """(state on `device`, step, sampler_draws); sampler_draws is -1 for
    checkpoints written without it. Reads the JAX package's checkpoints
    too (its `key` is not needed: see the module docstring)."""
    dev = resolve_device(device)
    with np.load(filename) as z:
        def t(name):
            return torch.from_numpy(np.array(z[name])).to(dev)

        def tree(prefix):
            return {name: t(f"{prefix}_{name}") for name in PARAM_NAMES}

        state = TrainState(
            params=GaussianParams(**tree("p")),
            alive=t("alive"),
            opt=AdamState(mu=tree("mu"), nu=tree("nu"),
                          count=int(z["opt_count"])),
            stats=DensifyStats(
                xys_grad_norm=t("stats_xys_grad_norm"),
                vis_counts=t("stats_vis_counts"),
                max_2d_size=t("stats_max_2d_size"),
                initialized=t("stats_initialized"),
            ),
        )
        step = int(z["step"])
        draws = int(z["sampler_draws"]) if "sampler_draws" in z else -1
    return state, step, draws
