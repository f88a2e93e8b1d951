"""A (data, model) grid of ranks and the collectives over its two axes.

Counterpart of opensplat_tpu/parallel/mesh.py. The JAX package runs one
program over a device Mesh (shard_map); the port runs one process per
rank (torch.distributed), as the JAX package's multi-host recipe does
(parallel/distributed.py): every rank runs the same trainer with the
same seeds, so all agree on each step's batch.

Axes, as in the JAX package:
  data  — camera data-parallelism: each rank renders other cameras of
          the same scene; parameter gradients are summed over `data`;
  model — Gaussian sharding: the capacity axis is split over `model`.

The collectives are built on all_reduce and broadcast alone: gloo
supports only those two on CUDA tensors, so one code path serves gloo on
the CPU, gloo on a card that several ranks share, and NCCL. An
all-gather is an all_reduce of a zero buffer into which each rank wrote
its own rows (exact: x + 0 = x); a reduce-scatter is an all_reduce
followed by the rank's own rows. All ranks receive the same bits from an
all_reduce, so results do not depend on which rank finishes first.
Outside a process group (one process) a 1x1 mesh's collectives are the
identity.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..models.gaussians import TrainState, state_map


class Mesh:
    """This rank's place in a (data, model) grid of ranks and a process
    group for each axis it belongs to. `shape` and `index` are dicts
    keyed by axis name; `member` is False on a rank outside the grid."""

    def __init__(self, n_data: int, n_model: int, ranks: Sequence[int],
                 groups: Optional[dict], mesh_rank: Optional[int]):
        self.shape = {"data": n_data, "model": n_model}
        self.ranks = list(ranks)  # world ranks, host-major
        self.member = mesh_rank is not None
        r = mesh_rank or 0
        self.index = {"data": r // n_model, "model": r % n_model}
        # axis name -> process group; None without a process group
        self._groups = groups

    def _reduce(self, x: torch.Tensor, axis: str, op) -> torch.Tensor:
        y = x.clone(memory_format=torch.contiguous_format)
        if self._groups is not None:
            dist.all_reduce(y, op=op, group=self._groups[axis])
        return y

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of x over the ranks along `axis` (a new tensor)."""
        return self._reduce(x, axis, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, dist.ReduceOp.MAX)

    def psum_many(self, tensors: List[torch.Tensor],
                  axis: str) -> List[torch.Tensor]:
        """psum of several float32 tensors in one all_reduce."""
        flat = self.psum(torch.cat([t.reshape(-1).to(torch.float32)
                                    for t in tensors]), axis)
        return [f.view(t.shape) for f, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' x concatenated along dim 0 in axis order (every
        rank's x must have the same shape). Exact for every dtype."""
        n = self.shape[axis]
        if n == 1 and self._groups is None:
            return x.clone()
        src = x.to(torch.uint8) if x.dtype == torch.bool else x
        rows = src.shape[0]
        out = src.new_zeros((n * rows,) + tuple(src.shape[1:]))
        i = self.index[axis]
        out[i * rows:(i + 1) * rows] = src
        out = self.psum(out, axis)
        return out.bool() if x.dtype == torch.bool else out

    def own_rows(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """This rank's block of x's dim 0, split evenly along `axis`."""
        rows = x.shape[0] // self.shape[axis]
        i = self.index[axis]
        return x[i * rows:(i + 1) * rows]

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Mesh rank 0's x on every rank of the mesh (a new tensor)."""
        y = (x.to(torch.uint8) if x.dtype == torch.bool else x).clone(
            memory_format=torch.contiguous_format)
        if self._groups is not None:
            dist.broadcast(y, src=self.ranks[0], group=self._groups["all"])
        return y.bool() if x.dtype == torch.bool else y


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A (data, model) grid over `ranks` (default: every rank of the
    process group), host-major: ranks[i] has data index i // n_model and
    model index i % n_model, so a data row's ranks are neighbours.

    Every rank of the process group must call this, in the same order
    and with the same arguments: it creates one process group per data
    row (the `model` axis), one per model column (the `data` axis) and
    one over the grid, and torch.distributed.new_group must be called by
    every rank alike. A rank outside `ranks` gets a Mesh with
    member False. Without a process group the only mesh is 1x1."""
    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1 or list(ranks or [0]) != [0]:
            raise ValueError(f"make_mesh: a {n_data} x {n_model} mesh needs "
                             "a process group (initialize_from_env)")
        return Mesh(1, 1, [0], None, 0)
    world, me = dist.get_world_size(), dist.get_rank()
    ranks = list(range(world) if ranks is None else ranks)
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data * n_model != len(ranks) or n_data < 1:
        raise ValueError(f"make_mesh: {n_data} x {n_model} does not cover "
                         f"{len(ranks)} ranks")
    if any(r < 0 or r >= world for r in ranks):
        raise ValueError(f"make_mesh: ranks {ranks} outside world {world}")
    groups: Dict[str, object] = {}
    for d in range(n_data):
        g = dist.new_group(ranks[d * n_model:(d + 1) * n_model])
        if me in ranks[d * n_model:(d + 1) * n_model]:
            groups["model"] = g
    for m in range(n_model):
        col = ranks[m::n_model]
        g = dist.new_group(col)
        if me in col:
            groups["data"] = g
    g = dist.new_group(ranks)
    mesh_rank = ranks.index(me) if me in ranks else None
    if mesh_rank is not None:
        groups["all"] = g
    return Mesh(n_data, n_model, ranks, groups, mesh_rank)


def replicate(mesh: Mesh, state: TrainState) -> TrainState:
    """Mesh rank 0's state on every rank (new tensors): the start of a
    replicated state, equal on every rank to the bit."""
    return state_map(mesh.broadcast, state)


def shard_params(mesh: Mesh, state: TrainState,
                 axis: str = "model") -> TrainState:
    """This rank's block of every (C, ...) leaf along the capacity axis
    (clones): params, alive, Adam moments and stats. C must divide
    evenly over `axis`."""
    c, n = state.alive.shape[0], mesh.shape[axis]
    if c % n:
        raise ValueError(f"shard_params: capacity {c} is not a multiple of "
                         f"{n} shards")
    return state_map(lambda x: mesh.own_rows(x, axis).clone(), state,
                     capacity_only=True)


class _GatherRows(torch.autograd.Function):
    """all_gather whose rows feed a different consumer on every rank: the
    backward sums every rank's gradient and hands each owner its rows (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.own_rows(ctx.mesh.psum(g, ctx.axis), ctx.axis), \
            None, None


class _GatherReplicated(torch.autograd.Function):
    """all_gather whose result feeds a consumer that every rank computes
    alike (the whole image's loss): each rank's gradient already holds
    the whole consumer's, so the backward takes the rank's own rows and
    sums nothing."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.own_rows(g, ctx.axis).clone(), None, None


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Differentiable all_gather; backward = reduce-scatter."""
    return _GatherRows.apply(x, mesh, axis)


def all_gather_replicated(x: torch.Tensor, mesh: Mesh,
                          axis: str) -> torch.Tensor:
    """Differentiable all_gather for a replicated consumer; backward =
    the rank's own rows of the gradient."""
    return _GatherReplicated.apply(x, mesh, axis)
