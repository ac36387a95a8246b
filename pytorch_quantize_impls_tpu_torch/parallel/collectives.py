"""The collectives of the sharded train and eval steps, with their
gradients, and the mesh context those steps set.

The JAX package's sharded step is its single-device step over logical
global arrays; GSPMD places the collectives (``pytorch_quantize_impls_tpu/
parallel/sharding.py:15-17``). Here every rank runs only its rows of the
batch and its columns of each sharded kernel, so every reduction of the
step that spans the batch or a whole kernel is made global by hand, and
its backward with it:

* tensor parallelism is Megatron's column-parallel layer.
  :class:`CopyToModel` (``f``) is the identity forward and an all-reduce
  (sum) of the input's cotangent over the model group backward: the input
  is replicated over the group and every rank's block of outputs adds to
  its gradient. :class:`GatherFromModel` (``g``) all-gathers the output
  blocks over the model group forward, in rank order along one axis, and
  keeps this rank's block of the cotangent backward: what follows it is
  replicated, so its cotangent is the same on every rank.
* :class:`GroupMean` averages equal-sized local means over a group. Its
  backward all-reduces the cotangent too where every rank uses the mean on
  its own part (BatchNorm's moments over the data group, a column shard's
  ``E|W|`` over the model group), and only scales it where the mean feeds
  the replicated loss (the elastic penalty over the model group).
* :class:`GroupMax` is the maximum over a group; its gradient goes to the
  tied maxima of every rank in equal parts, as ``jnp.max``'s and
  ``torch.max``'s do over one tensor (DoReFa's ``max|tanh W|``).
* :func:`group_reduce` is DoReFa's statistic of a whole tensor from a
  rank's block, by those two: a column shard's kernel (over the model
  group), or an expert-parallel ``QuantMoE``'s block of experts
  (``parallel.shard_experts``).

In a group of one rank every collective copies and every count is 1: the
sharded step's numbers are the unsharded step's bit for bit.

:class:`MeshContext` is what the modules read while a sharded step runs
(``nn.base.sharded_step``): the mesh's two groups, this rank's place on
them, the layers whose kernel is a column shard, and the reductions and
draws above as methods. ``COUNTS`` counts every collective launched, by
name.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence

import torch
import torch.distributed as dist
from torch import nn

from pytorch_quantize_impls_tpu_torch.ops.binary import BlockDraw
from pytorch_quantize_impls_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size

#: collectives launched, by name (``all_reduce``, ``all_gather``)
COUNTS: Counter = Counter()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` in place on a contiguous ``t``, counted; returns ``t``."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, joined along ``dim`` in rank order
    (JAX's tiled ``all_gather``), counted."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    flat = t.new_empty(n * t.numel())
    COUNTS["all_gather"] += 1
    dist.all_gather_into_tensor(flat, t.reshape(-1), group=group)
    return torch.cat(flat.view(n, *t.shape).unbind(0), dim=dim)


class CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward; backward, the sum of every model
    rank's cotangent of the replicated input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class GatherFromModel(torch.autograd.Function):
    """Megatron's ``g``: every model rank's block joined along ``dim``
    forward; this rank's block of the cotangent backward."""

    @staticmethod
    def forward(ctx, y, group, dim):
        ctx.dim = dim % y.dim()
        ctx.rank, ctx.size = dist.get_rank(group), y.shape[ctx.dim]
        return all_gather(y, group, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


class GroupMean(torch.autograd.Function):
    """The mean over ``group`` of each rank's ``t`` (a local mean over
    equal-sized parts): the sum by all-reduce, over the rank count. The
    backward is ``sum over ranks of the cotangent / n`` where each rank uses
    the mean on its own part, ``cotangent / n`` where ``replicated`` (the
    mean feeds a computation that every rank of the group repeats)."""

    @staticmethod
    def forward(ctx, t, group, replicated):
        ctx.group, ctx.replicated = group, replicated
        ctx.n = dist.get_world_size(group)
        return all_reduce(t.detach().contiguous().clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return g / ctx.n, None, None
        return all_reduce(g.contiguous().clone(), ctx.group) / ctx.n, None, None


class GroupMax(torch.autograd.Function):
    """The maximum over ``group`` of each rank's 0-d ``m``, the maximum of
    its part, which holds ``k`` entries equal to ``m``. Backward, the sum
    of the ranks' cotangents goes to the ranks that hold the maximum, each
    its share ``k / (all tied entries)``; ``torch.max`` then splits a
    rank's share over its ``k`` entries."""

    @staticmethod
    def forward(ctx, m, k, group):
        s = all_reduce(m.detach().clone(), group, dist.ReduceOp.MAX)
        ctx.group = group
        ctx.save_for_backward(m.detach() == s, k)
        return s

    @staticmethod
    def backward(ctx, g):
        tied, k = ctx.saved_tensors
        mine = torch.where(tied, k.to(g.dtype), torch.zeros_like(g))
        total = all_reduce(torch.stack([g, mine]), ctx.group)
        return torch.where(tied, total[0] * (mine / total[1]), torch.zeros_like(g)), None, None


def group_reduce(group):
    """``reduce(kind, t)`` for ``ops.dorefa_weight(reduce=)``: the whole
    tensor's statistic from this rank's block of it, over ``group`` with its
    gradient. ``"mean"`` is the mean of the ranks' means (equal blocks),
    ``"max"`` the maximum of the ranks' entries ``t``; each rank then
    quantizes its block by it."""

    def reduce(kind: str, t: torch.Tensor) -> torch.Tensor:
        if kind == "mean":
            return GroupMean.apply(t, group, False)
        if kind == "max":
            m = t.max()
            k = (t.detach() == m.detach()).sum().to(t.dtype)
            return GroupMax.apply(m, k, group)
        raise ValueError(f"unknown statistic {kind!r}")

    return reduce


def block_draw(generator: torch.Generator, t: torch.Tensor, n: int, i: int) -> BlockDraw:
    """The draw of the whole tensor that ``t`` is block ``i`` of, ``n``
    equal blocks along axis 0: the uniforms the unsharded tensor gets
    there."""
    rows = t.shape[0]
    return BlockDraw(generator, (n * rows, *t.shape[1:]), 0, i * rows)


class MeshContext:
    """A sharded step's mesh as its modules see it (module docstring).
    ``columns``: the layers (``nn.base`` quant layers) whose ``weight`` is
    this rank's block of out-features over ``"model"``."""

    def __init__(self, mesh, columns: Iterable[nn.Module] = ()):
        self.data_group = mesh.get_group(DATA_AXIS)
        self.model_group = mesh.get_group(MODEL_AXIS)
        self.data_size, self.data_rank = axis_size(mesh, DATA_AXIS), mesh.get_local_rank(DATA_AXIS)
        self.model_size = axis_size(mesh, MODEL_AXIS)
        self.model_rank = mesh.get_local_rank(MODEL_AXIS)
        self.columns = frozenset(columns)

    # --- the data axis: this rank's rows of the batch -----------------------

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The batch's mean from this rank's mean of its rows, with a gradient."""
        return GroupMean.apply(t, self.data_group, False)

    def data_max(self, m: torch.Tensor) -> torch.Tensor:
        """The batch's maximum from this rank's (no gradient)."""
        return all_reduce(m.detach().contiguous().clone(), self.data_group, dist.ReduceOp.MAX)

    def batch_draw(self, generator: torch.Generator, x: torch.Tensor) -> BlockDraw:
        """The draw of the whole batch's tensor, this rank's rows of it."""
        return block_draw(generator, x, self.data_size, self.data_rank)

    @torch.no_grad()
    def data_means(self, *values: torch.Tensor) -> Sequence[torch.Tensor]:
        """Batch means of 0-d per-rank means (the metrics), in one all-reduce."""
        out = all_reduce(torch.stack([v.to(torch.float32) for v in values]), self.data_group)
        return (out / self.data_size).unbind(0)

    @torch.no_grad()
    def average_gradients(self, params: Iterable[nn.Parameter]) -> None:
        """Every gradient := its mean over the data group: one all-reduce of
        the gradients laid end to end, in parameter order, per dtype."""
        by_dtype = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.data_group)
            flat.div_(self.data_size)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    # --- the model axis: a column-sharded layer -----------------------------

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToModel.apply(x, self.model_group)

    def gather(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        return GatherFromModel.apply(y, self.model_group, dim)

    def penalty_mean(self, t: torch.Tensor) -> torch.Tensor:
        """A whole kernel's penalty (a mean over its entries) from a column
        shard's; the loss it enters is the same on every model rank."""
        return GroupMean.apply(t, self.model_group, True)

    def reduce(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        """The whole kernel's statistic from a column shard's:
        :func:`group_reduce` over the model group."""
        return group_reduce(self.model_group)(kind, t)

    def weight_draw(self, generator: torch.Generator, w: torch.Tensor) -> BlockDraw:
        """The draw of the whole kernel, this rank's block of out-features."""
        return block_draw(generator, w, self.model_size, self.model_rank)

