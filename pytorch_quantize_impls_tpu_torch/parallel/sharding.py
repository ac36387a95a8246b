"""Placement rules on the (data, model) mesh: the serving half.

Counterpart of ``pytorch_quantize_impls_tpu/parallel/sharding.py:32-71``.
A ``PartitionSpec`` becomes a tuple of ``torch.distributed.tensor``
placements, one per mesh dimension (``(Replicate(), Shard(0))`` is JAX's
``P(None, "model")`` on a tensor whose out-features are dimension 0).
:func:`param_shardings` places every entry of a module's state by a rule on
the flax path that ``utils.bridge`` gives it, and :func:`local_shard` cuts a
rank's block of a tensor by its placements. Two rules:

* JAX's ``_spec_for_path`` (the default): a ``kernel`` of rank >= 2 on its
  out-features over ``"model"`` (the flax kernel's last axis, which is
  dimension 0 of a port ``weight`` stored ``(out, in)`` or OIHW, and the
  last dimension of a parameter kept in the flax layout, the MoE's
  ``wi_kernel``/``wo_kernel``), everything else replicated;
* expert parallelism (``nn.moe.expert_sharding_rules``): the expert stacks
  on their expert axis over ``"model"``, which :func:`shard_experts`
  applies to a model's ``QuantMoE`` blocks.

The packed dense records of a served model are cut by
``infer.shard_packed``; the batch is scattered by the engines. The sharded
train state and steps, and the batch helpers they take (``replicate``,
``batch_sharding``, ``shard_batch``), are ROADMAP queue 1 item 6 (b2).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from pytorch_quantize_impls_tpu_torch.nn.moe import QuantMoE, expert_sharding_rules
from pytorch_quantize_impls_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
from pytorch_quantize_impls_tpu_torch.utils.bridge import flax_paths

Placements = Tuple[Placement, ...]
# (flax collection, flax path, ndim) -> the port dimension sharded over "model", or None
Rule = Callable[[str, Tuple[str, ...], int], Optional[int]]


def _placements(mesh: DeviceMesh, **dims) -> Placements:
    """One placement per mesh dimension: ``Shard(dims[name])`` where the
    dimension's name is given, else ``Replicate()``."""
    return tuple(Shard(dims[name]) if name in dims else Replicate()
                 for name in mesh.mesh_dim_names)


def tp_rule(collection: str, path: Tuple[str, ...], ndim: int) -> Optional[int]:
    """JAX's ``_spec_for_path``: the port dimension of a flax ``kernel``'s
    last axis, or None where the entry is replicated."""
    if collection != "params" or "kernel" not in path[-1] or ndim < 2:
        return None
    return 0 if path[-1] == "kernel" else ndim - 1


def ep_rule(collection: str, path: Tuple[str, ...], ndim: int) -> Optional[int]:
    """Expert parallelism: an expert stack's leading (expert) axis."""
    return 0 if collection == "params" and expert_sharding_rules("/".join(path)) else None


def param_shardings(module: nn.Module, mesh: DeviceMesh, rule: Rule = tp_rule
                    ) -> Dict[str, Placements]:
    """State-dict key -> placements for every entry of ``module``'s state:
    the dimension ``rule`` names over ``"model"``, else replicated."""
    sd = module.state_dict()
    out = {}
    for key, (collection, path) in flax_paths(module).items():
        dim = rule(collection, path, sd[key].ndim)
        out[key] = _placements(mesh) if dim is None else _placements(mesh, **{MODEL_AXIS: dim})
    return out


def local_shard(tensor: torch.Tensor, mesh: DeviceMesh, placements: Sequence[Placement]
                ) -> torch.Tensor:
    """This rank's block of the whole ``tensor`` under ``placements``, as a
    contiguous copy: ``Shard(d)`` on a mesh dimension of n ranks keeps
    block ``i`` of n equal blocks of axis d, i this rank's index there. An
    axis that does not divide raises ``ValueError``."""
    out = tensor
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            n, i = axis_size(mesh, name), mesh.get_local_rank(name)
            size = out.shape[p.dim]
            if size % n:
                raise ValueError(f"axis {p.dim} of size {size} does not divide over the "
                                 f"{n} ranks of {name!r}")
            out = out.narrow(p.dim, i * (size // n), size // n)
    return out.contiguous() if out is not tensor else out


def shard_experts(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Place every ``QuantMoE`` of ``model`` on ``mesh``, in place: each
    keeps this rank's block of its expert stacks (:func:`ep_rule`,
    ``Shard(0)`` over ``"model"``) and routes its tokens, this data rank's
    block, over the data group (``QuantMoE.expert_parallel``). Returns
    ``model``."""
    placements = param_shardings(model, mesh, ep_rule)
    for prefix, m in model.named_modules():
        if not isinstance(m, QuantMoE):
            continue
        stacks = {}
        for name, p in m.named_parameters(recurse=False):
            where = placements[f"{prefix}.{name}" if prefix else name]
            if any(isinstance(pl, Shard) for pl in where):
                stacks[name] = local_shard(p.detach(), mesh, where)
        m.expert_parallel(stacks, mesh.get_group(DATA_AXIS), mesh.get_group(MODEL_AXIS))
    return model
