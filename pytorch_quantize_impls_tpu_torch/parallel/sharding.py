"""Placement rules on the (data, model) mesh, and the sharded train and
eval steps.

Counterpart of ``pytorch_quantize_impls_tpu/parallel/sharding.py``.
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
``infer.shard_packed``; the engines scatter their batches themselves.

Training (JAX ``sharding.py:52-98``): :func:`shard_train_state` keeps this
rank's block of every kernel, and of its Adam moments, in place of the
whole; :func:`shard_batch` gives a data rank its rows;
:func:`make_sharded_train_step` and :func:`make_sharded_eval_step` run the
local step's forward and loss (``train.steps.make_compute_loss``) under the
mesh's context (``parallel.collectives.MeshContext``): every column-sharded
layer in Megatron's column-parallel order, BatchNorm's and the quantizers'
statistics over their groups, the draws of the whole tensor cut to the
rank's block, every gradient averaged over the data group after the
backward (one all-reduce in parameter order; no DistributedDataParallel,
whose buckets would hide the order), then the optimizer and the clamp, as
the local step. The metrics are the global batch's. :func:`unshard_params`
gathers the whole state back (checkpoints, export). Left for ROADMAP queue 1
item 6 (b3): expert parallelism under autograd, the 8-bit Adam under a
model axis > 1 (a column shard's blocks of 256 are not the whole tensor's).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from pytorch_quantize_impls_tpu_torch.nn.base import _QuantLayer, sharded_step
from pytorch_quantize_impls_tpu_torch.nn.moe import QuantMoE, expert_sharding_rules
from pytorch_quantize_impls_tpu_torch.parallel.collectives import (
    MeshContext,
    all_gather,
    group_reduce,
)
from pytorch_quantize_impls_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
from pytorch_quantize_impls_tpu_torch.train.quantized_optim import QuantizedAdam
from pytorch_quantize_impls_tpu_torch.train.steps import (
    ElasticWeight,
    _on_device,
    cross_entropy,
    fp32_cudnn,
    make_compute_loss,
)
from pytorch_quantize_impls_tpu_torch.utils.bridge import flax_paths

Placements = Tuple[Placement, ...]
# (flax collection, flax path, ndim) -> the port dimension sharded over "model", or None
Rule = Callable[[str, Tuple[str, ...], int], Optional[int]]


def _placements(mesh: DeviceMesh, **dims) -> Placements:
    """One placement per mesh dimension: ``Shard(dims[name])`` where the
    dimension's name is given, else ``Replicate()``."""
    return tuple(Shard(dims[name]) if name in dims else Replicate()
                 for name in mesh.mesh_dim_names)


def replicate(mesh: DeviceMesh) -> Placements:
    """Every mesh dimension replicated (JAX's ``P()``)."""
    return _placements(mesh)


def batch_sharding(mesh: DeviceMesh) -> Placements:
    """A batch tensor's placements: its leading axis over ``"data"``,
    replicated over ``"model"`` (JAX's ``P("data", None, ...)``)."""
    return _placements(mesh, **{DATA_AXIS: 0})


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
        out[key] = replicate(mesh) if dim is None else _placements(mesh, **{MODEL_AXIS: dim})
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
    ``Shard(0)`` over ``"model"``), quantized by the whole stack's statistic
    (``parallel.collectives.group_reduce`` over the model group), and routes
    its tokens, this data rank's block, over the data group
    (``QuantMoE.expert_parallel``). Returns ``model``."""
    placements = param_shardings(model, mesh, ep_rule)
    for prefix, m in model.named_modules():
        if not isinstance(m, QuantMoE):
            continue
        stacks = {}
        for name, p in m.named_parameters(recurse=False):
            where = placements[f"{prefix}.{name}" if prefix else name]
            if any(isinstance(pl, Shard) for pl in where):
                stacks[name] = local_shard(p.detach(), mesh, where)
        m.expert_parallel(stacks, mesh.get_group(DATA_AXIS), mesh.get_group(MODEL_AXIS),
                          group_reduce(mesh.get_group(MODEL_AXIS)))
    return model


# --- training: the sharded state, batch and steps ----------------------------

NEXT_SLICE = "ROADMAP queue 1 item 6 (b3)"


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(batch, mesh: DeviceMesh) -> tuple:
    """This data rank's rows of every array of ``batch`` (numpy or
    tensors), on the mesh's device: block ``d`` of ``D`` equal blocks of
    the leading axis. A batch that does not divide over the data axis
    raises ``ValueError``."""
    rows = tuple(local_shard(torch.from_numpy(b) if not isinstance(b, torch.Tensor) else b, mesh,
                             batch_sharding(mesh)) for b in batch)
    return _on_device(rows, mesh_device(mesh))


def _sharded_over_model(placements: Placements, mesh: DeviceMesh) -> Optional[int]:
    p = placements[mesh.mesh_dim_names.index(MODEL_AXIS)]
    return p.dim if isinstance(p, Shard) else None


def _refuse(model: nn.Module, optimizer, mesh: DeviceMesh) -> None:
    """The models and optimizers the sharded steps do not run (yet)."""
    for name, m in model.named_modules():
        if isinstance(m, QuantMoE) and (m.ep is not None or mesh.size() > 1):
            raise ValueError(f"{name or 'the model'} is a QuantMoE on a mesh of "
                             f"{mesh.size()} ranks: its routing, capacity and aux loss under "
                             f"autograd over the mesh are {NEXT_SLICE}")
    if axis_size(mesh, MODEL_AXIS) > 1 and isinstance(optimizer, QuantizedAdam):
        raise ValueError("QuantizedAdam under a model axis > 1: a column shard's blocks of "
                         f"256 are not the whole tensor's; the 8-bit Adam under TP is {NEXT_SLICE}")


def column_layers(model: nn.Module, placements: Dict[str, Placements], mesh: DeviceMesh) -> list:
    """The quant layers whose ``weight`` ``placements`` shard over a model
    axis > 1 (on their out-features). Any other entry sharded there raises
    ``ValueError``: no layer of its kind runs column-parallel. On a model
    axis of one rank none: every kernel is whole, and the layers run the
    unsharded path (no collective over the model group)."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return []
    owners = {}
    for prefix, m in model.named_modules():
        if isinstance(m, _QuantLayer):
            owners[f"{prefix}.weight" if prefix else "weight"] = m
    columns = []
    for key, where in placements.items():
        dim = _sharded_over_model(where, mesh)
        if dim is None:
            continue
        if key in owners and dim == 0:
            columns.append(owners[key])
        else:
            raise ValueError(f"{key} is sharded over 'model' but is no quant layer's weight: "
                             "nothing runs it column-parallel")
    return columns


def shard_train_state(state, mesh: DeviceMesh):
    """Place a ``train.QuantTrainState`` on ``mesh`` in place: every kernel
    (``param_shardings``' rule) keeps this rank's block of out-features,
    and so do its optimizer moments of its shape (Adam's); everything else
    stays whole (replicated). Returns ``(state, placements)``. An
    out-feature count that does not divide over ``"model"`` raises
    ``ValueError``, as do an MoE model on more than one rank or placed by
    ``shard_experts`` and the 8-bit Adam under a model axis > 1."""
    model = state.model
    _refuse(model, state.optimizer, mesh)
    placements = param_shardings(model, mesh)
    column_layers(model, placements, mesh)
    if axis_size(mesh, MODEL_AXIS) == 1:
        return state, placements
    params = dict(model.named_parameters())
    cut = {}
    for key, where in placements.items():
        if _sharded_over_model(where, mesh) is not None:
            cut[key] = local_shard(params[key].detach(), mesh, where)
    for key, block in cut.items():
        p, where = params[key], placements[key]
        moments = state.optimizer.state.get(p, {})
        for name, t in list(moments.items()):
            if isinstance(t, torch.Tensor) and t.shape == p.shape:
                moments[name] = local_shard(t, mesh, where)
        p.data = block
    return state, placements


def _whole(t: torch.Tensor, where: Placements, mesh: DeviceMesh) -> torch.Tensor:
    dim = _sharded_over_model(where, mesh)
    return t if dim is None else all_gather(t, mesh.get_group(MODEL_AXIS), dim)


def unshard_params(model: nn.Module, mesh: DeviceMesh,
                   placements: Optional[Dict[str, Placements]] = None) -> Dict[str, torch.Tensor]:
    """The whole state dict of a model placed by :func:`shard_train_state`,
    on every rank: each sharded entry all-gathered over ``"model"``, the
    rest as they are. A collective: every rank calls it."""
    placements = placements or param_shardings(model, mesh)
    return {k: _whole(v.detach(), placements[k], mesh) for k, v in model.state_dict().items()}


def unshard_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                            mesh: DeviceMesh, placements: Dict[str, Placements]) -> dict:
    """``optimizer.state_dict()`` with every moment of a sharded parameter
    gathered whole over ``"model"`` (a collective: every rank calls it)."""
    sd = optimizer.state_dict()
    names = {id(p): k for k, p in model.named_parameters()}
    index = [id(p) for g in optimizer.param_groups for p in g["params"]]
    params = dict(model.named_parameters())
    for i, moments in list(sd["state"].items()):
        key = names[index[i]]
        # state_dict() shares the optimizer's own dicts: build new ones
        sd["state"][i] = {name: _whole(t, placements[key], mesh)
                          if isinstance(t, torch.Tensor) and t.shape == params[key].shape else t
                          for name, t in moments.items()}
    return sd


def make_sharded_train_step(state, mesh: DeviceMesh, *, has_quant_rng: Optional[bool] = None,
                            elastic_weight: ElasticWeight = 0.0, loss_fn: Callable = cross_entropy):
    """``(sharded_state, step_fn)``: ``state`` placed by
    :func:`shard_train_state`, and ``step_fn(state, batch) -> (state,
    {"loss", "accuracy"})``, the local train step over the mesh (module
    docstring): ``batch`` is this data rank's rows (:func:`shard_batch`),
    the metrics the whole batch's, the same on every rank.
    ``elastic_weight`` and ``loss_fn`` are ``train.make_train_step``'s
    (JAX's ``**step_kwargs``); ``has_quant_rng`` is accepted for the JAX
    package's call sites and ignored (the step's generator is always
    there). Refuses what :func:`shard_train_state` refuses."""
    del has_quant_rng
    state, placements = shard_train_state(state, mesh)
    model = state.model
    context = MeshContext(mesh, column_layers(model, placements, mesh))

    def step(state, batch):
        if state.model is not model:
            raise ValueError("this step runs the state make_sharded_train_step placed")
        x, y = _on_device(batch, state.device)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        compute_loss = make_compute_loss(state, x, y, elastic_weight=elastic_weight,
                                         loss_fn=loss_fn)
        with fp32_cudnn():
            with sharded_step(context):
                loss, logits = compute_loss()
            loss.backward()
        context.average_gradients(model.parameters())
        state.apply_gradients()
        with torch.no_grad():
            acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        loss, acc = context.data_means(loss.detach(), acc)
        return state, {"loss": loss, "accuracy": acc}

    step.context = context
    return state, step


def make_sharded_eval_step(placements: Dict[str, Placements], mesh: DeviceMesh):
    """``eval_fn(state, batch) -> {"loss", "accuracy", "count"}``: eval mode
    on this data rank's rows (:func:`shard_batch`) of a state placed by
    :func:`shard_train_state` with ``placements``; the loss, accuracy and
    count of the whole batch, the same on every rank."""

    @torch.no_grad()
    def step(state, batch):
        model = state.model
        context = MeshContext(mesh, column_layers(model, placements, mesh))
        x, y = _on_device(batch, state.device)
        model.eval()
        with sharded_step(context):
            logits = model(x)
        loss, acc = context.data_means(cross_entropy(logits, y),
                                       (logits.argmax(-1) == y).to(torch.float32).mean())
        return {"loss": loss, "accuracy": acc,
                "count": torch.tensor(y.shape[0] * context.data_size)}

    return step
