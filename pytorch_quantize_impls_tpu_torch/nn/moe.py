"""Quantized Mixture-of-Experts FFN with top-1 (switch) routing.

Counterpart of ``pytorch_quantize_impls_tpu/nn/moe.py``. Routing is a dense
one-hot dispatch and combine: each token goes to the expert of its largest
router probability, into the next free of ``cap`` slots of that expert, in
the order of the tokens flattened over ``(..., d_model)``; a token past its
expert's capacity is dropped and gives 0 (the caller adds the residual).
The expert kernels are stacked on a leading expert axis, ``wi_kernel (E, d,
f)`` and ``wo_kernel (E, f, d)``, and each stack goes through the scheme's
weight quantizer as one tensor (DoReFa's ``max |tanh w|`` is taken over
every expert). The router ``(d, E)`` stays float32 and full precision.

The arithmetic is the JAX layer's:

* ``cap = max(min(int(ceil(T / E) * capacity_factor), T), 1)`` in Python
  float arithmetic with truncation, for T tokens;
* float32 router logits, their softmax, ``gate = max(probs)`` (at a tie its
  gradient is split evenly among the tied entries, as ``jnp.max``'s is:
  ``torch.amax``), the expert ``argmax(probs)`` (the first index of a tie);
* the switch aux loss ``aux_loss_weight * E * sum_e frac_e * pmean_e``;
* the dispatch, the combine (the gate in it) and both expert weights cast to
  the compute dtype (``dtype``, else the input's) before the products, with
  a ReLU between the two expert products.

:func:`switch_route` and :func:`switch_ffn` are the plain functions on
tensors; :class:`QuantMoE` holds the parameters, quantizes the stacks and
keeps the aux loss of its last forward, which :meth:`QuantMoE.penalty`
returns and ``nn.collect_elastic_losses`` sums, as the JAX layer sows it into
the ``losses`` collection: ``train.make_train_step(elastic_weight=w)`` adds
``w * aux`` to the loss.

Expert parallelism (EP; ``parallel.shard_experts`` calls
:meth:`QuantMoE.expert_parallel`) computes what the JAX layer computes under
GSPMD with the tokens sharded over ``"data"`` and the expert stacks over
``"model"``: the same function of the whole token set. Each rank holds its
``E / n_model`` experts of both stacks and routes its own tokens, which are
the data rank's block of the flattened token order. :func:`switch_route`
then takes ``cap`` from the global token count and offsets the slot
``cumsum`` by the per-expert counts of the lower data ranks (an
``all_gather`` over the data group); the aux loss's ``frac`` and ``pmean``
are ``all_reduce`` sums over the global tokens. Each rank's dispatch
einsum, summed over the data group, is the global ``xin`` exactly (each
(expert, slot) has one token at most); each model rank runs its experts,
their outputs are gathered over the model group in expert order, and the
combine runs on the local tokens. A scheme whose quantizer takes a
statistic of the whole stack (DoReFa's ``max |tanh w|``, one-bit DoReFa's
``E|W|``) reduces it over the model group (``ExpertParallel.reduce``,
``ops.dorefa_weight(reduce=)``), so that a shard quantizes as the whole
stack does. EP runs the forward only: the dispatch's all-reduce, the
outputs' all-gather and the aux loss's all-reduces carry no gradient, so
EP under autograd raises (EP under autograd is ROADMAP queue 1 item 6 (b3);
the sharded train step refuses such a model).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pytorch_quantize_impls_tpu_torch.nn.base import _apply_quant, scheme_weight_quant
from pytorch_quantize_impls_tpu_torch.ops.dorefa import dorefa_weight
from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device


def capacity(tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: ``int(ceil(tokens / n_experts) * capacity_factor)``
    (a Python float, truncated), within ``[1, tokens]``."""
    cap = int(-(-tokens // n_experts) * capacity_factor)
    return max(min(cap, tokens), 1)


class Routing(NamedTuple):
    """One switch routing of T tokens over E experts with ``cap`` slots each."""

    probs: torch.Tensor  # (T, E) float32 router softmax
    gate: torch.Tensor  # (T,) the chosen expert's probability
    expert: torch.Tensor  # (T,) int64
    onehot: torch.Tensor  # (T, E) float32
    keep: torch.Tensor  # (T, E) bool: routed there and within capacity
    dispatch: torch.Tensor  # (T, E, cap) float32 0/1
    combine: torch.Tensor  # (T, E, cap) float32: dispatch * gate
    cap: int
    counts: torch.Tensor  # (E,) float32: tokens routed to each expert, over every data rank
    tokens: int  # the token count over every data rank


def switch_route(xf: torch.Tensor, router: torch.Tensor, capacity_factor: float,
                 data_group=None) -> Routing:
    """Route the tokens ``xf`` (T, d) with the float32 ``router`` (d, E).
    With ``data_group``, ``xf`` is this data rank's block of the tokens
    (ranks in token order): the capacity is the global token count's and
    the slots continue the lower ranks' counts."""
    t, e = xf.shape[0], router.shape[1]
    # x at float32 (JAX's xf.astype(float32)) times the router at its dtype:
    # float32, or float64 in a model made .double()
    rdt = torch.promote_types(torch.float32, router.dtype)
    logits = xf.to(torch.float32).to(rdt) @ router.to(rdt)
    # jax.nn.softmax's arithmetic: exp(x - max) / sum, the max held constant
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = u / u.sum(dim=-1, keepdim=True)
    gate = probs.amax(dim=-1)
    expert = probs.argmax(dim=-1)
    onehot = F.one_hot(expert, e).to(torch.float32)
    counts = onehot.sum(dim=0)
    offset = torch.zeros_like(counts)
    if data_group is not None:
        # every data rank's (per-expert counts, tokens): float32 holds them exactly
        mine = torch.cat([counts, counts.new_tensor([t])])
        every = mine.new_empty(dist.get_world_size(data_group) * (e + 1))
        dist.all_gather_into_tensor(every, mine, group=data_group)
        every = every.view(-1, e + 1)
        offset = every[:dist.get_rank(data_group), :e].sum(dim=0)
        counts, t = every[:, :e].sum(dim=0), int(every[:, e].sum().item())
    cap = capacity(t, e, capacity_factor)
    # 1-based slot in the chosen expert
    pos = (torch.cumsum(onehot, dim=0) + offset) * onehot
    keep = (pos <= cap) & (onehot > 0)
    # the slot's one-hot where kept; JAX's one_hot(pos - 1, cap) gives zeros
    # for pos - 1 outside [0, cap), which keep already excludes
    slot = (pos.sum(dim=-1) - 1).to(torch.int64).clamp(0, cap - 1)
    dispatch = keep.to(torch.float32)[..., None] * F.one_hot(slot, cap).to(torch.float32)[:, None]
    combine = dispatch * gate[:, None, None]
    return Routing(probs, gate, expert, onehot, keep, dispatch, combine, cap, counts, t)


def switch_aux_loss(r: Routing, aux_loss_weight: float = 1.0, data_group=None) -> torch.Tensor:
    """``aux_loss_weight * E * sum_e frac_e * pmean_e``: at least
    ``aux_loss_weight``, equal to it at a perfect balance. With
    ``data_group`` (``r`` routed with it), the means are over every data
    rank's tokens."""
    e = r.onehot.shape[1]
    if data_group is None:
        frac = r.onehot.mean(dim=0)
        pmean = r.probs.mean(dim=0)
    else:
        psum = r.probs.sum(dim=0)
        dist.all_reduce(psum, group=data_group)
        frac, pmean = r.counts / r.tokens, psum / r.tokens
    return aux_loss_weight * e * torch.sum(frac * pmean)


def switch_ffn(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, *,
               capacity_factor: float = 2.0, aux_loss_weight: float = 1.0,
               dtype: Optional[torch.dtype] = None, ep: Optional["ExpertParallel"] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Routing]:
    """The switch FFN on ``x`` (..., d) with the (already quantized) expert
    weights ``wi`` (E, d, f) and ``wo`` (E, f, d): ``(out (..., d), aux
    loss, routing)``. Dropped tokens give 0. With ``ep``, ``x`` is a data
    rank's tokens and ``wi``/``wo`` a model rank's experts (E/n of each
    stack, quantized with the whole stack's statistic): the rows of the
    whole function's output at these tokens, and the global aux loss."""
    *lead, d = x.shape
    xf = x.reshape(-1, d)
    data_group = None if ep is None else ep.data_group
    r = switch_route(xf, router, capacity_factor, data_group)
    aux = switch_aux_loss(r, aux_loss_weight, data_group)
    cdt = dtype or x.dtype
    xin = torch.einsum("tec,td->ecd", r.dispatch.to(cdt), xf.to(cdt))
    if ep is None:
        hout = expert_ffn(xin, wi.to(cdt), wo.to(cdt))
    else:
        # one token at most per (expert, slot) over every data rank: the sum is exact
        xin = xin.contiguous()
        dist.all_reduce(xin, group=data_group)
        mine = expert_ffn(xin[ep.first_expert:ep.first_expert + wi.shape[0]], wi.to(cdt),
                          wo.to(cdt)).contiguous()
        hout = mine.new_empty(xin.shape)
        dist.all_gather_into_tensor(hout, mine, group=ep.model_group)  # expert order
    out = torch.einsum("tec,ecd->td", r.combine.to(cdt), hout)
    return out.reshape(*lead, d), aux, r


def expert_ffn(xin: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The experts on their dispatched slots: ``xin`` (E, C, d) through
    ``wi`` (E, d, f), a ReLU and ``wo`` (E, f, d) -> ``hout`` (E, C, d).
    Each expert's rows depend on its own slots and weights only, so a rank
    holding experts ``[lo, hi)`` computes rows ``[lo, hi)`` of the whole
    stack's output."""
    h = torch.relu(torch.einsum("ecd,edf->ecf", xin, wi))
    return torch.einsum("ecf,efd->ecd", h, wo)


def expert_sharding_rules(params_path: str) -> bool:
    """True if this parameter path names an expert-stacked kernel (leading
    axis = expert), which expert parallelism shards over the model axis;
    the ``_kernel`` suffix also keeps them in the clamp's default filter."""
    return params_path.endswith("wi_kernel") or params_path.endswith("wo_kernel")


class ExpertParallel(NamedTuple):
    """A ``QuantMoE``'s place on a mesh: the groups of its data and model
    axes, its model rank's first expert, and the reduction over the model
    group that gives DoReFa the whole stack's statistic from this rank's
    block (``ops.dorefa_weight(reduce=)``)."""

    data_group: object
    model_group: object
    first_expert: int
    reduce: Callable[[str, torch.Tensor], torch.Tensor]


class QuantMoE(nn.Module):
    """Top-1-routed FFN over ``n_experts`` quantized experts: input (...,
    d_model) -> output (..., d_model), at the compute dtype.

    Parameters (float32, on ``device``: the card unless ``device="cpu"``;
    raises without a GPU): ``router (d_model, E)``, ``wi_kernel (E, d_model,
    d_ff)``, ``wo_kernel (E, d_ff, d_model)``, drawn glorot-uniform over
    their last two axes (:func:`nn.init_like_flax` redraws them from a seed
    as flax's ``glorot_normal``). The scheme's weight quantizer
    (:func:`nn.base.scheme_weight_quant`; ``"xnor"`` as ``"binary"``) acts on
    each stack as one tensor; the router is not quantized.
    """

    def __init__(self, d_model: int, n_experts: int, d_ff: int, *, scheme: str = "binary",
                 w_bits: int = 1, fsr: float = 0.0, capacity_factor: float = 2.0,
                 aux_loss_weight: float = 1.0, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        # the LM's map; xnor experts quantize as binary, as in the JAX layer
        self.quantizer = scheme_weight_quant("binary" if scheme == "xnor" else scheme, w_bits,
                                             fsr)
        self.scheme, self.w_bits = scheme, w_bits
        self.n_experts = n_experts
        self.ep: Optional[ExpertParallel] = None  # set by expert_parallel
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(d_model, n_experts, device=device))
        self.wi_kernel = nn.Parameter(torch.empty(n_experts, d_model, d_ff, device=device))
        self.wo_kernel = nn.Parameter(torch.empty(n_experts, d_ff, d_model, device=device))
        with torch.no_grad():
            for p in self.glorot_params():
                fan_in, fan_out = p.shape[-2], p.shape[-1]
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                nn.init.uniform_(p, -bound, bound)
        self._aux: Optional[torch.Tensor] = None

    def glorot_params(self):
        """The parameters ``nn.init_like_flax`` draws by ``glorot_normal``,
        in the order it draws them; each one's fans are its last two axes."""
        return (self.router, self.wi_kernel, self.wo_kernel)

    def quantized_kernels(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(wi, wo)``: the stacked masters through the scheme's quantizer
        (on a mesh, this rank's experts, with the whole stack's statistic)."""
        if self.ep is None:
            return (_apply_quant(self.quantizer, self.wi_kernel, self),
                    _apply_quant(self.quantizer, self.wo_kernel, self))
        if self.scheme != "dorefa" or self.w_bits >= 32:
            return (_apply_quant(self.quantizer, self.wi_kernel, self),
                    _apply_quant(self.quantizer, self.wo_kernel, self))
        return tuple(dorefa_weight(w, self.w_bits, reduce=self.ep.reduce)
                     for w in (self.wi_kernel, self.wo_kernel))

    def expert_parallel(self, stacks: Dict[str, torch.Tensor], data_group, model_group,
                        reduce: Callable[[str, torch.Tensor], torch.Tensor]) -> None:
        """Place the layer on a mesh (``parallel.shard_experts``, which cuts
        ``stacks``): ``wi_kernel`` and ``wo_kernel`` become this model
        rank's block of ``E / n`` experts (block ``r`` of the model group's
        ``n`` ranks, in rank order), quantized by the whole stack's
        statistic that ``reduce`` gives over the model group, and the layer
        routes over the data group."""
        if set(stacks) != {"wi_kernel", "wo_kernel"}:
            raise ValueError(f"expert_parallel takes both expert stacks, not {sorted(stacks)}")
        per = stacks["wi_kernel"].shape[0]
        for name, w in stacks.items():
            setattr(self, name, nn.Parameter(w))
        self.ep = ExpertParallel(data_group, model_group, dist.get_rank(model_group) * per,
                                 reduce)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ep is not None and torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            raise NotImplementedError(
                "an expert-parallel QuantMoE runs the forward only (its statistics reduce "
                "without a gradient): run it under torch.no_grad(); EP under autograd is "
                "ROADMAP queue 1 item 6 (b3)")
        wi, wo = self.quantized_kernels()
        out, self._aux, _ = switch_ffn(
            x, self.router, wi, wo, capacity_factor=self.capacity_factor,
            aux_loss_weight=self.aux_loss_weight, dtype=self.dtype, ep=self.ep)
        return out

    def penalty(self) -> torch.Tensor:
        """The switch aux loss of the last forward (with its graph where
        that forward recorded one)."""
        if self._aux is None:
            raise RuntimeError(
                "QuantMoE.penalty() was read before any forward: the aux loss is a function "
                "of the last forward's routing")
        return self._aux

    def __getstate__(self):
        # a copy has had no forward (and a tensor with a graph does not deep-copy)
        return {**super().__getstate__(), "_aux": None}
