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
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_quantize_impls_tpu_torch.nn.base import _apply_quant, scheme_weight_quant
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


def switch_route(xf: torch.Tensor, router: torch.Tensor, capacity_factor: float) -> Routing:
    """Route the tokens ``xf`` (T, d) with the float32 ``router`` (d, E)."""
    t, e = xf.shape[0], router.shape[1]
    cap = capacity(t, e, capacity_factor)
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
    pos = torch.cumsum(onehot, dim=0) * onehot  # 1-based slot in the chosen expert
    keep = (pos <= cap) & (onehot > 0)
    # the slot's one-hot where kept; JAX's one_hot(pos - 1, cap) gives zeros
    # for pos - 1 outside [0, cap), which keep already excludes
    slot = (pos.sum(dim=-1) - 1).to(torch.int64).clamp(0, cap - 1)
    dispatch = keep.to(torch.float32)[..., None] * F.one_hot(slot, cap).to(torch.float32)[:, None]
    combine = dispatch * gate[:, None, None]
    return Routing(probs, gate, expert, onehot, keep, dispatch, combine, cap)


def switch_aux_loss(r: Routing, aux_loss_weight: float = 1.0) -> torch.Tensor:
    """``aux_loss_weight * E * sum_e frac_e * pmean_e``: at least
    ``aux_loss_weight``, equal to it at a perfect balance."""
    e = r.onehot.shape[1]
    frac = r.onehot.mean(dim=0)
    pmean = r.probs.mean(dim=0)
    return aux_loss_weight * e * torch.sum(frac * pmean)


def switch_ffn(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, *,
               capacity_factor: float = 2.0, aux_loss_weight: float = 1.0,
               dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor, Routing]:
    """The switch FFN on ``x`` (..., d) with the (already quantized) expert
    weights ``wi`` (E, d, f) and ``wo`` (E, f, d): ``(out (..., d), aux
    loss, routing)``. Dropped tokens give 0."""
    *lead, d = x.shape
    xf = x.reshape(-1, d)
    r = switch_route(xf, router, capacity_factor)
    aux = switch_aux_loss(r, aux_loss_weight)
    cdt = dtype or x.dtype
    xin = torch.einsum("tec,td->ecd", r.dispatch.to(cdt), xf.to(cdt))
    h = torch.relu(torch.einsum("ecd,edf->ecf", xin, wi.to(cdt)))
    hout = torch.einsum("ecf,efd->ecd", h, wo.to(cdt))
    out = torch.einsum("tec,ecd->td", r.combine.to(cdt), hout)
    return out.reshape(*lead, d), aux, r


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
        self.n_experts = n_experts
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
        """``(wi, wo)``: the stacked masters through the scheme's quantizer."""
        return (_apply_quant(self.quantizer, self.wi_kernel, self),
                _apply_quant(self.quantizer, self.wo_kernel, self))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wi, wo = self.quantized_kernels()
        out, self._aux, _ = switch_ffn(
            x, self.router, wi, wo, capacity_factor=self.capacity_factor,
            aux_loss_weight=self.aux_loss_weight, dtype=self.dtype)
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
