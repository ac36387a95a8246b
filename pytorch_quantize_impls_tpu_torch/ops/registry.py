"""The quantizer registry: a scheme name and its knobs -> a configured
quantizer.

Counterpart of ``pytorch_quantize_impls_tpu/ops/registry.py``: the same ten
schemes, knob names and errors. The callable maps ``x`` (deterministic
schemes) or ``(x, generator)`` (stochastic schemes, where the JAX package
takes ``(x, key)``) to the fake-quantized tensor with its STE backward.

``"xnor"`` is the JAX registry's expression, ``xnor_quantize(w) *
xnor_alpha(w)``: ``xnor_quantize`` already carries alpha, so the result is
``alpha^2 sign(w)``, not the XNOR layers' ``alpha sign(w)``. It is kept so
that both packages' registries return the same values.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from pytorch_quantize_impls_tpu_torch.ops import binary, dorefa, log_lin, ternary, xnor

SCHEMES = (
    "binary",
    "binary_stoch",
    "binary_tanh",
    "ternary",
    "ternary_stoch",
    "dorefa_weight",
    "dorefa_activation",
    "log",
    "lin",
    "xnor",
)

STOCHASTIC_SCHEMES = ("binary_stoch", "ternary_stoch")

_DETERMINISTIC = {
    "binary": binary.binary_connect_det,
    "binary_tanh": binary.binary_tanh,
    "ternary": ternary.ternary_connect_det,
    "dorefa_weight": dorefa.dorefa_weight,
    "dorefa_activation": dorefa.dorefa_activation,
    "log": log_lin.log_quant,
    "lin": log_lin.lin_quant,
}
_STOCHASTIC = {
    "binary_stoch": binary.binary_connect_stoch,
    "ternary_stoch": ternary.ternary_connect_stoch,
}


def get_quantizer(scheme: str, **knobs) -> Callable[..., torch.Tensor]:
    """The quantizer of ``scheme`` with ``knobs`` bound: ``bits``, ``fsr``,
    ``with_sign``, ``lin_back``, ``ste_mode``, ``clip_bound`` or
    ``channel_axis``, as the scheme's op takes them. A knob the op does not
    take raises TypeError when the quantizer is called (xnor and the
    stochastic schemes: here); an unknown scheme raises ValueError.

    >>> q = get_quantizer("dorefa_weight", bits=4)
    >>> wq = q(w)
    >>> q = get_quantizer("binary_stoch")
    >>> wq = q(w, generator)  # stochastic schemes take a torch.Generator
    """
    if scheme in _DETERMINISTIC:
        return functools.partial(_DETERMINISTIC[scheme], **knobs)
    if scheme in _STOCHASTIC:
        if knobs:
            raise TypeError(f"{scheme} takes no knobs, got {knobs}")
        return _STOCHASTIC[scheme]
    if scheme == "xnor":
        ca = knobs.pop("channel_axis", -1)
        if knobs:
            raise TypeError(f"xnor knobs: channel_axis only, got {knobs}")

        def q(w):
            return xnor.xnor_quantize(w, ca) * xnor.xnor_alpha(w, ca)

        return q
    raise ValueError(f"unknown scheme {scheme!r}; pick from {SCHEMES}")
