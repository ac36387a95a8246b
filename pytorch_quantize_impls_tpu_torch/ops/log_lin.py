"""Log-domain (power-of-2) and linear FSR quantization (arXiv:1603.01025).

Counterpart of ``pytorch_quantize_impls_tpu/ops/log_lin.py``:

* ``log_quant(x; fsr, bits)``:
  ``sign(x) * 2^(clip(round(log2|x|), fsr - 2^bits, fsr))``; 0 maps to the
  smallest level before the log. ``with_sign=False`` drops the sign.
  ``lin_back=True`` is the identity STE; ``lin_back=False`` scales the
  gradient by the surrogate ``|y|/|x| sign(x) sign(y)`` (0 at x == 0).
* ``lin_quant(x; fsr, bits)``: the uniform grid of step
  ``2^(fsr - bits)``, clipped to ``±2^fsr``; identity STE.
* ``log_quant_exponent`` / ``log_quant_from_exponent``: the (sign,
  exponent index) pair the packed shift kernels store, index in
  ``[0, 2^bits]`` for the level ``2^(fsr - 2^bits + index)``.

``torch.round`` rounds half to even, as ``jnp.round`` does. ``log2`` and
``exp2`` are float32 library calls whose last bit may differ from XLA's
where ``|x|`` sits within an ulp of ``2^(k + 1/2)`` (the exponent then
rounds the other way) or for deep-negative levels (``exp2`` one ulp off).
"""

from __future__ import annotations

import torch

from pytorch_quantize_impls_tpu_torch.ops.common import safe_sign, ste


def _log_levels(fsr: float, bits: int):
    return fsr - float(2**bits), float(fsr)


def _log_exponent(x: torch.Tensor, fsr: float, bits: int) -> torch.Tensor:
    """``clip(round(log2|x|), lo, hi)``, with 0 mapped to ``2^lo`` first."""
    lo, hi = _log_levels(fsr, bits)
    mag = x.abs()
    mag = torch.where(mag == 0, torch.full_like(mag, 2.0**lo), mag)
    return torch.clamp(torch.round(torch.log2(mag)), lo, hi)


def _log_quant_value(x: torch.Tensor, fsr: float, bits: int, with_sign: bool) -> torch.Tensor:
    y = torch.exp2(_log_exponent(x, fsr, bits))
    if with_sign:
        y = y * safe_sign(x)
    return y.to(x.dtype)


class _LogQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fsr, bits, with_sign, lin_back):
        y = _log_quant_value(x, fsr, bits, with_sign)
        ctx.with_sign, ctx.lin_back = with_sign, lin_back
        if not lin_back:
            ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.lin_back:
            return g, None, None, None, None
        x, y = ctx.saved_tensors
        # the log-domain surrogate derivative |y|/|x| (~1 on the levels),
        # guarded at x == 0
        denom = torch.where(x == 0, torch.ones_like(x), x)
        scale = torch.where(x == 0, torch.zeros_like(x), y.abs() / denom.abs())
        if ctx.with_sign:
            return g * scale * safe_sign(x) * safe_sign(y), None, None, None, None
        return g * scale, None, None, None, None


def log_quant(
    x: torch.Tensor,
    fsr: float = 0.0,
    bits: int = 4,
    *,
    with_sign: bool = True,
    lin_back: bool = True,
) -> torch.Tensor:
    """Power-of-2 quantization with an STE backward (module docstring)."""
    return _LogQuant.apply(x, fsr, bits, with_sign, lin_back)


def lin_quant(x: torch.Tensor, fsr: float = 0.0, bits: int = 4) -> torch.Tensor:
    """Uniform FSR-grid quantization with an identity STE."""
    step = 2.0 ** (fsr - bits)
    bound = 2.0**fsr
    return ste(
        lambda v: torch.clamp(torch.round(v / step) * step, -bound, bound).to(v.dtype)
    )(x)


def log_quant_exponent(x: torch.Tensor, fsr: float = 0.0, bits: int = 4):
    """(sign, exponent index) of ``log_quant(x)``: the sign as ``x``'s dtype
    (``safe_sign``, +1 at 0), the index int32 in ``[0, 2^bits]``."""
    lo, _ = _log_levels(fsr, bits)
    idx = (_log_exponent(x, fsr, bits) - lo).to(torch.int32)
    return safe_sign(x), idx


def log_quant_from_exponent(
    sign: torch.Tensor, idx: torch.Tensor, fsr: float = 0.0, bits: int = 4
) -> torch.Tensor:
    """Inverse of :func:`log_quant_exponent`: ``sign * 2^(idx + lo)`` in
    float32."""
    lo, _ = _log_levels(fsr, bits)
    return sign * torch.exp2(idx.to(torch.float32) + lo)
