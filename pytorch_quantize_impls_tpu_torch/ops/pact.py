"""PACT, parameterized clipping activation (arXiv:1805.06085).

Counterpart of ``pytorch_quantize_impls_tpu/ops/pact.py``: activations are
clipped to a learnable upper bound ``alpha`` and quantized to k bits over
``[0, alpha]``:

    y = round(clip(x, 0, a) * (2^k - 1) / a) * a / (2^k - 1),  a = max(alpha, 1e-8)

Gradients (paper §4, STE over the round): ``dy/dx = 1`` on ``0 < x < a``,
``dy/dalpha = 1`` on ``x >= a``, 0 elsewhere. The paper regularizes alpha
with an L2 term, :func:`pact_alpha_penalty`, added to the training loss.
"""

from __future__ import annotations

import torch


class _Pact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, n):
        a = torch.clamp(alpha, min=1e-8)
        ctx.save_for_backward(x, a)
        y = torch.minimum(torch.clamp(x, min=0.0), a)
        return torch.round(y * (n / a)) * (a / n)

    @staticmethod
    def backward(ctx, g):
        x, a = ctx.saved_tensors
        gx = g * ((x > 0) & (x < a)).to(g.dtype)
        galpha = (g * (x >= a).to(g.dtype)).sum().reshape(a.shape)
        return gx, galpha, None


def pact(x: torch.Tensor, alpha: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """PACT-quantize activations to ``bits`` over the learnable ``[0, alpha]``,
    at float32 or x's dtype where it is wider: the JAX package's
    ``result_type(x, float32)``, so a bf16 ``x`` gives float32."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    x, alpha = x.to(dtype), alpha.to(dtype)
    if bits >= 32:
        return torch.minimum(torch.clamp(x, min=0.0), torch.clamp(alpha, min=1e-8))
    return _Pact.apply(x, alpha, float(2**bits - 1))


def pact_alpha_penalty(alpha: torch.Tensor) -> torch.Tensor:
    """L2 regularizer on the clip level (paper: lambda ||alpha||^2)."""
    return torch.sum(torch.square(alpha))
