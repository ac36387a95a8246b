"""DoReFa-Net k-bit weight and activation quantization (arXiv:1606.06160).

Counterpart of ``pytorch_quantize_impls_tpu/ops/dorefa.py``:

* ``quantize_k(x, k) = round((2^k - 1) x) / (2^k - 1)``, identity STE over
  the round (eq. 5);
* weights (eq. 9): ``2 quantize_k(tanh(W) / (2 max|tanh(W)|) + 1/2) - 1``,
  the gradient flowing through tanh and the max-normalizer; ``k == 1`` is
  ``E(|W|) sign(W)`` (eq. 8), STE on the sign only;
* activations (eq. 10): ``quantize_k(clip(x, 0, 1), k)``, the clip
  differentiated exactly;
* gradients (eq. 12, in training): the identity forward, and a backward
  that quantizes the cotangent stochastically,
  ``2 m (quantize_k(g / 2m + 1/2 + N) - 1/2 - N)`` with ``m = max|g|`` over
  the tensor and the noise ``N = (u - 1/2) / (2^k - 1)``. The primitive
  :func:`dorefa_grad_prim` takes the uniform draw ``u`` as an argument, as
  JAX's ``_dorefa_grad_prim(x, u, n_levels)`` does, and keeps its order of
  float operations, so the two packages give the same bits on a shared
  ``u``; :func:`dorefa_gradient` draws ``u`` from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from pytorch_quantize_impls_tpu_torch.ops.binary import uniform_like
from pytorch_quantize_impls_tpu_torch.ops.common import jnp_clip, round_ste, safe_sign, ste

_sign_ste = ste(safe_sign)


def quantize_k(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Uniform k-bit quantizer on [0, 1] with identity STE over the round."""
    if bits >= 32:
        return x
    n = float(2**bits - 1)
    return round_ste(x * n) / n


def dorefa_weight(w: torch.Tensor, bits: int, *, stat: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """DoReFa weight quantization (paper eq. 8/9); output in [-1, 1].

    ``stat`` stands in for the tensor's own statistic, ``E|W|`` at one bit
    and ``max|tanh W|`` above: the whole tensor's, where ``w`` is a shard of
    it (an expert-parallel rank's experts)."""
    if bits == 1:
        # |w| as w sign(w): the same values, and JAX's gradient +1 at w = 0
        # (torch's abs has 0 there); the mean as jnp.mean takes it, the sum
        # over the count, which an expert-parallel statistic reproduces
        scale = (w * safe_sign(w.detach())).sum() / w.numel() if stat is None else stat
        return scale * _sign_ste(w)
    if bits >= 32:
        return w
    t = torch.tanh(w)
    # all-zero weights would divide 0/0: the guard keeps forward and
    # gradient finite, as in the JAX package
    m = t.abs().max() if stat is None else stat
    t = t / (2.0 * torch.where(m > 0, m, torch.ones_like(m))) + 0.5
    return 2.0 * quantize_k(t, bits) - 1.0


def dorefa_activation(x: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa activation quantization (paper eq. 10): the k-bit grid on
    ``clip(x, 0, 1)``, the clip ``jnp.clip``'s (half the gradient where x
    sits on a bound, as in the JAX package)."""
    if bits >= 32:
        return x
    return quantize_k(jnp_clip(x, 0.0, 1.0), bits)


class _DorefaGrad(torch.autograd.Function):
    """Identity forward; the backward quantizes the cotangent (eq. 12) with
    the noise of ``u``, and gives nothing for ``u``."""

    @staticmethod
    def forward(ctx, x, u, n_levels):
        ctx.save_for_backward(u)
        ctx.n_levels = n_levels
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        n = torch.tensor(ctx.n_levels, dtype=u.dtype, device=u.device)
        m = g.abs().max()
        m = torch.where(m == 0, torch.ones_like(m), m)
        noise = (u - 0.5) / n
        gs = g / (2.0 * m) + 0.5 + noise
        q = torch.round(torch.clamp(gs, 0.0, 1.0) * n) / n
        gq = 2.0 * m * (q - 0.5 - noise)
        return gq.to(g.dtype), None, None


def dorefa_grad_prim(x: torch.Tensor, u: torch.Tensor, bits: int) -> torch.Tensor:
    """The gradient quantizer on a given draw ``u`` ~ U[0, 1) of x's shape:
    ``x`` forward, the ``bits``-bit stochastic cotangent backward."""
    return _DorefaGrad.apply(x, u, float(2**bits - 1))


def dorefa_gradient(x: torch.Tensor, generator: torch.Generator, bits: int) -> torch.Tensor:
    """Identity forward; quantizes the gradient to ``bits`` bits (paper eq.
    12), with a fresh draw per call from ``generator``. Insert it on the
    activation path."""
    if bits >= 32:
        return x
    return dorefa_grad_prim(x, uniform_like(x, generator), bits)


def dorefa_quantizers(w_bits: int = 1, a_bits: int = 32,
                      g_bits: int = 32) -> Dict[str, Callable]:
    """The configured ``{"weight", "activation", "gradient"}`` callables, as
    the reference's ``nnDorefaQuant(bitwight=k)``; the gradient one takes
    ``(x, generator)``."""
    return {
        "weight": lambda w: dorefa_weight(w, w_bits),
        "activation": lambda x: dorefa_activation(x, a_bits),
        "gradient": lambda x, generator: dorefa_gradient(x, generator, g_bits),
    }
