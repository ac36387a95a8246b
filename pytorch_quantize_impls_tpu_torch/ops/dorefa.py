"""DoReFa-Net k-bit weight and activation quantization (arXiv:1606.06160).

Counterpart of ``pytorch_quantize_impls_tpu/ops/dorefa.py``:

* ``quantize_k(x, k) = round((2^k - 1) x) / (2^k - 1)``, identity STE over
  the round (eq. 5);
* weights (eq. 9): ``2 quantize_k(tanh(W) / (2 max|tanh(W)|) + 1/2) - 1``,
  the gradient flowing through tanh and the max-normalizer; ``k == 1`` is
  ``E(|W|) sign(W)`` (eq. 8), STE on the sign only;
* activations (eq. 10): ``quantize_k(clip(x, 0, 1), k)``, the clip
  differentiated exactly.

The gradient quantizer ``dorefa_gradient`` (eq. 12) waits for training.
"""

from __future__ import annotations

import torch

from pytorch_quantize_impls_tpu_torch.ops.common import round_ste, safe_sign, ste

_sign_ste = ste(safe_sign)


def quantize_k(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Uniform k-bit quantizer on [0, 1] with identity STE over the round."""
    if bits >= 32:
        return x
    n = float(2**bits - 1)
    return round_ste(x * n) / n


def dorefa_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa weight quantization (paper eq. 8/9); output in [-1, 1]."""
    if bits == 1:
        return w.abs().mean() * _sign_ste(w)
    if bits >= 32:
        return w
    t = torch.tanh(w)
    # all-zero weights would divide 0/0: the guard keeps forward and
    # gradient finite, as in the JAX package
    m = t.abs().max()
    t = t / (2.0 * torch.where(m > 0, m, torch.ones_like(m))) + 0.5
    return 2.0 * quantize_k(t, bits) - 1.0


def dorefa_activation(x: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa activation quantization (paper eq. 10): the k-bit grid on
    ``clip(x, 0, 1)``."""
    if bits >= 32:
        return x
    return quantize_k(torch.clamp(x, 0.0, 1.0), bits)
