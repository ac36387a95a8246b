"""KV-cache quantization codecs.

Counterpart of ``pytorch_quantize_impls_tpu/ops/kv_cache.py``: symmetric
codes with one float32 scale per (batch, position, head) group, the same
arithmetic in the same order, so codes and scales are bit-equal to the JAX
package's on the same input (``torch.round`` rounds half to even, as
``jnp.round`` does).
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv(x: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., head_dim) float -> (codes int8, scale float32 over the last axis).

    Symmetric, with no -2^(bits-1) code; an all-zero group gets scale 1 so
    its round trip is exactly zero instead of NaN.
    """
    if not 2 <= bits <= 8:
        raise ValueError(f"kv bits must be in [2, 8], got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    codes = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax).to(torch.int8)
    return codes, scale


def dequantize_kv(
    codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``codes * scale`` in ``dtype``."""
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)
