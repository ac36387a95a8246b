"""Shared quantizer helpers: the zero-safe sign, the BinaryConnect hard
sigmoid and the straight-through estimator (STE), as a
``torch.autograd.Function``.

Counterpart of ``pytorch_quantize_impls_tpu/ops/common.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

STE_IDENTITY = "identity"
STE_CLIP = "clip"

Mask = Callable[[torch.Tensor], torch.Tensor]


def safe_sign(x: torch.Tensor) -> torch.Tensor:
    """Sign with ``sign(0) == +1`` so binarized values are never 0."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def jnp_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient is split
    in half where x sits on a bound (``torch.clamp`` passes all of it). The
    forward is one ``torch.clamp``; the half lives in the backward mask,
    and a call that records no gradient (serving) is the bare clamp."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)

    def mask(x):
        inside = ((x > lo) & (x < hi)).to(x.dtype)
        return inside + 0.5 * ((x == lo) | (x == hi)).to(x.dtype)

    return _STE.apply(x, lambda x: torch.clamp(x, lo, hi), mask)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """BinaryConnect hard sigmoid: ``clip((x + 1) / 2, 0, 1)``."""
    return jnp_clip((x + 1.0) * 0.5, 0.0, 1.0)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Subnormal floats -> 0, as XLA computes on the CPU and the TPU.

    PyTorch keeps subnormals. A value that is exactly 0 in the JAX package
    (an attention context whose large terms cancel, the rest flushed) can
    then come out as a tiny nonzero here, and a sign taken on it flips. The
    attention code flushes the softmax probabilities and the context before
    its sign. Products inside a matmul are not flushed, so the fused decode
    step leaves ``p * v_scale`` as it is too: then it forms the same terms as
    the fake-quant model, whose probabilities meet dequantized V in a matmul.

    XLA's flush is no op of the program, so it has no gradient of its own:
    the gradient passes through unchanged. (A context that is exactly 0 in
    both packages still passes its sign's STE gradient back, as in JAX; a
    zero gradient there would cut the attention's backward wherever a W1A1
    context cancels.)"""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return _flush(x)
    return _STE.apply(x, _flush, None)


def _flush(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, 0.0, x)


class _STE(torch.autograd.Function):
    """Forward ``forward(x)``; backward ``g * backward_mask(x)`` (or ``g``)."""

    @staticmethod
    def forward(ctx, x, forward, backward_mask):
        ctx.backward_mask = backward_mask
        if backward_mask is not None:
            ctx.save_for_backward(x)
        return forward(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward_mask is None:
            return g, None, None
        (x,) = ctx.saved_tensors
        return g * ctx.backward_mask(x), None, None


def ste(
    forward: Callable[[torch.Tensor], torch.Tensor],
    backward_mask: Optional[Mask] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build a straight-through-estimator quantizer: ``forward`` maps x to its
    quantized twin; the gradient passes through, times ``backward_mask(x)``
    when one is given."""
    return lambda x: _STE.apply(x, forward, backward_mask)


def clip_mask(bound: float = 1.0) -> Mask:
    """Hard-tanh STE mask: cancel the gradient where ``|x| > bound``."""
    return lambda x: (x.abs() <= bound).to(x.dtype)


def ste_identity(forward: Callable[[torch.Tensor], torch.Tensor]):
    """Identity-STE wrapper: the gradient passes through unchanged."""
    return ste(forward, None)


def ste_clip(forward: Callable[[torch.Tensor], torch.Tensor], bound: float = 1.0):
    """Clipped-STE wrapper: the gradient is cancelled where ``|x| > bound``."""
    return ste(forward, clip_mask(bound))


def resolve_ste_mask(
    mode: Union[str, Mask, None], clip_bound: float = 1.0
) -> Optional[Mask]:
    """Map an STE mode name (``'identity'`` | ``'clip'``) or a custom mask
    callable to a backward mask."""
    if mode is None or mode == STE_IDENTITY:
        return None
    if mode == STE_CLIP:
        return clip_mask(clip_bound)
    if callable(mode):
        return mode
    raise ValueError(f"unknown STE mode: {mode!r}")


_round_ste = ste_identity(torch.round)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """``round`` (half to even, as ``jnp.round``) with the identity STE: the
    atom under the DoReFa, linear and log grids."""
    return _round_ste(x)
