"""BinaryConnect / BNN sign binarization, deterministic and stochastic.

Counterpart of ``pytorch_quantize_impls_tpu/ops/binary.py``. The stochastic
variant takes ``+1`` with probability ``hard_sigmoid(x)``: the primitive
takes the uniform draw ``u`` as an argument, as JAX's
``_binary_stoch_prim(x, u)`` does, so the two packages can be held bit for
bit on a shared ``u``; :func:`binary_connect_stoch` draws ``u`` from a
``torch.Generator`` on ``x``'s device. The draw is a constant in the
backward pass. A :class:`BlockDraw` in place of the generator draws a whole
tensor's uniforms and hands out one block of them: a shard's draw on a
mesh, the same numbers as the unsharded tensor's at the same place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple, Union

import torch

from pytorch_quantize_impls_tpu_torch.ops.common import (
    STE_CLIP,
    STE_IDENTITY,
    hard_sigmoid,
    resolve_ste_mask,
    safe_sign,
    ste,
)


def binary_connect_det(
    x: torch.Tensor,
    *,
    ste_mode: Union[str, Callable[[torch.Tensor], torch.Tensor]] = STE_CLIP,
    clip_bound: float = 1.0,
) -> torch.Tensor:
    """Deterministic BinaryConnect: ``sign(x)`` with ``sign(0) -> +1``.

    Backward is the straight-through estimator; ``ste_mode='clip'`` (the
    default) cancels the gradient where ``|x| > clip_bound``,
    ``'identity'`` passes it unchanged.
    """
    return ste(safe_sign, resolve_ste_mask(ste_mode, clip_bound))(x)


class _BinaryStoch(torch.autograd.Function):
    """``where(u < hard_sigmoid(x), 1, -1)``; backward ``g * 1[|x| <= 1]``
    (``clip=True``) or ``g``, and nothing for ``u``."""

    @staticmethod
    def forward(ctx, x, u, clip):
        ctx.clip = clip
        if clip:
            ctx.save_for_backward(x)
        return torch.where(u < hard_sigmoid(x), 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.clip:
            return g, None, None
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype), None, None


def binary_stoch_prim(x: torch.Tensor, u: torch.Tensor, *, ste_mode: str = STE_CLIP):
    """The stochastic binarizer on a given draw ``u`` ~ U[0, 1) of x's shape."""
    if ste_mode not in (STE_CLIP, STE_IDENTITY):
        raise ValueError(f"unknown STE mode: {ste_mode!r}")
    return _BinaryStoch.apply(x, u, ste_mode == STE_CLIP)


@dataclass(frozen=True)
class BlockDraw:
    """A generator that draws the whole tensor of ``shape`` and keeps the
    block of ``x``'s extent along ``dim`` from index ``start``: where ``x``
    is a shard of that tensor (a column shard's kernel, a data rank's rows
    of the batch), ``uniform_like(x, BlockDraw(...))`` gives the numbers
    the whole tensor's draw has there, and moves the generator as far."""

    generator: torch.Generator
    shape: Tuple[int, ...]
    dim: int
    start: int


def uniform_like(x: torch.Tensor, generator: Union[torch.Generator, BlockDraw]) -> torch.Tensor:
    """U[0, 1) of x's shape, drawn in float32 on x's device from ``generator``
    (which must live there), cast to x's dtype. A :class:`BlockDraw` draws
    its whole shape and returns x's block of it."""
    if isinstance(generator, BlockDraw):
        shape = tuple(generator.shape)
        block = list(shape)
        block[generator.dim] = x.shape[generator.dim]
        if tuple(block) != tuple(x.shape) or generator.start + block[generator.dim] > \
                shape[generator.dim]:
            raise ValueError(f"a block of shape {tuple(x.shape)} from {generator.start} on axis "
                             f"{generator.dim} does not lie in the draw's shape {shape}")
        u = torch.rand(shape, generator=generator.generator, device=x.device,
                       dtype=torch.float32)
        return u.narrow(generator.dim, generator.start, block[generator.dim]).to(x.dtype)
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return u.to(x.dtype)


def binary_connect_stoch(
    x: torch.Tensor, generator: torch.Generator, *, ste_mode: str = STE_CLIP
) -> torch.Tensor:
    """Stochastic BinaryConnect: ``P(+1) = hard_sigmoid(x)``, a fresh draw
    per call from ``generator``; the same STE as the deterministic variant."""
    return binary_stoch_prim(x, uniform_like(x, generator), ste_mode=ste_mode)


def binary_tanh(x: torch.Tensor) -> torch.Tensor:
    """BNN activation binarization: ``sign(x)`` with the hard-tanh STE,
    gradient ``g * 1[|x| <= 1]`` (arXiv:1602.02830 eq. 4)."""
    return binary_connect_det(x, ste_mode=STE_CLIP)


def binary_connect(deterministic: bool = True, *, ste_mode: str = STE_CLIP):
    """The configured quantizer: ``x -> sign(x)``, or ``(x, generator) ->``
    a stochastic draw."""
    if deterministic:
        return lambda x: binary_connect_det(x, ste_mode=ste_mode)
    return lambda x, generator: binary_connect_stoch(x, generator, ste_mode=ste_mode)
