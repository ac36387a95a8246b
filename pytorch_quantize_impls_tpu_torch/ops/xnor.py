"""XNOR-Net scaling math (arXiv:1603.05279).

Counterpart of ``pytorch_quantize_impls_tpu/ops/xnor.py``:

* the per-output-channel scale ``alpha_c = mean(|W_c|)``, so ``W ~ alpha_c
  sign(W)``;
* the input scale map ``K = conv(mean_c |I|, all-ones / (kh kw))`` of the
  full-XNOR mode (binarized inputs), stride 1, SAME.

alpha stays differentiable through ``|.|`` and the mean: ``xnor_quantize``
is the plain product ``alpha(W) * sign_ste_clip(W)`` and autograd gives the
paper's gradient (the 1/n term and alpha times the STE term). Only the sign
carries a straight-through estimator.

Layouts are the JAX package's at these functions: ``channel_axis`` defaults
to the last axis (HWIO, (in, out)), and ``xnor_input_scale_map`` takes NHWC.
The port's layers keep their weights in PyTorch's layouts, (out, in) and
OIHW, and pass ``channel_axis=0`` (:func:`out_channel_alpha`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from pytorch_quantize_impls_tpu_torch.ops.common import clip_mask, safe_sign, ste

#: Sign binarization with the clipped STE (``g * 1[|w| <= 1]``): the XNOR
#: layers' weight quantizer, so master weights get a gradient through the
#: binarization and not only through alpha's mean(|w|).
sign_ste_clip = ste(safe_sign, clip_mask(1.0))


def xnor_alpha(w: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """Per-output-channel L1 scale ``alpha_c = mean over the other axes of
    |W|``, keeping the reduced axes. ``|w|`` is ``w * sign(w)`` with
    ``sign(0) = +1``: the same values, and the gradient +1 at 0 that
    ``jnp.abs`` has (``torch.abs`` gives 0 there)."""
    axis = channel_axis % w.dim()
    return (w * safe_sign(w.detach())).mean(
        dim=tuple(i for i in range(w.dim()) if i != axis), keepdim=True)


def out_channel_alpha(w: torch.Tensor) -> torch.Tensor:
    """alpha of a port weight, (out, in) or OIHW, as a (out,) vector: the
    output scale of the XNOR layers and what ``infer.pack_model`` and
    ``infer.export_fused_chain`` store, one reduction for all three."""
    return xnor_alpha(w, channel_axis=0).reshape(-1)


def xnor_quantize(w: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """``alpha_c sign(W)`` with the clipped STE on the sign and a
    differentiable alpha."""
    return xnor_alpha(w, channel_axis) * sign_ste_clip(w)


def xnor_input_scale_map(
    x: torch.Tensor, kernel_size: Sequence[int], *, channel_axis: int = -1
) -> torch.Tensor:
    """Input scale map ``K`` of a full-XNOR conv (paper section 3.2) on NHWC
    ``x``: ``A = mean over channels |x|``, then a stride-1 SAME conv with the
    ``1 / (kh kw)`` kernel, in float32 without TF32 (the JAX package asks
    for HIGHEST precision). Returns (N, H, W, 1) at x's dtype; a narrower
    one (bf16) takes the mean in float32, as ``jnp.mean`` does."""
    # imported here: kernels imports ops (the bit packing)
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc

    acc = torch.promote_types(x.dtype, torch.float32)
    a = x.abs().to(acc).mean(dim=channel_axis, keepdim=True).to(x.dtype)
    kh, kw = kernel_size
    kern = torch.full((1, 1, kh, kw), 1.0 / (kh * kw), dtype=a.dtype, device=a.device)
    return conv2d_nhwc(a, kern, (1, 1), "SAME")
