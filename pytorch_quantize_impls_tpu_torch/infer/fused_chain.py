"""Fused int8-chained inference for the DoReFa ResNet-20.

Counterpart of the ResNet half of
``pytorch_quantize_impls_tpu/infer/fused_chain.py``. Each block conv
consumes a_bits codes ``c`` in ``[0, n_a]`` and the conv1 -> conv2 boundary
(BatchNorm, relu, the [0, 1] clip and the next input's quantization) folds
into one per-channel affine + round + clip on the raw int32 accumulator:

    code = clip(round(a1 * y + b1), 0, n_a)
    a1 = gamma1 / s1 / (n_w n_a) * n_a,  b1 = (beta1 - gamma1 mu1 / s1) * n_a

with ``s = sqrt(var + eps)``; conv2's BatchNorm folds into a real-valued
affine ``a2 * y + b2``. Both run in the epilogue of the int8 conv K5
(``kernels.int8_conv``), so codes cross the block as int8. The real residual
stream materializes once per block (the junction relu); the stem and the 1x1
projections are float convolutions on it (``conv2d_nhwc``, float32, no
TF32), as the JAX package leaves them to XLA.

The fold reads the JAX model's fixed [0, 1] clip. A PACT model (learnable
clip ``alpha``, config ``dorefa_resnet20``) raises in
:func:`export_fused_resnet20`: the JAX package's export ignores ``alpha`` and
its fused logits drift from the model's (ROADMAP §3).

The binary chains (``export_fused_chain``, ``export_fused_lenet``) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc, conv_pads
from pytorch_quantize_impls_tpu_torch.kernels.int8_conv import int8_conv2d
from pytorch_quantize_impls_tpu_torch.ops.dorefa import dorefa_weight


@dataclasses.dataclass(frozen=True)
class FusedResBlock:
    w1: torch.Tensor  # int8 centered codes 2c - n_w, flat (cin*3*3, cout), (cin, kh, kw) rows
    a1: torch.Tensor  # codes epilogue: code = clip(round(a1 * y + b1), 0, n_a)
    b1: torch.Tensor
    w2: torch.Tensor  # int8 centered codes, flat
    a2: torch.Tensor  # real epilogue: a2 * y + b2
    b2: torch.Tensor
    wp: Optional[torch.Tensor] = None  # float OIHW 1x1 projection (on the real stream)
    ap: Optional[torch.Tensor] = None  # projection BatchNorm affine
    bp: Optional[torch.Tensor] = None
    strides: Tuple[int, int] = (1, 1)


@dataclasses.dataclass(frozen=True)
class FusedResNet:
    stem_w: torch.Tensor  # float OIHW
    stem_a: torch.Tensor  # stem BatchNorm affine: r = relu(stem_a * y + stem_b)
    stem_b: torch.Tensor
    blocks: Tuple[FusedResBlock, ...]
    head_w: torch.Tensor  # (features, classes)
    head_b: torch.Tensor
    n_a: int = 15


def _bn_affine(bn, eps: float = 1e-5):
    """(gamma, beta, mean, s = sqrt(var + eps)) in float32."""
    return (
        bn.weight.detach().float(), bn.bias.detach().float(),
        bn.running_mean.detach().float(), torch.sqrt(bn.running_var.detach().float() + eps),
    )


@torch.no_grad()
def export_fused_resnet20(model) -> FusedResNet:
    """Build a :class:`FusedResNet` from a ``DorefaResNet20`` with k-bit
    block-conv inputs (``a_bits >= 1``) and the fixed clip, on the model's
    device."""
    if not model.a_bits:
        raise ValueError("fused resnet needs a_bits >= 1")
    if model.a_quant != "fixed":
        raise NotImplementedError(
            f"fused resnet needs a_quant='fixed', got {model.a_quant!r}: the fold assumes the "
            "fixed [0, 1] clip, and the JAX export would silently drop PACT's alpha"
        )
    n_w = 2**model.w_bits - 1
    n_a = 2**model.a_bits - 1
    inv_wa = 1.0 / (n_w * n_a)

    def flat_codes(conv):
        # 2c - n_w, exact; rows in (cin, kh, kw) order, as the packed layout
        wq = dorefa_weight(conv.weight.detach().float(), model.w_bits)
        return torch.round(wq * n_w).to(torch.int8).reshape(wq.shape[0], -1).T.contiguous()

    g, b, mu, s = _bn_affine(model.bn_stem)
    blocks = []
    for blk in model.blocks():
        g1, b1, m1, s1 = _bn_affine(blk.bn1)
        g2, b2, m2, s2 = _bn_affine(blk.bn2)
        wp = ap = bp = None
        if blk.proj is not None:
            gp, bpb, mp, sp = _bn_affine(blk.bn_proj)
            wp, ap, bp = blk.proj.weight.detach().float(), gp / sp, bpb - gp * mp / sp
        blocks.append(FusedResBlock(
            w1=flat_codes(blk.conv1.conv), a1=(g1 / s1) * inv_wa * n_a,
            b1=(b1 - g1 * m1 / s1) * n_a,
            w2=flat_codes(blk.conv2.conv), a2=(g2 / s2) * inv_wa, b2=b2 - g2 * m2 / s2,
            wp=wp, ap=ap, bp=bp, strides=blk.conv1.conv.strides,
        ))
    return FusedResNet(
        stem_w=model.stem.weight.detach().float(), stem_a=g / s, stem_b=b - g * mu / s,
        blocks=tuple(blocks),
        head_w=model.head.weight.detach().float().T.contiguous(),
        head_b=model.head.bias.detach().float(), n_a=n_a,
    )


def _quant_codes(h: torch.Tensor, n_a: int) -> torch.Tensor:
    return torch.clamp(torch.round(h), 0, n_a).to(torch.int8)


def _block_conv(c, w, strides, epilogue, a, b, n_a):
    pads = conv_pads("SAME", c.shape[1:3], (3, 3), strides)
    return int8_conv2d(c, w, (3, 3), strides, pads, epilogue, a, b, n_a)


@torch.no_grad()
def fused_resnet_apply(net: FusedResNet, x: torch.Tensor) -> torch.Tensor:
    """Forward through the fused DoReFa ResNet; ``x``: NHWC real images.

    Carries the real residual stream ``r`` and the int8 codes ``c =
    clip(round(n_a r), 0, n_a)`` the block convs consume (r >= 0 after the
    relu, so the [0, 1] clip is the [0, n_a] clip)."""
    n_a = net.n_a
    y = conv2d_nhwc(x.to(torch.float32), net.stem_w, (1, 1), "SAME")
    r = torch.relu(y * net.stem_a + net.stem_b)
    c = _quant_codes(r * float(n_a), n_a)
    for blk in net.blocks:
        c1 = _block_conv(c, blk.w1, blk.strides, "codes", blk.a1, blk.b1, n_a)
        y2r = _block_conv(c1, blk.w2, (1, 1), "affine", blk.a2, blk.b2, n_a)
        if blk.wp is not None:
            resr = conv2d_nhwc(r, blk.wp, blk.strides, "SAME") * blk.ap + blk.bp
        else:
            resr = r
        r = torch.relu(y2r + resr)
        c = _quant_codes(r * float(n_a), n_a)
    return r.mean(dim=(1, 2)) @ net.head_w + net.head_b
