"""Fused int8-chained inference: the binary chains (the XNOR convnet and
BNN LeNet) and the DoReFa ResNet-20.

Counterpart of ``pytorch_quantize_impls_tpu/infer/fused_chain.py``.

**Binary chains** (``export_fused_chain``, ``export_fused_lenet``,
``fused_apply``). Eval BatchNorm is a per-channel affine ``z = gamma
(alpha y - mu) / s + beta`` on the raw sum ``y`` (``s = sqrt(var + eps)``,
alpha the XNOR scale or 1), and the next layer binarizes ``sign(z)``; so
the next layer's input code is a per-channel threshold on ``y``:

    code = hi  if y >= t,  else lo
    t    = (mu - beta s / gamma) / alpha
    (hi, lo) = (+1, -1) if gamma > 0;  (-1, +1) if gamma < 0;  sign(beta) twice if gamma = 0

(gamma = 0 and alpha = 0 set ``t = -inf`` and a constant code). Max pooling
commutes with the monotone sign, the gamma < 0 flip included, so it runs on
the int8 codes, and activations cross every hidden boundary as +-1 int8.
The code-input convs run K5 (``kernels.int8_conv``) with the ``threshold``
epilogue, or ``affine`` on the last stage (BatchNorm and alpha folded into
``scale * y + bias``); code-input dense stages run K3 (``int8_gemm``) on the
flattened codes and the threshold after it; real-input stages (the first
conv) a float conv (``conv2d_nhwc``, float32, no TF32) on the input rounded
to ``first_dtype``, then the threshold; the head a float matmul, then alpha,
then the bias. Two deviations from the fake-quant model, both at a measure-
zero boundary: the threshold is another float expression than BatchNorm's,
and for gamma < 0 a ``y`` exactly on ``t`` codes -1 where the fake path's
``sign(0) = +1`` gives +1 (ROADMAP section 3); the port matches the JAX
chain there. The XNOR net's K map must be off (``use_input_scale_map=False``):
K depends on real input magnitudes the code chain never holds.

**DoReFa ResNet-20** (``export_fused_resnet20``, ``fused_resnet_apply``).
Each block conv consumes a_bits codes ``c`` in ``[0, n_a]`` and the conv1
-> conv2 boundary (BatchNorm, relu, the [0, 1] clip and the next input's
quantization) folds into one per-channel affine + round + clip on the raw
int32 accumulator:

    code = clip(round(a1 * y + b1), 0, n_a)
    a1 = gamma1 / s1 / (n_w n_a) * n_a,  b1 = (beta1 - gamma1 mu1 / s1) * n_a

conv2's BatchNorm folds into a real-valued affine ``a2 * y + b2``. Both run
in K5's epilogue (``codes``, ``affine``), so codes cross the block as int8.
The real residual stream materializes once per block (the junction relu);
the stem and the 1x1 projections are float convolutions on it
(``conv2d_nhwc``, float32, no TF32), as the JAX package leaves them to XLA.
The fold reads the JAX model's fixed [0, 1] clip. A PACT model (learnable
clip ``alpha``, config ``dorefa_resnet20``) raises in
:func:`export_fused_resnet20`: the JAX package's export ignores ``alpha`` and
its fused logits drift from the model's (ROADMAP section 3). So does a
one-bit model: its weights are ``E|W| sign(W)``, which the codes of the fold
do not hold.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import torch

from pytorch_quantize_impls_tpu_torch.infer.packed import refuse_act_scale
from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc, conv_pads
from pytorch_quantize_impls_tpu_torch.kernels.int8_conv import int8_conv2d, threshold_codes
from pytorch_quantize_impls_tpu_torch.kernels.int8_matmul import int8_gemm
from pytorch_quantize_impls_tpu_torch.models.lenet import max_pool_nhwc
from pytorch_quantize_impls_tpu_torch.ops.dorefa import dorefa_weight
from pytorch_quantize_impls_tpu_torch.ops.xnor import out_channel_alpha


@dataclasses.dataclass(frozen=True)
class FusedStage:
    """One conv or dense stage with its boundary folded into the epilogue."""

    # code-input conv: int8 +-1, flat (cin * kh * kw, cout) in (cin, kh, kw)
    # order (K5's layout); dense (always on codes, with a threshold): int8
    # +-1 (in, out); real-input conv: OIHW in first_dtype (+-1, or the float
    # kernel of fp32_first_last)
    w: torch.Tensor
    # threshold epilogue (hidden stages): per-channel float32 threshold, and
    # the codes (hi, lo) as float32 rows, K5's (2, cout) argument
    thr: Optional[torch.Tensor] = None
    codes: Optional[torch.Tensor] = None
    # real epilogue (last stage): z = y * scale + bias (BatchNorm and alpha)
    scale: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    in_codes: bool = True
    pool: bool = False
    strides: Tuple[int, int] = (1, 1)
    padding: str = "SAME"
    dense: bool = False
    kernel_size: Tuple[int, int] = (3, 3)


@dataclasses.dataclass(frozen=True)
class FusedHead:
    w: torch.Tensor  # (features_in, classes) float32: +-1 codes or the float kernel
    alpha: Optional[torch.Tensor] = None  # xnor per-class scale
    bias: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class FusedChain:
    stages: Tuple[FusedStage, ...]
    head: FusedHead


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


def _binarize_epilogue(gamma, beta, mean, s, alpha):
    """(thr, hi, lo) for ``code = sign(BN(alpha y))`` as a threshold on the
    raw ``y``; hi and lo int8. The JAX package's float expressions, in its
    order."""
    safe_g = torch.where(gamma == 0, 1.0, gamma)
    safe_a = torch.where(alpha == 0, 1.0, alpha)
    t = (mean - beta * s / safe_g) / safe_a
    sign_b = torch.where(beta >= 0, 1, -1)
    hi = torch.where(gamma > 0, 1, torch.where(gamma < 0, -1, sign_b))
    lo = torch.where(gamma > 0, -1, torch.where(gamma < 0, 1, sign_b))
    # gamma == 0: the code is the constant sign(beta); the threshold is moot
    t = torch.where(gamma == 0, -torch.inf, t)
    # alpha == 0 (an all-zero kernel channel): alpha sign(k) = 0, so the
    # BatchNorm input is 0 and the code is the constant sign(beta - gamma mu /
    # s); the +-1 code plane is all +1 there, so y itself is not 0
    const_code = torch.where(beta - gamma * mean / s >= 0, 1, -1)
    hi = torch.where(alpha == 0, const_code, hi)
    lo = torch.where(alpha == 0, const_code, lo)
    t = torch.where(alpha == 0, -torch.inf, t)
    return t.to(torch.float32), hi.to(torch.int8), lo.to(torch.int8)


def _threshold_stage(w, bn, alpha=None, **kw) -> FusedStage:
    """A stage whose boundary is BatchNorm ``bn`` and the next sign, for a
    sum scaled by ``alpha`` (None: 1)."""
    gamma, beta, mean, s = _bn_affine(bn)
    alpha = torch.ones_like(gamma) if alpha is None else alpha
    thr, hi, lo = _binarize_epilogue(gamma, beta, mean, s, alpha)
    return FusedStage(w=w, thr=thr, codes=torch.stack((hi, lo)).to(torch.float32), **kw)


def _sign_codes(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= 0, 1, -1).to(torch.int8)


def _flat(codes_oihw: torch.Tensor) -> torch.Tensor:
    """OIHW -> flat (cin * kh * kw, cout), K5's layout."""
    return codes_oihw.reshape(codes_oihw.shape[0], -1).T.contiguous()


@torch.no_grad()
def export_fused_chain(model, *, first_dtype=torch.bfloat16) -> FusedChain:
    """Build a :class:`FusedChain` from an ``XNORConvNet`` in full-XNOR mode
    with the K map off, on the model's device. ``first_dtype``: the first
    (real-input) conv's compute dtype, bfloat16 as in the JAX package; pass
    float32 for parity."""
    if not (model.quantized and model.binarize_inputs):
        raise ValueError("fused chain needs quantized=True, binarize_inputs=True")
    if model.use_input_scale_map:
        raise ValueError(
            "fused chain needs use_input_scale_map=False (K depends on real "
            "input magnitudes the int8 code chain never materializes)"
        )
    n = len(model.widths)
    stages = []
    for i in range(n):
        conv = getattr(model, f"conv{i}")
        if model.fp32_first_last and i == 0:
            kernel = conv.weight.detach().float()
            w = kernel.to(first_dtype)
            alpha = torch.ones(kernel.shape[0], dtype=torch.float32, device=kernel.device)
        else:
            kernel = conv.conv.weight.detach().float()
            alpha = out_channel_alpha(kernel)
            codes = _sign_codes(kernel)
            w = _flat(codes) if i > 0 else codes.to(first_dtype)
        bn = getattr(model, f"bn{i}")
        kw = dict(in_codes=i > 0, pool=i % 2 == 1)
        if i == n - 1:
            # real epilogue: gamma (alpha y - mu) / s + beta
            gamma, beta, mean, s = _bn_affine(bn)
            stages.append(FusedStage(w=w, scale=gamma * alpha / s, bias=beta - gamma * mean / s,
                                     **kw))
        else:
            stages.append(_threshold_stage(w, bn, alpha, **kw))
    if model.fp32_first_last:
        head = FusedHead(w=model.head.weight.detach().float().T.contiguous(),
                         bias=model.head.bias.detach().float())
    else:
        dense = model.head.dense
        k = dense.weight.detach().float()
        head = FusedHead(w=_sign_codes(k).to(torch.float32).T.contiguous(),
                         alpha=out_channel_alpha(k),
                         bias=None if dense.bias is None else dense.bias.detach().float())
    return FusedChain(stages=tuple(stages), head=head)


@torch.no_grad()
def export_fused_lenet(model, *, first_dtype=torch.bfloat16) -> FusedChain:
    """Build a :class:`FusedChain` from a ``BNNLeNet`` (W1A1, VALID 5x5
    convs, a binary dense trunk), on the model's device: conv1 on the real
    pixels with bn1 folded into its threshold and the pool on the codes;
    conv2 (K5, threshold) and its pool; fc1 (K3 on the flattened codes, then
    bn3's threshold); the +-1 head. ``first_dtype`` as in
    :func:`export_fused_chain`. A model with ``act_scale`` raises: its
    thresholds would drop g."""
    refuse_act_scale(model, "export_fused_lenet")
    conv1 = _sign_codes(model.conv1.conv.weight.detach()).to(first_dtype)
    conv2 = _flat(_sign_codes(model.conv2.conv.weight.detach()))
    fc1 = _sign_codes(model.fc1.dense.weight.detach()).T.contiguous()  # (in, out)
    valid = dict(padding="VALID", kernel_size=(5, 5))
    stages = (
        _threshold_stage(conv1, model.bn1, in_codes=False, pool=True, **valid),
        _threshold_stage(conv2, model.bn2, pool=True, **valid),
        _threshold_stage(fc1, model.bn3, dense=True),
    )
    head = FusedHead(w=_sign_codes(model.head.dense.weight.detach()).to(torch.float32).T
                     .contiguous())
    return FusedChain(stages=stages, head=head)


def fused_stage_outputs(chain: FusedChain, x: torch.Tensor) -> Iterator[torch.Tensor]:
    """Each stage's output, after its pool, for NHWC real images ``x``: int8
    codes after a threshold stage, float32 after the last."""
    h = x
    for st in chain.stages:
        if st.dense:  # on the flattened codes: f32 of the exact int32 sum
            h = threshold_codes(int8_gemm(h.reshape(h.shape[0], -1), st.w), st.thr, st.codes)
        elif st.in_codes:
            pads = conv_pads(st.padding, h.shape[1:3], st.kernel_size, st.strides)
            if st.thr is not None:
                h = int8_conv2d(h, st.w, st.kernel_size, st.strides, pads, "threshold",
                                st.thr, st.codes)
            else:
                h = int8_conv2d(h, st.w, st.kernel_size, st.strides, pads, "affine",
                                st.scale, st.bias)
        else:
            # the input rounded to first_dtype, a float32 conv
            y = conv2d_nhwc(h.to(st.w.dtype).to(torch.float32), st.w.to(torch.float32),
                            st.strides, st.padding)
            h = threshold_codes(y, st.thr, st.codes) if st.thr is not None \
                else y * st.scale + st.bias
        if st.pool:
            h = max_pool_nhwc(h)
        yield h


@torch.no_grad()
def fused_apply(chain: FusedChain, x: torch.Tensor) -> torch.Tensor:
    """Forward through the fused binary chain; ``x``: NHWC real images."""
    for h in fused_stage_outputs(chain, x):
        pass
    y = h.reshape(h.shape[0], -1).to(torch.float32) @ chain.head.w
    if chain.head.alpha is not None:
        y = y * chain.head.alpha
    if chain.head.bias is not None:
        y = y + chain.head.bias
    return y


@torch.no_grad()
def export_fused_resnet20(model) -> FusedResNet:
    """Build a :class:`FusedResNet` from a ``DorefaResNet20`` with k-bit
    block-conv inputs (``a_bits >= 1``) and the fixed clip, on the model's
    device."""
    if not (model.quantized and model.a_bits):
        raise ValueError("fused resnet needs quantized=True and a_bits >= 1")
    if model.a_quant != "fixed":
        raise NotImplementedError(
            f"fused resnet needs a_quant='fixed', got {model.a_quant!r}: the fold assumes the "
            "fixed [0, 1] clip, and the JAX export would silently drop PACT's alpha"
        )
    if model.w_bits == 1:
        raise NotImplementedError(
            "fused resnet needs w_bits >= 2: one-bit DoReFa weights are E|W| sign(W), and the "
            "fold's codes round(w_q n_w) keep no scale (ROADMAP section 3)")
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
