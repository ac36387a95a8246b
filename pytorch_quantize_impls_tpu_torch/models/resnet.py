"""DoReFa ResNet-20 for CIFAR-10 (BASELINE config 4: W4A4).

Counterpart of ``pytorch_quantize_impls_tpu/models/resnet.py``: the CIFAR
ResNet-20 (3 stages x 3 basic blocks, widths w/2w/4w) with DoReFa k-bit
weights and k-bit inputs to every block conv. The stem conv, the 1x1
projection shortcuts and the classifier stay float32; the residual stream
stays real-valued. Input is NHWC ``(B, 32, 32, 3)``, as in the JAX package,
and module names match the flax ones (``stem``, ``bn_stem``,
``stage1_block0.conv1.conv``, ``.conv1.act``, ``.bn1``, ``.proj``,
``.bn_proj``, ``head``), so ``utils.bridge`` loads the JAX variables
directly.

``quantized=False`` is the float32 twin of the Δ-accuracy runs: the block
convs are plain ``Conv`` layers named ``conv1``/``conv2``, with no
activation quantizer. ``remat=True`` runs each block under
``torch.utils.checkpoint`` (JAX's ``nn.remat``): its activations are
recomputed in the backward instead of kept, and BatchNorm moves its running
statistics only in the first forward (``models.lenet.recomputing``), so a
step gives the same bits either way.

``dtype`` (``None`` or ``torch.bfloat16``) is the compute dtype of the
stem, every block conv, projection and BatchNorm, as in the JAX model; the
global mean is taken in float32 and rounded to it, as ``jnp.mean`` does,
and the head computes at float32 (or wider), so the logits are float32
under any compute dtype (DoReFa keeps the last layer full precision).
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pytorch_quantize_impls_tpu_torch.models.lenet import BatchNorm, recomputing
from pytorch_quantize_impls_tpu_torch.nn.base import Conv, Dense, mesh_context, sharded_step
from pytorch_quantize_impls_tpu_torch.nn.dorefa import DorefaConv


class BasicBlock(nn.Module):
    """conv1 (stride s) -> bn1 -> relu -> conv2 -> bn2, plus the identity or
    a 1x1 projection (+ BN) shortcut, then relu. Each block conv quantizes
    its own input (``a_bits``), so the residual stream stays real."""

    def __init__(self, in_channels, features, strides=1, *, w_bits=4, a_bits=4, a_quant="fixed",
                 quantized=True, dtype=None):
        super().__init__()
        s = (strides, strides)
        q = dict(bits=w_bits, a_bits=a_bits or None, a_quant=a_quant, use_bias=False, dtype=dtype)

        def conv(cin, stride):
            if quantized:
                return DorefaConv(cin, features, strides=stride, **q)
            return Conv(cin, features, (3, 3), strides=stride, use_bias=False, dtype=dtype)

        self.conv1 = conv(in_channels, s)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = conv(features, (1, 1))
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.proj = self.bn_proj = None
        if strides != 1 or in_channels != features:
            self.proj = Conv(in_channels, features, (1, 1), strides=s, use_bias=False,
                             dtype=dtype)
            self.bn_proj = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.proj is None else self.bn_proj(self.proj(x))
        return torch.relu(y + residual)


@contextlib.contextmanager
def _recomputation(context):
    with recomputing(), sharded_step(context):
        yield


def _remat_contexts():
    """checkpoint's (forward, recomputation) contexts: the recomputation
    leaves BatchNorm's running statistics alone, and runs under the
    forward's sharded step (its mesh context), if any, which the backward's
    thread does not hold."""
    return contextlib.nullcontext(), _recomputation(mesh_context())


class DorefaResNet20(nn.Module):
    def __init__(self, classes: int = 10, w_bits: int = 4, a_bits: int = 4,
                 a_quant: str = "fixed", width: int = 16, quantized: bool = True,
                 remat: bool = False, dtype: Optional[Any] = None):
        super().__init__()
        self.w_bits, self.a_bits, self.a_quant, self.width = w_bits, a_bits, a_quant, width
        self.quantized, self.remat = quantized, remat
        w = width
        self.stem = Conv(3, w, (3, 3), use_bias=False, dtype=dtype)
        self.bn_stem = BatchNorm(w, dtype=dtype)
        cin = w
        for stage, (f, s) in enumerate([(w, 1), (2 * w, 2), (4 * w, 2)]):
            for block in range(3):
                self.add_module(f"stage{stage}_block{block}", BasicBlock(
                    cin, f, s if block == 0 else 1, w_bits=w_bits, a_bits=a_bits, a_quant=a_quant,
                    quantized=quantized, dtype=dtype,
                ))
                cin = f
        self.head = Dense(4 * w, classes)

    def blocks(self):
        return [getattr(self, f"stage{s}_block{b}") for s in range(3) for b in range(3)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn_stem(self.stem(x)))
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks():
            if remat:
                x = checkpoint(blk, x, use_reentrant=False, context_fn=_remat_contexts)
            else:
                x = blk(x)
        # jnp.mean's float32 sum, rounded to x's dtype; the head at float32
        acc = torch.promote_types(x.dtype, torch.float32)
        return self.head(x.to(acc).mean(dim=(1, 2)).to(x.dtype).to(acc))
