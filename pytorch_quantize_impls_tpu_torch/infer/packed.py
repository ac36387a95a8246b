"""Packed-model export and execution for the binary, xnor, dorefa, log and
lin schemes.

Counterpart of ``pytorch_quantize_impls_tpu/infer/packed.py``:

    packed = pack_model(model)                  # once, from the master weights
    ready  = prepare(packed)                    # decode hot buffers once
    y      = packed_apply(model, ready, x)      # every quantized layer packed

Records are keyed by the module path as a tuple, the same tuple flax gives
(``("conv1", "conv")``), and ``save_packed``/``load_packed`` write and read
the JAX package's ``.npz`` artifact (uint32 words, the same JSON meta), so
artifacts move between the two packages in both directions.

Execution plan:

| scheme, inputs               | prepared? | path                                          |
|------------------------------|-----------|-----------------------------------------------|
| binary/xnor, a_bits=1        | no        | ``binary_gemm`` (K1) on the packed words      |
| binary/xnor, a_bits=1        | yes       | ``int8_gemm`` (K3) on ±1 decoded by prepare   |
| dorefa, 1 <= a_bits <= 7     | no        | ``dorefa_gemm`` (K6) on the packed codes      |
| dorefa, 1 <= a_bits <= 7     | yes       | ``int8_gemm`` (K3) on centered codes (K7)     |
| log (a_bits=0)               | no        | ``shift_gemm`` (K8) on the codes, bf16(x)     |
| log (a_bits=0)               | yes       | float matmul on bf16 ±2^e decoded by K9       |
| other real inputs (a_bits=0) | either    | float matmul on decoded ±1 / f32 grid weights |
| conv, binary/xnor/dorefa with quantized inputs | either | ``packed_conv2d``: decode per call, K5 conv |
| conv, real inputs (log: K9 decode) | either | float conv on the decoded weights     |

As in the JAX package, the quantized-input conv path decodes its weights on
every call and does not read ``prepare()``'s buffer; a real-input conv reads
it when it is there (log: K9 on every unprepared call). The unprepared log
dense layer rounds its input to bf16 and the prepared one does not, as in
the JAX package. ``pack_model`` refuses log and lin layers with quantized
inputs (``quantize_input=True``): the JAX package's packed paths ignore that
quantizer (ROADMAP section 3). The ternary scheme, and packing xnor layers
(the port has none), raise ``NotImplementedError`` (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
from pytorch_quantize_impls_tpu_torch.kernels.conv import (
    PackedConv,
    conv2d_nhwc,
    packed_conv2d,
)
from pytorch_quantize_impls_tpu_torch.nn.base import (
    QuantConv,
    QuantDense,
    intercept_quant_layers,
)
from pytorch_quantize_impls_tpu_torch.ops import pack as packlib
from pytorch_quantize_impls_tpu_torch.ops.dorefa import dorefa_activation, dorefa_weight
from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device

_PORTED_SCHEMES = ("binary", "xnor", "dorefa", "log", "lin")


@dataclasses.dataclass(frozen=True)
class PackedLayer:
    packed: torch.Tensor  # grouped-planar packed words (int32 bit patterns)
    alpha: Optional[torch.Tensor] = None  # xnor per-out-channel scale
    # prepare(): ±1 int8 (K, N), centered int8 codes (Kp, N), f32 grid (K, N)
    # or bf16 ±2^e (K, N)
    decoded: Optional[torch.Tensor] = None
    kind: str = "dense"  # dense|conv
    scheme: str = "binary"
    w_bits: int = 1
    a_bits: int = 0
    fsr: float = 0.0
    # the JAX kernel's shape: (in, out) dense, HWIO conv
    kernel_shape: Tuple[int, ...] = ()


PackedModel = Dict[Tuple[str, ...], PackedLayer]


def _not_ported(scheme: str):
    return NotImplementedError(
        f"packed scheme {scheme!r} is not ported yet (ROADMAP queue 1, item 10)"
    )


def _pack_layer(m) -> PackedLayer:
    if m.scheme not in ("binary", "dorefa", "log", "lin"):
        raise _not_ported(m.scheme)
    if m.scheme in ("log", "lin") and m.a_bits > 0:
        raise NotImplementedError(
            f"a {m.scheme} layer with quantize_input=True (a_bits={m.a_bits}) does not pack: "
            "the packed paths ignore the input quantizer, as the JAX package's do, so "
            "they would compute another function (ROADMAP section 3)"
        )
    w = m.weight.detach()
    if isinstance(m, QuantConv):
        cout, cin, kh, kw = w.shape
        w2d = w.reshape(cout, -1).T  # (cin*kh*kw, cout) in (cin, kh, kw) order
        kind, kernel_shape = "conv", (kh, kw, cin, cout)
    else:
        w2d = w.T
        kind, kernel_shape = "dense", tuple(w2d.shape)
    if m.scheme == "dorefa":
        packed = pm.pack_dorefa_weights(dorefa_weight(w2d, m.w_bits), m.w_bits)
    elif m.scheme == "log":
        packed = sm.pack_log_weights(w2d, m.fsr, m.w_bits)
    elif m.scheme == "lin":
        # signed grid codes round(w / step) clipped to ±2^bits, offset into
        # [0, 2^(bits+1)]; 8-bit planar fields (bits <= 6)
        step = 2.0 ** (m.fsr - m.w_bits)
        c = torch.clamp(torch.round(w2d / step), -(2**m.w_bits), 2**m.w_bits)
        packed = packlib.pack_bitplanes((c + 2**m.w_bits).to(torch.int32), 8)
    else:
        packed = bg.pack_binary_weights(w2d)
    return PackedLayer(
        packed=packed,
        kind=kind,
        scheme=m.scheme,
        w_bits=m.w_bits,
        a_bits=m.a_bits,
        fsr=m.fsr,
        kernel_shape=kernel_shape,
    )


def _quant_layers(model: nn.Module):
    for name, m in model.named_modules():
        if isinstance(m, (QuantDense, QuantConv)) and m.scheme != "none":
            yield tuple(name.split(".")), m


@torch.no_grad()
def pack_model(model: nn.Module) -> PackedModel:
    """Pack every quantized layer's master weight, on the weight's device."""
    return {path: _pack_layer(m) for path, m in _quant_layers(model)}


def _decode_weights(rec: PackedLayer) -> torch.Tensor:
    """Packed codes -> execution-ready weights (K, N): ±1 int8 for
    binary/xnor; the f32 grids ``(2c - n) / n`` for dorefa (not bf16-exact)
    and ``c * step`` for lin, unpacked in plain PyTorch as the JAX package
    does; bf16 ``±2^e`` for log, by K9, bit-identical to the JAX package's
    plain decode."""
    if rec.scheme not in _PORTED_SCHEMES:
        raise _not_ported(rec.scheme)
    k2d = int(np.prod(rec.kernel_shape[:-1]))
    if rec.scheme == "dorefa":
        c = packlib.unpack_bitplanes(rec.packed, rec.w_bits, k2d)
        n = 2**rec.w_bits - 1
        return (2.0 * c.to(torch.float32) - n) / n
    if rec.scheme == "log":
        return sm.decode_log_weights(rec.packed, fsr=rec.fsr, bits=rec.w_bits)[:k2d]
    if rec.scheme == "lin":
        c = packlib.unpack_bitplanes(rec.packed, 8, k2d) - 2**rec.w_bits
        return c.to(torch.float32) * 2.0 ** (rec.fsr - rec.w_bits)
    return bg.decode_binary_weights(rec.packed)[:k2d]


def _int_codes(rec: PackedLayer) -> bool:
    """True where the layer runs the integer-code GEMM: dorefa with inputs
    quantized to 1..7 bits (codes that fit int8)."""
    return rec.scheme == "dorefa" and 1 <= rec.a_bits <= 7


def _decode_execution(rec: PackedLayer) -> torch.Tensor:
    """The buffer the layer's hot path consumes: centered int8 codes (K7)
    for the integer-code GEMM, decoded values otherwise."""
    if _int_codes(rec):
        return pm.decode_dorefa_weights(rec.packed, w_bits=rec.w_bits)
    return _decode_weights(rec)


def prepare(packed: PackedModel) -> PackedModel:
    """Decode every layer's execution buffer once (weight-stationary)."""
    return {
        path: dataclasses.replace(rec, decoded=_decode_execution(rec))
        for path, rec in packed.items()
    }


def _dense_forward(rec: PackedLayer, x: torch.Tensor, bias) -> torch.Tensor:
    # the GEMM kernels take (M, K): fold any leading batch/sequence dims
    lead = x.shape[:-1]
    y = _dense_forward_2d(rec, x.reshape(-1, x.shape[-1]), bias)
    return y.reshape(*lead, y.shape[-1])


def _dense_forward_2d(rec: PackedLayer, x: torch.Tensor, bias) -> torch.Tensor:
    if rec.scheme not in _PORTED_SCHEMES:
        raise _not_ported(rec.scheme)
    if rec.scheme in ("binary", "xnor") and rec.a_bits == 1:
        xi = bg.binarize_to_int8(x)
        if rec.decoded is not None:
            y = bg.binary_gemm_decoded(xi, rec.decoded, rec.alpha)
        else:
            y = bg.binary_gemm(xi, rec.packed, rec.alpha)
    elif _int_codes(rec):
        codes = pm.dorefa_act_to_int8(dorefa_activation(x, rec.a_bits), rec.a_bits)
        if rec.decoded is not None:
            y = pm.dorefa_gemm_decoded(codes, rec.decoded, w_bits=rec.w_bits, a_bits=rec.a_bits)
        else:
            y = pm.dorefa_gemm(codes, rec.packed, w_bits=rec.w_bits, a_bits=rec.a_bits)
    elif rec.scheme == "log" and rec.decoded is None:
        y = sm.shift_gemm(x, rec.packed, fsr=rec.fsr, bits=rec.w_bits)
    else:
        # real inputs: decoded weights at the input dtype
        w = rec.decoded if rec.decoded is not None else _decode_weights(rec)
        y = (x @ w.to(x.dtype)).to(torch.float32)
        if rec.alpha is not None:
            y = y * rec.alpha[None, :]
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def _conv_forward(m: QuantConv, rec: PackedLayer, x: torch.Tensor, bias) -> torch.Tensor:
    if rec.scheme not in _PORTED_SCHEMES:
        raise _not_ported(rec.scheme)
    kh, kw, cin, cout = rec.kernel_shape
    if rec.scheme in ("binary", "xnor", "dorefa") and rec.a_bits >= 1:
        pc = PackedConv(
            scheme=rec.scheme,
            packed=rec.packed,
            kernel_size=(kh, kw),
            cin=cin,
            cout=cout,
            alpha=rec.alpha,
            w_bits=rec.w_bits,
            a_bits=rec.a_bits,
            fsr=rec.fsr,
        )
        xin = dorefa_activation(x, rec.a_bits) if rec.scheme == "dorefa" else x
        y = packed_conv2d(xin, pc, strides=m.strides, padding=m.padding)
    else:
        # real inputs: decoded weights, float conv at the input dtype
        w2d = rec.decoded if rec.decoded is not None else _decode_weights(rec)
        w4d = w2d.T.reshape(cout, cin, kh, kw).to(x.dtype)
        y = conv2d_nhwc(x, w4d, m.strides, m.padding)
        if rec.alpha is not None:
            y = y * rec.alpha
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def packed_apply(model: nn.Module, packed: PackedModel, *args, **kwargs):
    """Eval forward ``model(*args, **kwargs)`` with every packed quantized
    layer dispatched to its packed path; other modules (BatchNorm, pooling,
    LayerNorm, attention) run as they are. The model must be in eval mode.
    A decode-mode LM takes ``(tokens, cache)`` and returns what it returns,
    ``(logits, cache)``."""
    if model.training:
        raise ValueError("packed_apply runs the eval forward: call model.eval() first")
    paths = {m: path for path, m in _quant_layers(model)}

    def interceptor(m, x, fake_quant_forward):
        rec = packed.get(paths.get(m))
        if rec is None:
            return fake_quant_forward(x)
        if isinstance(m, QuantConv):
            return _conv_forward(m, rec, x, m.bias)
        return _dense_forward(rec, x, m.bias)

    with torch.no_grad(), intercept_quant_layers(interceptor):
        return model(*args, **kwargs)


# --- inference-only export artifact ---------------------------------------


def save_packed(path: str, packed: PackedModel) -> None:
    """Write the packed model artifact: npz arrays (uint32 words) + json meta."""
    meta = {}
    arrays = {}
    for i, (mpath, rec) in enumerate(sorted(packed.items())):
        key = f"layer{i}"
        meta[key] = {
            "path": list(mpath),
            "kind": rec.kind,
            "scheme": rec.scheme,
            "w_bits": rec.w_bits,
            "a_bits": rec.a_bits,
            "fsr": rec.fsr,
            "kernel_shape": list(rec.kernel_shape),
            "has_alpha": rec.alpha is not None,
        }
        arrays[f"{key}_packed"] = rec.packed.cpu().numpy().view(np.uint32)
        if rec.alpha is not None:
            arrays[f"{key}_alpha"] = rec.alpha.cpu().numpy()
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_packed(path: str, device="cuda") -> PackedModel:
    """Read an artifact written by either package onto ``device`` (the card
    unless ``device="cpu"``; raises without a GPU)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        out: PackedModel = {}
        for key, m in meta.items():
            words = data[f"{key}_packed"].astype(np.uint32).view(np.int32)
            out[tuple(m["path"])] = PackedLayer(
                packed=torch.from_numpy(words).to(device),
                alpha=(
                    torch.from_numpy(data[f"{key}_alpha"]).to(device)
                    if m["has_alpha"]
                    else None
                ),
                kind=m["kind"],
                scheme=m["scheme"],
                w_bits=m["w_bits"],
                a_bits=m["a_bits"],
                fsr=m["fsr"],
                kernel_shape=tuple(m["kernel_shape"]),
            )
    return out
