"""Packed-model export and execution for the binary, xnor, dorefa, log, lin
and ternary schemes.

Counterpart of ``pytorch_quantize_impls_tpu/infer/packed.py``:

    packed = pack_model(model)                  # once, from the master weights
    ready  = prepare(packed)                    # decode hot buffers once
    y      = packed_apply(model, ready, x)      # every quantized layer packed

The packed layers are the ``QuantDense``/``QuantConv`` ones: an MoE LM's
expert stacks (``nn.QuantMoE``) are not packed, and ``packed_apply`` runs
them fake-quant beside its packed attention projections, as the JAX
package's interceptor does.

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
| other real inputs (a_bits=0) | either    | float matmul on decoded ±1 (K2) / f32 grid (dorefa: K7) / bf16 {-1, 0, 1} weights |
| conv, binary/xnor/dorefa with quantized inputs | either | ``packed_conv2d``: decode per call, K5 conv |
| conv, real inputs (log: K9, dorefa: K7, binary/xnor: K2 decode) | either | float conv on the decoded weights |

xnor layers carry alpha (``mean |W|`` over all but the out-channel axis):
K1's and K3's epilogue scale, K5's ``scale`` epilogue in the conv, and a
multiply after the float op on real inputs. One-bit DoReFa layers carry
alpha too: their weights are ``E|W| sign(W)`` and the codes keep the sign,
so the per-tensor ``E|W|`` (one value per out channel) rides K6's scalar
epilogue (``float32(1/(n_w n_a) * alpha)``), K3's alpha vector after
``prepare()``, K5's scale and the real-input multiply. The JAX package
drops it (ROADMAP section 3): a one-bit DoReFa record without alpha, such
as a JAX artifact's, raises on load and in every packed route.

Ternary weights pack as 2-bit planes of ``round(clip(w, -1, 1)) + 1`` and
decode to bf16 {-1, 0, 1} in plain PyTorch, as the JAX package does (no
kernel); their records carry the layer's ``w_bits`` (the LM's, 2 for
``LinearTer``/``TerConv``) although the planes are always 2-bit, so
artifacts interchange.

As in the JAX package, the quantized-input conv path decodes its weights on
every call and does not read ``prepare()``'s buffer; a real-input conv reads
it when it is there (log: K9 on every unprepared call). The unprepared log
dense layer rounds its input to bf16 and the prepared one does not, as in
the JAX package. Every branch returns at the input's dtype, as the JAX
package's do: a bf16 input (a model with ``dtype=torch.bfloat16``) gets the
float32 sums of the integer kernels rounded once to bf16; a real-input layer
multiplies at the input's dtype, and where alpha or a bias follows, a bf16
product is taken in float32 and rounded once after them (JAX's
``preferred_element_type=float32``). ``pack_model`` refuses log and lin
layers with quantized inputs (``quantize_input=True``): the JAX package's
packed paths ignore that quantizer (ROADMAP section 3). ``pack_model`` and
``packed_apply`` refuse a model with a learnable activation scale
(``act_scale``, config ``bnn_lenet_as``): the packed paths binarize the
input to +-1 and would drop g, as the JAX package's pack and export do
(ROADMAP section 3).
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
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
from pytorch_quantize_impls_tpu_torch.ops.xnor import out_channel_alpha
from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device

_PORTED_SCHEMES = ("binary", "xnor", "dorefa", "log", "lin", "ternary")
TERNARY_PLANE_BITS = 2  # ternary codes {0, 1, 2} = round(clip(w, -1, 1)) + 1


@dataclasses.dataclass(frozen=True)
class PackedLayer:
    packed: torch.Tensor  # grouped-planar packed words (int32 bit patterns)
    # xnor's per-out-channel scale; one-bit dorefa's E|W| per out channel
    alpha: Optional[torch.Tensor] = None
    # prepare(): ±1 int8 (K, N), centered int8 codes (Kp, N), f32 grid (K, N)
    # or bf16 ±2^e (K, N); a real-input dense layer's stored out-major
    decoded: Optional[torch.Tensor] = None
    kind: str = "dense"  # dense|conv
    scheme: str = "binary"
    w_bits: int = 1
    a_bits: int = 0
    fsr: float = 0.0
    # the JAX kernel's shape: (in, out) dense, HWIO conv
    kernel_shape: Tuple[int, ...] = ()

    @functools.cached_property
    def alpha_host(self) -> Optional[float]:
        """One-bit dorefa's E|W| as a host float (K6's scalar epilogue, the
        conv's ``w_scale``), read from the device once per record."""
        return None if self.alpha is None else float(self.alpha[0])


PackedModel = Dict[Tuple[str, ...], PackedLayer]


def _check_scheme(scheme: str) -> None:
    if scheme not in _PORTED_SCHEMES:
        raise ValueError(f"unpackable scheme {scheme!r}")


def _check_record(rec: PackedLayer) -> None:
    """A ported scheme, and a one-bit dorefa record with its alpha."""
    _check_scheme(rec.scheme)
    if rec.scheme == "dorefa" and rec.w_bits == 1 and rec.alpha is None:
        raise ValueError(
            "a one-bit dorefa record without alpha (E|W|), such as the JAX package's, would "
            "compute sign(W) in place of E|W| sign(W): re-pack the model with this package "
            "(ROADMAP section 3)")


def _pack_layer(m, pack_planes=packlib.pack_bitplanes) -> PackedLayer:
    """One layer's record. Each scheme's weight codes (K, N) are stated here
    once; ``pack_planes(codes, bits)`` turns them into the planar words:
    ``ops.pack`` on the weight's device, or the host codec
    (``infer.host_export``)."""
    _check_scheme(m.scheme)
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
    alpha = None
    if m.scheme == "dorefa":
        codes, bits = pm.dorefa_weight_codes(dorefa_weight(w2d, m.w_bits), m.w_bits), m.w_bits
        if m.w_bits == 1:  # the fake-quant layer's E|W|, on its own (out, ...) weight
            alpha = w.abs().mean().expand(w.shape[0]).contiguous()
    elif m.scheme == "log":
        codes, bits = sm.log_weight_codes(w2d, m.fsr, m.w_bits), sm.CODE_BITS
    elif m.scheme == "lin":
        # signed grid codes round(w / step) clipped to ±2^bits, offset into
        # [0, 2^(bits+1)]; 8-bit planar fields (bits <= 6)
        step = 2.0 ** (m.fsr - m.w_bits)
        c = torch.clamp(torch.round(w2d / step), -(2**m.w_bits), 2**m.w_bits)
        codes, bits = (c + 2**m.w_bits).to(torch.int32), 8
    elif m.scheme == "ternary":
        c = torch.round(torch.clamp(w2d, -1.0, 1.0)) + 1
        codes, bits = c.to(torch.int32), TERNARY_PLANE_BITS
    else:
        if m.scheme == "xnor":
            alpha = out_channel_alpha(w)
        codes, bits = bg.binary_weight_codes(w2d), 1
    return PackedLayer(
        packed=pack_planes(codes, bits),
        alpha=alpha,
        kind=kind,
        scheme=m.scheme,
        w_bits=m.w_bits,
        a_bits=m.a_bits,
        fsr=m.fsr,
        kernel_shape=kernel_shape,
    )


def scaled_layers(model: nn.Module) -> list:
    """The names of ``model``'s layers that hold a learnable activation scale
    (``act_scale``)."""
    return [name for name, m in model.named_modules() if _has_act_scale(m)]


def _has_act_scale(m: nn.Module) -> bool:
    return isinstance(getattr(m, "act_scale", None), nn.Parameter)


def _act_scale_error(what: str, scaled: list) -> ValueError:
    return ValueError(
        f"{what} refuses a learnable activation scale (act_scale on {scaled}): its "
        "binarized inputs are +-1 codes, so it would drop g and compute another function "
        "(ROADMAP section 3); serve the fake-quant model")


def refuse_act_scale(model: nn.Module, what: str) -> None:
    """Raise ValueError if a layer of ``model`` holds a learnable activation
    scale: ``what`` (a packed or fused path) would run on +-1 inputs and
    drop it."""
    scaled = scaled_layers(model)
    if scaled:
        raise _act_scale_error(what, scaled)


def _quant_layers(model: nn.Module, refuse: Optional[str] = None) -> list:
    """``(path, layer)`` for every quantized layer of ``model``. With
    ``refuse`` (the name of a packed path), the same walk raises as
    :func:`refuse_act_scale` does."""
    layers, scaled = [], []
    for name, m in model.named_modules():
        if refuse is not None and _has_act_scale(m):
            scaled.append(name)
        if isinstance(m, (QuantDense, QuantConv)) and m.scheme != "none":
            layers.append((tuple(name.split(".")), m))
    if scaled:
        raise _act_scale_error(refuse, scaled)
    return layers


@torch.no_grad()
def pack_model(model: nn.Module, pack_planes=packlib.pack_bitplanes) -> PackedModel:
    """Pack every quantized layer's master weight, on the weight's device;
    ``pack_planes`` as in ``_pack_layer``. Refuses ``act_scale``
    (:func:`refuse_act_scale`)."""
    return {path: _pack_layer(m, pack_planes)
            for path, m in _quant_layers(model, refuse="pack_model")}


def _decode_weights(rec: PackedLayer) -> torch.Tensor:
    """Packed codes -> execution-ready weights (K, N): ±1 int8 for
    binary/xnor (K2); the f32 grids ``(2c - n) / n`` for dorefa (not
    bf16-exact; ``2c - n`` by K7 at 1, 2 and 4 bits, where the JAX package
    unpacks in plain code: the same integers, so the same floats; one-bit
    alpha applies after the op), ``c * step`` for lin and bf16 {-1, 0, 1}
    for ternary, unpacked in plain PyTorch as the JAX package does; bf16
    ``±2^e`` for log, by K9, bit-identical to the JAX package's plain
    decode."""
    _check_record(rec)
    k2d = int(np.prod(rec.kernel_shape[:-1]))
    if rec.scheme == "dorefa":
        n = 2**rec.w_bits - 1
        if rec.w_bits in (1, 2, 4):
            centered = pm.decode_dorefa_weights(rec.packed, w_bits=rec.w_bits)[:k2d]
            return centered.to(torch.float32) / n
        c = packlib.unpack_bitplanes(rec.packed, rec.w_bits, k2d)
        return (2.0 * c.to(torch.float32) - n) / n
    if rec.scheme == "log":
        return sm.decode_log_weights(rec.packed, fsr=rec.fsr, bits=rec.w_bits)[:k2d]
    if rec.scheme == "lin":
        c = packlib.unpack_bitplanes(rec.packed, 8, k2d) - 2**rec.w_bits
        return c.to(torch.float32) * 2.0 ** (rec.fsr - rec.w_bits)
    if rec.scheme == "ternary":
        c = packlib.unpack_bitplanes(rec.packed, TERNARY_PLANE_BITS, k2d) - 1
        return c.to(torch.bfloat16)
    return bg.decode_binary_weights(rec.packed)[:k2d]


def _int_codes(rec: PackedLayer) -> bool:
    """True where the layer runs the integer-code GEMM: dorefa with inputs
    quantized to 1..7 bits (codes that fit int8)."""
    return rec.scheme == "dorefa" and 1 <= rec.a_bits <= 7


def _real_input_dense(rec: PackedLayer) -> bool:
    """True where the dense layer multiplies real inputs by decoded weights."""
    binary_inputs = rec.scheme in ("binary", "xnor") and rec.a_bits == 1
    return rec.kind == "dense" and not binary_inputs and not _int_codes(rec)


def _out_major(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(K, N) weights at ``dtype``, stored as (N, K) rows: the fake-quant
    layer's layout, so cuBLAS runs the kernel it runs there and the two
    answer alike bit for bit. No copy when ``w`` is so already."""
    if w.dtype == dtype and w.T.is_contiguous():
        return w
    return w.T.to(dtype, copy=True, memory_format=torch.contiguous_format).T


def _decode_execution(rec: PackedLayer) -> torch.Tensor:
    """The buffer the layer's hot path consumes: centered int8 codes (K7)
    for the integer-code GEMM, decoded values otherwise (out-major for a
    real-input dense layer)."""
    _check_record(rec)
    if _int_codes(rec):
        return pm.decode_dorefa_weights(rec.packed, w_bits=rec.w_bits)
    w = _decode_weights(rec)
    return _out_major(w, w.dtype) if _real_input_dense(rec) else w


def prepare(packed: PackedModel) -> PackedModel:
    """Decode every layer's execution buffer once (weight-stationary)."""
    return {
        path: dataclasses.replace(rec, decoded=_decode_execution(rec))
        for path, rec in packed.items()
    }


def _unrounded(x: torch.Tensor, rec: PackedLayer, bias) -> bool:
    """True where a real-input layer's product of values narrower than
    float32 is taken in float32 (exact products, float32 sums) because alpha
    or a bias follows it; otherwise its one rounding to x's dtype comes at
    the end either way."""
    return x.dtype not in (torch.float32, torch.float64) and (
        rec.alpha is not None or bias is not None)


def _dense_forward(rec: PackedLayer, x: torch.Tensor, bias, tp_group=None) -> torch.Tensor:
    # the GEMM kernels take (M, K): fold any leading batch/sequence dims
    lead = x.shape[:-1]
    y = _dense_forward_2d(rec, x.reshape(-1, x.shape[-1]), bias, tp_group)
    return y.reshape(*lead, y.shape[-1])


def _gather_columns(y: torch.Tensor, tp_group) -> torch.Tensor:
    """Each model rank's (M, N/n) column block -> the whole (M, N), blocks
    in rank order (JAX's tiled ``all_gather`` on axis 1)."""
    n = dist.get_world_size(tp_group)
    blocks = y.new_empty((n * y.shape[0], y.shape[1]))
    dist.all_gather_into_tensor(blocks, y.contiguous(), group=tp_group)
    return blocks.view(n, *y.shape).permute(1, 0, 2).reshape(y.shape[0], n * y.shape[1])


def _dense_forward_2d(rec: PackedLayer, x: torch.Tensor, bias, tp_group=None) -> torch.Tensor:
    """One packed GEMM. With ``tp_group`` the record is this rank's column
    shard (:func:`shard_packed`): the GEMM computes the rank's block of
    output columns and an all-gather over the group assembles the row
    before the bias."""
    _check_record(rec)
    if rec.scheme in ("binary", "xnor") and rec.a_bits == 1:
        xi = bg.binarize_to_int8(x)
        if rec.decoded is not None:
            y = bg.binary_gemm_decoded(xi, rec.decoded, rec.alpha)
        else:
            y = bg.binary_gemm(xi, rec.packed, rec.alpha)
    elif _int_codes(rec):
        codes = pm.dorefa_act_to_int8(dorefa_activation(x, rec.a_bits), rec.a_bits)
        if rec.decoded is not None:
            y = pm.dorefa_gemm_decoded(codes, rec.decoded, w_bits=rec.w_bits, a_bits=rec.a_bits,
                                       alpha=rec.alpha)
        else:
            y = pm.dorefa_gemm(codes, rec.packed, w_bits=rec.w_bits, a_bits=rec.a_bits,
                               alpha=rec.alpha_host)
    elif rec.scheme == "log" and rec.decoded is None:
        y = sm.shift_gemm(x, rec.packed, fsr=rec.fsr, bits=rec.w_bits)
    else:
        # real inputs: decoded weights, out-major, at the input dtype
        w = _out_major(rec.decoded if rec.decoded is not None else _decode_weights(rec), x.dtype)
        if _unrounded(x, rec, bias):
            y = x.float() @ w.float()
        else:
            y = (x @ w).to(torch.float32)
        if rec.alpha is not None:
            y = y * rec.alpha[None, :]
    if tp_group is not None:
        y = _gather_columns(y, tp_group)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def _conv_forward(m: QuantConv, rec: PackedLayer, x: torch.Tensor, bias) -> torch.Tensor:
    _check_record(rec)
    kh, kw, cin, cout = rec.kernel_shape
    if rec.scheme in ("binary", "xnor", "dorefa") and rec.a_bits >= 1:
        dorefa = rec.scheme == "dorefa"
        pc = PackedConv(
            scheme=rec.scheme,
            packed=rec.packed,
            kernel_size=(kh, kw),
            cin=cin,
            cout=cout,
            alpha=None if dorefa else rec.alpha,
            w_bits=rec.w_bits,
            a_bits=rec.a_bits,
            fsr=rec.fsr,
            w_scale=rec.alpha_host if dorefa else None,
        )
        xin = dorefa_activation(x, rec.a_bits) if rec.scheme == "dorefa" else x
        y = packed_conv2d(xin, pc, strides=m.strides, padding=m.padding)
    else:
        # real inputs: decoded weights, float conv at the input dtype
        w2d = rec.decoded if rec.decoded is not None else _decode_weights(rec)
        w4d = w2d.T.reshape(cout, cin, kh, kw).to(x.dtype)
        xc = x.float() if _unrounded(x, rec, bias) else x
        y = conv2d_nhwc(xc, w4d.to(xc.dtype), m.strides, m.padding)
        if rec.alpha is not None:
            y = y * rec.alpha
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def packed_apply(model: nn.Module, packed: PackedModel, *args, tp_group=None, **kwargs):
    """Eval forward ``model(*args, **kwargs)`` with every packed quantized
    layer dispatched to its packed path; other modules (BatchNorm, pooling,
    LayerNorm, attention) run as they are. The model must be in eval mode.
    A decode-mode LM takes ``(tokens, cache)`` and returns what it returns,
    ``(logits, cache)``.

    ``tp_group`` (a model-axis group): ``packed``'s dense records are this
    rank's column shards (:func:`shard_packed` over that axis), and each
    dense layer all-gathers its output columns over the group before its
    bias (column-parallel tensor parallelism); conv records are whole."""
    if model.training:
        raise ValueError("packed_apply runs the eval forward: call model.eval() first")
    paths = {m: path for path, m in _quant_layers(model, refuse="packed_apply")}

    def interceptor(m, x, fake_quant_forward):
        rec = packed.get(paths.get(m))
        if rec is None:
            return fake_quant_forward(x)
        if isinstance(m, QuantConv):
            return _conv_forward(m, rec, x, m.bias)
        return _dense_forward(rec, x, m.bias, tp_group)

    with torch.no_grad(), intercept_quant_layers(interceptor):
        return model(*args, **kwargs)


def _column_shard(rec: PackedLayer, n: int, rank: int) -> PackedLayer:
    """Columns ``[rank N/n, (rank + 1) N/n)`` of a dense record, each
    buffer a contiguous copy: the packed words and ``decoded`` on their N
    axis (an out-major ``decoded`` stays out-major), ``alpha`` on its only
    axis. One-bit DoReFa's ``alpha`` holds the whole tensor's E|W| in
    every entry, so its shard keeps that value. Conv records stay whole."""
    if rec.kind != "dense":
        return rec
    *k_dims, n_out = rec.kernel_shape
    if n_out % n:
        raise ValueError(f"{n_out} output columns do not divide over {n} model ranks")
    lo, width = rank * (n_out // n), n_out // n
    dec = rec.decoded
    if dec is not None:
        if _real_input_dense(rec):  # (K, N) over (N, K) rows: cut the rows
            dec = dec.T.narrow(0, lo, width).clone().T
        else:
            dec = dec.narrow(1, lo, width).contiguous()
    return dataclasses.replace(
        rec, packed=rec.packed.narrow(-1, lo, width).contiguous(),
        alpha=None if rec.alpha is None else rec.alpha.narrow(0, lo, width).contiguous(),
        decoded=dec, kernel_shape=(*k_dims, width))


def shard_packed_columns(packed: PackedModel, n: int, rank: int) -> PackedModel:
    """Model rank ``rank``'s records of ``packed`` over ``n`` model ranks:
    every dense record's column block ``rank`` of ``n``, cut once as
    contiguous copies; conv records whole, as in the JAX package (conv
    serving shards on data)."""
    return {path: _column_shard(rec, n, rank) for path, rec in packed.items()}


def shard_packed(packed: PackedModel, mesh, axis: str = "model") -> PackedModel:
    """This rank's records of ``packed`` on ``mesh``: the dense records
    column-sharded over ``axis`` (:func:`shard_packed_columns` at the
    rank's index there), the counterpart of the JAX package's
    ``packed_tp_specs``. Run them through ``packed_apply(...,
    tp_group=mesh.get_group(axis))``."""
    return shard_packed_columns(packed, mesh.size(mesh.mesh_dim_names.index(axis)),
                                mesh.get_local_rank(axis))


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
            if m["scheme"] == "dorefa" and m["w_bits"] == 1 and not m["has_alpha"]:
                raise ValueError(
                    f"{path}: the one-bit dorefa layer {'/'.join(m['path'])} has no alpha "
                    "(E|W|): an artifact of the JAX package, whose packing drops it, so its "
                    "packed layer would compute sign(W) in place of E|W| sign(W) (ROADMAP "
                    "section 3)")
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
