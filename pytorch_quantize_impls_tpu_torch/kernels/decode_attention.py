"""Single-token decode attention over the int8-quantized KV cache.

Counterpart of ``pytorch_quantize_impls_tpu/kernels/decode_attention.py``:

    scores = (q . k_codes) * k_scale * rsqrt(hd) + mask_bias
    p      = softmax(scores)           (numerically stable, over cl)
    ctx    = ((p * v_scale) . v_codes) / sum(p)

The dequantization scales fold into the score and probability vectors, so
the cache is never dequantized to a copy. The layout is b-h-major, as in the
fused decode cache (``infer.fused_decode``).

``decode_attention`` launches the hand-written CUDA kernel in
``csrc/decode_attention.cu`` for CUDA tensors and takes its plain PyTorch
version ``decode_attention_reference`` for CPU tensors; ``.launches`` counts
the kernel launches. Both compute in float32. The JAX kernel's ``precision``
option (bf16 passes on the TPU) has no counterpart: on the card everything is
f32.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_quantize_impls_tpu_torch.kernels import _build
from pytorch_quantize_impls_tpu_torch.ops.common import flush_subnormal

# head dims the CUDA kernel is instantiated for (16 codes per lane, whole
# rows per warp)
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)


def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    # (q, k_codes, k_scale, v_codes, v_scale, mask_bias, out, B, H, CL, HD,
    #  device, stream)
    return _build.library("decode_attention", qt_decode_attention=[p] * 7 + [i] * 5 + [p])


def decode_attention_reference(q, k_codes, k_scale, v_codes, v_scale, mask_bias):
    """Plain PyTorch version of :func:`decode_attention`, the same formula
    step by step in float32 (it does build float copies of the codes).
    ``p`` is flushed to 0 where subnormal, as XLA computes it
    (``ops.flush_subnormal``)."""
    hd = q.shape[-1]
    s = torch.einsum("bhd,bhkd->bhk", q.to(torch.float32), k_codes.to(torch.float32))
    s = s * k_scale * torch.rsqrt(torch.tensor(float(hd), device=q.device))
    s = s + mask_bias[:, None, :]
    p = flush_subnormal(torch.exp(s - s.amax(dim=-1, keepdim=True)))
    denom = p.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bhk,bhkd->bhd", p * v_scale, v_codes.to(torch.float32))
    return ctx / denom


def decode_attention(
    q: torch.Tensor,
    k_codes: torch.Tensor,
    k_scale: torch.Tensor,
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    mask_bias: torch.Tensor,
) -> torch.Tensor:
    """One-token attention over the quantized cache.

    q: (b, h, hd) float32 query; k_codes/v_codes: (b, h, cl, hd) int8;
    k_scale/v_scale: (b, h, cl) float32; mask_bias: (b, cl) float32, 0 where
    a position may be attended and -1e30 where not. Returns (b, h, hd)
    float32.
    """
    b, h, hd = q.shape
    cl = k_codes.shape[2]
    if tuple(k_codes.shape) != (b, h, cl, hd) or tuple(v_codes.shape) != (b, h, cl, hd):
        raise ValueError(f"codes {tuple(k_codes.shape)}/{tuple(v_codes.shape)}, expected {(b, h, cl, hd)}")
    if tuple(mask_bias.shape) != (b, cl):
        raise ValueError(f"mask_bias {tuple(mask_bias.shape)}, expected {(b, cl)}")
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_reference(q, k_codes, k_scale, v_codes, v_scale, mask_bias)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in {KERNEL_HEAD_DIMS}")
    _build.require("q", q, torch.float32, (b, h, hd), dev)
    for name, t in (("k_codes", k_codes), ("v_codes", v_codes)):
        _build.require(name, t, torch.int8, (b, h, cl, hd), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned")
    _build.require("k_scale", k_scale, torch.float32, (b, h, cl), dev)
    _build.require("v_scale", v_scale, torch.float32, (b, h, cl), dev)
    _build.require("mask_bias", mask_bias, torch.float32, (b, cl), dev)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.qt_decode_attention(
        _build.ptr(q), _build.ptr(k_codes), _build.ptr(k_scale), _build.ptr(v_codes),
        _build.ptr(v_scale), _build.ptr(mask_bias), _build.ptr(out), b, h, cl, hd,
        *_build.launch_args(q),
    )
    _build.check(lib, code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
