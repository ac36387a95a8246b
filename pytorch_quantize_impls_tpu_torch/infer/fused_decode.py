"""Fused serving-time decode step for the 1-bit transformer LM.

Counterpart of ``pytorch_quantize_impls_tpu/infer/fused_decode.py``
(binary scheme, W1A1, dense FFN, quantized KV cache):

  - one sign-binarize per boundary, shared by its consumers: the post-LN
    stream is binarized once and Q/K/V run as ONE integer GEMM over the
    concatenated (d, 3d) ±1 weight;
  - single-token attention (s == 1) runs the ``decode_attention`` kernel in
    one pass over the int8 cache; the multi-token prefill runs the plain
    PyTorch ``_attend_cached`` (the JAX package runs plain XLA there);
  - the FFN hidden boundary is a per-channel threshold on the integer
    accumulator, ``sign(y + b1) == [y >= -b1]``, so the (b, d_ff) hidden
    activation crosses as int8 codes;
  - weights stay resident as ±1 int8 codes (``weights="int8"``, the
    ``int8_gemm`` kernel) or as planar 1-bit words (``weights="packed"``,
    the ``binary_gemm`` kernel, 8x fewer weight bytes). Both GEMMs are
    exact, so the two exports give the same bits.

The cache is b-h-major, ``(b, h, cl, hd)``, for unit-stride kernel reads,
with the flax leaf names (``k_codes``/``k_scale``/``v_codes``/``v_scale``/
``index`` per block, ``pos_index``), so ``serve.DecodeEngine``'s slot
machinery works on it unchanged. :func:`fused_decode_apply` updates the
cache in place: K/V are written by indexed assignment at each slot's cursor
and the cursors are replaced by new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as da
from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
from pytorch_quantize_impls_tpu_torch.ops import kv_cache as kvlib
from pytorch_quantize_impls_tpu_torch.ops.common import flush_subnormal
from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FusedDecodeLayer:
    w_qkv: torch.Tensor  # (d, 3d) int8 ±1 codes, or planar 1-bit int32 words
    w_out: torch.Tensor  # (d, d)
    w1: torch.Tensor  # (d, d_ff)
    thr1: torch.Tensor  # (d_ff,) f32: hidden code +1 iff acc >= thr1 (= -b1)
    w2: torch.Tensor  # (d_ff, d)
    b2: Optional[torch.Tensor]  # (d,) f32
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FusedDecodeModel:
    embed: torch.Tensor  # (vocab, d) f32, also the tied head
    pos: torch.Tensor  # (max_len, d) f32
    layers: Tuple[FusedDecodeLayer, ...]
    lnf_scale: torch.Tensor
    lnf_bias: torch.Tensor
    n_heads: int = 8
    max_len: int = 1024
    kv_bits: int = 8
    ln_eps: float = 1e-6

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _sign_i8(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1, -1).to(torch.int8)


def _ln(x, scale, bias, eps):
    """The fused step's LayerNorm: two-pass variance (not flax's), as the
    JAX fused step computes it."""
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _gemm_i8(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """±1 int8 codes (M, K) @ weight -> (M, N) f32, exact integer sums:
    ``int8_gemm`` on int8 codes, ``binary_gemm`` on planar 1-bit words."""
    if w.dtype == torch.int32:
        return bg.binary_gemm(c, w)
    return im.int8_gemm(c, w)


@torch.no_grad()
def export_fused_decode(model, *, weights: str = "int8", device="cuda") -> FusedDecodeModel:
    """Build the fused decode program from a ``QuantTransformerLM`` with
    ``scheme='binary', w_bits=1, a_bits=1``, a dense FFN and a quantized KV
    cache, on ``device`` (the card unless ``device="cpu"``; raises without a
    GPU).

    ``weights``: ``"int8"`` keeps ±1 int8 codes resident, ``"packed"`` keeps
    planar 1-bit words (``kernels.xnor_gemm.pack_binary_weights``).
    """
    device = resolve_device(device)
    if weights not in ("int8", "packed"):
        raise ValueError(f"weights must be 'int8' or 'packed', got {weights!r}")
    if model.scheme != "binary" or model.w_bits != 1 or model.a_bits != 1:
        raise ValueError(
            "fused decode supports the binary W1A1 serving config; got "
            f"scheme={model.scheme!r} w_bits={model.w_bits} a_bits={model.a_bits}"
        )
    if model.n_experts > 0:
        raise ValueError("fused decode does not support MoE FFNs")
    if model.kv_bits is None:
        raise ValueError("fused decode requires a quantized KV cache")

    def codes(dense):  # the JAX kernel layout (in, out) as ±1 int8
        return _sign_i8(dense.weight.detach().T)

    def mk_w(c):
        w = bg.pack_binary_weights(c.to(torch.float32)) if weights == "packed" else c
        return w.contiguous().to(device)

    def f32(t):
        return t.detach().to(device, torch.float32).contiguous()

    layers = []
    for blk in model.blocks():
        a = blk.attn
        b1, b2 = blk.ffn_in.bias, blk.ffn_out.bias
        layers.append(FusedDecodeLayer(
            w_qkv=mk_w(torch.cat([codes(a.q), codes(a.k), codes(a.v)], dim=1)),
            w_out=mk_w(codes(a.out)),
            w1=mk_w(codes(blk.ffn_in)),
            thr1=(f32(-b1) if b1 is not None
                  else torch.zeros(blk.ffn_in.weight.shape[0], device=device)),
            w2=mk_w(codes(blk.ffn_out)),
            b2=f32(b2) if b2 is not None else None,
            ln1_scale=f32(blk.ln1.weight), ln1_bias=f32(blk.ln1.bias),
            ln2_scale=f32(blk.ln2.weight), ln2_bias=f32(blk.ln2.bias),
        ))
    return FusedDecodeModel(
        embed=f32(model.embed.weight), pos=f32(model.pos_embed), layers=tuple(layers),
        lnf_scale=f32(model.ln_f.weight), lnf_bias=f32(model.ln_f.bias),
        n_heads=model.n_heads, max_len=model.max_len, kv_bits=model.kv_bits,
    )


def fused_init_cache(fm: FusedDecodeModel, b: int, device="cuda") -> Dict:
    """A fresh b-h-major cache for ``b`` slots on ``device`` (the card unless
    ``device="cpu"``; raises without a GPU), every cursor at 0."""
    device = resolve_device(device)
    d = fm.embed.shape[1]
    h, hd, cl = fm.n_heads, d // fm.n_heads, fm.max_len

    def attn():
        return {
            "k_codes": torch.zeros((b, h, cl, hd), dtype=torch.int8, device=device),
            "k_scale": torch.zeros((b, h, cl), dtype=torch.float32, device=device),
            "v_codes": torch.zeros((b, h, cl, hd), dtype=torch.int8, device=device),
            "v_scale": torch.zeros((b, h, cl), dtype=torch.float32, device=device),
            "index": torch.zeros((b,), dtype=torch.int32, device=device),
        }

    cache = {f"block{i}": {"attn": attn()} for i in range(len(fm.layers))}
    cache["pos_index"] = torch.zeros((b,), dtype=torch.int32, device=device)
    return cache


def _attend_cached(q, att, offset, s):
    """Multi-query attention over the whole cache (the prefill path, plain
    PyTorch): the scales fold into scores and probabilities. Subnormal
    probabilities are flushed as XLA flushes them (``ops.flush_subnormal``)."""
    hd = q.shape[-1]
    cl = att["k_codes"].shape[2]
    scores = torch.einsum("bqhd,bhkd->bhqk", q, att["k_codes"].to(torch.float32))
    scores = scores * att["k_scale"][:, :, None, :]
    scores = scores * torch.rsqrt(torch.tensor(float(hd), device=q.device))
    q_pos = offset[:, None].long() + torch.arange(s, device=q.device)[None, :]  # (b, s)
    mask = torch.arange(cl, device=q.device)[None, None, :] <= q_pos[..., None]
    scores = torch.where(mask[:, None], scores, -1e30)
    attn = flush_subnormal(torch.softmax(scores, dim=-1)) * att["v_scale"][:, :, None, :]
    return torch.einsum("bhqk,bhkd->bqhd", attn, att["v_codes"].to(torch.float32))


@torch.no_grad()
def fused_decode_apply(fm: FusedDecodeModel, cache: Optional[Dict], toks: torch.Tensor):
    """Forward ``toks`` (b, s) through the fused program. Returns
    ``(logits (b, s, vocab) f32, cache)``, the contract of the decode-mode
    ``QuantTransformerLM``; ``cache=None`` starts from a fresh cache on the
    tokens' device. The cache is updated in place (module docstring).

    s == 1 is the single-token step (the ``decode_attention`` kernel);
    s > 1 is the prefill (same math, batched queries, plain PyTorch).
    """
    b, s = toks.shape
    d = fm.embed.shape[1]
    h = fm.n_heads
    hd = d // h
    dev = toks.device
    if cache is None:
        cache = fused_init_cache(fm, b, device=dev)
    ar = torch.arange(s, device=dev)
    offset = cache["pos_index"]
    idx = (offset[:, None].long() + ar[None, :]).clamp(0, fm.max_len - 1)
    x = fm.embed[toks] + fm.pos[idx]  # (b, s, d) f32
    cache["pos_index"] = offset + s

    rows = torch.arange(b, device=dev)[:, None, None]  # slot
    heads = torch.arange(h, device=dev)[None, :, None]
    for i, ly in enumerate(fm.layers):
        att = cache[f"block{i}"]["attn"]
        cur = att["index"]  # (b,) per-slot cursor
        c = _sign_i8(_ln(x, ly.ln1_scale, ly.ln1_bias, fm.ln_eps))  # one binarize: q, k, v
        qkv = _gemm_i8(c.reshape(b * s, d), ly.w_qkv).reshape(b, s, 3 * d)
        q, k, v = qkv.split(d, dim=-1)
        q = q.reshape(b, s, h, hd)
        k_codes, k_scale = kvlib.quantize_kv(k.reshape(b, s, h, hd), fm.kv_bits)
        v_codes, v_scale = kvlib.quantize_kv(v.reshape(b, s, h, hd), fm.kv_bits)
        # write this call's K/V at the per-slot cursor (b-h-major), in place
        cols = cur[:, None, None].long() + ar[None, None, :]  # (b, 1, s)
        att["k_codes"][rows, heads, cols] = k_codes.transpose(1, 2)
        att["k_scale"][rows, heads, cols] = k_scale.transpose(1, 2)
        att["v_codes"][rows, heads, cols] = v_codes.transpose(1, 2)
        att["v_scale"][rows, heads, cols] = v_scale.transpose(1, 2)
        att["index"] = cur + s
        if s == 1:
            cl = att["k_codes"].shape[2]
            bias = torch.where(
                torch.arange(cl, device=dev)[None, :] <= cur[:, None], 0.0, -1e30
            ).to(torch.float32)
            ctx = da.decode_attention(
                q[:, 0].contiguous(), att["k_codes"], att["k_scale"],
                att["v_codes"], att["v_scale"], bias,
            ).reshape(b, 1, d)
        else:
            ctx = _attend_cached(q, att, cur, s).reshape(b, s, d)
        c2 = _sign_i8(flush_subnormal(ctx))  # XLA's zero where the JAX step has one
        x = x + _gemm_i8(c2.reshape(b * s, d), ly.w_out).reshape(b, s, d)

        c3 = _sign_i8(_ln(x, ly.ln2_scale, ly.ln2_bias, fm.ln_eps))
        y1 = _gemm_i8(c3.reshape(b * s, d), ly.w1)  # (b*s, d_ff) integer sums
        # hidden boundary as a threshold: sign(y1 + b1) == [y1 >= -b1]
        c4 = torch.where(y1 >= ly.thr1[None, :], 1, -1).to(torch.int8)
        y2 = _gemm_i8(c4, ly.w2).reshape(b, s, d)
        if ly.b2 is not None:
            y2 = y2 + ly.b2
        x = x + y2

    x = _ln(x, fm.lnf_scale, fm.lnf_bias, fm.ln_eps)
    return x @ fm.embed.T, cache
