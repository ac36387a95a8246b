"""Quantized transformer LM: eval forward and decode mode.

Counterpart of ``pytorch_quantize_impls_tpu/models/transformer.py``
(``QuantAttention``, ``QuantTransformerBlock``, ``QuantTransformerLM``).
Every projection (QKV, attention out, dense FFN) is a ``QuantDense``, and
every MoE expert stack a ``QuantMoE`` kernel, whose float32 master weight is
fake-quantized per forward; the embedding, layer norms and the tied logits
head stay float32. Module names match the flax ones (``block0.attn.q``,
``block0.ffn_in``, ``block0.moe``, ``ln_f``, ``embed``, ``pos_embed``), so
``utils.bridge`` loads the JAX package's variables directly.

Decode mode (``decode=True``, or :func:`serve.decode_model`) serves token by
token from a fixed-capacity (``max_len``) KV cache. The flax ``"cache"``
collection becomes an explicit dict that the caller passes in and gets back,
with the flax leaf names and layouts:

    {"block{i}": {"attn": {"k_codes": (b, cl, h, hd) int8,
                           "k_scale": (b, cl, h) f32,
                           "v_codes", "v_scale": the same,
                           "index": (b,) int32}},
     "pos_index": (b,) int32}

(``kv_bits=None`` keeps ``k_raw``/``v_raw`` (b, cl, h, hd) at the compute
dtype instead.)
The forward updates the dict in place: this call's K/V are written into the
cache tensors by indexed assignment at each slot's cursor, and the cursors
are replaced by new tensors. It returns the same dict. Cursors are per slot,
and a query at position p attends cache positions <= p, so right-padded
prefill and slots of different lengths are safe, as in the JAX model.
Callers keep every cursor + s within ``max_len``: ``serve.generate`` and
``serve.DecodeEngine`` check it.

Ported scope: schemes ``binary`` (``a_bits`` 0 or 1), ``dorefa`` (k-bit
weights; ``a_bits`` > 0 quantizes every projection input to the [0, 1] grid,
with a ReLU before the FFN's quantizer), ``log``, ``lin`` (weights only,
levels set by ``fsr``) and ``ternary`` (deterministic {-1, 0, 1} weights
only; the records carry the model's ``w_bits``); for these three ``a_bits``
> 0 raises ``ValueError``, as in the JAX package; and ``none``. The JAX
model has no ``xnor`` weight quantizer, so ``scheme="xnor"`` raises
``ValueError`` there and here. ``kv_bits`` 8 (2..8) or ``None``.
The FFN is dense, or with ``n_experts > 0`` a switch-routed ``nn.QuantMoE``
(``block{i}.moe``: ``capacity_factor``, the expert kernels quantized by the
model's scheme and ``w_bits``; it ignores ``a_bits``, as in the JAX model,
and takes the LayerNorm's real output). Each MoE forward routes every token
of the call together, over the batch and the sequence, so in decode mode the
slots of a batch share the experts' capacity. An injected ``attention_fn``
(ring or Ulysses attention) waits for ROADMAP queue 1 item 6 and raises
``NotImplementedError``.

``dtype`` (``None`` or ``torch.bfloat16``) is the compute dtype of every
projection, as in the JAX model: the embedding sum is cast to it, the
residual stream and K/V stay at it, the scores and softmax are float32 and
cast back to q's dtype; the embedding, the LayerNorms (float32 outputs)
and the tied head stay float32, so the logits are float32. A model made
``.double()`` computes all of it, the scores and LayerNorms included, in
float64.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.nn.base import QuantDense, scheme_weight_quant
from pytorch_quantize_impls_tpu_torch.nn.moe import QuantMoE
from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device

def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, item {item})")


def _act_quant(scheme: str, a_bits: int):
    """The quantizer of every projection input: sign binarization for binary
    W1A1, the k-bit [0, 1] grid for dorefa; none for log, lin and ternary, whose
    activations stay real."""
    if a_bits <= 0:
        return None
    if scheme == "dorefa":
        return partial(ops.dorefa_activation, bits=a_bits)
    if scheme == "binary":
        if a_bits != 1:
            raise ValueError(f"scheme {scheme!r} activations are 1-bit; got a_bits={a_bits}")
        return ops.binary_tanh
    raise ValueError(f"a_bits unsupported for scheme {scheme!r}")


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax ``nn.LayerNorm``'s arithmetic
    (flax 0.12, ``use_fast_variance=True``): ``var = max(0, E[x^2] - E[x]^2)``,
    then ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32 (in
    float64 in a model made ``.double()``). The signs taken right after it
    should see the JAX model's rounding."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(self.weight.dtype, torch.float32))
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return (x - mean) * mul + self.bias


def _softmax_attention(q, k, v, mask):
    """(b, s, h, hd) q over (b, cl, h, hd) k/v; ``mask`` broadcasts to
    (b, h, s, cl). Float32 scores and softmax, as in the JAX model (float64
    in a model made ``.double()``), with subnormal probabilities flushed as
    XLA flushes them."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32))
    scores = scores / torch.sqrt(torch.tensor(float(hd), device=q.device))
    scores = torch.where(mask, scores, -1e30)
    attn = ops.flush_subnormal(torch.softmax(scores, dim=-1)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


class QuantAttention(nn.Module):
    """Multi-head self-attention with quantized Q/K/V/out projections.

    ``forward(x)`` is causal (or full) attention over ``x``;
    ``forward(x, cache)`` is the decode mode over this layer's cache dict
    (updated in place; see the module docstring).
    """

    def __init__(
        self,
        d_model: int,
        n_heads: int,
        *,
        scheme: str = "binary",
        w_bits: int = 1,
        a_bits: int = 0,
        fsr: float = 0.0,
        causal: bool = True,
        cache_len: int = 0,
        kv_bits: Optional[int] = 8,
        attention_fn=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if attention_fn is not None:
            raise _not_ported("an injected attention_fn (ring/Ulysses attention)", 6)
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of n_heads {n_heads}")
        self.n_heads = n_heads
        self.causal = causal
        self.cache_len = cache_len
        self.kv_bits = kv_bits
        self.dtype = dtype
        wq = scheme_weight_quant(scheme, w_bits, fsr)
        aq = _act_quant(scheme, a_bits)

        def proj():
            return QuantDense(
                d_model, d_model, weight_quant=wq, input_quant=aq, use_bias=False,
                scheme=scheme, w_bits=w_bits, a_bits=a_bits, fsr=fsr, dtype=dtype,
            )

        self.q, self.k, self.v, self.out = proj(), proj(), proj(), proj()

    def forward(self, x: torch.Tensor, cache: Optional[Dict] = None) -> torch.Tensor:
        b, s, d = x.shape
        h = self.n_heads
        q = self.q(x).reshape(b, s, h, d // h)
        k = self.k(x).reshape(b, s, h, d // h)
        v = self.v(x).reshape(b, s, h, d // h)
        if cache is not None:
            ctx = self._cached_attention(q, k, v, cache)
        else:
            if self.causal:
                mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            else:
                mask = torch.ones((1, 1), dtype=torch.bool, device=x.device)
            ctx = _softmax_attention(q, k, v, mask)
        # the out projection may sign-binarize ctx: flush as the JAX model does
        return self.out(ops.flush_subnormal(ctx).reshape(b, s, d))

    def init_cache(self, b: int, hd: int, device) -> Dict[str, torch.Tensor]:
        cl, h = self.cache_len, self.n_heads
        if self.kv_bits is not None:
            cache = {
                "k_codes": torch.zeros((b, cl, h, hd), dtype=torch.int8, device=device),
                "k_scale": torch.zeros((b, cl, h), dtype=torch.float32, device=device),
                "v_codes": torch.zeros((b, cl, h, hd), dtype=torch.int8, device=device),
                "v_scale": torch.zeros((b, cl, h), dtype=torch.float32, device=device),
            }
        else:  # at k's dtype: the projections' compute dtype
            raw = self.dtype or torch.float32
            cache = {
                "k_raw": torch.zeros((b, cl, h, hd), dtype=raw, device=device),
                "v_raw": torch.zeros((b, cl, h, hd), dtype=raw, device=device),
            }
        cache["index"] = torch.zeros((b,), dtype=torch.int32, device=device)
        return cache

    def _cached_attention(self, q, k, v, cache):
        """Write this call's K/V at each slot's cursor, then attend q over
        the whole cache with the cursor-causal mask."""
        b, s, h, hd = q.shape
        cl = self.cache_len
        if not cl >= s > 0:
            raise ValueError(f"decode call of {s} tokens into a cache of {cl}")
        offset = cache["index"]
        rows = torch.arange(b, device=q.device)[:, None]
        cols = offset[:, None].long() + torch.arange(s, device=q.device)[None, :]  # (b, s)
        if self.kv_bits is not None:
            k_codes, k_scale = ops.quantize_kv(k, self.kv_bits)
            v_codes, v_scale = ops.quantize_kv(v, self.kv_bits)
            cache["k_codes"][rows, cols] = k_codes
            cache["k_scale"][rows, cols] = k_scale
            cache["v_codes"][rows, cols] = v_codes
            cache["v_scale"][rows, cols] = v_scale
            k_full = ops.dequantize_kv(cache["k_codes"], cache["k_scale"], k.dtype)
            v_full = ops.dequantize_kv(cache["v_codes"], cache["v_scale"], v.dtype)
        else:
            cache["k_raw"][rows, cols] = k
            cache["v_raw"][rows, cols] = v
            k_full, v_full = cache["k_raw"], cache["v_raw"]
        cache["index"] = offset + s
        k_pos = torch.arange(cl, device=q.device)
        mask = k_pos[None, None, :] <= cols[..., None]  # (b, s, cl)
        return _softmax_attention(q, k_full, v_full, mask[:, None])


class QuantTransformerBlock(nn.Module):
    """Pre-LN block: LN -> quantized attention -> residual; LN -> quantized
    dense FFN (or ``QuantMoE`` when ``n_experts > 0``) -> residual. With
    sign-binarized activations (binary, ``a_bits == 1``) the dense FFN's
    nonlinearity is the sign and there is no ReLU before it (ReLU then sign
    would be +1 everywhere); otherwise (dorefa's [0, 1] grid included) a ReLU
    precedes ``ffn_out``. The MoE has its own ReLU between its products."""

    def __init__(
        self,
        d_model: int,
        n_heads: int,
        d_ff: int,
        *,
        scheme: str = "binary",
        w_bits: int = 1,
        a_bits: int = 0,
        fsr: float = 0.0,
        n_experts: int = 0,
        capacity_factor: float = 2.0,
        causal: bool = True,
        cache_len: int = 0,
        kv_bits: Optional[int] = 8,
        attention_fn=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.ln1 = LayerNorm(d_model)
        self.attn = QuantAttention(
            d_model, n_heads, scheme=scheme, w_bits=w_bits, a_bits=a_bits, fsr=fsr,
            causal=causal, cache_len=cache_len, kv_bits=kv_bits, attention_fn=attention_fn,
            dtype=dtype,
        )
        self.ln2 = LayerNorm(d_model)
        if n_experts > 0:
            # built on the CPU with the other parameters; the bridge moves them
            self.moe = QuantMoE(d_model, n_experts, d_ff, scheme=scheme, w_bits=w_bits, fsr=fsr,
                                capacity_factor=capacity_factor, dtype=dtype, device="cpu")
            return
        wq, aq = scheme_weight_quant(scheme, w_bits, fsr), _act_quant(scheme, a_bits)
        meta = dict(weight_quant=wq, input_quant=aq, scheme=scheme, w_bits=w_bits,
                    a_bits=a_bits, fsr=fsr, dtype=dtype)
        self.ffn_in = QuantDense(d_model, d_ff, **meta)
        self.ffn_out = QuantDense(d_ff, d_model, **meta)
        self.sign_act = a_bits == 1 and scheme in ("binary", "xnor")

    def forward(self, x: torch.Tensor, cache: Optional[Dict] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), cache)
        if hasattr(self, "moe"):
            return x + self.moe(self.ln2(x))
        ff = self.ffn_in(self.ln2(x))
        if not self.sign_act:
            ff = torch.relu(ff)
        return x + self.ffn_out(ff)


class QuantTransformerLM(nn.Module):
    """Causal LM over the quantized blocks: float32 embedding, learned
    positions and tied head; everything between is scheme-quantized.

    ``forward(tokens)`` gives (b, s, vocab) logits. In decode mode
    ``forward(tokens, cache=None)`` gives ``(logits, cache)``; ``None``
    starts from a fresh cache on the tokens' device.
    """

    def __init__(
        self,
        vocab: int,
        d_model: int = 128,
        n_heads: int = 4,
        n_layers: int = 2,
        d_ff: int = 256,
        max_len: int = 256,
        *,
        scheme: str = "binary",
        w_bits: int = 1,
        a_bits: int = 0,
        fsr: float = 0.0,
        n_experts: int = 0,
        capacity_factor: float = 2.0,
        decode: bool = False,
        kv_bits: Optional[int] = 8,
        attention_fn=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.vocab, self.d_model, self.n_heads = vocab, d_model, n_heads
        self.n_layers, self.d_ff, self.max_len = n_layers, d_ff, max_len
        self.scheme, self.w_bits, self.a_bits = scheme, w_bits, a_bits
        self.n_experts, self.decode, self.kv_bits = n_experts, decode, kv_bits
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.embed = nn.Embedding(vocab, d_model)
        self.pos_embed = nn.Parameter(torch.randn(max_len, d_model) * 0.02)
        for i in range(n_layers):
            self.add_module(f"block{i}", QuantTransformerBlock(
                d_model, n_heads, d_ff, scheme=scheme, w_bits=w_bits, a_bits=a_bits,
                fsr=fsr, n_experts=n_experts, capacity_factor=capacity_factor,
                cache_len=max_len, kv_bits=kv_bits,
                attention_fn=attention_fn, dtype=dtype,
            ))
        self.ln_f = LayerNorm(d_model)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.n_layers)]

    def init_cache(self, b: int, device="cuda") -> Dict:
        """A fresh decode cache for ``b`` slots on ``device`` (the card
        unless ``device="cpu"``; raises without a GPU), every cursor at 0."""
        device = resolve_device(device)
        hd = self.d_model // self.n_heads
        cache = {
            f"block{i}": {"attn": blk.attn.init_cache(b, hd, device)}
            for i, blk in enumerate(self.blocks())
        }
        cache["pos_index"] = torch.zeros((b,), dtype=torch.int32, device=device)
        return cache

    def forward(self, tokens: torch.Tensor, cache: Optional[Dict] = None):
        b, s = tokens.shape
        x = self.embed.weight[tokens]
        if self.decode:
            if cache is None:
                cache = self.init_cache(b, device=tokens.device)
            offset = cache["pos_index"]
            cache["pos_index"] = offset + s
            idx = offset[:, None].long() + torch.arange(s, device=tokens.device)[None, :]
            x = x + self.pos_embed[idx.clamp(0, self.max_len - 1)]
        else:
            if cache is not None:
                raise ValueError("a cache was given to a model not in decode mode")
            x = x + self.pos_embed[None, :s]
        x = x.to(self.dtype or x.dtype)
        for i, blk in enumerate(self.blocks()):
            x = blk(x, cache[f"block{i}"]["attn"] if self.decode else None)
        logits = self.ln_f(x) @ self.embed.weight.T
        return (logits, cache) if self.decode else logits
