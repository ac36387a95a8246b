"""Grouped-planar bit packing: the layout of the packed GEMM kernels.

Counterpart of ``pytorch_quantize_impls_tpu/ops/pack.py`` (its
``pack_bitplanes``/``unpack_bitplanes``, the DoReFa code encodings and the
log (sign, exponent) codes); the
words are bit-identical, which
is what lets packed artifacts move between the two packages. Codes are
packed along the *contraction* axis (-2):

  factor   f = 32 // bits          codes per 32-bit word
  group    GROUP_ROWS = 32 words   covering group_k = f * 32 k-rows
  word[g * 32 + r, n] holds ``codes[g * group_k + i * 32 + r, n]``
  in bit field ``[bits*i, bits*(i+1))``.

Words are ``int32`` tensors holding the uint32 bit pattern: PyTorch has no
``>>``/``<<`` for ``uint32`` on the CPU, and ``int32`` ``>>`` is
arithmetic, so every right shift is followed by a mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SUPPORTED_BITS = (1, 2, 4, 8)
GROUP_ROWS = 32


def pack_factor(bits: int) -> int:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    return 32 // bits


def planar_group_k(bits: int) -> int:
    """K-rows covered by one self-contained packed group."""
    return pack_factor(bits) * GROUP_ROWS


def pack_bitplanes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Grouped-planar-pack unsigned codes along axis -2 into int32 words.

    K (axis -2) is zero-padded to a multiple of ``planar_group_k(bits)``.
    """
    f = pack_factor(bits)
    gk = planar_group_k(bits)
    k, n = codes.shape[-2:]
    kp = -(-k // gk) * gk
    c = F.pad(codes.to(torch.int64), (0, 0, 0, kp - k))
    lead = c.shape[:-2]
    c = c.reshape(*lead, kp // gk, f, GROUP_ROWS, n)
    shifts = torch.arange(f, device=c.device, dtype=torch.int64) * bits
    # bit fields are disjoint, so the sum is the bitwise or
    words = (c << shifts.reshape(f, 1, 1)).sum(dim=-3)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).reshape(*lead, (kp // gk) * GROUP_ROWS, n)


def unpack_bitplanes(word: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_bitplanes`; returns int32 codes, axis -2 = k."""
    f = pack_factor(bits)
    r, n = word.shape[-2:]
    if r % GROUP_ROWS:
        raise ValueError(f"packed rows {r} not a multiple of {GROUP_ROWS}")
    lead = word.shape[:-2]
    w = word.to(torch.int32).reshape(*lead, r // GROUP_ROWS, 1, GROUP_ROWS, n)
    shifts = torch.arange(f, device=w.device, dtype=torch.int32) * bits
    c = (w >> shifts.reshape(f, 1, 1)) & (2**bits - 1)
    return c.reshape(*lead, (r // GROUP_ROWS) * f * GROUP_ROWS, n)[..., :k, :]


# --- DoReFa value <-> code encodings -----------------------------------------


def dorefa_weight_to_codes(wq: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa fake-quant weights (grid ``{2i/(2^k-1) - 1}``) -> codes i."""
    n = float(2**bits - 1)
    return torch.round((wq + 1.0) * 0.5 * n).to(torch.int32)


def codes_to_dorefa_weight(c: torch.Tensor, bits: int, dtype=torch.float32) -> torch.Tensor:
    n = float(2**bits - 1)
    return (2.0 * c.to(dtype) / n - 1.0).to(dtype)


def dorefa_act_to_codes(aq: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa fake-quant activations (grid ``{i/(2^k-1)}``) -> codes i."""
    n = float(2**bits - 1)
    return torch.round(aq * n).to(torch.int32)


# --- log (sign, exponent index) <-> code encoding -----------------------------


def log_to_codes(sign: torch.Tensor, exp_idx: torch.Tensor, bits: int) -> torch.Tensor:
    """(sign, exponent index) from ``ops.log_quant_exponent`` -> int32 codes.

    The index takes ``2^bits + 1`` values, so it needs ``bits + 1`` bits; the
    sign sits at bit ``bits + 1`` and 1 means POSITIVE (IEEE's sign bit 1
    means negative). ``bits + 2`` bits in all, packed at 8 bits."""
    sign_bit = (sign > 0).to(torch.int32)
    return (sign_bit << (bits + 1)) | torch.clamp(exp_idx.to(torch.int32), 0, 2**bits)


def codes_to_log(c: torch.Tensor, bits: int):
    """Inverse of :func:`log_to_codes`: (sign ±1, exponent index), int32."""
    c = c.to(torch.int32)
    sign = 2 * ((c >> (bits + 1)) & 1) - 1
    return sign, c & (2 ** (bits + 1) - 1)
