#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorch_quantize_impls_tpu_torch``)
on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and refuses to run
   without a CUDA device: there is no CPU fallback.
2. Builds every CUDA kernel from ``pytorch_quantize_impls_tpu_torch/csrc``
   with nvcc, one process per source, all at once.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and at edge shapes: K1 binary_gemm, K2
   decode_binary_weights, K3 int8_gemm, K5 int8_conv2d, K6 dorefa_gemm and
   K7 decode_dorefa_weights bit for bit, K9 decode_log_weights bit for bit
   as int16 patterns, K4 decode_attention within a float32 tolerance, K8
   shift_gemm within 1e-5 of |bf16(x)| @ |w| per element. Prints kernel,
   plain, library-call and bound times.
4. Main path 1, BNN LeNet (``bnn_lenet``, width 128) from seeded random
   weights: bridge -> pack_model -> save_packed -> load_packed ->
   InferenceEngine over the unprepared artifact (K1, K2, K5) -> prepare ->
   InferenceEngine over the prepared artifact (K2, K3, K5), from several
   client threads. Every answer is checked against packed_apply on its
   padded batch; unprepared, prepared and fake-quant agree exactly; a small
   input agrees with the CPU.
5. Main path 2, the 1-bit transformer LM that scripts/perf_bench.py serves
   (d 1024, 8 layers, cache 1024, W1A1, int8 KV) from seeded random weights:
   bridge -> export_fused_decode (int8 and packed) -> DecodeEngine(fused=)
   with 32 slots, 64 requests from 4 client threads (K4, K3, K1). Every
   batch the engines ran is replayed through fused_decode_apply of the other
   export and must give the same bits, tokens and final cache; the fused
   step is held against the fake-quant decode model, teacher-forced; at the
   JAX tests' size the two agree token for token.
6. Main path 3, the DoReFa ResNet-20 W4A4 at width 64 (scripts/perf_bench.py
   :211-213, fixed clip) from seeded weights with BatchNorm statistics
   calibrated on seeded images (the codes of each stage's input must spread
   over [0, 15]): pack_model -> save_packed -> load_packed ->
   InferenceEngine over the unprepared and the prepared artifact (K7, K5),
   then export_fused_resnet20 -> InferenceEngine.from_fused_resnet (K5).
   Every batch is replayed bit-equal (unprepared == prepared); direct ==
   im2col (K6) at the stride-2 stage-1 conv; packed and fused agree with
   fake-quant (argmax, logit gap within RESNET_LOGIT_TOL) and with the CPU.
7. Main path 4, the serving LM's shape with DoReFa W4A4: DecodeEngine(
   packed=) over the unprepared records (K6), then prepare() (K7) and the
   prepared records (K3); the same tokens for every request, and
   teacher-forced argmax against the fake-quant model.
8. Main path 5, the log-quant VGG-small (``logquant_vgg``, widths
   128..512, W4 log, fsr 1) from build_model with seeded weights and
   BatchNorm calibrated on seeded images: pack_model -> save_packed ->
   load_packed -> InferenceEngine over the unprepared records (K9 at every
   conv call, K8 at the head), then prepare() (K9) and the prepared records
   (no K8). Every batch is replayed bit-equal; packed against fake-quant
   (argmax, logits within the JAX seam tolerance), unprepared against
   prepared (the head's bf16 input rounding), direct (K9 + conv) against
   im2col (K8) at conv3, card against CPU.
9. Main path 6, the serving LM's shape with W4 log weights (fsr 0):
   DecodeEngine(packed=) over the unprepared records (K8 on every
   projection), then prepare() (K9) and the prepared records; each packed
   projection held to its fake-quant GEMM on the same input, and
   teacher-forced argmax against the fake-quant model.
10. For each main path the kernels' launch counters are zeroed just before
    it and read just after; each kernel of the path must be > 0.
11. Prints engine images/s, decode prefill ms and tokens/s, one JSON line
    with the kernels and their launches per path, and last
    ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, if any phase fails.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
WIDTH = 128
BUCKETS = (1, 4, 16, 64, 256)
CLIENTS = 4
REQUESTS_PER_CLIENT = 24
SMALL_M = (1, 16, 256)
PORT = "pytorch_quantize_impls_tpu_torch"

# the serving LM of scripts/perf_bench.py:273-276
LM_CFG = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=8, d_ff=4096, max_len=1024,
              scheme="binary", w_bits=1, a_bits=1, kv_bits=8)
# the JAX package's fused-decode test model, tests/test_fused_decode.py:22-28
SMALL_LM_CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64,
                    scheme="binary", w_bits=1, a_bits=1)
SLOTS = 32
DECODE_REQUESTS = 64
PROMPT_LENS = (16, 128)
MAX_NEW = 32
DECODE_BATCHES = (1, 8, 32)
PREFILL_LEN = 128
# Logits of the fused step against the fake-quant model where no ±1 code
# differs: the JAX package's own tolerance for this seam
# (tests/test_fused_decode.py:47); only LayerNorm statistics and the f32 head
# differ in summation order there.
LOGIT_TOL = 2e-4

# the production-width DoReFa ResNet-20 of scripts/perf_bench.py:211-213,
# W4A4 with the fixed [0, 1] clip, on CIFAR-10-shaped images
RESNET_WIDTH = 64
RESNET_SHAPE = (32, 32, 3)
RESNET_BATCH = BUCKETS[-1]
RESNET_CALIB = 256  # images whose statistics set every BatchNorm's
RESNET_EVAL = 512  # rows held against the fake-quant forward
RESNET_IM2COL_BATCH = 16
# Packed and fused logits against the fake-quant forward (and card against
# CPU). The block convs' k-bit grid amplifies float rounding: where a float32
# sum lands within an ulp of a .5 code boundary, the two paths round it to
# neighbouring codes, and such flips cascade through the later convs, so
# logits differ by about 1e-2 (on logits of std ~0.3) even where every
# integer is exact; against_fake_quant prints the spread. The JAX package
# holds this seam to 5e-2 (tests/test_infer.py:47): 99% of rows must be
# within it, and argmax must agree on 99% of rows.
RESNET_LOGIT_TOL = 5e-2
# The serving LM's shape, W4A4 DoReFa (scheme="dorefa"), served packed
W4A4_LM_CFG = dict(LM_CFG, scheme="dorefa", w_bits=4, a_bits=4)
# A packed projection against its fake-quant GEMM on the same input: the
# float32 sum of up to 4096 products of the fake-quant GEMM, in another order
# than the exact integer sum, is off by some tens of ulps of its largest
# output; this allows ~800 (2^-13)
W4A4_GEMM_RTOL = 1e-4
# End-to-end argmax of the W4A4 LM in lockstep: see lm_teacher_forced
W4A4_ARGMAX_FLOOR = 0.85

# BASELINE config 5, logquant_vgg (utils/config.py): VGG-small at its
# published widths 128/128/256/256/512/512, W4 log weights, fsr 1, on
# CIFAR-10-shaped images; its head is 8192 -> 10
VGG_CALIB = 256  # images whose statistics set every BatchNorm's
VGG_EVAL = 512  # rows held against the fake-quant forward
VGG_IM2COL_BATCH = 8  # conv3 as im2col: M 2048, K 2304, N 256
# Packed against fake-quant logits (and card against CPU): the JAX package's
# tolerance for this seam, tests/test_infer.py:50-52 (atol 5e-2, rtol 5e-2).
# The unprepared head rounds its input to bf16 (2^-9 relative) and the
# float32 sums run in another order; 99% of rows must have every logit
# within it, and argmax must agree on 99% of rows.
VGG_LOGIT_ATOL = VGG_LOGIT_RTOL = 5e-2
# K8 against its plain version: |K8 - plain| <= rtol * (|bf16(x)| @ |w|) per
# element, the JAX test's rtol (tests/test_kernels.py:162): the products are
# exact, only the order of the float32 sum differs
SHIFT_RTOL = 1e-5
# Rounding a value to bf16 moves it by at most 2^-9 of itself; an output of
# the unprepared (bf16 x) and the prepared (float32 x) path then differs by at
# most 2^-9 (|x| @ |w|) plus float32 sums: hazard bound 2^-8, plus SHIFT_RTOL
BF16_INPUT_RTOL = 2.0**-8
# The serving LM's shape with W4 log weights (weights only: a_bits 0), levels
# 2^-16 .. 2^0 (fsr 0); served packed through DecodeEngine(packed=)
LOG_LM_CFG = dict(LM_CFG, scheme="log", w_bits=4, a_bits=0, fsr=0.0)
# End-to-end argmax of the log LM in lockstep: no activation is quantized, so
# the prepared path (float32 x, the same weights) differs from fake-quant by
# float32 sum order only; the unprepared one also rounds every projection
# input to bf16
LOG_ARGMAX_FLOOR = {"prepared": 0.99, "unprepared": 0.95}

# NVIDIA H100 SXM published peaks (dense), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


def cuda():
    """The card this script runs on."""
    import torch

    return torch.device("cuda", 0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` per call on the card, by CUDA events over
    ``iters`` back-to-back calls (wrapper overhead included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the CUDA function each wrapper launches, as torch.profiler names it
KERNEL_SYMBOLS = {
    "binary_gemm": "binary_gemm_kernel", "decode_binary_weights": "decode_binary_kernel",
    "int8_gemm": "int8_gemm_kernel", "decode_attention": "decode_attention_kernel",
    "int8_conv2d": "int8_conv_kernel", "dorefa_gemm": "dorefa_gemm_kernel",
    "decode_dorefa_weights": "decode_dorefa_kernel", "shift_gemm": "shift_gemm_kernel",
    "decode_log_weights": "decode_log_kernel",
}


def device_times(fn, iters: int = 20):
    """Run ``fn`` ``iters`` times under torch.profiler (CUDA activity);
    returns ({kernel name: (device ms, launches) per call}, wall ms per
    call). Device times carry no host time; the wall clock ends in a
    synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / iters
    per_call = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us > 0:
            ms, n = per_call.get(e.key, (0.0, 0.0))
            per_call[e.key] = (ms + us / 1e3 / iters, n + e.count / iters)
    return per_call, wall


def profile_line(fn, unit: str, iters: int) -> str:
    """torch.profiler over ``iters`` calls of ``fn``: wall and device-busy
    ms per call, the idle share, launches, and the four largest kernels."""
    per_call, wall = device_times(fn, iters=iters)
    if not per_call:  # the profiler once saw no device activity at all: try again
        per_call, wall = device_times(fn, iters=iters)
    if not per_call:
        return f"profile: wall {wall:.3f} ms/{unit}; device time not measured (no device events)"
    busy = sum(ms for ms, _ in per_call.values())
    launches = sum(n for _, n in per_call.values())
    top = sorted(per_call.items(), key=lambda kv: -kv[1][0])[:4]
    return (f"profile: wall {wall:.3f} ms/{unit}, device busy {busy:.3f} ms "
            f"({100 * (1 - busy / wall):.1f}% idle) in {launches:.0f} launches; largest: "
            + "; ".join(f"{k[:48]} {ms:.3f} ms x{n:.0f}" for k, (ms, n) in top))


def kernel_device_ms(fn, kernel: str):
    """Device time per call of the kernel that ``kernel``'s wrapper
    launches, or None if the profiler saw no device time for it."""
    per_call, _ = device_times(fn)
    got = [ms for name, (ms, _) in per_call.items() if KERNEL_SYMBOLS[kernel] in name]
    return sum(got) if got else None


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    """(least time in ms, what sets it): bytes over the memory rate or
    operations over the peak rate for their type, whichever is larger."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- kernels vs plain versions ---------------------------------------------


def gemm_bound(m, k, n, w_bytes, scales):
    """K1/K3: x (M,K) int8 + weights + out (M,N) f32 (+ scales) once each;
    2*M*K*N int8 operations."""
    return bound_ms(m * k + w_bytes + 4 * m * n + scales, 2 * m * k * n, INT8_OPS_PER_S)


def attention_bound(b, h, cl, hd, lens):
    """K4: what these inputs need: q, the mask row and the output once, and
    the K/V codes and scales of the attended positions only (the kernel
    skips masked ones); 4 flops per attended code pair element."""
    valid = int(np.sum(lens)) * h
    nbytes = 4 * b * h * hd * 2 + 4 * b * cl + valid * (2 * hd + 8)
    return bound_ms(nbytes, 4 * valid * hd, F32_FLOPS_PER_S)


def kernel_cases(rng, dev):
    """Every comparison: dicts with the kernel, a label, the kernel call, its
    plain version, the library call (or None), the bound and whether it is
    the main-path shape reported in the JSON line."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as da
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def pm1(m, k):  # binarized activations
        return bg.binarize_to_int8(t(rng.normal(size=(m, k)).astype(np.float32)))

    def packed(k, n):
        return bg.pack_binary_weights(t(rng.normal(size=(k, n)).astype(np.float32)))

    def scales(m, n, use_alpha, use_row):
        alpha = t(rng.uniform(0.5, 1.5, n).astype(np.float32)) if use_alpha else None
        row = t(rng.uniform(0.5, 1.5, m).astype(np.float32)) if use_row else None
        return alpha, row

    def int_mm(m, k, n):
        """torch._int_mm takes M > 16 and K, N multiples of 8."""
        return m > 16 and k % 8 == 0 and n % 8 == 0

    cases = []
    # K2 at every layer's packed shape, and K = 2304 (decode once dropped the
    # last partial K tile there)
    for label, (k, n) in {
        "conv1 (32,128)": (25, 128), "conv2 (128,256)": (3200, 256),
        "fc1 (128,1024)": (4096, 1024), "head (32,10)": (1024, 10),
        "K=2304 (96,256)": (2304, 256),
    }.items():
        wp = packed(k, n)
        r = wp.shape[0]
        cases.append(dict(
            kernel="decode_binary_weights", label=label,
            fn=lambda wp=wp: bg.decode_binary_weights(wp),
            plain=lambda wp=wp: bg.decode_binary_weights_reference(wp),
            library=None, bound=bound_ms(4 * r * n + 32 * r * n, 0, INT8_OPS_PER_S),
            main=label.startswith("conv2"),
        ))
    # K1 and K3 at LeNet's fc1/head with M in SMALL_M and at the decode LM's
    # four projections (no scales: the binary scheme)
    gemm_shapes = [(f"{name} M={m}", m, k, n, False, False)
                   for name, k, n in (("fc1", 4096, 1024), ("head", 1024, 10))
                   for m in SMALL_M]
    gemm_shapes += [(f"lm {name} M={m}", m, k, n, False, False)
                    for name, k, n, ms in (
                        ("qkv", 1024, 3072, (1, 32)), ("out", 1024, 1024, (32,)),
                        ("ffn_in", 1024, 4096, (32,)), ("ffn_out", 4096, 1024, (1, 32)))
                    for m in ms]
    # edges: odd M, N=10 and odd N, un-padded K, K % 4 != 0, scales on/off
    gemm_shapes += [
        ("edge M=33 K=300 N=130 alpha+row", 33, 300, 130, True, True),
        ("edge M=255 K=2100 N=257 alpha", 255, 2100, 257, True, False),
        ("edge M=1 K=1000 N=10 row", 1, 1000, 10, False, True),
        ("edge M=17 K=301 N=64 alpha+row", 17, 301, 64, True, True),
    ]
    for label, m, k, n, ua, ur in gemm_shapes:
        main = label == "fc1 M=256"
        x = pm1(m, k)
        if label.startswith("edge M=17"):  # zeros, as in padding
            x = x * t(rng.integers(0, 2, size=(m, k)).astype(np.int8))
        wp = packed(k, n)
        alpha, row = scales(m, n, ua, ur)
        nscale = 4 * ((n if ua else 0) + (m if ur else 0))
        lib = int_mm(m, k, n) and not (ua or ur)
        w8 = bg.decode_binary_weights(wp)[:k].contiguous() if lib else None
        cases.append(dict(
            kernel="binary_gemm", label=label,
            fn=lambda x=x, wp=wp, a=alpha, r=row: bg.binary_gemm(x, wp, a, r),
            plain=lambda x=x, wp=wp, a=alpha, r=row: bg.binary_gemm_reference(x, wp, a, r),
            library=(lambda x=x, w=w8: torch._int_mm(x, w)) if lib else None,
            bound=gemm_bound(m, k, n, 4 * wp.numel(), nscale), main=main,
        ))
        xi = t(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
        wi = t(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
        cases.append(dict(
            kernel="int8_gemm", label=label,
            fn=lambda x=xi, w=wi, a=alpha, r=row: im.int8_gemm(x, w, a, r),
            plain=lambda x=xi, w=wi, a=alpha, r=row: im.int8_gemm_reference(x, w, a, r),
            library=(lambda x=xi, w=wi: torch._int_mm(x, w)) if lib else None,
            bound=gemm_bound(m, k, n, k * n, nscale), main=main,
        ))
    # K4 at the decode LM's shapes (h 8, cache 1024, hd 128) with per-slot
    # cursors: as the engine has them (prompt 16..128 + up to 32 new), spread
    # over the whole cache, and full; then edge shapes
    hi = PROMPT_LENS[1] + MAX_NEW
    attn_shapes = [
        ("b=32 engine cursors", 32, 8, 1024, 128, rng.integers(PROMPT_LENS[0] + 1, hi + 1, 32)),
        ("b=1 varied", 1, 8, 1024, 128, rng.integers(1, 1025, 1)),
        ("b=8 varied", 8, 8, 1024, 128, rng.integers(1, 1025, 8)),
        ("b=32 varied", 32, 8, 1024, 128, rng.integers(1, 1025, 32)),
        ("b=32 full", 32, 8, 1024, 128, np.full(32, 1024)),
        ("edge cl=1", 3, 8, 1, 128, np.ones(3, int)),
        ("edge cl=37 hd=64 b=5", 5, 4, 37, 64, np.array([1, 37, 20, 2, 36])),
        ("edge hd=64 one valid row", 3, 8, 1024, 64, np.array([1, 512, 1024])),
        ("edge hd=16 b=7", 7, 2, 300, 16, rng.integers(1, 301, 7)),
    ]
    for label, b, h, cl, hd, lens in attn_shapes:
        q = t(rng.normal(size=(b, h, hd)).astype(np.float32))
        kc = t(rng.integers(-127, 128, (b, h, cl, hd)).astype(np.int8))
        vc = t(rng.integers(-127, 128, (b, h, cl, hd)).astype(np.int8))
        ks = t(rng.uniform(0.01, 0.1, (b, h, cl)).astype(np.float32))
        vs = t(rng.uniform(0.01, 0.1, (b, h, cl)).astype(np.float32))
        bias = t(np.where(np.arange(cl)[None, :] < lens[:, None], 0.0, -1e30).astype(np.float32))
        args = (q, kc, ks, vc, vs, bias)
        cases.append(dict(
            kernel="decode_attention", label=label,
            fn=lambda a=args: da.decode_attention(*a),
            plain=lambda a=args: da.decode_attention_reference(*a),
            library=None, sdpa=sdpa_yardstick(args),
            bound=attention_bound(b, h, cl, hd, lens),
            full_bound=attention_bound(b, h, cl, hd, np.full(b, cl)),
            main=label == "b=32 engine cursors",
        ))
    return cases


def resnet_convs():
    """The DoReFa ResNet-20's block convs at RESNET_WIDTH: (label, input
    size, cin, cout, stride), one of each shape."""
    w = RESNET_WIDTH
    return (
        (f"stage0 conv 32x32x{w}", 32, w, w, 1),
        (f"stage1 conv1 s2 32x32x{w}", 32, w, 2 * w, 2),
        (f"stage1 conv 16x16x{2 * w}", 16, 2 * w, 2 * w, 1),
        (f"stage2 conv1 s2 16x16x{2 * w}", 16, 2 * w, 4 * w, 2),
        (f"stage2 conv 8x8x{4 * w}", 8, 4 * w, 4 * w, 1),
    )


def lm_gemms(cfg: dict):
    """The LM's projection GEMMs (name, K, N), one per GEMM_INPUTS entry."""
    d, ff = cfg["d_model"], cfg["d_ff"]
    return (("qkv", d, d), ("out", d, d), ("ffn_in", d, ff), ("ffn_out", ff, d))


def kbit_cases(rng, dev):
    """K5 int8_conv2d, K6 dorefa_gemm and K7 decode_dorefa_weights: every
    shape the ResNet (b = RESNET_BATCH) and W4A4 LM paths give them, the
    im2col cross-check's, BNN LeNet's conv2, and edges. Same dicts as
    :func:`kernel_cases`."""
    import torch
    import torch.nn.functional as F

    from pytorch_quantize_impls_tpu_torch import ops
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def dorefa_packed(k, n, w_bits):
        w = t(rng.normal(size=(k, n)).astype(np.float32))
        return pm.pack_dorefa_weights(ops.dorefa_weight(w, w_bits), w_bits)

    cases = []
    # K7 at every ResNet block conv's and LM projection's weights, then edges
    k7 = {f"resnet {label} ({9 * cin},{cout})": (9 * cin, cout, 4)
          for label, _, cin, cout, _ in resnet_convs()}
    k7.update({f"lm {name} ({k},{n})": (k, n, 4) for name, k, n in lm_gemms(W4A4_LM_CFG)})
    k7.update({"edge w2 K=300 N=10": (300, 10, 2), "edge w1 K=1500 N=130": (1500, 130, 1),
               "edge w4 K=25 N=7": (25, 7, 4)})
    for label, (k, n, w_bits) in k7.items():
        wp = dorefa_packed(k, n, w_bits)
        r = wp.shape[0]
        cases.append(dict(
            kernel="decode_dorefa_weights", label=label,
            fn=lambda wp=wp, b=w_bits: pm.decode_dorefa_weights(wp, w_bits=b),
            plain=lambda wp=wp, b=w_bits: pm.decode_dorefa_weights_reference(wp, w_bits=b),
            library=None, bound=bound_ms(4 * r * n + r * (32 // w_bits) * n, 0, INT8_OPS_PER_S),
            main=label.startswith("resnet stage2 conv 8x8"),
        ))
    # K6 at the LM's GEMMs (decode step M = SLOTS, prefill M = 128), the
    # im2col cross-check of the stage-1 stride-2 conv (RESNET_IM2COL_BATCH
    # images), then edges over w_bits x a_bits, M = 1, ragged N, K off the
    # group and K % 4 != 0
    w = RESNET_WIDTH
    k6 = [(f"lm {name} M={m}", m, k, n, 4, 4)
          for name, k, n in lm_gemms(W4A4_LM_CFG) for m in (SLOTS, 128)]
    k6 += [(f"resnet im2col stage1 conv1 b={RESNET_IM2COL_BATCH}",
            RESNET_IM2COL_BATCH * 16 * 16, 9 * w, 2 * w, 4, 4)]
    k6 += [("edge M=1 K=576 N=64 w4a4", 1, 576, 64, 4, 4),
           ("edge M=33 K=2304 N=130 w4a2", 33, 2304, 130, 4, 2),
           ("edge M=17 K=301 N=64 w4a1", 17, 301, 64, 4, 1),
           ("edge M=64 K=700 N=24 w2a4", 64, 700, 24, 2, 4),
           ("edge M=5 K=300 N=40 w2a2", 5, 300, 40, 2, 2),
           ("edge M=8 K=1500 N=24 w1a1", 8, 1500, 24, 1, 1),
           ("edge M=3 K=64 N=8 w1a4", 3, 64, 8, 1, 4)]
    for label, m, k, n, w_bits, a_bits in k6:
        a = t(rng.integers(0, 2**a_bits, size=(m, k)).astype(np.int8))
        wp = dorefa_packed(k, n, w_bits)
        lib = m > 16 and k % 8 == 0 and n % 8 == 0  # torch._int_mm's shape rules
        w8 = pm.decode_dorefa_weights(wp, w_bits=w_bits)[:k].contiguous() if lib else None
        cases.append(dict(
            kernel="dorefa_gemm", label=label,
            fn=lambda a=a, wp=wp, wb=w_bits, ab=a_bits: pm.dorefa_gemm(a, wp, w_bits=wb, a_bits=ab),
            plain=lambda a=a, wp=wp, wb=w_bits, ab=a_bits: pm.dorefa_gemm_reference(
                a, wp, w_bits=wb, a_bits=ab),
            library=(lambda a=a, w8=w8: torch._int_mm(a, w8)) if lib else None,
            bound=gemm_bound(m, k, n, 4 * wp.numel(), 0), main=label == f"lm ffn_in M={SLOTS}",
        ))
    # K5 at the ResNet's block convs (b = RESNET_BATCH): the packed path's
    # scale epilogue at every shape, the fused path's codes and affine ones
    # at stage 1; BNN LeNet's conv2 (±1, no scale); then edges
    n_a = 15
    conv_cases = [(label, RESNET_BATCH, h, cin, cout, 3, (s, s), "SAME", "scale")
                  for label, h, cin, cout, s in resnet_convs()]
    conv_cases += [(f"stage1 conv 16x16x{2 * w} {epi}", RESNET_BATCH, 16, 2 * w, 2 * w, 3,
                    (1, 1), "SAME", epi) for epi in ("codes", "affine")]
    conv_cases += [(f"bnn_lenet conv2 12x12x{WIDTH}", BUCKETS[-1], 12, WIDTH, 2 * WIDTH, 5,
                    (1, 1), "VALID", "none")]
    conv_cases += [
        ("edge b=1 3x3 VALID C=5 N=7 -> 1x1", 1, 3, 5, 7, 3, (1, 1), "VALID", "scale"),
        ("edge 5x5 VALID C=6 N=10 codes", 2, 12, 6, 10, 5, (1, 1), "VALID", "codes"),
        ("edge 1x1 s2 SAME C=12 N=20 affine", 3, 9, 12, 20, 1, (2, 2), "SAME", "affine"),
        ("edge s2 SAME 15x15 C=64 N=130", 2, 15, 64, 130, 3, (2, 2), "SAME", "scale"),
        ("edge s2 SAME 16x16 C=3 N=65 codes", 2, 16, 3, 65, 3, (2, 2), "SAME", "codes"),
        ("edge pads ((1,2),(0,1)) s(2,1) C=33", 2, 15, 33, 70, 3, (2, 1), ((1, 2), (0, 1)),
         "affine"),
        ("edge codes ties a=0.5 b=0", 2, 8, 16, 20, 3, (1, 1), "SAME", "ties"),
    ]
    for label, b, h, cin, cout, k, strides, padding, epi in conv_cases:
        kk = cin * k * k
        if label.startswith("bnn_lenet"):
            x = t(np.where(rng.normal(size=(b, h, h, cin)) >= 0, 1, -1).astype(np.int8))
            wc = t(np.where(rng.normal(size=(kk, cout)) >= 0, 1, -1).astype(np.int8))
        else:
            x = t(rng.integers(0, n_a + 1, size=(b, h, h, cin)).astype(np.int8))
            wc = t((2 * rng.integers(0, 16, size=(kk, cout)) - 15).astype(np.int8))
        pads = conv_pads(padding, (h, h), (k, k), strides)
        # codes: y = a acc + b spread over [0, n_a] (acc's spread is about
        # 1e3 sqrt(K) for uniform codes); ties: every odd acc lands on .5
        acc_scale = n_a / (4.0e3 * np.sqrt(kk))
        a = b_ = None
        if epi == "scale":
            a = t(rng.uniform(0.5, 1.5, cout).astype(np.float32) / np.float32(1e3))
        elif epi in ("codes", "affine"):
            a = t((rng.uniform(0.5, 1.5, cout) * acc_scale).astype(np.float32))
            b_ = t(rng.uniform(0, n_a, cout).astype(np.float32))
        elif epi == "ties":
            a, b_ = t(np.full(cout, 0.5, np.float32)), t(np.zeros(cout, np.float32))
        kind = {"none": "scale", "ties": "codes"}.get(epi, epi)
        args = (x, wc, (k, k), strides, pads, kind, a, b_, n_a)
        (pt, pb), (pl, pr) = pads
        ho, wo = ic.out_size(h, k, strides[0], pads[0]), ic.out_size(h, k, strides[1], pads[1])
        m = b * ho * wo
        xf = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (pl, pr, pt, pb))
        wf = wc.T.reshape(cout, cin, k, k).to(torch.float32).contiguous()

        def cudnn(xf=xf, wf=wf, strides=strides):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return F.conv2d(xf, wf, stride=strides)

        out_bytes = m * cout * (1 if kind == "codes" else 4)
        nvec = (a is not None) + (b_ is not None)
        cases.append(dict(
            kernel="int8_conv2d", label=label,
            fn=lambda args=args: ic.int8_conv2d(*args),
            plain=lambda args=args: ic.int8_conv2d_reference(*args),
            library=cudnn,
            bound=bound_ms(x.numel() + wc.numel() + out_bytes + 4 * cout * nvec,
                           2 * m * kk * cout, INT8_OPS_PER_S),
            main=label == f"stage1 conv 16x16x{2 * w}",
        ))
    return cases


def vgg_convs(widths):
    """LogQuantVGGSmall's convs: (label, input size, cin, cout), a 2x2 pool
    after every second one."""
    convs, hw, cin = [], RESNET_SHAPE[0], RESNET_SHAPE[2]
    for i, w in enumerate(widths):
        convs.append((f"conv{i} {hw}x{hw}x{cin}", hw, cin, w))
        cin = w
        if i % 2 == 1:
            hw //= 2
    return convs


def log_cases(rng, dev):
    """K8 shift_gemm and K9 decode_log_weights: every shape the VGG and log
    LM paths give them, conv3 as im2col, and edges (K off the 128-row group,
    N = 10, (fsr, bits) = (0, 3) and (1, 6)). Same dicts as
    :func:`kernel_cases`, plus ``abs_ref``, K8's |bf16(x)| @ |w| in float64,
    and ``cublas_bf16``, the bf16 tensor-core yardstick."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def packed(k, n, fsr, bits):
        w = t(rng.normal(size=(k, n)).astype(np.float32) * np.float32((2.0 / k) ** 0.5))
        return sm.pack_log_weights(w, fsr, bits)

    cfg = RunConfig(**SCHEME_CONFIGS["logquant_vgg"])
    vgg = (cfg.fsr, cfg.w_bits)
    lm = (LOG_LM_CFG["fsr"], LOG_LM_CFG["w_bits"])
    head_k = 512 * 4 * 4
    cases = []
    # K9 at every VGG conv's and the head's weights (prepare), the log LM's
    # projections, then edges
    k9 = {f"vgg {label} ({9 * cin},{cout})": (9 * cin, cout, *vgg)
          for label, _, cin, cout in vgg_convs((128, 128, 256, 256, 512, 512))}
    k9[f"vgg head ({head_k},10)"] = (head_k, 10, *vgg)
    k9.update({f"lm {name} ({k},{n})": (k, n, *lm) for name, k, n in lm_gemms(LOG_LM_CFG)})
    k9.update({"edge K=300 N=10 fsr0 b3": (300, 10, 0.0, 3),
               "edge K=27 N=7 fsr1 b6": (27, 7, 1.0, 6),
               "edge K=2100 N=130 fsr0 b4": (2100, 130, 0.0, 4)})
    for label, (k, n, fsr, bits) in k9.items():
        wp = packed(k, n, fsr, bits)
        r = wp.shape[0]
        cases.append(dict(
            kernel="decode_log_weights", label=label,
            fn=lambda wp=wp, f=fsr, b=bits: sm.decode_log_weights(wp, fsr=f, bits=b),
            plain=lambda wp=wp, f=fsr, b=bits: sm.decode_log_weights_reference(wp, fsr=f, bits=b),
            library=None, bound=bound_ms(4 * r * n + 2 * 4 * r * n, 0, BF16_FLOPS_PER_S),
            main=label.startswith("vgg conv5"),
        ))
    # K8 at the VGG head (M = 1, 16, 256), the log LM's projections at
    # M = SLOTS, conv3 as im2col, then edges
    k8 = [(f"vgg head M={m}", m, head_k, 10, *vgg) for m in SMALL_M]
    k8 += [(f"lm {name} M={SLOTS}", SLOTS, k, n, *lm) for name, k, n in lm_gemms(LOG_LM_CFG)]
    k8 += [(f"vgg im2col conv3 b={VGG_IM2COL_BATCH}", VGG_IM2COL_BATCH * 16 * 16, 9 * 256, 256,
            *vgg)]
    k8 += [("edge M=1 K=27 N=128 fsr1 b4", 1, 27, 128, 1.0, 4),
           ("edge M=33 K=300 N=10 fsr0 b3", 33, 300, 10, 0.0, 3),
           ("edge M=70 K=2100 N=130 fsr1 b6", 70, 2100, 130, 1.0, 6),
           ("edge M=5 K=128 N=65 fsr0 b4", 5, 128, 65, 0.0, 4)]
    for label, m, k, n, fsr, bits in k8:
        x = t(rng.normal(size=(m, k)).astype(np.float32))
        wp = packed(k, n, fsr, bits)
        wb = sm.decode_log_weights(wp, fsr=fsr, bits=bits)[:k].contiguous()
        xb = x.to(torch.bfloat16)
        xf, wf = xb.to(torch.float32), wb.to(torch.float32)
        cases.append(dict(
            kernel="shift_gemm", label=label,
            fn=lambda x=x, wp=wp, f=fsr, b=bits: sm.shift_gemm(x, wp, fsr=f, bits=b),
            plain=lambda x=x, wp=wp, f=fsr, b=bits: sm.shift_gemm_reference(x, wp, fsr=f, bits=b),
            # the same function in one PyTorch call: float32 matmul of the
            # bf16 values (TF32 off)
            library=lambda xf=xf, wf=wf: torch.matmul(xf, wf),
            cublas_bf16=lambda xb=xb, wb=wb: torch.matmul(xb, wb),
            abs_ref=lambda xf=xf, wf=wf: xf.abs().double() @ wf.abs().double(),
            bound=bound_ms(4 * m * k + 4 * wp.numel() + 4 * m * n, 2 * m * k * n,
                           BF16_FLOPS_PER_S),
            main=label == f"lm ffn_in M={SLOTS}",
        ))
    return cases


def sdpa_yardstick(args):
    """No one PyTorch call computes decode attention over int8 codes and
    scales. As a labelled yardstick only: scaled_dot_product_attention over
    K/V dequantized to float32 beforehand (outside the timed call)."""
    import torch
    import torch.nn.functional as F

    q, kc, ks, vc, vs, bias = args
    kf = kc.to(torch.float32) * ks[..., None]
    vf = vc.to(torch.float32) * vs[..., None]
    mask = bias[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q[:, :, None, :], kf, vf, attn_mask=mask)[:, :, 0]


def check_kernels(card: str, timed: bool = True):
    """Compare every kernel with its plain version on the card: K1-K3 and
    K5-K7 bit for bit, K9 bit for bit as int16 patterns, K4 within ``rtol
    1e-5, atol 1e-5 * max|plain|`` (float32 sums over up to 1024 positions
    in another order; exp carries an ulp of a score near 20, 2e-6, into every
    probability), K8 within ``SHIFT_RTOL * (|bf16(x)| @ |w|)`` per element.
    K4 and K8 must also give the same bits twice. Returns {kernel: summary
    for the JSON line}."""
    import torch

    dev = cuda()
    rng = np.random.default_rng(SEED)
    summary = {}
    for c in kernel_cases(rng, dev) + kbit_cases(rng, dev) + log_cases(rng, dev):
        kernel, label, fn, plain = c["kernel"], c["label"], c["fn"], c["plain"]
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            fail(f"{kernel} {label}: {got.dtype} {tuple(got.shape)} vs plain "
                 f"{ref.dtype} {tuple(ref.shape)}")
        err = (got.double() - ref.double()).abs().max().item()
        if kernel == "decode_attention":
            scale = ref.abs().max().item()
            if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * scale):
                fail(f"{kernel} {label}: max |err| {err} beyond 1e-5 of max |plain| {scale}")
            if not torch.equal(got, fn()):
                fail(f"{kernel} {label}: two launches gave different bits")
            verdict = f"max |err| {err:.3g} (of {scale:.3g}), deterministic"
        elif kernel == "shift_gemm":
            bound = c["abs_ref"]()
            ratio = ((got.double() - ref.double()).abs() / bound.clamp_min(1e-300)).max().item()
            if not ((got.double() - ref.double()).abs() <= SHIFT_RTOL * bound).all():
                fail(f"{kernel} {label}: |err| / (|bf16(x)| @ |w|) reaches {ratio:.3g}, beyond "
                     f"{SHIFT_RTOL}")
            if not torch.equal(got, fn()):
                fail(f"{kernel} {label}: two launches gave different bits")
            verdict = f"max |err| {err:.3g}, largest |err| / (|x|@|w|) {ratio:.3g}, deterministic"
        elif kernel == "decode_log_weights":
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                n = int((got.view(torch.int16) != ref.view(torch.int16)).sum())
                fail(f"{kernel} {label}: {n} bf16 patterns differ from its plain version")
            verdict = "bit-equal (int16 patterns)"
        else:
            if not torch.equal(got, ref):
                fail(f"{kernel} {label}: differs from its plain version, max |err| {err}")
            verdict = "bit-equal"
        s = summary.setdefault(kernel, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        line = f"check {kernel:22s} {label:32s} {verdict}"
        if timed and not label.startswith("edge"):
            ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
            dev_ms = kernel_device_ms(fn, kernel)
            bms, by = c["bound"]
            lib_ms = cuda_ms(c["library"]) if c["library"] else None
            line += (f"  kernel {ms:.4f} ms (device "
                     f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'})  plain "
                     f"{plain_ms:.4f} ms  bound {bms:.4f} ms ({by})  library "
                     f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
            extra = {"device_ms": dev_ms}
            if "sdpa" in c:
                sdpa_ms = cuda_ms(c["sdpa"])
                yard_err = (c["sdpa"]() - ref).abs().max().item()
                line += (f"  [yardstick: SDPA on dequantized f32 K/V {sdpa_ms:.4f} ms, "
                         f"max |diff| {yard_err:.3g}; full-cache bound "
                         f"{c['full_bound'][0]:.4f} ms]")
                extra["sdpa_dequantized_ms"] = sdpa_ms
            if "cublas_bf16" in c:
                bf16_ms = cuda_ms(c["cublas_bf16"])
                line += f"  [yardstick: cuBLAS bf16 matmul on decoded weights {bf16_ms:.4f} ms]"
                extra["cublas_bf16_ms"] = bf16_ms
            line += f"  [{card}]"
            if c["main"]:
                s.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib_ms, shape=label, **extra)
        print(line, flush=True)
    return summary


# --- main path 1: BNN LeNet -------------------------------------------------


def seeded_variables(width: int, rng) -> dict:
    """BNN LeNet variables in the JAX package's (flax) layout, as numpy.
    BatchNorm statistics are set to the scale of each layer's output (an
    integer sum of cin*kh*kw or K terms of ±1) so every sign sees a spread
    of values around its threshold."""
    w = width

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def bn(c, fan_in):
        return (
            {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32), "bias": normal(c, scale=0.1)},
            {"mean": normal(c, scale=0.2 * np.sqrt(fan_in)),
             "var": (fan_in * rng.uniform(0.5, 2.0, c)).astype(np.float32)},
        )

    p, s = {}, {}
    p["conv1"] = {"conv": {"kernel": normal(5, 5, 1, w, scale=0.2)}}
    p["bn1"], s["bn1"] = bn(w, 25)
    p["conv2"] = {"conv": {"kernel": normal(5, 5, w, 2 * w, scale=0.05)}}
    p["bn2"], s["bn2"] = bn(2 * w, 25 * w)
    p["fc1"] = {"dense": {"kernel": normal(32 * w, 8 * w, scale=0.02)}}
    p["bn3"], s["bn3"] = bn(8 * w, 32 * w)
    p["head"] = {"dense": {"kernel": normal(8 * w, 10, scale=0.03)}}
    return {"params": p, "batch_stats": s}


def serve(submit, n: int):
    """Call ``submit(i)`` for i < n from CLIENTS threads with small random
    gaps; return the futures' results in order."""
    answers = [None] * n
    errors = []

    def client(idx):
        r = np.random.default_rng(SEED + 1 + idx[0])
        try:
            futs = []
            for i in idx:
                futs.append((i, submit(i)))
                time.sleep(r.uniform(0, 1e-3))
            for i, f in futs:
                answers[i] = f.result(timeout=300)
        except Exception as e:  # reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(list(range(c, n, CLIENTS)),))
               for c in range(CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            fail("a client thread did not finish")
    if errors:
        fail(f"a request failed: {errors[0]!r}")
    return answers


def all_kernels():
    """Every kernel wrapper of the port, K1-K9, in the JSON line's order."""
    from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as da
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

    return (bg.binary_gemm, bg.decode_binary_weights, im.int8_gemm, da.decode_attention,
            ic.int8_conv2d, pm.dorefa_gemm, pm.decode_dorefa_weights, sm.shift_gemm,
            sm.decode_log_weights)


def zero_launches() -> None:
    for k in all_kernels():
        k.launches = 0


def read_launches(path: str, required) -> dict:
    """Every kernel's count since zero_launches; each kernel in ``required``
    (the path's) must be > 0."""
    import torch

    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in all_kernels()}
    print(f"launches on the {path} path: {launches}", flush=True)
    for k in required:
        if launches[k.__name__] <= 0:
            fail(f"kernel {k.__name__} was not launched on the {path} path")
    return launches


def drive_main_path(card: str, model, example_shape, inputs):
    """The main path, from a packed model to served answers: save_packed ->
    load_packed -> InferenceEngine (unprepared artifact) -> prepare ->
    InferenceEngine (prepared artifact). The kernels' launch counters are
    zeroed just before and read just after. Returns (loaded artifact, engine
    answers and logged (batch, output) pairs per artifact, launch counts)."""
    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine

    dev = cuda()
    # conv2 runs K2 + K5, fc1 and head K1 (unprepared) or K3 (prepared)
    kernels = (bg.binary_gemm, bg.decode_binary_weights, im.int8_gemm, ic.int8_conv2d)
    logs = {"unprepared": [], "prepared": []}
    answers = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bnn_lenet.npz")
        infer.save_packed(path, infer.pack_model(model))
        zero_launches()
        loaded = infer.load_packed(path, device=dev)
        for name in ("unprepared", "prepared"):
            recs = loaded if name == "unprepared" else infer.prepare(loaded)

            def forward(x, recs=recs, log=logs[name]):
                y = infer.packed_apply(model, recs, x)
                log.append((x.clone(), y.clone()))
                return y

            engine = InferenceEngine(forward, example_shape, batch_sizes=BUCKETS, device=dev)
            try:
                engine.warmup()
                answers[name] = serve(lambda i: engine.submit(inputs[i]), len(inputs))
            finally:
                engine.shutdown()
            st = engine.stats
            print(f"engine[{name}]: {st.requests} requests in {st.batches} batches, "
                  f"mean batch {st.mean_batch_size:.2f}, mean latency "
                  f"{st.mean_latency_ms:.3f} ms  [{card}]", flush=True)
            if st.requests != len(inputs):
                fail(f"engine[{name}] answered {st.requests} of {len(inputs)}")
        launches = read_launches("bnn_lenet", kernels)
    return loaded, answers, logs, launches


def check_main_path(model, loaded, inputs, answers, logs) -> None:
    """Every logged batch: finite (B, 10), and identical to packed_apply on
    the same batch, to the other artifact and to the fake-quant forward.
    Every answer: the row of the batch its request rode in."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer

    artifacts = {"unprepared": loaded, "prepared": infer.prepare(loaded)}
    by_input = {}
    for name in answers:
        for x, y in zip(inputs, answers[name]):
            by_input.setdefault(x.tobytes(), {})[name] = y
    matched = 0
    for name, log in logs.items():
        other = "prepared" if name == "unprepared" else "unprepared"
        for xb, yb in log:
            if yb.shape != (xb.shape[0], 10) or not torch.isfinite(yb).all():
                fail(f"engine[{name}] batch output {tuple(yb.shape)} not finite (B, 10)")
            for ref_name, ref in (
                ("packed_apply on the same batch", infer.packed_apply(model, artifacts[name], xb)),
                (f"the {other} artifact", infer.packed_apply(model, artifacts[other], xb)),
                ("the fake-quant forward", torch.no_grad()(model)(xb)),
            ):
                if not torch.equal(yb, ref):
                    fail(f"engine[{name}] batch of {xb.shape[0]} differs from {ref_name}: "
                         f"{int((yb != ref).sum())} logits")
            for x_row, y_row in zip(xb.cpu().numpy(), yb.cpu().numpy()):
                got = by_input.get(x_row.tobytes(), {}).get(name)
                if got is not None:
                    if not np.array_equal(got, y_row):
                        fail(f"engine[{name}] answer differs from its batch row")
                    matched += 1
    if matched != len(answers) * len(inputs):
        fail(f"matched {matched} of {len(answers) * len(inputs)} answers to their batches")
    print(f"checked {matched} answers against packed_apply on their padded batches; "
          f"unprepared == prepared == fake-quant on every batch", flush=True)


def main_path(card: str):
    """Build bnn_lenet at full width from seeded weights, drive the main
    path, check it, and check a small input against the CPU."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.utils import (
        SCHEME_CONFIGS, RunConfig, build_model, load_flax_variables,
    )

    dev = cuda()
    rng = np.random.default_rng(SEED)
    cfg = RunConfig(**SCHEME_CONFIGS["bnn_lenet"])
    model, example_shape, _ = build_model(cfg, device=dev)
    if cfg.width != WIDTH:
        fail(f"bnn_lenet width {cfg.width}, expected {WIDTH}")
    load_flax_variables(model, seeded_variables(cfg.width, rng), device=dev)
    model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    inputs = [rng.normal(size=example_shape).astype(np.float32)
              for _ in range(CLIENTS * REQUESTS_PER_CLIENT)]

    loaded, answers, logs, launches = drive_main_path(card, model, example_shape, inputs)
    check_main_path(model, loaded, inputs, answers, logs)

    # A small input on a grid where conv1 is exact in any summation order,
    # against the same model on the CPU (plain kernel versions).
    prepared = infer.prepare(loaded)
    xs = np.round(rng.normal(size=(8, *example_shape)) * 8).astype(np.float32) / 8
    gpu = infer.packed_apply(model, prepared, torch.from_numpy(xs).to(dev)).cpu()
    cpu = infer.packed_apply(cpu_model, infer.pack_model(cpu_model), torch.from_numpy(xs))
    if not torch.equal(gpu, cpu):
        fail(f"card and CPU differ on {int((gpu != cpu).sum())} of {gpu.numel()} logits")
    print("card == CPU (plain versions) on an 8-image grid input", flush=True)
    return model, prepared, example_shape, launches


def throughput(card: str, label: str, backends: dict, example_shape):
    """Engine images/s per bucket ``b`` for each backend (name -> forward),
    closed loop: an engine whose largest bucket is ``b`` serves rounds of
    exactly ``b`` requests submitted at once. Its deadline (1 s) is far
    beyond a round's submissions (which at b=256 took over 50 ms on the H100
    host), so each round is one full batch and no deadline is waited out. At
    least 100 rounds, so the p90 round time has 10 samples beyond it. Beside
    it, the forward alone on a batch of ``b`` (CUDA events)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine

    dev = cuda()
    rng = np.random.default_rng(SEED + 100)
    for b in BUCKETS:
        xs = rng.normal(size=(b, *example_shape)).astype(np.float32)
        xb = torch.from_numpy(xs).to(dev)
        for name, forward in backends.items():
            engine = InferenceEngine(forward, example_shape, batch_sizes=(b,),
                                     max_delay_ms=1000.0, device=dev)
            try:
                engine.warmup()
                rounds = max(100, 1024 // b)
                round_ms = []
                t0 = time.perf_counter()
                for _ in range(rounds):
                    t1 = time.perf_counter()
                    futs = [engine.submit(x) for x in xs]
                    for f in futs:
                        f.result(timeout=120)
                    round_ms.append(1e3 * (time.perf_counter() - t1))
                dt = time.perf_counter() - t0
            finally:
                engine.shutdown()
            with torch.inference_mode():
                fwd_ms = cuda_ms(lambda: forward(xb), iters=20)
            p50, p90 = np.percentile(round_ms, [50, 90])
            print(f"{label} {name:16s} bucket {b:3d}: engine {rounds * b / dt:10.1f} images/s, "
                  f"round p50 {p50:.3f} ms p90 {p90:.3f} ms ({rounds} rounds in "
                  f"{engine.stats.batches} batches); forward {fwd_ms:.3f} ms "
                  f"({1e3 * b / fwd_ms:.1f} images/s)  [{card}]", flush=True)


# --- main path 2: the 1-bit transformer LM, fused decode ---------------------


def seeded_lm_variables(cfg: dict, rng) -> dict:
    """QuantTransformerLM variables in the flax layout, as numpy. Only the
    signs of the projection kernels matter (W1A1). LayerNorm scales and
    biases are spread so that each sign after a LayerNorm sees values on
    both sides; the FFN biases are on the scale of the integer sums they
    shift (sqrt(fan_in) terms of ±1), so the hidden threshold is live."""
    d, ff, vocab = cfg["d_model"], cfg["d_ff"], cfg["vocab"]

    def normal(*shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    def ln():
        return {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32), "bias": normal(d, scale=0.1)}

    p = {"embed": {"embedding": normal(vocab, d, scale=d ** -0.5)},
         "pos_embed": normal(cfg["max_len"], d, scale=0.02), "ln_f": ln()}
    for i in range(cfg["n_layers"]):
        p[f"block{i}"] = {
            "ln1": ln(), "ln2": ln(),
            "attn": {n: {"kernel": normal(d, d)} for n in ("q", "k", "v", "out")},
            "ffn_in": {"kernel": normal(d, ff), "bias": normal(ff, scale=0.25 * d ** 0.5)},
            "ffn_out": {"kernel": normal(ff, d), "bias": normal(d, scale=0.25 * ff ** 0.5)},
        }
    return {"params": p}


def seeded_dorefa_lm_variables(cfg: dict, rng) -> dict:
    """:func:`seeded_lm_variables` for the DoReFa scheme. DoReFa's weight
    quantizer divides by max|tanh(W)|, so the kernels' scale alone sets
    nothing: a kernel of N(0, 1) entries puts codes all over the 4-bit grid,
    and each projection output (1024 terms in [0, 1] x [-1, 1]) is ~10 wide,
    which saturates the next [0, 1] quantizer at codes 0 and 15. Here each
    kernel is N(0, 0.05^2) with its first entry set to 1, as a trained
    kernel's bell shape and outliers do: most codes fall on the two central
    levels, ±1/15, each projection's output is O(1), and the next quantizer
    sees a spread of codes. The FFN biases are on that scale."""
    v = seeded_lm_variables(cfg, rng)
    for i in range(cfg["n_layers"]):
        blk = v["params"][f"block{i}"]
        for node in (*blk["attn"].values(), blk["ffn_in"], blk["ffn_out"]):
            k = node["kernel"] * np.float32(0.05)
            k.flat[0] = 1.0
            node["kernel"] = k
        for name in ("ffn_in", "ffn_out"):
            blk[name]["bias"] = rng.normal(size=blk[name]["bias"].shape).astype(np.float32) * 0.25
    return v


def build_lm(cfg: dict, seed: int):
    """(port QuantTransformerLM on the card, eval mode) from seeded weights
    through the bridge."""
    from pytorch_quantize_impls_tpu_torch.models import QuantTransformerLM
    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    seeded = {"dorefa": seeded_dorefa_lm_variables, "log": seeded_log_lm_variables}.get(
        cfg["scheme"], seeded_lm_variables)
    variables = seeded(cfg, np.random.default_rng(seed))
    return load_flax_variables(QuantTransformerLM(**cfg), variables, device=cuda()).eval()


def logged_engine(model, fm, dev):
    """A DecodeEngine over ``fm`` that records every batch it runs, in order:
    ("admit", slot, prompt), ("step", active mask) and after each of those
    ("batch", tokens, logits)."""
    from pytorch_quantize_impls_tpu_torch.serve import DecodeEngine

    class LoggedEngine(DecodeEngine):
        def __init__(self, *args, **kwargs):
            self.log = []
            super().__init__(*args, **kwargs)

        def _admit(self, req, slot_idx):
            self.log.append(("admit", slot_idx, req.prompt))
            super()._admit(req, slot_idx)

        def _step(self, toks, active):
            self.log.append(("step", active.clone()))
            return super()._step(toks, active)

        def _apply(self, cache, toks):
            logits, cache = super()._apply(cache, toks)
            self.log.append(("batch", toks.clone(), logits.clone()))
            return logits, cache

    return LoggedEngine(model, fused=fm, n_slots=SLOTS, device=dev)


def drive_decode_path(card: str, model, fms: dict, prompts):
    """The decode main path: DecodeEngine(fused=) over the int8 and the
    packed export, 64 requests each from 4 client threads. Launch counters
    of K4, K3 and K1 are zeroed just before and read just after. Returns
    {export: (answers, log, final cache)} and the launch counts."""
    from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as da
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

    dev = cuda()
    kernels = (da.decode_attention, im.int8_gemm, bg.binary_gemm)
    runs = {}
    zero_launches()
    for name, fm in fms.items():
        engine = logged_engine(model, fm, dev)
        t0 = time.perf_counter()
        try:
            answers = serve(lambda i: engine.submit(prompts[i], max_new=MAX_NEW), len(prompts))
        finally:
            engine.shutdown()
        dt = time.perf_counter() - t0
        st = engine.stats
        print(f"decode engine[fused {name}]: {st.requests} requests, {st.tokens} tokens in "
              f"{dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps, mean occupancy "
              f"{st.mean_occupancy:.3f}  [{card}]", flush=True)
        if st.requests != len(prompts) or st.tokens != MAX_NEW * len(prompts):
            fail(f"decode engine[{name}] answered {st.requests} requests, {st.tokens} tokens")
        runs[name] = (answers, engine.log, engine._cache)
    launches = read_launches("decode_lm", kernels)
    return runs, launches


def _pin_cursors(cache, active):
    import torch

    for key, sub in cache.items():
        if key == "pos_index":
            cache[key] = torch.where(active, sub, 0)
        else:
            sub["attn"]["index"] = torch.where(active, sub["attn"]["index"], 0)


def _insert_row(cache, one, slot: int, n: int):
    for key, sub in one.items():
        if key == "pos_index":
            cache[key][slot] = n
            continue
        for leaf, value in sub["attn"].items():
            cache[key]["attn"][leaf][slot] = n if leaf == "index" else value[0]


def replay(name: str, fm, log, answers, prompts, final_cache) -> int:
    """Replay every batch an engine ran through ``fused_decode_apply`` of
    ``fm`` on a cache rebuilt the same way (prefill rows inserted at their
    slot, idle cursors pinned to 0): every batch's tokens and logits, every
    request's answer and the final cache must be the same bits. Returns the
    number of batches."""
    import torch

    from pytorch_quantize_impls_tpu_torch.infer import fused_decode_apply, fused_init_cache

    dev = cuda()
    cache = fused_init_cache(fm, SLOTS, device=dev)
    owner = [None] * SLOTS  # prompt bytes of the request in each slot
    tokens = {}
    i = batches = 0
    while i < len(log):
        event, (kind, toks, logits) = log[i], log[i + 1]
        i += 2
        if kind != "batch":
            fail(f"replay[{name}]: event {event[0]} not followed by its batch")
        if event[0] == "admit":
            _, slot, prompt = event
            n = prompt.size
            want = np.zeros((1, toks.shape[1]), np.int32)
            want[0, :n] = prompt
            if not np.array_equal(toks.cpu().numpy(), want):
                fail(f"replay[{name}]: prefill batch is not the padded prompt")
            got, one = fused_decode_apply(fm, None, toks)
            _insert_row(cache, one, slot, n)
            owner[slot] = prompt.tobytes()
            tokens[owner[slot]] = [int(got[0, n - 1].argmax())]
        else:
            active = event[1]
            want = [s is not None for s in owner]
            if active.tolist() != want:
                fail(f"replay[{name}]: active slots {active.tolist()} vs {want}")
            last = [tokens[s][-1] if s is not None else 0 for s in owner]
            if toks[:, 0].tolist() != last:
                fail(f"replay[{name}]: step tokens are not the slots' last tokens")
            got, cache = fused_decode_apply(fm, cache, toks)
            _pin_cursors(cache, active)
            for slot, nxt in enumerate(got[:, 0].argmax(-1).tolist()):
                if owner[slot] is not None:
                    tokens[owner[slot]].append(nxt)
        if not torch.equal(got, logits):
            fail(f"replay[{name}]: batch {batches} logits differ in "
                 f"{int((got != logits).sum())} places")
        for slot, key in enumerate(owner):
            if key is not None and len(tokens[key]) >= MAX_NEW:
                owner[slot] = None
        batches += 1
    for p, a in zip(prompts, answers):
        if not np.array_equal(np.asarray(tokens[p.tobytes()], np.int32), a):
            fail(f"replay[{name}]: an engine answer differs from its replayed batches")
    for key, sub in cache.items():
        pairs = ([(key, sub, final_cache[key])] if key == "pos_index" else
                 [(f"{key}/{leaf}", v, final_cache[key]["attn"][leaf])
                  for leaf, v in sub["attn"].items()])
        for leaf, mine, theirs in pairs:
            if not torch.equal(mine, theirs):
                fail(f"replay[{name}]: final cache {leaf} differs")
    return batches


GEMM_INPUTS = ("LN1 -> QKV", "context -> out", "LN2 -> ffn_in", "hidden -> ffn_out")


def teacher_forced(card: str, model, fm, lockstep: bool):
    """The fused step against the port's fake-quant decode model
    (QuantTransformerLM decode mode) at full width, both fed the same tokens
    (the fake-quant model's greedy choice): a 64-token prefill, then 32
    steps, 8 rows. Each GEMM input's ±1 codes are captured on both sides.
    Where a layer's Q/K/V input codes agree for a position, its K/V codes and
    scales must be equal; logits of rows with no differing code must agree
    within LOGIT_TOL.

    A single flipped code (an input within ~1e-7 of zero, where the two
    LayerNorm variance formulas or attention sum orders disagree) sends a
    W1A1 slot down another path for the rest of the run. With ``lockstep``
    every call starts from the fake-quant model's cache (copied into the
    fused layout), so each step is compared on equal state and a flip
    counts only where it happens: argmax must then agree on at least 99% of
    the (step, row) pairs. Without it the run is free, and its agreement is
    reported."""
    import torch

    from pytorch_quantize_impls_tpu_torch import serve
    from pytorch_quantize_impls_tpu_torch.infer import fused_decode as fd
    from pytorch_quantize_impls_tpu_torch.nn import intercept_quant_layers

    dev = cuda()
    b, steps = 8, 32
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, LM_CFG["vocab"], (b, 64)).astype(np.int32)).to(dev)
    md = serve.decode_model(model)
    tapped = {id(getattr(blk, n) if n.startswith("ffn") else getattr(blk.attn, n))
              for blk in model.blocks() for n in ("q", "out", "ffn_in", "ffn_out")}
    fake_codes, fused_codes = [], []

    def interceptor(m, x, fake_quant_forward):
        if id(m) in tapped:
            fake_codes.append(torch.where(x >= 0, 1, -1).to(torch.int8).reshape(-1, x.shape[-1]))
        return fake_quant_forward(x)

    gemm = fd._gemm_i8

    def tap(c, w):
        fused_codes.append(c.clone())
        return gemm(c, w)

    def both(cache_f, cache_g, t):
        fake_codes.clear()
        fused_codes.clear()
        with torch.no_grad(), intercept_quant_layers(interceptor):
            ref, cache_f = md(t, cache_f)
        fd._gemm_i8 = tap
        try:
            got, cache_g = fd.fused_decode_apply(fm, cache_g, t)
        finally:
            fd._gemm_i8 = gemm
        if len(fake_codes) != len(fused_codes):
            fail(f"teacher-forced: {len(fake_codes)} vs {len(fused_codes)} GEMM inputs")
        return ref, cache_f, got, cache_g

    kv = ("k_codes", "k_scale", "v_codes", "v_scale")
    flips = kv_rows = kv_skipped = agree = total = clean_rows = 0
    first_flips = [0] * len(GEMM_INPUTS)  # flips in slots clean until that GEMM
    clean = torch.ones(b, dtype=torch.bool, device=dev)
    max_clean_err = 0.0
    ref, cf, got, cg = both(None, None, toks)
    for step in range(steps + 1):
        s = toks.shape[1] if step == 0 else 1
        cur = int(cg["pos_index"][0]) - s
        if lockstep:
            clean = torch.ones(b, dtype=torch.bool, device=dev)
        for layer in range(LM_CFG["n_layers"]):
            for j in range(len(GEMM_INPUTS)):
                bad = (fused_codes[4 * layer + j] != fake_codes[4 * layer + j]).reshape(b, s, -1)
                flips += int(bad.sum())
                first_flips[j] += int(bad[clean].sum())
                if j == 0:
                    same = ~bad.any(dim=-1)  # Q/K/V input codes of each (slot, position)
                clean &= ~bad.any(dim=-1).any(dim=-1)
            fa, ga = cf[f"block{layer}"]["attn"], cg[f"block{layer}"]["attn"]
            for name in kv:
                f = fa[name][:, cur:cur + s].transpose(1, 2)  # (b, h, s, ...)
                g = ga[name][:, :, cur:cur + s]
                eq = (f == g).reshape(b, f.shape[1], s, -1).all(dim=-1).all(dim=1)  # (b, s)
                if not eq[same].all():
                    fail(f"teacher-forced: layer {layer} {name} differs where the "
                         f"Q/K/V input codes agree")
            kv_rows += int(same.sum())
            kv_skipped += int((~same).sum())
        if step > 0:
            total += b
            agree += int((ref[:, 0].argmax(-1) == got[:, 0].argmax(-1)).sum())
            if clean.any():
                err = (ref[clean, 0] - got[clean, 0]).abs().max().item()
                max_clean_err = max(max_clean_err, err)
                if err > LOGIT_TOL:
                    fail(f"teacher-forced: step {step} logits differ by {err} in rows "
                         f"with no flipped code")
                clean_rows += int(clean.sum())
        if step == steps:
            break
        if lockstep:
            for layer in range(LM_CFG["n_layers"]):
                fa, ga = cf[f"block{layer}"]["attn"], cg[f"block{layer}"]["attn"]
                for name in kv:
                    ga[name].copy_(fa[name].transpose(1, 2))
        t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
        ref, cf, got, cg = both(cf, cg, t)
    origin = ", ".join(f"{k}: {n}" for k, n in zip(GEMM_INPUTS, first_flips))
    print(f"teacher-forced fused vs fake-quant at full width, "
          f"{'lockstep' if lockstep else 'free-running'}: {steps} steps x {b} rows, argmax "
          f"agrees on {agree}/{total} ({100 * agree / total:.2f}%); {flips} flipped ±1 codes "
          f"over all GEMM inputs, first flips by GEMM input ({origin}); K/V codes and scales "
          f"equal on {kv_rows} (layer, slot, position) rows with equal Q/K/V codes "
          f"({kv_skipped} rows had a flipped code); max |logit err| {max_clean_err:.3g} over "
          f"{clean_rows} rows with no flipped code (tolerance {LOGIT_TOL})  [{card}]", flush=True)
    if lockstep and agree < 0.99 * total:
        fail(f"teacher-forced (lockstep): argmax agrees on only {agree} of {total}")


def small_token_exact(card: str):
    """At the JAX package's fused-decode test size (seeded weights): the
    fused step and the fake-quant decode model agree within LOGIT_TOL,
    teacher-forced, and greedy generation gives the same tokens through
    serve.generate (fake-quant) and DecodeEngine(fused=)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer, serve

    dev = cuda()
    model = build_lm(SMALL_LM_CFG, SEED)
    fm = infer.export_fused_decode(model, device=dev)
    rng = np.random.default_rng(SEED + 1)
    toks = torch.from_numpy(rng.integers(0, 128, (3, 8)).astype(np.int32)).to(dev)
    md = serve.decode_model(model)
    with torch.no_grad():
        ref, cf = md(toks)
        got, cg = infer.fused_decode_apply(fm, None, toks)
        for _ in range(7):
            err = (ref - got).abs().max().item()
            if err > LOGIT_TOL or not torch.equal(ref[:, -1].argmax(-1), got[:, -1].argmax(-1)):
                fail(f"small LM: fused vs fake-quant logits differ by {err}")
            t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
            ref, cf = md(t, cf)
            got, cg = infer.fused_decode_apply(fm, cg, t)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32) for n in (5, 9, 12)]
    engine = serve.DecodeEngine(model, fused=fm, n_slots=4, device=dev)
    try:
        fused = [engine(p, max_new=6) for p in prompts]
    finally:
        engine.shutdown()
    for p, f in zip(prompts, fused):
        want = serve.generate(model, p[None], 6, device=dev)[0].cpu().numpy()
        if not np.array_equal(f, want):
            fail(f"small LM: fused engine {f} vs fake-quant generate {want}")
    print("small LM (JAX test size): fused == fake-quant within 2e-4 for 8 teacher-forced "
          "calls; greedy tokens identical for 3 prompts  [" + card + "]", flush=True)


def decode_speed(card: str, backends: dict):
    """scripts/perf_bench.py:bench_decode's metrics on the card: 128-token
    prefill ms (b = 1) and decode tokens/s at each of DECODE_BATCHES, by
    CUDA events over N steps with the cache advancing (each step feeds the
    previous step's argmax, on the card), for each backend (name ->
    ``apply(cache, tokens) -> (logits, cache)``)."""
    import torch

    dev = cuda()
    rng = np.random.default_rng(SEED + 2)
    n_steps = 32
    profiles = []
    with torch.no_grad():
        for name, apply in backends.items():
            toks1 = torch.from_numpy(
                rng.integers(0, LM_CFG["vocab"], (1, PREFILL_LEN)).astype(np.int32)).to(dev)
            prefill_ms = cuda_ms(lambda: apply(None, toks1), iters=5, warmup=1)
            line = f"decode {name:13s}: prefill {PREFILL_LEN} tok {prefill_ms:.3f} ms"
            for b in DECODE_BATCHES:
                tb = torch.from_numpy(
                    rng.integers(0, LM_CFG["vocab"], (b, PREFILL_LEN)).astype(np.int32)).to(dev)
                logits, cache = apply(None, tb)
                t = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                for _ in range(3):
                    logits, cache = apply(cache, t)
                    t = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n_steps):
                    logits, cache = apply(cache, t)
                    t = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                end.record()
                end.synchronize()
                step_ms = start.elapsed_time(end) / n_steps
                line += f"; b={b}: {step_ms:.3f} ms/step {1e3 * b / step_ms:.1f} tok/s"
                if b == DECODE_BATCHES[-1]:
                    state = {"cache": cache, "t": t}

                    def step():
                        logits, state["cache"] = apply(state["cache"], state["t"])
                        state["t"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

                    profiles.append(f"decode {name} b={b} " + profile_line(step, "step", 8))
                    cache = state["cache"]
                del cache
            print(line + f"  [{card}]", flush=True)
    for line in profiles:
        print(line + f"  [{card}]", flush=True)


def decode_path(card: str):
    """Build the serving LM at full width, export it both ways, drive and
    replay the engine, then the seam checks and the speeds."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.serve import decode_model

    dev = cuda()
    t0 = time.perf_counter()
    model = build_lm(LM_CFG, SEED)
    fms = {w: infer.export_fused_decode(model, weights=w, device=dev) for w in ("int8", "packed")}
    print(f"decode LM built and exported in {time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated", flush=True)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, LM_CFG["vocab"], rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(DECODE_REQUESTS)]
    runs, launches = drive_decode_path(card, model, fms, prompts)
    other = {"int8": "packed", "packed": "int8"}
    for name, (answers, log, final_cache) in runs.items():
        n = replay(name, fms[other[name]], log, answers, prompts, final_cache)
        print(f"replayed the fused {name} engine's {n} batches through the {other[name]} "
              f"export: same logits, tokens and final cache, bit for bit", flush=True)
        del log
    if any(not np.array_equal(a, b) for a, b in zip(runs["int8"][0], runs["packed"][0])):
        fail("the int8 and packed engines answered differently")
    del runs
    for lockstep in (True, False):
        teacher_forced(card, model, fms["int8"], lockstep)
    small_token_exact(card)
    md = decode_model(model)
    backends = {"fake-quant": lambda c, t: md(t, c)}
    for name, fm in fms.items():
        backends[f"fused {name}"] = lambda c, t, fm=fm: infer.fused_decode_apply(fm, c, t)
    decode_speed(card, backends)
    return launches


# --- main path 3: DoReFa ResNet-20 W4A4, packed and fused --------------------


def seeded_resnet_variables(width: int, rng, a_quant: str = "fixed") -> dict:
    """DorefaResNet20 variables in the flax layout, as numpy: He-scaled conv
    kernels, BatchNorm scales and biases by role, statistics left for
    :func:`calibrate_batchnorm`. After calibration each BatchNorm output is
    about N(bias, scale) per channel: the stem's and bn1's around 0.2-0.5
    (their relu'd output is a block conv's input on the [0, 1] grid), bn2's
    small and centred a little below 0 (it is added to the residual stream,
    which must not drift past 1 and saturate the codes), the projections'
    like the stem's. PACT clips (``a_quant="pact"``) are drawn in [1, 2]."""
    f32 = np.float32

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(f32)

    def bn(c, gamma, beta):
        return ({"scale": rng.uniform(*gamma, c).astype(f32),
                 "bias": rng.uniform(*beta, c).astype(f32)},
                {"mean": np.zeros(c, f32), "var": np.ones(c, f32)})

    def kernel(k, cin, cout):
        return normal(k, k, cin, cout, scale=np.sqrt(2.0 / (k * k * cin)))

    w = width
    p = {"stem": {"kernel": kernel(3, 3, w)}}
    s = {}
    p["bn_stem"], s["bn_stem"] = bn(w, (0.3, 0.6), (0.2, 0.5))
    cin = w
    for stage, (f, stride) in enumerate([(w, 1), (2 * w, 2), (4 * w, 2)]):
        for b in range(3):
            bp, bs = {}, {}
            for i, c_in in ((1, cin), (2, f)):
                bp[f"conv{i}"] = {"conv": {"kernel": kernel(3, c_in, f)}}
                if a_quant == "pact":
                    bp[f"conv{i}"]["act"] = {"alpha": np.asarray(rng.uniform(1.0, 2.0), f32)}
            bp["bn1"], bs["bn1"] = bn(f, (0.3, 0.5), (0.2, 0.5))
            bp["bn2"], bs["bn2"] = bn(f, (0.1, 0.3), (-0.15, 0.05))
            if b == 0 and (stride != 1 or cin != f):
                bp["proj"] = {"kernel": kernel(1, cin, f)}
                bp["bn_proj"], bs["bn_proj"] = bn(f, (0.2, 0.4), (0.2, 0.4))
            p[f"stage{stage}_block{b}"], s[f"stage{stage}_block{b}"] = bp, bs
            cin = f
    p["head"] = {"kernel": normal(4 * w, 10, scale=(4 * w) ** -0.5), "bias": normal(10, scale=0.1)}
    return {"params": p, "batch_stats": s}


def calibrate_batchnorm(model, x) -> dict:
    """Set every BatchNorm's running statistics to the per-channel mean and
    (biased) variance of its input on ``x``, in one forward pass in order,
    so each sees inputs already normalized by the ones before it. Returns
    the statistics in the flax ``batch_stats`` layout (numpy)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.models.lenet import BatchNorm

    def hook(bn, args):
        dims = tuple(range(args[0].dim() - 1))
        bn.running_mean.copy_(args[0].mean(dim=dims))
        bn.running_var.copy_(args[0].var(dim=dims, unbiased=False))

    bns = [(name, m) for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    handles = [m.register_forward_pre_hook(hook) for _, m in bns]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    stats = {}
    for name, m in bns:
        node = stats
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["mean"] = m.running_mean.cpu().numpy()
        node["var"] = m.running_var.cpu().numpy()
    return stats


def calibrated_resnet(width: int, rng, x, device, a_quant: str = "fixed"):
    """(port DorefaResNet20 W4 on ``device`` in eval mode, its variables in
    the flax layout): seeded weights through the bridge, BatchNorm
    statistics calibrated on the images ``x`` (numpy NHWC)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.models import DorefaResNet20
    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    variables = seeded_resnet_variables(width, rng, a_quant)
    model = DorefaResNet20(w_bits=4, a_bits=4, a_quant=a_quant, width=width)
    load_flax_variables(model, variables, device=device).eval()
    variables["batch_stats"] = calibrate_batchnorm(model, torch.from_numpy(x).to(device))
    return model, variables


def stage_code_histograms(model, x) -> None:
    """The codes of each stage's first block-conv input on the images ``x``
    (fake-quant forward); fail if one code holds more than 90% of them, which
    would leave the integer paths nothing to disagree on."""
    import torch

    n_a = 2**model.a_bits - 1
    seen = {}

    def hook(s):
        def fn(m, args):
            codes = torch.round(torch.clamp(args[0], 0, 1) * n_a).flatten().to(torch.int64)
            seen[s] = torch.bincount(codes, minlength=n_a + 1).cpu()
        return fn

    hooks = [getattr(model, f"stage{s}_block0").conv1.conv.register_forward_pre_hook(hook(s))
             for s in range(3)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    for s, counts in sorted(seen.items()):
        share = (counts.double() / counts.sum()).tolist()
        print(f"stage{s}_block0.conv1 input code shares 0..{n_a}: "
              + " ".join(f"{v:.3f}" for v in share), flush=True)
        if max(share) > 0.9:
            fail(f"stage {s}: one code holds {max(share):.3f} of the conv inputs")


def logged_engine_class():
    """InferenceEngine that records every batch it runs after its warmup, as
    (input, output) numpy arrays; ``from_fused_resnet`` builds one too."""
    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine

    class LoggedInferenceEngine(InferenceEngine):
        def __init__(self, *args, **kwargs):
            self.log = []
            super().__init__(*args, **kwargs)

        def warmup(self):
            super().warmup()
            self.log.clear()

        def _run(self, x):
            y = super()._run(x)
            self.log.append((x, y))
            return y

    return LoggedInferenceEngine


def run_engine(card: str, label: str, engine, inputs):
    """Warm ``engine`` up, serve ``inputs`` from CLIENTS threads, shut it
    down; returns the answers."""
    try:
        engine.warmup()
        answers = serve(lambda i: engine.submit(inputs[i]), len(inputs))
    finally:
        engine.shutdown()
    st = engine.stats
    print(f"engine[{label}]: {st.requests} requests in {st.batches} batches, mean batch "
          f"{st.mean_batch_size:.2f}, mean latency {st.mean_latency_ms:.3f} ms  [{card}]",
          flush=True)
    if st.requests != len(inputs):
        fail(f"engine[{label}] answered {st.requests} of {len(inputs)}")
    return answers


def check_logged(label: str, log, inputs, answers, refs: dict) -> None:
    """Every batch the engine ran: finite (B, 10) and bit-equal to each
    forward in ``refs`` on the same batch; every answer: its batch's row."""
    import torch

    dev = cuda()
    rows = {}
    for xb, yb in log:
        if yb.shape != (xb.shape[0], 10) or not np.isfinite(yb).all():
            fail(f"engine[{label}] batch output {yb.shape} not finite (B, 10)")
        with torch.inference_mode():
            xt = torch.from_numpy(xb).to(dev)
            for name, forward in refs.items():
                ref = forward(xt).cpu().numpy()
                if not np.array_equal(yb, ref):
                    fail(f"engine[{label}] batch of {xb.shape[0]} differs from {name} in "
                         f"{int((yb != ref).sum())} logits")
        for xr, yr in zip(xb, yb):
            rows[xr.tobytes()] = yr
    for x, a in zip(inputs, answers):
        row = rows.get(x.tobytes())
        if row is None or not np.array_equal(a, row):
            fail(f"engine[{label}] answer differs from its batch row")
    print(f"engine[{label}]: {len(log)} batches bit-equal to {' and '.join(refs)} on the same "
          f"batch; {len(answers)} answers are their batch rows", flush=True)


def against_fake_quant(card: str, label: str, model, forward, xs, atol=RESNET_LOGIT_TOL,
                       rtol=0.0) -> None:
    """``forward`` against the fake-quant forward on the images ``xs``, in
    batches of RESNET_BATCH: argmax agreement and the row-max logit gap. A
    row is within the tolerance when every logit is within ``atol + rtol *
    |fake-quant logit|``; 99% of rows must be, and argmax must agree on 99%
    of rows."""
    import torch

    dev = cuda()
    gaps, inside, agree = [], [], 0
    with torch.inference_mode():
        for i in range(0, len(xs), RESNET_BATCH):
            xb = torch.from_numpy(xs[i:i + RESNET_BATCH]).to(dev)
            ref, got = model(xb), forward(xb)
            gaps.append((got - ref).abs().amax(dim=1).cpu())
            inside.append(((got - ref).abs() <= atol + rtol * ref.abs()).all(dim=1).cpu())
            agree += int((got.argmax(1) == ref.argmax(1)).sum())
    gaps = torch.cat(gaps).double()
    n = len(xs)
    within = float(torch.cat(inside).double().mean())
    tol = f"{atol}" + (f" + {rtol} |ref|" if rtol else "")
    q50, q99 = np.quantile(gaps.numpy(), [0.5, 0.99])
    print(f"{label} vs fake-quant on {n} rows: argmax agrees on {agree}/{n}; row max |logit "
          f"gap| median {q50:.4g} p99 {q99:.4g} max {gaps.max():.4g}; {100 * within:.2f}% of "
          f"rows within {tol}  [{card}]", flush=True)
    if agree < 0.99 * n or within < 0.99:
        fail(f"{label}: argmax agrees on {agree}/{n}, {100 * within:.2f}% of rows within "
             f"{tol} of the fake-quant logits")


def direct_vs_im2col(model, loaded, x) -> None:
    """The stride-2 first conv of stage 1 (JAX's (0, 1) SAME pads) on its
    real input: direct (K7 + K5) and im2col (F.unfold + K6) bit for bit."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels.conv import PackedConv, packed_conv2d

    conv = model.stage1_block0.conv1.conv
    rec = loaded[("stage1_block0", "conv1", "conv")]
    kh, kw, cin, cout = rec.kernel_shape
    pc = PackedConv("dorefa", rec.packed, (kh, kw), cin, cout, None, rec.w_bits, rec.a_bits)
    seen = []
    hook = conv.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            model(x)
    finally:
        hook.remove()
    xq = conv.input_quant(seen[0])
    kw_ = dict(strides=conv.strides, padding=conv.padding)
    direct = packed_conv2d(xq, pc, **kw_)
    im2col = packed_conv2d(xq, pc, mode="im2col", **kw_)
    if not torch.equal(direct, im2col):
        fail(f"stage1 conv1: direct and im2col differ in {int((direct != im2col).sum())} places")
    print(f"stage1_block0.conv1 (stride 2) on {x.shape[0]} images: direct (K7 + K5) == "
          f"im2col (F.unfold + K6), {tuple(direct.shape)}, bit for bit", flush=True)


def resnet_path(card: str):
    """Main path 3: the DoReFa ResNet-20 W4A4 at width 64, packed
    (unprepared, then prepared) and fused, each through InferenceEngine, with
    every served batch replayed; then the seams and the speeds."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm

    dev = cuda()
    rng = np.random.default_rng(SEED + 20)
    calib = rng.normal(size=(RESNET_CALIB, *RESNET_SHAPE)).astype(np.float32)
    model, _ = calibrated_resnet(RESNET_WIDTH, rng, calib, dev)
    stage_code_histograms(model, torch.from_numpy(calib[:64]).to(dev))
    cpu_model = copy.deepcopy(model).cpu()
    inputs = [rng.normal(size=RESNET_SHAPE).astype(np.float32)
              for _ in range(CLIENTS * REQUESTS_PER_CLIENT)]
    Logged = logged_engine_class()
    launches, answers, logs = {}, {}, {}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dorefa_resnet20_w64.npz")
        infer.save_packed(path, infer.pack_model(model))
        zero_launches()
        loaded = infer.load_packed(path, device=dev)
        for name in ("unprepared", "prepared"):
            recs = loaded if name == "unprepared" else infer.prepare(loaded)
            engine = Logged(lambda x, recs=recs: infer.packed_apply(model, recs, x), RESNET_SHAPE,
                            batch_sizes=BUCKETS, device=dev)
            answers[name] = run_engine(card, f"resnet {name}", engine, inputs)
            logs[name] = engine.log
        launches["resnet_w4a4_packed"] = read_launches(
            "resnet_w4a4_packed", (pm.decode_dorefa_weights, ic.int8_conv2d))
    prepared = infer.prepare(loaded)
    net = infer.export_fused_resnet20(model)
    zero_launches()
    engine = Logged.from_fused_resnet(net, RESNET_SHAPE, batch_sizes=BUCKETS, device=dev)
    answers["fused"] = run_engine(card, "resnet fused", engine, inputs)
    logs["fused"] = engine.log
    launches["resnet_w4a4_fused"] = read_launches("resnet_w4a4_fused", (ic.int8_conv2d,))

    forwards = {
        "packed_apply (unprepared)": lambda x: infer.packed_apply(model, loaded, x),
        "packed_apply (prepared)": lambda x: infer.packed_apply(model, prepared, x),
    }
    check_logged("resnet unprepared", logs["unprepared"], inputs, answers["unprepared"], forwards)
    check_logged("resnet prepared", logs["prepared"], inputs, answers["prepared"], forwards)
    fused = {"fused_resnet_apply": lambda x: infer.fused_resnet_apply(net, x)}
    check_logged("resnet fused", logs["fused"], inputs, answers["fused"], fused)
    del logs
    direct_vs_im2col(model, loaded, torch.from_numpy(calib[:RESNET_IM2COL_BATCH]).to(dev))

    xs = rng.normal(size=(RESNET_EVAL, *RESNET_SHAPE)).astype(np.float32)
    against_fake_quant(card, "resnet packed", model, forwards["packed_apply (prepared)"], xs)
    against_fake_quant(card, "resnet fused", model, fused["fused_resnet_apply"], xs)

    # a small input against the same model on the CPU (plain kernel versions)
    xs = rng.normal(size=(8, *RESNET_SHAPE)).astype(np.float32)
    with torch.inference_mode():
        xt = torch.from_numpy(xs)
        pairs = {
            "packed": (infer.packed_apply(model, prepared, xt.to(dev)),
                       infer.packed_apply(cpu_model, infer.pack_model(cpu_model), xt)),
            "fused": (infer.fused_resnet_apply(net, xt.to(dev)),
                      infer.fused_resnet_apply(infer.export_fused_resnet20(cpu_model), xt)),
        }
    for name, (gpu, cpu) in pairs.items():
        gap = (gpu.cpu() - cpu).abs().max().item()
        if gap > RESNET_LOGIT_TOL or not torch.equal(gpu.argmax(1).cpu(), cpu.argmax(1)):
            fail(f"resnet {name}: card and CPU logits differ by {gap} on 8 images")
        print(f"resnet {name}: card vs CPU (plain versions) on 8 images: max |logit gap| "
              f"{gap:.4g} (tolerance {RESNET_LOGIT_TOL}), same argmax", flush=True)

    backends = {
        "packed": forwards["packed_apply (unprepared)"],
        "packed prepared": forwards["packed_apply (prepared)"],
        "fused": fused["fused_resnet_apply"],
        "fake-quant": model,
    }
    throughput(card, "resnet", backends, RESNET_SHAPE)
    for b in (1, RESNET_BATCH):
        xb = torch.from_numpy(rng.normal(size=(b, *RESNET_SHAPE)).astype(np.float32)).to(dev)
        for name, forward in backends.items():
            with torch.inference_mode():
                line = profile_line(lambda: forward(xb), "forward", 10)
            print(f"resnet {name} b={b} {line}  [{card}]", flush=True)
    return launches


# --- main path 5: log-quant VGG-small, packed --------------------------------


def seeded_vgg_variables(widths, rng) -> dict:
    """LogQuantVGGSmall variables in the flax layout, as numpy: He-scaled
    conv kernels (the exponent indices of each layer spread over several
    levels), BatchNorm scales and biases that leave each ReLU about half
    open, statistics left for :func:`calibrate_batchnorm`, and a head of
    scale 1/sqrt(fan_in) with a small bias."""
    f32 = np.float32
    p, s = {}, {}
    cin = RESNET_SHAPE[2]
    for i, w in enumerate(widths):
        kernel = rng.normal(size=(3, 3, cin, w)) * np.sqrt(2.0 / (9 * cin))
        p[f"conv{i}"] = {"conv": {"kernel": kernel.astype(f32)}}
        p[f"bn{i}"] = {"scale": rng.uniform(0.5, 1.5, w).astype(f32),
                       "bias": rng.uniform(-0.2, 0.4, w).astype(f32)}
        s[f"bn{i}"] = {"mean": np.zeros(w, f32), "var": np.ones(w, f32)}
        cin = w
    side = RESNET_SHAPE[0] // 2 ** (len(widths) // 2)
    k = side * side * cin
    p["head"] = {"dense": {"kernel": (rng.normal(size=(k, 10)) * k ** -0.5).astype(f32),
                           "bias": (rng.normal(size=10) * 0.1).astype(f32)}}
    return {"params": p, "batch_stats": s}


def calibrated_vgg(model, rng, x):
    """Load seeded variables into the port LogQuantVGGSmall ``model`` through
    the bridge (eval mode) and calibrate its BatchNorm statistics on the
    images ``x`` (numpy NHWC). Returns (model, its variables in the flax
    layout)."""
    import torch

    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    dev = next(model.parameters()).device
    variables = seeded_vgg_variables(model.widths, rng)
    load_flax_variables(model, variables, device=dev).eval()
    variables["batch_stats"] = calibrate_batchnorm(model, torch.from_numpy(x).to(dev))
    return model, variables


def exponent_histograms(label: str, model, min_levels: int, show=("",)) -> None:
    """Per log layer, the shares of its weights' exponent indices 0..2^bits
    (``ops.log_quant_exponent`` of the master weight), printed for the
    layers whose name starts with one of ``show``; fail unless every layer
    has at least ``min_levels`` indices holding 1% or more."""
    import torch

    from pytorch_quantize_impls_tpu_torch import ops
    from pytorch_quantize_impls_tpu_torch.nn import QuantConv, QuantDense

    fewest = None
    for name, m in model.named_modules():
        if not isinstance(m, (QuantConv, QuantDense)) or m.scheme != "log":
            continue
        _, idx = ops.log_quant_exponent(m.weight.detach(), m.fsr, m.w_bits)
        counts = torch.bincount(idx.flatten().long(), minlength=2**m.w_bits + 1).double()
        share = (counts / counts.sum()).tolist()
        live = sum(v >= 0.01 for v in share)
        fewest = live if fewest is None else min(fewest, live)
        if name.startswith(show):
            print(f"{label} {name:20s} exponent index shares 0..{2**m.w_bits}: "
                  + " ".join(f"{v:.3f}" for v in share), flush=True)
        if live < min_levels:
            fail(f"{label} {name}: only {live} exponent levels hold 1% of the weights")
    print(f"{label}: every log layer has >= {fewest} exponent levels holding 1% of its weights",
          flush=True)


def packed_words_vs_cpu(label: str, model, card_recs, cpu_recs) -> None:
    """Codes packed on the card against codes packed on the CPU from the same
    master weights: log2 may round the other way where |w| is within an ulp
    of 2^(k + 1/2). Print how many differ; fail if one is not at such a
    boundary."""
    import torch

    from pytorch_quantize_impls_tpu_torch.nn import QuantConv, QuantDense
    from pytorch_quantize_impls_tpu_torch.ops import pack as packlib

    masters = {tuple(n.split(".")): m.weight.detach().cpu() for n, m in model.named_modules()
               if isinstance(m, (QuantConv, QuantDense)) and m.scheme == "log"}
    total = differ = 0
    for path, rec in cpu_recs.items():
        w = masters[path]
        w2d = w.reshape(w.shape[0], -1).T  # (K, N) in the packed order
        k = w2d.shape[0]
        a = packlib.unpack_bitplanes(card_recs[path].packed.cpu(), 8, k)
        b = packlib.unpack_bitplanes(rec.packed, 8, k)
        bad = a != b
        total += a.numel()
        differ += int(bad.sum())
        if bad.any():
            frac = torch.log2(w2d[bad].abs().double()) % 1.0
            if ((frac - 0.5).abs() > 1e-6).any():
                fail(f"{label} {path}: a code packed on the card differs from the CPU's away "
                     f"from an exponent boundary")
    print(f"{label}: codes packed on the card and on the CPU differ in {differ} of {total} "
          f"(each at an exponent boundary)", flush=True)


def vgg_direct_vs_im2col(model, loaded, x) -> None:
    """conv3 (16x16x256 -> 256) on its real input: packed_conv2d(scheme=
    "log") direct (K9 + float conv) against im2col (F.unfold + K8), within
    SHIFT_RTOL of |bf16(x)| conv |w|: both round x to bf16, only the float32
    sums differ."""
    import torch

    from pytorch_quantize_impls_tpu_torch.kernels.conv import (
        PackedConv, conv2d_nhwc, decode_conv_weights, packed_conv2d,
    )

    conv = model.conv3.conv
    rec = loaded[("conv3", "conv")]
    kh, kw, cin, cout = rec.kernel_shape
    pc = PackedConv("log", rec.packed, (kh, kw), cin, cout, None, rec.w_bits, 0, rec.fsr)
    seen = []
    hook = conv.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            model(x)
    finally:
        hook.remove()
    xin = seen[0]
    kw_ = dict(strides=conv.strides, padding=conv.padding)
    with torch.no_grad():
        direct = packed_conv2d(xin, pc, **kw_)
        im2col = packed_conv2d(xin, pc, mode="im2col", **kw_)
        w = decode_conv_weights(pc).double().abs().T.reshape(cout, cin, kh, kw)
        bound = conv2d_nhwc(xin.to(torch.bfloat16).double().abs(), w, conv.strides, conv.padding)
    diff = (direct.double() - im2col.double()).abs()
    ratio = (diff / bound.clamp_min(1e-300)).max().item()
    if (diff > SHIFT_RTOL * bound).any():
        fail(f"vgg conv3: direct and im2col differ by {ratio:.3g} of |x| conv |w|")
    print(f"vgg conv3 on {x.shape[0]} images: direct (K9 + conv) vs im2col (F.unfold + K8) "
          f"{tuple(direct.shape)}, max |diff| {diff.max().item():.3g}, largest |diff| / "
          f"(|bf16(x)| conv |w|) {ratio:.3g} (tolerance {SHIFT_RTOL})", flush=True)


def vgg_unprepared_vs_prepared(card: str, model, records, xs) -> None:
    """The convs of both paths run the same float conv on the same K9
    weights, so the head sees the same input h; the unprepared head rounds h
    to bf16 (K8), the prepared one does not: per logit within
    (BF16_INPUT_RTOL + SHIFT_RTOL) (|h| @ |W_head|)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer

    dev = cuda()
    seen = []
    hook = model.head.dense.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.inference_mode():
            xb = torch.from_numpy(xs).to(dev)
            y = {name: infer.packed_apply(model, recs, xb) for name, recs in records.items()}
    finally:
        hook.remove()
    if not torch.equal(seen[0], seen[1]):
        fail("vgg: the head's input differs between the unprepared and prepared paths")
    w = records["prepared"][("head", "dense")].decoded.double()
    bound = seen[0].abs().double() @ w.abs() + model.head.dense.bias.detach().abs().double()
    diff = (y["unprepared"] - y["prepared"]).abs().double()
    ratio = (diff / bound).max().item()
    print(f"vgg unprepared vs prepared on {len(xs)} images: max |logit diff| "
          f"{diff.max().item():.3g}, largest |diff| / (|h| @ |W_head|) {ratio:.3g} (bf16 "
          f"rounding of the head's input; tolerance {BF16_INPUT_RTOL + SHIFT_RTOL:.6g})  "
          f"[{card}]", flush=True)
    if ratio > BF16_INPUT_RTOL + SHIFT_RTOL:
        fail(f"vgg: unprepared and prepared logits differ by {ratio:.3g} of |h| @ |W_head|")


def vgg_path(card: str):
    """Main path 5: logquant_vgg at its published widths through build_model,
    seeded weights and calibrated BatchNorm, packed and served through
    InferenceEngine: the unprepared records (K9 at every conv call, K8 at the
    head), then prepare() (K9) and the prepared records (no K8), each path's
    counters zeroed just before it; every served batch replayed; then the
    seams and the speeds."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig, build_model

    dev = cuda()
    rng = np.random.default_rng(SEED + 30)
    cfg = RunConfig(**SCHEME_CONFIGS["logquant_vgg"])
    model, shape, _ = build_model(cfg, device=dev)
    head = tuple(model.head.dense.weight.shape)
    if model.widths != (128, 128, 256, 256, 512, 512) or head != (10, 8192):
        fail(f"logquant_vgg widths {model.widths}, head {head}")
    calib = rng.normal(size=(VGG_CALIB, *shape)).astype(np.float32)
    calibrated_vgg(model, rng, calib)
    exponent_histograms("vgg", model, 4)
    cpu_model = copy.deepcopy(model).cpu()
    inputs = [rng.normal(size=shape).astype(np.float32)
              for _ in range(CLIENTS * REQUESTS_PER_CLIENT)]
    Logged = logged_engine_class()
    launches, answers, logs, records = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "logquant_vgg.npz")
        infer.save_packed(path, infer.pack_model(model))
        loaded = infer.load_packed(path, device=dev)
    for name, required in (("unprepared", (sm.decode_log_weights, sm.shift_gemm)),
                           ("prepared", (sm.decode_log_weights,))):
        zero_launches()
        recs = loaded if name == "unprepared" else infer.prepare(loaded)
        engine = Logged(lambda x, recs=recs: infer.packed_apply(model, recs, x), shape,
                        batch_sizes=BUCKETS, device=dev)
        answers[name] = run_engine(card, f"vgg {name}", engine, inputs)
        logs[name] = engine.log
        launches[f"vgg_{name}"] = read_launches(f"vgg_{name}", required)
        records[name] = recs
    if launches["vgg_prepared"]["shift_gemm"]:
        fail("the prepared VGG path launched shift_gemm")

    forwards = {name: (lambda x, recs=recs: infer.packed_apply(model, recs, x))
                for name, recs in records.items()}
    for name in records:
        check_logged(f"vgg {name}", logs[name], inputs, answers[name],
                     {f"packed_apply ({name})": forwards[name]})
    del logs
    vgg_direct_vs_im2col(model, loaded, torch.from_numpy(calib[:VGG_IM2COL_BATCH]).to(dev))
    xs = rng.normal(size=(VGG_EVAL, *shape)).astype(np.float32)
    for name in records:
        against_fake_quant(card, f"vgg packed {name}", model, forwards[name], xs,
                           atol=VGG_LOGIT_ATOL, rtol=VGG_LOGIT_RTOL)
    vgg_unprepared_vs_prepared(card, model, records, xs[:RESNET_BATCH])

    # a small input against the same model on the CPU (plain kernel versions)
    cpu_recs = infer.pack_model(cpu_model)
    packed_words_vs_cpu("vgg", cpu_model, loaded, cpu_recs)
    xs = rng.normal(size=(8, *shape)).astype(np.float32)
    for name, recs in (("unprepared", cpu_recs), ("prepared", infer.prepare(cpu_recs))):
        with torch.inference_mode():
            gpu = forwards[name](torch.from_numpy(xs).to(dev)).cpu()
            cpu = infer.packed_apply(cpu_model, recs, torch.from_numpy(xs))
        gap = (gpu - cpu).abs().max().item()
        inside = ((gpu - cpu).abs() <= VGG_LOGIT_ATOL + VGG_LOGIT_RTOL * cpu.abs()).all()
        if not inside or not torch.equal(gpu.argmax(1), cpu.argmax(1)):
            fail(f"vgg packed {name}: card and CPU logits differ by {gap} on 8 images")
        print(f"vgg packed {name}: card vs CPU (plain versions) on 8 images: max |logit gap| "
              f"{gap:.4g} (tolerance {VGG_LOGIT_ATOL} + {VGG_LOGIT_RTOL} |ref|), same argmax",
              flush=True)

    backends = {"packed": forwards["unprepared"], "packed prepared": forwards["prepared"],
                "fake-quant": model}
    throughput(card, "vgg", backends, shape)
    xb = torch.from_numpy(rng.normal(size=(RESNET_BATCH, *shape)).astype(np.float32)).to(dev)
    for name, forward in backends.items():
        with torch.inference_mode():
            line = profile_line(lambda: forward(xb), "forward", 10)
        print(f"vgg {name} b={RESNET_BATCH} {line}  [{card}]", flush=True)
    return launches


def lm_code_shares(model, md, toks) -> None:
    """Print, for the first and last block, the code shares of each GEMM
    input (the [0, 1] grid of a_bits) on one prefill of ``toks``."""
    import torch

    from pytorch_quantize_impls_tpu_torch.nn import intercept_quant_layers

    n_a = 2**model.a_bits - 1
    names = {}
    for i in (0, model.n_layers - 1):
        blk = getattr(model, f"block{i}")
        for label, m in zip(GEMM_INPUTS, (blk.attn.q, blk.attn.out, blk.ffn_in, blk.ffn_out)):
            names[id(m)] = f"block{i} {label}"
    shares = {}

    def interceptor(m, x, fake_quant_forward):
        if id(m) in names:
            codes = torch.round(torch.clamp(x, 0, 1) * n_a).flatten().to(torch.int64)
            counts = torch.bincount(codes, minlength=n_a + 1).double()
            shares[names[id(m)]] = (counts / counts.sum()).tolist()
        return fake_quant_forward(x)

    with torch.no_grad(), intercept_quant_layers(interceptor):
        md(toks, None)
    for name, share in shares.items():
        print(f"W4A4 LM {name:24s} input code shares 0..{n_a}: "
              + " ".join(f"{v:.3f}" for v in share), flush=True)


def lm_teacher_forced(card: str, model, recs) -> None:
    """The packed W4A4 LM against the fake-quant decode model, both fed the
    fake-quant model's greedy tokens: a 64-token prefill, then 32 steps over
    SLOTS rows.

    Per projection (the gate): inside the fake-quant forward, every
    QuantDense also runs its packed record on the same input, and the two
    outputs must agree within W4A4_GEMM_RTOL of the call's largest output.

    End to end (reported, with a floor): each packed call starts from a copy
    of the fake-quant model's cache (lockstep). A W4A4 model of this width
    is chaotic in code space: a code flipped by float rounding (a sum within
    an ulp of a .5 boundary) moves every output of the next projection by
    ~1/225, which flips ~7% of the codes after it, so one step's 8 layers
    amplify a few first flips into logit gaps of ~0.1 and argmax moves where
    the top two logits are that close. The floor catches a wrong scale or
    code mapping (argmax would agree on ~1/8192), not this."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.nn import intercept_quant_layers
    from pytorch_quantize_impls_tpu_torch.serve import decode_model

    dev = cuda()
    b, steps = SLOTS, 32
    rng = np.random.default_rng(SEED + 8)
    toks = torch.from_numpy(rng.integers(0, LM_CFG["vocab"], (b, 64)).astype(np.int32)).to(dev)
    md = decode_model(model)
    lm_code_shares(model, md, toks[:4])
    paths = {id(m): tuple(n.split(".")) for n, m in md.named_modules()}
    kind = {"q": 0, "k": 0, "v": 0, "out": 1, "ffn_in": 2, "ffn_out": 3}
    worst = [0.0] * len(GEMM_INPUTS)
    calls = [0]

    def per_gemm(m, x, fake_quant_forward):
        y = fake_quant_forward(x)
        path = paths[id(m)]
        got = infer.packed_apply(m, {("",): recs[path]}, x)
        rel = ((got - y).abs().max() / y.abs().max()).item()
        j = kind[path[-1]]
        worst[j] = max(worst[j], rel)
        calls[0] += 1
        return y

    def clone(cache):
        return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in cache.items()}

    agree = total = 0
    gaps = []
    cache, t = None, toks
    with torch.no_grad():
        for step in range(steps + 1):
            got, _ = infer.packed_apply(md, recs, t, None if cache is None else clone(cache))
            with intercept_quant_layers(per_gemm):
                ref, cache = md(t, cache)
            gaps.append((got[:, -1] - ref[:, -1]).abs().amax(dim=1).cpu())
            if step > 0:
                total += b
                agree += int((got[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).sum())
            t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
    gaps = torch.cat(gaps).double().numpy()
    per = ", ".join(f"{k}: {w:.3g}" for k, w in zip(GEMM_INPUTS, worst))
    print(f"W4A4 LM packed vs fake-quant, teacher-forced: per projection on the same input, "
          f"{calls[0]} calls, max |diff| / max |output| by GEMM input ({per}; tolerance "
          f"{W4A4_GEMM_RTOL}); end to end in lockstep, {steps} steps x {b} rows, argmax agrees "
          f"on {agree}/{total} ({100 * agree / total:.2f}%, floor "
          f"{100 * W4A4_ARGMAX_FLOOR:.0f}%), row max |logit gap| median {np.median(gaps):.4g} "
          f"max {gaps.max():.4g}  [{card}]", flush=True)
    if max(worst) > W4A4_GEMM_RTOL:
        fail(f"W4A4 LM: a packed projection differs from its fake-quant GEMM by "
             f"{max(worst):.3g} of its largest output")
    if agree < W4A4_ARGMAX_FLOOR * total:
        fail(f"W4A4 LM teacher-forced: argmax agrees on only {agree} of {total}")


def w4a4_lm_path(card: str):
    """Main path 4: the serving LM's shape with DoReFa W4A4 weights and
    activations, through DecodeEngine(packed=): the unprepared records (K6),
    then prepare() (K7) and the prepared ones (K3), each path's counters
    zeroed just before it. Both must answer every request with the same
    tokens: the GEMMs are integer-exact and share one f32 scale."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.serve import DecodeEngine, decode_model

    dev = cuda()
    t0 = time.perf_counter()
    model = build_lm(W4A4_LM_CFG, SEED + 9)
    packed = infer.pack_model(model)
    print(f"W4A4 LM built and packed in {time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated", flush=True)
    rng = np.random.default_rng(SEED + 10)
    prompts = [rng.integers(0, LM_CFG["vocab"], rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(DECODE_REQUESTS)]
    answers, launches, records = {}, {}, {}
    for name, required in (("unprepared", (pm.dorefa_gemm,)),
                           ("prepared", (pm.decode_dorefa_weights, im.int8_gemm))):
        zero_launches()
        recs = packed if name == "unprepared" else infer.prepare(packed)
        engine = DecodeEngine(model, packed=recs, n_slots=SLOTS, device=dev)
        t1 = time.perf_counter()
        try:
            answers[name] = serve(lambda i: engine.submit(prompts[i], max_new=MAX_NEW),
                                  len(prompts))
        finally:
            engine.shutdown()
        dt = time.perf_counter() - t1
        st = engine.stats
        print(f"decode engine[W4A4 packed {name}]: {st.requests} requests, {st.tokens} tokens "
              f"in {dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps, mean occupancy "
              f"{st.mean_occupancy:.3f}  [{card}]", flush=True)
        if st.requests != len(prompts) or st.tokens != MAX_NEW * len(prompts):
            fail(f"W4A4 engine[{name}] answered {st.requests} requests, {st.tokens} tokens")
        launches[f"lm_w4a4_{name}"] = read_launches(f"lm_w4a4_{name}", required)
        records[name] = recs
    if any(not np.array_equal(a, b) for a, b in zip(answers["unprepared"], answers["prepared"])):
        fail("the W4A4 LM's unprepared and prepared engines answered differently")
    print(f"W4A4 LM: unprepared and prepared engines gave the same {MAX_NEW} tokens for all "
          f"{len(prompts)} requests", flush=True)
    lm_teacher_forced(card, model, records["prepared"])
    md = decode_model(model)
    backends = {"fake-quant": lambda c, t: md(t, c)}
    for name, recs in records.items():
        backends[f"packed {name}"] = lambda c, t, recs=recs: infer.packed_apply(md, recs, t, c)
    decode_speed(card, backends)
    return launches


# --- main path 6: the serving LM's shape with W4 log weights, packed ----------


def seeded_log_lm_variables(cfg: dict, rng) -> dict:
    """:func:`seeded_lm_variables` for W4 log weights: each projection kernel
    is N(0, 1/fan_in), so every projection output stays O(1) and the
    exponent indices of a kernel spread over about 7 levels around
    2^-5 (fsr 0: levels 2^-16 .. 2^0); the FFN biases are 0.1-scale."""
    v = seeded_lm_variables(cfg, rng)
    for i in range(cfg["n_layers"]):
        blk = v["params"][f"block{i}"]
        for node in (*blk["attn"].values(), blk["ffn_in"], blk["ffn_out"]):
            node["kernel"] = node["kernel"] * np.float32(node["kernel"].shape[0] ** -0.5)
        for name in ("ffn_in", "ffn_out"):
            blk[name]["bias"] = rng.normal(size=blk[name]["bias"].shape).astype(np.float32) * 0.1
    return v


def log_lm_teacher_forced(card: str, model, records: dict) -> None:
    """The packed log LM (unprepared and prepared) against the fake-quant
    decode model, all fed the fake-quant model's greedy tokens: a 64-token
    prefill, then 32 steps over SLOTS rows.

    Per projection (the gate): inside the fake-quant forward, every
    QuantDense also runs each packed record on the same input x, and each
    output must be within rtol (|x| @ |w| + |bias|) of the fake-quant one:
    SHIFT_RTOL for the prepared record (the same float32 x and weights; the
    fake-quant exp2 may sit an ulp off the exact decoded level), plus
    BF16_INPUT_RTOL for the unprepared one (K8 rounds x to bf16).

    End to end: each packed call starts from a copy of the fake-quant
    model's cache (lockstep); argmax must agree on LOG_ARGMAX_FLOOR of the
    (step, row) pairs."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.nn import intercept_quant_layers
    from pytorch_quantize_impls_tpu_torch.serve import decode_model

    dev = cuda()
    b, steps = SLOTS, 32
    rng = np.random.default_rng(SEED + 41)
    toks = torch.from_numpy(rng.integers(0, LM_CFG["vocab"], (b, 64)).astype(np.int32)).to(dev)
    md = decode_model(model)
    paths = {id(m): tuple(n.split(".")) for n, m in md.named_modules()}
    kind = {"q": 0, "k": 0, "v": 0, "out": 1, "ffn_in": 2, "ffn_out": 3}
    rtol = {"unprepared": BF16_INPUT_RTOL + SHIFT_RTOL, "prepared": SHIFT_RTOL}
    worst = {name: [0.0] * len(GEMM_INPUTS) for name in records}
    calls = [0]

    def per_gemm(m, x, fake_quant_forward):
        y = fake_quant_forward(x)
        path = paths[id(m)]
        bound = x.abs().double() @ m.weight_quant(m.weight).abs().double().T
        if m.bias is not None:
            bound = bound + m.bias.abs().double()
        for name, recs in records.items():
            got = infer.packed_apply(m, {("",): recs[path]}, x)
            rel = ((got - y).abs().double() / bound.clamp_min(1e-300)).max().item()
            j = kind[path[-1]]
            worst[name][j] = max(worst[name][j], rel)
        calls[0] += 1
        return y

    def clone(cache):
        return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in cache.items()}

    agree = {name: 0 for name in records}
    total = 0
    cache, t = None, toks
    with torch.no_grad():
        for step in range(steps + 1):
            got = {name: infer.packed_apply(md, recs, t, None if cache is None else clone(cache))[0]
                   for name, recs in records.items()}
            with intercept_quant_layers(per_gemm):
                ref, cache = md(t, cache)
            if step > 0:
                total += b
                for name in records:
                    agree[name] += int((got[name][:, -1].argmax(-1) == ref[:, -1].argmax(-1)).sum())
            t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
    for name in records:
        per = ", ".join(f"{k}: {w:.3g}" for k, w in zip(GEMM_INPUTS, worst[name]))
        print(f"log LM packed {name} vs fake-quant, teacher-forced: per projection on the same "
              f"input, {calls[0]} calls, largest |diff| / (|x| @ |w|) by GEMM input ({per}; "
              f"tolerance {rtol[name]:.6g}); end to end in lockstep, {steps} steps x {b} rows, "
              f"argmax agrees on {agree[name]}/{total} ({100 * agree[name] / total:.2f}%, floor "
              f"{100 * LOG_ARGMAX_FLOOR[name]:.0f}%)  [{card}]", flush=True)
        if max(worst[name]) > rtol[name]:
            fail(f"log LM {name}: a packed projection differs from its fake-quant GEMM by "
                 f"{max(worst[name]):.3g} of |x| @ |w|")
        if agree[name] < LOG_ARGMAX_FLOOR[name] * total:
            fail(f"log LM {name} teacher-forced: argmax agrees on only {agree[name]} of {total}")


def log_lm_path(card: str):
    """Main path 6: the serving LM's shape with W4 log weights, through
    DecodeEngine(packed=): the unprepared records (K8 on every projection),
    then prepare() (K9) and the prepared records (no K8), each path's
    counters zeroed just before it; then the seams and the speeds."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.serve import DecodeEngine, decode_model

    dev = cuda()
    t0 = time.perf_counter()
    model = build_lm(LOG_LM_CFG, SEED + 40)
    last = f"block{LOG_LM_CFG['n_layers'] - 1}."
    exponent_histograms("log LM", model, 6, show=("block0.", last))
    packed = infer.pack_model(model)
    print(f"log LM built and packed in {time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated", flush=True)
    rng = np.random.default_rng(SEED + 42)
    prompts = [rng.integers(0, LM_CFG["vocab"], rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(DECODE_REQUESTS)]
    answers, launches, records = {}, {}, {}
    for name, required, absent in (("unprepared", sm.shift_gemm, sm.decode_log_weights),
                                   ("prepared", sm.decode_log_weights, sm.shift_gemm)):
        zero_launches()
        recs = packed if name == "unprepared" else infer.prepare(packed)
        engine = DecodeEngine(model, packed=recs, n_slots=SLOTS, device=dev)
        t1 = time.perf_counter()
        try:
            answers[name] = serve(lambda i: engine.submit(prompts[i], max_new=MAX_NEW),
                                  len(prompts))
        finally:
            engine.shutdown()
        dt = time.perf_counter() - t1
        st = engine.stats
        print(f"decode engine[log packed {name}]: {st.requests} requests, {st.tokens} tokens in "
              f"{dt:.2f} s ({st.tokens / dt:.1f} tok/s), {st.steps} steps, mean occupancy "
              f"{st.mean_occupancy:.3f}  [{card}]", flush=True)
        if st.requests != len(prompts) or st.tokens != MAX_NEW * len(prompts):
            fail(f"log LM engine[{name}] answered {st.requests} requests, {st.tokens} tokens")
        launches[f"lm_log_{name}"] = read_launches(f"lm_log_{name}", (required,))
        if launches[f"lm_log_{name}"][absent.__name__]:
            fail(f"the {name} log LM path launched {absent.__name__}")
        records[name] = recs
    same = sum(np.array_equal(a, b) for a, b in zip(answers["unprepared"], answers["prepared"]))
    print(f"log LM: the unprepared (bf16 x) and prepared (float32 x) engines gave the same "
          f"{MAX_NEW} tokens for {same} of {len(prompts)} requests", flush=True)
    log_lm_teacher_forced(card, model, records)
    md = decode_model(model)
    backends = {"fake-quant": lambda c, t: md(t, c)}
    for name, recs in records.items():
        backends[f"packed {name}"] = lambda c, t, recs=recs: infer.packed_apply(md, recs, t, c)
    decode_speed(card, backends)
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    card = card_line()
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is on; the fake-quant forward must run in float32")

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build()
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    summary = check_kernels(card)
    model, prepared, example_shape, launches = main_path(card)
    launches = {"bnn_lenet": launches}
    throughput(card, "bnn_lenet", {
        "packed prepared": lambda x: infer.packed_apply(model, prepared, x),
        "fake-quant": model,
    }, example_shape)
    del model, prepared
    launches["decode_lm"] = decode_path(card)
    launches.update(resnet_path(card))
    launches.update(w4a4_lm_path(card))
    launches.update(vgg_path(card))
    launches.update(log_lm_path(card))

    src = f"{PORT}/csrc"
    tpu = "pytorch_quantize_impls_tpu"
    meta = {
        "binary_gemm": ("xnor_gemm.cu", f"{tpu}/kernels/xnor_gemm.py:132"),
        "decode_binary_weights": ("xnor_gemm.cu", f"{tpu}/kernels/xnor_gemm.py:308"),
        "int8_gemm": ("int8_matmul.cu", f"{tpu}/kernels/int8_matmul.py:99"),
        "decode_attention": ("decode_attention.cu", f"{tpu}/kernels/decode_attention.py:113"),
        # not a pallas_call: XLA's int8 conv_general_dilated
        "int8_conv2d": ("int8_conv.cu", f"{tpu}/kernels/conv.py:121"),
        "dorefa_gemm": ("dorefa_gemm.cu", f"{tpu}/kernels/packed_matmul.py:156"),
        "decode_dorefa_weights": ("dorefa_gemm.cu", f"{tpu}/kernels/packed_matmul.py:315"),
        "shift_gemm": ("shift_gemm.cu", f"{tpu}/kernels/shift_matmul.py:112"),
        "decode_log_weights": ("shift_gemm.cu", f"{tpu}/kernels/shift_matmul.py:260"),
    }
    rows = []
    for name, (cu, replaces) in meta.items():
        s = summary[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        rows.append({
            "name": name, "route": "cuda", "source": f"{src}/{cu}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            **{k: v for k, v in s.items()
               if k in ("shape", "device_ms", "sdpa_dequantized_ms", "cublas_bf16_ms")},
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
