"""Kernel microbenchmark and tile sweep on the card.

Counterpart of ``scripts/kernel_bench.py:65-159``. Times one of the port's
packed GEMM kernels at ``--shape`` against the float32 (TF32 off) and bf16
``torch.matmul`` yardsticks. Where the JAX script sweeps Pallas tiles
``(tm, tn, tk)``, this one sweeps ``m_tiles`` (``kernels.common.WS_M_TILES``)
for the weight-stationary kernels; the other kernels have one configuration
each, which it times and names. ``dorefa_ws`` and ``shift_ws`` time
``dorefa_gemm_ws`` and ``shift_gemm_ws``, which the JAX script never timed.

    python -m pytorch_quantize_impls_tpu_torch.bench.kernel_bench --kernel binary_ws

prints one JSON line per configuration, then a ``best`` line; without a GPU
it raises and prints no result.
"""

from __future__ import annotations

import argparse
import json

import torch

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.bench import common
from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
from pytorch_quantize_impls_tpu_torch.kernels.common import WS_M_TILES

KERNELS = ("binary", "binary_ws", "binary_decoded", "dorefa", "dorefa_ws", "shift", "shift_ws")
FIXED = "one configuration: 64 x 64 output tiles (CUDA cores)"


def build(kernel: str, shape=(common.SHAPE,) * 3, bits: int = 4, device="cuda"):
    """The configurations of ``kernel`` on seeded inputs (as
    ``scripts/kernel_bench.py:85-139`` makes them): a list of (config dict,
    timed call, plain version of the same function)."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r}: one of {KERNELS}")
    m, n, k = shape
    _, xn, wn = common.seeded_inputs(m, n, k)
    x, w = common.to(xn, device), common.to(wn, device)
    if kernel.startswith("binary"):
        xi, wp = bg.binarize_to_int8(x), bg.pack_binary_weights(w)
        alpha = w.abs().mean(0)
        plain = lambda: bg.binary_gemm_reference(xi, wp, alpha)  # noqa: E731
        if kernel == "binary":
            return [({"config": FIXED}, lambda: bg.binary_gemm(xi, wp, alpha), plain)]
        if kernel == "binary_decoded":
            w8 = bg.decode_binary_weights(wp)
            return [({"config": "one configuration: int8_gemm, 64 x 64 output tiles"},
                     lambda: im.int8_gemm(xi, w8[:k], alpha), plain)]
        return [({"m_tiles": r}, lambda r=r: bg.binary_gemm_ws(xi, wp, alpha, m_tiles=r), plain)
                for r in WS_M_TILES]
    if kernel.startswith("dorefa"):
        codes = pm.dorefa_act_to_int8(ops.dorefa_activation(x.abs(), bits), bits)
        wp = pm.pack_dorefa_weights(ops.dorefa_weight(w, bits), bits)
        kw = dict(w_bits=bits, a_bits=bits)
        plain = lambda: pm.dorefa_gemm_reference(codes, wp, **kw)  # noqa: E731
        if kernel == "dorefa":
            return [({"config": FIXED}, lambda: pm.dorefa_gemm(codes, wp, **kw), plain)]
        return [({"m_tiles": r}, lambda r=r: pm.dorefa_gemm_ws(codes, wp, m_tiles=r, **kw), plain)
                for r in WS_M_TILES]
    wp = sm.pack_log_weights(w, 1.0, 4)
    plain = lambda: sm.shift_gemm_reference(x, wp, fsr=1.0, bits=4)  # noqa: E731
    if kernel == "shift":
        return [({"config": FIXED}, lambda: sm.shift_gemm(x, wp, fsr=1.0, bits=4), plain)]
    return [({"m_tiles": r}, lambda r=r: sm.shift_gemm_ws(x, wp, fsr=1.0, bits=4, m_tiles=r), plain)
            for r in WS_M_TILES]


def yardsticks(shape, device) -> dict:
    """float32 (TF32 off) and bf16 ``torch.matmul`` on the same seeded x, w
    (bf16 operands cast once, outside the timed call)."""
    m, n, k = shape
    _, xn, wn = common.seeded_inputs(m, n, k)
    x, w = common.to(xn, device), common.to(wn, device)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    return {"fp32": lambda: torch.matmul(x, w), "bf16": lambda: torch.matmul(xb, wb)}


def run(kernel: str, shape=(common.SHAPE,) * 3, bits: int = 4, device="cuda", *,
        window_s: float = 0.25, repeats: int = 5, log=print) -> dict:
    """Times every configuration of ``kernel`` and the yardsticks; logs one
    JSON line per configuration and a ``best`` line, and returns the best."""
    dev = common.require_card(device)
    flops = 2 * shape[0] * shape[1] * shape[2]
    yard = {name: common.time_call(fn, window_s=window_s, repeats=repeats)[0]
            for name, fn in yardsticks(shape, dev).items()}
    results = []
    for config, fn, _ in build(kernel, shape, bits, dev):
        t, spread = common.time_call(fn, window_s=window_s, repeats=repeats)
        r = {"kernel": kernel, **config, "ms": t * 1e3, "tflops_equiv": flops / t / 1e12,
             "vs_fp32": yard["fp32"] / t, "vs_bf16": yard["bf16"] / t,
             "spread_pct": 100 * spread}
        results.append(r)
        log(json.dumps(r))
    best = {"best": max(results, key=lambda r: r["tflops_equiv"]), "kernel": kernel,
            "shape": list(shape), "fp32_ms": yard["fp32"] * 1e3, "bf16_ms": yard["bf16"] * 1e3,
            "device": common.card_line()}
    log(json.dumps(best))
    return best


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", nargs=3, type=int, default=[common.SHAPE] * 3)
    p.add_argument("--kernel", default="binary", choices=KERNELS)
    p.add_argument("--bits", type=int, default=4, help="dorefa code width")
    a = p.parse_args(argv)
    run(a.kernel, tuple(a.shape), a.bits)


if __name__ == "__main__":
    main()
