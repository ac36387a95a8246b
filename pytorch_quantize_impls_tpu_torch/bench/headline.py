"""The headline GEMM benchmark on the card: quantized GEMM TFLOP-equiv/s at
4096^3 against a float32 matmul.

Counterpart of ``bench.py:156-311`` (the metric ``BASELINE.json:2`` names).
The baseline is ``torch.matmul`` in float32 with TF32 off; a bf16
``torch.matmul`` stands for its bf16 "speed of light", ``torch._int_mm``
for its measured int8 peak. The rows are the port's kernels on the same
seeded inputs: binary fused (``binary_gemm``), binary ws
(``binary_gemm_ws``), binary decoded (``decode_binary_weights`` once, then
``int8_gemm``; float32 out where the JAX path returns bf16), dorefa4 packed
(``dorefa_gemm``) and log shift (``shift_gemm``). The headline value is the
better of binary fused and binary ws (``bench.py:224-225``).

    python -m pytorch_quantize_impls_tpu_torch.bench.headline

prints detail lines on stderr and one JSON line with ``bench.py``'s keys plus
``device`` (the card's name and power limit). Without a GPU it raises and
prints no result (there is no CPU fallback); it writes no file.
"""

from __future__ import annotations

import json
import sys

import torch

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.bench import common
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

METRIC = "binary_gemm_tflops_equiv_per_chip_4096"


def build_rows(m: int, n: int, k: int, device) -> list:
    """The timed rows on seeded inputs: dicts with ``name``, ``label``,
    ``fn`` (the timed call), ``plain`` (the same function through plain
    versions, float64 sums) and ``exact`` (whether ``fn`` must equal
    ``plain`` bit for bit: every kernel row and the int8 yardstick); the
    log shift row adds ``abs_ref``, |bf16(x)| @ |w| in float64, the scale of
    its float32 sum's error. The one-time decode of the binary decoded row
    runs here."""
    rng, xn, wn = common.seeded_inputs(m, n, k)
    x, w = common.to(xn, device), common.to(wn, device)
    xi8 = common.to(rng.integers(-127, 127, (m, k)), device).to(torch.int8)
    wi8 = common.to(rng.integers(-127, 127, (k, n)), device).to(torch.int8)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)

    xi = bg.binarize_to_int8(x)
    wp = bg.pack_binary_weights(w)
    alpha = w.abs().mean(0)
    w8 = bg.decode_binary_weights(wp)
    codes = pm.dorefa_act_to_int8(ops.dorefa_activation(x.abs(), 4), 4)
    wp4 = pm.pack_dorefa_weights(ops.dorefa_weight(w, 4), 4)
    wpl = sm.pack_log_weights(w, 1.0, 4)

    def f64(a, b):
        return a.to(torch.float64) @ b.to(torch.float64)

    return [
        dict(name="fp32_highest", label="fp32 torch.matmul (TF32 off)", exact=False,
             fn=lambda: torch.matmul(x, w), plain=lambda: f64(x, w).to(torch.float32)),
        dict(name="bf16_peak", label="bf16 torch.matmul", exact=False,
             fn=lambda: torch.matmul(xb, wb), plain=lambda: f64(xb, wb).to(torch.bfloat16)),
        dict(name="int8_peak", label="int8 torch._int_mm", exact=True,
             fn=lambda: torch._int_mm(xi8, wi8), plain=lambda: f64(xi8, wi8).to(torch.int32)),
        dict(name="binary_fused", label="binary fused (binary_gemm)", exact=True,
             fn=lambda: bg.binary_gemm(xi, wp, alpha),
             plain=lambda: bg.binary_gemm_reference(xi, wp, alpha)),
        dict(name="binary_ws", label="binary ws (binary_gemm_ws)", exact=True,
             fn=lambda: bg.binary_gemm_ws(xi, wp, alpha),
             plain=lambda: bg.binary_gemm_ws_reference(xi, wp, alpha)),
        dict(name="binary_decoded", label="binary decoded (int8_gemm, f32 out)", exact=True,
             fn=lambda: bg.binary_gemm_decoded(xi, w8, alpha),
             plain=lambda: bg.binary_gemm_reference(xi, wp, alpha)),
        dict(name="dorefa4_packed", label="dorefa4 packed (dorefa_gemm)", exact=True,
             fn=lambda: pm.dorefa_gemm(codes, wp4, w_bits=4, a_bits=4),
             plain=lambda: pm.dorefa_gemm_reference(codes, wp4, w_bits=4, a_bits=4)),
        dict(name="log_shift", label="log shift (shift_gemm)", exact=False,
             fn=lambda: sm.shift_gemm(x, wpl, fsr=1.0, bits=4),
             plain=lambda: sm.shift_gemm_reference(x, wpl, fsr=1.0, bits=4),
             abs_ref=lambda: f64(xb.abs(), sm.decode_log_weights_reference(
                 wpl, fsr=1.0, bits=4)[:k].abs())),
    ]


def run(device="cuda", *, window_s: float = 0.5, repeats: int = 7, log=None,
        rows=None) -> dict:
    """Times every row at 4096^3 (median of ``repeats`` runs of about
    ``window_s`` s each, CUDA events) and returns ``bench.py``'s result
    dict, with ``device`` and per-row ms. ``rows``: those of
    :func:`build_rows` at 4096^3, if the caller built them (to check them
    too); else built here."""
    dev = common.require_card(device)
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    flops = 2 * common.SHAPE**3
    if rows is None:
        rows = build_rows(common.SHAPE, common.SHAPE, common.SHAPE, dev)
    t, spread = {}, {}
    for r in rows:
        t[r["name"]], spread[r["name"]] = common.time_call(r["fn"], window_s=window_s,
                                                           repeats=repeats)
    peak = {"int8": t["int8_peak"], "bf16": t["bf16_peak"]}
    for r in rows:
        name = r["name"]
        ref = "bf16" if name in ("log_shift", "bf16_peak", "fp32_highest") else "int8"
        log(f"# {r['label']:38s} {t[name] * 1e3:.4f} ms  {flops / t[name] / 1e12:.2f} T/s "
            f"({t['fp32_highest'] / t[name]:.3f}x fp32, {100 * peak[ref] / t[name]:.1f}% of the "
            f"measured {ref} peak, ±{100 * spread[name]:.1f}%)")
    best = min(("binary_fused", "binary_ws"), key=t.get)
    tb = t[best]
    return {
        "metric": METRIC,
        "value": flops / tb / 1e12,
        "unit": "TFLOP-equiv/s",
        "vs_baseline": t["fp32_highest"] / tb,
        "spread_pct": 100 * spread[best],
        "pct_of_int8_peak": 100 * t["int8_peak"] / tb,
        "pct_of_datasheet_int8_peak": 100 * flops / tb / common.INT8_OPS_PER_S,
        "headline_kernel": {"binary_fused": "binary_gemm", "binary_ws": "binary_gemm_ws"}[best],
        "detail_tflops": {**{name: flops / s / 1e12 for name, s in t.items()},
                          "binary_fused_best": flops / tb / 1e12},
        "ms": {name: s * 1e3 for name, s in t.items()},
        "device": common.card_line(),
    }


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
