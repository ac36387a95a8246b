"""The launch plan of decode_attention (K4), swept on the card.

K4 (``csrc/decode_attention.cu``) runs one thread-block cluster of C blocks
per (b, h), each block owning a share of the cache rows
(``kernels.common.attention_plan``). This script times the kernel at the
five shapes ``chip_smoke.py`` times it at (the decode LM's h 8, cache 1024,
head dim 128: b = 32 at the engine's cursors, b = 1, 8 and 32 with cursors
anywhere in the cache, b = 32 with a full cache) for every cluster size.
Each configuration is first held against the
plain version (``rtol 1e-5, atol 1e-5 * max|plain|``, as ``chip_smoke.py``
holds it); then its time per call by CUDA events (median of ``repeats``
windows of back-to-back calls), and last its device time per launch by
torch.profiler (a profiler session slows later launches on the host, so
every CUDA-event time is taken first).

    python -m pytorch_quantize_impls_tpu_torch.bench.attention_cost

prints one JSON line per shape and configuration (the default plan's
marked), a table, and the card last; without a GPU it raises and prints no
result. Run as a file it times the checkout on ``PYTHONPATH``; one from
before the clustered kernel (no ``attention_plan``) is timed at its one
launch per (b, h), so two checkouts compare in one call.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pytorch_quantize_impls_tpu_torch.bench import common
from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as da

try:
    from pytorch_quantize_impls_tpu_torch.kernels.common import ATTN_CLUSTERS, attention_plan
except ImportError:  # a checkout before the clustered kernel
    ATTN_CLUSTERS, attention_plan = (), None

H, CL, HD = 8, 1024, 128
# the engine's cursors: a prompt of 16..128 tokens plus up to 32 new ones
ENGINE_LENS = (17, 160)


def shapes(rng) -> list:
    """(label, b, lens): the five timed shapes of chip_smoke.py's K4 rows,
    cursors drawn from the same ranges."""
    lo, hi = ENGINE_LENS
    return [
        ("b=32 engine cursors", 32, rng.integers(lo, hi + 1, 32)),
        ("b=1 varied", 1, rng.integers(1, CL + 1, 1)),
        ("b=8 varied", 8, rng.integers(1, CL + 1, 8)),
        ("b=32 varied", 32, rng.integers(1, CL + 1, 32)),
        ("b=32 full", 32, np.full(32, CL)),
    ]


def inputs(rng, b: int, lens, dev) -> tuple:
    """(q, k_codes, k_scale, v_codes, v_scale, mask_bias) as chip_smoke.py
    draws them."""
    q = rng.normal(size=(b, H, HD)).astype(np.float32)
    kc = rng.integers(-127, 128, (b, H, CL, HD)).astype(np.int8)
    vc = rng.integers(-127, 128, (b, H, CL, HD)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (b, H, CL)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (b, H, CL)).astype(np.float32)
    bias = np.where(np.arange(CL)[None, :] < np.asarray(lens)[:, None], 0.0, -1e30)
    return tuple(common.to(a, dev) for a in (q, kc, ks, vc, vs, bias.astype(np.float32)))


def device_ms(fn, iters: int = 20):
    """Device time per call of the K4 kernel under torch.profiler, or None
    if the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
             if "decode_attention_kernel" in e.key)
    return us / 1e3 / iters if us > 0 else None


def configs(b: int) -> list:
    """(label, plan) of each launch to time: every cluster size's plan, or
    the one launch per (b, h) of a checkout before the clustered kernel."""
    if attention_plan is None:
        return [("one block per (b, h)", None)]
    return [(f"C={c}", attention_plan(b, H, CL, HD, c)) for c in ATTN_CLUSTERS]


def run(device="cuda", *, window_s: float = 0.05, repeats: int = 5, log=print) -> list:
    dev = common.require_card(device)
    rng = np.random.default_rng(0)
    rows, calls = [], []
    for label, b, lens in shapes(rng):
        args = inputs(rng, b, lens, dev)
        ref = da.decode_attention_reference(*args)
        scale = ref.abs().max().item()
        default = attention_plan(b, H, CL, HD) if attention_plan else None
        for name, plan in configs(b):
            fn = ((lambda a=args, p=plan: da.launch(*a, p)) if plan
                  else (lambda a=args: da.decode_attention(*a)))
            got = fn()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * scale):
                raise RuntimeError(f"{label} {name}: max |err| {err} beyond 1e-5 of max |plain| "
                                   f"{scale}")
            med, spread = common.time_call(fn, window_s=window_s, repeats=repeats)
            rows.append(dict(shape=label, config=name, chunk=plan and plan["chunk"],
                             blocks=plan["blocks"] if plan else b * H,
                             default=plan is None or plan == default, max_abs_err=err,
                             ms=med * 1e3, spread_pct=100 * spread))
            calls.append(fn)
    for row, fn in zip(rows, calls):  # device times last
        row["device_ms"] = device_ms(fn)
        log(json.dumps(row))
    log("shape                  config                 blocks  ms (events, wrapper included)"
        "  device ms")
    for r in rows:
        dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        log(f"{r['shape']:22s} {r['config']:22s} {r['blocks']:6d}  {r['ms']:.4f}"
            f"                        {dms}{'  (default)' if r['default'] else ''}")
    log(json.dumps({"device": common.card_line()}))
    return rows


if __name__ == "__main__":
    run()
