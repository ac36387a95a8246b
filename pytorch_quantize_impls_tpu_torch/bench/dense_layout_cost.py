"""What the packed real-input dense branch costs, on the card.

The packed LMs whose projections take real inputs (W4 log weights, ternary
weights, W4 DoReFa weights only) multiply the decoded weights by the float
inputs (``infer/packed.py``, the last branch of ``_dense_forward_2d``). This
script

1. (``gemms``) times that product alone at each projection of the serving
   LM (d 1024, d_ff 4096: K x N 1024 x 1024, 1024 x 4096, 4096 x 1024) for
   M in {1, 8, 32}, bf16 and float32: the decoded weights stored (K, N)
   row-major (``kn``), stored out-major as the fake-quant layer's (N, K)
   (``out_major``), and copied out-major on every call (``copy_per_call``).
   Device ms per call by torch.profiler, every kernel the call launches;
2. (``steps``) times the decode step of those LMs at the serving LM's
   shape (8 layers, vocab 8192) through ``infer.packed_apply`` on the
   decode-mode model: unprepared (the weights decoded on every call) and
   prepared (``infer.prepare``, decoded once), and the fake-quant model
   beside them. Each step feeds the previous step's argmax and advances the
   cache, from a 128-token prefill, at b = 1, 8 and 32: ms per step by CUDA
   events (the median of ``repeats`` windows of ``steps`` steps; the host
   drives these steps, so this is mostly host time), then device-busy ms
   per step and launches per step by torch.profiler over ``steps`` steps,
   and the device ms of the GEMM kernels among them. Weights are the
   model's own initial ones from ``--seed``.

    python pytorch_quantize_impls_tpu_torch/bench/dense_layout_cost.py [--repeats 5]

prints one JSON line per row and the card last; without a GPU it exits 1
and prints no result. Part 2 calls only the package's public functions, so
run as a file with ``PYTHONPATH=<checkout>`` it times that checkout, and
two checkouts compare in one call (``--part steps``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

LM = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=8, d_ff=4096, max_len=1024)
SCHEMES = {
    "log": dict(scheme="log", w_bits=4, a_bits=0, fsr=0.0),
    "ternary": dict(scheme="ternary", w_bits=1, a_bits=0),
    "dorefa_w4": dict(scheme="dorefa", w_bits=4, a_bits=0),
}
BATCHES = (1, 8, 32)
PREFILL = 128
PROJECTIONS = ((1024, 1024), (1024, 4096), (4096, 1024))  # (K, N)


def device_ms(fn, iters: int):
    """(device-busy ms, launches, GEMM and GEMV kernels' device ms) per call of
    ``fn`` over ``iters`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = launches = gemm = 0.0
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us > 0:
            busy += us / 1e3 / iters
            launches += e.count / iters
            if "gemm" in e.key.lower() or "gemv" in e.key.lower():
                gemm += us / 1e3 / iters
    return busy, launches, gemm


def gemms(card: str, iters: int) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for k, n in PROJECTIONS:
            w_kn = torch.randint(-1, 2, (k, n), generator=g).to(dev, dtype)
            w_out = w_kn.T.contiguous().T
            for m in BATCHES:
                x = torch.randn(m, k, generator=g).to(dev, dtype)
                variants = {"kn": lambda: x @ w_kn, "out_major": lambda: x @ w_out,
                            "copy_per_call": lambda: x @ w_kn.T.contiguous().T}
                for name, fn in variants.items():
                    busy, launches, _ = device_ms(fn, iters)
                    print(json.dumps({"part": "gemms", "dtype": str(dtype), "m": m, "k": k,
                                      "n": n, "layout": name, "device_ms": busy,
                                      "launches": launches, "card": card}), flush=True)


def step_ms(apply, vocab: int, b: int, steps: int, repeats: int, rng):
    """Median ms per decode step over ``repeats`` windows of ``steps``, and
    the decode state to go on from."""
    dev = torch.device("cuda")
    toks = torch.from_numpy(rng.integers(0, vocab, (b, PREFILL)).astype(np.int32)).to(dev)
    logits, cache = apply(None, toks)
    t = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(3):
        logits, cache = apply(cache, t)
        t = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            logits, cache = apply(cache, t)
            t = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / steps)
    return statistics.median(times), {"cache": cache, "t": t}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False).stdout
        return out.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def steps(card: str, args) -> None:
    import pytorch_quantize_impls_tpu_torch as pkg
    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.models import QuantTransformerLM
    from pytorch_quantize_impls_tpu_torch.serve import decode_model

    for scheme, kw in SCHEMES.items():
        torch.manual_seed(args.seed)
        model = QuantTransformerLM(**LM, **kw).to("cuda").eval()
        md = decode_model(model)
        packed = infer.pack_model(model)
        ready = infer.prepare(packed)
        backends = {
            "fake-quant": lambda c, t: md(t, c),
            "unprepared": lambda c, t: infer.packed_apply(md, packed, t, c),
            "prepared": lambda c, t: infer.packed_apply(md, ready, t, c),
        }
        with torch.no_grad():
            for records, apply in backends.items():
                rng = np.random.default_rng(args.seed)
                for b in BATCHES:
                    ms, state = step_ms(apply, LM["vocab"], b, args.steps, args.repeats, rng)

                    def step():
                        logits, state["cache"] = apply(state["cache"], state["t"])
                        state["t"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

                    busy, launches, gemm = device_ms(step, args.steps)
                    print(json.dumps({"part": "steps", "checkout": pkg.__file__,
                                      "scheme": scheme, "records": records, "b": b,
                                      "ms_per_step": ms, "device_ms_per_step": busy,
                                      "launches_per_step": launches, "gemm_device_ms": gemm,
                                      "card": card}), flush=True)
                    del state
        del model, md, packed, ready, backends
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--part", choices=("gemms", "steps", "all"), default="all")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--iters", type=int, default=50, help="calls profiled per GEMM")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_layout_cost needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    if args.part in ("gemms", "all"):
        gemms(card, args.iters)
    if args.part in ("steps", "all"):
        steps(card, args)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
