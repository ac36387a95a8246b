#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorch_quantize_impls_tpu_torch``)
on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and refuses to run
   without a CUDA device: there is no CPU fallback.
2. Builds every CUDA kernel from ``pytorch_quantize_impls_tpu_torch/csrc``
   with nvcc, one process per source, all at once.
3. Holds each kernel (K1 binary_gemm, K2 decode_binary_weights, K3 int8_gemm)
   against its plain PyTorch version on the card, at the shapes BNN LeNet's
   serving path gives it and at edge shapes; they must agree bit for bit.
4. Drives the main path at full width (``bnn_lenet``, width 128) from seeded
   random weights: bridge -> pack_model -> save_packed -> load_packed ->
   InferenceEngine over the unprepared artifact (K1, K2) -> prepare ->
   InferenceEngine over the prepared artifact (K2, K3), serving requests from
   several client threads. The kernels' launch counters are zeroed just
   before and read just after; each must be > 0. Every answer is then checked
   against packed_apply on the same padded batch, the unprepared and prepared
   artifacts and the fake-quant forward must agree exactly, and a small input
   is checked against the same model run on the CPU.
5. Prints kernel vs plain times, engine images/s per bucket, one JSON line
   with the kernels, and last ``{"ok": true, "device": {...}}``.

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


# --- kernels vs plain versions ---------------------------------------------


def kernel_cases(rng, dev):
    """(kernel, label, kernel_fn, plain_fn, main_shape) for every comparison."""
    import torch

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

    cases = []
    # K2 at every layer's packed shape, and K = 2304 (decode once dropped the
    # last partial K tile there)
    for label, (k, n) in {
        "conv1 (32,128)": (25, 128), "conv2 (128,256)": (3200, 256),
        "fc1 (128,1024)": (4096, 1024), "head (32,10)": (1024, 10),
        "K=2304 (96,256)": (2304, 256),
    }.items():
        wp = packed(k, n)
        cases.append((
            "decode_binary_weights", label, lambda wp=wp: bg.decode_binary_weights(wp),
            lambda wp=wp: bg.decode_binary_weights_reference(wp), label.startswith("conv2"),
        ))
    # K1 and K3 at fc1/head with M in SMALL_M (no scales: the binary scheme)
    gemm_shapes = [(f"{name} M={m}", m, k, n, False, False)
                   for name, k, n in (("fc1", 4096, 1024), ("head", 1024, 10))
                   for m in SMALL_M]
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
        cases.append((
            "binary_gemm", label,
            lambda x=x, wp=wp, a=alpha, r=row: bg.binary_gemm(x, wp, a, r),
            lambda x=x, wp=wp, a=alpha, r=row: bg.binary_gemm_reference(x, wp, a, r),
            main,
        ))
        xi = t(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
        wi = t(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
        cases.append((
            "int8_gemm", label,
            lambda x=xi, w=wi, a=alpha, r=row: im.int8_gemm(x, w, a, r),
            lambda x=xi, w=wi, a=alpha, r=row: im.int8_gemm_reference(x, w, a, r),
            main,
        ))
    return cases


def check_kernels(card: str, timed: bool = True):
    """Compare every kernel with its plain version on the card (bit for bit).
    Returns {kernel: {"max_abs_err", "ms", "plain_ms", "shape"}}."""
    import torch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    summary = {}
    for kernel, label, fn, plain, main in kernel_cases(rng, dev):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            fail(f"{kernel} {label}: {got.dtype} {tuple(got.shape)} vs plain "
                 f"{ref.dtype} {tuple(ref.shape)}")
        err = (got.double() - ref.double()).abs().max().item()
        if not torch.equal(got, ref):
            fail(f"{kernel} {label}: differs from its plain version, max |err| {err}")
        s = summary.setdefault(kernel, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        line = f"check {kernel:22s} {label:32s} bit-equal"
        if timed and not label.startswith("edge"):
            ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
            line += f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  [{card}]"
            if main:
                s.update(ms=ms, plain_ms=plain_ms, shape=label)
        print(line, flush=True)
    return summary


# --- the main path ----------------------------------------------------------


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


def serve(engine, inputs):
    """Submit ``inputs`` from CLIENTS threads with small random gaps; return
    the answers in input order."""
    answers = [None] * len(inputs)
    errors = []

    def client(idx):
        r = np.random.default_rng(SEED + 1 + idx[0])
        try:
            futs = []
            for i in idx:
                futs.append((i, engine.submit(inputs[i])))
                time.sleep(r.uniform(0, 1e-3))
            for i, f in futs:
                answers[i] = f.result(timeout=120)
        except Exception as e:  # reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(list(range(c, len(inputs), CLIENTS)),))
               for c in range(CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        if th.is_alive():
            fail("a client thread did not finish")
    if errors:
        fail(f"a request failed: {errors[0]!r}")
    return answers


def drive_main_path(card: str, model, example_shape, inputs):
    """The main path, from a packed model to served answers: save_packed ->
    load_packed -> InferenceEngine (unprepared artifact) -> prepare ->
    InferenceEngine (prepared artifact). The kernels' launch counters are
    zeroed just before and read just after. Returns (loaded artifact, engine
    answers and logged (batch, output) pairs per artifact, launch counts)."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine

    dev = torch.device("cuda", 0)
    kernels = (bg.binary_gemm, bg.decode_binary_weights, im.int8_gemm)
    logs = {"unprepared": [], "prepared": []}
    answers = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bnn_lenet.npz")
        infer.save_packed(path, infer.pack_model(model))
        for k in kernels:
            k.launches = 0
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
                answers[name] = serve(engine, inputs)
            finally:
                engine.shutdown()
            st = engine.stats
            print(f"engine[{name}]: {st.requests} requests in {st.batches} batches, "
                  f"mean batch {st.mean_batch_size:.2f}, mean latency "
                  f"{st.mean_latency_ms:.3f} ms  [{card}]", flush=True)
            if st.requests != len(inputs):
                fail(f"engine[{name}] answered {st.requests} of {len(inputs)}")
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
    print(f"launches on the main path: {launches}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched on the main path")
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

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    cfg = RunConfig(**SCHEME_CONFIGS["bnn_lenet"])
    model, example_shape, _ = build_model(cfg)
    if cfg.width != WIDTH:
        fail(f"bnn_lenet width {cfg.width}, expected {WIDTH}")
    load_flax_variables(model, seeded_variables(cfg.width, rng))
    cpu_model = copy.deepcopy(model).eval()
    model = model.to(dev).eval()
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


def throughput(card: str, model, prepared, example_shape):
    """Engine images/s per bucket ``b``, closed loop: an engine whose largest
    bucket is ``b`` serves rounds of exactly ``b`` requests submitted at once.
    Its deadline (1 s) is far beyond a round's submissions (which at b=256
    took over 50 ms on the H100 host), so each round is one full batch and
    no deadline is waited out. At least 100 rounds, so the p90 round time has
    10 samples beyond it."""
    import torch

    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 100)
    for b in BUCKETS:
        engine = InferenceEngine(lambda x: infer.packed_apply(model, prepared, x),
                                 example_shape, batch_sizes=(b,), max_delay_ms=1000.0,
                                 device=dev)
        try:
            engine.warmup()
            xs = rng.normal(size=(b, *example_shape)).astype(np.float32)
            rounds = max(100, 2048 // b)
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
        xb = torch.from_numpy(xs).to(dev)
        fwd_ms = cuda_ms(lambda: infer.packed_apply(model, prepared, xb), iters=20)
        fq_ms = cuda_ms(lambda: torch.no_grad()(model)(xb), iters=20)
        p50, p90 = np.percentile(round_ms, [50, 90])
        print(f"engine bucket {b:3d}: {rounds * b / dt:10.1f} images/s, round "
              f"p50 {p50:.3f} ms p90 {p90:.3f} ms ({rounds} rounds in "
              f"{engine.stats.batches} batches); packed forward {fwd_ms:.3f} ms "
              f"({1e3 * b / fwd_ms:.1f} images/s), fake-quant forward {fq_ms:.3f} ms "
              f"per batch  [{card}]", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    card = card_line()
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is on; the fake-quant forward must run in float32")

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
    throughput(card, model, prepared, example_shape)

    src = f"{PORT}/csrc"
    meta = {
        "binary_gemm": ("xnor_gemm.cu", "pytorch_quantize_impls_tpu/kernels/xnor_gemm.py:132"),
        "decode_binary_weights": ("xnor_gemm.cu", "pytorch_quantize_impls_tpu/kernels/xnor_gemm.py:308"),
        "int8_gemm": ("int8_matmul.cu", "pytorch_quantize_impls_tpu/kernels/int8_matmul.py:99"),
    }
    rows = []
    for name, (cu, replaces) in meta.items():
        s = summary[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"{src}/{cu}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "shape": s["shape"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
