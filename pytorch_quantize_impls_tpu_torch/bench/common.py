"""Shared pieces of the benchmarks: the shape, the card's peak rates, the
card check, CUDA-event timing and the seeded inputs."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

# M = N = K of the GEMM measurements: bench.py:75, scripts/kernel_bench.py:67,
# scripts/mxu_probe.py:74
SHAPE = 4096

# NVIDIA H100 SXM published peaks (dense), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


def require_card(device) -> torch.device:
    """``device`` as a CUDA device; raise for anything else, and raise if
    TF32 matmul is on (the float32 baseline must be float32)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"this benchmark times the card; got device {dev}, "
                           f"CUDA available: {torch.cuda.is_available()}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on; the float32 baseline must run in float32")
    return dev


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _event_seconds(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def time_call(fn, *, window_s: float = 0.5, repeats: int = 7, max_iters: int = 4000):
    """(median seconds per call, spread = (max - min) / median) over
    ``repeats`` runs of back-to-back calls, each run sized to fill about
    ``window_s`` seconds, timed by CUDA events (the methodology of
    ``bench.py:_bench``, with device events in place of its relay
    differential)."""
    fn()
    torch.cuda.synchronize()
    est = _event_seconds(fn, 3)
    n = min(max(1, int(window_s / max(est, 1e-9))), max_iters)
    runs = sorted(_event_seconds(fn, n) for _ in range(repeats))
    med = runs[len(runs) // 2]
    return med, (runs[-1] - runs[0]) / med


def seeded_inputs(m: int, n: int, k: int, seed: int = 0):
    """(numpy generator, x (M, K), w (K, N)): float32 normals, as
    ``bench.py:164-166`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    return rng, x, w


def to(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
