"""Host cost per call of the packed-GEMM wrappers on the card.

    python pytorch_quantize_impls_tpu_torch/bench/host_cost.py [--calls N]

Times back-to-back calls of ``dorefa_gemm`` (K6, w4a4), ``shift_gemm`` (K8,
fsr 0, 4 bits), ``binary_gemm`` (K1, ±1 activations) and ``int8_gemm`` (K3,
on K6's weights decoded to int8) at
the serving LM's ffn_in shape (M 32, K 1024, N 4096)
by the CPU clock, the card synchronized after the clock stops: 200 calls,
which fit the launch queue, so a kernel slower on the card than its wrapper
on the host does not hold the clock, and ``calls``. Then it profiles
``calls`` calls with cProfile and prints the functions that take the most
host time. It calls only the wrappers' public functions,
so it runs against any checkout of the package on ``PYTHONPATH`` (run as a
file, it imports the package from there). Without a GPU it exits 1.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys
import time

import numpy as np
import torch

M, K, N = 32, 1024, 4096


def calls_us(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=2000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("host_cost: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from pytorch_quantize_impls_tpu_torch import ops
    from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
    from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 16, (M, K)).astype(np.int8)).to(dev)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
    wp4 = pm.pack_dorefa_weights(ops.dorefa_weight(w, 4), 4)
    wpl = sm.pack_log_weights(w * np.float32(K**-0.5), 0.0, 4)
    w8 = pm.decode_dorefa_weights(wp4, w_bits=4)
    wf = sm.decode_log_weights(wpl, fsr=0.0, bits=4).to(torch.float32)
    xf = x.to(torch.bfloat16).to(torch.float32)
    xi, wp1 = bg.binarize_to_int8(x), bg.pack_binary_weights(w)
    # and, as yardsticks, the PyTorch call that computes each one's function
    wrappers = {
        "dorefa_gemm": lambda: pm.dorefa_gemm(codes, wp4, w_bits=4, a_bits=4),
        "shift_gemm": lambda: sm.shift_gemm(x, wpl, fsr=0.0, bits=4),
        "binary_gemm": lambda: bg.binary_gemm(xi, wp1),
        "int8_gemm": lambda: im.int8_gemm(codes, w8),
        "torch._int_mm": lambda: torch._int_mm(codes, w8),
        "torch.matmul f32": lambda: torch.matmul(xf, wf),
    }
    for name, fn in wrappers.items():
        us200 = calls_us(fn, 200)
        us = calls_us(fn, args.calls)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(args.calls):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(12)
        print(f"host_cost {name} M={M} K={K} N={N}: {us200:.2f} us/call over 200 calls, "
              f"{us:.2f} over {args.calls} (CPU clock) [{torch.cuda.get_device_name(0)}]")
        print(text.getvalue())


if __name__ == "__main__":
    main()
