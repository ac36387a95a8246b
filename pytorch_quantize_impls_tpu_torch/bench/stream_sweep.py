"""The launch plans of the streamed GEMMs K6 ``dorefa_gemm`` and K8
``shift_gemm`` on the card: each shape under ``kernels/common.py``'s
``stream_plan`` and under other tile heights (BM) and splits over K (S).

    python -m pytorch_quantize_impls_tpu_torch.bench.stream_sweep

Every plan's output is held to the plain version first (K6 bit for bit, K8
within 1e-5 of |bf16(x)| @ |w|); then each plan is timed in turns (the
plans, then the same in reverse order) by ``torch.profiler`` device time
per call and CUDA-event ms per back-to-back call. Prints one line per
timing and the card. Without a GPU it raises and prints no result.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.bench import common
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
from pytorch_quantize_impls_tpu_torch.kernels.common import STREAM_BN, stream_plan, stream_split

# (kernel, M, K, N, other plans as (BM, S or None for stream_plan's S at that BM))
CASES = (
    ("dorefa_gemm", 32, 1024, 4096, ((32, 1), (32, 8), (64, None))),
    ("shift_gemm", 32, 1024, 4096, ((32, 1), (32, 8), (64, None))),
    ("dorefa_gemm", 256, 8192, 10, ((64, 16), (64, 64))),
    ("shift_gemm", 256, 8192, 10, ((64, 16), (64, 64))),
    ("shift_gemm", 128, 1024, 4096, ((32, None), (128, None))),
    ("dorefa_gemm", 4096, 4096, 4096, ((64, None),)),
    ("shift_gemm", 4096, 4096, 4096, ((64, None),)),
)
SHIFT_RTOL = 1e-5  # chip_smoke.py's gate for K8


def plan_of(m: int, n: int, k: int, stage_k: int, bm: int, splits=None):
    """(BM, S, chunk) with the tile height ``bm``; S as given (rounded to
    whole stages per chunk) or as stream_plan picks it for that height."""
    stages = -(-k // stage_k)
    if splits is None:
        splits, per = stream_split(-(-m // bm) * -(-n // STREAM_BN), stages)
    else:
        per = -(-stages // splits)
    return bm, -(-stages // per), per * stage_k


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Device time per call of the kernels whose names hold ``kernel``; a
    second profile if the first saw no device time (it happens once in a
    while, as chip_smoke.py's profile_line notes)."""
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if f"{kernel}_kernel" in e.key)
        if total > 0:
            break
    return total / 1e3 / iters


def case_inputs(kernel: str, m: int, k: int, n: int, dev, rng):
    """(launch(plan) -> output, plain output, |x| @ |w| or None)."""
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    if kernel == "dorefa_gemm":
        a = torch.from_numpy(rng.integers(0, 16, (m, k)).astype(np.int8)).to(dev)
        wp = pm.pack_dorefa_weights(ops.dorefa_weight(w, 4), 4)
        scale = pm.inv_scale(4, 4)
        return (lambda plan: pm._launch_dorefa_gemm(a, wp, 4, scale, plan),
                pm.dorefa_gemm_reference(a, wp, w_bits=4, a_bits=4), None)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    wp = sm.pack_log_weights(w * np.float32(k**-0.5), 1.0, 4)
    wd = sm.decode_log_weights_reference(wp, fsr=1.0, bits=4)[:k].double()
    return (lambda plan: sm._launch_shift_gemm(x, wp, 4, sm._lo(1.0, 4), plan),
            sm.shift_gemm_reference(x, wp, fsr=1.0, bits=4),
            x.to(torch.bfloat16).double().abs() @ wd.abs())


def run(device="cuda", log=print) -> list:
    """Every case's plans, checked and timed; returns the timing rows."""
    dev = common.require_card(device)
    rng = np.random.default_rng(0)
    rows = []
    for kernel, m, k, n, others in CASES:
        stage_k = pm.STAGE_K if kernel == "dorefa_gemm" else sm.STAGE_K
        plans = [stream_plan(m, n, k, stage_k)]
        plans += [plan_of(m, n, k, stage_k, bm, s) for bm, s in others]
        launch, ref, abs_ref = case_inputs(kernel, m, k, n, dev, rng)
        for plan in plans:
            got = launch(plan)
            err = (got.double() - ref.double()).abs()
            if abs_ref is None:
                ok = torch.equal(got, ref)
            else:
                ok = bool((err <= SHIFT_RTOL * abs_ref).all())
            if not ok:
                raise RuntimeError(f"{kernel} M={m} K={k} N={n} plan {plan}: differs from the "
                                   f"plain version by {err.max().item():.3g}")
        for plan in plans + plans[::-1]:
            fn = lambda plan=plan: launch(plan)  # noqa: E731
            dms = device_ms(fn, kernel)
            ms = common.time_call(fn, window_s=0.05, repeats=3)[0] * 1e3
            chosen = "plan" if plan == plans[0] else "other"
            rows.append(dict(kernel=kernel, m=m, k=k, n=n, bm=plan[0], splits=plan[1],
                             device_ms=dms, ms=ms, chosen=chosen))
            log(f"# sweep {kernel} M={m} K={k} N={n} BM={plan[0]} S={plan[1]} ({chosen}): "
                f"device {dms:.4f} ms, event {ms:.4f} ms")
    log(f"# card: {common.card_line()}")
    return rows


if __name__ == "__main__":
    run()
