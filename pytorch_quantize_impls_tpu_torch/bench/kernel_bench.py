"""Kernel microbenchmark and tile sweep on the card.

Counterpart of ``scripts/kernel_bench.py:65-159``. Times one of the port's
packed GEMM kernels at ``--shape`` against the float32 (TF32 off) and bf16
``torch.matmul`` yardsticks. Where the JAX script sweeps Pallas tiles
``(tm, tn, tk)``, this one sweeps ``m_tiles`` (``kernels.common.WS_M_TILES``)
for the weight-stationary kernels; the other kernels have one configuration
each, which it times and names. ``dorefa_ws`` and ``shift_ws`` time
``dorefa_gemm_ws`` and ``shift_gemm_ws``, which the JAX script never timed.
``int8_conv`` times the int8 conv K5 at the DoReFa ResNet-20's block convs
(width 64) and BNN LeNet's conv2, ``--batch`` images each, against cuDNN's
float32 conv of the same codes (TF32 off); ``--shape`` does not apply.

    python -m pytorch_quantize_impls_tpu_torch.bench.kernel_bench --kernel binary_ws

prints one JSON line per configuration, then a ``best`` line; without a GPU
it raises and prints no result. It calls only the wrappers' public
functions, so run as a file it times any checkout of the package on
``PYTHONPATH`` (an older one, to compare).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.bench import common
from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
from pytorch_quantize_impls_tpu_torch.kernels.common import WS_M_TILES

# the GEMMs, timed at --shape; int8_conv times the conv K5 at CONVS
KERNELS = ("binary", "binary_ws", "binary_decoded", "dorefa", "dorefa_ws", "shift", "shift_ws")
STREAMED = "one configuration: the streamed tensor-core schedule, plan common.stream_plan"
# int8_conv's convs: (label, input size, cin, cout, kernel, stride, padding),
# the ResNet-20's at width 64 (DoReFa codes, scale epilogue) and BNN
# LeNet's conv2 (±1)
CONVS = (
    ("resnet stage0 conv 32x32x64", 32, 64, 64, 3, 1, "SAME"),
    ("resnet stage1 conv1 s2 32x32x64", 32, 64, 128, 3, 2, "SAME"),
    ("resnet stage1 conv 16x16x128", 16, 128, 128, 3, 1, "SAME"),
    ("resnet stage2 conv1 s2 16x16x128", 16, 128, 256, 3, 2, "SAME"),
    ("resnet stage2 conv 8x8x256", 8, 256, 256, 3, 1, "SAME"),
    ("bnn_lenet conv2 12x12x128", 12, 128, 256, 5, 1, "VALID"),
)


def conv_configs(batch: int, device):
    """int8_conv's configurations on seeded codes: a list of (config dict,
    timed call, plain version, cuDNN float32 conv of the same values)."""
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads

    rng = np.random.default_rng(0)
    out = []
    for label, h, cin, cout, k, s, padding in CONVS:
        kk = cin * k * k
        if label.startswith("bnn"):
            x = np.where(rng.normal(size=(batch, h, h, cin)) >= 0, 1, -1).astype(np.int8)
            w = np.where(rng.normal(size=(kk, cout)) >= 0, 1, -1).astype(np.int8)
            scale = None
        else:
            x = rng.integers(0, 16, size=(batch, h, h, cin)).astype(np.int8)
            w = (2 * rng.integers(0, 16, size=(kk, cout)) - 15).astype(np.int8)
            scale = common.to(rng.uniform(0.5, 1.5, cout).astype(np.float32) / 1e3, device)
        xc, wc = common.to(x, device), common.to(w, device)
        pads = conv_pads(padding, (h, h), (k, k), (s, s))
        args = (xc, wc, (k, k), (s, s), pads, "scale", scale)
        (pt, pb), (pl, pr) = pads
        xf = F.pad(xc.permute(0, 3, 1, 2).to(torch.float32), (pl, pr, pt, pb))
        wf = wc.T.reshape(cout, cin, k, k).to(torch.float32).contiguous()

        def cudnn(xf=xf, wf=wf, s=s):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return F.conv2d(xf, wf, stride=(s, s))

        ho = ic.out_size(h, k, s, pads[0])
        config = {"conv": label, "batch": batch, "gemm_mkn": [batch * ho * ho, kk, cout]}
        out.append((config, lambda a=args: ic.int8_conv2d(*a),
                    lambda a=args: ic.int8_conv2d_reference(*a), cudnn))
    return out


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
            return [({"config": STREAMED}, lambda: bg.binary_gemm(xi, wp, alpha), plain)]
        if kernel == "binary_decoded":
            w8 = bg.decode_binary_weights(wp)[:k].contiguous()
            return [({"config": f"int8_gemm: {STREAMED}"},
                     lambda: im.int8_gemm(xi, w8, alpha), plain)]
        return [({"m_tiles": r}, lambda r=r: bg.binary_gemm_ws(xi, wp, alpha, m_tiles=r), plain)
                for r in WS_M_TILES]
    if kernel.startswith("dorefa"):
        codes = pm.dorefa_act_to_int8(ops.dorefa_activation(x.abs(), bits), bits)
        wp = pm.pack_dorefa_weights(ops.dorefa_weight(w, bits), bits)
        kw = dict(w_bits=bits, a_bits=bits)
        plain = lambda: pm.dorefa_gemm_reference(codes, wp, **kw)  # noqa: E731
        if kernel == "dorefa":
            return [({"config": STREAMED}, lambda: pm.dorefa_gemm(codes, wp, **kw), plain)]
        return [({"m_tiles": r}, lambda r=r: pm.dorefa_gemm_ws(codes, wp, m_tiles=r, **kw), plain)
                for r in WS_M_TILES]
    wp = sm.pack_log_weights(w, 1.0, 4)
    plain = lambda: sm.shift_gemm_reference(x, wp, fsr=1.0, bits=4)  # noqa: E731
    if kernel == "shift":
        return [({"config": STREAMED}, lambda: sm.shift_gemm(x, wp, fsr=1.0, bits=4), plain)]
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


def run_conv(batch: int, device, *, window_s: float, repeats: int, log=print) -> dict:
    """Times int8_conv2d and cuDNN's float32 conv (TF32 off) at every conv
    of CONVS; logs one JSON line each and a ``best`` line (the highest
    rate), and returns it."""
    results = []
    for config, fn, _, cudnn in conv_configs(batch, device):
        t, spread = common.time_call(fn, window_s=window_s, repeats=repeats)
        t_ref, _ = common.time_call(cudnn, window_s=window_s, repeats=repeats)
        m, k, n = config["gemm_mkn"]
        r = {"kernel": "int8_conv", **config, "ms": t * 1e3, "tops": 2 * m * k * n / t / 1e12,
             "cudnn_fp32_ms": t_ref * 1e3, "vs_cudnn_fp32": t_ref / t,
             "spread_pct": 100 * spread}
        results.append(r)
        log(json.dumps(r))
    best = {"best": max(results, key=lambda r: r["tops"]), "kernel": "int8_conv",
            "device": common.card_line()}
    log(json.dumps(best))
    return best


def run(kernel: str, shape=(common.SHAPE,) * 3, bits: int = 4, device="cuda", *,
        window_s: float = 0.25, repeats: int = 5, log=print, batch: int = 256) -> dict:
    """Times every configuration of ``kernel`` and the yardsticks; logs one
    JSON line per configuration and a ``best`` line, and returns the best."""
    dev = common.require_card(device)
    if kernel == "int8_conv":
        return run_conv(batch, dev, window_s=window_s, repeats=repeats, log=log)
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
    p.add_argument("--kernel", default="binary", choices=(*KERNELS, "int8_conv"))
    p.add_argument("--bits", type=int, default=4, help="dorefa code width")
    p.add_argument("--batch", type=int, default=256, help="int8_conv's images")
    a = p.parse_args(argv)
    run(a.kernel, tuple(a.shape), a.bits, batch=a.batch)


if __name__ == "__main__":
    main()
