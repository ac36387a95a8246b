"""The packed conv's two routes, and what they cost a forward, on the card.

The packed conv (``kernels/conv.py`` direct mode) runs either one launch of
K5 with the packed weight stage (``fused``: ``int8_conv2d(...,
w_bits=)``, the decode inside K5's weight stage) or K7 / K2 then the raw
K5 on the decoded codes (``decode``); ``kernels.common.conv_route`` picks
one from the shape. This script

1. times both routes at each ResNet-20 block conv (W4A4, width 64, 4-bit
   DoReFa words) and at BNN LeNet's conv2 (width 128, binary words), for b
   in {1, 8, 64, 256}. Each route is first held to the plain version
   (decode + ``int8_conv2d_reference``) bit for bit; then its time per
   call by CUDA events (median of ``repeats`` windows of back-to-back
   calls, the wrapper's host cost included), and last its device time per
   call, every kernel it launches (torch.profiler; a profiler session slows
   later launches on the host, so every CUDA-event time is taken first).
   The route ``conv_route`` picks is marked;
2. runs the packed forwards through ``infer.packed_apply``: the DoReFa
   ResNet-20 W4A4 at width 64, unprepared and prepared, and ``bnn_lenet``
   at width 128, unprepared and prepared, at b = 1 and 256, from seeded
   weights, under torch.profiler: wall and device-busy ms per forward, the
   idle share, launches per forward and the decoders' and K5's launches;
3. (``--variants``) builds variants of ``csrc/int8_conv.cu``'s packed
   stage and times their device ms at the ResNet's convs and LeNet's conv2
   at b = 1 and 256: ``no_decode`` (the stage's decode left out; its
   results wrong), what the decode costs, and ``words_from_l2``, the
   design the slab was chosen over: no slab in shared memory, each
   stage's words read from device memory (L2) through the same table
   (bit-equal; without a register prefetch of the next stage's words).

    python -m pytorch_quantize_impls_tpu_torch.bench.conv_decode_cost [--variants]

prints one JSON line per row, two tables, and the card last; without a GPU
it raises and prints no result. Run as a file with ``PYTHONPATH=<checkout>``
it times that checkout; one from before the fused route (no ``w_bits`` in
``int8_conv2d``) runs part 2 only, so two checkouts compare in one call.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pytorch_quantize_impls_tpu_torch.bench import common
from pytorch_quantize_impls_tpu_torch.kernels import _build
from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads
from pytorch_quantize_impls_tpu_torch.ops import pack as packlib

FUSED = "w_bits" in inspect.signature(ic.int8_conv2d).parameters
BATCHES = (1, 8, 64, 256)
FORWARD_BATCHES = (1, 256)
RESNET_WIDTH, LENET_WIDTH = 64, 128
# the decoders' and K5's CUDA functions, as torch.profiler names them
SYMBOLS = {"K2": "decode_binary_kernel", "K7": "decode_dorefa_kernel",
           "K5": "int8_conv_kernel"}


def convs() -> list:
    """(label, size, cin, cout, kernel, stride, padding, bits): the
    ResNet-20's block convs at width 64, one of each shape, and LeNet's
    conv2."""
    w = RESNET_WIDTH
    out = [(f"resnet stage0 conv 32x32x{w}", 32, w, w, 1),
           (f"resnet stage1 conv1 s2 32x32x{w}", 32, w, 2 * w, 2),
           (f"resnet stage1 conv 16x16x{2 * w}", 16, 2 * w, 2 * w, 1),
           (f"resnet stage2 conv1 s2 16x16x{2 * w}", 16, 2 * w, 4 * w, 2),
           (f"resnet stage2 conv 8x8x{4 * w}", 8, 4 * w, 4 * w, 1)]
    out = [(label, h, cin, cout, 3, s, "SAME", 4) for label, h, cin, cout, s in out]
    return out + [(f"bnn_lenet conv2 12x12x{LENET_WIDTH}", 12, LENET_WIDTH, 2 * LENET_WIDTH, 5, 1,
                   "VALID", 1)]


def profile(fn, iters: int = 10):
    """(wall ms, {kernel name: (device ms, launches)}) per call of ``fn``
    under torch.profiler; the wall clock ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile as prof_

    fn()
    torch.cuda.synchronize()
    with prof_(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / iters
    per = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us > 0:
            ms, n = per.get(e.key, (0.0, 0.0))
            per[e.key] = (ms + us / 1e3 / iters, n + e.count / iters)
    return wall, per


def route_rows(dev, rng, *, window_s: float, repeats: int, log) -> list:
    """Part 1: both routes at every conv and batch."""
    from pytorch_quantize_impls_tpu_torch.kernels.common import conv_route

    rows, calls = [], []
    for label, h, cin, cout, k, s, padding, bits in convs():
        kk = cin * k * k
        codes = torch.from_numpy(rng.integers(0, 2**bits, size=(kk, cout))).to(torch.int32)
        wp = packlib.pack_bitplanes(codes, bits).to(dev)
        decode = ((lambda wp=wp: bg.decode_binary_weights(wp)) if bits == 1
                  else (lambda wp=wp: pm.decode_dorefa_weights(wp, w_bits=bits)))
        scale = torch.full((cout,), 1e-3, dtype=torch.float32, device=dev)
        for b in BATCHES:
            if bits == 1:
                x = np.where(rng.normal(size=(b, h, h, cin)) >= 0, 1, -1).astype(np.int8)
            else:
                x = rng.integers(0, 16, size=(b, h, h, cin)).astype(np.int8)
            x = common.to(x, dev)
            pads = conv_pads(padding, (h, h), (k, k), (s, s))
            args = (x, wp, (k, k), (s, s), pads, "scale", scale)
            ref = ic.int8_conv2d_reference(*args, w_bits=bits)
            m = ref.shape[0] * ref.shape[1] * ref.shape[2]
            picked = conv_route(b, m, cout, cin, k * k, bits)
            for route, fn in (
                ("fused", lambda a=args, bits=bits: ic.int8_conv2d(*a, w_bits=bits)),
                ("decode", lambda a=args, d=decode, kk=kk: ic.int8_conv2d(a[0], d()[:kk], *a[2:])),
            ):
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise RuntimeError(f"{label} b={b} {route}: differs from the plain version")
                med, spread = common.time_call(fn, window_s=window_s, repeats=repeats)
                rows.append(dict(conv=label, b=b, route=route, picked=route == picked,
                                 ms=med * 1e3, spread_pct=100 * spread))
                calls.append(fn)
    for row, fn in zip(rows, calls):  # device times last
        _, per = profile(fn, iters=20)
        row["device_ms"] = sum(ms for ms, _ in per.values()) if per else None
        row["launches"] = sum(n for _, n in per.values())
        log(json.dumps(row))
    log("conv                                 b    fused ms  device   decode ms  device   picked")
    for f, d in zip(rows[::2], rows[1::2]):
        log(f"{f['conv']:36s} {f['b']:4d}  {f['ms']:.4f}  {f['device_ms'] or 0:.4f}    "
            f"{d['ms']:.4f}  {d['device_ms'] or 0:.4f}   {'fused' if f['picked'] else 'decode'}")
    return rows


def models(dev):
    """The two packed models, from seeded weights: {name: (model, packed
    artifact, prepared artifact, input shape)}."""
    from pytorch_quantize_impls_tpu_torch import infer
    from pytorch_quantize_impls_tpu_torch.models import DorefaResNet20
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig, build_model

    torch.manual_seed(0)
    resnet = DorefaResNet20(w_bits=4, a_bits=4, width=RESNET_WIDTH).to(dev).eval()
    lenet, shape, _ = build_model(RunConfig(**SCHEME_CONFIGS["bnn_lenet"]), device=dev)
    lenet.eval()
    out = {}
    for name, model, x_shape in (("resnet20_w4a4_w64", resnet, (32, 32, 3)),
                                 ("bnn_lenet_w128", lenet, tuple(shape))):
        packed = infer.pack_model(model)
        out[name] = (model, packed, infer.prepare(packed), x_shape)
    return out


def forward_rows(dev, rng, *, log) -> list:
    """Part 2: the packed forwards under torch.profiler."""
    from pytorch_quantize_impls_tpu_torch import infer

    rows = []
    for name, (model, packed, prepared, x_shape) in models(dev).items():
        for b in FORWARD_BATCHES:
            x = common.to(rng.normal(size=(b, *x_shape)).astype(np.float32), dev)
            for artifact, recs in (("unprepared", packed), ("prepared", prepared)):
                with torch.inference_mode():
                    wall, per = profile(lambda: infer.packed_apply(model, recs, x))
                busy = sum(ms for ms, _ in per.values())
                row = dict(model=name, artifact=artifact, b=b, wall_ms=wall, busy_ms=busy,
                           idle_pct=100 * (1 - busy / wall),
                           launches=sum(n for _, n in per.values()))
                for short, sym in SYMBOLS.items():
                    row[f"{short}_launches"] = sum(n for k, (_, n) in per.items() if sym in k)
                    row[f"{short}_ms"] = sum(ms for k, (ms, _) in per.items() if sym in k)
                rows.append(row)
                log(json.dumps(row))
    log("model              artifact    b    wall ms  busy ms  idle %  launches  K2   K7   K5")
    for r in rows:
        log(f"{r['model']:18s} {r['artifact']:10s} {r['b']:4d}  {r['wall_ms']:8.3f} "
            f"{r['busy_ms']:8.3f}  {r['idle_pct']:5.1f}  {r['launches']:8.1f}  "
            f"{r['K2_launches']:3.0f}  {r['K7_launches']:3.0f}  {r['K5_launches']:3.0f}")
    return rows


# the variants of part 3: (anchor, replacement) edits of csrc/int8_conv.cu,
# every anchor once in the file
VARIANTS = {
    "no_decode": [("      decode_slab_stage<BITS>(Bs, slabs",
                   "      if (false) decode_slab_stage<BITS>(Bs, slabs")],
    "words_from_l2": [
        ("      load_slab<BITS>(slabs + (g & 1)",
         "      if (false) load_slab<BITS>(slabs + (g & 1)"),
        ("const uint32_t* tab) {", "const uint32_t* tab, int Ng) {"),
        ("__funnelshift_r(*reinterpret_cast<const uint32_t*>(col + (t[i] & ~31u)), 0u, t[i]);",
         "__funnelshift_r(__ldg(D + (t[i] >> 8) * Ng + n), 0u, t[i]);"),
        ("decode_slab_stage<BITS>(Bs, slabs + (g & 1) * slab_words(groups),",
         "decode_slab_stage<BITS>(Bs, static_cast<const uint32_t*>(w) + (size_t)((long)g * cbs * "
         "STAGE_BYTES * taps / (32 / BITS * 32) * 32) * s.N + n0,"),
        ("within / taps * STAGE_BYTES);", "within / taps * STAGE_BYTES, s.N);"),
    ],
}
VARIANT_DIR = _build.BUILD_DIR / "conv_decode_cost"


def variants(text: str) -> dict:
    """{name: csrc/int8_conv.cu's source ``text`` with the variant's edits};
    raises if an anchor is not in it exactly once."""
    out = {}
    for name, edits in VARIANTS.items():
        src = text
        for anchor, repl in edits:
            if src.count(anchor) != 1:
                raise ValueError(f"int8_conv.cu: expected {anchor!r} once for {name}")
            src = src.replace(anchor, repl)
        out[name] = src
    return out


def build_variants() -> dict:
    """Compile every variant (all at once); {name: loaded library}."""
    files = {h.name: h.read_text() for h in _build.CSRC.glob("*.cuh")}
    procs = {}
    for name, src in variants((_build.CSRC / "int8_conv.cu").read_text()).items():
        d = VARIANT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, body in {**files, "int8_conv.cu": src}.items():
            (d / fname).write_text(body)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "int8_conv.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.qt_int8_conv2d.argtypes = [ctypes.c_char_p]
        libs[name] = lib
    return libs


def variant_rows(dev, rng, *, log) -> list:
    """Part 3: the kernel and each variant, device ms per call; the
    words_from_l2 variant held to the plain version bit for bit."""
    from pytorch_quantize_impls_tpu_torch.kernels.common import conv_slab_plan

    libs = {"kernel": ic._lib(), **build_variants()}
    index, stream = _build.launch_args(torch.empty(1, device=dev))
    rows = []
    for label, h, cin, cout, k, s, padding, bits in convs():
        kk = cin * k * k
        codes = torch.from_numpy(rng.integers(0, 2**bits, size=(kk, cout))).to(torch.int32)
        wp = packlib.pack_bitplanes(codes, bits).to(dev)
        scale = torch.full((cout,), 1e-3, dtype=torch.float32, device=dev)
        plan = conv_slab_plan(cin, k * k, bits)
        for b in FORWARD_BATCHES:
            x = common.to(rng.integers(0, 2, size=(b, h, h, cin)).astype(np.int8), dev)
            pads = conv_pads(padding, (h, h), (k, k), (s, s))
            ref = ic.int8_conv2d_reference(x, wp, (k, k), (s, s), pads, "scale", scale,
                                           w_bits=bits)
            out = torch.empty(ref.shape, dtype=ref.dtype, device=dev)  # NHWC, contiguous
            args = ic._CONV_ARGS.pack(
                x.data_ptr(), wp.data_ptr(), scale.data_ptr(), 0, out.data_ptr(), stream,
                b, h, h, cin, k, k, ref.shape[1], ref.shape[2], cout, s, s, pads[0][0],
                pads[1][0], 0, 0, plan["bn"], index, bits, plan["groups"], wp.shape[0])
            row = dict(conv=label, b=b)
            # the kernel before and after the variants, each over 100 calls
            for key, name in (("kernel", "kernel"), *((v, v) for v in VARIANTS),
                              ("kernel_after", "kernel")):
                call = (lambda lib=libs[name]: lib.qt_int8_conv2d(args))
                out.zero_()
                if call():
                    raise RuntimeError(f"{label} b={b} {name}: the launch failed")
                torch.cuda.synchronize()
                if name in ("kernel", "words_from_l2") and not torch.equal(out, ref):
                    raise RuntimeError(f"{label} b={b} {name}: differs from the plain version")
                _, per = profile(call, iters=100)
                row[key] = sum(ms for ms, _ in per.values()) if per else None
            rows.append(row)
            log(json.dumps(row))
    log("conv                                 b    kernel  no_decode  words_from_l2  kernel "
        "(device ms)")
    for r in rows:
        log(f"{r['conv']:36s} {r['b']:4d}  {r['kernel']:.4f}  {r['no_decode']:.4f}     "
            f"{r['words_from_l2']:.4f}         {r['kernel_after']:.4f}")
    return rows


def run(device="cuda", *, variants: bool = False, window_s: float = 0.05, repeats: int = 5,
        log=print) -> dict:
    dev = common.require_card(device)
    rng = np.random.default_rng(0)
    out = {"fused_route": FUSED, "checkout": sys.modules[ic.__name__].__file__}
    log(json.dumps(out))
    if FUSED:
        out["routes"] = route_rows(dev, rng, window_s=window_s, repeats=repeats, log=log)
    out["forwards"] = forward_rows(dev, rng, log=log)
    if variants and FUSED:
        out["variants"] = variant_rows(dev, rng, log=log)
    log(json.dumps({"device": common.card_line()}))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also build and time the packed stage's variants (part 3)")
    run(variants=parser.parse_args().variants)
