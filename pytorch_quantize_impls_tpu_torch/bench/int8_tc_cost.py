"""What holds int8_gemm (K3) and int8_conv2d (K5) back, measured on the card.

Both run on the streamed int8 tensor-core schedule of
``csrc/stream_tile.cuh``: cp.async loads of x (K3) or of the gathered
pixels (K5) and of the raw int8 weights, one transpose of each weight stage
to K-major, ``mma.sync`` on every stage, then the epilogue. This script
builds variants of ``csrc/int8_matmul.cu`` and ``csrc/int8_conv.cu`` with
one of those parts left out (the results are then wrong) and times them
beside the kernel at the shapes the main paths give it:

- ``kernel``: the sources as they are;
- ``no_transpose``: the weight stage is never transposed (Bs keeps stale
  bytes);
- ``no_w_load``: the weight stages are never copied;
- ``no_x_load``: the activation stages are never copied (K5: nor gathered);
- ``no_mma``: the products and their fragment loads are left out;
- ``no_store`` (K5): the staged output tile is never written to device
  memory.

The time a variant saves is what that part costs beyond what overlaps it.

    python -m pytorch_quantize_impls_tpu_torch.bench.int8_tc_cost

prints one JSON line per kernel, shape and variant, then the card; without
a GPU it raises and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from pytorch_quantize_impls_tpu_torch.bench import common
from pytorch_quantize_impls_tpu_torch.kernels import _build
from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as ic
from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as im
from pytorch_quantize_impls_tpu_torch.kernels.common import conv_plan, stream_plan
from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads

VARIANT_DIR = _build.BUILD_DIR / "int8_tc_cost"
# K3: (label, M, K, N); K5: (label, batch, size, cin, cout, stride)
GEMMS = (("fc1 M=256", 256, 4096, 1024), ("lm ffn_out M=32", 32, 4096, 1024),
         ("4096^3", 4096, 4096, 4096))
CONVS = (("resnet stage1 conv 16x16x128", 256, 16, 128, 128, 1),
         ("resnet stage0 conv 32x32x64", 256, 32, 64, 64, 1))

# each variant puts `if (false)` before the statement that starts at each
# of its anchors: (file, anchor), every anchor once in its file
_MMA = ("stream_tile.cuh", "mma::warp_stage_ldsm<")
EDITS = {
    "int8_matmul.cu": {
        "no_transpose": [("int8_matmul.cu", "qt::stream::transpose_stage<")],
        "no_w_load": [("int8_matmul.cu", "qt::stream::load_stage_bytes<")],
        "no_x_load": [("int8_matmul.cu", "qt::stream::load_rows<")],
        "no_mma": [_MMA],
    },
    "int8_conv.cu": {
        "no_transpose": [("int8_conv.cu", "qt::stream::transpose_stage<")],
        "no_w_load": [("int8_conv.cu", "qt::stream::load_stage_bytes<")],
        "no_x_load": [("int8_conv.cu", "if (xmode == 16) {")],
        "no_mma": [_MMA],
        "no_store": [("int8_conv.cu",
                      "if (codes_out) {\n    auto* o = static_cast<int8_t*>(out);")],
    },
}


def variants(source: str) -> dict:
    """{variant: {file name: text}} for ``source`` (``int8_matmul.cu`` or
    ``int8_conv.cu``): the kernel and each edit of EDITS, the headers beside
    it; raises if an anchor is not in its file exactly once."""
    files = {h.name: h.read_text() for h in _build.CSRC.glob("*.cuh")}
    files[source] = (_build.CSRC / source).read_text()
    out = {"kernel": files}
    for name, edits in EDITS[source].items():
        v = dict(files)
        for fname, anchor in edits:
            if v[fname].count(anchor) != 1:
                raise ValueError(f"{fname}: expected {anchor!r} once for {name}")
            v[fname] = v[fname].replace(anchor, "if (false) " + anchor)
        out[name] = v
    return out


def build() -> dict:
    """Compile every variant of both sources (all at once) into VARIANT_DIR;
    returns {(source, variant): loaded library}."""
    procs = {}
    for source in EDITS:
        for name, files in variants(source).items():
            d = VARIANT_DIR / source.removesuffix(".cu") / name
            d.mkdir(parents=True, exist_ok=True)
            for fname, text in files.items():
                (d / fname).write_text(text)
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / source)]
            procs[(source, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for key, (proc, d) in procs.items():
        out, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc exited {proc.returncode}\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in ("qt_int8_gemm", "qt_int8_conv2d"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [ctypes.c_char_p]
        libs[key] = lib
    return libs


def gemm_call(lib, x, w, out, index, stream):
    (m, k), n = x.shape, w.shape[1]
    bm, splits, chunk = stream_plan(m, n, k, im.STAGE_K)
    ws = _build.scratch(4 * splits * m * n, index, stream) if splits > 1 else 0
    args = im._GEMM_ARGS.pack(x.data_ptr(), w.data_ptr(), 0, 0, out.data_ptr(), ws, stream,
                              m, n, k, bm, splits, chunk, index)
    return lambda: lib.qt_int8_gemm(args)


def conv_call(lib, x, w, scale, out, index, stream, stride):
    b, h, _, c = x.shape
    n = w.shape[1]
    pads = conv_pads("SAME", (h, h), (3, 3), (stride, stride))
    ho = ic.out_size(h, 3, stride, pads[0])
    args = ic._CONV_ARGS.pack(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), 0, out.data_ptr(), stream,
        b, h, h, c, 3, 3, ho, ho, n, stride, stride, pads[0][0], pads[1][0],
        0, 0, conv_plan(b * ho * ho, n)["bn"], index, 0, 0, 0)
    return lambda: lib.qt_int8_conv2d(args)


def run(device="cuda", *, window_s: float = 0.1, repeats: int = 3, log=print) -> list:
    dev = common.require_card(device)
    rng = np.random.default_rng(0)
    libs = build()
    index, stream = _build.launch_args(torch.empty(1, device=dev))
    cases = []
    for label, m, k, n in GEMMS:
        x = common.to(rng.integers(-127, 128, (m, k)).astype(np.int8), dev)
        w = common.to(rng.integers(-127, 128, (k, n)).astype(np.int8), dev)
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        cases.append(("int8_matmul.cu", label,
                      lambda lib, x=x, w=w, out=out: gemm_call(lib, x, w, out, index, stream)))
    for label, b, h, cin, cout, s in CONVS:
        x = common.to(rng.integers(0, 16, (b, h, h, cin)).astype(np.int8), dev)
        w = common.to((2 * rng.integers(0, 16, (9 * cin, cout)) - 15).astype(np.int8), dev)
        scale = common.to(np.full(cout, 1e-3, np.float32), dev)
        out = torch.empty((b, h // s, h // s, cout), dtype=torch.float32, device=dev)
        cases.append(("int8_conv.cu", label,
                      lambda lib, x=x, w=w, sc=scale, out=out, s=s: conv_call(
                          lib, x, w, sc, out, index, stream, s)))
    rows = []
    for source, label, make in cases:
        for (src, name), lib in libs.items():
            if src != source:
                continue
            call = make(lib)

            def checked(call=call, name=name):
                code = call()
                if code:
                    raise RuntimeError(f"{source} {name}: CUDA error {code}")

            med, spread = common.time_call(checked, window_s=window_s, repeats=repeats)
            row = {"source": source, "shape": label, "variant": name, "ms": med * 1e3,
                   "spread_pct": 100 * spread}
            rows.append(row)
            log(json.dumps(row))
    log(json.dumps({"device": common.card_line()}))
    return rows


if __name__ == "__main__":
    run()
