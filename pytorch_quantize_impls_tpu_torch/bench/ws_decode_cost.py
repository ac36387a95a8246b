"""What holds the wgmma GEMMs with a weight-writing warpgroup back: their
decoder or transposer, measured on the card.

In shift_gemm_ws (K12, ``csrc/shift_gemm.cu``), binary_gemm_ws (K10) and
dorefa_gemm_ws (K11, both on ``csrc/packed_ws.cuh``) a decoder warpgroup
turns the packed codes into the weight tile of each stage (K12: log codes
into bf16; K10: bits into ±1 int8; K11: 4-bit codes into centered int8),
and in the probe's int8 and int4 tiled_mm (P1, ``csrc/mxu_probe.cu``) a
transposer warpgroup turns w's staged rows K-major (int4: and expands x's
and w's nibbles into bytes), while the consumer warpgroups run wgmma on the
stage before. This script builds two variants of each source beside the
real kernel and times all three at 4096^3 for every m_tiles (P1: every
tiling):

- ``kernel``: the source as it is;
- ``no_decode``: the decode or transpose left out (the weight tile is
  never written, so the results are wrong): the time of everything else,
  the TMA loads, the words' loads, the barriers, the products;
- ``instrumented``: the kernel with clock64() counters in the decoder of one
  block: per stage, the cycles it waits for its slot (P1: for its staged
  rows and its slot) and the cycles it spends decoding, and the block's
  cycles per stage in all.

    python -m pytorch_quantize_impls_tpu_torch.bench.ws_decode_cost [--kernel dorefa_gemm_ws]

prints one JSON line per kernel, variant and m_tiles or tiling, then the
card; without a GPU it raises and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.bench import common
from pytorch_quantize_impls_tpu_torch.bench import mxu_probe as mp
from pytorch_quantize_impls_tpu_torch.kernels import _build
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
from pytorch_quantize_impls_tpu_torch.kernels.common import WS_M_TILES

VARIANT_DIR = _build.BUILD_DIR / "ws_decode_cost"
FSR, BITS = 1.0, 4

_DECODE_END = "      fence_async_shared();\n      bar_arrive(&full[slot]);\n    };\n"
_DECODER = "    const int t = threadIdx.x % WG_THREADS;\n"
_WS = dict(start="      uint8_t* B = Bs + slot * T::B_BYTES;\n",
           wait="      if (s >= T::STAGES) bar_wait(&empty[slot], (s / T::STAGES - 1) & 1);\n")
_PACKED = dict(_WS, source="packed_ws.cuh",
               loop_end="      if (T::SPG * (g + 1) < stages) group(w1, w0, g + 1);\n    }\n")
_PROBE = dict(source="mxu_probe.cu", start="      const uint8_t* W = Stg + g * T::STG_BYTES;\n",
              wait="      bar_wait(&landed[g], (s / T::STG) & 1);\n"
                   "      if (s >= T::STAGES) bar_wait(&empty[slot], (s / T::STAGES - 1) & 1);\n",
              loop_end="      if (t == 0 && s + T::STG < stages) fetch(s + T::STG);\n    }\n")
# each kernel's library source, the file that holds its decoder (or
# transposer) and the lines of it that the variants edit: the decode's first
# line (start), the waits before it, the last line of the loop over stages
KERNELS = {
    "shift_gemm_ws": dict(_WS, library="shift_gemm", source="shift_gemm.cu",
                          loop_end="      if (2 * (g + 1) < stages) group(w1, w0, g + 1);\n    }\n"),
    "binary_gemm_ws": dict(_PACKED, library="xnor_gemm"),
    "dorefa_gemm_ws": dict(_PACKED, library="dorefa_gemm"),
    "tiled_mm_int8": dict(_PROBE, library="mxu_probe"),
    "tiled_mm_int4": dict(_PROBE, library="mxu_probe"),
}
# the counters: wait cycles, decode cycles, stages, block cycles
_COUNTERS = "__device__ unsigned long long qt_decode_cycles[4];\n"
_READ = ('\nextern "C" int qt_read_cycles(void* host) {\n'
         "  return (int)cudaMemcpyFromSymbol(host, qt_decode_cycles, sizeof(qt_decode_cycles));\n}\n"
         'extern "C" int qt_zero_cycles() {\n  unsigned long long z[4] = {};\n'
         "  return (int)cudaMemcpyToSymbol(qt_decode_cycles, z, sizeof(z));\n}\n")


def variants(src: str, kernel: str = "shift_gemm_ws") -> dict:
    """{name: text} of the three variants of ``kernel``'s decoder file,
    whose text is ``src`` (KERNELS); raises if the decoder no longer has the
    lines they edit."""
    k = KERNELS[kernel]
    for mark in (k["start"], _DECODE_END, k["wait"], _DECODER, k["loop_end"]):
        if src.count(mark) != 1:
            raise ValueError(f"{k['source']}: expected the line {mark!r} once")
    a, b = src.index(k["start"]), src.index(_DECODE_END)
    no_decode = src[:a] + src[b:]
    probe = "blockIdx.x == 5 && blockIdx.y == 3 && t == 0"
    first = re.search(r"^namespace ", src, re.M).start()
    inst = src[:first] + _COUNTERS + src[first:]
    inst = inst.replace(_DECODER, _DECODER + f"    const bool probe = {probe};\n"
                        "    const long long start = clock64();\n")
    inst = inst.replace(k["wait"], "      const long long c0 = clock64();\n" + k["wait"]
                        + "      const long long c1 = clock64();\n")
    inst = inst.replace(_DECODE_END, _DECODE_END.replace(
        "    };\n", "      if (probe) {\n        qt_decode_cycles[0] += c1 - c0;\n"
        "        qt_decode_cycles[1] += clock64() - c1;\n        qt_decode_cycles[2] += 1;\n"
        "      }\n    };\n"))
    inst = inst.replace(k["loop_end"],
                        k["loop_end"] + "    if (probe) qt_decode_cycles[3] += clock64() - start;\n")
    return {"kernel": src, "no_decode": no_decode, "instrumented": inst + _READ}


def build(kernel: str = "shift_gemm_ws") -> dict:
    """Compile ``kernel``'s variants (all at once) into VARIANT_DIR; returns
    {name: loaded library}."""
    k = KERNELS[kernel]
    cu = f"{k['library']}.cu"
    src = (_build.CSRC / k["source"]).read_text()
    procs = {}
    for name, text in variants(src, kernel).items():
        d = VARIANT_DIR / kernel / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / cu).write_text((_build.CSRC / cu).read_text())
        (d / k["source"]).write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {"shift_gemm": ("qt_shift_gemm_ws", [p, p, p, i, i, i, i, i, i, i, i, i, p]),
                "xnor_gemm": ("qt_binary_gemm_ws", [p] * 5 + [i] * 7 + [p]),
                "dorefa_gemm": ("qt_dorefa_gemm_ws", [p, p, p] + [i] * 6 + [ctypes.c_float, i, i, p]),
                "mxu_probe": ("qt_tiled_mm", [p, p, p, i, i, i, i, i, i, i, p])}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{kernel} {name}: nvcc exited {proc.returncode}\n{out}")
        lib = ctypes.CDLL(str(VARIANT_DIR / kernel / name / "lib.so"))
        fn, types = argtypes[k["library"]]
        getattr(lib, fn).argtypes = types
        libs[name] = lib
    return libs


def configs(kernel: str) -> tuple:
    """What the rows of ``kernel`` run over: m_tiles, or P1's tilings."""
    return mp.TILES if kernel.startswith("tiled_mm") else WS_M_TILES


def _caller(kernel: str, dev):
    """(call(lib, config) -> CUDA error code) of ``kernel``'s entry point on
    seeded 4096^3 inputs (K12: fsr 1, 4 bits; K11: w4a4; P1: the probe's
    operands)."""
    n = common.SHAPE
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    index, stream = _build.launch_args(out)
    if kernel.startswith("tiled_mm"):
        dt = kernel.rsplit("_", 1)[1]
        x, w = mp.operands(n, n, n, dev)[dt]
        return lambda lib, tiles: lib.qt_tiled_mm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), n, n, n, mp.DTYPES.index(dt), *tiles,
            index, stream)
    _, xn, wn = common.seeded_inputs(n, n, n)
    x, w = common.to(xn, dev), common.to(wn, dev)
    if kernel == "shift_gemm_ws":
        xb, wp = x.to(torch.bfloat16), sm.pack_log_weights(w, FSR, BITS)
        return lambda lib, r: lib.qt_shift_gemm_ws(
            xb.data_ptr(), wp.data_ptr(), out.data_ptr(), n, n, n, n, wp.shape[0], BITS,
            int(FSR) - 2**BITS, r, index, stream)
    if kernel == "dorefa_gemm_ws":
        a = torch.randint(0, 2**BITS, (n, n), generator=torch.Generator().manual_seed(0),
                          dtype=torch.int8).to(dev)
        wp = pm.pack_dorefa_weights(ops.dorefa_weight(w, BITS), BITS)
        return lambda lib, r: lib.qt_dorefa_gemm_ws(
            a.data_ptr(), wp.data_ptr(), out.data_ptr(), n, n, n, n, wp.shape[0], BITS,
            pm.inv_scale(BITS, BITS), r, index, stream)
    xi, wp = bg.binarize_to_int8(x), bg.pack_binary_weights(w)
    alpha = w.abs().mean(0)
    return lambda lib, r: lib.qt_binary_gemm_ws(
        xi.data_ptr(), wp.data_ptr(), alpha.data_ptr(), None, out.data_ptr(), n, n, n, n,
        wp.shape[0], r, index, stream)


def run(device="cuda", *, kernels=tuple(KERNELS), window_s: float = 0.25, repeats: int = 5,
        log=print) -> list:
    dev = common.require_card(device)
    rows = []
    for kernel in kernels:
        launch = _caller(kernel, dev)
        key = "tiles" if kernel.startswith("tiled_mm") else "m_tiles"
        for name, lib in build(kernel).items():
            for cfg in configs(kernel):
                def call(lib=lib, cfg=cfg, name=name):
                    code = launch(lib, cfg)
                    if code:
                        raise RuntimeError(f"{kernel} {name} {key} {cfg}: CUDA error {code}")
                row = {"kernel": kernel, "variant": name,
                       key: f"{cfg[0]}x{cfg[1]}" if key == "tiles" else cfg}
                if name == "instrumented":
                    lib.qt_zero_cycles()
                    call()
                    torch.cuda.synchronize()
                    c = (ctypes.c_ulonglong * 4)()
                    lib.qt_read_cycles(c)
                    stages = max(c[2], 1)
                    row.update(wait_cycles_per_stage=c[0] / stages,
                               decode_cycles_per_stage=c[1] / stages,
                               block_cycles_per_stage=c[3] / stages)
                else:
                    med, spread = common.time_call(call, window_s=window_s, repeats=repeats)
                    row.update(ms=med * 1e3, spread_pct=100 * spread)
                rows.append(row)
                log(json.dumps(row))
    log(json.dumps({"shape": common.SHAPE, "device": common.card_line()}))
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=tuple(KERNELS), action="append",
                   help="the kernels to measure (default: all)")
    a = p.parse_args(argv)
    run(kernels=tuple(a.kernel or KERNELS))


if __name__ == "__main__":
    main()
