"""Tensor-core throughput by operand dtype through a minimal tiled matmul.

Counterpart of ``scripts/mxu_probe.py``, which asks at which operand dtype
the TPU's matrix unit peaks. Here the question is which of the H100's
tensor-core dtypes peaks, and how near a hand-written ``wgmma`` tile comes
to the library's rate. ``tiled_mm`` (P1) launches the CUDA kernel in
``csrc/mxu_probe.cu`` (bf16, int8, int4) for CUDA tensors and takes its plain
PyTorch version ``tiled_mm_reference`` for CPU tensors;
``tiled_mm.launches`` counts the kernel launches.

    python -m pytorch_quantize_impls_tpu_torch.bench.mxu_probe

runs 4096^3 for each dtype over the tilings and prints ms, T/s and the share
of the data-sheet peak, beside ``torch.mm(..., out_dtype=torch.float32)``
and ``torch.matmul`` (bf16) and ``torch._int_mm`` (int8) as yardsticks,
then the dtypes ranked by their best rate; without a GPU it raises and
prints no result. Every dtype runs on the Hopper wgmma tile
(``csrc/wgmma_tile.cuh``): bf16 on its bf16 path, int8 and int4 on its s8
path, with a transposer warpgroup that writes w K-major (int4: each nibble
sign-extended to a byte).
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from pytorch_quantize_impls_tpu_torch.bench import common
from pytorch_quantize_impls_tpu_torch.kernels import _build
from pytorch_quantize_impls_tpu_torch.kernels.common import int8_rows

# (BM, BN) block tilings with a kernel instantiation, and the multiple of K
# each dtype takes (the kernels walk K in stages of 64 bf16 or 128 int8 and
# int4 values; TMA zero-fills a last int8 stage that K does not fill)
TILES = ((128, 128), (128, 256), (256, 128), (64, 128))
DTYPES = ("bf16", "int8", "int4")
STAGE_K = {"bf16": 32, "int8": 64, "int4": 128}
PEAK = {"bf16": common.BF16_FLOPS_PER_S, "int8": common.INT8_OPS_PER_S,
        # the data sheet gives the H100 no dense int4 rate: held to int8's
        "int4": common.INT8_OPS_PER_S}


def pack_int4(v: torch.Tensor, dim: int) -> torch.Tensor:
    """int8 values in [-8, 7] -> int8 bytes holding two of them along ``dim``
    (even index in the low nibble): (M, K) -> (M, K/2) for x along K = 1,
    (K, N) -> (K/2, N) for w along K = 0."""
    v = v.movedim(dim, -1).to(torch.int32)
    pairs = (v[..., 0::2] & 0xF) | ((v[..., 1::2] & 0xF) << 4)
    packed = torch.where(pairs >= 128, pairs - 256, pairs).to(torch.int8)
    return packed.movedim(-1, dim).contiguous()


def unpack_int4(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extended int8 values)."""
    b = p.movedim(dim, -1).to(torch.int32) & 0xFF
    lo, hi = b & 0xF, b >> 4
    v = torch.stack([lo, hi], dim=-1).flatten(-2)
    v = torch.where(v >= 8, v - 16, v).to(torch.int8)
    return v.movedim(-1, dim).contiguous()


def _dtype(x: torch.Tensor, int4: bool) -> str:
    if int4:
        return "int4"
    return {torch.bfloat16: "bf16", torch.int8: "int8"}.get(x.dtype, str(x.dtype))


def _check(x, w, tiles, int4: bool):
    """(dtype name, M, N, K in elements); raise unless the shapes divide the
    tiles, as the JAX function needs (it does not pad), and unless x is
    16-byte aligned and w 16-byte (bf16) or 4-byte aligned (int8, int4:
    :func:`tiled_mm` copies such a w for TMA, which reads 16-byte aligned
    rows)."""
    if tuple(tiles) not in TILES:
        raise ValueError(f"tiles={tiles}: must be one of {TILES}")
    dt = _dtype(x, int4)
    if dt not in DTYPES or x.dtype != w.dtype:
        raise ValueError(f"tiled_mm takes bf16 or int8 operands (int4 packed in int8), "
                         f"got {x.dtype} and {w.dtype}")
    m, kx = x.shape
    kw, n = w.shape
    if kx != kw:
        raise ValueError(f"inner dims differ: {kx} vs {kw}")
    w_align = 16 if dt == "bf16" else 4
    if x.data_ptr() % 16 or w.data_ptr() % w_align:
        raise ValueError(f"tiled_mm: x must be 16-byte and w {w_align}-byte aligned")
    k = 2 * kx if int4 else kx
    bm, bn = tiles
    if m % bm or n % bn or k % STAGE_K[dt]:
        raise ValueError(f"({m}, {k}) @ ({k}, {n}) does not divide tiles ({bm}, {bn}) "
                         f"with {STAGE_K[dt]}-deep {dt} stages")
    return dt, m, n, k


def tiled_mm_reference(x: torch.Tensor, w: torch.Tensor, *, int4: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`tiled_mm`: exact float64 sum (the
    products of bf16 or small integers are exact), rounded once to float32."""
    if int4:
        x, w = unpack_int4(x, 1), unpack_int4(w, 0)
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)


def tiled_mm(x: torch.Tensor, w: torch.Tensor, *, tiles=TILES[0], int4: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) float32 on the tensor cores: bf16 operands
    with a float32 accumulator, int8 (or ``int4``, packed by
    :func:`pack_int4` along K) with an int32 accumulator. ``tiles`` = (BM,
    BN), one of TILES; the shapes must divide them. On the card an int8 or
    int4 w that is not 16-byte aligned is copied (``common.int8_rows``)."""
    dt, m, n, k = _check(x, w, tiles, int4)
    dev = x.device
    if dev.type == "cpu":
        return tiled_mm_reference(x, w, int4=int4)
    if dev.type != "cuda":
        raise ValueError(f"tiled_mm: unsupported device {dev}")
    _build.require("x", x, x.dtype, tuple(x.shape), dev)
    _build.require("w", w, x.dtype, tuple(w.shape), dev)
    if dt != "bf16":
        w = int8_rows(w)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _build.library("mxu_probe", qt_tiled_mm=[p, p, p, i, i, i, i, i, i, i, p])
    code = lib.qt_tiled_mm(_build.ptr(x), _build.ptr(w), _build.ptr(out), m, n, k,
                           DTYPES.index(dt), *tiles, *_build.launch_args(x))
    _build.check(lib, code, "tiled_mm")
    tiled_mm.launches += 1
    return out


tiled_mm.launches = 0


def operands(m: int, n: int, k: int, device, seed: int = 0) -> dict:
    """Seeded operands per dtype, as ``scripts/mxu_probe.py:76-92`` draws
    them: bf16 normals, int8 and int4 integers in [-4, 4)."""
    rng, xf, wf = common.seeded_inputs(m, n, k, seed)
    xi = rng.integers(-4, 4, (m, k))
    wi = rng.integers(-4, 4, (k, n))
    x4 = rng.integers(-4, 4, (m, k))
    w4 = rng.integers(-4, 4, (k, n))
    t = lambda a, dt: common.to(a, device).to(dt)  # noqa: E731
    return {
        "bf16": (t(xf, torch.bfloat16), t(wf, torch.bfloat16)),
        "int8": (t(xi, torch.int8), t(wi, torch.int8)),
        "int4": (pack_int4(t(x4, torch.int8), 1), pack_int4(t(w4, torch.int8), 0)),
    }


def library_call(dt: str, x, w):
    """One PyTorch call on the same operands, as a yardstick only (never used
    by the port): for bf16 ``torch.mm`` with a float32 output (the same
    function: bf16 products, float32 sum and output), or bf16
    ``torch.matmul`` (which rounds its output to bf16) where this torch lacks
    that overload; ``torch._int_mm`` for int8; none for int4."""
    if dt == "bf16":
        if common.mm_f32_out_supported(x.device):
            return lambda: torch.mm(x, w, out_dtype=torch.float32)
        return lambda: torch.matmul(x, w)
    if dt == "int8":
        return lambda: torch._int_mm(x, w)
    return None


def library_name(dt: str, x) -> str:
    """The name of :func:`library_call`'s call for ``dt`` on x's device."""
    if dt == "bf16":
        f32 = common.mm_f32_out_supported(x.device)
        return "torch.mm out_dtype=float32" if f32 else "torch.matmul bf16"
    return {"int8": "torch._int_mm"}.get(dt, "none")


def run(device="cuda", *, window_s: float = 0.25, repeats: int = 5, log=print) -> dict:
    """Times :func:`tiled_mm` at 4096^3 (``scripts/mxu_probe.py:74``) for
    each dtype over every tiling, and the library yardsticks; returns
    {dtype: {"tiles": {..: ms}, "launches": .., "best": .., "library_ms": ..}}
    (``launches``: the dtype's kernel launches in its timing windows)."""
    dev = common.require_card(device)
    m = n = k = common.SHAPE
    ops = 2 * m * n * k
    cases = operands(m, n, k, dev)
    out = {}
    for dt, (x, w) in cases.items():
        res = {"tiles": {}}
        before = tiled_mm.launches
        for tl in TILES:
            med, spread = common.time_call(lambda: tiled_mm(x, w, tiles=tl, int4=dt == "int4"),
                                           window_s=window_s, repeats=repeats)
            res["tiles"][f"{tl[0]}x{tl[1]}"] = med * 1e3
            log(f"# {dt} tiles {tl}: {med * 1e3:.4f} ms {ops / med / 1e12:.1f} T/s "
                f"({100 * ops / med / PEAK[dt]:.1f}% of the {PEAK[dt] / 1e12:.0f} T/s peak, "
                f"±{100 * spread:.1f}%)")
        res["launches"] = tiled_mm.launches - before  # this dtype's, all tilings
        best = min(res["tiles"], key=res["tiles"].get)
        res["best"] = best
        res["best_tops"] = ops / (res["tiles"][best] / 1e3) / 1e12
        yard = {library_name(dt, x): library_call(dt, x, w)}
        if dt == "bf16":
            yard["torch.matmul bf16"] = lambda x=x, w=w: torch.matmul(x, w)
        res["library_ms"] = None
        for name, lib in yard.items():
            if lib is None:
                continue
            med, spread = common.time_call(lib, window_s=window_s, repeats=repeats)
            res.setdefault("library", {})[name] = med * 1e3
            if res["library_ms"] is None:
                res["library_ms"] = med * 1e3
            log(f"# {dt} library ({name}): {med * 1e3:.4f} ms {ops / med / 1e12:.1f} T/s "
                f"({100 * ops / med / PEAK[dt]:.1f}% of peak, ±{100 * spread:.1f}%)")
        out[dt] = res
    if "int4" in out and "int8" in out:
        log(f"# int4 / int8 rate of the best tiles: "
            f"{out['int4']['best_tops'] / out['int8']['best_tops']:.3f}")
    log("# dtype ranking by the best tiles' rate: " + ranking(out))
    return out


def ranking(res: dict) -> str:
    """The dtypes of :func:`run`'s result from the fastest rate down, each
    with its T/s and tiling, e.g. ``int8 1100.0 T/s (256x128) > ...``."""
    order = sorted(res, key=lambda dt: -res[dt]["best_tops"])
    return " > ".join(f"{dt} {res[dt]['best_tops']:.1f} T/s ({res[dt]['best']})" for dt in order)


def main() -> None:
    res = run(log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps({"probe": res, "shape": common.SHAPE, "device": common.card_line()}))


if __name__ == "__main__":
    main()
