"""PyTorch port, the GEMM measurement slice, held against the JAX package.

The weight-stationary GEMMs (binary_gemm_ws, dorefa_gemm_ws, shift_gemm_ws),
the dtype probe's tiled matmul (tiled_mm) and the benchmarks built on them
(bench.headline, bench.kernel_bench, bench.mxu_probe). Inputs are made with
numpy from a seed and go through both packages: the JAX kernels run in
Pallas interpret mode on the CPU, the port's wrappers take their plain
PyTorch versions (CPU tensors). The CUDA kernels run on the card only, where
chip_smoke.py holds them against the same plain versions.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu_torch import ops as tops
from pytorch_quantize_impls_tpu_torch.bench import headline, kernel_bench
from pytorch_quantize_impls_tpu_torch.bench import mxu_probe as tmp
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as tpm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as tsm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as tbg
from pytorch_quantize_impls_tpu_torch.kernels.common import WS_DEFAULT_M_TILES, WS_M_TILES

jbg = sys.modules["pytorch_quantize_impls_tpu.kernels.xnor_gemm"]
jpm = sys.modules["pytorch_quantize_impls_tpu.kernels.packed_matmul"]
jsm = sys.modules["pytorch_quantize_impls_tpu.kernels.shift_matmul"]

REPO = Path(__file__).resolve().parent.parent
JAX_TILES = (128, 128, 1024)  # tests/test_kernels.py:60, 121, 178


def _probe_script():
    """scripts/mxu_probe.py as a module (it has no package to import from)."""
    spec = importlib.util.spec_from_file_location("mxu_probe_script", REPO / "scripts" / "mxu_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("scales", ["none", "alpha+row"])
@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (300, 2100, 260)])
def test_binary_gemm_ws_plain_matches_jax_kernel(m, k, n, scales):
    rng = np.random.default_rng(m + k + n)
    x, w = _normal(rng, m, k), _normal(rng, k, n)
    jxi, jwp = jbg.binarize_to_int8(jnp.asarray(x)), jbg.pack_binary_weights(jnp.asarray(w))
    alpha = row = None
    if scales != "none":
        alpha, row = np.abs(w).mean(0), np.abs(x).mean(1)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    ref = np.asarray(jbg.binary_gemm_ws(jxi, jwp, j(alpha), j(row), tiles=JAX_TILES))
    got = tbg.binary_gemm_ws(_t(jxi), _t(np.asarray(jwp).view(np.int32)), t(alpha), t(row))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("w_bits,a_bits", [(2, 2), (4, 4)])
def test_dorefa_gemm_ws_plain_matches_jax_kernel(w_bits, a_bits):
    m, k, n = 300, 2100, 260
    rng = np.random.default_rng(w_bits * 10 + a_bits)
    w, x = _normal(rng, k, n), np.abs(_normal(rng, m, k))
    wq = jops.dorefa_weight(jnp.asarray(w), w_bits)
    codes = jpm.dorefa_act_to_int8(jops.dorefa_activation(jnp.asarray(x), a_bits), a_bits)
    wp = jpm.pack_dorefa_weights(wq, w_bits)
    ref = np.asarray(jpm.dorefa_gemm_ws(codes, wp, w_bits=w_bits, a_bits=a_bits, tiles=JAX_TILES))
    # the port packs the same words from its own quantizers
    twp = tpm.pack_dorefa_weights(tops.dorefa_weight(_t(w), w_bits), w_bits)
    np.testing.assert_array_equal(twp.numpy().view(np.uint32), np.asarray(wp))
    got = tpm.dorefa_gemm_ws(_t(codes), twp, w_bits=w_bits, a_bits=a_bits)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fsr,bits", [(1.0, 4), (0.0, 3)])
def test_shift_gemm_ws_plain_matches_jax_kernel(fsr, bits):
    """JAX sums in float32 in tile order, the plain version exactly in
    float64: |diff| <= 1e-5 (|bf16(x)| @ |w|) per element."""
    m, k, n = 300, 2100, 260
    rng = np.random.default_rng(int(fsr) * 10 + bits)
    x, w = _normal(rng, m, k), _normal(rng, k, n)
    wp = jsm.pack_log_weights(jnp.asarray(w), fsr, bits)
    ref = np.asarray(jsm.shift_gemm_ws(jnp.asarray(x), wp, fsr=fsr, bits=bits, tiles=JAX_TILES))
    twp = _t(np.asarray(wp).view(np.int32))
    got = tsm.shift_gemm_ws(_t(x), twp, fsr=fsr, bits=bits).numpy()
    wd = tsm.decode_log_weights(twp, fsr=fsr, bits=bits)[:k].to(torch.float64)
    bound = (_t(x).to(torch.bfloat16).to(torch.float64).abs() @ wd.abs()).numpy()
    assert (np.abs(got.astype(np.float64) - ref) <= 1e-5 * bound).all()


def _jax_tiled_mm(x, w, tiles, acc_dtype):
    """scripts/mxu_probe.py's kernel body with the grid and specs of its
    pallas_mm (:47-60), in interpret mode (pallas_mm has no such switch)."""
    mp = _probe_script()
    m, k = x.shape
    n = w.shape[1]
    tm, tn, tk = tiles
    return pl.pallas_call(
        functools.partial(mp._mm_kernel, n_k=k // tk, out_dtype=jnp.float32),
        grid=(m // tm, n // tn, k // tk),
        in_specs=[
            pl.BlockSpec((tm, tk), lambda i, j, kk: (i, kk), memory_space=pltpu.VMEM),
            pl.BlockSpec((tk, tn), lambda i, j, kk: (kk, j), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tm, tn), lambda i, j, kk: (i, j), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((tm, tn), acc_dtype)],
        interpret=True,
    )(x, w)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_tiled_mm_plain_matches_jax_probe_kernel(dtype):
    """256x512x256, JAX tiles (128, 128, 256): int8 and int4 bit for bit,
    bf16 within 1e-5 (|x| @ |w|) (JAX sums in float32, the plain version in
    float64). JAX builds int4 arrays on the CPU, but its interpret-mode dot
    on them fails XLA's CPU verifier ("custom element sizes"), so the int4
    case holds the port's packed int4 to the JAX kernel on the same values
    as int8."""
    m, k, n = 256, 512, 256
    rng = np.random.default_rng(5)
    if dtype == "bf16":
        x, w = _normal(rng, m, k), _normal(rng, k, n)
        jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
        ref = np.asarray(_jax_tiled_mm(jx, jw, (128, 128, 256), jnp.float32))
        tx, tw = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
        got = tmp.tiled_mm(tx, tw).numpy()
        bound = (tx.double().abs() @ tw.double().abs()).numpy()
        assert (np.abs(got.astype(np.float64) - ref) <= 1e-5 * bound).all()
        return
    x = rng.integers(-4, 4, (m, k)).astype(np.int8)
    w = rng.integers(-4, 4, (k, n)).astype(np.int8)
    ref = np.asarray(_jax_tiled_mm(jnp.asarray(x), jnp.asarray(w), (128, 128, 256), jnp.int32))
    tx, tw = _t(x), _t(w)
    if dtype == "int4":
        tx, tw = tmp.pack_int4(tx, 1), tmp.pack_int4(tw, 0)
        assert tx.shape == (m, k // 2) and tw.shape == (k // 2, n)
    got = tmp.tiled_mm(tx, tw, tiles=(128, 128), int4=dtype == "int4")
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dim", [0, 1])
def test_int4_packing_round_trips(dim):
    v = torch.from_numpy(np.random.default_rng(dim).integers(-8, 8, (6, 10)).astype(np.int8))
    p = tmp.pack_int4(v, dim)
    assert p.dtype == torch.int8 and p.shape[dim] == v.shape[dim] // 2
    assert torch.equal(tmp.unpack_int4(p, dim), v)
    # low nibble first along dim
    first = v.select(dim, 0).to(torch.int32) & 0xF
    assert torch.equal(p.select(dim, 0).to(torch.int32) & 0xF, first)


def test_headline_rows_match_their_plain_versions():
    """Every row of bench.headline at a small shape on the CPU: the kernel
    rows (the wrappers take their plain versions) and the int8 yardstick bit
    for bit, log shift within 1e-5 of its ``abs_ref`` (the gate chip_smoke
    holds the card to), the float yardsticks within their type's rounding."""
    rows = headline.build_rows(64, 96, 300, "cpu")
    assert [r["name"] for r in rows] == [
        "fp32_highest", "bf16_peak", "int8_peak", "binary_fused", "binary_ws",
        "binary_decoded", "dorefa4_packed", "log_shift"]
    assert [r["name"] for r in rows if "abs_ref" in r] == ["log_shift"]
    for r in rows:
        got, ref = r["fn"](), r["plain"]()
        assert got.shape == ref.shape and got.dtype == ref.dtype, r["name"]
        if r["exact"]:
            assert torch.equal(got, ref), r["name"]
        elif "abs_ref" in r:
            assert ((got.double() - ref.double()).abs() <= 1e-5 * r["abs_ref"]()).all()
        else:
            tol = 2**-7 if got.dtype == torch.bfloat16 else 1e-5
            torch.testing.assert_close(got.double(), ref.double(), rtol=tol, atol=tol * 300)


@pytest.mark.parametrize("kernel", kernel_bench.KERNELS)
def test_kernel_bench_configs_match_their_plain_versions(kernel):
    configs = kernel_bench.build(kernel, (70, 130, 300), 4, "cpu")
    if kernel.endswith("_ws"):
        assert [c["m_tiles"] for c, _, _ in configs] == list(WS_M_TILES)
    else:
        assert len(configs) == 1 and "config" in configs[0][0]
    for _, fn, plain in configs:
        assert torch.equal(fn(), plain())


@pytest.mark.parametrize("main", [headline.main, lambda: kernel_bench.main([]), tmp.main])
def test_bench_main_refuses_without_a_gpu(main, monkeypatch, capsys):
    """Without a GPU a bench's entry point raises (so ``python -m`` exits
    non-zero) and prints no result line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="times the card"):
        main()
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("run", [
    lambda: headline.run("cpu"),
    lambda: kernel_bench.run("binary_ws", (64, 64, 64), device="cpu"),
    lambda: tmp.run("cpu"),
])
def test_bench_run_refuses_the_cpu(run):
    with pytest.raises(RuntimeError, match="times the card"):
        run()


def _ws_calls(m_tiles):
    x8 = torch.ones(70, 300, dtype=torch.int8)
    wp1 = tbg.pack_binary_weights(torch.ones(300, 20))
    wp4 = tpm.pack_dorefa_weights(tops.dorefa_weight(torch.ones(300, 20), 4), 4)
    wpl = tsm.pack_log_weights(torch.ones(300, 20), 1.0, 4)
    return {
        "binary_gemm_ws": lambda: tbg.binary_gemm_ws(x8, wp1, m_tiles=m_tiles),
        "dorefa_gemm_ws": lambda: tpm.dorefa_gemm_ws(x8, wp4, w_bits=4, a_bits=4, m_tiles=m_tiles),
        "shift_gemm_ws": lambda: tsm.shift_gemm_ws(torch.ones(70, 300), wpl, fsr=1.0, bits=4,
                                                   m_tiles=m_tiles),
    }


@pytest.mark.parametrize("m_tiles", [0, 3, 8, "2"])
@pytest.mark.parametrize("kernel", sorted(WS_DEFAULT_M_TILES))
def test_ws_m_tiles_outside_the_set_raise(kernel, m_tiles):
    with pytest.raises(ValueError, match="m_tiles"):
        _ws_calls(m_tiles)[kernel]()


@pytest.mark.parametrize("kernel", sorted(WS_DEFAULT_M_TILES))
def test_ws_every_m_tiles_gives_the_same_plain_result(kernel):
    assert WS_DEFAULT_M_TILES[kernel] in WS_M_TILES
    outs = [_ws_calls(mt)[kernel]() for mt in (None, *WS_M_TILES)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("tiles,shape", [
    ((96, 128), (128, 128, 128)),  # not an instantiated tiling
    ((128, 128), (100, 128, 128)),  # M does not divide
    ((128, 128), (128, 100, 128)),  # K does not divide the stage
    ((64, 128), (128, 128, 96)),  # N does not divide
])
def test_tiled_mm_needs_shapes_that_divide_its_tiles(tiles, shape):
    m, k, n = shape
    with pytest.raises(ValueError):
        tmp.tiled_mm(torch.ones(m, k, dtype=torch.int8), torch.ones(k, n, dtype=torch.int8),
                     tiles=tiles)


@pytest.mark.parametrize("operand", ["x", "w"])
def test_tiled_mm_rejects_misaligned_operands(operand):
    """A contiguous view off the kernel's load width raises, where the
    kernel would fault on the card."""
    def view(rows, cols, offset):
        return torch.ones(rows * cols + offset, dtype=torch.int8)[offset:].view(rows, cols)

    x = view(128, 128, 8 if operand == "x" else 0)
    w = view(128, 128, 2 if operand == "w" else 0)
    with pytest.raises(ValueError, match="aligned"):
        tmp.tiled_mm(x, w)


def test_tiled_mm_rejects_other_dtypes():
    with pytest.raises(ValueError, match="bf16 or int8"):
        tmp.tiled_mm(torch.ones(128, 128), torch.ones(128, 128))
    with pytest.raises(ValueError, match="bf16 or int8"):
        tmp.tiled_mm(torch.ones(128, 128, dtype=torch.int8),
                     torch.ones(128, 128, dtype=torch.bfloat16))

