"""PyTorch port, quantizer core and kernels, held against the JAX package.

Inputs are made with numpy from a seed and go through both packages: the JAX
kernels run as in tests/test_kernels.py (Pallas interpret mode on the CPU),
the port's wrappers take their plain PyTorch versions (CPU tensors). Every
comparison of integer-exact results is bit-exact. The CUDA kernels
themselves run on the card only, where chip_smoke.py holds them against the
same plain versions.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu.kernels import int8_matmul as jim
from pytorch_quantize_impls_tpu.ops import pack as jpack
from pytorch_quantize_impls_tpu_torch import ops as tops
from pytorch_quantize_impls_tpu_torch.kernels import _build
from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as tda
from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as tim
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as tbg
from pytorch_quantize_impls_tpu_torch.ops import pack as tpack

jbg = sys.modules["pytorch_quantize_impls_tpu.kernels.xnor_gemm"]
jda = sys.modules["pytorch_quantize_impls_tpu.kernels.decode_attention"]


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 300, 2304])
def test_pack_bitplanes_words_match_jax(bits, k):
    rng = np.random.default_rng(bits * 1000 + k)
    codes = rng.integers(0, 2**bits, size=(2, k, 7)).astype(np.int32)
    jw = np.asarray(jpack.pack_bitplanes(jnp.asarray(codes), bits))
    tw = tpack.pack_bitplanes(_t(codes), bits)
    assert tw.dtype == torch.int32 and jw.dtype == np.uint32
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw)
    back = tpack.unpack_bitplanes(tw, bits, k).numpy()
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(
        back, np.asarray(jpack.unpack_bitplanes(jnp.asarray(jw), bits, k))
    )
    assert tpack.planar_group_k(bits) == jpack.planar_group_k(bits)


def test_pack_rejects_unsupported_bits():
    with pytest.raises(ValueError):
        tpack.pack_bitplanes(torch.zeros(4, 4, dtype=torch.int32), 3)


@pytest.mark.parametrize(
    "m,k,n,scales",
    [
        (64, 128, 128, "alpha"),
        (33, 300, 130, "alpha+row"),
        (128, 2100, 256, "none"),
        (16, 2304, 64, "row"),
    ],
)
def test_binary_gemm_plain_matches_jax_kernel(m, k, n, scales):
    rng = np.random.default_rng(m * k + n)
    x, w = _normal(rng, m, k), _normal(rng, k, n)
    alpha = np.abs(w).mean(0) if "alpha" in scales else None
    row = np.abs(x).mean(1) if "row" in scales else None
    jxi = jbg.binarize_to_int8(jnp.asarray(x))
    jwp = jbg.pack_binary_weights(jnp.asarray(w))
    txi = tbg.binarize_to_int8(_t(x))
    twp = tbg.pack_binary_weights(_t(w))
    np.testing.assert_array_equal(txi.numpy(), np.asarray(jxi))
    np.testing.assert_array_equal(twp.numpy().view(np.uint32), np.asarray(jwp))
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    ref = np.asarray(jbg.binary_gemm(jxi, jwp, j(alpha), j(row)))
    got = tbg.binary_gemm(txi, twp, t(alpha), t(row))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_binary_gemm_zero_activations_match_jax_kernel():
    """Zeros in x (K padding, SAME-padded im2col patches) contribute 0: the
    kernels must not use the XNOR-popcount identity."""
    rng = np.random.default_rng(7)
    m, k, n = 24, 1500, 70
    xi = rng.integers(-1, 2, size=(m, k)).astype(np.int8)
    wp = np.asarray(jbg.pack_binary_weights(jnp.asarray(_normal(rng, k, n))))
    ref = np.asarray(jbg.binary_gemm(jnp.asarray(xi), jnp.asarray(wp)))
    got = tbg.binary_gemm(_t(xi), _t(wp.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k,n", [(25, 128), (3200, 256), (4096, 1024), (1024, 10), (2304, 256)])
def test_decode_plain_matches_jax_kernel(k, n):
    rng = np.random.default_rng(k + n)
    w = _normal(rng, k, n)
    jwp = jbg.pack_binary_weights(jnp.asarray(w))
    ref = np.asarray(jbg.decode_binary_weights(jwp))
    got = tbg.decode_binary_weights(_t(np.asarray(jwp).view(np.int32)))
    assert got.dtype == torch.int8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # every real row decodes to sign(w), K = 2304 included
    np.testing.assert_array_equal(got.numpy()[:k], np.where(w >= 0, 1, -1))


@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (33, 300, 130), (130, 2100, 257)])
def test_int8_gemm_plain_matches_jax_kernel(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 127, size=(m, k)).astype(np.int8)
    w = rng.integers(-127, 127, size=(k, n)).astype(np.int8)
    alpha, row = _normal(rng, n), _normal(rng, m)
    ref = np.asarray(
        jim.int8_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(row))
    )
    got = tim.int8_gemm(_t(x), _t(w), _t(alpha), _t(row))
    np.testing.assert_array_equal(got.numpy(), ref)
    ref2 = np.asarray(jim.int8_gemm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(tim.int8_gemm(_t(x), _t(w)).numpy(), ref2)


def test_binary_gemm_decoded_matches_jax():
    rng = np.random.default_rng(3)
    x, w = _normal(rng, 16, 2000), _normal(rng, 2000, 96)
    alpha = np.abs(w).mean(0)
    jwp = jbg.pack_binary_weights(jnp.asarray(w))
    jw8 = jbg.decode_binary_weights(jwp)[:2000]
    ref = np.asarray(
        jbg.binary_gemm_decoded(
            jbg.binarize_to_int8(jnp.asarray(x)), jw8, jnp.asarray(alpha),
            out_dtype=jnp.float32,
        )
    )
    tw8 = tbg.decode_binary_weights(_t(np.asarray(jwp).view(np.int32)))[:2000]
    got = tbg.binary_gemm_decoded(tbg.binarize_to_int8(_t(x)), tw8, _t(alpha))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_safe_sign_and_binary_tanh_match_jax():
    rng = np.random.default_rng(11)
    x = np.concatenate(
        [_normal(rng, 200) * 2, np.array([0.0, -0.0, 1.0, -1.0, 1.5, -1.5], np.float32)]
    )
    g = _normal(rng, x.size)
    np.testing.assert_array_equal(tops.safe_sign(_t(x)).numpy(), np.asarray(jops.safe_sign(jnp.asarray(x))))
    xt = _t(x).requires_grad_(True)
    y = tops.binary_tanh(xt)
    (y * _t(g)).sum().backward()
    jy = np.asarray(jops.binary_tanh(jnp.asarray(x)))
    jgrad = np.asarray(
        jax.grad(lambda v: jnp.sum(jops.binary_tanh(v) * jnp.asarray(g)))(jnp.asarray(x))
    )
    np.testing.assert_array_equal(y.detach().numpy(), jy)
    np.testing.assert_array_equal(xt.grad.numpy(), jgrad)


def test_binary_connect_det_identity_ste_matches_jax():
    rng = np.random.default_rng(12)
    x = _normal(rng, 64) * 3
    xt = _t(x).requires_grad_(True)
    tops.binary_connect_det(xt, ste_mode="identity").sum().backward()
    jgrad = jax.grad(
        lambda v: jnp.sum(jops.binary_connect_det(v, ste_mode="identity"))
    )(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))


def _attention_inputs(rng, b, h, cl, hd, lens):
    """Inputs of tests/test_kernels.py's decode-attention test; position j
    of slot i is attended iff j < lens[i]."""
    q = _normal(rng, b, h, hd)
    kc = rng.integers(-127, 128, (b, h, cl, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (b, h, cl, hd)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (b, h, cl)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (b, h, cl)).astype(np.float32)
    bias = np.where(np.arange(cl)[None, :] < np.asarray(lens)[:, None], 0.0, -1e30)
    return q, kc, ks, vc, vs, bias.astype(np.float32)


@pytest.mark.parametrize(
    "b,h,cl,hd,lens",
    [
        (3, 4, 64, 32, [5, 30, 64]),  # tests/test_kernels.py:305-315
        (1, 8, 1, 128, [1]),
        (5, 2, 37, 64, [1, 37, 20, 2, 36]),
        (2, 8, 256, 128, [256, 1]),
    ],
)
def test_decode_attention_plain_matches_jax_kernel(b, h, cl, hd, lens):
    rng = np.random.default_rng(b * cl + hd)
    args = _attention_inputs(rng, b, h, cl, hd, lens)
    ref = np.asarray(jda.decode_attention(*map(jnp.asarray, args)))
    got = tda.decode_attention(*map(_t, args))
    assert got.dtype == torch.float32 and got.shape == (b, h, hd)
    # float32 on both sides (not the TPU's bf16 passes), sums in another
    # order. Scores reach |s| ~ 20, where an f32 ulp is 2e-6, and exp turns
    # that into a relative error of every p; a context that cancels keeps it
    # as an absolute error, measured here up to 2e-6 of the largest context.
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_decode_attention_flushes_subnormal_probabilities():
    """Scores 100 apart give p = e^-100 (subnormal): XLA flushes it, so the
    context is that of the one dominant position exactly."""
    q = np.zeros((1, 1, 16), np.float32)
    q[0, 0, 0] = 1.0
    kc = np.zeros((1, 1, 2, 16), np.int8)
    kc[0, 0, 0, 0] = 100  # score 100 * k_scale 4 * rsqrt(16) = 100; the other 0
    vc = np.zeros((1, 1, 2, 16), np.int8)
    vc[0, 0, 1, :] = 1
    ks = np.array([[[4.0, 4.0]]], np.float32)
    vs = np.ones((1, 1, 2), np.float32)
    bias = np.zeros((1, 2), np.float32)
    args = (q, kc, ks, vc, vs, bias)
    got = tda.decode_attention(*map(_t, args))
    ref = np.asarray(jda.decode_attention(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got == 0).all()


def test_cpu_tensors_take_the_plain_versions():
    counters = (tbg.binary_gemm, tbg.decode_binary_weights, tim.int8_gemm, tda.decode_attention)
    before = [f.launches for f in counters]
    x = torch.ones(4, 64, dtype=torch.int8)
    wp = tbg.pack_binary_weights(torch.ones(64, 8))
    tbg.binary_gemm(x, wp)
    tim.int8_gemm(x, tbg.decode_binary_weights(wp)[:64])
    codes = torch.zeros(2, 2, 8, 16, dtype=torch.int8)
    scales = torch.ones(2, 2, 8)
    tda.decode_attention(torch.ones(2, 2, 16), codes, scales, codes, scales, torch.zeros(2, 8))
    assert [f.launches for f in counters] == before


def test_other_devices_raise():
    """Off the CPU a wrapper launches its kernel or raises: no fallback."""
    x = torch.empty(4, 64, dtype=torch.int8, device="meta")
    wp = torch.empty(32, 8, dtype=torch.int32, device="meta")
    w8 = torch.empty(64, 8, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbg.binary_gemm(x, wp)
    with pytest.raises(ValueError, match="unsupported device"):
        tbg.decode_binary_weights(wp)
    with pytest.raises(ValueError, match="unsupported device"):
        tim.int8_gemm(x, w8)
    codes = torch.empty(2, 2, 8, 16, dtype=torch.int8, device="meta")
    scales = torch.empty(2, 2, 8, device="meta")
    q, bias = torch.empty(2, 2, 16, device="meta"), torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tda.decode_attention(q, codes, scales, codes, scales, bias)


def test_shape_checks_raise():
    with pytest.raises(ValueError):  # K beyond the packed K
        tbg.binary_gemm(torch.ones(2, 1025, dtype=torch.int8), torch.zeros(32, 4, dtype=torch.int32))
    with pytest.raises(ValueError):  # packed rows not a whole group
        tbg.decode_binary_weights(torch.zeros(31, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tim.int8_gemm(torch.ones(2, 8, dtype=torch.int8), torch.ones(9, 4, dtype=torch.int8))
    codes = torch.zeros(2, 2, 8, 16, dtype=torch.int8)
    scales = torch.ones(2, 2, 8)
    with pytest.raises(ValueError, match="codes"):
        tda.decode_attention(torch.ones(2, 2, 16), codes[:, :, :, :8], scales, codes, scales,
                             torch.zeros(2, 8))
    with pytest.raises(ValueError, match="mask_bias"):
        tda.decode_attention(torch.ones(2, 2, 16), codes, scales, codes, scales, torch.zeros(2, 9))


def test_build_is_keyed_on_sources_and_needs_nvcc(monkeypatch, tmp_path):
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and name in path.name
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_launch_errors_and_bad_arguments_raise():
    class Lib:  # stands in for a loaded kernel library
        @staticmethod
        def qt_cuda_error_string(code):
            return b"invalid configuration argument"

    _build.check(Lib, 0, "k")
    with pytest.raises(RuntimeError, match="k: CUDA error 9: invalid configuration"):
        _build.check(Lib, 9, "k")
    t = torch.zeros(4, 6, dtype=torch.int8)
    _build.require("x", t, torch.int8, (4, 6), t.device)
    for bad, match in (
        (t.to(torch.int32), "expected"),  # dtype
        (t[:, :3].contiguous(), "expected"),  # shape
        (torch.zeros(6, 4, dtype=torch.int8).T, "contiguous"),
    ):
        with pytest.raises(ValueError, match=match):
            _build.require("x", bad, torch.int8, (4, 6), t.device)
    with pytest.raises(ValueError, match="expected meta"):
        _build.require("x", t, torch.int8, (4, 6), torch.device("meta"))


def _ws_and_probe_wrappers(device):
    """The weight-stationary GEMMs and the probe's tiled matmul, each called
    on small tensors on ``device``: {name: (wrapper, call)}."""
    from pytorch_quantize_impls_tpu_torch.bench import mxu_probe as tmp
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as tpm
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as tsm

    x8 = torch.ones(4, 64, dtype=torch.int8, device=device)
    wp = torch.zeros(32, 8, dtype=torch.int32, device=device)
    xf = torch.ones(4, 64, device=device)
    a = torch.ones(128, 128, dtype=torch.int8, device=device)
    return {
        "binary_gemm_ws": (tbg.binary_gemm_ws, lambda: tbg.binary_gemm_ws(x8, wp)),
        "dorefa_gemm_ws": (tpm.dorefa_gemm_ws,
                           lambda: tpm.dorefa_gemm_ws(x8, wp, w_bits=4, a_bits=4)),
        "shift_gemm_ws": (tsm.shift_gemm_ws, lambda: tsm.shift_gemm_ws(xf, wp, fsr=1.0, bits=4)),
        "tiled_mm": (tmp.tiled_mm, lambda: tmp.tiled_mm(a, a)),
    }


WS_AND_PROBE = ("binary_gemm_ws", "dorefa_gemm_ws", "shift_gemm_ws", "tiled_mm")


@pytest.mark.parametrize("name", WS_AND_PROBE)
def test_ws_and_probe_cpu_tensors_take_the_plain_versions(name):
    wrapper, call = _ws_and_probe_wrappers("cpu")[name]
    before = wrapper.launches
    out = call()
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    assert wrapper.launches == before


@pytest.mark.parametrize("name", WS_AND_PROBE)
def test_ws_and_probe_other_devices_raise(name):
    """Off the CPU a wrapper launches its kernel or raises: no fallback."""
    _, call = _ws_and_probe_wrappers("meta")[name]
    with pytest.raises(ValueError, match="unsupported device"):
        call()


@pytest.mark.parametrize("name", ["binary_gemm_ws", "dorefa_gemm_ws", "shift_gemm_ws"])
def test_ws_shape_checks_raise(name):
    from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as tpm
    from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as tsm

    short = torch.zeros(31, 4, dtype=torch.int32)  # packed rows not a whole group
    x_long = torch.ones(2, 1025, dtype=torch.int8)  # K beyond a 1-bit group
    call = {
        "binary_gemm_ws": lambda w, x: tbg.binary_gemm_ws(x, w),
        "dorefa_gemm_ws": lambda w, x: tpm.dorefa_gemm_ws(x, w, w_bits=4, a_bits=4),
        "shift_gemm_ws": lambda w, x: tsm.shift_gemm_ws(x.float(), w, fsr=1.0, bits=4),
    }[name]
    with pytest.raises(ValueError):
        call(short, torch.ones(2, 8, dtype=torch.int8))
    with pytest.raises(ValueError):
        call(torch.zeros(32, 4, dtype=torch.int32), x_long)
