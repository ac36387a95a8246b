"""PyTorch port of the log-quant (power-of-2) slice, held against the JAX
package.

Inputs are made with numpy from a seed and go through both packages: the JAX
Pallas kernels (``shift_gemm``, ``decode_log_weights``) run in interpret
mode on the CPU, as tests/test_kernels.py runs them; the port's wrappers
take their plain PyTorch versions (CPU tensors). Packed words and decoded
bf16 patterns are compared bit for bit; GEMM outputs and logits to the
float tolerances stated beside each. The CUDA kernels run on the card only,
where chip_smoke.py holds them against the same plain versions.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import nn as jnn
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu.infer import packed as jpacked
from pytorch_quantize_impls_tpu.models.transformer import QuantTransformerLM as JLM
from pytorch_quantize_impls_tpu.ops import log_lin as jlog
from pytorch_quantize_impls_tpu.ops import pack as jpack
from pytorch_quantize_impls_tpu.serve.generate import _MUT
from pytorch_quantize_impls_tpu_torch import infer, models, nn as tnn, ops, serve
from pytorch_quantize_impls_tpu_torch.kernels import conv as tconv
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as tsm
from pytorch_quantize_impls_tpu_torch.ops import pack as tpack
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
    load_flax_variables,
)

jsm = sys.modules["pytorch_quantize_impls_tpu.kernels.shift_matmul"]
jconv = sys.modules["pytorch_quantize_impls_tpu.kernels.conv"]
CPU = "cpu"
# the float tolerance of a GEMM whose products are exact and whose float32
# sums run in another order (tests/test_kernels.py:162)
GEMM_TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _i16(a):
    """bf16 bit patterns as int16, from a torch or a JAX array."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _weights(rng, k, n):
    """He-scaled weights with exact zeros and powers of two among them."""
    w = _normal(rng, k, n, scale=(2.0 / k) ** 0.5)
    w.flat[:4] = (0.0, -0.0, 0.25, -2.0)
    return w


# --- ops.log_lin ---------------------------------------------------------------


@pytest.mark.parametrize("fsr,bits", [(1.0, 4), (0.0, 3), (2.0, 2)])
@pytest.mark.parametrize("with_sign", [True, False])
def test_log_quant_forward_and_grads_match_jax(fsr, bits, with_sign):
    rng = np.random.default_rng(int(10 * fsr) + bits)
    x = _weights(rng, 40, 16).ravel() * 3
    g = _normal(rng, x.size)
    ref = np.asarray(jops.log_quant(jnp.asarray(x), fsr, bits, with_sign=with_sign))
    got = ops.log_quant(_t(x), fsr, bits, with_sign=with_sign).numpy()
    # the port's levels are the exact powers of two of JAX's exponents; XLA's
    # CPU exp2 sits up to 8 ulp (5e-7) off them at levels <= 2^-13
    sign, idx = jlog.log_quant_exponent(jnp.asarray(x), fsr, bits)
    exact = np.ldexp(np.float32(1), np.asarray(idx) + int(fsr) - 2**bits)
    np.testing.assert_array_equal(got, exact * (np.asarray(sign) if with_sign else 1))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    for lin_back in (True, False):
        xt = _t(x).requires_grad_(True)
        (ops.log_quant(xt, fsr, bits, with_sign=with_sign, lin_back=lin_back) * _t(g)).sum().backward()
        jg = jax.grad(lambda v: jnp.sum(
            jops.log_quant(v, fsr, bits, with_sign=with_sign, lin_back=lin_back) * g))(jnp.asarray(x))
        # |y| / |x|: one float division on XLA's exp2, up to 8 ulp off
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=0)
        if lin_back:
            np.testing.assert_array_equal(xt.grad.numpy(), g)


@pytest.mark.parametrize("fsr,bits", [(1.0, 4), (0.0, 3), (-1.0, 6)])
def test_lin_quant_and_grad_match_jax(fsr, bits):
    rng = np.random.default_rng(bits)
    x = _normal(rng, 500, scale=2.0)
    g = _normal(rng, 500)
    xt = _t(x).requires_grad_(True)
    y = ops.lin_quant(xt, fsr, bits)
    (y * _t(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jops.lin_quant(jnp.asarray(x), fsr, bits)))
    jg = jax.grad(lambda v: jnp.sum(jops.lin_quant(v, fsr, bits) * g))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("fsr,bits", [(1.0, 4), (0.0, 3), (1.0, 6), (0.5, 4)])
def test_exponent_codes_match_jax(fsr, bits):
    """Sign, exponent index and codes bit for bit on seeded data (no |w| lies
    within an ulp of 2^(k + 1/2) here); fsr 0.5 is the non-integer case
    where ops.log_quant and the kernels' int(fsr) disagree."""
    rng = np.random.default_rng(bits)
    w = _weights(rng, 300, 20)
    sign, idx = ops.log_quant_exponent(_t(w), fsr, bits)
    jsign, jidx = jlog.log_quant_exponent(jnp.asarray(w), fsr, bits)
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.dtype == torch.int32 and int(idx.min()) >= 0 and int(idx.max()) <= 2**bits
    codes = tpack.log_to_codes(sign, idx, bits)
    jcodes = jpack.log_to_codes(jsign.astype(jnp.int32), jidx, bits)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    back = tpack.codes_to_log(codes, bits)
    for mine, theirs in zip(back, jpack.codes_to_log(jcodes, bits)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(back[1].numpy(), idx.numpy())
    # the port's levels are exact powers of two; XLA's CPU exp2 drifts off
    # them at deep-negative levels (26 ulp, 1.5e-6, at 2^-63)
    levels = ops.log_quant_from_exponent(sign, idx, fsr, bits).numpy()
    exact = sign.numpy() * np.exp2(idx.numpy() + fsr - 2**bits).astype(np.float32)
    if fsr == int(fsr):
        np.testing.assert_array_equal(levels, exact)
    np.testing.assert_allclose(levels, exact, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        levels, np.asarray(jlog.log_quant_from_exponent(jsign, jidx, fsr, bits)), rtol=1e-5, atol=0)


# --- K8 shift_gemm, K9 decode_log_weights --------------------------------------


@pytest.mark.parametrize("fsr,bits", [(1.0, 4), (0.0, 3), (1.0, 6)])
@pytest.mark.parametrize("k", [300, 2100])
def test_pack_and_decode_log_weights_match_jax(fsr, bits, k):
    rng = np.random.default_rng(k + bits)
    n = 24
    w = _weights(rng, k, n)
    jw = jsm.pack_log_weights(jnp.asarray(w), fsr, bits)
    tw = tsm.pack_log_weights(_t(w), fsr, bits)
    assert tw.dtype == torch.int32 and tw.shape == (-(-k // 128) * 32, n)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    # K9: every packed row decodes, bit-identical to the Pallas decode and to
    # infer/packed.py's plain decode; padded rows hold code 0 = -2^lo
    tdec = tsm.decode_log_weights(tw, fsr=fsr, bits=bits)
    assert tdec.dtype == torch.bfloat16 and tdec.shape == (4 * tw.shape[0], n)
    np.testing.assert_array_equal(_i16(tdec), _i16(jsm.decode_log_weights(jw, fsr=fsr, bits=bits)))
    np.testing.assert_array_equal(_i16(tsm.decode_log_weights_reference(tw, fsr=fsr, bits=bits)),
                                  _i16(tdec))
    rec = jpacked.PackedLayer(packed=jw, kind="dense", scheme="log", w_bits=bits, fsr=fsr,
                              kernel_shape=(k, n))
    np.testing.assert_array_equal(_i16(tdec[:k]), _i16(jpacked._decode_weights(rec)))
    lo = int(fsr) - 2**bits
    assert (tdec[k:].float() == -(2.0**lo)).all()
    # the decoded levels are the port's log_quant values, exactly
    np.testing.assert_array_equal(tdec[:k].float().numpy(), ops.log_quant(_t(w), fsr, bits).numpy())


@pytest.mark.parametrize(
    "m,k,n,fsr,bits",
    [(1, 27, 128, 1.0, 4), (16, 384, 64, 1.0, 4), (33, 300, 10, 0.0, 3), (7, 1100, 130, 1.0, 6)],
)
def test_shift_gemm_plain_matches_jax(m, k, n, fsr, bits):
    rng = np.random.default_rng(m + k + n)
    jw = jsm.pack_log_weights(jnp.asarray(_weights(rng, k, n)), fsr, bits)
    tw = _t(np.asarray(jw).view(np.int32))
    x = _normal(rng, m, k)
    got = tsm.shift_gemm(_t(x), tw, fsr=fsr, bits=bits)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), tsm.shift_gemm_reference(_t(x), tw, fsr=fsr,
                                                                         bits=bits).numpy())
    kw = dict(fsr=fsr, bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsm.shift_gemm(jnp.asarray(x), jw, **kw)),
                               **GEMM_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsm.shift_gemm_reference(jnp.asarray(x), jw, **kw)), **GEMM_TOL)
    # bf16 x is rounded exactly once: a bf16 input gives the same bits
    np.testing.assert_array_equal(
        tsm.shift_gemm(_t(x).to(torch.bfloat16), tw, **kw).numpy(), got.numpy())
    # the decoded GEMM on K9's weights: the same function
    dec = tsm.decode_log_weights(tw, **kw)
    np.testing.assert_allclose(tsm.shift_gemm_decoded(_t(x), dec).numpy(), got.numpy(), **GEMM_TOL)
    np.testing.assert_allclose(
        tsm.shift_gemm_decoded(_t(x), dec).numpy(),
        np.asarray(jsm.shift_gemm_decoded(jnp.asarray(x), jsm.decode_log_weights(jw, **kw))),
        **GEMM_TOL)


def test_shift_refusals_and_dispatch():
    counters = (tsm.shift_gemm, tsm.decode_log_weights)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="bits=7"):
        tsm.pack_log_weights(torch.zeros(8, 4), 0.0, 7)
    with pytest.raises(ValueError):  # K beyond the packed K (128 rows)
        tsm.shift_gemm(torch.ones(2, 129), torch.zeros(32, 4, dtype=torch.int32), fsr=0.0, bits=4)
    with pytest.raises(ValueError):  # packed rows not a whole group
        tsm.decode_log_weights(torch.zeros(31, 4, dtype=torch.int32), fsr=0.0, bits=4)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsm.shift_gemm(torch.empty(2, 64, **meta), torch.empty(32, 4, dtype=torch.int32, **meta),
                       fsr=0.0, bits=4)
    with pytest.raises(ValueError, match="unsupported device"):
        tsm.decode_log_weights(torch.empty(32, 4, dtype=torch.int32, **meta), fsr=0.0, bits=4)
    assert [f.launches for f in counters] == before


# --- the packed conv -----------------------------------------------------------


@pytest.mark.parametrize("strides,padding", [((1, 1), "SAME"), ((2, 2), "SAME"), ((2, 1), "VALID")])
def test_packed_conv_log_matches_jax(strides, padding):
    rng = np.random.default_rng(strides[0] + len(padding))
    cin, cout = 8, 12
    w_hwio = _normal(rng, 3, 3, cin, cout, scale=0.2)
    x = _normal(rng, 2, 16, 16, cin)
    jpc = jconv.pack_conv_weights(jnp.asarray(w_hwio), "log", w_bits=4, fsr=1.0)
    tpc = tconv.pack_conv_weights(_t(w_hwio.transpose(3, 2, 0, 1)), "log", w_bits=4, fsr=1.0)
    np.testing.assert_array_equal(tpc.packed.numpy().view(np.uint32), np.asarray(jpc.packed))
    # K9 decode, HWIO in JAX, flat (cin, kh, kw) x cout in the port
    jdec = np.asarray(jconv.decode_conv_weights(jpc)).view(np.int16)
    np.testing.assert_array_equal(_i16(tconv.decode_conv_weights(tpc)),
                                  jdec.transpose(2, 0, 1, 3).reshape(-1, cout))
    kw = dict(strides=strides, padding=padding)
    direct = tconv.packed_conv2d(_t(x), tpc, **kw)
    im2col = tconv.packed_conv2d(_t(x), tpc, mode="im2col", **kw)
    np.testing.assert_allclose(direct.numpy(), im2col.numpy(), **GEMM_TOL)
    for mode, got in (("direct", direct), ("im2col", im2col)):
        ref = np.asarray(jconv.packed_conv2d(jnp.asarray(x), jpc, mode=mode, **kw))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, **GEMM_TOL)


# --- LogQuantVGGSmall ----------------------------------------------------------

WIDTHS = (8, 8, 16, 16)


@pytest.fixture(scope="module")
def vgg():
    """(jax model, jax variables, port model, input batch): seeded He-scaled
    weights through the bridge, BatchNorm calibrated on seeded images, as
    chip_smoke.py builds the full-width model."""
    rng = np.random.default_rng(0)
    calib = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    tm, variables = chip_smoke.calibrated_vgg(models.LogQuantVGGSmall(widths=WIDTHS), rng, calib)
    jm = jmodels.LogQuantVGGSmall(widths=WIDTHS, bits=4, fsr=1.0)
    x = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    init = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]),
                                          train=False))
    same = jax.tree_util.tree_map(lambda a, b: a.shape == b.shape, dict(init), variables)
    assert all(jax.tree_util.tree_leaves(same))
    return jm, variables, tm, x


def _fake(tm, x):
    with torch.no_grad():
        return tm(_t(x)).numpy()


def test_vgg_fake_quant_logits_match_jax(vgg):
    jm, variables, tm, x = vgg
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    got = _fake(tm, x)
    assert got.shape == (6, 10) and np.isfinite(got).all()
    # conv sums in another order; log_quant's exp2 may sit an ulp apart
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_vgg_pack_records_match_jax(vgg):
    jm, variables, tm, x = vgg
    jp = jinfer.pack_model(jm, variables, jnp.asarray(x[:1]))
    tp = infer.pack_model(tm)
    assert set(tp) == set(jp) == {(f"conv{i}", "conv") for i in range(4)} | {("head", "dense")}
    for path, jrec in jp.items():
        rec = tp[path]
        np.testing.assert_array_equal(rec.packed.numpy().view(np.uint32), np.asarray(jrec.packed))
        assert (rec.kind, rec.scheme, rec.w_bits, rec.a_bits, rec.fsr, rec.kernel_shape) == (
            jrec.kind, jrec.scheme, jrec.w_bits, jrec.a_bits, jrec.fsr, jrec.kernel_shape)
    jprep, tprep = jinfer.prepare(jp), infer.prepare(tp)
    for path in jp:
        assert tprep[path].decoded.dtype == torch.bfloat16
        np.testing.assert_array_equal(_i16(tprep[path].decoded), _i16(jprep[path].decoded))


def _head_inputs(jm, variables, jp, tm, tp, x):
    """(port logits, JAX logits, port head input, JAX head input) of
    packed_apply on ``x``."""
    import flax.linen as fnn

    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and context.module.path == ("head", "dense"):
            seen["jax"] = np.asarray(args[0])
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        ref = np.asarray(jinfer.packed_apply(jm, variables, jp, jnp.asarray(x)))
    hook = tm.head.dense.register_forward_pre_hook(
        lambda m, args: seen.__setitem__("port", args[0].numpy()))
    try:
        got = infer.packed_apply(tm, tp, _t(x)).numpy()
    finally:
        hook.remove()
    return got, ref, seen["port"], seen["jax"]


@pytest.mark.parametrize("prepared", [False, True], ids=["unprepared", "prepared"])
def test_vgg_packed_logits_match_jax(vgg, prepared):
    jm, variables, tm, x = vgg
    jp = jinfer.pack_model(jm, variables, jnp.asarray(x[:1]))
    tp = infer.pack_model(tm)
    if prepared:
        jp, tp = jinfer.prepare(jp), infer.prepare(tp)
    got, ref, h, jh = _head_inputs(jm, variables, jp, tm, tp, x)
    np.testing.assert_allclose(h, jh, rtol=1e-4, atol=1e-4)  # conv sums in another order
    # The unprepared head (K8) rounds its input to bf16. Where the two
    # packages' float32 inputs straddle a bf16 rounding boundary they round
    # one bf16 ulp apart, which moves that product by 2^-8 of itself: the
    # logits then differ by that much beyond the float tolerance, and by
    # nothing more.
    flips = 0.0
    if not prepared:
        hb, jhb = (_t(a).to(torch.bfloat16).double() for a in (h, jh))
        w = infer.prepare(tp)[("head", "dense")].decoded.double()
        flips = ((hb - jhb).abs() @ w.abs()).numpy()
        assert int((hb != jhb).sum()) <= 0.01 * hb.numel()
    assert (np.abs(got - ref) <= 1e-4 + 1e-4 * np.abs(ref) + flips).all()
    # the packed-vs-fake-quant seam of tests/test_infer.py:50-52
    np.testing.assert_allclose(got, _fake(tm, x), rtol=5e-2, atol=5e-2)


def test_vgg_artifacts_interchange(vgg, tmp_path):
    jm, variables, tm, x = vgg
    jpath, tpath = os.path.join(tmp_path, "jax.npz"), os.path.join(tmp_path, "port.npz")
    jp = jinfer.pack_model(jm, variables, jnp.asarray(x[:1]))
    tp = infer.pack_model(tm)
    jinfer.save_packed(jpath, jp)
    infer.save_packed(tpath, tp)
    loaded = infer.load_packed(jpath, device=CPU)
    for a, b in ((loaded, tp), (infer.prepare(loaded), infer.prepare(tp))):
        np.testing.assert_array_equal(infer.packed_apply(tm, a, _t(x)).numpy(),
                                      infer.packed_apply(tm, b, _t(x)).numpy())
    jloaded = jinfer.load_packed(tpath)
    for a, b in ((jloaded, jp), (jinfer.prepare(jloaded), jinfer.prepare(jp))):
        np.testing.assert_array_equal(
            np.asarray(jinfer.packed_apply(jm, variables, a, jnp.asarray(x))),
            np.asarray(jinfer.packed_apply(jm, variables, b, jnp.asarray(x))))


def test_build_model_logquant_vgg():
    cfg = RunConfig(**SCHEME_CONFIGS["logquant_vgg"])
    model, shape, data = build_model(cfg, device=CPU)
    assert (shape, data, cfg.w_bits, cfg.a_bits, cfg.fsr) == ((32, 32, 3), "cifar10", 4, 0, 1.0)
    assert model.widths == (128, 128, 256, 256, 512, 512)
    assert tuple(model.conv5.conv.weight.shape) == (512, 512, 3, 3)
    assert tuple(model.head.dense.weight.shape) == (10, 8192)
    assert model.conv0.conv.bias is None and model.head.dense.bias is not None
    assert (model.head.dense.scheme, model.head.dense.w_bits, model.head.dense.fsr) == ("log", 4, 1.0)
    assert model.head.clip_bound == 2.0


def test_vgg_flattens_nhwc_before_the_head():
    """The head's 8192 inputs are in (h, w, c) order, as ``x.reshape((b,
    -1))`` of the JAX model's NHWC tensor."""
    m = models.LogQuantVGGSmall(widths=(2, 3)).eval()
    seen = []
    m.head.dense.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    x = torch.randn(1, 32, 32, 3)
    with torch.no_grad():
        feats = torch.relu(m.bn1(m.conv1(torch.relu(m.bn0(m.conv0(x))))))
        m(x)
    pooled = torch.nn.functional.max_pool2d(feats.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(seen[0].numpy(), pooled.reshape(1, -1).numpy())


# --- log and lin layers ---------------------------------------------------------


@pytest.mark.parametrize("scheme", ["log", "lin"])
def test_log_lin_layers_packed_match_jax(scheme):
    """A dense and a conv layer of each scheme (bias on), packed unprepared
    and prepared, against JAX's packed_apply; weights-only, so the prepared
    path equals the fake-quant forward up to float32 sums (log: exp2 ulp)."""
    rng = np.random.default_rng(len(scheme))
    x = _normal(rng, 8, 64)
    xc = _normal(rng, 2, 8, 8, 4)
    v_d = {"params": {"dense": {"kernel": _normal(rng, 64, 16, scale=0.3),
                                "bias": _normal(rng, 16, scale=0.1)}}}
    v_c = {"params": {"conv": {"kernel": _normal(rng, 3, 3, 4, 6, scale=0.3),
                               "bias": _normal(rng, 6, scale=0.1)}}}
    jd = (jnn.LinearQuantLog if scheme == "log" else jnn.LinearQuantLin)(features=16, fsr=1.0, bits=4)
    jc = (jnn.ConvQuantLog if scheme == "log" else jnn.ConvQuantLin)(features=6, fsr=1.0, bits=4)
    td = (tnn.LinearQuantLog if scheme == "log" else tnn.LinearQuantLin)(64, 16, fsr=1.0, bits=4)
    tc = (tnn.ConvQuantLog if scheme == "log" else tnn.ConvQuantLin)(4, 6, fsr=1.0, bits=4)
    for jl, tl, v, xin in ((jd, td, v_d, x), (jc, tc, v_c, xc)):
        load_flax_variables(tl, v, device=CPU).eval()
        with torch.no_grad():
            fake = tl(_t(xin)).numpy()
        np.testing.assert_allclose(fake, np.asarray(jl.apply(v, jnp.asarray(xin), train=False)),
                                   rtol=1e-5, atol=1e-5)
        jp = jinfer.pack_model(jl, v, jnp.asarray(xin[:1]))
        tp = infer.pack_model(tl)
        for path in jp:
            np.testing.assert_array_equal(tp[path].packed.numpy().view(np.uint32),
                                          np.asarray(jp[path].packed))
        for a, b in ((tp, jp), (infer.prepare(tp), jinfer.prepare(jp))):
            got = infer.packed_apply(tl, a, _t(xin)).numpy()
            ref = np.asarray(jinfer.packed_apply(jl, v, b, jnp.asarray(xin)))
            np.testing.assert_allclose(got, ref, **GEMM_TOL)
            np.testing.assert_allclose(got, fake, rtol=2e-2, atol=2e-2)


def test_pack_model_refuses_quantized_inputs():
    """With quantize_input=True the fake-quant forward quantizes the input
    but every packed path would ignore it, as the JAX package's do."""
    for layer in (tnn.LinearQuantLog(8, 4, bits=4, quantize_input=True),
                  tnn.ConvQuantLin(3, 4, bits=4, quantize_input=True)):
        inner = layer.dense if hasattr(layer, "dense") else layer.conv
        assert inner.a_bits == 4
        with pytest.raises(NotImplementedError, match="quantize_input"):
            infer.pack_model(layer.eval())


# --- a small log LM ---------------------------------------------------------------

# tests/test_decode_engine.py:19-21's engine model, with W4 log weights
LOG_LM_CFG = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32,
                  scheme="log", w_bits=4, fsr=0.0)
LM_TOL = dict(rtol=2e-4, atol=2e-4)  # float32 LayerNorm and attention sums


@pytest.fixture(scope="module")
def log_lm():
    jm = JLM(**LOG_LM_CFG)
    v = jm.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 4), jnp.int32), train=False)
    v = jax.tree_util.tree_map(np.array, v)
    tm = load_flax_variables(models.QuantTransformerLM(**LOG_LM_CFG), v, device=CPU).eval()
    toks = np.random.default_rng(4).integers(0, 32, (3, 8)).astype(np.int32)
    return jm, v, tm, toks


def test_log_lm_fake_quant_logits_match_jax(log_lm):
    jm, v, tm, toks = log_lm
    ref = np.asarray(jm.apply(v, jnp.asarray(toks), train=False))
    with torch.no_grad():
        got = tm(_t(toks)).numpy()
    np.testing.assert_allclose(got, ref, **LM_TOL)


@pytest.mark.parametrize("prepared", [False, True], ids=["unprepared", "prepared"])
def test_log_lm_packed_decode_matches_jax(log_lm, prepared):
    """Prefill and a step of the decode model through packed_apply, port
    against JAX, on the same records (unprepared: K8 on every projection)."""
    jm, v, tm, toks = log_lm
    jp = jinfer.pack_model(jm, v, jnp.asarray(toks[:1]))
    tp = infer.pack_model(tm)
    assert set(tp) == set(jp) and len(tp) == 2 * 6
    for path in jp:
        np.testing.assert_array_equal(tp[path].packed.numpy().view(np.uint32),
                                      np.asarray(jp[path].packed))
    if prepared:
        jp, tp = jinfer.prepare(jp), infer.prepare(tp)
    md, tmd = jm.clone(decode=True), serve.decode_model(tm)
    ref, st = jinfer.packed_apply(md, {"params": v["params"]}, jp, jnp.asarray(toks), mutable=_MUT)
    got, cache = infer.packed_apply(tmd, tp, _t(toks), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LM_TOL)
    t = np.argmax(np.asarray(ref)[:, -1], -1).astype(np.int32)[:, None]
    ref, _ = jinfer.packed_apply(md, {"params": v["params"], "cache": st["cache"]}, jp,
                                 jnp.asarray(t), mutable=_MUT)
    got, _ = infer.packed_apply(tmd, tp, _t(t), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LM_TOL)


def test_log_lm_engine_serves_packed(log_lm):
    """DecodeEngine(packed=) over prepared records answers as the fake-quant
    generate does: the prepared path differs from fake-quant by float32 sum
    order only."""
    _, _, tm, _ = log_lm
    prompts = [np.random.default_rng(5).integers(0, 32, (n,)).astype(np.int32) for n in (4, 7)]
    eng = serve.DecodeEngine(tm, packed=infer.prepare(infer.pack_model(tm)), n_slots=2, device=CPU)
    try:
        got = [eng.submit(p, max_new=4).result(timeout=120) for p in prompts]
    finally:
        eng.shutdown()
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, serve.generate(tm, p[None], 4, device=CPU)[0].numpy())


def test_log_lm_refuses_quantized_activations():
    for scheme in ("log", "lin"):
        with pytest.raises(ValueError, match="a_bits unsupported"):
            models.QuantTransformerLM(**dict(LOG_LM_CFG, scheme=scheme, a_bits=4))
