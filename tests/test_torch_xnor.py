"""PyTorch port of the XNOR-Net slice, held against the JAX package.

The XNOR scaling math, the XNOR layers, ``XNORConvNet`` (BASELINE config 3,
here at widths 16/16/32/32 on CIFAR-shaped images, the widths of
tests/test_fused_chain.py), its packed records and artifacts, and the binary
fused chains (the XNOR net and BNN LeNet at width 8) with K5's threshold
epilogue. Inputs and variables are made with numpy from a seed
(``chip_smoke.seeded_xnor_variables``, BatchNorm statistics calibrated on
seeded images) and go through both packages on the CPU, where the port's
kernel wrappers take their plain versions.

Tolerances: integer-exact things (packed words, codes, the threshold fold)
bit for bit; alpha, a float32 mean of up to 4,608 terms that XLA sums in
order and PyTorch pairwise, within 1e-6 relative (measured up to 7 ulp, the
JAX package's own mean being 6 ulp off the exact one; tests/test_torch_dorefa
holds the same alpha so), and an artifact carries its alpha, so logits from
one artifact see the same alpha in both packages; float layers within 1e-5; whole models by the JAX
package's own logit rule (tests/test_fused_chain.py:47-68): strict
``allclose(2e-4, 2e-4)``, else >= 99% of logits within it and every argmax
equal, because a value within an ulp of a sign boundary, summed in another
order by XLA and PyTorch, flips one code and moves a few logits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import nn as jnn
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu.infer import fused_chain as jfc
from pytorch_quantize_impls_tpu_torch import infer, models, nn as tnn, ops, serve
from pytorch_quantize_impls_tpu_torch.infer import fused_chain as tfc
from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as tic
from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads
from pytorch_quantize_impls_tpu_torch.models.lenet import max_pool_nhwc
from pytorch_quantize_impls_tpu_torch.ops import pack as tpack
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
    load_flax_variables,
)

CPU = "cpu"
WIDTHS = (16, 16, 32, 32)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)  # float32 sums in another order


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def assert_logits_match(got, ref, rtol=2e-4, atol=2e-4, min_within=0.99):
    """The JAX package's parity rule for whole binary models
    (tests/test_fused_chain.py:47-68), unchanged."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref) - (atol + rtol * np.abs(ref))
    if (err <= 0).all():
        return
    frac_bad = float((err > 0).mean())
    assert frac_bad <= 1 - min_within and (got.argmax(-1) == ref.argmax(-1)).all(), (
        f"{frac_bad:.1%} of logits out of tolerance, max err {float(err.max()):.3e}"
    )


# --- the scaling math and the layers ------------------------------------------


@pytest.mark.parametrize("shape", [(64, 10), (3, 3, 8, 16), (5, 5, 1, 4)])
def test_alpha_and_quantize_match_jax(shape):
    """Forward within 1e-6; gradients of sum(q * r) against jax.grad within
    1e-5 (alpha's 1/n term and the clipped STE on the sign)."""
    rng = np.random.default_rng(0)
    w = _normal(rng, *shape) * np.float32(0.8)
    w.flat[0] = 0.0  # sign(0) = +1 and |.|'s gradient at 0
    r = _normal(rng, *shape)
    np.testing.assert_allclose(ops.xnor_alpha(_t(w)).numpy(), np.asarray(jops.xnor_alpha(w)),
                               rtol=1e-6)
    ref_g = jax.jit(jax.grad(lambda v: jnp.sum(jops.xnor_quantize(v) * r)))(w)
    wt = _t(w).requires_grad_(True)
    q = ops.xnor_quantize(wt)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jops.xnor_quantize(w)), rtol=1e-6)
    (q * _t(r)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel_size", [(3, 3), (2, 2), (5, 5)])
def test_input_scale_map_matches_jax(kernel_size):
    x = _normal(np.random.default_rng(1), 2, 9, 11, 5)
    got = ops.xnor_input_scale_map(_t(x), kernel_size).numpy()
    ref = np.asarray(jops.xnor_input_scale_map(x, kernel_size))
    assert got.shape == ref.shape == (2, 9, 11, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("binarize, k_map, stride, padding", [
    (True, True, 1, "SAME"), (True, True, 2, "SAME"), (True, False, 1, "SAME"),
    (True, True, 1, "VALID"), (False, True, 1, "SAME"), (True, True, 2, "VALID"),
], ids=["kmap", "kmap-s2", "no-kmap", "valid-no-map", "real-input", "valid-s2"])
def test_xnor_conv_matches_jax(binarize, k_map, stride, padding):
    """Fake-quant XNORConv: the K map is sliced at stride 2 and multiplies
    the output only where padding is SAME."""
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 9, 9, 6)
    kernel = _normal(rng, 3, 3, 6, 8)
    bias = _normal(rng, 8)
    jl = jnn.XNORConv(features=8, strides=(stride, stride), padding=padding,
                      binarize_input=binarize, use_input_scale_map=k_map)
    v = {"params": {"conv": {"kernel": kernel, "bias": bias}}}
    ref = np.asarray(jl.apply(v, jnp.asarray(x), train=False))
    tl = tnn.XNORConv(6, 8, strides=(stride, stride), padding=padding, binarize_input=binarize,
                      use_input_scale_map=k_map)
    load_flax_variables(tl, v, device=CPU).eval()
    with torch.no_grad():
        got = tl(_t(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **LAYER_TOL)


@pytest.mark.parametrize("binarize", [False, True])
def test_xnor_linear_matches_jax(binarize):
    rng = np.random.default_rng(3)
    x = _normal(rng, 5, 40)
    v = {"params": {"dense": {"kernel": _normal(rng, 40, 12), "bias": _normal(rng, 12)}}}
    ref = np.asarray(jnn.XNORLinear(features=12, binarize_input=binarize).apply(
        v, jnp.asarray(x), train=False))
    tl = load_flax_variables(tnn.XNORLinear(40, 12, binarize_input=binarize), v, device=CPU)
    with torch.no_grad():
        np.testing.assert_allclose(tl(_t(x)).numpy(), ref, **LAYER_TOL)


# --- XNORConvNet ---------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["xnor", "fp32-first-last"])
def xnor(request):
    """The K-map-on XNOR net in both packages: a dict with the jax model, its
    variables, the port model, the images, the JAX records and JAX's forwards
    (jitted: op by op they take seconds to compile)."""
    fp32 = request.param
    rng = np.random.default_rng(10)
    variables = chip_smoke.seeded_xnor_variables(WIDTHS, rng, fp32_first_last=fp32)
    calib = _normal(rng, 32, 32, 32, 3)
    # the bridge loads strictly: the variables hold every port parameter
    tm, variables = chip_smoke.calibrated_xnor(
        models.XNORConvNet(widths=WIDTHS, fp32_first_last=fp32), variables, calib, CPU)
    jm = jmodels.XNORConvNet(widths=WIDTHS, fp32_first_last=fp32)
    x = _normal(rng, 6, 32, 32, 3)
    return dict(jm=jm, v=variables, tm=tm, x=x,
                jp=jax.jit(lambda v, x: jinfer.pack_model(jm, v, x))(variables,
                                                                    jnp.asarray(x[:1])),
                fake=jax.jit(lambda v, x: jm.apply(v, x, train=False)),
                packed=jax.jit(lambda v, p, x: jinfer.packed_apply(jm, v, p, x)))


def test_xnor_net_fake_quant_matches_jax(xnor):
    ref = np.asarray(xnor["fake"](xnor["v"], jnp.asarray(xnor["x"])))
    with torch.no_grad():
        got = xnor["tm"](_t(xnor["x"])).numpy()
    assert_logits_match(got, ref)


def test_xnor_pack_records_match_jax(xnor):
    """Words bit for bit; alpha within 1e-6 (a float32 mean, in another
    order); the metadata equal."""
    jp, tm = xnor["jp"], xnor["tm"]
    tp = infer.pack_model(tm)
    assert set(tp) == set(jp)
    assert len(tp) == len(WIDTHS) + 1 - 2 * tm.fp32_first_last
    for path, jrec in jp.items():
        rec = tp[path]
        np.testing.assert_array_equal(rec.packed.numpy().view(np.uint32), np.asarray(jrec.packed))
        np.testing.assert_allclose(rec.alpha.numpy(), np.asarray(jrec.alpha), rtol=1e-6)
        assert (rec.kind, rec.scheme, rec.w_bits, rec.a_bits, rec.kernel_shape) == (
            jrec.kind, jrec.scheme, jrec.w_bits, jrec.a_bits, jrec.kernel_shape)


@pytest.mark.parametrize("prepared", [False, True], ids=["unprepared", "prepared"])
def test_xnor_packed_apply_matches_jax(xnor, prepared):
    """K1/K3 are not reached (the head and conv0 take real inputs): hidden
    convs run K5 with alpha, conv0 and the head decoded +-1 (K2) with a
    float op and alpha after it. Both packages on the JAX records (the same
    alpha), and the port's own records against its fake-quant forward."""
    jp, tm, x = xnor["jp"], xnor["tm"], xnor["x"]
    port_recs = {path: infer.PackedLayer(
        packed=_t(np.asarray(r.packed).view(np.int32)), alpha=_t(np.asarray(r.alpha)),
        kind=r.kind, scheme=r.scheme, w_bits=r.w_bits, a_bits=r.a_bits, fsr=r.fsr,
        kernel_shape=r.kernel_shape) for path, r in jp.items()}
    own = infer.pack_model(tm)
    if prepared:
        jp = jax.jit(jinfer.prepare)(jp)
        port_recs, own = infer.prepare(port_recs), infer.prepare(own)
        for path in jp:
            np.testing.assert_array_equal(port_recs[path].decoded.numpy(),
                                          np.asarray(jp[path].decoded))
    ref = np.asarray(xnor["packed"](xnor["v"], jp, jnp.asarray(x)))
    assert_logits_match(infer.packed_apply(tm, port_recs, _t(x)).numpy(), ref)
    with torch.no_grad():
        fake = tm(_t(x)).numpy()
    assert_logits_match(infer.packed_apply(tm, own, _t(x)).numpy(), fake)


def test_xnor_artifacts_interchange(xnor, tmp_path):
    """A JAX artifact loads in the port and a port artifact in JAX, with
    words and alpha as written; each package's logits on the other's
    artifact agree with its own on it."""
    tm, x = xnor["tm"], xnor["x"]
    jpath, tpath = os.path.join(tmp_path, "jax.npz"), os.path.join(tmp_path, "port.npz")
    jinfer.save_packed(jpath, xnor["jp"])
    infer.save_packed(tpath, infer.pack_model(tm))
    for path in (jpath, tpath):
        jl, tl = jinfer.load_packed(path), infer.load_packed(path, device=CPU)
        assert set(jl) == set(tl)
        for p, rec in tl.items():
            np.testing.assert_array_equal(rec.packed.numpy().view(np.uint32),
                                          np.asarray(jl[p].packed))
            np.testing.assert_array_equal(rec.alpha.numpy(), np.asarray(jl[p].alpha))
        ref = np.asarray(xnor["packed"](xnor["v"], jl, jnp.asarray(x)))
        for recs in (tl, infer.prepare(tl)):
            assert_logits_match(infer.packed_apply(tm, recs, _t(x)).numpy(), ref)
    got = infer.packed_apply(tm, infer.load_packed(tpath, device=CPU), _t(x))
    np.testing.assert_array_equal(got.numpy(),
                                  infer.packed_apply(tm, infer.pack_model(tm), _t(x)).numpy())


def test_build_model_xnor_cifar():
    cfg = RunConfig(**SCHEME_CONFIGS["xnor_cifar"])
    model, shape, data = build_model(cfg, device=CPU)
    assert (shape, data, cfg.w_bits, cfg.a_bits) == ((32, 32, 3), "cifar10", 1, 1)
    assert model.widths == (128, 128, 256, 256, 512, 512) and model.use_input_scale_map
    assert tuple(model.conv3.conv.weight.shape) == (256, 256, 3, 3)
    assert tuple(model.head.dense.weight.shape) == (10, 4 * 4 * 512)
    assert model.conv0.conv.a_bits == 0 and model.conv1.conv.a_bits == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    # the compute dtype: every conv, BatchNorm and the head at bf16, float32 masters
    bf16 = models.XNORConvNet(dtype=torch.bfloat16)
    assert bf16.conv0.conv.dtype == bf16.bn3.dtype == bf16.head.dense.dtype == torch.bfloat16
    assert {p.dtype for p in bf16.parameters()} == {torch.float32}


# --- the binary fused chains and K5's threshold epilogue ------------------------


def test_binarize_epilogue_matches_jax():
    """(thr, hi, lo) bit for bit, with gamma = 0, gamma < 0 and alpha = 0
    channels among random ones."""
    rng = np.random.default_rng(4)
    n = 64
    gamma = _normal(rng, n)
    gamma[:4] = 0.0
    beta = _normal(rng, n)
    beta[1] = 0.0  # sign(0) = +1
    mean = _normal(rng, n, scale=3.0)
    s = np.sqrt(rng.uniform(0.1, 4.0, n).astype(np.float32) + np.float32(1e-5))
    alpha = rng.uniform(0.1, 1.0, n).astype(np.float32)
    alpha[[2, 5, 6]] = 0.0
    args = (gamma, beta, mean, s, alpha)
    ref = jfc._binarize_epilogue(*map(jnp.asarray, args))
    got = tfc._binarize_epilogue(*map(_t, args))
    for g, r in zip(got, ref):
        assert g.dtype == {np.float32: torch.float32, np.int8: torch.int8}[np.asarray(r).dtype.type]
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    thr, hi, lo = (g.numpy() for g in got)
    live = alpha != 0
    assert np.isneginf(thr[[0, 2, 5, 6]]).all() and (hi[live & (gamma < 0)] == -1).all()
    assert (hi[[0, 2, 5, 6]] == lo[[0, 2, 5, 6]]).all()


@pytest.mark.parametrize("case", ["3x3-same", "5x5-valid-odd-cout", "s2-packed"])
def test_threshold_epilogue_plain_matches_numpy(case):
    """The plain K5 with the threshold epilogue against a numpy where on the
    exact sum: ties (thresholds on integer sums) give hi, -inf always hi."""
    rng = np.random.default_rng(5)
    b, h, cin, cout, k, strides, padding, w_bits = {
        "3x3-same": (2, 8, 16, 24, 3, (1, 1), "SAME", 0),
        "5x5-valid-odd-cout": (3, 12, 8, 17, 5, (1, 1), "VALID", 0),
        "s2-packed": (2, 9, 12, 20, 3, (2, 2), "SAME", 1),
    }[case]
    x = np.where(rng.normal(size=(b, h, h, cin)) >= 0, 1, -1).astype(np.int8)
    wf = rng.normal(size=(cin * k * k, cout))
    w = np.where(wf >= 0, 1, -1).astype(np.int8)
    pads = conv_pads(padding, (h, h), (k, k), strides)
    acc = tic.int8_conv2d_reference(_t(x), _t(w), (k, k), strides, pads).numpy()
    # thresholds: integers (ties wherever the sum equals them), halves, -inf
    thr = rng.integers(-6, 7, cout).astype(np.float32)
    thr[::3] += 0.5
    thr[1] = -np.inf
    codes = np.stack([np.where(rng.uniform(size=cout) < 0.3, -1, 1),
                      np.where(rng.uniform(size=cout) < 0.7, -1, 1)]).astype(np.float32)
    want = np.where(acc >= thr, codes[0], codes[1]).astype(np.int8)
    assert (acc == thr).any(), "no tie in the case"
    wt = tpack.pack_bitplanes(_t((wf >= 0).astype(np.int32)), 1) if w_bits else _t(w)
    got = tic.int8_conv2d(_t(x), wt, (k, k), strides, pads, "threshold", _t(thr), _t(codes),
                          w_bits=w_bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="needs a and b"):
        tic.int8_conv2d(_t(x), _t(w), (k, k), strides, pads, "threshold", _t(thr))


@jax.jit
def _jax_stage_outputs(chain, x):
    """Each stage's output of the JAX package's fused_apply, after its pool
    (its loop, infer/fused_chain.py:407-433, stage by stage)."""
    dn = ("NHWC", "HWIO", "NHWC")
    h, outs = jnp.asarray(x), []
    for st in chain.stages:
        if st.dense:
            h = h.reshape(h.shape[0], -1)
            y = jnp.dot(h, st.w, preferred_element_type=jnp.int32).astype(jnp.float32)
        elif st.in_codes:
            y = jax.lax.conv_general_dilated(h, st.w, st.strides, st.padding, dimension_numbers=dn,
                                             preferred_element_type=jnp.int32).astype(jnp.float32)
        else:
            y = jax.lax.conv_general_dilated(h.astype(st.w.dtype), st.w, st.strides, st.padding,
                                             dimension_numbers=dn,
                                             preferred_element_type=jnp.float32)
        h = jnp.where(y >= st.thr, st.hi, st.lo) if st.thr is not None else y * st.scale + st.bias
        if st.pool:
            h = jfc._max_pool(h)
        outs.append(h)
    return outs


def _assert_stages_match(tchain, jchain, x):
    """Each hidden stage's codes equal on >= 99.9% of entries; the weights
    are the JAX chain's, in K5's layout."""
    got = [h.numpy() for h in tfc.fused_stage_outputs(tchain, _t(x))]
    ref = [np.asarray(r) for r in _jax_stage_outputs(jchain, jnp.asarray(x))]
    for i, (g, r, st) in enumerate(zip(got, ref, jchain.stages)):
        if st.thr is None:
            continue
        assert g.dtype == np.int8 and g.shape == r.shape
        assert (g == r).mean() >= 0.999, f"stage {i}: {(g != r).mean():.4%} of codes differ"
        w = np.asarray(st.w, np.float32)
        if st.in_codes and not st.dense:  # HWIO -> (cin, kh, kw) rows
            w = w.transpose(2, 0, 1, 3).reshape(-1, w.shape[-1])
        elif not st.dense:  # the real-input conv: HWIO -> OIHW
            w = w.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(tchain.stages[i].w.float().numpy(), w)


@pytest.mark.parametrize("fp32_first_last", [False, True], ids=["xnor", "fp32-first-last"])
def test_fused_chain_matches_jax(fp32_first_last):
    """fused_apply of the K-off XNOR net against JAX's fused_apply
    (first_dtype float32) and against the port's packed_apply, by the logit
    rule; every stage's codes against JAX's."""
    rng = np.random.default_rng(11)
    variables = chip_smoke.seeded_xnor_variables(WIDTHS, rng, fp32_first_last=fp32_first_last)
    tm, variables = chip_smoke.calibrated_xnor(
        models.XNORConvNet(widths=WIDTHS, use_input_scale_map=False,
                           fp32_first_last=fp32_first_last),
        variables, _normal(rng, 32, 32, 32, 3), CPU)
    jm = jmodels.XNORConvNet(widths=WIDTHS, use_input_scale_map=False,
                             fp32_first_last=fp32_first_last)
    x = _normal(rng, 6, 32, 32, 3)
    jchain = jax.jit(lambda v: jinfer.export_fused_chain(jm, v, first_dtype=jnp.float32))(
        variables)
    tchain = infer.export_fused_chain(tm, first_dtype=torch.float32)
    assert [st.in_codes for st in tchain.stages] == [False, True, True, True]
    assert tchain.stages[-1].thr is None and tchain.stages[-1].pool
    ref = np.asarray(jax.jit(jinfer.fused_apply)(jchain, jnp.asarray(x)))
    got = infer.fused_apply(tchain, _t(x)).numpy()
    assert_logits_match(got, ref)
    assert_logits_match(got, infer.packed_apply(tm, infer.pack_model(tm), _t(x)).numpy())
    _assert_stages_match(tchain, jchain, x)
    # JAX's default first_dtype rounds the pixels to bf16: the stage codes move
    bf16 = infer.fused_apply(infer.export_fused_chain(tm), _t(x)).numpy()
    assert bf16.shape == got.shape and np.isfinite(bf16).all()


def test_fused_lenet_matches_jax():
    rng = np.random.default_rng(12)
    variables = chip_smoke.seeded_variables(8, rng)
    x = _normal(rng, 6, 28, 28, 1)
    jm = jmodels.BNNLeNet(width=8)
    tm = load_flax_variables(models.BNNLeNet(width=8), variables, device=CPU).eval()
    jchain = jax.jit(lambda v: jinfer.export_fused_lenet(jm, v, first_dtype=jnp.float32))(
        variables)
    tchain = infer.export_fused_lenet(tm, first_dtype=torch.float32)
    assert [(st.in_codes, st.dense, st.pool) for st in tchain.stages] == [
        (False, False, True), (True, False, True), (True, True, False)]
    ref = np.asarray(jax.jit(jinfer.fused_apply)(jchain, jnp.asarray(x)))
    got = infer.fused_apply(tchain, _t(x)).numpy()
    assert_logits_match(got, ref)
    assert_logits_match(got, infer.packed_apply(tm, infer.pack_model(tm), _t(x)).numpy())
    _assert_stages_match(tchain, jchain, x)


def test_fused_chain_refusals():
    for kw in (dict(), dict(binarize_inputs=False, use_input_scale_map=False)):
        with pytest.raises(ValueError, match="use_input_scale_map|binarize_inputs"):
            infer.export_fused_chain(models.XNORConvNet(widths=(8, 8), **kw))


def test_max_pool_matches_jax_valid_pool():
    """2x2 VALID max pool on int8 codes and on floats: an odd last row and
    column are dropped, as in the JAX chain's reduce_window."""
    rng = np.random.default_rng(6)
    codes = np.where(rng.normal(size=(2, 5, 7, 3)) >= 0, 1, -1).astype(np.int8)
    y = _normal(rng, 2, 5, 7, 3)
    for a in (codes, y):
        got = max_pool_nhwc(_t(a))
        assert got.dtype == _t(a).dtype and tuple(got.shape) == (2, 2, 3, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfc._max_pool(jnp.asarray(a))))


def test_engine_serves_fused_chain():
    rng = np.random.default_rng(13)
    variables = chip_smoke.seeded_variables(8, rng)
    tm = load_flax_variables(models.BNNLeNet(width=8), variables, device=CPU).eval()
    chain = infer.export_fused_lenet(tm, first_dtype=torch.float32)
    xs = [_normal(rng, 28, 28, 1) for _ in range(5)]
    eng = serve.InferenceEngine.from_fused_chain(chain, (28, 28, 1), batch_sizes=(1, 4),
                                                 device=CPU)
    try:
        got = [f.result(timeout=120) for f in [eng.submit(x) for x in xs]]
    finally:
        eng.shutdown()
    ref = infer.fused_apply(chain, _t(np.stack(xs))).numpy()
    np.testing.assert_array_equal(np.stack(got), ref)
    assert eng.stats.requests == 5
