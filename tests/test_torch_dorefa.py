"""PyTorch port of the DoReFa pieces, held against the JAX package.

Inputs are made with numpy from a seed and go through both packages: the JAX
Pallas kernels run in interpret mode on the CPU (as tests/test_kernels.py
runs them), the port's wrappers take their plain PyTorch versions (CPU
tensors). Quantizer grids, packed words, the K5/K6/K7 plain versions and the
decoded GEMM are integer-exact and compared bit for bit. The CUDA kernels
run on the card only, where chip_smoke.py holds them against the same plain
versions.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu import serve as jserve
from pytorch_quantize_impls_tpu.models.transformer import QuantTransformerLM as JLM
from pytorch_quantize_impls_tpu.ops import pack as jpack
from pytorch_quantize_impls_tpu_torch import infer, ops, serve
from pytorch_quantize_impls_tpu_torch.kernels import conv as tconv
from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as tic
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as tpm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as tsm
from pytorch_quantize_impls_tpu_torch.models import QuantTransformerLM
from pytorch_quantize_impls_tpu_torch.ops import pack as tpack
from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

jpm = sys.modules["pytorch_quantize_impls_tpu.kernels.packed_matmul"]
jconv = sys.modules["pytorch_quantize_impls_tpu.kernels.conv"]
CPU = "cpu"
DN = ("NHWC", "HWIO", "NHWC")


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# --- ops.dorefa, ops.pact ------------------------------------------------------


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_dorefa_weight_and_grad_match_jax(bits):
    rng = np.random.default_rng(bits)
    w = _normal(rng, 300, scale=0.7)
    g = _normal(rng, 300)
    wt = _t(w).requires_grad_(True)
    y = ops.dorefa_weight(wt, bits)
    (y * _t(g)).sum().backward()
    ref = np.asarray(jops.dorefa_weight(jnp.asarray(w), bits))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(jops.dorefa_weight(v, bits) * g))(jnp.asarray(w)))
    # tanh and the |w| mean are float ops whose last bit may differ between
    # the frameworks: values within 1 ulp of 1.0 (one k-bit level would be
    # >= 1/255), gradients (tanh' and the max-normalizer) within 1e-5
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=0, atol=2e-7)
    np.testing.assert_allclose(wt.grad.numpy(), jgrad, rtol=1e-5, atol=1e-6)
    if bits > 1:
        n = 2**bits - 1
        np.testing.assert_array_equal(
            tpack.dorefa_weight_to_codes(y.detach(), bits).numpy(),
            np.asarray(jpack.dorefa_weight_to_codes(jnp.asarray(ref), bits)),
        )
        assert set(np.unique(np.round((ref + 1) * n / 2))) <= set(range(n + 1))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_dorefa_activation_and_quantize_k_match_jax(bits):
    rng = np.random.default_rng(10 + bits)
    x = _normal(rng, 500, scale=1.5)
    g = _normal(rng, 500)
    xt = _t(x).requires_grad_(True)
    y = ops.dorefa_activation(xt, bits)
    (y * _t(g)).sum().backward()
    ref = np.asarray(jops.dorefa_activation(jnp.asarray(x), bits))
    jgrad = jax.grad(lambda v: jnp.sum(jops.dorefa_activation(v, bits) * g))(jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), ref)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))  # no x at exactly 0 or 1
    np.testing.assert_array_equal(
        ops.quantize_k(_t(np.abs(x) % 1), bits).numpy(),
        np.asarray(jops.quantize_k(jnp.asarray(np.abs(x) % 1), bits)),
    )
    codes = tpack.dorefa_act_to_codes(y.detach(), bits).numpy()
    np.testing.assert_array_equal(codes, np.asarray(jpack.dorefa_act_to_codes(jnp.asarray(ref), bits)))
    np.testing.assert_array_equal(
        tpack.codes_to_dorefa_weight(_t(codes), bits).numpy(),
        np.asarray(jpack.codes_to_dorefa_weight(jnp.asarray(codes), bits)),
    )


@pytest.mark.parametrize("bits,alpha", [(4, 2.0), (2, 0.7), (8, 6.0)])
def test_pact_and_grads_match_jax(bits, alpha):
    rng = np.random.default_rng(bits)
    x = _normal(rng, 400, scale=2.0)
    g = _normal(rng, 400)
    xt = _t(x).requires_grad_(True)
    at = torch.tensor(alpha, requires_grad=True)
    y = ops.pact(xt, at, bits)
    (y * _t(g)).sum().backward()

    def f(v, a):
        return jnp.sum(jops.pact(v, a, bits) * g)

    ref = np.asarray(jops.pact(jnp.asarray(x), jnp.float32(alpha), bits))
    gx, ga = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.float32(alpha))
    np.testing.assert_array_equal(y.detach().numpy(), ref)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx))
    # dL/dalpha is a float sum over the clipped entries, in another order
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), rtol=1e-5)


# --- packed words --------------------------------------------------------------


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("k", [25, 576, 2304])
def test_pack_dorefa_weights_words_match_jax(bits, k):
    rng = np.random.default_rng(bits * 7 + k)
    w = _normal(rng, k, 37, scale=0.5)
    # JAX's own fake-quant weights: the words must be bit-identical
    wq = np.asarray(jops.dorefa_weight(jnp.asarray(w), bits))
    jw = np.asarray(jpm.pack_dorefa_weights(jnp.asarray(wq), bits))
    tw = tpm.pack_dorefa_weights(_t(wq), bits)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw)
    # from the port's own dorefa_weight: tanh may differ by an ulp between
    # the frameworks, which could move a code sitting on a round-half
    # boundary; count such disagreements (none at these seeds)
    own = tpm.pack_dorefa_weights(ops.dorefa_weight(_t(w), bits), bits)
    diff = (tpack.unpack_bitplanes(own, bits, k) != tpack.unpack_bitplanes(tw, bits, k)).sum()
    assert int(diff) == 0


def test_dorefa_refusals():
    with pytest.raises(ValueError, match="w_bits=8"):
        tpm.pack_dorefa_weights(torch.zeros(8, 4), 8)
    with pytest.raises(ValueError, match="a_bits=8"):
        tpm.dorefa_act_to_int8(torch.zeros(8, 4), 8)
    with pytest.raises(ValueError, match="w_bits=8"):
        tpm.decode_dorefa_weights(torch.zeros(32, 4, dtype=torch.int32), w_bits=8)
    with pytest.raises(ValueError):  # K beyond the packed K (256 rows at 4 bits)
        tpm.dorefa_gemm(torch.ones(2, 257, dtype=torch.int8), torch.zeros(32, 4, dtype=torch.int32),
                        w_bits=4, a_bits=4)
    with pytest.raises(ValueError):  # packed rows not a whole group
        tpm.decode_dorefa_weights(torch.zeros(31, 4, dtype=torch.int32), w_bits=2)


# --- K6 dorefa_gemm, K7 decode_dorefa_weights, dorefa_gemm_decoded -------------


@pytest.mark.parametrize(
    "m,k,n,w_bits,a_bits",
    [
        (1, 576, 64, 4, 4),      # M = 1, K off the 256-row group (stage-0 conv)
        (33, 2304, 130, 4, 4),   # K = 2304 (stage-2 conv), ragged N
        (64, 1024, 96, 4, 2),
        (16, 1152, 32, 4, 1),
        (17, 300, 40, 2, 2),     # 512-row group
        (5, 700, 24, 2, 4),
        (8, 1500, 24, 1, 1),     # 1024-row group
        (3, 64, 8, 1, 4),
    ],
)
def test_dorefa_kernels_plain_match_jax(m, k, n, w_bits, a_bits):
    rng = np.random.default_rng(m * k + n + w_bits)
    wq = np.asarray(jops.dorefa_weight(jnp.asarray(_normal(rng, k, n)), w_bits))
    jw = jpm.pack_dorefa_weights(jnp.asarray(wq), w_bits)
    tw = _t(np.asarray(jw).view(np.int32))
    a = rng.integers(0, 2**a_bits, size=(m, k)).astype(np.int8)
    ref = np.asarray(jpm.dorefa_gemm(jnp.asarray(a), jw, w_bits=w_bits, a_bits=a_bits))
    got = tpm.dorefa_gemm(_t(a), tw, w_bits=w_bits, a_bits=a_bits)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpm.dorefa_gemm_reference(jnp.asarray(a), jw, w_bits=w_bits,
                                                           a_bits=a_bits)))
    # K7: every packed row decodes, padded rows to -n_w
    jdec = np.asarray(jpm.decode_dorefa_weights(jw, w_bits=w_bits))
    tdec = tpm.decode_dorefa_weights(tw, w_bits=w_bits)
    assert tdec.dtype == torch.int8 and tdec.shape == jdec.shape
    np.testing.assert_array_equal(tdec.numpy(), jdec)
    n_w = 2**w_bits - 1
    np.testing.assert_array_equal(tdec.numpy()[:k], np.round(wq * n_w).astype(np.int8))
    assert (tdec.numpy()[k:] == -n_w).all()
    # K3 with alpha = 1/(n_w n_a): the JAX function's bits, and K6's
    jd = np.asarray(jpm.dorefa_gemm_decoded(jnp.asarray(a), jnp.asarray(jdec), w_bits=w_bits,
                                            a_bits=a_bits))
    td = tpm.dorefa_gemm_decoded(_t(a), tdec, w_bits=w_bits, a_bits=a_bits)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(td.numpy(), got.numpy())


# --- K5 int8_conv2d and the packed conv ----------------------------------------


def _lax_conv_i32(x, w_flat, cin, kh, kw, strides, padding):
    """JAX's int8 conv with an int32 accumulator, on the flat weights."""
    w4 = np.asarray(w_flat).reshape(cin, kh, kw, -1).transpose(1, 2, 0, 3)
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w4), strides, padding, dimension_numbers=DN,
        preferred_element_type=jnp.int32,
    ))


@pytest.mark.parametrize(
    "b,hw,cin,cout,k,strides,padding",
    [
        (2, 32, 8, 16, 3, (2, 2), "SAME"),   # 32 -> 16, JAX pads (0, 1)
        (3, 16, 16, 16, 3, (1, 1), "SAME"),
        (2, 12, 5, 7, 5, (1, 1), "VALID"),   # 5x5 VALID, ragged channels
        (1, 9, 12, 20, 1, (2, 2), "SAME"),   # 1x1 stride 2
        (2, 15, 6, 8, 3, (2, 1), ((1, 2), (0, 1))),
    ],
)
def test_int8_conv_plain_matches_jax(b, hw, cin, cout, k, strides, padding):
    rng = np.random.default_rng(hw * cin + k)
    x = rng.integers(-15, 16, size=(b, hw, hw, cin)).astype(np.int8)
    w = rng.integers(-15, 16, size=(cin * k * k, cout)).astype(np.int8)
    acc = _lax_conv_i32(x, w, cin, k, k, strides, padding)
    pads = tconv.conv_pads(padding, (hw, hw), (k, k), strides)
    if isinstance(padding, str):
        assert pads == tuple(jax.lax.padtype_to_pads((hw, hw), (k, k), strides, padding))
    args = (_t(x), _t(w), (k, k), strides, pads)
    scale = _normal(rng, cout)
    a, bb = _normal(rng, cout, scale=0.05), _normal(rng, cout, scale=4.0)
    af = acc.astype(np.float32)
    np.testing.assert_array_equal(tic.int8_conv2d(*args).numpy(), af)
    np.testing.assert_array_equal(tic.int8_conv2d(*args, "scale", _t(scale)).numpy(),
                                  np.asarray(jnp.asarray(af) * scale))
    # the fused ResNet's epilogues, as jax computes them (y * a + b, round, clip)
    y = jnp.asarray(af) * a + bb
    np.testing.assert_array_equal(tic.int8_conv2d(*args, "affine", _t(a), _t(bb)).numpy(),
                                  np.asarray(y))
    codes = tic.int8_conv2d(*args, "codes", _t(a), _t(bb), 15)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jnp.clip(jnp.round(y), 0, 15).astype(jnp.int8)))


def test_same_padding_stride2_is_asymmetric_as_in_jax():
    """conv2d_nhwc (the fake-quant and float convs) pads SAME as JAX does:
    (0, 1) for a 3x3 stride-2 conv of a 32-wide input, not PyTorch's (1, 1)."""
    assert tconv.conv_pads("SAME", (32, 32), (3, 3), (2, 2)) == ((0, 1), (0, 1))
    rng = np.random.default_rng(3)
    x, w = _normal(rng, 2, 32, 32, 4), _normal(rng, 3, 3, 4, 6)
    ref = np.asarray(jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                                  dimension_numbers=DN))
    got = tconv.conv2d_nhwc(_t(x), _t(w.transpose(3, 2, 0, 1)), (2, 2), "SAME").numpy()
    assert got.shape == ref.shape == (2, 16, 16, 6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)  # float sums in another order


@pytest.mark.parametrize(
    "scheme,strides,padding,k",
    [("dorefa", (2, 2), "SAME", 3), ("dorefa", (1, 1), "SAME", 3), ("binary", (2, 2), "SAME", 3),
     ("xnor", (1, 1), "VALID", 5), ("dorefa", (2, 2), "SAME", 1)],
)
def test_packed_conv_direct_equals_im2col_and_jax(scheme, strides, padding, k):
    rng = np.random.default_rng(len(scheme) + k)
    cin, cout = 8, 12
    w_hwio = _normal(rng, k, k, cin, cout)
    x = _normal(rng, 2, 16, 16, cin)
    if scheme == "dorefa":
        w_hwio = np.asarray(jops.dorefa_weight(jnp.asarray(w_hwio), 4))
        x = np.asarray(jops.dorefa_activation(jnp.asarray(x), 4))
    jpc = jconv.pack_conv_weights(jnp.asarray(w_hwio), scheme, w_bits=4, a_bits=4)
    tpc = tconv.pack_conv_weights(_t(w_hwio.transpose(3, 2, 0, 1)), scheme, w_bits=4, a_bits=4)
    np.testing.assert_array_equal(tpc.packed.numpy().view(np.uint32), np.asarray(jpc.packed))
    if scheme == "xnor":  # a float mean, in another order
        np.testing.assert_allclose(tpc.alpha.numpy(), np.asarray(jpc.alpha), rtol=1e-6)
        tpc = tpc._replace(alpha=_t(np.asarray(jpc.alpha)))
    kw = dict(strides=strides, padding=padding)
    direct = tconv.packed_conv2d(_t(x), tpc, **kw)
    np.testing.assert_array_equal(direct.numpy(), tconv.packed_conv2d(_t(x), tpc, mode="im2col", **kw).numpy())
    ref = np.asarray(jconv.packed_conv2d(jnp.asarray(x), jpc, **kw))
    np.testing.assert_array_equal(direct.numpy(), ref)
    with pytest.raises(ValueError, match="unknown scheme"):  # not ported: ROADMAP queue 1
        tconv.packed_conv2d(_t(x), tpc._replace(scheme="ternary"))


def test_cpu_tensors_take_the_plain_versions_and_other_devices_raise():
    counters = (tpm.dorefa_gemm, tpm.decode_dorefa_weights, tic.int8_conv2d, tsm.shift_gemm,
                tsm.decode_log_weights)
    before = [f.launches for f in counters]
    wp = tpm.pack_dorefa_weights(torch.zeros(64, 8), 4)
    tpm.dorefa_gemm(torch.ones(4, 64, dtype=torch.int8), wp, w_bits=4, a_bits=4)
    tpm.decode_dorefa_weights(wp, w_bits=4)
    lp = tsm.pack_log_weights(torch.ones(64, 8), 1.0, 4)
    tsm.shift_gemm(torch.ones(4, 64), lp, fsr=1.0, bits=4)
    tsm.decode_log_weights(lp, fsr=1.0, bits=4)
    tic.int8_conv2d(torch.ones(1, 4, 4, 2, dtype=torch.int8), torch.ones(18, 3, dtype=torch.int8),
                    (3, 3), (1, 1), ((1, 1), (1, 1)))
    assert [f.launches for f in counters] == before
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpm.dorefa_gemm(torch.empty(4, 64, dtype=torch.int8, **meta),
                        torch.empty(32, 8, dtype=torch.int32, **meta), w_bits=4, a_bits=4)
    with pytest.raises(ValueError, match="unsupported device"):
        tpm.decode_dorefa_weights(torch.empty(32, 8, dtype=torch.int32, **meta), w_bits=4)
    with pytest.raises(ValueError, match="unsupported device"):
        tsm.shift_gemm(torch.empty(4, 64, **meta), torch.empty(32, 8, dtype=torch.int32, **meta),
                       fsr=1.0, bits=4)
    with pytest.raises(ValueError, match="unsupported device"):
        tsm.decode_log_weights(torch.empty(32, 8, dtype=torch.int32, **meta), fsr=1.0, bits=4)
    with pytest.raises(ValueError, match="unsupported device"):
        tic.int8_conv2d(torch.empty(1, 4, 4, 2, dtype=torch.int8, **meta),
                        torch.empty(18, 3, dtype=torch.int8, **meta), (3, 3), (1, 1),
                        ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="weight rows"):
        tic.int8_conv2d(torch.ones(1, 4, 4, 2, dtype=torch.int8), torch.ones(17, 3, dtype=torch.int8),
                        (3, 3), (1, 1), ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="needs a and b"):
        tic.int8_conv2d(torch.ones(1, 4, 4, 2, dtype=torch.int8), torch.ones(18, 3, dtype=torch.int8),
                        (3, 3), (1, 1), ((1, 1), (1, 1)), "codes")


# --- the W4A4 LM through DecodeEngine(packed=) ---------------------------------

# tests/test_decode_engine.py:91-94, the dorefa W4A4 case
LM_CFG = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32,
              scheme="dorefa", w_bits=4, a_bits=4)


@pytest.fixture(scope="module")
def w4a4_lm():
    jm = JLM(**LM_CFG)
    v = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 4), jnp.int32), train=False)
    v = jax.tree_util.tree_map(np.array, v)
    tm = load_flax_variables(QuantTransformerLM(**LM_CFG), v, device=CPU).eval()
    return jm, v, tm


def test_w4a4_lm_packed_records_match_jax(w4a4_lm):
    jm, v, tm = w4a4_lm
    jp = jinfer.pack_model(jm, v, jnp.zeros((1, 4), jnp.int32))
    tp = infer.pack_model(tm)
    assert set(tp) == set(jp) and len(tp) == 2 * 4 + 2 * 2
    for path, jrec in jp.items():
        rec = tp[path]
        assert (rec.scheme, rec.w_bits, rec.a_bits, rec.kernel_shape) == (
            jrec.scheme, jrec.w_bits, jrec.a_bits, jrec.kernel_shape)
        np.testing.assert_array_equal(rec.packed.numpy().view(np.uint32), np.asarray(jrec.packed))
    for path, rec in infer.prepare(tp).items():
        assert rec.decoded.dtype == torch.int8  # centered codes: the integer GEMM's buffer


@pytest.mark.parametrize("prepared", [False, True], ids=["unprepared", "prepared"])
def test_w4a4_lm_packed_engine_tokens_match_jax(w4a4_lm, prepared):
    """Greedy tokens of DecodeEngine(packed=) equal JAX ``serve.generate`` of
    the same model, as the JAX test holds its own packed engine
    (tests/test_decode_engine.py:83-115)."""
    jm, v, tm = w4a4_lm
    packed = infer.pack_model(tm)
    if prepared:
        packed = infer.prepare(packed)
    prompts = [np.random.default_rng(5).integers(0, 32, (n,)).astype(np.int32) for n in (4, 8, 6)]
    eng = serve.DecodeEngine(tm, packed=packed, n_slots=2, device=CPU)
    try:
        got = [eng.submit(p, max_new=4).result(timeout=120) for p in prompts]
    finally:
        eng.shutdown()
    for p, g in zip(prompts, got):
        ref = np.asarray(jserve.generate(jm, v["params"], jnp.asarray(p[None]), 4)[0])
        np.testing.assert_array_equal(g, ref)
