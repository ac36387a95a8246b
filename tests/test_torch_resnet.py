"""PyTorch port of the DoReFa ResNet-20 serving paths, held against the JAX
package.

One set of seeded numpy variables in the flax layout (chip_smoke.py's, with
BatchNorm statistics calibrated so the block-conv input codes spread over
[0, 15]) drives the JAX ``DorefaResNet20`` and, through ``utils.bridge``,
the port's, at width 8 on 16x16 images.

Tolerances: the stem, the 1x1 projections, BatchNorm, the residual adds and
the pooled head are float32 sums that the two frameworks take in different
orders (about 1e-7 relative each). Every block conv is integer-exact, and
the codes between them are identical unless a value lands within that
rounding of a .5 boundary, which none does at these seeds. So logits agree
to 1e-5 (absolute, on logits of magnitude ~1), and the integer paths of the
port (packed unprepared and prepared, direct and im2col) agree with one
another bit for bit.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu_torch import infer, models
from pytorch_quantize_impls_tpu_torch.kernels import conv as tconv
from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
    flax_state_dict,
    load_flax_variables,
)

WIDTH = 8
SHAPE = (16, 16, 3)
TOL = dict(rtol=0, atol=1e-5)  # f32 sums in another order (module docstring)
A_QUANTS = ["fixed", "pact"]


def _resnet(a_quant):
    rng = np.random.default_rng(11 if a_quant == "fixed" else 12)
    calib = rng.normal(size=(8, *SHAPE)).astype(np.float32)
    tm, variables = chip_smoke.calibrated_resnet(WIDTH, rng, calib, "cpu", a_quant=a_quant)
    x = rng.normal(size=(3, *SHAPE)).astype(np.float32)
    jm = jmodels.DorefaResNet20(w_bits=4, a_bits=4, a_quant=a_quant, width=WIDTH)
    return jm, variables, tm, x


@pytest.fixture(scope="module", params=A_QUANTS)
def resnet(request):
    """(jax model, flax variables as numpy, port model, images), per a_quant."""
    return _resnet(request.param)


@pytest.fixture(scope="module")
def fixed_resnet():
    return _resnet("fixed")


@pytest.mark.parametrize("a_quant", A_QUANTS)
def test_bridge_loads_jax_init_strictly(a_quant):
    """The JAX model's own ``init`` loads strictly: PACT's scalar ``alpha``
    is carried, the ``losses`` collection (the sown alpha penalty) dropped."""
    jm = jmodels.DorefaResNet20(w_bits=4, a_bits=4, a_quant=a_quant, width=WIDTH)
    init = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *SHAPE)), train=False)
    v = jax.tree_util.tree_map(np.array, dict(init))
    assert ("losses" in v) == (a_quant == "pact")
    tm = models.DorefaResNet20(w_bits=4, a_bits=4, a_quant=a_quant, width=WIDTH)
    load_flax_variables(tm, v, device="cpu")
    assert set(flax_state_dict(v)) == set(tm.state_dict())
    k = v["params"]["stage1_block0"]["conv1"]["conv"]["kernel"]
    np.testing.assert_array_equal(tm.stage1_block0.conv1.conv.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
    if a_quant == "pact":
        alpha = tm.stage2_block1.conv2.act.alpha
        assert alpha.shape == () and float(alpha.detach()) == 6.0
    with pytest.raises(ValueError, match="no port counterpart"):
        flax_state_dict({**v, "intermediates": {}})


def test_seeded_variables_have_the_jax_tree(resnet):
    jm, variables, _, x = resnet
    init = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]), train=False)
    init = {k: init[k] for k in ("params", "batch_stats")}
    same = jax.tree_util.tree_map(lambda a, b: np.shape(a) == np.shape(b), init, variables)
    assert all(jax.tree_util.tree_leaves(same))


def test_block_conv_codes_spread(fixed_resnet):
    """The calibration works: the first block's input codes use the grid."""
    _, _, tm, x = fixed_resnet
    seen = []
    hook = tm.stage0_block0.conv1.conv.register_forward_pre_hook(
        lambda m, args: seen.append(torch.round(torch.clamp(args[0], 0, 1) * 15)))
    with torch.no_grad():
        tm(torch.from_numpy(x))
    hook.remove()
    counts = torch.bincount(seen[0].flatten().to(torch.int64), minlength=16)
    assert (counts > 0).sum() >= 12 and counts.max() < 0.9 * counts.sum()


def test_fake_quant_logits_match_jax(resnet):
    jm, variables, tm, x = resnet
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, ref, **TOL)


def test_pack_model_records_match_jax(resnet):
    jm, variables, tm, x = resnet
    jp = jinfer.pack_model(jm, variables, jnp.asarray(x[:1]))
    tp = infer.pack_model(tm)
    assert set(tp) == set(jp) and len(tp) == 18
    for path, jrec in jp.items():
        rec = tp[path]
        np.testing.assert_array_equal(rec.packed.numpy().view(np.uint32), np.asarray(jrec.packed))
        assert (rec.kind, rec.scheme, rec.w_bits, rec.a_bits, rec.kernel_shape) == (
            jrec.kind, jrec.scheme, jrec.w_bits, jrec.a_bits, jrec.kernel_shape)
    for rec in infer.prepare(tp).values():  # PACT: real inputs, f32 grid weights
        assert rec.decoded.dtype == (torch.int8 if rec.a_bits else torch.float32)


def test_packed_logits_match_jax(resnet):
    """Unprepared (K7 + K5 per conv) and prepared agree bit for bit (the conv
    path ignores prepare()'s buffer, as in JAX); both match JAX's packed
    forward and the fake-quant one."""
    jm, variables, tm, x = resnet
    jp = jinfer.pack_model(jm, variables, jnp.asarray(x[:1]))
    ref = np.asarray(jinfer.packed_apply(jm, variables, jinfer.prepare(jp), jnp.asarray(x)))
    tp = infer.pack_model(tm)
    got = infer.packed_apply(tm, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, infer.packed_apply(tm, infer.prepare(tp),
                                                          torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(got, ref, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got, tm(torch.from_numpy(x)).numpy(), **TOL)


def test_stride2_block_conv_direct_equals_im2col(fixed_resnet):
    """The first conv of stage 1 (stride 2, JAX's (0, 1) SAME pads) through
    K5 (direct) and through K6 on F.unfold patches (im2col), bit for bit."""
    _, _, tm, x = fixed_resnet
    conv = tm.stage1_block0.conv1.conv
    rec = infer.pack_model(tm)[("stage1_block0", "conv1", "conv")]
    kh, kw, cin, cout = rec.kernel_shape
    pc = tconv.PackedConv("dorefa", rec.packed, (kh, kw), cin, cout, None, 4, 4)
    seen = []
    hook = conv.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    with torch.no_grad():
        tm(torch.from_numpy(x))
    hook.remove()
    xq = conv.input_quant(seen[0])
    kw_ = dict(strides=conv.strides, padding=conv.padding)
    direct = tconv.packed_conv2d(xq, pc, **kw_)
    assert direct.shape == (3, 8, 8, 2 * WIDTH)
    np.testing.assert_array_equal(direct.numpy(),
                                  tconv.packed_conv2d(xq, pc, mode="im2col", **kw_).numpy())


def test_jax_artifact_loads_in_port(resnet, tmp_path):
    jm, variables, tm, x = resnet
    path = os.path.join(tmp_path, "jax.npz")
    jinfer.save_packed(path, jinfer.pack_model(jm, variables, jnp.asarray(x[:1])))
    ref = np.asarray(jinfer.packed_apply(jm, variables, jinfer.load_packed(path), jnp.asarray(x)))
    loaded = infer.load_packed(path, device="cpu")
    for rec in (loaded, infer.prepare(loaded)):
        np.testing.assert_allclose(infer.packed_apply(tm, rec, torch.from_numpy(x)).numpy(), ref,
                                   **TOL)


def test_port_artifact_loads_in_jax(resnet, tmp_path):
    jm, variables, tm, x = resnet
    path = os.path.join(tmp_path, "port.npz")
    tp = infer.pack_model(tm)
    infer.save_packed(path, tp)
    loaded = jinfer.load_packed(path)
    assert set(loaded) == set(tp)
    for p, rec in loaded.items():
        assert np.asarray(rec.packed).dtype == np.uint32
        np.testing.assert_array_equal(np.asarray(rec.packed), tp[p].packed.numpy().view(np.uint32))
        assert (rec.w_bits, rec.a_bits, rec.kernel_shape) == (
            tp[p].w_bits, tp[p].a_bits, tp[p].kernel_shape)
    ref = np.asarray(jinfer.packed_apply(jm, variables, loaded, jnp.asarray(x)))
    np.testing.assert_allclose(infer.packed_apply(tm, tp, torch.from_numpy(x)).numpy(), ref,
                               **TOL)


def test_fused_resnet_matches_jax_and_fake_quant(fixed_resnet):
    jm, variables, tm, x = fixed_resnet
    jnet = jinfer.export_fused_resnet20(jm, variables, first_dtype=jnp.float32)
    ref = np.asarray(jinfer.fused_resnet_apply(jnet, jnp.asarray(x)))
    net = infer.export_fused_resnet20(tm)
    for blk, jblk in zip(net.blocks, jnet.blocks):
        assert blk.w1.dtype == torch.int8 and blk.strides == jblk.strides
        np.testing.assert_array_equal(
            blk.w1.numpy(), np.asarray(jblk.w1).transpose(2, 0, 1, 3).reshape(blk.w1.shape))
        np.testing.assert_array_equal(blk.a1.numpy(), np.asarray(jblk.a1))
        np.testing.assert_array_equal(blk.b2.numpy(), np.asarray(jblk.b2))
    got = infer.fused_resnet_apply(net, torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, ref, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got, tm(torch.from_numpy(x)).numpy(), **TOL)


def test_fused_export_refuses_pact(resnet):
    """The JAX export ignores PACT's alpha (here drawn in [1, 2]), so its
    fused logits leave the model's by far more than any rounding; the port
    refuses instead."""
    jm, variables, _, x = resnet
    if jm.a_quant == "pact":
        ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
        jnet = jinfer.export_fused_resnet20(jm, variables, first_dtype=jnp.float32)
        drift = np.abs(np.asarray(jinfer.fused_resnet_apply(jnet, jnp.asarray(x))) - ref).max()
        assert drift > 100 * TOL["atol"]
    tm = models.DorefaResNet20(w_bits=4, a_bits=4, a_quant="pact", width=4)
    with pytest.raises(NotImplementedError, match="a_quant='fixed'"):
        infer.export_fused_resnet20(tm)
    with pytest.raises(ValueError, match="a_bits"):
        infer.export_fused_resnet20(models.DorefaResNet20(a_bits=0, width=4))


def test_fused_engine_answers_match_fused_apply(fixed_resnet):
    _, _, tm, _ = fixed_resnet
    net = infer.export_fused_resnet20(tm)
    engine = InferenceEngine.from_fused_resnet(net, SHAPE, batch_sizes=(1, 4), max_delay_ms=5.0,
                                               device="cpu")
    inputs = np.random.default_rng(6).normal(size=(6, *SHAPE)).astype(np.float32)
    answers = [None] * len(inputs)

    def client(idx):
        for i, f in [(i, engine.submit(inputs[i])) for i in idx]:
            answers[i] = f.result(timeout=60)

    threads = [threading.Thread(target=client, args=(range(c, 6, 2),)) for c in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        engine.shutdown()
    assert engine.stats.requests == 6
    # a row does not depend on the others in its padded batch
    ref = infer.fused_resnet_apply(net, torch.from_numpy(inputs)).numpy()
    np.testing.assert_allclose(np.stack(answers), ref, **TOL)


@pytest.mark.parametrize("name", ["dorefa_resnet20", "dorefa_resnet20_w4"])
def test_build_model_dorefa_resnet20(name):
    cfg = RunConfig(**SCHEME_CONFIGS[name])
    model, shape, data = build_model(cfg, device="cpu")
    assert (shape, data, model.width, model.w_bits) == ((32, 32, 3), "cifar10", 16, 4)
    conv = model.stage0_block1.conv2
    if name == "dorefa_resnet20":  # PACT: a clip per conv, real inputs to the packed path
        assert model.a_quant == "pact" and conv.act is not None and conv.conv.a_bits == 0
    else:
        assert model.a_bits == 0 and conv.act is None and conv.conv.input_quant is None
    with torch.no_grad():
        assert model.eval()(torch.zeros(2, *shape)).shape == (2, 10)
