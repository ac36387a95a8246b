"""PyTorch port of the packed BNN LeNet path, held against the JAX package.

One set of seeded numpy variables (the ones chip_smoke.py builds, in the
flax layout) drives the JAX ``BNNLeNet`` and, through ``utils.bridge``, the
port's. After conv1 every value is an integer sum and each BatchNorm output
only feeds a sign, so the logits of the two packages are expected to be
identical: fake-quant, packed prepared (int8 GEMM) and packed unprepared
(1-bit GEMM), and across the ``.npz`` artifact in both directions.
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
from pytorch_quantize_impls_tpu_torch import infer, models, nn as tnn
from pytorch_quantize_impls_tpu_torch.infer import packed as tpacked
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
    flax_state_dict,
    load_flax_variables,
)

WIDTH = 8


@pytest.fixture(scope="module")
def lenet():
    """(jax model, jax variables, port model, input batch)."""
    rng = np.random.default_rng(0)
    variables = chip_smoke.seeded_variables(WIDTH, rng)
    x = rng.normal(size=(4, 28, 28, 1)).astype(np.float32)
    jm = jmodels.BNNLeNet(width=WIDTH)
    init = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]), train=False)
    same_tree = jax.tree_util.tree_map(lambda a, b: a.shape == b.shape, dict(init), variables)
    assert all(jax.tree_util.tree_leaves(same_tree))
    tm = load_flax_variables(models.BNNLeNet(width=WIDTH), variables, device="cpu").eval()
    return jm, variables, tm, x


def test_bridge_layouts(lenet):
    _, variables, tm, _ = lenet
    sd = flax_state_dict(variables)
    assert set(sd) == set(tm.state_dict())
    k1 = variables["params"]["conv2"]["conv"]["kernel"]  # HWIO
    np.testing.assert_array_equal(tm.conv2.conv.weight.detach().numpy(), k1.transpose(3, 2, 0, 1))
    kd = variables["params"]["fc1"]["dense"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(tm.fc1.dense.weight.detach().numpy(), kd.T)
    np.testing.assert_array_equal(
        tm.bn2.running_var.numpy(), variables["batch_stats"]["bn2"]["var"]
    )
    with pytest.raises(ValueError, match="no port counterpart"):
        flax_state_dict({"params": {"x": {"gamma": np.zeros(3)}}})


def test_fake_quant_logits_identical(lenet):
    jm, variables, tm, x = lenet
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 10)
    np.testing.assert_array_equal(got, ref)


def test_pack_model_words_match_jax(lenet):
    jm, variables, tm, x = lenet
    jp = jinfer.pack_model(jm, variables, jnp.asarray(x[:1]))
    tp = infer.pack_model(tm)
    assert set(tp) == set(jp) == {
        ("conv1", "conv"), ("conv2", "conv"), ("fc1", "dense"), ("head", "dense"),
    }
    for path, jrec in jp.items():
        rec = tp[path]
        np.testing.assert_array_equal(rec.packed.numpy().view(np.uint32), np.asarray(jrec.packed))
        assert (rec.kind, rec.scheme, rec.w_bits, rec.a_bits, rec.fsr, rec.kernel_shape) == (
            jrec.kind, jrec.scheme, jrec.w_bits, jrec.a_bits, jrec.fsr, jrec.kernel_shape,
        )
        assert rec.alpha is None and jrec.alpha is None


@pytest.mark.parametrize("prepared", [True, False], ids=["prepared", "unprepared"])
def test_packed_logits_identical(lenet, prepared):
    jm, variables, tm, x = lenet
    jp = jinfer.pack_model(jm, variables, jnp.asarray(x[:1]))
    tp = infer.pack_model(tm)
    if prepared:
        jp, tp = jinfer.prepare(jp), infer.prepare(tp)
        for path in jp:
            np.testing.assert_array_equal(tp[path].decoded.numpy(), np.asarray(jp[path].decoded))
    ref = np.asarray(jinfer.packed_apply(jm, variables, jp, jnp.asarray(x)))
    got = infer.packed_apply(tm, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    with torch.no_grad():
        np.testing.assert_array_equal(got, tm(torch.from_numpy(x)).numpy())


def test_jax_artifact_loads_in_port(lenet, tmp_path):
    jm, variables, tm, x = lenet
    path = os.path.join(tmp_path, "jax.npz")
    jinfer.save_packed(path, jinfer.pack_model(jm, variables, jnp.asarray(x[:1])))
    ref = np.asarray(jinfer.packed_apply(jm, variables, jinfer.load_packed(path), jnp.asarray(x)))
    loaded = infer.load_packed(path, device="cpu")
    for rec in (loaded, infer.prepare(loaded)):
        got = infer.packed_apply(tm, rec, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, ref)


def test_port_artifact_loads_in_jax(lenet, tmp_path):
    jm, variables, tm, x = lenet
    path = os.path.join(tmp_path, "port.npz")
    tp = infer.pack_model(tm)
    infer.save_packed(path, tp)
    loaded = jinfer.load_packed(path)
    assert set(loaded) == set(tp)
    for p, rec in loaded.items():
        assert np.asarray(rec.packed).dtype == np.uint32
        np.testing.assert_array_equal(np.asarray(rec.packed), tp[p].packed.numpy().view(np.uint32))
        assert rec.kernel_shape == tp[p].kernel_shape and rec.a_bits == tp[p].a_bits
    ref = np.asarray(jinfer.packed_apply(jm, variables, jinfer.prepare(loaded), jnp.asarray(x)))
    got = infer.packed_apply(tm, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_real_input_dense_branch_matches_jax():
    """``LinearBin`` without input binarization (a_bits=0) takes the
    float-input branch: decoded ±1 weights, float matmul."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    kernel = rng.normal(size=(64, 16)).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    variables = {"params": {"dense": {"kernel": kernel, "bias": bias}}}
    jl = jnn.LinearBin(features=16)
    ref = np.asarray(jinfer.packed_apply(jl, variables, jinfer.pack_model(jl, variables, jnp.asarray(x[:1])), jnp.asarray(x)))
    tl = load_flax_variables(tnn.LinearBin(64, 16), variables, device="cpu").eval()
    for tp in (infer.pack_model(tl), infer.prepare(infer.pack_model(tl))):
        got = infer.packed_apply(tl, tp, torch.from_numpy(x)).numpy()
        # real-valued sums: float32 rounding, order differs between packages
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_build_model_bnn_lenet():
    cfg = RunConfig(**SCHEME_CONFIGS["bnn_lenet"])
    model, shape, data = build_model(cfg, device="cpu")
    assert (shape, data, cfg.width, cfg.a_bits) == ((28, 28, 1), "mnist", 128, 1)
    assert tuple(model.fc1.dense.weight.shape) == (1024, 4096)
    assert tuple(model.conv2.conv.weight.shape) == (256, 128, 5, 5)
    with pytest.raises(ValueError, match="unknown config"):  # every JAX config is ported
        build_model(RunConfig(config="no_such_config"), device="cpu")


@pytest.mark.parametrize("scheme", ["ternary", "xnor"])
def test_unported_parts_raise(lenet, scheme):
    """What the packed paths refuse raises: pack_model on a learnable
    activation scale (act_scale, on the dense and the conv layer: the packed
    paths would drop it), and a scheme no package packs, in pack_model and
    in the packed forward. The XNOR net takes its compute dtype: packed at
    bf16 its logits are bf16 with the argmax of its bf16 fake-quant forward
    (the packed head adds alpha and the bias before its one rounding to
    bf16, the fake-quant head after, as in the JAX package)."""
    _, _, tm, x = lenet
    with pytest.raises(ValueError, match="act_scale"):
        infer.pack_model(tnn.LinearBin(8, 4, binarize_input=True, act_scale=True).eval())
    if scheme == "ternary":
        with pytest.raises(ValueError, match="act_scale"):
            infer.pack_model(tnn.BinConv(1, 4, (3, 3), binarize_input=True, act_scale=True))
    else:
        xm = tnn.init_like_flax(models.XNORConvNet(widths=(8, 8), dtype=torch.bfloat16,
                                                   image_shape=(8, 8, 1)), 0).eval()
        xb = torch.from_numpy(x[:, :8, :8]).bfloat16()
        got = infer.packed_apply(xm, infer.pack_model(xm), xb)
        with torch.no_grad():
            ref = xm(xb)
        assert got.dtype == ref.dtype == torch.bfloat16
        assert torch.equal(got.argmax(1), ref.argmax(1))
    with pytest.raises(ValueError, match="unpackable"):
        infer.pack_model(tnn.QuantDense(8, 4, scheme=f"{scheme}_stoch", w_bits=2).eval())
    rec = tpacked.PackedLayer(packed=torch.zeros(32, 4, dtype=torch.int32),
                              scheme=f"{scheme}_stoch", w_bits=4, a_bits=4, kernel_shape=(8, 4))
    with pytest.raises(ValueError, match="unpackable"):
        tpacked._dense_forward_2d(rec, torch.zeros(2, 8), None)
    tm.train()
    try:
        with pytest.raises(ValueError, match="eval"):
            infer.packed_apply(tm, infer.pack_model(tm), torch.from_numpy(x))
    finally:
        tm.eval()
