"""The last of the digits scheme zoo in the port, held against the JAX
package: the learnable activation scale (``act_scale``, config
``bnn_lenet_as``), ``ShiftNormBatch``, the XNOR digits convnets
(``xnor_digits``: binary weights, real activations; ``xnor_digits_a1``: full
XNOR) and the three configs.

Inputs and variables are made with numpy from a seed and go through both
packages on the CPU, where the port's kernel wrappers take their plain
versions. Tolerances: float32 sums in another order within 1e-5 (layers,
gradients, BatchNorm statistics; alpha and the act_scale gradient, sums over
batch and space, are such sums); whole binary models by the JAX package's
logit rule (tests/test_fused_chain.py:47-68); the training steps by
``tests/_torch_train_helpers.steps_against_jax`` in float64; packed words
and AP2 scales bit for bit. ``ShiftNormBatch``'s inputs keep every scale at
least 1e-4 relative away from a rounding point 2^(k+1/2) of AP2, where
XLA's inexact CPU ``log2`` could round to the other power.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import nn as jnn
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu.infer import fused_chain as jfc
from pytorch_quantize_impls_tpu.nn.binary import _ap2 as jax_ap2
from pytorch_quantize_impls_tpu.utils.config import SCHEME_CONFIGS as JCONFIGS
from pytorch_quantize_impls_tpu.utils.config import RunConfig as JRunConfig
from pytorch_quantize_impls_tpu.utils.config import build_model as jbuild_model
from pytorch_quantize_impls_tpu_torch import infer, models, nn as tnn, ops, serve, train
from pytorch_quantize_impls_tpu_torch.infer import host_export
from pytorch_quantize_impls_tpu_torch.kernels.conv import PackedConv, packed_conv2d
from pytorch_quantize_impls_tpu_torch.nn.binary import _ap2
from pytorch_quantize_impls_tpu_torch.train import run as trun
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    bridge,
    build_model,
    flax_variables,
    load_flax_variables,
)
from _torch_train_helpers import steps_against_jax

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)
DIGITS = (8, 8, 1)
NEW = ("bnn_lenet_as", "xnor_digits", "xnor_digits_a1")


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _grad_close(got, ref):
    """Within 1e-5 of the tensor's largest entry (float32 sums in another
    order)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def _jax_params_grads(layer, variables, x, r):
    """JAX's output and the gradients of sum(y * r) by params and x, in
    training mode."""
    def loss(p, xv):
        y = layer.apply({"params": p}, xv, train=True)
        return jnp.sum(y * r), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], x)
    return np.asarray(y), gp, np.asarray(gx)


# --- act_scale -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_act_scale_layer_matches_jax(kind):
    """LinearBin and BinConv with binarized inputs and g in [0.5, 2]: the
    forward, and the gradients of the kernel, the bias, g and the input,
    against JAX's in training mode; g is a parameter of the wrapper (flax
    path ``("act_scale",)``, state key ``act_scale``) and its layer's sums
    are not rounded to integers."""
    rng = np.random.default_rng(1)
    if kind == "dense":
        x, cin = _normal(rng, 6, 40), 40
        kernel = _normal(rng, 40, 8, scale=0.3)
        jl = jnn.LinearBin(features=8, binarize_input=True, act_scale=True)
        tl = tnn.LinearBin(40, 8, binarize_input=True, act_scale=True)
        inner = "dense"
    else:
        x, cin = _normal(rng, 2, 7, 7, 5), 5
        kernel = _normal(rng, 3, 3, 5, 8, scale=0.3)
        jl = jnn.BinConv(features=8, binarize_input=True, act_scale=True)
        tl = tnn.BinConv(5, 8, (3, 3), binarize_input=True, act_scale=True)
        inner = "conv"
    g = rng.uniform(0.5, 2.0, cin).astype(np.float32)
    v = {"params": {"act_scale": g, inner: {"kernel": kernel, "bias": _normal(rng, 8)}}}
    r = _normal(rng, *jax.eval_shape(lambda: jl.apply(v, x)).shape)
    ref, gp, gx = _jax_params_grads(jl, v, jnp.asarray(x), r)
    load_flax_variables(tl, v, device=CPU).train()
    assert list(dict(tl.named_parameters())) == ["act_scale", f"{inner}.weight", f"{inner}.bias"]
    xt = _t(x).requires_grad_(True)
    y = tl(xt)
    np.testing.assert_allclose(y.detach().numpy(), ref, **TOL)
    (y * _t(r)).sum().backward()
    grads = _flax_grads(tl)
    _grad_close(grads[("act_scale",)], gp["act_scale"])
    _grad_close(grads[(inner, "kernel")], gp[inner]["kernel"])
    _grad_close(grads[(inner, "bias")], gp[inner]["bias"])
    _grad_close(xt.grad.numpy(), gx)
    layer = getattr(tl, inner)
    assert getattr(layer, "_integer_sums", False) is False
    sums = layer.fake_quant_forward(_t(x)) - layer.bias
    assert float((sums - sums.round()).detach().abs().max()) > 1e-3  # +-g: not integers


def _flax_grads(module):
    """Each parameter's gradient by its flax path, in flax's layout."""
    params = dict(module.named_parameters())
    return {path: bridge._to_flax_layout(path[-1], params[k].grad.numpy())
            for k, (_, path) in bridge.flax_paths(module).items() if k in params}


def test_act_scale_folds_into_the_kernel():
    """tests/test_layers.py:237-256: a per-input-channel g commutes into the
    binarized kernel, ``conv(g sign(x), Wb) == conv(sign(x), g Wb)``."""
    from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc

    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 8, 8, 3)
    layer = tnn.BinConv(3, 4, (3, 3), binarize_input=True, act_scale=True, use_bias=False)
    with torch.no_grad():
        layer.act_scale.copy_(_t(rng.uniform(0.5, 2.0, 3).astype(np.float32)))
        y = layer(_t(x))
        wq = ops.binary_connect_det(layer.conv.weight) * layer.act_scale[None, :, None, None]
        ref = conv2d_nhwc(ops.binary_tanh(_t(x)), wq, (1, 1), "SAME")
    np.testing.assert_allclose(y.numpy(), ref.numpy(), **TOL)


def test_act_scale_only_on_binarized_inputs():
    """No parameter without ``binarize_input`` (as JAX, which makes g inside
    its input binarizer); LeNet's conv1 (real pixels) has none; the plain
    binarized layer keeps its integer sums."""
    for layer in (tnn.LinearBin(8, 4, act_scale=True), tnn.BinConv(3, 4, act_scale=True)):
        assert layer.act_scale is None and "act_scale" not in dict(layer.named_parameters())
    assert tnn.BinConv(3, 4, binarize_input=True).conv._integer_sums
    assert not tnn.BinConv(3, 4, binarize_input=True, act_scale=True).conv._integer_sums
    lenet = models.BNNLeNet(width=8, act_scale=True)
    scaled = {k: tuple(v.shape) for k, v in lenet.state_dict().items() if "act_scale" in k}
    assert scaled == {"conv2.act_scale": (8,), "fc1.act_scale": (256,), "head.act_scale": (64,)}


def test_act_scale_bridge_init_and_clamp():
    """g round-trips through flax_variables / load_flax_variables; init is
    ones; a deep copy scales by its own g; the clamp after a step (and
    clip_params) leaves a g of 1.5 at 1.5 and clips the kernels."""
    import copy

    model = tnn.init_like_flax(models.BNNLeNet(width=8, act_scale=True), 0)
    assert all(torch.equal(p, torch.ones_like(p)) for k, p in model.named_parameters()
               if k.endswith("act_scale"))
    with torch.no_grad():
        model.fc1.act_scale.fill_(1.5)
        model.conv2.conv.weight.mul_(40.0)
    v = flax_variables(model)
    assert v["params"]["fc1"]["act_scale"].shape == (256,) and "act_scale" not in v["params"]["conv1"]
    other = load_flax_variables(models.BNNLeNet(width=8, act_scale=True), v, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 other.state_dict().values()))
    twin = copy.deepcopy(model)
    with torch.no_grad():
        twin.fc1.act_scale.fill_(0.5)
    assert float(model.fc1.act_scale.detach()[0]) == 1.5
    assert twin.fc1.dense.input_quant.__self__ is twin.fc1
    train.clip_params(model)
    assert float(model.fc1.act_scale.min()) == float(model.fc1.act_scale.max()) == 1.5
    assert float(model.conv2.conv.weight.abs().max()) <= 1.0
    clamped = {id(p) for p, _ in train.clip_quantized_weights(model).params}
    assert id(model.fc1.act_scale) not in clamped and id(model.fc1.dense.weight) in clamped


# --- ShiftNormBatch ------------------------------------------------------------


def _away_from_rounding_points(s):
    """Every |s| at least 1e-4 relative away from 2^(k+1/2)."""
    e = np.log2(np.abs(np.asarray(s, np.float64)))
    nearest = 2.0 ** (np.floor(e) + 0.5)
    return bool((np.abs(np.abs(s) / nearest - 1) >= 1e-4).all())


def test_shift_norm_batch_matches_jax():
    """Train forward (batch statistics), the running statistics after two
    updates (momentum 0.9), the eval forward on them, and the gradients of
    x, scale and bias against JAX's; the AP2 scales exact powers of two,
    equal in both packages."""
    rng = np.random.default_rng(5)
    x1 = _normal(rng, 16, 8) * 3 + 1
    x2 = _normal(rng, 16, 8) * 2 - 0.5
    gamma = rng.uniform(0.2, 3.0, 8).astype(np.float32) * np.where(rng.uniform(size=8) < 0.25, -1, 1)
    beta = _normal(rng, 8, scale=0.3)
    r = _normal(rng, 16, 8)
    jl = jnn.ShiftNormBatch()

    @jax.jit
    def jax_train_step(params, stats, xv):
        def loss(p, xv):
            out, new = jl.apply({"params": p, "batch_stats": stats}, xv, train=True,
                                mutable=["batch_stats"])
            return jnp.sum(out * r), (out, new)

        return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, xv)
    v = {"params": {"scale": gamma.astype(np.float32), "bias": beta},
         "batch_stats": {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}}
    tl = tnn.ShiftNormBatch(8).train()
    with torch.no_grad():
        tl.weight.copy_(_t(gamma))
        tl.bias.copy_(_t(beta))
    stats = v["batch_stats"]
    for x in (x1, x2):
        scale = gamma / np.sqrt(x.astype(np.float64).var(0) + 1e-5)
        assert _away_from_rounding_points(scale)
        (_, (ref, new)), (gp, gx) = jax_train_step(v["params"], stats, jnp.asarray(x))
        xt = _t(x).requires_grad_(True)
        y = tl(xt)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **TOL)
        (y * _t(r)).sum().backward()
        _grad_close(xt.grad.numpy(), gx)
        _grad_close(tl.weight.grad.numpy(), gp["scale"])
        _grad_close(tl.bias.grad.numpy(), gp["bias"])
        tl.zero_grad()
        stats = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
        np.testing.assert_allclose(tl.running_mean.numpy(), stats["mean"], **TOL)
        np.testing.assert_allclose(tl.running_var.numpy(), stats["var"], **TOL)
    tl.eval()
    scale = gamma / np.sqrt(stats["var"].astype(np.float64) + 1e-5)
    assert _away_from_rounding_points(scale)
    got_ap2 = _ap2(tl.weight.detach() * torch.rsqrt(tl.running_var + 1e-5)).numpy()
    ref_ap2 = np.asarray(jax_ap2(jnp.asarray(gamma) * jax.lax.rsqrt(jnp.asarray(stats["var"]) + 1e-5)))
    np.testing.assert_array_equal(got_ap2, ref_ap2)
    e = np.log2(np.abs(got_ap2))
    assert (e == np.round(e)).all() and (np.sign(got_ap2) == np.sign(gamma)).all()
    ref = jl.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x1), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(tl(_t(x1)).numpy(), np.asarray(ref), **TOL)
    v = flax_variables(torch.nn.ModuleDict({"sn": tl}))  # BatchNorm's flax names
    assert {k: set(c["sn"]) for k, c in v.items()} == {"params": {"scale", "bias"},
                                                        "batch_stats": {"mean", "var"}}


# --- the configs ----------------------------------------------------------------


def test_scheme_configs_equal_jax():
    assert list(SCHEME_CONFIGS) == list(JCONFIGS) and len(SCHEME_CONFIGS) == 15
    assert SCHEME_CONFIGS == JCONFIGS
    with pytest.raises(ValueError, match="unknown config"):
        build_model(RunConfig(config="no_such_config"), device=CPU)


def _jax_tree(name, fp32, shape):
    jm = jbuild_model(JRunConfig(**JCONFIGS[name]), fp32=fp32)[0]
    tree = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
                          jnp.zeros((1, *shape), jnp.float32))
    return jm, {jax.tree_util.keystr(p): tuple(a.shape)
                for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("fp32", [False, True], ids=["quantized", "twin"])
@pytest.mark.parametrize("name", NEW)
def test_new_configs_build_with_jax_tree(name, fp32):
    """Each new config and its twin build on the CPU with the JAX model's
    variable tree: every path and shape; the model's metadata as JAX's."""
    model, shape, data = build_model(RunConfig(**SCHEME_CONFIGS[name]), fp32=fp32, device=CPU)
    assert (shape, data) == ({"bnn_lenet_as": ((28, 28, 1), "mnist")}.get(
        name, (DIGITS, "digits")))
    _, tree = _jax_tree(name, fp32, shape)
    v = flax_variables(model)
    got = {jax.tree_util.keystr(p): tuple(a.shape)
           for p, a in jax.tree_util.tree_flatten_with_path(v)[0]}
    assert got == tree
    if name.startswith("xnor") and not fp32:
        assert model.fp32_first_last and model.widths == ((32, 64) if name == "xnor_digits"
                                                          else (128, 128))
        assert model.binarize_inputs == (name == "xnor_digits_a1")
        assert model.conv1.conv.a_bits == (name == "xnor_digits_a1")


def _seeded(name, rng, fp32=False):
    """(port model in eval mode, flax variables, JAX model, input shape) from
    seeded variables: the XNOR nets with BatchNorm calibrated on seeded
    images, LeNet with chip_smoke.seeded_variables and g in [0.5, 2]."""
    cfg = RunConfig(**SCHEME_CONFIGS[name])
    if name == "bnn_lenet_as":
        cfg.width = 16
    model, shape, _ = build_model(cfg, fp32=fp32, device=CPU)
    jm = jbuild_model(JRunConfig(**{**JCONFIGS[name], "width": cfg.width}), fp32=fp32)[0]
    if fp32:
        return model.eval(), flax_variables(model), jm, shape
    if name == "bnn_lenet_as":
        v = chip_smoke.seeded_variables(16, rng)
        for layer, n in (("conv2", 16), ("fc1", 512), ("head", 128)):
            v["params"][layer]["act_scale"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        return load_flax_variables(model, v, device=CPU).eval(), v, jm, shape
    v = chip_smoke.seeded_xnor_variables(model.widths, rng, fp32_first_last=True,
                                         image_shape=DIGITS)
    model, v = chip_smoke.calibrated_xnor(model, v, _normal(rng, 64, *DIGITS), CPU)
    return model, v, jm, shape


@pytest.mark.parametrize("fp32", [False, True], ids=["quantized", "twin"])
@pytest.mark.parametrize("name", NEW)
def test_new_configs_logits_match_jax(name, fp32):
    """Eval logits on seeded variables: the quantized models by the JAX
    logit rule (the K map, alpha and g are float), the twins within 1e-5."""
    rng = np.random.default_rng(7)
    model, v, jm, shape = _seeded(name, rng, fp32)
    x = _normal(rng, 16, *shape)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = model(_t(x)).numpy()
    assert got.shape == (16, 10) and np.isfinite(got).all()
    if fp32:
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        chip_smoke_rule(got, ref)


def chip_smoke_rule(got, ref, rtol=2e-4, atol=2e-4, min_within=0.99):
    """The JAX package's parity rule for whole binary models
    (tests/test_fused_chain.py:47-68)."""
    err = np.abs(np.asarray(got, np.float64) - ref) - (atol + rtol * np.abs(ref))
    if (err <= 0).all():
        return
    assert float((err > 0).mean()) <= 1 - min_within
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()


def test_k_map_at_the_digits_size():
    """The K map's SAME window on 8x8 (a border share of 28 of 64 pixels)
    and full-XNOR conv1 of xnor_digits_a1's shape (128 -> 128, cut to 16),
    fake-quant, against JAX."""
    rng = np.random.default_rng(8)
    x = _normal(rng, 4, 8, 8, 16)
    np.testing.assert_allclose(ops.xnor_input_scale_map(_t(x), (3, 3)).numpy(),
                               np.asarray(jops.xnor_input_scale_map(x, (3, 3))), rtol=1e-6,
                               atol=1e-6)
    v = {"params": {"conv": {"kernel": _normal(rng, 3, 3, 16, 16, scale=0.3)}}}
    ref = jnn.XNORConv(features=16, binarize_input=True, use_bias=False).apply(
        v, jnp.asarray(x), train=False)
    tl = load_flax_variables(tnn.XNORConv(16, 16, binarize_input=True, use_bias=False), v,
                             device=CPU)
    with torch.no_grad():
        np.testing.assert_allclose(tl(_t(x)).numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name, width", [("xnor_digits_a1", 16), ("bnn_lenet_as", 16)])
def test_steps_match_jax(name, width):
    """Three teacher-forced training steps in float64 against JAX's
    (tests/_torch_train_helpers.steps_against_jax), at a cut width, after
    one step of JAX's alone. LeNet's g start drawn in [0.5, 2], as a trained
    model's are. Why width 16: conv2's sums of +-g terms tie in a pool window
    where two positions have the same sign count in every input channel;
    with 8 channels (several saturated after bn1) 1-9 of 8192 windows per
    step tie so, the two packages round the tied sums apart and the pool's
    gradient goes to another position (plain bnn_lenet rounds its integer
    sums exact, and ties the same in both); with 16 none does in these
    steps."""
    rng = np.random.default_rng(9)
    cfg = RunConfig(**{**SCHEME_CONFIGS[name], "width": width})
    tm, shape, _ = build_model(cfg, device=CPU)
    jm = jbuild_model(JRunConfig(**{**JCONFIGS[name], "width": width}))[0]
    if name == "bnn_lenet_as":
        with torch.no_grad():
            for layer in (tm.conv2, tm.fc1, tm.head):
                layer.act_scale.copy_(_t(rng.uniform(0.5, 2.0, layer.act_scale.shape)))
    x = _normal(rng, 128, *shape)
    y = rng.integers(0, 10, 128).astype(np.int32)
    ts = steps_against_jax(jm, tm, x, y, first_step=1)
    assert ts.step == 4


# --- serving -------------------------------------------------------------------


@pytest.fixture(scope="module", params=["xnor_digits", "xnor_digits_a1"])
def digits_net(request):
    rng = np.random.default_rng(11)
    model, v, jm, shape = _seeded(request.param, rng)
    x = _normal(rng, 8, *shape)
    return dict(name=request.param, tm=model, v=v, jm=jm, x=x,
                packed=jax.jit(lambda v, p, x: jinfer.packed_apply(jm, v, p, x)))


def test_digits_artifacts_match_jax(digits_net, tmp_path):
    """JAX's artifact in the port and the port's in JAX: words and alpha as
    written, each package's packed_apply on either artifact (unprepared and
    prepared in the port) by the JAX logit rule; the port's records against
    its fake-quant forward. xnor_digits' conv1 takes real inputs (K2 decode,
    a float conv, alpha); xnor_digits_a1's binarized ones (K5 with alpha,
    the K map after it)."""
    tm, jm, v, x = digits_net["tm"], digits_net["jm"], digits_net["v"], digits_net["x"]
    jp = jax.jit(lambda v, x: jinfer.pack_model(jm, v, x))(v, jnp.asarray(x[:1]))
    assert set(jp) == {("conv1", "conv")}
    assert jp[("conv1", "conv")].a_bits == int(digits_net["name"] == "xnor_digits_a1")
    jpath, tpath = os.path.join(tmp_path, "jax.npz"), os.path.join(tmp_path, "port.npz")
    jinfer.save_packed(jpath, jp)
    infer.save_packed(tpath, infer.pack_model(tm))
    for path in (jpath, tpath):
        jl, tl = jinfer.load_packed(path), infer.load_packed(path, device=CPU)
        for p, rec in tl.items():
            np.testing.assert_array_equal(rec.packed.numpy().view(np.uint32),
                                          np.asarray(jl[p].packed))
            np.testing.assert_array_equal(rec.alpha.numpy(), np.asarray(jl[p].alpha))
        ref = np.asarray(digits_net["packed"](v, jl, jnp.asarray(x)))
        for recs in (tl, infer.prepare(tl)):
            chip_smoke_rule(infer.packed_apply(tm, recs, _t(x)).numpy(), ref)
    with torch.no_grad():
        chip_smoke_rule(infer.packed_apply(tm, infer.pack_model(tm), _t(x)).numpy(),
                        tm(_t(x)).numpy())


def test_a1_conv1_direct_equals_im2col():
    """xnor_digits_a1's conv1 (8x8x128 -> 128, 3x3 SAME) on its real input:
    the direct packed conv (K5's plain version, both routes) and im2col (K1's)
    bit for bit."""
    rng = np.random.default_rng(12)
    x = _normal(rng, 4, 8, 8, 128)
    w = _t(_normal(rng, 128, 128, 3, 3))
    pc = PackedConv("xnor", *_packed(w))
    direct = packed_conv2d(_t(x), pc)
    assert torch.equal(direct, packed_conv2d(_t(x), pc, mode="im2col"))
    assert direct.shape == (4, 8, 8, 128)


def _packed(w_oihw):
    from pytorch_quantize_impls_tpu_torch.kernels.conv import pack_conv_weights

    pc = pack_conv_weights(w_oihw, "xnor", a_bits=1)
    return pc.packed, pc.kernel_size, pc.cin, pc.cout, pc.alpha, 1, 1


# --- refusals, bnn_lenet_as served as fake-quant, train.run -------------------------


def test_act_scale_refused_by_every_pack_and_export(tmp_path):
    """pack_model, packed_apply, the host export and export_fused_lenet
    raise on act_scale (the JAX package's drop g); the fused chain refuses
    xnor_digits_a1's K map in both packages."""
    model = build_model(RunConfig(**{**SCHEME_CONFIGS["bnn_lenet_as"], "width": 8}),
                        device=CPU)[0].eval()
    for fn in (lambda: infer.pack_model(model),
               lambda: infer.packed_apply(model, {}, torch.zeros(1, 28, 28, 1)),
               lambda: host_export.export_packed(os.path.join(tmp_path, "m.npz"), model),
               lambda: infer.export_fused_lenet(model)):
        with pytest.raises(ValueError, match="act_scale"):
            fn()
    assert not os.path.exists(os.path.join(tmp_path, "m.npz"))
    a1 = build_model(RunConfig(**{**SCHEME_CONFIGS["xnor_digits_a1"], "width": 8}),
                     device=CPU)[0]
    with pytest.raises(ValueError, match="use_input_scale_map"):
        infer.export_fused_chain(a1)
    ja1 = jbuild_model(JRunConfig(**{**JCONFIGS["xnor_digits_a1"], "width": 8}))[0]
    with pytest.raises(ValueError, match="use_input_scale_map"):
        jfc.export_fused_chain(ja1, None)  # refused before the variables are read


def test_bnn_lenet_as_served_as_fake_quant():
    """InferenceEngine over the fake-quant model: every answer is the
    model's own on that image."""
    rng = np.random.default_rng(13)
    model = _seeded("bnn_lenet_as", rng)[0]
    xs = _normal(rng, 6, 28, 28, 1)
    engine = serve.InferenceEngine(model, (28, 28, 1), batch_sizes=(1, 4), device=CPU)
    try:
        got = [engine.submit(x).result(timeout=60) for x in xs]
    finally:
        engine.shutdown()
    with torch.no_grad():
        ref = model(_t(xs))
    for a, r in zip(got, ref):
        assert torch.equal(torch.as_tensor(a).argmax(), r.argmax())


@pytest.mark.parametrize("name", ["xnor_digits_a1", "bnn_lenet_as"])
def test_train_run_new_configs(name, tmp_path, monkeypatch):
    """train.run on the CPU at a cut width for a few steps: the digits as
    8x8x1 images (the synthetic stand-in of sklearn's, whose import alone
    takes seconds), MNIST for LeNet; the XNOR net evaluated packed too,
    bnn_lenet_as not (its packed paths refuse g), and its --export refused
    before training."""
    monkeypatch.setattr(trun.data, "digits",
                        lambda flatten=False: trun.data.synthetic_digits(flatten=flatten))
    steps, width = ("3", "8") if name == "xnor_digits_a1" else ("2", "4")
    args = ["--config", name, "--steps", steps, "--width", width, "--device", CPU,
            "--batch-size", "16"]
    model, out = trun.train_config(trun.parse_args(args))
    assert out["steps"] == int(steps) and np.isfinite(out["loss"])
    if name == "xnor_digits_a1":
        assert model.image_shape == DIGITS and model.widths == (8, 8)
    assert ("packed_accuracy" in out) == (name == "xnor_digits_a1")
    if name == "bnn_lenet_as":
        with pytest.raises(ValueError, match="act_scale"):
            trun.train_config(trun.parse_args(args + ["--export",
                                                      os.path.join(tmp_path, "a.npz")]))
