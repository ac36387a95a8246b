"""The port's quantizer core for training, held against the JAX package.

The STE helpers and the stochastic primitives run on the same seeded numpy
inputs (and the same uniform draw ``u``) in both packages and must agree bit
for bit, forward and gradient. The draws themselves cannot be compared (JAX
draws with threefry, PyTorch with Philox or mt19937), so the generator is
checked statistically and for determinism per (seed, step). Then flax's
BatchNorm in training mode, the clamp after each optimizer step, the data
module, and the new configs and twins through the bridge in both
directions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_quantize_impls_tpu import data as jdata
from pytorch_quantize_impls_tpu import nn as jnn
from pytorch_quantize_impls_tpu.ops import common as jcommon
from pytorch_quantize_impls_tpu import train as jtrain
from pytorch_quantize_impls_tpu.ops import binary as jbinary
from pytorch_quantize_impls_tpu.ops import ternary as jternary
from pytorch_quantize_impls_tpu.utils.config import SCHEME_CONFIGS as JCONFIGS
from pytorch_quantize_impls_tpu.utils.config import RunConfig as JRunConfig
from pytorch_quantize_impls_tpu.utils.config import build_model as jbuild_model
from pytorch_quantize_impls_tpu_torch import data, models, nn as tnn, ops, train
from pytorch_quantize_impls_tpu_torch.models.lenet import BatchNorm
from pytorch_quantize_impls_tpu_torch.ops import binary as tbinary
from pytorch_quantize_impls_tpu_torch.ops import ternary as tternary
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
    flax_variables,
    load_flax_variables,
)

# edges of every quantizer (0, +-0.5, +-1) beside seeded normals
EDGES = np.array([-2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5, -2.5], np.float32)


def _x(seed=0, n=509):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, (rng.normal(size=n) * 1.2).astype(np.float32)])


def _jax_fwd_grad(fn, x, g, *args):
    y, vjp = jax.vjp(lambda v: fn(v, *args), jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def _torch_fwd_grad(fn, x, g, *args):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt, *args)
    y.backward(torch.tensor(g))
    return y.detach().numpy(), xt.grad.numpy()


HELPERS = {
    "hard_sigmoid": (jcommon.hard_sigmoid, ops.hard_sigmoid),
    "ste_identity": (jcommon.ste_identity(jcommon.safe_sign),
                     ops.ste_identity(ops.safe_sign)),
    "ste_clip": (jcommon.ste_clip(jcommon.safe_sign, 0.5),
                 ops.ste_clip(ops.safe_sign, 0.5)),
    "round_ste": (jcommon.round_ste, ops.round_ste),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_common_helpers_match_jax(name):
    """Forward and gradient (against jax.vjp) bit for bit, at the edges too:
    hard_sigmoid's gradient is halved where x sits on a bound, as jnp.clip's."""
    x = np.concatenate([_x(), np.array([0.25, -0.25, 2.5, 3.5], np.float32)])
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jf, tf = HELPERS[name]
    jy, jg = _jax_fwd_grad(jf, x, g)
    ty, tg = _torch_fwd_grad(tf, x, g)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)


PRIMS = {
    "binary clip": (jbinary._binary_stoch_prim,
                    lambda x, u: tbinary.binary_stoch_prim(x, u, ste_mode="clip")),
    "binary identity": (jbinary._binary_stoch_prim_identity,
                        lambda x, u: tbinary.binary_stoch_prim(x, u, ste_mode="identity")),
    "ternary": (jternary._ternary_stoch_prim, tternary.ternary_stoch_prim),
}


@pytest.mark.parametrize("name", sorted(PRIMS))
def test_stochastic_prims_on_shared_u(name):
    """The stochastic primitives on one shared draw u: forward and the STE
    gradient bit for bit (u a constant of the backward)."""
    x = _x(2)
    rng = np.random.default_rng(3)
    u = rng.uniform(size=x.shape).astype(np.float32)
    u[:4] = [0.0, 0.25, 0.5, 0.75]  # draws on the thresholds
    g = rng.normal(size=x.shape).astype(np.float32)
    jf, tf = PRIMS[name]
    jy, jg = _jax_fwd_grad(jf, x, g, jnp.asarray(u))
    ty, tg = _torch_fwd_grad(tf, x, g, torch.from_numpy(u))
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("scheme", ["binary", "ternary"])
def test_stochastic_draw_statistics(scheme):
    """Over 4000 draws per point: the mean of the binary draws within 4
    sigma of 2 hard_sigmoid(x) - 1, the ternary draws' share of zeros within
    4 sigma of 1 - |clip(x)| and their mean of clip(x)."""
    x = torch.linspace(-1.25, 1.25, 41)
    n = 4000
    gen = torch.Generator().manual_seed(11)
    xs = x.expand(n, -1).contiguous()
    if scheme == "binary":
        draws = ops.binary_connect_stoch(xs, gen)
        assert set(draws.unique().tolist()) <= {-1.0, 1.0}
        p = ops.hard_sigmoid(x)
        mean, want, sigma = draws.mean(0), 2 * p - 1, 2 * torch.sqrt(p * (1 - p) / n)
        assert ((mean - want).abs() <= 4 * sigma + 1e-6).all()
    else:
        draws = ops.ternary_connect_stoch(xs, gen)
        assert set(draws.unique().tolist()) <= {-1.0, 0.0, 1.0}
        w = x.clamp(-1, 1)
        pz = 1 - w.abs()
        zeros = (draws == 0).double().mean(0)
        assert ((zeros - pz).abs() <= 4 * torch.sqrt(pz * (1 - pz) / n) + 1e-6).all()
        sigma = torch.sqrt((w.abs() - w * w) / n)
        assert ((draws.mean(0) - w).abs() <= 4 * sigma + 1e-6).all()


def test_step_generator_determinism_and_global_rng():
    """The train state's generator gives the same draws for the same (seed,
    step) and others for another step or seed; a train step of a stochastic
    MLP leaves the global RNG as it was; the layer refuses to draw outside a
    train step."""
    model = models.MLP(16, (32, 10), layer="bin_stoch")
    tnn.init_like_flax(model, 0)
    state = train.QuantTrainState.create_for(model, lr=1e-2, seed=5)
    x = torch.zeros(8, 16)

    def draw(st):
        return ops.binary_connect_stoch(x, st.step_generator())

    first = draw(state)
    assert torch.equal(first, draw(state))
    other = train.QuantTrainState.create_for(model, lr=1e-2, seed=6)
    assert not torch.equal(first, draw(other))
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(8, 16)).astype(np.float32), rng.integers(0, 10, 8).astype(np.int32))
    before = torch.get_rng_state()
    train.make_train_step()(state, batch)
    assert torch.equal(torch.get_rng_state(), before)
    assert state.step == 1 and not torch.equal(first, draw(state))
    model.train()
    with pytest.raises(RuntimeError, match="train step"):
        model(torch.zeros(2, 16))
    with tnn.quant_generator(torch.Generator().manual_seed(0)):
        assert model(torch.zeros(2, 16)).shape == (2, 10)


@pytest.mark.parametrize("kind", ["binary", "ternary"])
def test_stochastic_layers_eval_on_clipped_master(kind):
    """In eval mode a stochastic layer runs on clip(w, -1, 1) (BinaryConnect
    §2.4), not sign(w), as the JAX layer does with the same variables."""
    rng = np.random.default_rng(4)
    kernel = (rng.normal(size=(24, 12)) * 0.9).astype(np.float32)
    bias = rng.normal(size=12).astype(np.float32)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    variables = {"params": {"dense": {"kernel": kernel, "bias": bias}}}
    if kind == "binary":
        jl, tl = jnn.LinearBin(features=12, deterministic=False), tnn.LinearBin(
            24, 12, deterministic=False)
    else:
        jl, tl = jnn.LinearTer(features=12, deterministic=False), tnn.LinearTer(
            24, 12, deterministic=False)
    ref = np.asarray(jl.apply(variables, jnp.asarray(x), train=False))
    load_flax_variables(tl, variables, device="cpu").eval()
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, x @ np.clip(kernel, -1, 1) + bias)


class _FlaxBN:
    """flax.linen.BatchNorm in training mode, three updates in a row."""

    def __init__(self, features):
        import flax.linen as fnn

        self.m = fnn.BatchNorm(use_running_average=False)
        self.v = None
        self.features = features

    def __call__(self, x, scale, bias):
        if self.v is None:
            self.v = self.m.init(jax.random.PRNGKey(0), jnp.asarray(x))
        params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        y, upd = self.m.apply({"params": params, "batch_stats": self.v["batch_stats"]},
                              jnp.asarray(x), mutable=["batch_stats"])
        self.v = {"batch_stats": upd["batch_stats"]}
        return np.asarray(y), jax.tree_util.tree_map(np.asarray, upd["batch_stats"])


@pytest.mark.parametrize("shape", [(16, 6, 6, 5), (32, 7)], ids=["nhwc", "2d"])
def test_batchnorm_training_matches_flax(shape):
    """Output, gradient and running statistics within 1e-6 of flax's over
    three updates (momentum 0.99 on the old value, the biased fast variance
    in running_var), then the eval forward on the running statistics."""
    rng = np.random.default_rng(7)
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    fbn, bn = _FlaxBN(c), BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    for i in range(3):
        x = (rng.normal(size=shape) * (1 + i) + 0.5 * i).astype(np.float32)
        g = rng.normal(size=shape).astype(np.float32)
        ref, stats = fbn(x, scale, bias)
        xt = torch.tensor(x, requires_grad=True)
        y = bn(xt)
        np.testing.assert_allclose(y.detach().numpy(), ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=1e-6, atol=1e-6)
        y.backward(torch.from_numpy(g))

        def f(v):
            return fbn.m.apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                "batch_stats": fbn.v["batch_stats"]}, v,
                               mutable=["batch_stats"])[0]

        _, vjp = jax.vjp(f, jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                                   rtol=1e-5, atol=1e-5)
    bn.eval()
    x = rng.normal(size=shape).astype(np.float32)
    import flax.linen as fnn

    ref = fnn.BatchNorm(use_running_average=True).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": fbn.v["batch_stats"]},
        jnp.asarray(x))
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


class _AddUpdate(torch.optim.Optimizer):
    """An optimizer whose step adds a given update to each parameter."""

    def __init__(self, params, updates):
        super().__init__(params, {})
        self.updates = updates

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                p.add_(self.updates[p])


@pytest.mark.parametrize("quantized", [True, False], ids=["bnn", "twin"])
def test_clamp_matches_jax(quantized):
    """The clamp after the step against clip_quantized_weights on the same p
    and u, bit for bit: every kernel clipped (the twin's plain ones too),
    BatchNorm scales above 1 untouched."""
    model = models.BNNLeNet(width=4, quantized=quantized)
    tnn.init_like_flax(model, 3)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy((rng.normal(size=p.shape) * 0.8 + 0.6).astype(np.float32)))
            if name.startswith("bn") and name.endswith("weight"):
                p.abs_().add_(2.0)  # scales beyond the bound: must stay
    variables = flax_variables(model)
    updates = {p: torch.from_numpy((rng.normal(size=p.shape) * 0.7).astype(np.float32))
               for p in model.parameters()}
    named_u = {n: updates[p] for n, p in model.named_parameters()}
    u_model = models.BNNLeNet(width=4, quantized=quantized)
    u_model.load_state_dict({**model.state_dict(), **named_u})
    u_tree = flax_variables(u_model)["params"]
    tx = jtrain.clip_quantized_weights()
    u2, _ = tx.update(u_tree, tx.init(variables["params"]), variables["params"])
    ref = optax.apply_updates(variables["params"], u2)
    clamp = train.clip_quantized_weights(model)
    assert len(clamp.params) == 4  # conv1, conv2, fc1, head kernels
    clamp.step(_AddUpdate(model.parameters(), updates))
    got = flax_variables(model)["params"]
    for (path, want), (_, have) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                       jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_array_equal(have, np.asarray(want), err_msg=str(path))
    assert all(float(bn.weight.detach().max()) > 1.0 for bn in (model.bn1, model.bn2, model.bn3))
    assert all(float(p.abs().max()) <= 1.0 for p, _ in clamp.params)
    train.clip_params(u_model)
    assert float(u_model.conv1.weight.abs().max() if not quantized
                 else u_model.conv1.conv.weight.abs().max()) <= 1.0


def test_data_matches_jax():
    """The port's numpy data module against the JAX package's, bit for bit:
    the synthetic MNIST stand-in, a CIFAR-difficulty synthetic set, digits,
    and the batch stream with start_step."""
    (a, b), (c, d) = data.mnist(flatten=True), jdata.mnist(flatten=True)
    for got, want in zip((*a, *b), (*c, *d)):
        np.testing.assert_array_equal(got, want)
    assert data.datasets.SYNTH_CIFAR_DIFFICULTY == jdata.datasets.SYNTH_CIFAR_DIFFICULTY
    kw = dict(seed=1, **data.datasets.SYNTH_CIFAR_DIFFICULTY)
    for got, want in zip(data.synthetic_image_classification((32, 32, 3), 10, 96, 32, **kw),
                         jdata.synthetic_image_classification((32, 32, 3), 10, 96, 32, **kw)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    (a, b), (c, d) = data.digits(), jdata.digits()
    for got, want in zip((*a, *b), (*c, *d)):
        np.testing.assert_array_equal(got, want)
    train_set = data.digits(flatten=True)[0]
    for start in (0, 7, 30):
        ours = data.iterate_batches(train_set, 64, seed=3, start_step=start)
        theirs = jdata.iterate_batches(train_set, 64, seed=3, start_step=start)
        for _ in range(25):
            (x1, y1), (x2, y2) = next(ours), next(theirs)
            np.testing.assert_array_equal(x1, x2)
            np.testing.assert_array_equal(y1, y2)


def _write_idx(path, arr) -> None:
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 + arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_data_dir_reads_real_mnist_as_jax(tmp_path, monkeypatch):
    """MNIST idx files under a data directory: the port's loader reads them
    from its ``data_dir`` argument (what ``train.run --data-dir`` passes) as
    the JAX package's reads them from ``$QTPU_DATA_DIR``, bit for bit, and
    the argument leaves the environment as it was."""
    from pytorch_quantize_impls_tpu_torch.train import run as trun

    rng = np.random.default_rng(11)
    (tmp_path / "mnist").mkdir()
    for name, n in (("train", 12), ("t10k", 5)):
        _write_idx(tmp_path / "mnist" / f"{name}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28)))
        _write_idx(tmp_path / "mnist" / f"{name}-labels-idx1-ubyte", rng.integers(0, 10, n))
    monkeypatch.delenv(data.datasets.DATA_DIR_ENV, raising=False)
    ours = trun.load_data("mnist", (28, 28, 1), str(tmp_path))
    assert data.datasets.DATA_DIR_ENV not in os.environ
    assert ours[0][0].shape == (12, 28, 28, 1) and ours[1][0].shape == (5, 28, 28, 1)
    monkeypatch.setenv(data.datasets.DATA_DIR_ENV, str(tmp_path))
    theirs = jdata.mnist()
    for got, want in zip((*ours[0], *ours[1]), (*theirs[0], *theirs[1])):
        np.testing.assert_array_equal(got, want)


NEW_CONFIGS = ["binaryconnect_mlp", "bnn_lenet", "binaryconnect_digits",
               "binaryconnect_digits_stoch", "ternary_digits", "ternary_digits_stoch"]


@pytest.mark.parametrize("fp32", [False, True], ids=["quantized", "twin"])
@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_configs_and_twins_round_trip(name, fp32):
    """Each config and its float32 twin: the JAX entry's values, the same
    input shape and dataset, and the JAX model's variables load into the
    port's model (strict) and come back through flax_variables unchanged."""
    assert SCHEME_CONFIGS[name] == {k: v for k, v in JCONFIGS[name].items()}
    cfg = RunConfig(**SCHEME_CONFIGS[name])
    if name == "bnn_lenet":
        cfg.width = 8
    model, shape, dataset = build_model(cfg, fp32=fp32, device="cpu")
    jcfg = JRunConfig(**JCONFIGS[name])
    jcfg.width = cfg.width
    jmodel, jshape, jdataset = jbuild_model(jcfg, fp32=fp32)
    assert (shape, dataset) == (tuple(jshape), jdataset)
    x0 = jnp.zeros((1, *shape), jnp.float32)
    v = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(1), "quant": jax.random.PRNGKey(2)}, x0, train=True)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    load_flax_variables(model, v, device="cpu")
    back = flax_variables(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for want, got in zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, want)
    model.eval()
    ref = np.asarray(jax.jit(jmodel.apply, static_argnames="train")(v, x0 + 0.5, train=False))
    got = model(torch.full((1, *shape), 0.5)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_flax_init_and_default_device():
    """init_like_flax: deterministic per seed, truncated at 2 std, glorot
    for quantized layers and lecun for the twin's; uniform(-1, 1) for
    ternary. The entry points run on the card by default and raise here."""
    a = build_model(RunConfig(**SCHEME_CONFIGS["binaryconnect_mlp"]), device="cpu")[0]
    b = build_model(RunConfig(**SCHEME_CONFIGS["binaryconnect_mlp"]), device="cpu")[0]
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    w = a.layer0.dense.weight.detach()
    std = np.sqrt(2 / (784 + 512))
    assert abs(float(w.std()) / std - 1) < 0.02 and float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
    twin = build_model(RunConfig(**SCHEME_CONFIGS["binaryconnect_mlp"]), fp32=True,
                       device="cpu")[0]
    assert abs(float(twin.layer0.weight.detach().std()) / np.sqrt(1 / 784) - 1) < 0.02
    ter = build_model(RunConfig(**SCHEME_CONFIGS["ternary_digits"]), device="cpu")[0]
    tw = ter.layer0.dense.weight
    assert float(tw.min()) >= -1 and float(tw.max()) <= 1 and float(tw.abs().mean()) > 0.45
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(RunConfig(config="binaryconnect_mlp"))
        from pytorch_quantize_impls_tpu_torch.train import run

        with pytest.raises(RuntimeError, match="cuda"):
            run.main(["--config", "binaryconnect_digits", "--steps", "1"])


def test_max_pool_gradient_ties_match_jax():
    """LeNet's training pool against flax's max_pool on sums of +-1 terms
    (ties in most windows): the same values, and the gradient on the first
    maximum of each window, bit for bit."""
    import flax.linen as fnn

    from pytorch_quantize_impls_tpu_torch.models.lenet import max_pool_nhwc

    rng = np.random.default_rng(12)
    x = rng.integers(-2, 3, size=(4, 9, 8, 6)).astype(np.float32)
    g = rng.normal(size=(4, 4, 4, 6)).astype(np.float32)
    jy, jg = _jax_fwd_grad(lambda v: fnn.max_pool(v, (2, 2), strides=(2, 2)), x, g)
    ty, tg = _torch_fwd_grad(max_pool_nhwc, x, g)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("binarize_input", [True, False])
def test_binary_conv_sums_are_exact_integers(monkeypatch, binarize_input):
    """A conv of +-1 inputs and +-1 weights returns the exact integer sums
    even where the float conv is off by ~1e-4 (as cuDNN's is at some
    shapes; perturbed here), with the gradient passed
    through; a real-input conv keeps the float conv's output."""
    from pytorch_quantize_impls_tpu_torch.nn import base

    conv = tnn.BinConv(3, 4, (3, 3), binarize_input=binarize_input)
    real = base.conv2d_nhwc
    monkeypatch.setattr(base, "conv2d_nhwc", lambda *a: real(*a) + 1e-4)
    x = torch.randn(2, 5, 5, 3, requires_grad=True)
    y = conv(x)
    exact = y.detach() - conv.conv.bias.detach()
    if binarize_input:
        assert torch.equal(exact, exact.round())
    else:
        assert not torch.equal(exact, exact.round())
    y.sum().backward()
    assert x.grad is not None and conv.conv.weight.grad.abs().sum() > 0
