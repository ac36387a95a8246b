"""The port's compute dtype (bf16 compute, float32 masters), held against the
JAX package's (tests/test_mixed_precision.py).

The five models of that file's ``MODELS``, at its widths, and a small LM
are built in both packages with ``dtype`` bf16; one set of variables (drawn
by ``nn.init_like_flax`` as flax's initializers draw them) goes through
``utils.bridge`` into both, and the same numpy inputs through both.

JAX's functions are compiled with ``xla_allow_excess_precision`` off. With
it on (XLA's default) a fusion may keep its bf16 intermediates at float32,
which a binary net's signs turn into another function; off, the compiled
function rounds after each op as the model states it, which is what the
JAX test's op-by-op ``apply`` computes (the same bits, ten times faster
here).

Tolerances, all on the CPU:

- A product of +-1 inputs and weights is an integer sum, which both
  packages round once to bf16: such layers agree bit for bit, and so do the
  models built of them with BatchNorm and pools between (measured: every
  model but the ResNet bit-equal).
- A product of real bf16 values is a float32 sum taken in another order by
  XLA and PyTorch, rounded once: one bf16 ulp of the output apart at most.
- Whole forwards are held within JAX's own coarse seam (``rtol=0.05,
  atol=0.15``, tests/test_mixed_precision.py:100-113) with the argmax
  agreement reported.
- One training step from one state: the loss within 1e-4 relative and every
  gradient entry within 2^-5 of its tensor's max |g|. The backward rounds
  each cotangent to bf16 (2^-9 relative) at every layer, in another order in
  each package; measured worst 2^-6.2 at width 8. Post-Adam parameters are
  not compared (ROADMAP section 3).
- Packed serving at bf16 against the JAX package's packed path on one
  ``.npz``: LeNet, the binary MLP and the binary-weight XNOR net bit for
  bit; the ResNet within 1e-2 (its stem, the projections and the residual
  adds are real bf16 sums).
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import nn as jnn
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu import train as jtrain
from pytorch_quantize_impls_tpu.train.steps import make_compute_loss
from pytorch_quantize_impls_tpu_torch import infer, models, nn as tnn, ops, train
from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine
from pytorch_quantize_impls_tpu_torch.utils import flax_variables, load_flax_variables

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
SEAM = dict(rtol=0.05, atol=0.15)  # tests/test_mixed_precision.py:112-113
GRAD_TOL = 2.0 ** -5  # of a tensor's max |g| (module docstring)
LM_CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64)

# (JAX model, port model, input shape): tests/test_mixed_precision.py:23-38 and
# an LM with BinaryConnect weights; VGG on its 32x32 images (the port's head
# takes CIFAR's shape)
MODELS = {
    "binary_mlp": (lambda: jmodels.MLP(features=(64, 10), layer="bin", dtype=JBF16),
                   lambda: models.MLP(64, (64, 10), layer="bin", dtype=BF16), (4, 64)),
    "bnn_lenet": (lambda: jmodels.BNNLeNet(width=8, dtype=JBF16),
                  lambda: models.BNNLeNet(width=8, dtype=BF16), (4, 28, 28, 1)),
    "xnor_convnet": (lambda: jmodels.XNORConvNet(widths=(8, 8), dtype=JBF16),
                     lambda: models.XNORConvNet(widths=(8, 8), dtype=BF16,
                                                image_shape=(16, 16, 3)), (4, 16, 16, 3)),
    "log_vgg": (lambda: jmodels.LogQuantVGGSmall(widths=(8, 8), dtype=JBF16),
                lambda: models.LogQuantVGGSmall(widths=(8, 8), dtype=BF16), (4, 32, 32, 3)),
    "dorefa_resnet": (lambda: jmodels.DorefaResNet20(width=8, dtype=JBF16),
                      lambda: models.DorefaResNet20(width=8, dtype=BF16), (4, 16, 16, 3)),
    "lm": (lambda: jmodels.QuantTransformerLM(**LM_CFG, dtype=JBF16),
           lambda: models.QuantTransformerLM(**LM_CFG, dtype=BF16), (2, 16)),
}
FP32_OUT = {"dorefa_resnet", "lm"}  # float32 head and logits in both packages


def _strict(fn, *args):
    """``fn(*args)`` compiled by XLA without excess precision (module
    docstring)."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


def _input(name, shape, rng):
    if name == "lm":
        return rng.integers(0, LM_CFG["vocab"], shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """(name, JAX model, its variables as numpy, port model in eval mode,
    input)."""
    name = request.param
    make_j, make_t, shape = MODELS[name]
    x = _input(name, shape, np.random.default_rng(0))
    tm = tnn.init_like_flax(make_t(), 0).eval()
    return name, make_j(), flax_variables(tm), tm, x


def test_bf16_compute_fp32_masters(pair):
    """Masters and statistics float32 in both; the output at JAX's dtype
    (bf16, float32 for the ResNet's head and the LM's logits) and finite;
    the forward within JAX's coarse seam of JAX's (argmax reported)."""
    name, jm, v, tm, x = pair
    init = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                                          train=False))
    assert {a.dtype for a in jax.tree_util.tree_leaves(init["params"])} == {np.dtype(np.float32)}
    assert {t.dtype for t in tm.state_dict().values()} == {torch.float32}
    ref = _strict(lambda v, x: jm.apply(v, x, train=False), v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = torch.float32 if name in FP32_OUT else BF16
    assert ref.dtype == (jnp.float32 if name in FP32_OUT else JBF16) and got.dtype == want
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **SEAM)
    agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
    print(f"{name}: max |port - JAX| {np.abs(got - ref).max():.3g}, argmax agrees {agree:.3f}")


def test_w1a1_lm_dtypes():
    """The W1A1 LM (the serving LM's scheme): projections and the residual
    stream at bf16, LayerNorms and logits float32, the raw cache
    (kv_bits=None) at bf16, the int8 cache's scales float32."""
    cfg = dict(LM_CFG, scheme="binary", w_bits=1, a_bits=1)
    tm = tnn.init_like_flax(models.QuantTransformerLM(**cfg, dtype=BF16), 0).eval()
    seen = {}
    for n in ("block0.ln1", "block0.attn.q", "block0.attn.out", "block0.ffn_out", "block1"):
        tm.get_submodule(n).register_forward_hook(
            lambda m, i, o, n=n: seen.__setitem__(n, o.dtype))
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 8)).astype(np.int64))
    with torch.no_grad():
        logits = tm(tok)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert seen == {"block0.ln1": torch.float32, "block0.attn.q": BF16, "block0.attn.out": BF16,
                    "block0.ffn_out": BF16, "block1": BF16}
    raw = models.QuantTransformerLM(**cfg, dtype=BF16, decode=True, kv_bits=None)
    cache = raw.init_cache(2, device="cpu")["block0"]["attn"]
    assert cache["k_raw"].dtype == cache["v_raw"].dtype == BF16
    cache = tm.init_cache(2, device="cpu")["block0"]["attn"]
    assert cache["k_scale"].dtype == torch.float32 and cache["k_codes"].dtype == torch.int8


# --- each quantized layer fed the same input -----------------------------------

CONV = dict(kernel_size=(3, 3))
# (JAX layer, port layer, input shape, exact): exact where the product is a sum
# of +-1 terms (binary or xnor weights and inputs, no K map)
LAYERS = {
    "LinearBin": (lambda: jnn.LinearBin(features=8, dtype=JBF16),
                  lambda: tnn.LinearBin(16, 8, dtype=BF16), (4, 16), False),
    "LinearBin_bnn": (lambda: jnn.LinearBin(features=8, binarize_input=True, dtype=JBF16),
                      lambda: tnn.LinearBin(16, 8, binarize_input=True, dtype=BF16), (4, 16),
                      True),
    "BinConv": (lambda: jnn.BinConv(features=4, dtype=JBF16, **CONV),
                lambda: tnn.BinConv(3, 4, dtype=BF16), (2, 8, 8, 3), False),
    "BinConv_bnn": (lambda: jnn.BinConv(features=4, binarize_input=True, dtype=JBF16, **CONV),
                    lambda: tnn.BinConv(3, 4, binarize_input=True, dtype=BF16), (2, 8, 8, 3),
                    True),
    "XNORLinear_bnn": (lambda: jnn.XNORLinear(features=8, binarize_input=True, dtype=JBF16),
                       lambda: tnn.XNORLinear(16, 8, binarize_input=True, dtype=BF16), (4, 16),
                       True),
    "XNORConv": (lambda: jnn.XNORConv(features=4, dtype=JBF16, **CONV),
                 lambda: tnn.XNORConv(3, 4, dtype=BF16), (2, 8, 8, 3), False),
    "XNORConv_bnn_k": (lambda: jnn.XNORConv(features=4, binarize_input=True, dtype=JBF16,
                                            **CONV),
                       lambda: tnn.XNORConv(3, 4, binarize_input=True, dtype=BF16),
                       (2, 8, 8, 3), False),
    "LinearDorefa_a4": (lambda: jnn.LinearDorefa(features=8, a_bits=4, dtype=JBF16),
                        lambda: tnn.LinearDorefa(16, 8, a_bits=4, dtype=BF16), (4, 16), False),
    "DorefaConv_a4": (lambda: jnn.DorefaConv(features=4, a_bits=4, dtype=JBF16, **CONV),
                      lambda: tnn.DorefaConv(3, 4, a_bits=4, dtype=BF16), (2, 8, 8, 3), False),
    "DorefaConv_pact": (lambda: jnn.DorefaConv(features=4, a_bits=4, a_quant="pact",
                                               dtype=JBF16, **CONV),
                        lambda: tnn.DorefaConv(3, 4, a_bits=4, a_quant="pact", dtype=BF16),
                        (2, 8, 8, 3), False),
    "LinearQuantLog": (lambda: jnn.LinearQuantLog(features=8, fsr=1.0, dtype=JBF16),
                       lambda: tnn.LinearQuantLog(16, 8, fsr=1.0, dtype=BF16), (4, 16), False),
    "ConvQuantLog": (lambda: jnn.ConvQuantLog(features=4, fsr=1.0, dtype=JBF16, **CONV),
                     lambda: tnn.ConvQuantLog(3, 4, fsr=1.0, dtype=BF16), (2, 8, 8, 3), False),
    "LinearTer": (lambda: jnn.LinearTer(features=8, dtype=JBF16),
                  lambda: tnn.LinearTer(16, 8, dtype=BF16), (4, 16), False),
    "TerConv": (lambda: jnn.TerConv(features=4, dtype=JBF16, **CONV),
                lambda: tnn.TerConv(3, 4, dtype=BF16), (2, 8, 8, 3), False),
    "ElasticLinear": (lambda: jnn.ElasticLinear(features=8, dtype=JBF16),
                      lambda: tnn.ElasticLinear(16, 8, dtype=BF16), (4, 16), False),
    "ElasticConv": (lambda: jnn.ElasticConv(features=4, dtype=JBF16, **CONV),
                    lambda: tnn.ElasticConv(3, 4, dtype=BF16), (2, 8, 8, 3), False),
}


def _bf16_ulp(a):
    """One bf16 ulp at each |a| (8 significant bits)."""
    mag = np.maximum(np.abs(a.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _apply_jax(jl, v, x):
    if isinstance(jl, (jnn.ElasticLinear, jnn.ElasticConv)):
        return jl.apply(v, x, mutable=["losses"])[0]
    return jl.apply(v, x, train=False)


# a model feeds its first layer float32 images and every later one bf16
LAYER_CASES = [(n, "bfloat16") for n in sorted(LAYERS)] + [
    (n, "float32") for n in ("BinConv", "DorefaConv_pact", "LinearBin_bnn", "XNORConv_bnn_k")]


@pytest.mark.parametrize("name,in_dtype", LAYER_CASES)
def test_layer_matches_jax(name, in_dtype):
    """The layer fed JAX's input gives JAX's output at JAX's dtype: bit for
    bit where the sums are +-1 integers, within one bf16 ulp elsewhere."""
    make_j, make_t, shape, exact = LAYERS[name]
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    if in_dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, JBF16).astype(jnp.float32))  # on the bf16 grid
    tl = tnn.init_like_flax(make_t(), 3).eval()
    ref = _apply_jax(make_j(), flax_variables(tl), jnp.asarray(x, in_dtype))
    with torch.no_grad():
        got = tl(torch.from_numpy(x).to(getattr(torch, in_dtype)))
    assert str(ref.dtype) == str(got.dtype).split(".")[-1]
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        d = np.abs(got - ref)
        assert (d <= _bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))).all(), d.max()


def test_pact_output_dtype():
    """PACT computes at result_type(x, float32): float32 for a bf16 input,
    the same values as JAX's; its layer too."""
    x = np.random.default_rng(4).normal(size=(4, 16)).astype(np.float32) * 4
    ref = jops.pact(jnp.asarray(x, JBF16), jnp.asarray(6.0), 4)
    got = ops.pact(torch.from_numpy(x).bfloat16(), torch.tensor(6.0), 4)
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tnn.PACT(4)(torch.from_numpy(x).bfloat16()).dtype == torch.float32


# --- training ---------------------------------------------------------------------


def test_bf16_training_learns():
    """tests/test_mixed_precision.py:75-97 on the port: the bf16 MLP trains,
    the loss falls below 0.7 of its start, the master kernel stays float32
    and clamped."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 32)).astype(np.float32)
    y = (np.arange(128) % 10).astype(np.int32)
    model = tnn.init_like_flax(models.MLP(32, (64, 10), layer="bin", dtype=BF16), 0)
    state = train.QuantTrainState.create_for(model, lr=1e-2)
    step = train.make_train_step()
    losses = [float(step(state, (x, y))[1]["loss"]) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]
    assert np.isfinite(losses[-1])
    kernel = model.layer0.dense.weight
    assert kernel.dtype == torch.float32 and float(kernel.abs().max()) <= 1.0 + 1e-6


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_bf16_lenet_step_matches_jax():
    """One bf16 training step of BNN LeNet (width 8) from JAX's initial
    state on a batch of 32: the loss within 1e-4 relative and every gradient
    entry within GRAD_TOL of its tensor's max |g| of jax.value_and_grad's."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(32, 28, 28, 1)).astype(np.float32)
    y = (np.arange(32) % 10).astype(np.int32)
    jm = jmodels.BNNLeNet(width=8, dtype=JBF16)
    tm = tnn.init_like_flax(models.BNNLeNet(width=8, dtype=BF16), 0).train()
    v = flax_variables(tm)
    js = jtrain.QuantTrainState.create_for(
        jm, v, optax.chain(optax.adam(3e-3), jtrain.clip_quantized_weights()))
    (jloss, _), jgrads = _strict(lambda p: jax.value_and_grad(
        make_compute_loss(js, jnp.asarray(x), jnp.asarray(y)), has_aux=True)(p), js.params)
    with tnn.quant_generator(torch.Generator()):
        loss = train.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    carrier = load_flax_variables(models.BNNLeNet(width=8, dtype=BF16), v, device="cpu")
    with torch.no_grad():
        for (k, p), q in zip(carrier.named_parameters(), tm.parameters()):
            p.copy_(q.grad)
    got, want = _leaves(flax_variables(carrier)["params"]), _leaves(jgrads)
    assert set(got) == set(want)
    for k in want:
        assert want[k].dtype == got[k].dtype == np.float32
        bound = GRAD_TOL * np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= bound, k


# --- packed serving ---------------------------------------------------------------


def _lenet_pair():
    rng = np.random.default_rng(6)
    v = chip_smoke.seeded_variables(8, rng)
    x = np.asarray(jnp.asarray(rng.normal(size=(6, 28, 28, 1)), JBF16).astype(jnp.float32))
    tm = load_flax_variables(models.BNNLeNet(width=8, dtype=BF16), v, device="cpu").eval()
    return jmodels.BNNLeNet(width=8, dtype=JBF16), v, tm, x


def _real_input_pair(name):
    """The binary MLP (real-input dense layers with biases) or the
    binary-weight XNOR net (real-input convs with alpha): their packed
    products are taken in float32 before alpha and the bias, then rounded
    once."""
    if name == "mlp":
        jm, tm, shape = (jmodels.MLP(features=(64, 10), layer="bin", dtype=JBF16),
                         models.MLP(64, (64, 10), layer="bin", dtype=BF16), (8, 64))
    else:
        jm = jmodels.XNORConvNet(widths=(8, 8), binarize_inputs=False, dtype=JBF16)
        tm = models.XNORConvNet(widths=(8, 8), binarize_inputs=False, dtype=BF16,
                                image_shape=(16, 16, 3))
        shape = (8, 16, 16, 3)
    tm = tnn.init_like_flax(tm, 1).eval()
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for n, p in tm.named_parameters():
            if n.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    rng = np.random.default_rng(8)
    x = np.asarray(jnp.asarray(rng.normal(size=shape), JBF16).astype(jnp.float32))
    return jm, flax_variables(tm), tm, x


def _resnet_pair():
    rng = np.random.default_rng(7)
    calib = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    _, v = chip_smoke.calibrated_resnet(8, rng, calib, "cpu")
    x = np.asarray(jnp.asarray(rng.normal(size=(3, 16, 16, 3)), JBF16).astype(jnp.float32))
    tm = load_flax_variables(models.DorefaResNet20(w_bits=4, a_bits=4, width=8, dtype=BF16), v,
                             device="cpu").eval()
    return jmodels.DorefaResNet20(w_bits=4, a_bits=4, width=8, dtype=JBF16), v, tm, x


@pytest.mark.parametrize("name", ["lenet", "mlp", "resnet", "xnor_bwn"])
def test_packed_bf16_matches_jax(name, tmp_path):
    """One artifact of the model served by both packages' packed_apply at
    bf16 (bf16 inputs), unprepared and prepared: bit for bit, but the
    ResNet within 1e-2 (module docstring); the output at JAX's dtype."""
    pairs = {"lenet": _lenet_pair, "resnet": _resnet_pair}
    jm, v, tm, x = pairs[name]() if name in pairs else _real_input_pair(name)
    xj = jnp.asarray(x, JBF16)
    path = os.path.join(tmp_path, f"{name}.npz")
    infer.save_packed(path, infer.pack_model(tm))
    ref = _strict(lambda v, p, x: jinfer.packed_apply(jm, v, p, x), v, jinfer.load_packed(path),
                  xj)
    recs = infer.load_packed(path, device="cpu")
    xt = torch.from_numpy(x).bfloat16()
    for r in (recs, infer.prepare(recs)):
        got = infer.packed_apply(tm, r, xt)
        assert str(ref.dtype) == str(got.dtype).split(".")[-1]
        g, w = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
        if name == "resnet":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-2)
        else:
            np.testing.assert_array_equal(g, w)


def test_inference_engine_bf16_answers():
    """InferenceEngine(dtype=torch.bfloat16, device="cpu") over the packed
    bf16 LeNet answers every request from several threads with its row of
    packed_apply on the bf16 images (float32 arrays holding the bf16
    logits)."""
    _, _, tm, x = _lenet_pair()
    recs = infer.prepare(infer.pack_model(tm))
    engine = InferenceEngine(lambda b: infer.packed_apply(tm, recs, b), x.shape[1:],
                             batch_sizes=(1, 4), device="cpu", dtype=BF16)
    answers = [None] * len(x)

    def client(i):
        answers[i] = engine.submit(x[i]).result(timeout=60)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(x))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        engine.shutdown()
    want = infer.packed_apply(tm, recs, torch.from_numpy(x).bfloat16()).float().numpy()
    for a, w in zip(answers, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, w)
