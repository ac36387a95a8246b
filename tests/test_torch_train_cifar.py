"""Training of the CIFAR BASELINE configs in the port, held against the JAX
package's.

``XNORConvNet`` and ``LogQuantVGGSmall`` at widths (8, 8, 16, 16) and
``DorefaResNet20`` at width 8 (PACT W4A4, W4 weights only), each quantized
and as its float32 twin, on 32x32 CIFAR stand-in images, b = 16; the
variables are drawn by the port (``nn.init_like_flax``) and carried to JAX
through the bridge.

The twins' logits agree with JAX's in float32. The train step is held
against JAX's in float64, both packages (the models, Adam and the clamp;
the cross-entropy casts its logits to float32 in both): one step's loss and
every gradient against ``jax.value_and_grad`` of JAX's
``make_compute_loss(elastic_weight=2e-4)`` (PACT's alpha penalty), then five
teacher-forced steps, each from JAX's state, through the body of JAX's
``make_train_step`` (that ``value_and_grad``, ``apply_gradients``, the new
statistics), by the rule of ``tests/test_torch_train.py``: the loss within
1e-6 relative; every entry within 1e-5 where JAX's gradient is above the
rounding noise of an exactly-zero gradient, within 4 lr where it is not;
the running statistics within 1e-5 (relative where they exceed 1); every
gradient within 1e-5 of its tensor's largest entry. Why float64: in float32
the two packages' convs sum in other orders, and a ReLU mask or a PACT code
at its boundary flips; a flipped code moves the next conv's sums by a code
step and flips more, so JAX's and the port's float32 forwards part (at these
seeds: 10 PACT codes at stage 0, block 2, then 9651 of 32768 at the last
block), and even the ResNet twin's gradients differ by up to 2% of their
largest entry, where in float64 they agree to 2e-7.

Then the penalty collection and a scheduled ``elastic_weight``, the QAT warm
start against ``scripts/accuracy_sweep.py``'s ``_warm_start`` (loaded by
path), ``remat`` against the plain ResNet, ``build_model(fp32=True)`` for
every config with a twin against the JAX twin's variables, and
``train.accuracy_sweep.main`` on the CPU.
"""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_quantize_impls_tpu import data as jdata
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import train as jtrain
from pytorch_quantize_impls_tpu.nn.base import collect_elastic_losses as jcollect
from pytorch_quantize_impls_tpu.utils.config import SCHEME_CONFIGS as JCONFIGS
from pytorch_quantize_impls_tpu.utils.config import RunConfig as JRunConfig
from pytorch_quantize_impls_tpu.utils.config import build_model as jbuild_model
from pytorch_quantize_impls_tpu_torch import models, nn as tnn, ops, train
from pytorch_quantize_impls_tpu_torch.nn.base import _QuantLayer
from pytorch_quantize_impls_tpu_torch.train import accuracy_sweep
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
    flax_variables,
    load_flax_variables,
)
from _torch_train_helpers import (
    f64,
    jax_apply_gradients,
    jax_value_and_grad,
    leaves,
    load_jax_state,
    sweep_script,
)

LR = 3e-3
BATCH = 16
ELASTIC = 2e-4  # dorefa_resnet20's elastic_weight
NOISE = 1e-6  # |g| at or below this is rounding noise of an exactly-zero gradient
TOL = 1e-5
MIN_WITHIN = 0.999
WIDTHS = (8, 8, 16, 16)
WIDTH = 8

MODELS = {
    "xnor": (lambda: jmodels.XNORConvNet(widths=WIDTHS),
             lambda: models.XNORConvNet(widths=WIDTHS)),
    "xnor_twin": (lambda: jmodels.XNORConvNet(widths=WIDTHS, quantized=False),
                  lambda: models.XNORConvNet(widths=WIDTHS, quantized=False)),
    "vgg": (lambda: jmodels.LogQuantVGGSmall(widths=WIDTHS),
            lambda: models.LogQuantVGGSmall(widths=WIDTHS)),
    "vgg_twin": (lambda: jmodels.LogQuantVGGSmall(widths=WIDTHS, quantized=False),
                 lambda: models.LogQuantVGGSmall(widths=WIDTHS, quantized=False)),
    "resnet_pact": (lambda: jmodels.DorefaResNet20(width=WIDTH, a_quant="pact"),
                    lambda: models.DorefaResNet20(width=WIDTH, a_quant="pact")),
    "resnet_w4": (lambda: jmodels.DorefaResNet20(width=WIDTH, a_bits=0),
                  lambda: models.DorefaResNet20(width=WIDTH, a_bits=0)),
    "resnet_twin": (lambda: jmodels.DorefaResNet20(width=WIDTH, quantized=False),
                    lambda: models.DorefaResNet20(width=WIDTH, quantized=False)),
}
TWINS = ["xnor_twin", "vgg_twin", "resnet_twin"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Small convs and elementwise ops: more threads only contend (the tests
    run beside other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cifar():
    return jdata.cifar10()[0]


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """One JAX module per name, so its jitted functions compile once."""
    return MODELS[name][0]()


def _port(name, seed=0):
    """The port's model with flax-like initial weights (init_like_flax), and
    its variables in the flax layout."""
    tm = tnn.init_like_flax(MODELS[name][1](), seed)
    return tm, flax_variables(tm)


# one optimizer object: it is a static field of the train state, so the
# jitted functions below compile once per model
TX = optax.chain(optax.adam(LR), jtrain.clip_quantized_weights())


def _jax_state(name, variables):
    """JAX's train state (Adam, the clamp) on ``variables``: call inside
    jax.enable_x64 for float64 leaves."""
    return jtrain.QuantTrainState.create_for(_jax_model(name), variables, TX)


def _port_grads(tm, x, y):
    """The port's loss (with the penalty) and gradients in training mode, as
    flax-layout leaves; the running statistics are restored after."""
    stats = {k: v.clone() for k, v in tm.state_dict().items() if "running" in k}
    tm.train()
    tm.zero_grad(set_to_none=True)
    loss = train.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss = loss + ELASTIC * tnn.collect_elastic_losses(tm)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in tm.named_parameters()}
    tm.load_state_dict({**tm.state_dict(), **stats})
    tm.zero_grad(set_to_none=True)
    carrier = copy.deepcopy(tm)
    with torch.no_grad():
        for k, p in carrier.named_parameters():
            p.copy_(grads[k])
    return float(loss.detach()), leaves(flax_variables(carrier)["params"])


def _share_within(got, want, jgrad=None, bound=TOL):
    """The share of entries within ``bound``; where JAX's gradient is
    rounding noise, within 4 lr (asserted)."""
    d = np.abs(got - want)
    ok = d <= bound
    if jgrad is not None:
        noise = np.abs(jgrad) <= NOISE
        assert (d[noise] <= 4 * LR + TOL).all(), d[noise].max()
        ok = ok | noise
    return float(ok.mean())


def _check_grads(jg, tg):
    assert set(tg) == set(jg)
    for k in jg:
        bound = TOL * max(float(np.abs(jg[k]).max()), NOISE)
        assert _share_within(tg[k], jg[k], bound=bound) == 1.0, k


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("name", TWINS)
def test_twin_logits_match_jax(name, mode, cifar):
    """The twins' float32 logits within 1e-5 of JAX's on bridged variables,
    in training mode (batch statistics, the running ones moved alike) and in
    eval mode on the statistics that training forward left."""
    tm, v = _port(name)
    jm = _jax_model(name)
    x = cifar[0][:BATCH]
    ref, aux = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(v, x)
    got = tm.train()(torch.from_numpy(x)).detach().numpy()
    if mode == "eval":
        v = {**v, "batch_stats": aux["batch_stats"]}
        ref = jax.jit(functools.partial(jm.apply, train=False))(v, x)
        got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    else:
        stats = leaves(flax_variables(tm)["batch_stats"])
        for k, want in leaves(aux["batch_stats"]).items():
            np.testing.assert_allclose(stats[k], want, rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_step_gradients(name, cifar):
    """In float64: the loss within 1e-6 relative, every gradient entry
    within 1e-5 of its tensor's largest; PACT's alpha gradient holds the
    penalty's 2 lambda alpha."""
    tm, v = _port(name)
    x, y = cifar[0][:BATCH].astype(np.float64), cifar[1][:BATCH]
    with jax.enable_x64(True):
        (jl, _), jg = jax_value_and_grad(_jax_state(name, f64(v)), jnp.asarray(x),
                                         jnp.asarray(y), ELASTIC)
        jl, jg = float(jl), leaves(jg)
    tm.double()
    tl, tg = _port_grads(tm, x, y)
    assert abs(tl - jl) <= 1e-6 * abs(jl), (tl, jl)
    _check_grads(jg, tg)
    if name == "resnet_pact":
        # each alpha's gradient with the penalty less its gradient without
        alphas = [m.alpha for m in tm.modules() if isinstance(m, tnn.PACT)]
        grads = []
        for weight in (ELASTIC, 0.0):
            tm.zero_grad(set_to_none=True)
            loss = train.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
            (loss + weight * tnn.collect_elastic_losses(tm)).backward()
            grads.append(torch.stack([a.grad for a in alphas]))
        torch.testing.assert_close(grads[0] - grads[1], 2 * ELASTIC * torch.stack(alphas).detach(),
                                   rtol=1e-9, atol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_steps_against_jax(name, cifar):
    """Five teacher-forced steps in float64 (module docstring): each from
    JAX's state, on the same batch, against the body of JAX's
    make_train_step(elastic_weight=2e-4)."""
    tm, v = _port(name)
    tm.double()
    ts = train.QuantTrainState.create_for(tm, lr=LR)
    tstep = train.make_train_step(elastic_weight=ELASTIC)
    with jax.enable_x64(True):
        js = _jax_state(name, f64(v))
        for i, (x, y) in enumerate(jdata.iterate_batches(cifar, BATCH, seed=1)):
            if i == 5:
                break
            x = x.astype(np.float64)
            load_jax_state(ts, tm, js)
            (jl, (_, stats)), grads = jax_value_and_grad(js, jnp.asarray(x), jnp.asarray(y),
                                                         ELASTIC)
            js = jax_apply_gradients(js, grads, stats)
            ts, tmet = tstep(ts, (x, y))
            jl, tl, jg = float(jl), float(tmet["loss"]), leaves(grads)
            assert abs(tl - jl) <= 1e-6 * abs(jl), (i, tl, jl)
            assert ts.step == int(js.step) == i + 1
            got = flax_variables(tm)
            params, want = leaves(got["params"]), leaves(js.params)
            for k in want:
                assert _share_within(params[k], want[k], jg[k]) == 1.0, (i, k)
            stats, want_stats = leaves(got["batch_stats"]), leaves(js.batch_stats)
            for k in want_stats:
                bound = TOL * np.maximum(1.0, np.abs(want_stats[k]))
                assert (np.abs(stats[k] - want_stats[k]) <= bound).all(), (i, k)
            kernels = [a for k, a in params.items() if "kernel" in k]
            assert all(np.abs(a).max() <= 1.0 for a in kernels)


def test_collect_elastic_losses_matches_jax(cifar):
    """nn.collect_elastic_losses (the sum of PACT's alpha^2) against JAX's
    sum of the sown losses on the PACT ResNet; 0 for a model without
    penalties."""
    tm, _ = _port("resnet_pact")
    with torch.no_grad():
        for i, m in enumerate(x for x in tm.modules() if isinstance(x, tnn.PACT)):
            m.alpha.fill_(0.5 + 0.25 * i)
    jm = _jax_model("resnet_pact")
    _, aux = jax.jit(functools.partial(jm.apply, train=True, mutable=["losses", "batch_stats"]))(
        flax_variables(tm), cifar[0][:2])
    want = float(jcollect(aux))
    got = tnn.collect_elastic_losses(tm).detach()
    assert got.shape == () and abs(float(got) - want) <= 1e-6 * want, (float(got), want)
    assert float(ops.pact_alpha_penalty(torch.tensor([3.0, 4.0]))) == 25.0
    twin, _ = _port("resnet_twin")
    assert tnn.collect_elastic_losses(twin).shape == ()
    assert float(tnn.collect_elastic_losses(twin)) == 0.0


def test_scheduled_elastic_weight_matches_jax():
    """A callable elastic_weight gets the step before its update, in the loss
    and so in alpha's gradient, as JAX's make_train_step(jit=False): a PACT
    DoReFa MLP (64 -> 32 -> 10), three steps teacher-forced in float64."""
    def schedule(step):
        return 1e-2 * (step + 1)

    rng = np.random.default_rng(3)
    xs, ys = rng.normal(size=(3, 8, 64)), rng.integers(0, 10, (3, 8)).astype(np.int32)
    kw = dict(layer="dorefa", bits=4, a_bits=4, a_quant="pact")
    tm = tnn.init_like_flax(models.MLP(64, (32, 10), **kw), 0)
    jm = jmodels.MLP(features=(32, 10), **kw)
    with torch.no_grad():
        for i, m in enumerate(x for x in tm.modules() if isinstance(x, tnn.PACT)):
            m.alpha.fill_(1.0 + i)
    v = flax_variables(tm)
    tm.double()
    ts = train.QuantTrainState.create_for(tm, lr=LR)
    tstep = train.make_train_step(elastic_weight=schedule)
    with jax.enable_x64(True):
        js = jtrain.QuantTrainState.create_for(jm, f64(v), TX)
        jstep = jtrain.make_train_step(elastic_weight=schedule, donate=False)
        for i in range(3):
            load_jax_state(ts, tm, js)
            penalty = float(tnn.collect_elastic_losses(tm))
            ce = float(train.cross_entropy(copy.deepcopy(tm).train()(torch.from_numpy(xs[i])),
                                           torch.from_numpy(ys[i])))
            js, jmet = jstep(js, (jnp.asarray(xs[i]), jnp.asarray(ys[i])))
            ts, tmet = tstep(ts, (xs[i], ys[i]))
            loss = float(tmet["loss"])
            assert abs(loss - (ce + schedule(i) * penalty)) <= 1e-6 * loss, i
            assert abs(loss - float(jmet["loss"])) <= 1e-6 * loss, i
            got, want = leaves(flax_variables(tm)["params"]), leaves(js.params)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)


WARM = {"xnor_cifar": ("xnor", "xnor_twin"), "logquant_vgg": ("vgg", "vgg_twin"),
        "dorefa_resnet20": ("resnet_pact", "resnet_twin"),
        "dorefa_resnet20_w4": ("resnet_w4", "resnet_twin")}


def _random_like(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("config", sorted(WARM) + ["binaryconnect_mlp"])
def test_warm_start_matches_jax(config):
    """train.accuracy_sweep.warm_start against scripts/accuracy_sweep.py's
    _warm_start, leaf for leaf, on random variables of both models: the
    twin's kernels, BatchNorm parameters and statistics copied into the
    quantized model; PACT's alpha keeps its value. The count is every entry
    but the alphas."""
    rng = np.random.default_rng(7)
    if config == "binaryconnect_mlp":
        q, fp = (build_model(RunConfig(**SCHEME_CONFIGS[config]), fp32=t, device="cpu")[0]
                 for t in (False, True))
    else:
        (q, _), (fp, _) = (_port(n) for n in WARM[config])
    q_vars, fp_vars = (_random_like(flax_variables(m), rng) for m in (q, fp))
    want = sweep_script()._warm_start(q_vars, fp_vars)
    load_flax_variables(q, q_vars, device="cpu")
    load_flax_variables(fp, fp_vars, device="cpu")
    matched = accuracy_sweep.warm_start(q, fp)
    got = flax_variables(q)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=jax.tree_util.keystr(path))
    alphas = leaves({k: v for k, v in q_vars["params"].items()})
    alphas = {k: a for k, a in alphas.items() if k.endswith("['alpha']")}
    assert all(np.array_equal(leaves(got["params"])[k], a) for k, a in alphas.items())
    assert matched == len(q.state_dict()) - len(alphas)
    assert (len(alphas) == 18) == (config == "dorefa_resnet20")


@pytest.mark.parametrize("name", ["resnet_pact", "resnet_twin"])
def test_remat_is_bit_equal(name, cifar):
    """DorefaResNet20(remat=True): one train step gives the same loss,
    gradients, parameters and running statistics as remat=False, bit for
    bit; the statistics moved once (as one training forward moves them)."""
    plain, _ = _port(name)
    remat = copy.deepcopy(plain)
    remat.remat = True
    x, y = cifar[0][:BATCH], cifar[1][:BATCH]
    once = copy.deepcopy(plain).train()
    with torch.no_grad():
        once(torch.from_numpy(x))
    results = []
    for m in (plain, remat):
        ts = train.QuantTrainState.create_for(m, lr=LR)
        _, met = train.make_train_step(elastic_weight=ELASTIC)(ts, (x, y))
        results.append((float(met["loss"]), {k: p.grad.clone() for k, p in m.named_parameters()}))
    assert results[0][0] == results[1][0]
    for k, g in results[0][1].items():
        assert torch.equal(g, results[1][1][k]), k
    sd_plain, sd_remat, sd_once = plain.state_dict(), remat.state_dict(), once.state_dict()
    for k in sd_plain:
        assert torch.equal(sd_plain[k], sd_remat[k]), k
        if "running" in k:
            assert torch.equal(sd_remat[k], sd_once[k]), k


@pytest.mark.parametrize("name", sorted(SCHEME_CONFIGS))
def test_build_model_twins(name):
    """build_model(fp32=True) for every config (each has a twin): the JAX entry's
    values, no quantizer, the JAX twin's variables (names and shapes, from
    jax.eval_shape of its init) and an eval forward of the right shape."""
    assert SCHEME_CONFIGS[name] == JCONFIGS[name]
    cfg = RunConfig(**SCHEME_CONFIGS[name])
    model, shape, dataset = build_model(cfg, fp32=True, device="cpu")
    jmodel, jshape, jdataset = jbuild_model(JRunConfig(**JCONFIGS[name]), fp32=True)
    assert (shape, dataset) == (tuple(jshape), jdataset)
    assert not any(isinstance(m, _QuantLayer) and (m.weight_quant or m.input_quant)
                   for m in model.modules())
    assert not any(isinstance(m, tnn.PACT) for m in model.modules())
    jv = jax.eval_shape(functools.partial(jmodel.init, train=True),
                        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape)))
    want = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jax.tree_util.tree_flatten_with_path(
        {c: jv[c] for c in ("params", "batch_stats") if c in jv})[0]}
    got = {k: a.shape for k, a in leaves(flax_variables(model)).items()}
    assert got == want
    with torch.no_grad():
        assert tuple(model.eval()(torch.zeros(1, *shape)).shape) == (1, 10)


def test_accuracy_sweep_main(tmp_path, capsys):
    """train.accuracy_sweep.main on the CPU: dorefa_resnet20 (PACT, its
    elastic weight, warm-started) cut to width 4, batch 8, 3 steps: one row
    with the JSON keys, the warm start matched every entry but the alphas,
    and the packed accuracy equals fake-quant's."""
    out = tmp_path / "rows.json"
    rc = accuracy_sweep.main(["--configs", "dorefa_resnet20", "--steps", "3", "--set",
                              "width=4", "batch_size=8", "--device", "cpu",
                              "--json-out", str(out)])
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (row,) = last["rows"]
    assert last["rows"] == json.loads(out.read_text()) and last["device"] == "cpu"
    resnet = build_model(RunConfig(**{**SCHEME_CONFIGS["dorefa_resnet20"], "width": 4}),
                         device="cpu")[0]
    n_alpha = sum(isinstance(m, tnn.PACT) for m in resnet.modules())
    assert row["config"] == "dorefa_resnet20" and row["warm_start"] and row["steps"] == 3
    assert row["warm_matched"] == [len(resnet.state_dict()) - n_alpha]
    assert row["packed_acc"] == [row["quant_acc"]]
    assert np.isfinite(row["delta_acc"]) and 0.0 <= row["fp32_acc"] <= 1.0


def test_elastic_ramp_matches_jax():
    """accuracy_sweep.elastic_weight: the constant, or the JAX runs' ramp
    lambda min(step / (0.6 steps), 1) in float32."""
    cfg = RunConfig(**SCHEME_CONFIGS["dorefa_resnet20"])
    assert accuracy_sweep.elastic_weight(cfg, 100) == 2e-4
    ramp = accuracy_sweep.elastic_weight(RunConfig(elastic_weight=100.0, elastic_ramp=True), 3200)
    lam, total = 100.0, 0.6 * 3200
    for step in (0, 1, 7, 1919, 1920, 3199):
        want = float(lam * jnp.minimum(jnp.asarray(step, jnp.int32) / total, 1.0))
        assert ramp(step) == want, step
