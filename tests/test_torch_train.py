"""The port's training path held against the JAX package's.

One train step of BNN LeNet (width 8) and of the BinaryConnect MLP (hidden
64), and of their float32 twins, from JAX's initial variables (through the
bridge) on the same batch of 32: the loss, every gradient against
``jax.value_and_grad``, then the parameters and ``batch_stats`` after each
of five steps against JAX's ``make_train_step(jit=False)``.

The five steps are teacher-forced: before each one the port takes JAX's
state (parameters, BatchNorm statistics, Adam's moments and count). Free
running cannot be compared: the W1A1 LeNet is chaotic under float
reassociation, and JAX's own jitted and unjitted steps part after a single
step and differ almost everywhere a few steps later. What parts them is Adam on gradients that are zero in exact
arithmetic: a weight into a BatchNorm from an input that is constant over
the batch (a +1 code in every row), or a bias followed by a BatchNorm. Its
computed gradient is rounding noise (|g| <= 1e-6 here), and Adam's first
update ``lr g / (|g| + eps)`` turns the noise into a step of up to ``lr``.
So the rule is, per step from the same state: the loss within 1e-6
relative; every entry within 1e-5 where JAX's gradient is above that noise
level (or >= 99.9% of them, for a sign that ties after BatchNorm), and any
entry within 4 lr (the most Adam moves an entry in one step) where it is
not; the running statistics within 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_quantize_impls_tpu import data as jdata
from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import train as jtrain
from pytorch_quantize_impls_tpu.train.steps import make_compute_loss
from pytorch_quantize_impls_tpu.utils.config import RunConfig as JRunConfig
from pytorch_quantize_impls_tpu.utils.config import build_model as jbuild_model
from pytorch_quantize_impls_tpu_torch import data, infer, models, nn as tnn, train
from pytorch_quantize_impls_tpu_torch.train import run as trun
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
    flax_state_dict,
    flax_variables,
    load_flax_variables,
)

LR = 3e-3
BATCH = 32
NOISE = 1e-6  # |g| at or below this is rounding noise of an exactly-zero gradient
TOL = 1e-5
MIN_WITHIN = 0.999

MODELS = {
    "lenet": (lambda: jmodels.BNNLeNet(width=8), lambda: models.BNNLeNet(width=8), False),
    "lenet_twin": (lambda: jmodels.BNNLeNet(width=8, quantized=False),
                   lambda: models.BNNLeNet(width=8, quantized=False), False),
    "mlp": (lambda: jmodels.BinaryConnectMLP(hidden=64),
            lambda: models.BinaryConnectMLP(784, 64), True),
    "mlp_twin": (lambda: jmodels.BinaryConnectMLP(hidden=64, quantized=False),
                 lambda: models.BinaryConnectMLP(784, 64, quantized=False), True),
}


@pytest.fixture(scope="module")
def mnist():
    return jdata.mnist(), jdata.mnist(flatten=True)


def _setup(name, mnist):
    make_j, make_t, flat = MODELS[name]
    (tr, _) = mnist[1] if flat else mnist[0]
    jm, tm = make_j(), make_t()
    init = jax.jit(jm.init, static_argnames="train")
    v = init({"params": jax.random.PRNGKey(0)}, jnp.asarray(tr[0][:1]), train=True)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    load_flax_variables(tm, v, device="cpu")
    js = jtrain.QuantTrainState.create_for(
        jm, v, optax.chain(optax.adam(LR), jtrain.clip_quantized_weights()))
    return jm, tm, js, tr


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@jax.jit
def _jax_value_and_grad(js, x, y):
    return jax.value_and_grad(make_compute_loss(js, x, y), has_aux=True)(js.params)


def _jax_grads(js, x, y):
    (loss, _), grads = _jax_value_and_grad(js, jnp.asarray(x), jnp.asarray(y))
    return float(loss), _leaves(grads)


def _port_grads(tm, x, y):
    """The port's loss and gradients in training mode, as flax-layout
    leaves; the running statistics are restored after the forward."""
    stats = {k: v.clone() for k, v in tm.state_dict().items() if "running" in k}
    tm.train()
    tm.zero_grad(set_to_none=True)
    with tnn.quant_generator(torch.Generator()):
        loss = train.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in tm.named_parameters()}
    tm.load_state_dict({**tm.state_dict(), **stats})
    tm.zero_grad(set_to_none=True)
    # a copy carrying the gradients as its parameters, through the bridge
    carrier = copy.deepcopy(tm)
    with torch.no_grad():
        for k, p in carrier.named_parameters():
            p.copy_(grads[k])
    return float(loss), _leaves(flax_variables(carrier)["params"])


def _within(name, got, want, jgrad=None, bound=TOL):
    """The entry rule of the module docstring; returns the share within."""
    d = np.abs(got - want)
    ok = d <= bound
    if jgrad is not None:
        noise = np.abs(jgrad) <= NOISE
        assert (d[noise] <= 4 * LR + TOL).all(), (name, d[noise].max())
        ok = ok | noise
    return float(ok.mean())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_step_gradients(name, mnist):
    """Loss within 1e-6 relative, every gradient entry within 1e-6 + 1e-5 |g|
    of jax.value_and_grad's, from JAX's initial variables."""
    _, tm, js, tr = _setup(name, mnist)
    x, y = tr[0][:BATCH], tr[1][:BATCH]
    jl, jg = _jax_grads(js, x, y)
    tl, tg = _port_grads(tm, x, y)
    assert abs(tl - jl) <= 1e-6 * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _load_jax_state(ts, tm, js):
    """The port's state := JAX's: parameters, statistics, Adam's moments and
    count."""
    load_flax_variables(tm, {"params": js.params, "batch_stats": js.batch_stats}, device="cpu")
    adam = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    count = int(adam.count)
    ts.step = count
    if count == 0:
        return
    mu = flax_state_dict({"params": jax.tree_util.tree_map(np.asarray, adam.mu)})
    nu = flax_state_dict({"params": jax.tree_util.tree_map(np.asarray, adam.nu)})
    for k, p in tm.named_parameters():
        ts.optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[k].clone(),
                                 "exp_avg_sq": nu[k].clone()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_steps_against_jax(name, mnist):
    """Five teacher-forced steps (module docstring): each from JAX's state,
    on the same batch, against JAX's make_train_step(jit=False)."""
    _, tm, js, tr = _setup(name, mnist)
    ts = train.QuantTrainState.create_for(tm, lr=LR)
    jstep, tstep = jtrain.make_train_step(jit=False), train.make_train_step()
    for i, (x, y) in enumerate(jdata.iterate_batches(tr, BATCH, seed=1)):
        if i == 5:
            break
        _load_jax_state(ts, tm, js)
        _, jg = _jax_grads(js, x, y)
        js, jmet = jstep(js, (jnp.asarray(x), jnp.asarray(y)))
        ts, tmet = tstep(ts, (x, y))
        jl, tl = float(jmet["loss"]), float(tmet["loss"])
        assert abs(tl - jl) <= 1e-6 * abs(jl), (i, tl, jl)
        assert ts.step == int(js.step) == i + 1
        got = flax_variables(tm)
        params, want = _leaves(got["params"]), _leaves(js.params)
        shares = {k: _within(k, params[k], want[k], jg[k]) for k in want}
        worst = min(shares.values())
        assert worst == 1.0 or (worst >= MIN_WITHIN and abs(tl - jl) <= 1e-5 * abs(jl)), shares
        stats, want_stats = _leaves(got["batch_stats"]), _leaves(js.batch_stats)
        for k in want_stats:
            assert _within(k, stats[k], want_stats[k]) >= MIN_WITHIN, (i, k)
        kernels = [a for k, a in params.items() if "kernel" in k]
        assert all(np.abs(a).max() <= 1.0 for a in kernels)


@pytest.mark.parametrize("name", ["lenet", "mlp"])
def test_eval_step_matches_jax(name, mnist):
    """make_eval_step against JAX's after a few steps: loss within 1e-6
    relative, the same accuracy and count."""
    _, tm, js, tr = _setup(name, mnist)
    jstep = jtrain.make_train_step(donate=False)
    for i, (x, y) in enumerate(jdata.iterate_batches(tr, BATCH, seed=2)):
        if i == 3:
            break
        js, _ = jstep(js, (jnp.asarray(x), jnp.asarray(y)))
    load_flax_variables(tm, {"params": js.params, "batch_stats": js.batch_stats}, device="cpu")
    ts = train.QuantTrainState.create_for(tm)
    xe, ye = tr[0][-64:], tr[1][-64:]
    want = jtrain.make_eval_step()(js, (jnp.asarray(xe), jnp.asarray(ye)))
    got = train.make_eval_step()(ts, (xe, ye))
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-6 * float(want["loss"])
    assert float(got["accuracy"]) == float(want["accuracy"])
    assert int(got["count"]) == int(want["count"]) == 64
    assert not tm.training


def test_train_run_exports_an_artifact_jax_serves(tmp_path, mnist):
    """train.run end to end on the CPU (bnn_lenet at width 8, 20 steps,
    --export): the loss is finite, packed test accuracy equals fake-quant's,
    and the artifact loads in the JAX package's load_packed and gives the
    port's packed_apply logits (images on a 1/8 grid: conv1 sums them
    exactly in either package)."""
    path = str(tmp_path / "lenet.npz")
    args = trun.parse_args(["--config", "bnn_lenet", "--width", "8", "--steps", "20",
                            "--batch-size", str(BATCH), "--device", "cpu", "--export", path])
    model, out = trun.train_config(args)
    assert out["steps"] == 20 and np.isfinite(out["loss"])
    assert out["packed_accuracy"] == out["accuracy"]
    rng = np.random.default_rng(5)
    x = (np.clip(np.round(rng.normal(size=(16, 28, 28, 1)) * 8), -32, 32) / 8).astype(np.float32)
    ours = infer.packed_apply(model, infer.load_packed(path, device="cpu"), torch.from_numpy(x))
    jm = jmodels.BNNLeNet(width=8)
    theirs = jinfer.packed_apply(jm, flax_variables(model), jinfer.load_packed(path),
                                 jnp.asarray(x))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def _jax_init(fp32, cfg, x0):
    jm = jbuild_model(JRunConfig(config=cfg.config), fp32=fp32)[0]
    init = jax.jit(jm.init, static_argnames="train")
    v = init({"params": jax.random.PRNGKey(cfg.seed)}, jnp.asarray(x0), train=True)
    return jm, jax.tree_util.tree_map(np.asarray, dict(v))


def _port_accuracy(cfg, fp32, variables, train_set, test_set):
    """Train the config's port model from ``variables`` on the JAX batch
    stream with cosine-decayed Adam; its test accuracy."""
    tm = build_model(cfg, fp32=fp32, device="cpu")[0]
    load_flax_variables(tm, variables, device="cpu")
    ts = train.QuantTrainState.create_for(
        tm, lr=train.cosine_decay_schedule(cfg.lr, cfg.steps), seed=cfg.seed)
    step = train.make_train_step()
    for batch in data.iterate_batches(train_set, cfg.batch_size, seed=cfg.seed):
        if ts.step >= cfg.steps:
            break
        step(ts, batch)
    return trun.accuracy(tm.eval(), test_set, torch.device("cpu"))


def _jax_accuracy(cfg, jm, variables, train_set, test_set):
    tx = optax.chain(optax.adam(optax.cosine_decay_schedule(cfg.lr, cfg.steps)),
                     jtrain.clip_quantized_weights())
    js = jtrain.QuantTrainState.create_for(jm, variables, tx, seed=cfg.seed)
    jstep = jtrain.make_train_step(donate=False)
    for x, y in jdata.iterate_batches(train_set, cfg.batch_size, seed=cfg.seed):
        if int(js.step) >= cfg.steps:
            break
        js, _ = jstep(js, (jnp.asarray(x), jnp.asarray(y)))
    m = jtrain.make_eval_step()(js, (jnp.asarray(test_set[0]), jnp.asarray(test_set[1])))
    return float(m["accuracy"])


def test_binaryconnect_digits_milestone():
    """binaryconnect_digits (real sklearn digits, 512-wide, 1600 steps,
    cosine-decayed Adam as the JAX accuracy runs) trains in the port from
    JAX's initial variables on JAX's batches, and so does its float32 twin:
    Δacc >= -0.02 (ACCURACY.md's JAX row: -0.0019 +- 0.0056), and the final
    accuracy within 0.02 of the JAX package's run from the same start."""
    cfg = RunConfig(**SCHEME_CONFIGS["binaryconnect_digits"])
    train_set, test_set = data.digits(flatten=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # small GEMMs: more threads only contend
    try:
        jm, v = _jax_init(False, cfg, train_set[0][:1])
        acc = _port_accuracy(cfg, False, v, train_set, test_set)
        acc_jax = _jax_accuracy(cfg, jm, v, train_set, test_set)
        acc_fp32 = _port_accuracy(cfg, True, _jax_init(True, cfg, train_set[0][:1])[1],
                                  train_set, test_set)
    finally:
        torch.set_num_threads(threads)
    assert acc - acc_fp32 >= -0.02, (acc, acc_fp32)
    assert abs(acc - acc_jax) <= 0.02, (acc, acc_jax)
