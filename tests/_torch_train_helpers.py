"""The float64 teacher-forced step harness that the port's training tests
share: JAX's train state carried into the port's (parameters, statistics,
Adam's moments and count), JAX's loss and update jitted once, leaves by
path, the JAX package's ``scripts/accuracy_sweep.py`` as a module, and
``steps_against_jax``, the per-step rule of ``tests/test_torch_train.py``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pytorch_quantize_impls_tpu import train as jtrain
from pytorch_quantize_impls_tpu.train.steps import make_compute_loss
from pytorch_quantize_impls_tpu_torch import train
from pytorch_quantize_impls_tpu_torch.utils import bridge, flax_variables

ROOT = Path(__file__).resolve().parent.parent
LR = 3e-3
NOISE = 1e-6  # |g| at or below this is the rounding noise of an exactly-zero gradient


def f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def state_dict64(variables):
    """flax variables -> a float64 state dict (``flax_state_dict`` keeps
    float32)."""
    sd = {}
    for collection, names in (("params", bridge._PARAM_NAMES),
                              ("batch_stats", bridge._STAT_NAMES)):
        for path, value in bridge._leaves(variables.get(collection, {})):
            key = ".".join(path[:-1] + (names[path[-1]],))
            sd[key] = torch.from_numpy(np.array(bridge._to_torch_layout(path[-1], value),
                                                np.float64))
    return sd


def load_jax_state(ts, tm, js):
    """The port's state := JAX's, in float64: parameters, statistics, Adam's
    moments and count."""
    tm.double().load_state_dict(state_dict64(
        {"params": js.params, "batch_stats": js.batch_stats}))
    adam = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    ts.step = count = int(adam.count)
    if count == 0:
        return
    mu, nu = state_dict64({"params": adam.mu}), state_dict64({"params": adam.nu})
    for k, p in tm.named_parameters():
        ts.optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[k],
                                 "exp_avg_sq": nu[k]}


@jax.jit
def jax_value_and_grad(js, x, y, weight):
    """JAX's loss (the penalties weighed by ``weight``), its aux and its
    gradients."""
    return jax.value_and_grad(make_compute_loss(js, x, y, elastic_weight=lambda step: weight),
                              has_aux=True)(js.params)


@jax.jit
def jax_apply_gradients(js, grads, stats):
    return js.apply_gradients(grads=grads).replace(batch_stats=stats)


def sweep_script():
    """The JAX package's accuracy-sweep script, loaded as a module."""
    spec = importlib.util.spec_from_file_location("jax_accuracy_sweep",
                                                  ROOT / "scripts" / "accuracy_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def steps_against_jax(jm, tm, x_all, y_all, n_steps=3, elastic_weight=lambda step: 0.0,
                      batch=32, first_step=0):
    """``n_steps`` teacher-forced steps in float64 in both packages (JAX
    under ``jax.enable_x64``, the port ``.double()``), each from JAX's state
    on the same batch, by ``tests/test_torch_train.py``'s rule: the loss
    within 1e-6 relative; every parameter entry within 1e-5, or within 4 lr
    where JAX's gradient is rounding noise; the statistics within 1e-5; the
    kernels in [-1, 1]. ``elastic_weight(step)`` weighs the penalties in
    both; JAX takes ``first_step`` steps alone before them."""
    tm.double()
    ts = train.QuantTrainState.create_for(tm, lr=LR)
    tstep = train.make_train_step(elastic_weight=elastic_weight)
    tx = optax.chain(optax.adam(LR), jtrain.clip_quantized_weights())
    with jax.enable_x64(True):
        js = jtrain.QuantTrainState.create_for(jm, f64(flax_variables(tm)), tx)
        for i in range(first_step + n_steps):
            x = jnp.asarray(x_all[i * batch:(i + 1) * batch].astype(np.float64))
            y = jnp.asarray(y_all[i * batch:(i + 1) * batch])
            if i >= first_step:
                load_jax_state(ts, tm, js)
            (jl, (_, stats)), grads = jax_value_and_grad(js, x, y,
                                                         np.float64(elastic_weight(i)))
            js = jax_apply_gradients(js, grads, stats)
            if i < first_step:
                continue
            ts, tmet = tstep(ts, (np.asarray(x), np.asarray(y)))
            jl, tl, jg = float(jl), float(tmet["loss"]), leaves(grads)
            assert abs(tl - jl) <= 1e-6 * abs(jl), (i, tl, jl)
            got = flax_variables(tm)
            params, want = leaves(got["params"]), leaves(js.params)
            assert set(params) == set(want)
            for k in want:
                d = np.abs(params[k] - want[k])
                noise = np.abs(jg[k]) <= NOISE
                ok = (d <= 1e-5) | (noise & (d <= 4 * LR + 1e-5))
                assert ok.all(), (i, k, int((~ok).sum()))
            stats, want_stats = leaves(got["batch_stats"]), leaves(js.batch_stats)
            for k in want_stats:
                np.testing.assert_allclose(stats[k], want_stats[k], rtol=1e-5, atol=1e-6,
                                           err_msg=k)
            assert all(np.abs(a).max() <= 1.0 for k, a in params.items() if "kernel" in k)
    return ts
