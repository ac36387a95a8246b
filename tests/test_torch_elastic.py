"""The elastic (loss-aware) scheme of the port held against the JAX
package: the three grid penalties and their gradients, ``ElasticLinear`` and
``ElasticConv`` on carried weights with ``nn.collect_elastic_losses``, the
flax paths both ways and the clamp on their kernels, the hard projection
against ``scripts/accuracy_sweep.py``'s ``_project_elastic`` (on weights far
from converged, where the per-channel alpha is not 1), a few teacher-forced
steps of ``MLP(layer="elastic")`` under the ramped weight, and the two new
digits configs through ``train.run`` and ``train.accuracy_sweep`` on the
CPU.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import nn as jnn
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu_torch import models, nn as tnn, ops, train
from pytorch_quantize_impls_tpu_torch.train import accuracy_sweep
from pytorch_quantize_impls_tpu_torch.train import run as trun
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
    flax_variables,
    load_flax_variables,
)
from _torch_train_helpers import steps_against_jax, sweep_script

RTOL = 1e-6  # float32 means summed in another order


def _w(seed=0, shape=(40, 24)):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * 0.7).astype(np.float32)
    w.flat[:6] = [0.0, 1.0, -1.0, 0.5, -0.25, 2.0]  # the grids' points and ties
    return w


LOSSES = {
    "binary": (jops.binary_elastic_loss, ops.binary_elastic_loss, {}),
    "lin": (jops.lin_elastic_loss, ops.lin_elastic_loss, {"fsr": 1.0, "bits": 3}),
    "log": (jops.log_elastic_loss, ops.log_elastic_loss, {"fsr": 0.0, "bits": 4}),
}


@pytest.mark.parametrize("grid", sorted(LOSSES))
def test_losses_and_gradients_match_jax(grid):
    """Each penalty and its gradient against jax.value_and_grad, within
    float32 rounding; the nearest grid point carries no gradient; the
    dispatcher agrees."""
    jf, tf, kw = LOSSES[grid]
    w = _w(1)
    jl, jg = jax.value_and_grad(lambda v: jf(v, **kw))(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    loss = tf(wt, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-9)
    assert torch.equal(ops.elastic_loss(grid, wt.detach(), **kw), tf(wt.detach(), **kw))
    with pytest.raises(ValueError, match="grid"):
        ops.elastic_loss("ternary", wt)


class _JNet(fnn.Module):
    grid: str = "binary"

    @fnn.compact
    def __call__(self, x, train: bool = True):
        x = jnn.ElasticConv(features=6, kernel_size=(3, 3), strides=(2, 2), grid=self.grid,
                            fsr=1.0, bits=3, name="conv")(x)
        x = x.reshape(x.shape[0], -1)
        return jnn.ElasticLinear(features=5, grid=self.grid, fsr=1.0, bits=3, name="lin")(x)


class _Net(nn.Module):
    def __init__(self, grid="binary"):
        super().__init__()
        self.conv = tnn.ElasticConv(3, 6, (3, 3), strides=(2, 2), grid=grid, fsr=1.0, bits=3)
        self.lin = tnn.ElasticLinear(4 * 4 * 6, 5, grid=grid, fsr=1.0, bits=3)

    def forward(self, x):
        x = self.conv(x)
        return self.lin(x.reshape(x.shape[0], -1))


@pytest.mark.parametrize("grid", sorted(LOSSES))
def test_layers_forward_and_collected_penalty_match_jax(grid):
    """ElasticConv (SAME, stride 2: JAX's pads (0, 1)) and ElasticLinear on
    the weights JAX draws, carried by the bridge: the forward within 1e-5,
    the summed penalties within float32 rounding of JAX's ``losses``
    collection, and the variables back through the bridge unchanged."""
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 3)).astype(np.float32)
    jm = _JNet(grid)
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init({"params": jax.random.PRNGKey(3)},
                                                         jnp.asarray(x))))
    ref, aux = jm.apply({"params": v["params"]}, jnp.asarray(x), mutable=["losses"])
    tm = load_flax_variables(_Net(grid), v, device="cpu")
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tnn.collect_elastic_losses(tm)),
                               float(jnn.collect_elastic_losses(aux)), rtol=RTOL)
    back = flax_variables(tm)["params"]
    for name in ("conv", "lin"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf], v["params"][name][leaf])


def test_elastic_mlp_paths_init_and_clamp():
    """MLP(layer="elastic") against JAX's: the same flax paths and shapes
    (``['layer0']['kernel']``, no ``dense`` child; JAX's init also returns
    the penalties its layers sow), glorot_normal weights of JAX's spread,
    and the clamp after each step on every kernel, BatchNorm
    left alone."""
    jm = jmodels.MLP(features=(32, 32, 10), layer="elastic")
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.ones((1, 64))))
    want = {jax.tree_util.keystr(p): a.shape  # the penalties sown at init aside
            for p, a in jax.tree_util.tree_flatten_with_path(dict(v))[0] if p[0].key != "losses"}
    tm = tnn.init_like_flax(models.MLP(64, (32, 32, 10), layer="elastic"), 0)
    got = {jax.tree_util.keystr(p): a.shape
           for p, a in jax.tree_util.tree_flatten_with_path(flax_variables(tm))[0]}
    assert got == want
    std = float(tm.layer1.weight.std())
    assert abs(std - np.sqrt(2 / 64)) < 0.1 * np.sqrt(2 / 64)
    clamp = train.clip_quantized_weights(tm)
    named = {id(p): k for k, p in tm.named_parameters()}
    assert sorted(named[id(p)] for p, _ in clamp.params) == [
        "head.weight", "layer0.weight", "layer1.weight"]
    with torch.no_grad():
        tm.layer0.weight.mul_(5.0)
    ts = train.QuantTrainState.create_for(tm, lr=1e-3)
    x = torch.randn(8, 64)
    train.make_train_step(elastic_weight=1.0)(ts, (x, torch.randint(0, 10, (8,))))
    assert float(tm.layer0.weight.abs().max()) <= 1.0


def test_projection_matches_jax_on_unconverged_weights():
    """project_elastic against the JAX sweep's _project_elastic on weights
    far from the grid (alpha per output channel well below 1): every kernel
    projected, BatchNorm and biases untouched, each kernel entry +-its
    channel's alpha."""
    tm = tnn.init_like_flax(models.MLP(64, (32, 32, 10), layer="elastic"), 4)
    with torch.no_grad():
        tm.layer0.bias.uniform_(-1, 1)
    v = flax_variables(tm)
    want = sweep_script()._project_elastic(v["params"])
    assert accuracy_sweep.project_elastic(tm) == 3
    got = flax_variables(tm)["params"]
    for name in want:
        for leaf in want[name]:
            np.testing.assert_allclose(got[name][leaf], np.asarray(want[name][leaf]),
                                       rtol=RTOL, atol=0, err_msg=f"{name}/{leaf}")
    for name in ("layer0", "layer1", "head"):
        w = getattr(tm, name).weight.detach()
        alpha = w.abs().amax(1, keepdim=True)
        assert torch.equal(w.abs(), alpha.expand_as(w))
        assert float(alpha.max()) < 0.5
    np.testing.assert_array_equal(got["layer0"]["bias"], v["params"]["layer0"]["bias"])


def test_elastic_mlp_steps_under_the_ramp_match_jax():
    """Five teacher-forced steps of MLP(layer="elastic") (64-32-32-10) under
    the ramp 0 -> 100 over three steps (train.accuracy_sweep.elastic_weight,
    the same callable in both packages) against JAX's by the per-step rule."""
    cfg = RunConfig(elastic_weight=100.0, elastic_ramp=True)
    ramp = accuracy_sweep.elastic_weight(cfg, 5)
    lams = [ramp(s) for s in range(5)]
    assert lams[0] == 0.0 < lams[1] < lams[2] < lams[3] == lams[4] == 100.0
    rng = np.random.default_rng(5)
    x = rng.normal(size=(160, 64)).astype(np.float32)
    y = rng.integers(0, 10, 160).astype(np.int32)
    jm = jmodels.MLP(features=(32, 32, 10), layer="elastic")
    tm = tnn.init_like_flax(models.MLP(64, (32, 32, 10), layer="elastic"), 0)
    ts = steps_against_jax(jm, tm, x, y, n_steps=5, elastic_weight=ramp)
    assert float(tnn.collect_elastic_losses(ts.model)) > 0


@pytest.mark.parametrize("name", ["elastic_digits", "dorefa_digits_g6"])
def test_configs_match_jax_and_run(name, tmp_path):
    """The configs' values as JAX's; train.run takes each (3 steps; as
    ``scripts/train.py``, no penalty and no projection, which are
    train.accuracy_sweep's; the g6 model's packed accuracy equal to
    fake-quant's)."""
    from pytorch_quantize_impls_tpu.utils.config import SCHEME_CONFIGS as JCONFIGS

    assert SCHEME_CONFIGS[name] == JCONFIGS[name]
    model, shape, dataset = build_model(RunConfig(**SCHEME_CONFIGS[name]), device="cpu")
    assert (shape, dataset) == ((64,), "digits")
    args = trun.parse_args(["--config", name, "--steps", "3", "--batch-size", "64",
                            "--device", "cpu"])
    model, out = trun.train_config(args)
    assert out["steps"] == 3 and np.isfinite(out["loss"])
    if name == "elastic_digits":
        w = model.layer1.weight.detach()
        assert not torch.equal(w.abs(), w.abs().amax(1, keepdim=True).expand_as(w))
        assert "packed_accuracy" not in out
    else:
        assert out["packed_accuracy"] == out["accuracy"]


def test_sweep_rows_for_both_configs(capsys):
    """accuracy_sweep.main on both configs, 4 steps each: a row per config,
    the elastic model projected, the g6 model's packed accuracy equal to its
    fake-quant accuracy."""
    assert accuracy_sweep.main(["--configs", "elastic_digits", "dorefa_digits_g6", "--steps",
                                "4", "--device", "cpu"]) == 0
    rows = {r["config"]: r for r in json.loads(capsys.readouterr().out.splitlines()[-1])["rows"]}
    assert rows["elastic_digits"]["packed_acc"] == [None]
    assert rows["dorefa_digits_g6"]["packed_acc"] == [rows["dorefa_digits_g6"]["quant_acc"]]
