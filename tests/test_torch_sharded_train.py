"""The port's sharded training (``parallel.make_sharded_train_step``,
``make_sharded_eval_step``, ``shard_train_state``, ``shard_batch``,
``unshard_params``, ``assert_host_sync``, ``train.steps.make_compute_loss``
and ``train.run --mesh``) held against the JAX package's sharded step
(tests/test_parallel.py:35-129, tests/test_quantized_optim.py:157) and
against the port's own unsharded step.

The mesh cases run on 8 ranks of one gloo group on the CPU, spawned once
for the module (``tests/_torch_dist_helpers.py``); the JAX side and the
port's unsharded references run here while they do, JAX on the 8 virtual
devices of ``conftest.py``. Every statistic that spans the batch or a
whole kernel (BatchNorm's and ShiftNormBatch's moments, DoReFa's
``max|tanh W|`` and ``E|W|`` and its gradient quantizer's ``max|g|``, the
elastic penalty, XNOR's gathered alpha, the loss and accuracy) is held to
the unsharded step within 1e-5 on a (4, 2) mesh; the negative controls,
with a rank's own statistic in place of the group's, must miss that bound.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import parallel as jparallel
from pytorch_quantize_impls_tpu import train as jtrain
from pytorch_quantize_impls_tpu.train.steps import make_compute_loss as jax_compute_loss
from pytorch_quantize_impls_tpu_torch import train
from pytorch_quantize_impls_tpu_torch.train import run
from pytorch_quantize_impls_tpu_torch.train.steps import make_compute_loss
from pytorch_quantize_impls_tpu_torch.utils import flax_state_dict

from _torch_dist_helpers import make_model, make_state, start

WORLD = 8
TOL = 1e-5
LM_CFG = dict(vocab=32, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_len=32, n_experts=4)
RUN_STEPS = 4  # train.run --mesh 4,2: a checkpoint every 2, a run stopped at 2 resumed

# label -> (model name, kwargs, input row shape, elastic weight, negative control)
STATISTICS = {
    "dorefa4_max": ("MLP", dict(in_features=32, features=(64, 10), layer="dorefa", bits=4),
                    (32,), 0.0, "shard_statistic"),
    "lenet_batchnorm": ("BNNLeNet", dict(width=8), (28, 28, 1), 0.0, "local_data_mean"),
    "xnor_a1_alpha": ("XNORConvNet", dict(widths=(8, 8), fp32_first_last=True,
                                          image_shape=(8, 8, 1)), (8, 8, 1), 0.0, None),
    "elastic_penalty": ("MLP", dict(in_features=64, features=(32, 32, 10), layer="elastic"),
                        (64,), 100.0, None),
    "shift_norm_batch": ("ShiftNormMLP", {}, (64,), 0.0, "local_data_mean"),
    "g6_gradient": ("MLP", dict(in_features=64, features=(32, 32, 10), layer="dorefa", bits=1,
                                a_bits=2, g_bits=6), (64,), 0.0, None),
}
STAT_STEPS = 2


def _xy(seed, rows, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, *shape)).astype(np.float32),
            (np.arange(rows) % 10).astype(np.int64))


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_state(model, x, sgd):
    """tests/test_parallel.py:16-22."""
    variables = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]))
    opt = optax.sgd(0.1) if sgd else optax.adam(1e-3)
    tx = optax.chain(opt, jtrain.clip_quantized_weights())
    return jtrain.QuantTrainState.create_for(model, variables, tx)


def _jax_variables(state):
    return _tree({"params": state.params, "batch_stats": state.batch_stats})


def _jax_steps(model, x, y, sgd, shape):
    """JAX's local step and its sharded step over ``shape`` from one
    state: (loss, whole variables) of each."""
    xs, ys = jnp.asarray(x), jnp.asarray(y.astype(np.int32))
    sl, ml = jtrain.make_train_step(donate=False)(_jax_state(model, x, sgd), (xs, ys))
    mesh = jparallel.make_mesh(shape)
    state, step = jparallel.make_sharded_train_step(_jax_state(model, x, sgd), mesh)
    ss, ms = step(state, jparallel.shard_batch((x, y.astype(np.int32)), mesh))
    return {"local": (float(ml["loss"]), _jax_variables(sl)),
            "sharded": (float(ms["loss"]), _jax_variables(ss))}


def _port_unsharded(name, kwargs, x, y, opt="sgd", steps=1, elastic_weight=0.0, variables=None):
    """The port's local step on the whole batch: per-step (loss, accuracy)
    and the state dict after."""
    state = make_state(make_model(name, kwargs, variables=variables), opt)
    step = train.make_train_step(elastic_weight=elastic_weight)
    metrics = []
    for _ in range(steps):
        _, m = step(state, (x, y))
        metrics.append((float(m["loss"]), float(m["accuracy"])))
    return metrics, {k: v.detach().numpy() for k, v in state.model.state_dict().items()}


def _gap(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).max())
               for k in a)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, the JAX steps and the port's unsharded steps
    computed while they run."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    job = start(WORLD, tmp)
    dp_model = jmodels.MLP(features=(32, 10), layer="bin")
    dp_xy = _xy(0, 16, (64,))
    tp_model = jmodels.MLP(features=(64, 10), layer="bin")
    tp_xy = _xy(1, 16, (32,))
    v_dp = _jax_variables(_jax_state(dp_model, dp_xy[0], True))
    v_tp = _jax_variables(_jax_state(tp_model, tp_xy[0], False))
    mlp = lambda i, f: ("MLP", dict(in_features=i, features=f, layer="bin"))  # noqa: E731
    stat_xy = {label: _xy(10 + i, 16, spec[2])
               for i, (label, spec) in enumerate(STATISTICS.items())}
    stoch_xy = _xy(0, 16, (784,))
    run_dirs = [str(tmp / "uninterrupted"), str(tmp / "stopped")]
    runs = [["--config", "dorefa_digits_g6", "--mesh", "4,2", "--steps", str(steps),
             "--ckpt-every", "2", "--checkpoint-dir", d, "--device", "cpu"]
            for steps, d in ((RUN_STEPS, run_dirs[0]), (2, run_dirs[1]), (RUN_STEPS, run_dirs[1]))]
    cases = [
        ("train:dp", dict(model=(*mlp(64, (32, 10)), v_dp), x=dp_xy[0], y=dp_xy[1],
                          shape=(8, 1))),
        ("train:dp_tp_adam", dict(model=(*mlp(32, (64, 10)), v_tp), x=tp_xy[0],
                                  y=tp_xy[1], shape=(4, 2), opt="adam")),
        ("train:dp_tp_sgd", dict(model=(*mlp(32, (64, 10)), v_tp), x=tp_xy[0],
                                 y=tp_xy[1], shape=(4, 2))),
        ("train:stochastic", dict(model=("BinaryConnectMLP", dict(hidden=16, deterministic=False),
                                         None), x=stoch_xy[0], y=stoch_xy[1],
                                  shape=(8, 1), opt="adam", steps=3)),
        ("stochastic_block", dict(x=stoch_xy[0])),
        ("adam8", dict(x=stoch_xy[0], y=stoch_xy[1])),
        ("eval", dict(model=("BNNLeNet", dict(width=8)), x=stat_xy["lenet_batchnorm"][0],
                      y=stat_xy["lenet_batchnorm"][1])),
        ("host_sync", dict(x=tp_xy[0], y=tp_xy[1])),
        ("refusals", dict(lm_cfg=LM_CFG)),
        ("run", dict(argvs=runs)),
    ]
    for label, (name, kw, _, weight, control) in STATISTICS.items():
        x, y = stat_xy[label]
        shape = (8, 1) if label == "g6_gradient" else (4, 2)
        common = dict(x=x, y=y, shape=shape, steps=STAT_STEPS, elastic_weight=weight)
        cases.append((f"train:{label}", dict(model=(name, kw, None), **common)))
        if control:
            cases.append((f"train:{label}_control",
                          dict(model=(name, kw, None), control=control, **common)))
    job.run(cases)
    with ThreadPoolExecutor(2) as pool:
        jax_dp = pool.submit(_jax_steps, dp_model, *dp_xy, True, (8, 1))
        jax_tp = pool.submit(_jax_steps, tp_model, *tp_xy, False, (4, 2))
        refs = {"dp": _port_unsharded(*mlp(64, (32, 10)), *dp_xy, variables=v_dp),
                "dp_tp_sgd": _port_unsharded(*mlp(32, (64, 10)), *tp_xy, variables=v_tp),
                "stochastic": _port_unsharded("BinaryConnectMLP",
                                              dict(hidden=16, deterministic=False), *stoch_xy,
                                              opt="adam")}
        for label, (name, kw, _, weight, _) in STATISTICS.items():
            refs[label] = _port_unsharded(name, kw, *stat_xy[label], steps=STAT_STEPS,
                                          elastic_weight=weight)
        jax_out = {"dp": jax_dp.result(), "dp_tp": jax_tp.result()}
    return job.join(), jax_out, refs, stat_xy, run_dirs


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_imported"] == [] for r in ranks[0])


def test_dp_train_step_matches_jax(ranks):
    """tests/test_parallel.py:35-56 on 8 gloo ranks, (8, 1), SGD 0.1 and the
    clamp from one bridged state: the loss within rtol 1e-5 and every
    parameter and statistic within 1e-5 of JAX's local step and of JAX's
    sharded step, and of the port's unsharded step; every rank holds the
    same whole state. With one model rank no layer is column-parallel: the
    step launches no all-gather."""
    got, jax_out, refs, _, _ = ranks
    for r, res in enumerate(got):
        out = res["train:dp"]
        assert out["columns"] == 0 and "all_gather" not in out["collectives"]
        loss = out["metrics"][0][0]
        for kind in ("local", "sharded"):
            jloss, jvars = jax_out["dp"][kind]
            np.testing.assert_allclose(loss, jloss, rtol=TOL)
            want = {k: v.numpy() for k, v in flax_state_dict(jvars).items()}
            assert _gap(out["whole"], want) <= TOL, (r, kind)
        assert _gap(out["whole"], refs["dp"][1]) <= TOL
        assert _gap(out["whole"], got[0]["train:dp"]["whole"]) == 0.0


def test_dp_tp_train_step_matches_jax(ranks):
    """tests/test_parallel.py:71-85 on (4, 2) with Adam: the loss within
    1e-5 of JAX's sharded and local steps (Adam turns reduction-order noise
    in near-zero gradients into +-lr, so parameters are held with SGD, in
    the next test); each rank's kernels and their Adam moments hold half
    the out-features, and both layers run column-parallel (one all-gather
    each per step)."""
    got, jax_out, _, _, _ = ranks
    for res in got:
        out = res["train:dp_tp_adam"]
        assert out["columns"] == 2 and out["collectives"]["all_gather"] == 2
        for kind in ("local", "sharded"):
            np.testing.assert_allclose(out["metrics"][0][0], jax_out["dp_tp"][kind][0],
                                       rtol=TOL, atol=TOL)
        local, moments = out["local_shapes"], out["moment_shapes"]
        assert local["layer0.dense.weight"] == (32, 32)
        assert local["head.dense.weight"] == (5, 64)
        assert local["layer0.dense.bias"] == (64,)
        for key in ("layer0.dense.weight", "head.dense.weight"):
            assert moments[key]["exp_avg"] == local[key]
            assert moments[key]["exp_avg_sq"] == local[key]
        assert moments["layer0.dense.bias"]["exp_avg"] == (64,)


def test_dp_tp_sgd_matches_unsharded(ranks):
    """(4, 2) with SGD: every parameter and statistic within 1e-5 of the
    port's unsharded step, on every rank."""
    got, _, refs, _, _ = ranks
    for res in got:
        out = res["train:dp_tp_sgd"]
        np.testing.assert_allclose(out["metrics"][0][0], refs["dp_tp_sgd"][0][0][0], rtol=TOL)
        assert _gap(out["whole"], refs["dp_tp_sgd"][1]) <= TOL


@pytest.mark.parametrize("label", list(STATISTICS))
def test_statistics_match_unsharded(ranks, label):
    """Each statistic of the table on (4, 2) (G6's cotangent maximum and
    noise on (8, 1)), SGD, STAT_STEPS steps: loss, accuracy, parameters and
    running statistics within 1e-5 of the port's unsharded step; the
    negative control, with a rank's own statistic, misses that bound."""
    got, _, refs, _, _ = ranks
    metrics, whole = refs[label]
    control = STATISTICS[label][4]
    for res in got:
        out = res[f"train:{label}"]
        np.testing.assert_allclose(np.array(out["metrics"]), np.array(metrics), rtol=TOL,
                                   atol=TOL)
        assert _gap(out["whole"], whole) <= TOL
        if control:
            assert _gap(res[f"train:{label}_control"]["whole"], whole) > 10 * TOL


def test_stochastic_draws_identical_across_mesh(ranks):
    """tests/test_parallel.py:102-129: BinaryConnectMLP(hidden=16,
    deterministic=False) on (8, 1), Adam, 3 steps: every rank's state is
    bit-identical; the first loss, before any update, is the unsharded
    step's within 1e-5 (the same draws)."""
    got, _, refs, _, _ = ranks
    first = got[0]["train:stochastic"]
    for res in got:
        out = res["train:stochastic"]
        assert _gap(out["whole"], first["whole"]) == 0.0
        assert np.isfinite(out["metrics"][-1][0])
    np.testing.assert_allclose(first["metrics"][0][0], refs["stochastic"][0][0][0], rtol=TOL)


def test_stochastic_shard_is_block_of_whole_draw(ranks):
    """On (4, 2) a column-sharded stochastic layer draws the whole kernel's
    uniforms and keeps its block: its quantized weight is the block of the
    unsharded draw, bit for bit."""
    for res in ranks[0]:
        out = res["stochastic_block"]
        assert out["column"]
        rows = out["mine"].shape[0]
        m = out["model_rank"]
        assert rows * 2 == out["whole"].shape[0]
        np.testing.assert_array_equal(out["mine"], out["whole"][m * rows:(m + 1) * rows])


def test_quantized_adam_under_dp_mesh(ranks):
    """tests/test_quantized_optim.py:157: the 8-bit Adam on (8, 1), 2 steps:
    the loss finite, its int8/uint8 codes advanced, every code and scale
    bit-identical across ranks; under (4, 2) the step refuses it."""
    got = ranks[0]
    first = got[0]["adam8"]["state"]
    codes = [v for k, v in first.items() if v.dtype in (np.int8, np.uint8)]
    assert codes and any(np.abs(c.astype(np.int32)).sum() for c in codes)
    for res in got:
        out = res["adam8"]
        assert np.isfinite(out["losses"]).all()
        for k, v in out["state"].items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)
        assert "QuantizedAdam under a model axis > 1" in out["refused"]
        assert "(b3)" in out["refused"]


def test_sharded_eval_step(ranks):
    """make_sharded_eval_step on (4, 2) (bnn_lenet at width 8): loss,
    accuracy and count equal the unsharded eval of the whole batch."""
    got, _, _, stat_xy, _ = ranks
    x, y = stat_xy["lenet_batchnorm"]
    ref = train.make_eval_step()(make_state(make_model("BNNLeNet", dict(width=8)), "sgd"), (x, y))
    for res in got:
        out = res["eval"]
        np.testing.assert_allclose(out["loss"], float(ref["loss"]), rtol=1e-6)
        assert out["accuracy"] == pytest.approx(float(ref["accuracy"]), abs=1e-7)
        assert out["count"] == 16


def test_assert_host_sync(ranks):
    """assert_host_sync passes on a synced (4, 2) state; with one rank's
    replicated bias one ulp off it raises on every rank."""
    for res in ranks[0]:
        assert "rank 3 diverged: its replicated digest" in res["host_sync"]["raised"]


def test_make_compute_loss_matches_jax():
    """One process, no ranks: the port's make_compute_loss gives JAX's loss
    and logits within 1e-6 from one bridged state (the BNN LeNet at width
    8, in training mode)."""
    jm = jmodels.BNNLeNet(width=8)
    x, y = _xy(5, 8, (28, 28, 1))
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]), train=True)
    js = jtrain.QuantTrainState.create_for(
        jm, variables, optax.chain(optax.adam(1e-3), jtrain.clip_quantized_weights()))
    jloss, (jlogits, _) = jax.jit(jax_compute_loss(js, jnp.asarray(x), jnp.asarray(
        y.astype(np.int32))))(js.params)
    state = make_state(make_model("BNNLeNet", dict(width=8), variables=_tree(variables)), "adam")
    state.model.train()
    with torch.no_grad():
        loss, logits = make_compute_loss(state, torch.from_numpy(x), torch.from_numpy(y))()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def test_train_run_mesh_resumes_bit_for_bit(ranks):
    """train.run --config dorefa_digits_g6 --mesh 4,2 --device cpu, 4
    steps, a checkpoint every 2: a run stopped after its step-2 checkpoint
    and run again resumes and ends on the same bits as the uninterrupted
    run (both whole checkpoints at step 4, every rank's whole model);
    rank 0 alone evaluates."""
    got, _, _, _, run_dirs = ranks
    whole, stopped, resumed = got[0]["run"]
    assert stopped["result"]["steps"] == 2 and resumed["result"]["steps"] == RUN_STEPS
    for key in ("loss", "accuracy", "packed_accuracy"):
        assert resumed["result"][key] == whole["result"][key]
    assert whole["result"]["mesh"] == [4, 2]
    for res in got:
        a, _, b = res["run"]
        assert a["digest"] == whole["digest"] and b["digest"] == whole["digest"]
        assert "accuracy" not in a["result"] or res is got[0]
    ckpts = [torch.load(os.path.join(d, str(RUN_STEPS), "state.pt"), weights_only=True)
             for d in run_dirs]
    for key in ("model",):
        for k, v in ckpts[0][key].items():
            assert torch.equal(v, ckpts[1][key][k]), k
    for i, st in ckpts[0]["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ckpts[1]["optimizer"]["state"][i][k]), (i, k)
    assert ckpts[0]["model"]["layer0.dense.weight"].shape == (512, 64)
    assert ckpts[0]["optimizer"]["state"][0]["exp_avg"].shape == (512, 64)


def test_refusals(ranks):
    """Out-features that do not divide over "model" (10 over 4), a batch
    that does not divide over "data" (10 rows over 4), an MoE LM placed by
    shard_experts; here, --mesh with no process group."""
    for res in ranks[0]:
        out = res["refusals"]
        assert "size 10 does not divide over the 4 ranks of 'model'" in out["features"]
        assert "size 10 does not divide over the 4 ranks of 'data'" in out["batch"]
        assert "QuantMoE" in out["moe_ep"] and "(b3)" in out["moe_ep"]
    with pytest.raises(ValueError, match="--mesh needs a process group"):
        run.main(["--config", "binaryconnect_digits", "--mesh", "1,1", "--device", "cpu"])
