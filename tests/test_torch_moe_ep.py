"""Expert parallelism (EP) of the port's switch MoE (``parallel.shard_experts``,
``nn.moe.switch_ffn(ep=)``), held against the JAX package's replicated forward
(tests/test_moe.py::test_moe_ep_sharding_parity,
tests/test_transformer.py::test_moe_transformer_ep_parity_and_aux).

Eight ranks of one gloo group on the CPU, spawned once for the module
(``tests/_torch_dist_helpers.py``), over a (2, 4) mesh: the tokens over
``"data"``, the expert stacks over ``"model"`` (one expert per rank). Each
data rank's output rows must be within JAX's tolerances of JAX's replicated
output at its tokens (1e-4 / 1e-5 for the layer, 2e-4 / 2e-4 for the LM),
the same on every model rank; its routing and keep mask must equal the
port's replicated ``switch_route`` at its tokens; the aux loss must be
within 1e-6 (1 + |ref|) of JAX's.

Every expert scheme the port's MoE takes runs, the experts' masters scaled
apart (expert e's by (e + 1) / 4), so that a statistic of the whole stack
(DoReFa's ``max |tanh w|``, one-bit DoReFa's ``E|W|``) differs from any
one shard's: DoReFa 4-bit experts quantized with their shard's own maximum
must fail the gate, which shows that the reduction over the model group is
what makes EP compute the replicated function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_quantize_impls_tpu import nn as jqnn
from pytorch_quantize_impls_tpu.models.transformer import QuantTransformerLM as JLM
from pytorch_quantize_impls_tpu.nn.moe import QuantMoE as JMoE
from pytorch_quantize_impls_tpu_torch.nn.moe import switch_route

from _torch_dist_helpers import start

WORLD = 8
E, D, F = 4, 16, 32  # tests/test_moe.py:15
CF = 4.0  # tests/test_moe.py:80, tests/test_transformer.py:130
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
LM_TOL = dict(rtol=2e-4, atol=2e-4)
SCALES = np.array([0.25, 0.5, 0.75, 1.0], np.float32)
SCHEMES = {"binary": dict(scheme="binary"), "xnor": dict(scheme="xnor"),
           "ternary": dict(scheme="ternary"), "dorefa1": dict(scheme="dorefa", w_bits=1),
           "dorefa2": dict(scheme="dorefa", w_bits=2), "dorefa4": dict(scheme="dorefa", w_bits=4),
           "log": dict(scheme="log", w_bits=4), "lin": dict(scheme="lin", w_bits=4, fsr=1.0),
           "none": dict(scheme="none")}
# tests/test_transformer.py:18-25, 130: one MoE block, 4 experts
LM_CFG = dict(vocab=32, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_len=32,
              n_experts=4, capacity_factor=CF)
LM_SCHEMES = {"binary": {}, "dorefa2": dict(scheme="dorefa", w_bits=2)}


def _x():
    """tests/test_moe.py:81: 32 tokens."""
    return np.random.default_rng(2).normal(size=(32, D)).astype(np.float32)


def _layers():
    """{label: (kwargs, params)}: the JAX test's layer (flax init,
    ``PRNGKey(0)``), and each scheme on masters uniform(-1, 1) scaled apart
    per expert."""
    x = _x()
    jm = JMoE(n_experts=E, d_ff=F, capacity_factor=CF)
    jax_init = jax.jit(lambda k: jm.init({"params": k}, jnp.asarray(x)))(
        jax.random.PRNGKey(0))["params"]
    out = {"jax init": ({}, jax.tree_util.tree_map(np.array, dict(jax_init)))}
    rng = np.random.default_rng(11)
    for label, kw in SCHEMES.items():
        params = {"router": (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32),
                  "wi_kernel": rng.uniform(-1, 1, (E, D, F)).astype(np.float32)
                  * SCALES[:, None, None],
                  "wo_kernel": rng.uniform(-1, 1, (E, F, D)).astype(np.float32)
                  * SCALES[:, None, None]}
        out[label] = (kw, params)
    return out


def _jax_out_aux(apply, *args):
    """(output, summed aux loss) of a flax ``apply`` that sows ``losses``,
    jitted as the JAX tests run their sharded forwards."""
    def f(*a):
        out, st = apply(*a, mutable=["losses"])
        return out, jqnn.collect_elastic_losses(st)

    out, aux = jax.jit(f)(*args)
    return np.asarray(out), float(aux)


def _jax_layer(kw, params, x):
    jm = JMoE(n_experts=E, d_ff=F, capacity_factor=CF, **kw)
    return _jax_out_aux(lambda p, x, **m: jm.apply({"params": p}, x, **m), params, jnp.asarray(x))


def _lm_variables(kw):
    jm = JLM(**LM_CFG, **kw)
    v = jax.jit(lambda k: jm.init({"params": k}, _tokens(), train=False))(jax.random.PRNGKey(0))
    return jm, {"params": jax.tree_util.tree_map(np.array, v["params"])}


def _tokens():
    """tests/test_transformer.py:28-30: (4, 16) tokens."""
    return np.random.default_rng(0).integers(0, LM_CFG["vocab"], (4, 16)).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, and JAX's replicated outputs and aux losses
    computed while they run."""
    job = start(WORLD, tmp_path_factory.mktemp("moe_ep"))
    layers, x = _layers(), _x()
    lms = {label: _lm_variables(kw) for label, kw in LM_SCHEMES.items()}
    cases = [("moe_layer", dict(layers=layers, x=x, capacity_factor=CF))]
    job.run(cases + [(f"moe_lm:{label}", dict(cfg=dict(LM_CFG, **LM_SCHEMES[label]), variables=v,
                                              tokens=_tokens())) for label, (_, v) in lms.items()])
    refs = {label: _jax_layer(kw, params, x) for label, (kw, params) in layers.items()}
    for label, (jm, v) in lms.items():
        refs[f"lm:{label}"] = _jax_out_aux(lambda v, t, **m: jm.apply(v, t, train=False, **m),
                                           v, jnp.asarray(_tokens()))
    return job.join(), refs, layers


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_imported"] == [] for r in ranks[0])


def _by_data_rank(ranks, key, field):
    """{data index: the field}, checked equal over the data index's model
    ranks."""
    out = {}
    for res in ranks:
        d = res["moe_layer"]["coord"][0]
        got = res[key] if key.startswith("moe_lm") else res["moe_layer"][key]
        value = got[field]
        if d in out:
            np.testing.assert_array_equal(value, out[d])
        out[d] = value
    return out


@pytest.mark.parametrize("label", ["jax init", *SCHEMES])
def test_moe_ep_sharding_parity(ranks, label):
    ranks, refs, layers = ranks
    _, params = layers[label]
    x = _x()
    ref, ref_aux = refs[label]
    with torch.no_grad():
        r = switch_route(torch.from_numpy(x), torch.from_numpy(params["router"]), CF)
    outs = _by_data_rank(ranks, label, "out")
    for d, out in outs.items():
        rows = slice(d * 16, (d + 1) * 16)
        np.testing.assert_allclose(out, ref[rows], **LAYER_TOL)
        np.testing.assert_array_equal(_by_data_rank(ranks, label, "expert")[d],
                                      r.expert[rows].numpy())
        np.testing.assert_array_equal(_by_data_rank(ranks, label, "keep")[d],
                                      r.keep[rows].numpy())
    for res in ranks:
        got = res["moe_layer"][label]
        assert got["experts_held"] == 1
        assert abs(got["aux"] - ref_aux) <= 1e-6 * (1 + abs(ref_aux))
        if label == "dorefa4":  # the shard's own statistic computes another function
            d = res["moe_layer"]["coord"][0]
            local = got["local_stat_out"]
            assert not np.allclose(local, ref[d * 16:(d + 1) * 16], **LAYER_TOL)


def test_moe_ep_refuses_autograd(ranks):
    assert all("forward only" in res["moe_layer"]["grad_refused"] for res in ranks[0])


@pytest.mark.parametrize("label", list(LM_SCHEMES))
def test_moe_transformer_ep_parity_and_aux(ranks, label):
    ranks, refs, _ = ranks
    ref, ref_aux = refs[f"lm:{label}"]
    assert ref_aux > 0
    logits = _by_data_rank(ranks, f"moe_lm:{label}", "logits")
    for d, got in logits.items():
        np.testing.assert_allclose(got, ref[d * 2:(d + 1) * 2], **LM_TOL)
    for res in ranks:
        got = res[f"moe_lm:{label}"]
        assert got["experts_held"] == [1]
        assert abs(got["aux"] - ref_aux) <= 1e-6 * (1 + abs(ref_aux))


def test_decode_engine_refuses_expert_parallel_lm(ranks):
    """An MoE LM placed by shard_experts: DecodeEngine refuses it with a
    mesh and without, since rank 0's lone prefill would enter the
    data-group collectives of its MoE blocks."""
    for res in ranks[0]:
        for label in LM_SCHEMES:
            got = res[f"moe_lm:{label}"]
            assert "placed by parallel.shard_experts" in got["decode_mesh"]
            assert "placed by parallel.shard_experts" in got["decode_alone"]


def test_expert_sharding_rules_match_jax():
    """nn/moe.py:139-143: the expert stacks, by path, in either package's
    path style; the router and the rest are not."""
    from pytorch_quantize_impls_tpu.nn.moe import expert_sharding_rules as jrules
    from pytorch_quantize_impls_tpu_torch.nn.moe import expert_sharding_rules

    for path in ("['params']['block0']['moe']['wi_kernel']", "block0.moe.wo_kernel",
                 "block0.moe.router", "['params']['block0']['attn']['q']['kernel']",
                 "wi_kernel", "block1.moe.wi_kernel.bias"):
        assert expert_sharding_rules(path) == jrules(path)
