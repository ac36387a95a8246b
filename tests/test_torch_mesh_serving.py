"""The port's engines over a (data, model) mesh (``serve.DecodeEngine(mesh=)``
and ``serve.InferenceEngine(mesh=)``), held against the JAX package's
(tests/test_decode_engine.py::test_mesh_sharded_engine_matches_generate,
tests/test_serve.py::test_mesh_sharded_serving).

The engines run on 8 ranks of one gloo group on the CPU, spawned once for
the module (``tests/_torch_dist_helpers.py``): rank 0 serves, the others
take their part of every tick and check that ``submit`` refuses them. The
JAX side and the port's engines without a mesh run here.

* Decode: the W1A1 LM of the JAX test (``PRNGKey(2)``), 8 slots, six
  prompts, 5 new tokens: fake-quant over (4, 2), packed over (4, 2) (slots
  over data, whole records), packed over (2, 4) (the dense records
  column-sharded over the model axis, K1's plain version on each shard and
  an all-gather per projection) and prepared over (2, 4) (K3's). Each
  request's tokens equal JAX's ``generate`` and the port's engine without
  a mesh exactly; 6 slots on the 4-way data axis raise.
* Classifier: the packed binary MLP over (8, 1), buckets (8, 32): within
  JAX's ``rtol 1e-4, atol 1e-5`` of JAX's forward, and bit-equal to the
  port's engine without a mesh serving the same rows in the blocks each
  data rank computes (4 rows): the CPU's float GEMM rounds a row
  differently at another row count, so an engine that batches the rows
  otherwise may part in the last bit. Batch sizes that do not divide the
  data axis raise.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import serve as jserve
from pytorch_quantize_impls_tpu.models.transformer import QuantTransformerLM as JLM
from pytorch_quantize_impls_tpu_torch import infer, models, serve
from pytorch_quantize_impls_tpu_torch.models import QuantTransformerLM
from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine
from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

from _torch_dist_helpers import start

WORLD = 8
CPU = "cpu"
# tests/test_decode_engine.py:133-136
LM_CFG = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32,
              scheme="binary", w_bits=1, a_bits=1)
MAX_NEW = 5
DECODE_CASES = {"fake 4x2": ("fake", (4, 2)), "packed 4x2": ("packed", (4, 2)),
                "packed 2x4": ("packed", (2, 4)), "prepared 2x4": ("prepared", (2, 4))}


def _prompts(seed=7, lens=(3, 7, 5, 9, 4, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, LM_CFG["vocab"], size=(n,)).astype(np.int32) for n in lens]


def _lm():
    jm = JLM(**LM_CFG)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, 4), jnp.int32), train=False))(
        jax.random.PRNGKey(2))
    return jm, jax.tree_util.tree_map(np.array, v)


MLP_X0 = jnp.zeros((1, 64))


def _mlp():
    """tests/test_serve.py:19-25: the binary MLP and its variables."""
    jm = jmodels.MLP(features=(32, 10), layer="bin")
    v = jax.jit(lambda k: jm.init({"params": k}, MLP_X0, train=False))(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.array, v)


def _xs():
    return np.random.default_rng(1).normal(size=(32, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, and JAX's reference answers computed while they
    run: the tokens of ``generate`` and the MLP's forward."""
    job = start(WORLD, tmp_path_factory.mktemp("mesh_serving"))
    jm, lm_vars = _lm()
    jmlp, mlp_vars = _mlp()
    cases = [(f"decode:{label}", dict(cfg=LM_CFG, variables=lm_vars, prompts=_prompts(),
                                      max_new=MAX_NEW, shape=shape, backend=backend))
             for label, (backend, shape) in DECODE_CASES.items()]
    job.run(cases + [("serving", dict(variables=mlp_vars, xs=_xs()))])
    # generate compiles once per prompt length: the six compile side by side
    with ThreadPoolExecutor(len(_prompts())) as pool:
        tokens = [pool.submit(lambda p: np.asarray(jserve.generate(
            jm, lm_vars["params"], jnp.asarray(p[None]), MAX_NEW)[0]), p) for p in _prompts()]
        jpacked = jinfer.prepare(jinfer.pack_model(jmlp, mlp_vars, MLP_X0))
        refs = {"mlp": np.asarray(jinfer.packed_apply(jmlp, mlp_vars, jpacked,
                                                      jnp.asarray(_xs()))),
                "generate": [t.result() for t in tokens]}
    return job.join(), refs, lm_vars, mlp_vars


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_imported"] == [] for r in ranks[0])


@pytest.mark.parametrize("label", list(DECODE_CASES))
def test_mesh_sharded_engine_matches_generate(ranks, label):
    backend, (n_data, n_model) = DECODE_CASES[label]
    ranks, refs, v, _ = ranks
    prompts = _prompts()
    got = ranks[0][f"decode:{label}"]
    expected = refs["generate"]
    tm = load_flax_variables(QuantTransformerLM(**LM_CFG), v, device=CPU).eval()
    packed = None if backend == "fake" else infer.pack_model(tm)
    if backend == "prepared":
        packed = infer.prepare(packed)
    eng = serve.DecodeEngine(tm, packed=packed, n_slots=8, device=CPU)
    try:
        alone = [f.result(timeout=120) for f in [eng.submit(p, max_new=MAX_NEW) for p in prompts]]
    finally:
        eng.shutdown()
    for p, g, e, a in zip(prompts, got["tokens"], expected, alone):
        np.testing.assert_array_equal(g, e)
        np.testing.assert_array_equal(g, a)
    assert got["stats"] == (len(prompts), MAX_NEW * len(prompts))
    per = 8 // n_data
    for r, res in enumerate(ranks):
        out = res[f"decode:{label}"]
        assert out["slots"] == ((r // n_model) * per, (r // n_model + 1) * per)
        assert out["tp"] == (backend != "fake" and n_model > 1)
        if r:
            assert "only rank 0" in out["refused"]
        if n_data == 4:
            assert "must divide over the data axis (4)" in out["six_slots"]


def test_mesh_sharded_serving(ranks):
    ranks, refs, _, v = ranks
    xs = _xs()
    out = ranks[0]["serving"]
    np.testing.assert_allclose(out["answers"], refs["mlp"], rtol=1e-4, atol=1e-5)
    tm = load_flax_variables(models.MLP(64, features=(32, 10), layer="bin"), v, device=CPU).eval()
    packed = infer.prepare(infer.pack_model(tm))
    eng = InferenceEngine(lambda x: infer.packed_apply(tm, packed, x), (64,), batch_sizes=(4,),
                          max_delay_ms=1000, device=CPU)
    try:
        alone = np.stack([f.result(timeout=60) for f in [eng.submit(x) for x in xs]])
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(out["answers"], alone)
    assert out["batches"] == 1  # all 32 rows in one bucket
    for r, res in enumerate(ranks):
        got = res["serving"]
        # warmup's buckets 8 and 32, then the requests' 32: b / 8 rows each
        assert got["rows"] == [1, 4, 4]
        assert "do not divide over the data axis (8)" in got["four"]
        if r:
            assert "only rank 0" in got["refused"]
