"""The port's mesh and placement rules (``parallel``) and the column shards
of packed dense records (``infer.shard_packed``), held against the JAX
package (``parallel/mesh.py``, ``parallel/sharding.py``,
``infer/packed.py``'s ``packed_tp_specs``; tests/test_parallel.py).

The mesh cases run on 8 ranks of one gloo group on the CPU, spawned once
for the module (``tests/_torch_dist_helpers.py``); the JAX side runs here
on the 8 virtual devices of ``conftest.py``. The shard tests need no
group: a model rank's shard run through the kernels' plain versions must
give exactly the matching columns of the unsharded output, and a shard cut
from a JAX artifact the same words as the JAX package's own column block.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import parallel as jparallel
from pytorch_quantize_impls_tpu.infer.packed import packed_tp_specs
from pytorch_quantize_impls_tpu_torch import infer, models, nn as tnn
from pytorch_quantize_impls_tpu_torch.infer.packed import _dense_forward_2d
from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

from _torch_dist_helpers import start

WORLD = 8


def _placement_variables():
    """tests/test_parallel.py:59-63: the DoReFa MLP on a (1, 32) input."""
    model = jmodels.MLP(features=(64, 10), layer="dorefa", bits=4)
    v = model.init({"params": jax.random.PRNGKey(0)}, jnp.ones((1, 32)))
    return jax.tree_util.tree_map(np.array, v)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, and the JAX artifacts computed while they run."""
    job = start(WORLD, tmp_path_factory.mktemp("parallel"))
    variables = _placement_variables()
    rng = np.random.default_rng(3)
    moe_params = {"router": rng.normal(size=(8, 4)).astype(np.float32),
                  "wi_kernel": rng.normal(size=(4, 8, 16)).astype(np.float32),
                  "wo_kernel": rng.normal(size=(4, 16, 8)).astype(np.float32)}
    job.run([("mesh_shapes", {}),
             ("placement", dict(variables=variables, moe_params=moe_params))])
    with ThreadPoolExecutor(len(JAX_MLPS)) as pool:
        artifacts = {layer: pool.submit(_jax_artifact, layer, tmp_path_factory.mktemp(layer))
                     for layer in JAX_MLPS}
        artifacts = {layer: a.result() for layer, a in artifacts.items()}
    return job.join(), variables, moe_params, artifacts


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_imported"] == [] for r in ranks[0])


def test_mesh_shapes(ranks):
    """tests/test_parallel.py:26-32: every rank on data by default, the
    (4, 2) mesh's axis names, (3, 2) on 8 ranks raises; a cuda mesh over a
    gloo group raises too. Ranks lie row-major: rank = 2 d + m."""
    got = ranks[0]
    jmesh = jparallel.make_mesh((4, 2))
    for r, res in enumerate(got):
        out = res["mesh_shapes"]
        assert out["auto"] == ((WORLD, 1), ("data", "model"))
        assert out["4x2"] == ((4, 2), tuple(jmesh.axis_names))
        assert out["coord"] == (r // 2, r % 2)
        assert "(3, 2) != world size 8" in out["3x2"]
        assert "needs a nccl group" in out["cuda"]
    with pytest.raises(ValueError):
        jparallel.make_mesh((3, 2))


def test_tp_sharding_placement(ranks):
    """tests/test_parallel.py:59-68 on (4, 2): each kernel's out-features
    over "model" (the port's (out, in) weight on dimension 0), biases and
    BatchNorm replicated; a rank's block of ``layer0.dense.weight`` holds
    N/2 rows, which are the columns of JAX's shard at its model index."""
    got, variables, _, _ = ranks
    mesh = jparallel.make_mesh((4, 2))
    k = variables["params"]["layer0"]["dense"]["kernel"]
    spec = jparallel.param_shardings(variables["params"], mesh)["layer0"]["dense"]["kernel"].spec
    assert spec == P(None, jparallel.MODEL_AXIS)
    sharded = jax.device_put(jnp.asarray(k), NamedSharding(mesh, spec))
    jax_blocks = {(s.index[1].start or 0): np.asarray(s.data) for s in sharded.addressable_shards}
    for res in got:
        out = res["placement"]
        _, m = out["coord"]
        pl = out["placements"]
        assert pl["layer0.dense.weight"] == ("Replicate()", "Shard(dim=0)")
        assert pl["head.dense.weight"] == ("Replicate()", "Shard(dim=0)")
        assert pl["layer0.dense.bias"] == ("Replicate()", "Replicate()")
        assert all(pl[key] == ("Replicate()", "Replicate()") for key in pl if "bn" in key)
        w = out["local"]["layer0.dense.weight"]
        assert w.shape == (k.shape[1] // 2, k.shape[0])
        np.testing.assert_array_equal(w, jax_blocks[m * k.shape[1] // 2].T)
        np.testing.assert_array_equal(w, k[:, m * 32:(m + 1) * 32].T)
        head = variables["params"]["head"]["dense"]["kernel"]
        np.testing.assert_array_equal(out["local"]["head.dense.weight"],
                                      head[:, m * 5:(m + 1) * 5].T)
        np.testing.assert_array_equal(out["local"]["layer0.dense.bias"],
                                      variables["params"]["layer0"]["dense"]["bias"])


def test_moe_placement_rules(ranks):
    """A QuantMoE's stacks under the two rules: JAX's ``_spec_for_path``
    shards a ``*_kernel`` on its last (flax) axis over "model", and the EP
    rule (``expert_sharding_rules``) on the expert axis; the router is
    replicated by both. shard_experts leaves model rank m its block of
    E/2 experts of each stack, from expert 2m on."""
    from pytorch_quantize_impls_tpu.nn.moe import expert_sharding_rules as jrules
    from pytorch_quantize_impls_tpu.parallel.sharding import _spec_for_path

    got, _, moe_params, _ = ranks
    for res in got:
        out = res["placement"]
        _, m = out["coord"]
        for key, w in moe_params.items():
            spec = _spec_for_path(f"['params']['{key}']", w)
            tp = ("Replicate()", f"Shard(dim={len(spec) - 1})") if spec else ("Replicate()",) * 2
            assert out["moe"]["tp"][key] == tp
            ep = ("Replicate()", "Shard(dim=0)") if jrules(key) else ("Replicate()",) * 2
            assert out["moe"]["ep"][key] == ep
            if jrules(key):
                np.testing.assert_array_equal(out["moe_stacks"][key], w[2 * m:2 * m + 2])
        assert out["first_expert"] == 2 * m


# --- infer.shard_packed: no group needed ---------------------------------------


K_IN, N_OUT = 48, 32
LAYERS = {
    "binary": lambda: tnn.LinearBin(K_IN, N_OUT),
    "binary a1": lambda: tnn.LinearBin(K_IN, N_OUT, binarize_input=True),
    "xnor": lambda: tnn.XNORLinear(K_IN, N_OUT),
    "xnor a1": lambda: tnn.XNORLinear(K_IN, N_OUT, binarize_input=True),
    "dorefa w1": lambda: tnn.LinearDorefa(K_IN, N_OUT, bits=1),
    "dorefa w1a2": lambda: tnn.LinearDorefa(K_IN, N_OUT, bits=1, a_bits=2),
    "dorefa w2a2": lambda: tnn.LinearDorefa(K_IN, N_OUT, bits=2, a_bits=2),
    "dorefa w4": lambda: tnn.LinearDorefa(K_IN, N_OUT, bits=4),
    "dorefa w4a4": lambda: tnn.LinearDorefa(K_IN, N_OUT, bits=4, a_bits=4),
    "log": lambda: tnn.LinearQuantLog(K_IN, N_OUT, fsr=0.0, bits=4),
    "lin": lambda: tnn.LinearQuantLin(K_IN, N_OUT, fsr=1.0, bits=4),
    "ternary": lambda: tnn.LinearTer(K_IN, N_OUT),
}


def _layer(name):
    torch.manual_seed(5)
    layer = LAYERS[name]()
    with torch.no_grad():  # spread every scheme's grid; ternary's +-0.5 thresholds too
        layer.dense.weight.uniform_(-1.2, 1.2)
    return layer.eval()


@pytest.mark.parametrize("prepared", [False, True], ids=["unprepared", "prepared"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_shard_packed_columns_match_unsharded(name, prepared):
    """Rank r of n (2 and 4) holds columns [r N/n, (r + 1) N/n): its shard's
    GEMM (the plain versions of K1, K3, K6, K8, the real-input matmul)
    equals those columns of the unsharded output exactly; each buffer is a
    contiguous copy, an out-major ``decoded`` stays out-major, and
    one-bit DoReFa's per-tensor alpha keeps the whole tensor's value."""
    rec = infer.pack_model(_layer(name))[("dense",)]
    if prepared:
        rec = infer.prepare({"k": rec})["k"]
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(6, K_IN)).astype(np.float32))
    full = _dense_forward_2d(rec, x, None)
    for n in (2, 4):
        cols = N_OUT // n
        for r in range(n):
            sh = infer.shard_packed_columns({"k": rec}, n, r)["k"]
            assert sh.kernel_shape == (K_IN, cols) and sh.packed.is_contiguous()
            assert torch.equal(sh.packed, rec.packed[:, r * cols:(r + 1) * cols])
            if rec.alpha is not None:
                assert torch.equal(sh.alpha, rec.alpha[r * cols:(r + 1) * cols])
                assert sh.alpha_host == rec.alpha_host or name.startswith("xnor")
            if prepared:
                assert torch.equal(sh.decoded, rec.decoded[:, r * cols:(r + 1) * cols])
                assert sh.decoded.is_contiguous() or sh.decoded.T.is_contiguous()
                assert sh.decoded.T.is_contiguous() == rec.decoded.T.is_contiguous()
            got = _dense_forward_2d(sh, x, None)
            assert torch.equal(got, full[:, r * cols:(r + 1) * cols]), (n, r)


def test_shard_packed_refuses_ragged_columns_and_keeps_convs():
    recs = infer.pack_model(models.BNNLeNet(width=4).eval())
    shards = infer.shard_packed_columns(recs, 2, 1)
    assert shards[("conv1", "conv")] is recs[("conv1", "conv")]  # conv records whole
    assert shards[("fc1", "dense")].kernel_shape[-1] == recs[("fc1", "dense")].kernel_shape[-1] // 2
    with pytest.raises(ValueError, match="do not divide"):
        infer.shard_packed_columns(recs, 3, 0)  # head: 10 columns


JAX_MLPS = {"bin": {}, "dorefa": dict(bits=2), "log": {}}


def _jax_artifact(layer, tmp_path):
    """(JAX records, the port's load of their artifact, the JAX variables)."""
    jm = jmodels.MLP(features=(64, 32), layer=layer, **JAX_MLPS[layer])
    x0 = jnp.zeros((1, 48))
    v = jax.jit(lambda k: jm.init({"params": k}, x0))(jax.random.PRNGKey(1))
    v = jax.tree_util.tree_map(np.array, v)
    jpacked = jinfer.pack_model(jm, v, x0)
    path = os.path.join(tmp_path, "m.npz")
    jinfer.save_packed(path, jpacked)
    return jpacked, infer.load_packed(path, device="cpu"), v


@pytest.mark.parametrize("layer", sorted(JAX_MLPS))
def test_shard_of_jax_artifact_matches_jax_column_block(ranks, layer):
    """A JAX ``pack_model`` artifact loaded by the port and cut by
    ``shard_packed_columns`` gives, at every rank, the JAX record's column
    block (``packed_tp_specs``: ``P(None, axis)``) and the words of a shard
    cut from the port's own pack of the same weights."""
    jpacked, loaded, v = ranks[3][layer]
    tm = load_flax_variables(models.MLP(48, features=(64, 32), layer=layer, **JAX_MLPS[layer]),
                             v, device="cpu").eval()
    own = infer.pack_model(tm)
    specs = packed_tp_specs(jpacked, "model")
    for n in (2, 4):
        for r in range(n):
            a = infer.shard_packed_columns(loaded, n, r)
            b = infer.shard_packed_columns(own, n, r)
            for key, jrec in jpacked.items():
                assert specs[key].packed == P(None, "model")
                cols = jrec.kernel_shape[-1] // n
                words = np.asarray(jrec.packed).view(np.int32)[:, r * cols:(r + 1) * cols]
                np.testing.assert_array_equal(a[key].packed.numpy(), words)
                np.testing.assert_array_equal(b[key].packed.numpy(), words)
