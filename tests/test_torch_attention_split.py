"""The clustered split of K4 ``decode_attention`` (``csrc/decode_attention.cu``)
over the cache, on the CPU.

The CUDA kernel cannot run here. Its launch plan and what its cluster
computes are checked in numpy:

- ``kernels/common.py`` ``attention_plan`` at every shape ``chip_smoke.py``
  gives K4 and at edge shapes: the cluster size C divides the grid, the
  load rounds the ranks own cover the cache exactly once, and a block's
  shared memory (the formula and constants of the CUDA source) fits the
  H100's 227 KB;
- a numpy mirror of the cluster's schedule, driven by the plan: each rank's
  scores over the live rows it owns and its max (masked rows count with
  their bias), the global max M, p = exp(s - M) flushed below FLT_MIN, each
  rank's (sum p, partial context), and the combine in rank order. It is held
  to JAX's ``decode_attention`` (Pallas in interpret mode, as
  tests/test_torch_kernels.py runs it) and to ``decode_attention_reference``
  within ``rtol 1e-5, atol 1e-5 * max|ref|``, and, where a context is exactly
  0 in JAX because a probability flushed against the global M only, bit for
  bit.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu_torch.bench import attention_cost
from pytorch_quantize_impls_tpu_torch.kernels import common
from pytorch_quantize_impls_tpu_torch.kernels import decode_attention as tda

jda = sys.modules["pytorch_quantize_impls_tpu.kernels.decode_attention"]
SOURCE = Path(tda.__file__).resolve().parent.parent / "csrc" / "decode_attention.cu"
FLT_MIN = np.float32(np.finfo(np.float32).tiny)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not in {SOURCE.name}"
    return int(m.group(1))


# --- the launch plan ------------------------------------------------------------

# (b, h, cl, hd): chip_smoke.py's K4 shapes (the decode LM's five, its edges
# and the clustered split's edges), the plain tests' shapes, and shapes at
# the edges of the plan (one round, ragged rounds, a cache that needs the
# split to fit in shared memory)
PLAN_SHAPES = [
    (32, 8, 1024, 128), (1, 8, 1024, 128), (8, 8, 1024, 128),
    (3, 8, 1, 128), (5, 4, 37, 64), (3, 8, 1024, 64), (7, 2, 300, 16),
    (4, 8, 1024, 128), (4, 8, 1024, 256), (2, 8, 8192, 128),
    (3, 4, 64, 32), (1, 8, 1, 128), (2, 8, 256, 128),
    (64, 8, 1024, 128), (1, 1, 33, 128), (1, 1, 60000, 128), (2, 4, 200000, 256),
    (1, 1, 800000, 16),
]


def _owned(plan: dict, rank: int, cl: int) -> np.ndarray:
    """Cache rows rank ``rank`` owns, in its local order: its load rounds
    k C + rank, k = 0, 1, ..., of ``rows`` rows each (the kernel's ``pos``)."""
    c, rows = plan["clusters"], plan["rows"]
    k = np.arange(plan["chunk"] // rows)
    j = ((k[:, None] * c + rank) * rows + np.arange(rows)[None, :]).ravel()
    return j[j < cl]


@pytest.mark.parametrize("b,h,cl,hd", PLAN_SHAPES)
def test_plan_covers_the_cache_once_and_fits(b, h, cl, hd):
    plan = common.attention_plan(b, h, cl, hd)
    c = plan["clusters"]
    assert c in common.ATTN_CLUSTERS
    assert plan["blocks"] == b * h * c and plan["blocks"] % c == 0
    assert plan["rows"] == common.ATTN_WARPS * 32 // (hd // 16)
    assert plan["chunk"] % plan["rows"] == 0 and plan["chunk"] * c >= cl
    assert plan["chunk"] == -(-cl // (plan["rows"] * c)) * plan["rows"]  # ceil(cl / C), rounded up
    rows = np.concatenate([_owned(plan, r, cl) for r in range(c)])
    np.testing.assert_array_equal(np.sort(rows), np.arange(cl))  # every row, once
    assert plan["smem"] == common.attention_smem_bytes(hd, plan["chunk"])
    assert plan["smem"] <= common.WGMMA_SMEM_LIMIT


@pytest.mark.parametrize("b,h,cl,hd", PLAN_SHAPES[:13])
@pytest.mark.parametrize("clusters", common.ATTN_CLUSTERS)
def test_every_cluster_size_covers_the_cache_once(b, h, cl, hd, clusters):
    plan = common.attention_plan(b, h, cl, hd, clusters)
    assert plan["clusters"] == clusters and plan["blocks"] == b * h * clusters
    rows = np.concatenate([_owned(plan, r, cl) for r in range(clusters)])
    np.testing.assert_array_equal(np.sort(rows), np.arange(cl))


def test_default_plan_at_the_decode_lm_shapes():
    """The sweep's picks (bench/attention_cost.py, PERF.md): two blocks per
    (b, h) at b = 32 (512 blocks, four an SM), four at b = 8 and b = 1."""
    assert common.attention_plan(32, 8, 1024, 128)["clusters"] == 2
    assert common.attention_plan(8, 8, 1024, 128)["clusters"] == 4
    assert common.attention_plan(1, 8, 1024, 128)["clusters"] == 4
    assert common.attention_plan(64, 8, 1024, 128)["clusters"] == 1
    assert common.attention_plan(3, 8, 1, 128)["clusters"] == 1  # one round: one block


def test_plan_grows_the_cluster_to_fit_and_refuses_past_it():
    plan = common.attention_plan(1, 1, 400000, 128)
    assert plan["clusters"] == 8 and plan["smem"] <= common.WGMMA_SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        common.attention_plan(1, 1, 60000, 128, 1)
    with pytest.raises(ValueError, match="shared memory"):
        common.attention_plan(1, 1, 16 * 60000, 256)
    with pytest.raises(ValueError, match="must be one of"):
        common.attention_plan(1, 1, 64, 128, 3)
    with pytest.raises(ValueError, match="head dim 8"):
        common.attention_plan(1, 1, 64, 8)


def test_plan_constants_match_the_cuda_source():
    text = SOURCE.read_text()
    assert _constant("THREADS") == common.ATTN_THREADS
    assert _constant("MAX_CLUSTER") == common.ATTN_CLUSTERS[-1]
    assert _constant("SMEM_LIMIT") == common.WGMMA_SMEM_LIMIT
    assert "constexpr int SCALARS = MAX_CLUSTER + 4 * NWARPS;" in text
    assert common.ATTN_SCALARS == common.ATTN_CLUSTERS[-1] + 4 * common.ATTN_WARPS
    assert "(size_t)(NWARPS + 1) * hd + SCALARS + (size_t)chunk" in text
    assert "int C = (int)cluster.num_blocks()" in text  # the cluster size is the launch's
    assert "C != 1 && C != 2 && C != 4 && C != 8 && C != 16" in text


# --- the cluster's schedule, mirrored -------------------------------------------


def mirror(q, kc, ks, vc, vs, bias, plan):
    """What the cluster of ``plan`` computes, in float32 numpy: per rank,
    the scores of its live rows and its max; the global max M; per rank,
    flushed p, sum p and the partial context over rows with p != 0; the
    combine in rank order."""
    b, h, hd = q.shape
    cl = kc.shape[2]
    rs = np.float32(1) / np.sqrt(np.float32(hd))
    out = np.empty((b, h, hd), np.float32)
    for bi in range(b):
        for hi in range(h):
            owned, maxima = [], []
            for r in range(plan["clusters"]):
                j = _owned(plan, r, cl)
                s = bias[bi, j].copy()
                live = s > np.float32(-1e30)
                dot = kc[bi, hi, j[live]].astype(np.float32) @ q[bi, hi]
                s[live] = dot * ks[bi, hi, j[live]] * rs + s[live]
                owned.append((j, s))
                maxima.append(s.max() if len(s) else np.float32(-np.inf))
            m = np.max(np.array(maxima, np.float32))  # the same in every rank
            dens, ctxs = [], []
            for j, s in owned:
                with np.errstate(under="ignore", over="ignore"):
                    p = np.exp(s - m).astype(np.float32)
                p[p < FLT_MIN] = 0.0  # the flush, against the global M
                nz = p != 0
                dens.append(p.sum(dtype=np.float32))
                ctxs.append((p[nz] * vs[bi, hi, j[nz]]) @ vc[bi, hi, j[nz]].astype(np.float32))
            den, ctx = np.float32(0), np.zeros(hd, np.float32)
            for d, c in zip(dens, ctxs):  # rank order
                den, ctx = den + d, ctx + c
            out[bi, hi] = ctx / den
    return out


def _inputs(seed, b, h, cl, hd, lens):
    """Inputs as tests/test_torch_kernels.py draws them: position j of slot
    i is attended iff j < lens[i]."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kc = rng.integers(-127, 128, (b, h, cl, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (b, h, cl, hd)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (b, h, cl)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (b, h, cl)).astype(np.float32)
    bias = np.where(np.arange(cl)[None, :] < np.asarray(lens)[:, None], 0.0, -1e30)
    return q, kc, ks, vc, vs, bias.astype(np.float32)


def _one_live_row_in_the_last_rank(b, h, cl, hd):
    """A cache whose one live row is the last row the last rank owns at
    the default plan."""
    args = list(_inputs(7, b, h, cl, hd, [0] * b))
    plan = common.attention_plan(b, h, cl, hd)
    j = _owned(plan, plan["clusters"] - 1, cl)[-1]
    args[5][:, j] = 0.0
    return tuple(args)


# name -> (b, h, cl, hd, lens): tests/test_torch_kernels.py's shapes, caches
# of no whole number of rounds, one position, a fully masked row, one live
# row in the last rank's last round, the smallest and largest head dims
MIRROR_SHAPES = {
    "kernels 3x4x64x32": (3, 4, 64, 32, [5, 30, 64]),
    "kernels cl=1": (1, 8, 1, 128, [1]),
    "kernels cl=37 hd=64": (5, 2, 37, 64, [1, 37, 20, 2, 36]),
    "kernels 2x8x256x128": (2, 8, 256, 128, [256, 1]),
    "cl=37": (2, 4, 37, 128, [37, 11]),
    "cl=300": (2, 2, 300, 128, [300, 151]),
    "fully masked row": (3, 2, 300, 64, [0, 300, 17]),
    "one live row in the last rank": (2, 2, 1024, 128, None),
    "hd=16": (3, 2, 300, 16, [300, 1, 120]),
    "hd=256": (2, 2, 200, 256, [200, 64]),
}
_refs = {}


def _case(name):
    """(numpy inputs, JAX's output, the plain version's output), once per
    shape."""
    if name not in _refs:
        b, h, cl, hd, lens = MIRROR_SHAPES[name]
        if lens is None:
            args = _one_live_row_in_the_last_rank(b, h, cl, hd)
        else:
            args = _inputs(b * cl + hd, b, h, cl, hd, lens)
        jax_out = np.asarray(jda.decode_attention(*map(jnp.asarray, args)))
        plain = tda.decode_attention(*(torch.from_numpy(a.copy()) for a in args)).numpy()
        _refs[name] = args, jax_out, plain
    return _refs[name]


@pytest.mark.parametrize("clusters", [None, *common.ATTN_CLUSTERS])
@pytest.mark.parametrize("name", list(MIRROR_SHAPES))
def test_mirror_matches_jax_and_the_plain_version(name, clusters):
    args, jax_out, plain = _case(name)
    q, kc = args[0], args[1]
    plan = common.attention_plan(q.shape[0], q.shape[1], kc.shape[2], q.shape[2], clusters)
    got = mirror(*args, plan)
    assert np.isfinite(got).all()
    # float32 sums over the positions in another order than JAX's and the
    # plain version's, and exp carrying an ulp of a score near 20 (2e-6)
    # into every probability: as tests/test_torch_kernels.py holds K4
    for ref in (jax_out, plain):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("clusters", [2, 4, 8, 16])
def test_flush_uses_the_global_max(clusters):
    """Row 0 (rank 0) scores 100, every other row 0: against the global M
    their p is e^-100, subnormal, and XLA flushes it, so the context is row
    0's v, exactly 0. Rescaling a rank's partials from its own max (1 there)
    by e^-100 would keep subnormal terms; the mirror, like the kernel,
    flushes against M and gives JAX's zeros bit for bit."""
    cl, hd = 4096, 16  # 16 rounds of 256 rows: one for every rank at C = 16
    q = np.zeros((1, 1, hd), np.float32)
    q[0, 0, 0] = 1.0
    kc = np.zeros((1, 1, cl, hd), np.int8)
    kc[0, 0, 0, 0] = 100  # score 100 * k_scale 4 * rsqrt(16) = 100; the others 0
    vc = np.ones((1, 1, cl, hd), np.int8)
    vc[0, 0, 0, :] = 0
    ks = np.full((1, 1, cl), 4.0, np.float32)
    vs = np.ones((1, 1, cl), np.float32)
    bias = np.zeros((1, cl), np.float32)
    args = (q, kc, ks, vc, vs, bias)
    plan = common.attention_plan(1, 1, cl, hd, clusters)
    assert all(len(_owned(plan, r, cl)) for r in range(clusters))  # every rank holds rows
    ref = np.asarray(jda.decode_attention(*map(jnp.asarray, args)))
    got = mirror(*args, plan)
    np.testing.assert_array_equal(got, ref)
    assert (got == 0).all()
    plain = tda.decode_attention(*(torch.from_numpy(a.copy()) for a in args)).numpy()
    np.testing.assert_array_equal(plain, ref)


# --- the launcher and the sweep off the card ------------------------------------


def test_launch_refuses_cpu_tensors():
    """``launch`` is the kernel or an error: no plain fallback."""
    args = [torch.from_numpy(a) for a in _inputs(0, 1, 2, 8, 16, [8])]
    with pytest.raises(ValueError, match="decode_attention kernel"):
        tda.launch(*args, common.attention_plan(1, 2, 8, 16))


def test_attention_cost_refuses_without_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="times the card"):
        attention_cost.run()
    with pytest.raises(RuntimeError, match="times the card"):
        attention_cost.run("cpu")
    assert capsys.readouterr().out == ""


def test_attention_cost_times_an_older_checkout_at_its_one_launch(monkeypatch):
    assert [name for name, _ in attention_cost.configs(32)] == [
        f"C={c}" for c in common.ATTN_CLUSTERS]
    monkeypatch.setattr(attention_cost, "attention_plan", None)  # as before the split
    assert attention_cost.configs(32) == [("one block per (b, h)", None)]


def test_attention_cost_shapes_are_chip_smokes():
    shapes = attention_cost.shapes(np.random.default_rng(0))
    assert [s[0] for s in shapes] == ["b=32 engine cursors", "b=1 varied", "b=8 varied",
                                      "b=32 varied", "b=32 full"]
    lens = shapes[0][2]
    assert lens.min() >= 17 and lens.max() <= 160  # the engine's cursors
    assert (shapes[4][2] == attention_cost.CL).all()
