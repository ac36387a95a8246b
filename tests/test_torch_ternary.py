"""PyTorch port of the ternary slice (TernaryConnect), held against the JAX
package.

The deterministic quantizer, the 2-bit planes of ``round(clip(w)) + 1`` and
their decode, ``LinearTer``/``TerConv`` fake-quant and packed, and a small
transformer LM with ``scheme="ternary"`` (weights only) packed and served.
Inputs are made with numpy from a seed and go through both packages on the
CPU. Quantized weights, words and decoded weights are compared bit for bit;
float layers within 1e-5 (products of +-1/0 and x are exact, the float32
sums run in another order); LM logits within 1e-4. The ternary paths run no
TPU kernel in the JAX package (a plain decode and a float dot), and none in
the port. The xnor scheme has no LM in the JAX package: both packages refuse
it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import nn as jnn
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu.infer import packed as jpacked
from pytorch_quantize_impls_tpu.models.transformer import QuantTransformerLM as JLM
from pytorch_quantize_impls_tpu.serve.generate import _MUT
from pytorch_quantize_impls_tpu_torch import infer, models, nn as tnn, ops, serve
from pytorch_quantize_impls_tpu_torch.infer import packed as tpacked
from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

CPU = "cpu"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-4, atol=1e-4)  # float32 LayerNorm, attention and projection sums


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _weights(rng, *shape):
    """Masters around the +-0.5 thresholds and beyond the clip, with exact
    ties at +-0.5 and +-1.5 (round half to even: 0 and +-2 before the clip)."""
    w = rng.uniform(-1.6, 1.6, size=shape).astype(np.float32)
    w.flat[:6] = [0.5, -0.5, 1.5, -1.5, 0.0, -0.0]
    return w


@pytest.mark.parametrize("ste_mode", ["clip", "identity"])
def test_ternary_quantizer_matches_jax(ste_mode):
    rng = np.random.default_rng(0)
    w = _weights(rng, 40, 24)
    g = _normal(rng, 40, 24)
    ref = np.asarray(jops.ternary_connect_det(w, ste_mode=ste_mode))
    ref_g = jax.grad(lambda v: jnp.sum(jops.ternary_connect_det(v, ste_mode=ste_mode) * g))(w)
    wt = _t(w).requires_grad_(True)
    q = ops.ternary_connect_det(wt, ste_mode=ste_mode)
    np.testing.assert_array_equal(q.detach().numpy(), ref)
    assert set(np.unique(ref)) <= {-1.0, 0.0, 1.0} and (ref.flat[:4] == [0, 0, 1, -1]).all()
    (q * _t(g)).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(ref_g))


@pytest.mark.parametrize("shape", [(300, 24), (3, 3, 40, 16)], ids=["dense", "conv"])
def test_ternary_words_and_decode_match_jax(shape):
    """The records of one LinearTer / TerConv: 2-bit planes bit for bit,
    the decode to bf16 {-1, 0, 1} bit for bit (int16 patterns), w_bits 2."""
    rng = np.random.default_rng(1)
    kernel = _weights(rng, *shape)
    conv = len(shape) == 4
    jl = jnn.TerConv(features=shape[-1]) if conv else jnn.LinearTer(features=shape[-1])
    x = _normal(rng, 1, 5, 5, shape[2]) if conv else _normal(rng, 1, shape[0])
    node = "conv" if conv else "dense"
    v = {"params": {node: {"kernel": kernel, "bias": _normal(rng, shape[-1])}}}
    jrec = jax.jit(lambda v, x: jinfer.pack_model(jl, v, x))(v, x)[(node,)]
    tl = (tnn.TerConv(shape[2], shape[-1]) if conv else tnn.LinearTer(shape[0], shape[-1]))
    rec = infer.pack_model(load_flax_variables(tl, v, device=CPU).eval())[(node,)]
    np.testing.assert_array_equal(rec.packed.numpy().view(np.uint32), np.asarray(jrec.packed))
    assert (rec.scheme, rec.w_bits, rec.kind, rec.kernel_shape, rec.alpha) == (
        "ternary", 2, jrec.kind, jrec.kernel_shape, None)
    got = tpacked._decode_weights(rec)
    ref = np.asarray(jax.jit(jpacked._decode_weights)(jrec))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(np.int16))


@pytest.mark.parametrize("conv", [False, True], ids=["LinearTer", "TerConv"])
@pytest.mark.parametrize("prepared", [None, False, True], ids=["fake", "unprepared", "prepared"])
def test_ternary_layers_match_jax(conv, prepared):
    """Fake-quant (``prepared=None``) and packed forwards within 1e-5."""
    rng = np.random.default_rng(2)
    if conv:
        kernel, x = _weights(rng, 3, 3, 12, 16), _normal(rng, 2, 7, 7, 12)
        jl, tl = jnn.TerConv(features=16), tnn.TerConv(12, 16)
        v = {"params": {"conv": {"kernel": kernel, "bias": _normal(rng, 16)}}}
    else:
        kernel, x = _weights(rng, 48, 16), _normal(rng, 5, 48)
        jl, tl = jnn.LinearTer(features=16), tnn.LinearTer(48, 16)
        v = {"params": {"dense": {"kernel": kernel, "bias": _normal(rng, 16)}}}
    load_flax_variables(tl, v, device=CPU).eval()
    if prepared is None:
        ref = jl.apply(v, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = tl(_t(x))
    else:
        jp, tp = jinfer.pack_model(jl, v, jnp.asarray(x)), infer.pack_model(tl)
        if prepared:
            jp, tp = jinfer.prepare(jp), infer.prepare(tp)
        ref = jinfer.packed_apply(jl, v, jp, jnp.asarray(x))
        got = infer.packed_apply(tl, tp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LAYER_TOL)


def test_ternary_spread_init_and_stochastic_refusal():
    """uniform(-1, 1) from an explicit generator, reproducible by its seed;
    stochastic ternarization in training mode refuses to draw outside a
    train step (it never draws from the global RNG), and in eval mode uses
    the clipped master."""
    draws = [tnn.LinearTer(64, 32, generator=torch.Generator().manual_seed(7)).dense.weight
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    w = draws[0].detach()
    assert w.min() >= -1 and w.max() <= 1 and (w.abs() > 0.5).float().mean() > 0.3
    conv = tnn.TerConv(4, 8, generator=torch.Generator().manual_seed(7)).conv.weight
    assert conv.min() >= -1 and conv.max() <= 1
    stoch = tnn.LinearTer(8, 4, deterministic=False)
    x = torch.randn(3, 8)
    with pytest.raises(RuntimeError, match="train step"):
        stoch(x)
    w, b = stoch.dense.weight.detach(), stoch.dense.bias.detach()
    torch.testing.assert_close(stoch.eval()(x), x @ w.clamp(-1, 1).T + b, rtol=0, atol=0)


# --- a small ternary LM ---------------------------------------------------------------

# tests/test_decode_engine.py:19-21's engine model, with ternary weights
TER_LM_CFG = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32,
                  scheme="ternary", w_bits=1, a_bits=0)


@pytest.fixture(scope="module")
def ter_lm():
    jm = JLM(**TER_LM_CFG)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, 4), jnp.int32), train=False))(
        jax.random.PRNGKey(3))
    v = jax.tree_util.tree_map(np.array, v)
    # masters straddling the +-0.5 thresholds: a glorot kernel of this width
    # would quantize to all zeros
    rng = np.random.default_rng(4)
    for i in range(TER_LM_CFG["n_layers"]):
        blk = v["params"][f"block{i}"]
        for node in (*blk["attn"].values(), blk["ffn_in"], blk["ffn_out"]):
            node["kernel"] = _weights(rng, *node["kernel"].shape)
    tm = load_flax_variables(models.QuantTransformerLM(**TER_LM_CFG), v, device=CPU).eval()
    toks = rng.integers(0, 32, (3, 8)).astype(np.int32)
    return jm, v, tm, toks, jax.jit(lambda v, t: jinfer.pack_model(jm, v, t))(v, toks[:1])


def test_ternary_lm_fake_quant_logits_match_jax(ter_lm):
    jm, v, tm, toks, jp = ter_lm
    ref = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, train=False))(v, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(_t(toks)).numpy()
    np.testing.assert_allclose(got, ref, **LM_TOL)


@pytest.mark.parametrize("prepared", [False, True], ids=["unprepared", "prepared"])
def test_ternary_lm_packed_decode_matches_jax(ter_lm, prepared):
    """Prefill and a step of the decode model through packed_apply, port
    against JAX; every record carries the LM's w_bits (1), not 2."""
    jm, v, tm, toks, jp = ter_lm
    tp = infer.pack_model(tm)
    assert set(tp) == set(jp) and len(tp) == 2 * 6
    for path in jp:
        np.testing.assert_array_equal(tp[path].packed.numpy().view(np.uint32),
                                      np.asarray(jp[path].packed))
        assert tp[path].w_bits == jp[path].w_bits == TER_LM_CFG["w_bits"]
    if prepared:
        jp, tp = jax.jit(jinfer.prepare)(jp), infer.prepare(tp)
    md, tmd = jm.clone(decode=True), serve.decode_model(tm)
    step = jax.jit(lambda variables, p, t: jinfer.packed_apply(md, variables, p, t, mutable=_MUT))
    ref, st = step({"params": v["params"]}, jp, jnp.asarray(toks))
    got, cache = infer.packed_apply(tmd, tp, _t(toks), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LM_TOL)
    t = np.argmax(np.asarray(ref)[:, -1], -1).astype(np.int32)[:, None]
    ref, _ = step({"params": v["params"], "cache": st["cache"]}, jp, jnp.asarray(t))
    got, _ = infer.packed_apply(tmd, tp, _t(t), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LM_TOL)


def test_ternary_lm_artifacts_interchange(ter_lm, tmp_path):
    jm, v, tm, toks, jp = ter_lm
    path = os.path.join(tmp_path, "port.npz")
    tp = infer.pack_model(tm)
    infer.save_packed(path, tp)
    for p, rec in jinfer.load_packed(path).items():
        np.testing.assert_array_equal(np.asarray(rec.packed), tp[p].packed.numpy().view(np.uint32))
        assert (rec.scheme, rec.w_bits) == ("ternary", TER_LM_CFG["w_bits"])
    jpath = os.path.join(tmp_path, "jax.npz")
    jinfer.save_packed(jpath, jp)
    loaded = infer.load_packed(jpath, device=CPU)
    np.testing.assert_array_equal(infer.packed_apply(tm, loaded, _t(toks)).numpy(),
                                  infer.packed_apply(tm, tp, _t(toks)).numpy())


def test_ternary_lm_engine_serves_packed(ter_lm):
    """DecodeEngine(packed=) unprepared and prepared give the same tokens,
    and those of the fake-quant generate (float32 sums in another order
    only)."""
    _, _, tm, _, _ = ter_lm
    prompts = [np.random.default_rng(5).integers(0, 32, (n,)).astype(np.int32) for n in (4, 7)]
    packed = infer.pack_model(tm)
    answers = []
    for recs in (packed, infer.prepare(packed)):
        eng = serve.DecodeEngine(tm, packed=recs, n_slots=2, device=CPU)
        try:
            answers.append([eng.submit(p, max_new=4).result(timeout=120) for p in prompts])
        finally:
            eng.shutdown()
    for p, a, b in zip(prompts, *answers):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, serve.generate(tm, p[None], 4, device=CPU)[0].numpy())


@pytest.mark.parametrize("scheme, a_bits", [("ternary", 1), ("ternary", 4), ("xnor", 0),
                                            ("xnor", 1)])
def test_lm_refusals_match_jax(scheme, a_bits):
    """Ternary activations and the xnor scheme raise ValueError in both
    packages: the JAX LM has no xnor weight quantizer."""
    cfg = dict(TER_LM_CFG, scheme=scheme, a_bits=a_bits)
    with pytest.raises(ValueError):  # traced only
        jax.eval_shape(lambda: JLM(**cfg).init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, 4), jnp.int32), train=False))
    with pytest.raises(ValueError):
        models.QuantTransformerLM(**cfg)
