"""The port's switch-routed quantized MoE FFN (``nn.QuantMoE``) and the MoE
LM, held against the JAX package's (``nn/moe.py``, ``models/transformer.py``
with ``n_experts > 0``, tests/test_moe.py).

One set of numpy weights and inputs, drawn from a seed, goes into both
packages (through ``utils.bridge`` for the LM). Tolerances on the CPU:

- routing (the expert of every token) and the keep mask (routed and within
  capacity) equal exactly;
- the layer's output and aux loss within 1e-5 abs + 1e-5 rel (float32
  products in another summation order);
- gradients within 1e-5 of each tensor's max |g|;
- LM logits within 2e-4 (the JAX package's own fused-vs-fake seam, as
  tests/test_torch_decode.py), greedy tokens and the W1A1 KV codes equal;
- bf16: the layer within 2^-6 of |ref| + 2^-8 max |ref| (module test's
  docstring), JAX compiled with ``xla_allow_excess_precision`` off as in
  tests/test_torch_mixed_precision.py.
"""

import copy
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import nn as jqnn
from pytorch_quantize_impls_tpu import serve as jserve
from pytorch_quantize_impls_tpu import train as jtrain
from pytorch_quantize_impls_tpu.models.transformer import QuantTransformerLM as JLM
from pytorch_quantize_impls_tpu.nn.moe import QuantMoE as JMoE
from pytorch_quantize_impls_tpu.serve import decode_engine as jde
from pytorch_quantize_impls_tpu.serve.generate import _MUT
from pytorch_quantize_impls_tpu.train.steps import cross_entropy as jcross_entropy
from pytorch_quantize_impls_tpu.train.steps import make_compute_loss
from pytorch_quantize_impls_tpu_torch import infer, nn as tnn, ops, serve, train
from pytorch_quantize_impls_tpu_torch.models import QuantTransformerLM
from pytorch_quantize_impls_tpu_torch.nn.moe import capacity, switch_route
from pytorch_quantize_impls_tpu_torch.serve import decode_engine as tde
from pytorch_quantize_impls_tpu_torch.train.clipping import default_clip_filter, keystr
from pytorch_quantize_impls_tpu_torch.utils import flax_paths, flax_variables, load_flax_variables

CPU = "cpu"
E, D, F = 4, 16, 32  # tests/test_moe.py:15
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5  # of a tensor's max |g|
LM_TOL = dict(rtol=2e-4, atol=2e-4)
# the JAX tests' LM width (tests/test_torch_decode.py FUSED_CFG) with 4 experts
LM_CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64,
              scheme="binary", w_bits=1, a_bits=1, n_experts=4, capacity_factor=1.0)
W4A4_CFG = dict(LM_CFG, scheme="dorefa", w_bits=4, a_bits=4)
SCHEMES = {"binary": {}, "ternary": {}, "dorefa": dict(w_bits=4), "log": dict(w_bits=4),
           "lin": dict(w_bits=4, fsr=1.0), "none": {}}
FACTORS = (8.0, 1.0, 1e-9)


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_params(rng, d=D, e=E, f=F):
    """Router N(0, 1/d); expert masters uniform(-1, 1), which every scheme's
    grid resolves (ternary's +-0.5 thresholds included)."""
    return {"router": (rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32),
            "wi_kernel": rng.uniform(-1, 1, (e, d, f)).astype(np.float32),
            "wo_kernel": rng.uniform(-1, 1, (e, f, d)).astype(np.float32)}


def _port_moe(params, **kw):
    m = tnn.QuantMoE(D, E, F, device=CPU, **kw)
    with torch.no_grad():
        for k, v in params.items():
            getattr(m, k).copy_(_t(v))
    return m


def _jax_routing(x2d, router, cf):
    """JAX's routing, in jnp as nn/moe.py:79-105 computes it: (expert, keep)."""
    t, e = x2d.shape[0], router.shape[1]
    cap = max(min(int(-(-t // e) * cf), t), 1)
    probs = jax.nn.softmax(jnp.asarray(x2d, jnp.float32) @ jnp.asarray(router), axis=-1)
    onehot = jax.nn.one_hot(jnp.argmax(probs, axis=-1), e, dtype=jnp.float32)
    pos = jnp.cumsum(onehot, axis=0) * onehot
    return np.asarray(jnp.argmax(probs, axis=-1)), np.asarray((pos <= cap) & (onehot > 0))


def _jax_moe(params, x, **kw):
    """(out, aux) of JAX's QuantMoE on these params."""
    jm = JMoE(n_experts=E, d_ff=F, **kw)
    out, st = jm.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    return np.asarray(out), float(jqnn.collect_elastic_losses(st))


# --- the layer ------------------------------------------------------------------


def test_capacity_is_jax_arithmetic():
    """nn/moe.py:79-80: ceil(t / e) * factor in Python floats, truncated,
    within [1, t]."""
    assert capacity(24, 4, 8.0) == 24 and capacity(24, 4, 1.0) == 6
    assert capacity(24, 4, 1e-9) == 1 and capacity(25, 4, 1.0) == 7
    assert capacity(32, 8, 2.0) == 8 and capacity(3, 4, 2.0) == 2 and capacity(7, 3, 1.25) == 3


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_moe_layer_matches_jax(scheme, cf):
    """Each scheme at each capacity factor: the same tokens routed to the same
    experts and kept or dropped alike; the output and the aux loss within
    1e-5 abs + 1e-5 rel. Inputs (2, 12, D): the tokens flatten row-major."""
    rng = np.random.default_rng(11)
    params = _moe_params(rng)
    x = rng.normal(size=(2, 12, D)).astype(np.float32)
    kw = dict(scheme=scheme, capacity_factor=cf, **SCHEMES[scheme])
    ref, ref_aux = _jax_moe(params, x, **kw)
    m = _port_moe(params, **kw)
    with torch.no_grad():
        got = m(_t(x))
        r = switch_route(_t(x).reshape(-1, D), m.router, cf)
    expert, keep = _jax_routing(x.reshape(-1, D), params["router"], cf)
    np.testing.assert_array_equal(r.expert.numpy(), expert)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **LAYER_TOL)
    np.testing.assert_allclose(float(m.penalty()), ref_aux, **LAYER_TOL)
    dropped = ~keep.any(-1)
    assert (got.reshape(-1, D)[torch.from_numpy(dropped)] == 0).all()
    if cf == 1e-9:
        assert keep.sum() <= E and dropped.any()


def test_moe_matches_manual_routing():
    """tests/test_moe.py:22-44 on the port: a per-token loop over the chosen
    expert's binarized kernels, scaled by the gate."""
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(24, D)).astype(np.float32))
    m = _port_moe(_moe_params(rng), scheme="binary", capacity_factor=8.0)
    with torch.no_grad():
        out = m(x)
        probs = torch.softmax(x @ m.router, dim=-1)
        gate, idx = probs.max(dim=-1)
        wi, wo = ops.binary_connect_det(m.wi_kernel), ops.binary_connect_det(m.wo_kernel)
        manual = torch.stack([gate[t] * (torch.relu(x[t] @ wi[e]) @ wo[e])
                              for t, e in enumerate(idx.tolist())])
    np.testing.assert_allclose(out.numpy(), manual.numpy(), rtol=1e-4, atol=1e-5)


def test_moe_capacity_drops_overflow():
    """tests/test_moe.py:47-54: one slot per expert, at most E tokens give a
    nonzero output."""
    x = _t(np.random.default_rng(1).normal(size=(32, D)).astype(np.float32))
    m = tnn.init_like_flax(tnn.QuantMoE(D, E, F, capacity_factor=1e-9, device=CPU), 0)
    with torch.no_grad():
        out = m(x)
    assert int((out != 0).any(dim=-1).sum()) <= E


def test_moe_aux_loss_sown_and_scaled():
    """tests/test_moe.py:57-65: the aux loss is >= 1 (a perfect balance) and
    finite, through nn.collect_elastic_losses; aux_loss_weight scales it; it
    is read only after a forward."""
    x = _t(np.random.default_rng(0).normal(size=(24, D)).astype(np.float32))
    m = tnn.init_like_flax(tnn.QuantMoE(D, E, F, device=CPU), 0)
    with pytest.raises(RuntimeError, match="before any forward"):
        tnn.collect_elastic_losses(m)
    with torch.no_grad():
        m(x)
    loss = float(tnn.collect_elastic_losses(m))
    assert loss >= 1.0 - 1e-3 and np.isfinite(loss)
    m.aux_loss_weight = 0.25
    with torch.no_grad():
        m(x)
    assert float(m.penalty()) == pytest.approx(0.25 * loss, rel=1e-6)
    assert m.penalty().grad_fn is None  # a no_grad forward holds no graph
    m(x)  # with a graph: a copy of the layer has had no forward
    assert m.penalty().grad_fn is not None and copy.deepcopy(m)._aux is None


def test_moe_expert_masters_are_clampable():
    """tests/test_moe.py:68-74 through the port's flax paths: the default
    filter clamps wi_kernel and wo_kernel to [-1, 1] and leaves the router;
    the clamp after a step selects exactly those two of the LM's MoE."""
    f = default_clip_filter()
    assert f("['moe']['wi_kernel']") == 1.0 and f("['moe']['wo_kernel']") == 1.0
    assert f("['moe']['router']") is None
    tm = QuantTransformerLM(**dict(LM_CFG, n_layers=1))
    paths = {k: keystr(p) for k, (c, p) in flax_paths(tm).items()}
    assert paths["block0.moe.wi_kernel"] == "['block0']['moe']['wi_kernel']"
    assert f(paths["block0.moe.router"]) is None
    clamped = {id(p) for p, _ in train.clip_quantized_weights(tm).params}
    moe = tm.block0.moe
    assert id(moe.wi_kernel) in clamped and id(moe.wo_kernel) in clamped
    assert id(moe.router) not in clamped


def test_moe_dorefa_scheme_and_grads():
    """tests/test_moe.py:107-121: DoReFa w4 expert masters get finite STE
    gradients, nonzero for wi_kernel; its max |tanh w| is taken over every
    expert (one tensor), not per expert."""
    rng = np.random.default_rng(0)
    params = _moe_params(rng)
    params["wi_kernel"][0] *= 0.1  # expert 0's own max |tanh w| would differ
    m = _port_moe(params, scheme="dorefa", w_bits=4)
    x = _t(rng.normal(size=(24, D)).astype(np.float32))
    (m(x) ** 2).sum().backward()
    for p in m.parameters():
        assert torch.isfinite(p.grad).all()
    assert float(m.wi_kernel.grad.abs().max()) > 0
    wi, _ = m.quantized_kernels()
    np.testing.assert_array_equal(wi.detach().numpy(),
                                  ops.dorefa_weight(m.wi_kernel.detach(), 4).numpy())
    assert not torch.equal(wi[0], ops.dorefa_weight(m.wi_kernel.detach()[0], 4))


@pytest.mark.parametrize("scheme,tie", [("binary", False), ("dorefa", False), ("none", False),
                                        ("binary", True)],
                         ids=["binary", "dorefa", "none", "binary-gate_tie"])
def test_moe_gradients_match_jax(scheme, tie):
    """Gradients of sum(out^2) + aux for the router, both kernels and the
    input, against jax.grad, each within 1e-5 of its tensor's max |g|. With
    ``tie`` the router's columns 0 and 1 are equal, so every token whose
    largest probability is one of them ties: jnp.max splits the gate's
    gradient evenly between the two, torch.amax too (torch.max(dim) would
    send it to one)."""
    rng = np.random.default_rng(3)
    params = _moe_params(rng)
    if tie:
        params["router"][:, 1] = params["router"][:, 0]
    x = rng.normal(size=(24, D)).astype(np.float32)
    kw = dict(scheme=scheme, capacity_factor=2.0, **SCHEMES[scheme])
    jm = JMoE(n_experts=E, d_ff=F, **kw)

    def jloss(p, x):
        out, st = jm.apply({"params": p}, x, mutable=["losses"])
        return jnp.sum(out ** 2) + jqnn.collect_elastic_losses(st)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    m = _port_moe(params, **kw)
    xt = _t(x).requires_grad_(True)
    ((m(xt) ** 2).sum() + tnn.collect_elastic_losses(m)).backward()
    if tie:
        with torch.no_grad():
            r = switch_route(xt, m.router, 2.0)
        tied = r.probs[:, 0] == r.probs[:, 1]
        assert (tied & (r.expert == 0)).sum() >= 3  # the first index wins the tie
    got = {"router": m.router.grad, "wi_kernel": m.wi_kernel.grad, "wo_kernel": m.wo_kernel.grad,
           "x": xt.grad}
    want = {**{k: np.asarray(v) for k, v in jg.items()}, "x": np.asarray(jgx)}
    for k, w in want.items():
        assert np.abs(got[k].numpy() - w).max() <= GRAD_TOL * np.abs(w).max(), k


def _bf16_moe(params, x, scheme):
    kw = dict(scheme=scheme, capacity_factor=2.0, **SCHEMES[scheme])
    jm = JMoE(n_experts=E, d_ff=F, dtype=jnp.bfloat16, **kw)
    fn = lambda p, x: jm.apply({"params": p}, x, mutable=["losses"])[0]  # noqa: E731
    ref = jax.jit(fn).lower(params, x).compile({"xla_allow_excess_precision": False})(params, x)
    with torch.no_grad():
        got = _port_moe(params, dtype=torch.bfloat16, **kw)(_t(np.asarray(x.astype(jnp.float32)))
                                                           .to(torch.bfloat16))
    return got, ref


@pytest.mark.parametrize("scheme", ["binary", "dorefa", "none"])
def test_moe_bf16_matches_jax(scheme):
    """dtype bf16 (float32 router and masters): the output at bf16 in both;
    the routing is float32 in both, so the same tokens are kept; the values
    within 2^-6 |ref| + 2^-8 max|ref|. The dispatch and combine sums have
    one term each (exact); the two expert products are real sums rounded
    once to bf16 in another order (one bf16 ulp, 2^-8 relative), the second
    one on inputs that may differ by that ulp, and the gate rounded to bf16
    scales the result (2^-8 more): a few bf16 ulps of an entry, or of the
    largest entry where the sum cancels."""
    rng = np.random.default_rng(5)
    params = _moe_params(rng)
    x = jnp.asarray(rng.normal(size=(2, 12, D)).astype(np.float32), jnp.bfloat16)
    got, ref = _bf16_moe(params, x, scheme)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert ((got == 0) == (ref == 0)).all()  # the same dropped tokens
    bound = 2.0 ** -6 * np.abs(ref) + 2.0 ** -8 * np.abs(ref).max()
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


# --- the MoE LM -----------------------------------------------------------------


def _jax_lm(cfg, seed=0, **kw):
    """(JAX model, its variables as numpy), drawn by flax from ``seed``."""
    jm = JLM(**cfg, **kw)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, 4), jnp.int32), train=False))(
        jax.random.PRNGKey(seed))
    return jm, {"params": jax.tree_util.tree_map(np.array, v["params"])}


def _lm_pair(cfg, seed=0):
    """(JAX model, its variables as numpy, port model on the CPU in eval mode)."""
    jm, v = _jax_lm(cfg, seed)
    return jm, v, load_flax_variables(QuantTransformerLM(**cfg), v, device=CPU).eval()


@pytest.fixture(scope="module")
def w1a1():
    return _lm_pair(LM_CFG)


@pytest.fixture(scope="module")
def w4a4():
    return _lm_pair(W4A4_CFG, seed=1)


def _tokens(seed, shape, vocab=LM_CFG["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_moe_lm_builds_and_bridges(w1a1):
    """The MoE LM has block{i}.moe in place of ffn_in/ffn_out; the bridge
    carries the stacked kernels untransposed both ways."""
    _, v, tm = w1a1
    assert not hasattr(tm.block0, "ffn_in") and tm.block0.moe.capacity_factor == 1.0
    np.testing.assert_array_equal(tm.block1.moe.wi_kernel.detach().numpy(),
                                  v["params"]["block1"]["moe"]["wi_kernel"])
    back = flax_variables(tm)["params"]["block0"]["moe"]
    for k in ("router", "wi_kernel", "wo_kernel"):
        np.testing.assert_array_equal(back[k], v["params"]["block0"]["moe"][k])
    drawn = tnn.init_like_flax(QuantTransformerLM(**LM_CFG), 0).block0.moe
    std = float(drawn.wi_kernel.detach().std())  # glorot over (d, f), the expert axis left out
    assert abs(std - np.sqrt(2.0 / (64 + 128))) < 0.1 * std


def test_moe_lm_forward_matches_jax(w1a1):
    jm, v, tm = w1a1
    toks = _tokens(1, (3, 16))
    ref = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, train=False, mutable=["losses"])[0])(
        v, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(_t(toks))
    np.testing.assert_allclose(got.numpy(), ref, **LM_TOL)


def _pin(cache, active, is_jax):
    """Idle slots' cursors back to 0, as both engines pin them."""
    def pin(path, leaf):
        if "index" not in str(path[-1]):
            return leaf
        return jnp.where(jnp.asarray(active), leaf, 0) if is_jax else torch.where(
            torch.from_numpy(active), leaf, 0)
    if is_jax:
        return jax.tree_util.tree_map_with_path(lambda p, l: pin((p[-1].key,), l), cache)
    return tde._map_leaves(pin, cache)


def test_moe_lm_decode_with_idle_slots_matches_jax(w1a1):
    """Decode mode at capacity factor 1.0: a 4-slot prefill, then 6 steps in
    which slot 2 is idle (dummy token 0, cursors pinned to 0) but still
    routed with the others, so it takes capacity: logits within 2e-4, the
    KV codes and cursors equal."""
    jm, v, tm = w1a1
    md, tmd = jm.clone(decode=True), serve.decode_model(tm)
    apply = jax.jit(lambda variables, t: md.apply(variables, t, train=False, mutable=_MUT))
    toks = _tokens(2, (4, 8))
    ref, st = apply({"params": v["params"]}, jnp.asarray(toks))
    with torch.no_grad():
        got, cache = tmd(_t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LM_TOL)
    jcache = st["cache"]
    active = np.array([True, True, False, True])
    t = np.argmax(np.asarray(ref)[:, -1], -1).astype(np.int32)
    for _ in range(6):
        t = np.where(active, t, 0).astype(np.int32)[:, None]
        ref, st = apply({"params": v["params"], "cache": jcache}, jnp.asarray(t))
        with torch.no_grad():
            got, cache = tmd(_t(t), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LM_TOL)
        jcache, cache = _pin(st["cache"], active, True), _pin(cache, active, False)
        t = np.argmax(np.asarray(ref)[:, -1], -1).astype(np.int32)
    for i in range(LM_CFG["n_layers"]):
        for k, leaf in cache[f"block{i}"]["attn"].items():
            want = np.asarray(jcache[f"block{i}"]["attn"][k])
            if "scale" in k:  # jitted, XLA divides by qmax as a product with 1/qmax
                np.testing.assert_allclose(leaf.numpy(), want, rtol=2.0 ** -23, atol=0)
            else:
                np.testing.assert_array_equal(leaf.numpy(), want, err_msg=k)
    np.testing.assert_array_equal(cache["pos_index"].numpy(), np.asarray(jcache["pos_index"]))


def test_moe_lm_generate_matches_jax(w1a1):
    jm, v, tm = w1a1
    prompt = _tokens(3, (2, 6))
    ref = np.asarray(jserve.generate(jm, v["params"], jnp.asarray(prompt), 8))
    got = serve.generate(tm, prompt, 8, device=CPU)
    np.testing.assert_array_equal(got.numpy(), ref)
    # sampled: deterministic under the generator's seed (it draws other numbers than JAX)
    a, b = (serve.generate(tm, prompt, 8, temperature=1.0, device=CPU,
                           generator=torch.Generator().manual_seed(7)) for _ in range(2))
    assert a.shape == (2, 8) and torch.equal(a, b)


def _drive(eng, requests, step):
    """One engine's loop without its thread: admit waiting requests into free
    slots (lowest first), then one step over every slot, until all answer."""
    pending = list(requests)
    while pending or any(s is not None for s in eng._slots):
        while None in eng._slots and pending:
            eng._admit(pending.pop(0), eng._slots.index(None))
        if any(s is not None for s in eng._slots):
            step(eng)
    return [r.future.result(timeout=0) for r in requests]


def _jax_step(eng):
    """JAX's engine loop's step, its tokens emitted by slot index: JAX's own
    ``_emit`` finds a finished slot with ``list.index``, whose field-wise ==
    of two slots compares their numpy prompts and raises when a slot past an
    occupied one finishes first (the port's slots compare by identity)."""
    active = [s is not None for s in eng._slots]
    toks = jnp.asarray([s.last_token if s is not None else 0 for s in eng._slots], jnp.int32)
    nxt, eng._cache = eng._step(eng._params, eng._cache, toks, jnp.asarray(active),
                                eng._next_key(), *eng._step_extra)
    for i, s in enumerate(list(eng._slots)):
        if s is not None:
            s.last_token = int(nxt[i])
            s.generated.append(s.last_token)
            if len(s.generated) >= s.request.max_new:
                s.request.future.set_result(np.asarray(s.generated, np.int32))
                eng._slots[i] = None


def _port_step(eng):
    active = torch.tensor([s is not None for s in eng._slots])
    toks = torch.tensor([s.last_token if s is not None else 0 for s in eng._slots],
                        dtype=torch.int32)
    nxt = eng._step(toks, active).tolist()
    for i, s in enumerate(list(eng._slots)):
        if s is not None:
            s.last_token = nxt[i]
            eng._emit(s, nxt[i])


def test_moe_lm_engines_in_lockstep_match_jax(w1a1):
    """The port's DecodeEngine and JAX's, their threads stopped, driven
    through the same admits and steps (no threads: slots interact through
    the experts' capacity). 6 requests of mixed lengths and budgets in 4
    slots with the bucket 16, so prefills route pad tokens and steps
    route idle slots' dummy tokens: every answer equal. The port serves its
    prepared packed records (the attention projections on K3's plain
    version; the experts stay fake-quant), JAX its fake-quant model: the ±1
    projections are the same exact integer sums on both routes (the packed
    artifacts are held to JAX's packed_apply below)."""
    jm, v, tm = w1a1
    kw = dict(n_slots=4, prompt_buckets=(16,))
    jeng = jde.DecodeEngine(jm, v["params"], **kw)
    teng = serve.DecodeEngine(tm, packed=infer.prepare(infer.pack_model(tm)), device=CPU, **kw)
    jeng.shutdown()
    teng.shutdown()
    rng = np.random.default_rng(4)
    specs = [(rng.integers(0, 128, n).astype(np.int32), m)
             for n, m in ((5, 6), (9, 3), (3, 7), (12, 4), (7, 5), (4, 6))]
    jreqs = [jde._GenRequest(p, m, None, jde.Future()) for p, m in specs]
    treqs = [tde._GenRequest(p, m, None, tde.Future()) for p, m in specs]
    ref = _drive(jeng, jreqs, _jax_step)
    got = _drive(teng, treqs, _port_step)
    for g, r, (_, m) in zip(got, ref, specs):
        assert len(g) == m
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("which", ["w1a1", "w4a4"])
def test_moe_lm_packed_artifacts_interchange(which, request, tmp_path):
    """A JAX-written artifact of the MoE LM (its attention projections; the
    experts stay fake-quant in both) loads in the port with logits equal to
    JAX's packed_apply within 2e-4; the port's artifact loads in JAX as the
    same records, word for word (so JAX's packed_apply of it is that
    reference), and in the port alike; unprepared and prepared agree."""
    jm, v, tm = request.getfixturevalue(which)
    toks = _tokens(5, (2, 8))
    jp = jax.jit(lambda v, t: jinfer.pack_model(jm, v, t))(v, jnp.asarray(toks))
    assert len(jp) == 4 * LM_CFG["n_layers"]  # q, k, v, out of each block
    jpath, tpath = os.path.join(tmp_path, "jax.npz"), os.path.join(tmp_path, "port.npz")
    jinfer.save_packed(jpath, jp)
    infer.save_packed(tpath, infer.pack_model(tm))
    from_port = jinfer.load_packed(tpath)
    assert set(from_port) == set(jp)
    for key, rec in jp.items():
        np.testing.assert_array_equal(np.asarray(from_port[key].packed), np.asarray(rec.packed))
        assert (from_port[key].scheme, from_port[key].w_bits, from_port[key].a_bits) == (
            rec.scheme, rec.w_bits, rec.a_bits)
    ref = np.asarray(jinfer.packed_apply(jm, v, jinfer.load_packed(jpath), jnp.asarray(toks),
                                         mutable=["losses"])[0])
    for path in (jpath, tpath):
        recs = infer.load_packed(path, device=CPU)
        got = infer.packed_apply(tm, recs, _t(toks))
        np.testing.assert_allclose(got.numpy(), ref, **LM_TOL)
        prepared = infer.packed_apply(tm, infer.prepare(recs), _t(toks))
        np.testing.assert_allclose(prepared.numpy(), got.numpy(), **LM_TOL)


def test_engine_serves_a_later_slot_finishing_first(w1a1):
    """A request in slot 1 that finishes before slot 0's: the engine finds
    the finished slot by identity (a field-wise == of two slots compares
    their numpy prompts and raised, which ended the engine's thread)."""
    _, _, tm = w1a1
    eng = serve.DecodeEngine(tm, n_slots=2, prompt_buckets=(8,), device=CPU)
    try:
        a = eng.submit(_tokens(10, (3,)), max_new=6)
        b = eng.submit(_tokens(11, (5,)), max_new=2)
        assert len(b.result(timeout=60)) == 2 and len(a.result(timeout=60)) == 6
    finally:
        eng.shutdown()


def test_moe_lm_fused_decode_refused(w1a1):
    _, _, tm = w1a1
    with pytest.raises(ValueError, match="MoE"):
        infer.export_fused_decode(tm, device=CPU)


def test_moe_lm_bf16_matches_jax():
    """The MoE LM at dtype bf16 against JAX's compiled without excess
    precision: float32 logits within JAX's coarse bf16 seam (rtol 0.05,
    atol 0.15, tests/test_mixed_precision.py:112-113), as
    tests/test_torch_mixed_precision.py holds the dense LM."""
    cfg = dict(LM_CFG, a_bits=0, capacity_factor=2.0)
    jm, v = _jax_lm(cfg, dtype=jnp.bfloat16)
    tm = load_flax_variables(QuantTransformerLM(**cfg, dtype=torch.bfloat16), v,
                             device=CPU).eval()
    toks = jnp.asarray(_tokens(6, (2, 16)))
    fn = lambda v, t: jm.apply(v, t, train=False, mutable=["losses"])[0]  # noqa: E731
    ref = jax.jit(fn).lower(v, toks).compile({"xla_allow_excess_precision": False})(v, toks)
    with torch.no_grad():
        got = tm(_t(toks))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.05, atol=0.15)


def _contexts(jm, v, tm, x):
    """The input of every block's attention out projection (the context,
    before its sign), JAX's and the port's, and both logits, eval mode."""
    jctx, pctx = {}, {}

    def grab(next_fun, args, kwargs, ctx):
        m = ctx.module
        if ctx.method_name == "__call__" and m.name == "out" and m.parent.name == "attn":
            jctx[m.parent.parent.name] = np.asarray(args[0])
        return next_fun(*args, **kwargs)

    with flax_nn.intercept_methods(grab):
        jlogits = np.asarray(jm.apply(v, jnp.asarray(x), train=False, mutable=["losses"])[0])
    hooks = [blk.attn.out.register_forward_pre_hook(
        lambda m, a, i=i: pctx.__setitem__(f"block{i}", a[0].detach().numpy()))
        for i, blk in enumerate(tm.blocks())]
    try:
        with torch.no_grad():
            logits = tm(_t(x)).numpy()
    finally:
        for h in hooks:
            h.remove()
    return jctx, pctx, jlogits, logits


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_w1a1_context_codes_part_only_at_cancelled_sums(w1a1, seed):
    """The W1A1 MoE LM's attention contexts, JAX's against the port's, block
    by block on the batches of seeds 7-9: where their sign codes part, both
    contexts lie below one float32 ulp of the block's largest context (a sum
    that cancels, whose remainder's sign is the rounding of its order);
    everywhere else they agree within 1e-5 of the largest. Blocks after the
    first that parts take other codes and are not compared; where none
    parts, the logits agree within 2e-4."""
    jm, v, tm = w1a1
    x = _tokens(seed, (4, 17))[:, :-1]
    jctx, pctx, jlogits, logits = _contexts(jm, v, tm, x)
    sign = tm.block0.attn.out.input_quant
    for i in range(LM_CFG["n_layers"]):
        j, p = jctx[f"block{i}"], pctx[f"block{i}"]
        part = (sign(_t(j)) != sign(_t(p))).numpy()
        ulp = 2.0 ** -24 * np.abs(j).max()
        assert np.abs(j[part]).max(initial=0) < ulp and np.abs(p[part]).max(initial=0) < ulp
        np.testing.assert_allclose(p[~part], j[~part], rtol=0, atol=1e-5 * np.abs(j).max())
        if part.any():
            return
    np.testing.assert_allclose(logits, jlogits, **LM_TOL)


def test_moe_lm_double_computes_in_float64():
    """A MoE LM made .double() (the card-against-CPU training gate's model)
    routes, normalizes and attends in float64: the router's probabilities,
    every LayerNorm output and the logits are float64, and the logits of the
    float twin (scheme none) agree with its float32 model within 1e-4."""
    cfg = dict(LM_CFG, scheme="none", a_bits=0, capacity_factor=2.0)
    tm = tnn.init_like_flax(QuantTransformerLM(**cfg), 0).eval()
    td = copy.deepcopy(tm).double()
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, out: seen.append(out.dtype))
             for name, m in td.named_modules() if name.split(".")[-1].startswith("ln")]
    x = _t(_tokens(3, (2, 16)))
    with torch.no_grad():
        got, ref = td(x), tm(x)
        probs = switch_route(torch.randn(8, cfg["d_model"], dtype=torch.float64),
                             td.block0.moe.router, 2.0).probs
    for h in hooks:
        h.remove()
    assert seen and set(seen) == {torch.float64}
    assert got.dtype == probs.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref.double().numpy(), rtol=1e-4, atol=1e-4)


def test_moe_lm_train_step_matches_jax(w1a1):
    """One make_train_step step of the W1A1 MoE LM on next-token (b, s)
    labels with elastic_weight 0.01 (the aux losses enter through it), from
    one state, against JAX's loss and gradients (make_compute_loss) and its
    Adam + clamp update: the loss within 1e-6 relative, every gradient
    within 1e-5 of its tensor's max |g|, every parameter within 1e-5 where
    JAX's gradient is above the rounding noise of an exact zero (1e-6) and
    within 4 lr elsewhere (tests/test_torch_train.py's rule); the clamp
    holds on the expert kernels and not on the router.

    A W1A1 attention context whose large terms cancel keeps a remainder
    (~1e-34) whose sign is the float sum's rounding, and its code can part
    between the packages; tests/test_torch_decode.py's fixtures avoid such
    contexts. test_w1a1_context_codes_part_only_at_cancelled_sums shows
    that this is where the batches of seeds 8 and 9 part; this batch (seed
    7) has none, and its train-mode logits are held within 2e-4 of JAX's
    first: a flipped code moves them by far more."""
    jm, v, _ = w1a1
    lr, weight = 3e-3, 0.01
    seq = _tokens(7, (4, 17))
    x, y = seq[:, :-1], seq[:, 1:]
    js = jtrain.QuantTrainState.create_for(
        jm, v, optax.chain(optax.adam(lr), jtrain.clip_quantized_weights()))

    @jax.jit
    def jax_step(js, x, y):
        (loss, (logits, _)), grads = jax.value_and_grad(make_compute_loss(
            js, x, y, elastic_weight=weight), has_aux=True)(js.params)
        return loss, logits, grads, js.apply_gradients(grads=grads).params

    jloss, jlogits, jgrads, jnew = jax_step(js, jnp.asarray(x), jnp.asarray(y))
    tm = load_flax_variables(QuantTransformerLM(**LM_CFG), v, device=CPU).train()
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(x)).numpy(), np.asarray(jlogits), **LM_TOL)
    state = train.QuantTrainState.create_for(tm, lr=lr)
    _, metrics = train.make_train_step(elastic_weight=weight)(state, (x, y))
    assert abs(float(metrics["loss"]) - float(jloss)) <= 1e-6 * abs(float(jloss))
    params = dict(tm.named_parameters())

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return np.asarray(tree)

    for key, (_, path) in flax_paths(tm).items():
        p = params[key]
        g, jg = p.grad.numpy(), at(jgrads, path)
        new, jn = p.detach().numpy(), at(jnew, path)
        if path[-1] == "kernel":  # the port's (out, in) layout
            g, new = g.T, new.T
        assert np.abs(g - jg).max() <= GRAD_TOL * np.abs(jg).max(), key
        live = np.abs(jg) > 1e-6
        assert np.abs(new - jn)[live].max(initial=0) <= 1e-5, key
        assert np.abs(new - jn).max() <= 4 * lr, key
    for blk in tm.blocks():
        assert float(blk.moe.wi_kernel.detach().abs().max()) <= 1.0
        assert float(blk.moe.wo_kernel.detach().abs().max()) <= 1.0
    assert float(jnp.abs(jnew["block0"]["moe"]["router"]).max()) == pytest.approx(
        float(tm.block0.moe.router.detach().abs().max()), rel=1e-6)


def test_cross_entropy_on_sequences_matches_jax():
    """train.cross_entropy on (b, s, V) logits and (b, s) labels: the mean
    over every position, JAX's train.steps.cross_entropy within 1e-6; the
    classifier's (b, V) unchanged."""
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 4, 8)).astype(np.float32) * 3
    labels = rng.integers(0, 8, (2, 4)).astype(np.int32)
    ref = float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(float(train.cross_entropy(_t(logits), _t(labels))) - ref) <= 1e-6
    flat = float(jcross_entropy(jnp.asarray(logits[0]), jnp.asarray(labels[0])))
    assert abs(float(train.cross_entropy(_t(logits[0]), _t(labels[0]))) - flat) <= 1e-6
    ev = train.make_eval_step()
    tm = tnn.init_like_flax(QuantTransformerLM(**dict(LM_CFG, n_layers=1)), 0)
    state = train.QuantTrainState.create_for(tm)
    seq = _tokens(9, (2, 9))
    m = ev(state, (seq[:, :-1], seq[:, 1:]))
    assert np.isfinite(float(m["loss"])) and 0.0 <= float(m["accuracy"]) <= 1.0
