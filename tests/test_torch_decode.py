"""PyTorch port of the decode LM slice, held against the JAX package.

The JAX models are initialised as the JAX package's own tests initialise
them (tests/test_fused_decode.py, tests/test_decode_engine.py); their
variables, as numpy, go through ``utils.bridge`` into the port. Integer-exact
results (KV codes and scales, W1A1 caches, int8 vs packed exports) must be
bit-equal; logits agree within 2e-4 (the JAX package's own fused-vs-fake
tolerance: float32 LayerNorm and attention sums in another order); greedy
tokens must be identical.

These fixtures are the JAX tests' own, which keep every sign-binarized
attention context away from exact cancellation: there, the context is 0 or
a tiny value depending on the order of a float sum, in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu import serve as jserve
from pytorch_quantize_impls_tpu.models.transformer import QuantTransformerLM as JLM
from pytorch_quantize_impls_tpu.serve.generate import _MUT
from pytorch_quantize_impls_tpu_torch import infer, ops, serve
from pytorch_quantize_impls_tpu_torch.models import QuantTransformerLM
from pytorch_quantize_impls_tpu_torch.utils import flax_state_dict, load_flax_variables

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-4)
KV = ("k_codes", "k_scale", "v_codes", "v_scale", "index")
# tests/test_fused_decode.py:22-28 (W1A1, the fused decode config)
FUSED_CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64,
                 scheme="binary", w_bits=1, a_bits=1)
# tests/test_decode_engine.py:19-21 (BinaryConnect weights, real activations)
ENGINE_CFG = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32)


def _pair(cfg, seed=0):
    """(jax model, jax variables as numpy, port model on the CPU)."""
    jm = JLM(**cfg)
    v = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4), jnp.int32), train=False)
    v = jax.tree_util.tree_map(np.array, v)
    tm = load_flax_variables(QuantTransformerLM(**cfg), v, device=CPU).eval()
    return jm, v, tm


@pytest.fixture(scope="module")
def w1a1():
    return _pair(FUSED_CFG)


@pytest.fixture(scope="module")
def bc():
    return _pair(ENGINE_CFG)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_cache_equal(port_cache, jax_cache, n_layers):
    for i in range(n_layers):
        for k in port_cache[f"block{i}"]["attn"]:
            np.testing.assert_array_equal(
                port_cache[f"block{i}"]["attn"][k].numpy(),
                np.asarray(jax_cache[f"block{i}"]["attn"][k]), err_msg=f"block{i} {k}",
            )
    np.testing.assert_array_equal(port_cache["pos_index"].numpy(), np.asarray(jax_cache["pos_index"]))


# --- ops.kv_cache -------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_kv_bit_equal_to_jax(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(3, 5, 4, 32)).astype(np.float32) * 3
    x[0, 1] = 0.0  # all-zero groups: scale 1
    x[1, 2, 0, :4] = [0.5, -0.5, 1.5, -2.5]  # halves round to even
    x[1, 2, 0, 4] = -2.5 * 127 / (2 ** (bits - 1) - 1)
    codes, scale = ops.quantize_kv(_t(x), bits)
    jcodes, jscale = jops.quantize_kv(jnp.asarray(x), bits)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    qmax = 2 ** (bits - 1) - 1
    assert codes.abs().max() <= qmax and (scale[0, 1] == 1).all()
    np.testing.assert_array_equal(
        ops.dequantize_kv(codes, scale).numpy(),
        np.asarray(jops.dequantize_kv(jcodes, jscale)),
    )


def test_quantize_kv_rejects_bits():
    for bits in (1, 9):
        with pytest.raises(ValueError, match="kv bits"):
            ops.quantize_kv(torch.zeros(2, 4), bits)


def test_flush_subnormal():
    tiny = np.finfo(np.float32).tiny
    x = np.array([0.0, tiny, -tiny, tiny / 4, -tiny / 2, 1e-30, -1.0], np.float32)
    want = np.where(np.abs(x) < tiny, 0.0, x).astype(np.float32)
    assert (want[3:5] == 0).all() and (x[3:5] != 0).all()
    np.testing.assert_array_equal(ops.flush_subnormal(_t(x)).numpy(), want)


# --- bridge and the fake-quant model ------------------------------------------


def test_bridge_lm_layouts(w1a1):
    _, v, tm = w1a1
    p = v["params"]
    assert set(flax_state_dict(v)) == set(tm.state_dict())
    np.testing.assert_array_equal(tm.embed.weight.detach().numpy(), p["embed"]["embedding"])
    np.testing.assert_array_equal(tm.pos_embed.detach().numpy(), p["pos_embed"])
    np.testing.assert_array_equal(
        tm.block1.attn.k.weight.detach().numpy(), p["block1"]["attn"]["k"]["kernel"].T
    )
    np.testing.assert_array_equal(tm.block0.ln2.weight.detach().numpy(), p["block0"]["ln2"]["scale"])
    np.testing.assert_array_equal(tm.block0.ffn_out.bias.detach().numpy(), p["block0"]["ffn_out"]["bias"])
    extra = {"params": dict(p, head={"kernel": np.zeros((4, 4), np.float32)})}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_variables(QuantTransformerLM(**FUSED_CFG), extra, device=CPU)


@pytest.mark.parametrize("which", ["w1a1", "bc", "none"], ids=["binary-w1a1", "binary-a0", "none"])
def test_lm_forward_matches_jax(which, request):
    if which == "none":
        jm, v, tm = _pair(dict(ENGINE_CFG, scheme="none"))
    else:
        jm, v, tm = request.getfixturevalue(which)
    toks = np.random.default_rng(1).integers(0, jm.vocab, (3, 8)).astype(np.int32)
    ref = np.asarray(jm.apply(v, jnp.asarray(toks), train=False))
    with torch.no_grad():
        got = tm(_t(toks)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kv_bits", [8, None])
def test_lm_decode_prefill_and_steps_match_jax(kv_bits):
    cfg = dict(FUSED_CFG, kv_bits=kv_bits)
    jm, v, tm = _pair(cfg)
    md, tmd = jm.clone(decode=True), serve.decode_model(tm)
    # eager, as the JAX package's tests run it: under jit XLA turns the
    # scale's division by qmax into a product with 1/qmax (scales move by an ulp)
    def apply(var, t):
        return md.apply(var, t, train=False, mutable=_MUT)

    toks = np.random.default_rng(1).integers(0, cfg["vocab"], (3, 8)).astype(np.int32)
    ref, st = apply({"params": v["params"]}, jnp.asarray(toks))
    with torch.no_grad():
        got, cache = tmd(_t(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        _assert_cache_equal(cache, st["cache"], cfg["n_layers"])
        t = np.asarray(jnp.argmax(ref[:, -1], -1)).astype(np.int32)
        for _ in range(6):
            ref, st = apply({"params": v["params"], "cache": st["cache"]}, jnp.asarray(t)[:, None])
            got, cache = tmd(_t(t)[:, None], cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
            _assert_cache_equal(cache, st["cache"], cfg["n_layers"])
            np.testing.assert_array_equal(got[:, 0].argmax(-1).numpy(), np.argmax(ref[:, 0], -1))
            t = np.asarray(jnp.argmax(ref[:, 0], -1)).astype(np.int32)


def test_ffn_sign_is_the_nonlinearity(w1a1):
    """With a_bits == 1 there is no ReLU before the sign: ffn_out's input
    codes take both signs."""
    _, _, tm = w1a1
    seen = {}
    h = tm.block0.ffn_out.register_forward_pre_hook(lambda m, i: seen.update(x=i[0]))
    try:
        with torch.no_grad():
            tm(_t(np.random.default_rng(2).integers(0, 128, (2, 8))))
    finally:
        h.remove()
    assert (seen["x"] < 0).any() and (seen["x"] >= 0).any()


# --- infer.fused_decode -------------------------------------------------------


@pytest.mark.parametrize("weights", ["int8", "packed"])
def test_fused_decode_prefill_and_steps_match_jax(w1a1, weights):
    jm, v, tm = w1a1
    fm = infer.export_fused_decode(tm, weights=weights, device=CPU)
    jfm = jinfer.export_fused_decode(jm, v, weights=weights)
    if weights == "packed":
        for ly, jly in zip(fm.layers, jfm.layers):
            np.testing.assert_array_equal(ly.w_qkv.numpy().view(np.uint32), np.asarray(jly.w_qkv))
    apply = jinfer.fused_decode_apply  # eager: see the test above
    toks = np.random.default_rng(1).integers(0, 128, (3, 8)).astype(np.int32)
    got, cache = infer.fused_decode_apply(fm, None, _t(toks))
    ref, st = apply(jfm, None, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    _assert_cache_equal(cache, st["cache"], 2)
    t = np.asarray(jnp.argmax(ref[:, -1], -1)).astype(np.int32)
    for _ in range(6):
        ref, st = apply(jfm, st["cache"], jnp.asarray(t)[:, None])
        got, cache = infer.fused_decode_apply(fm, cache, _t(t)[:, None])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        _assert_cache_equal(cache, st["cache"], 2)
        np.testing.assert_array_equal(got[:, 0].argmax(-1).numpy(), np.argmax(ref[:, 0], -1))
        t = np.asarray(jnp.argmax(ref[:, 0], -1)).astype(np.int32)


def test_fused_int8_and_packed_exports_bit_equal(w1a1):
    _, _, tm = w1a1
    fi = infer.export_fused_decode(tm, weights="int8", device=CPU)
    fp = infer.export_fused_decode(tm, weights="packed", device=CPU)
    assert fi.layers[0].w1.dtype == torch.int8 and fp.layers[0].w1.dtype == torch.int32
    toks = _t(np.random.default_rng(4).integers(0, 128, (2, 8)).astype(np.int32))
    li, ci = infer.fused_decode_apply(fi, None, toks)
    lp, cp = infer.fused_decode_apply(fp, None, toks)
    for _ in range(3):
        assert torch.equal(li, lp)
        t = li[:, -1].argmax(-1).to(torch.int32)[:, None]
        li, ci = infer.fused_decode_apply(fi, ci, t)
        lp, cp = infer.fused_decode_apply(fp, cp, t)
    assert torch.equal(li, lp)
    for i in range(2):
        for k in KV:
            assert torch.equal(ci[f"block{i}"]["attn"][k], cp[f"block{i}"]["attn"][k])


def test_fused_matches_port_fake_quant_decode(w1a1):
    """The port's own seam: the fused program against the port's decode-mode
    model, teacher-forced; KV codes agree after the layout transpose."""
    _, _, tm = w1a1
    fm = infer.export_fused_decode(tm, device=CPU)
    md = serve.decode_model(tm)
    toks = _t(np.random.default_rng(1).integers(0, 128, (3, 8)).astype(np.int32))
    with torch.no_grad():
        ref, rc = md(toks)
        got, gc = infer.fused_decode_apply(fm, None, toks)
        for step in range(7):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
            for i in range(2):
                a, g = rc[f"block{i}"]["attn"], gc[f"block{i}"]["attn"]
                assert torch.equal(a["k_codes"].transpose(1, 2), g["k_codes"])
                assert torch.equal(a["v_scale"].transpose(1, 2), g["v_scale"])
            t = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
            ref, rc = md(t, rc)
            got, gc = infer.fused_decode_apply(fm, gc, t)


def test_export_fused_decode_validates(bc):
    _, _, tm = bc
    with pytest.raises(ValueError, match="binary W1A1"):
        infer.export_fused_decode(tm, device=CPU)
    tm8 = QuantTransformerLM(**dict(FUSED_CFG, kv_bits=None))
    with pytest.raises(ValueError, match="quantized KV"):
        infer.export_fused_decode(tm8, device=CPU)
    with pytest.raises(ValueError, match="'int8' or 'packed'"):
        infer.export_fused_decode(QuantTransformerLM(**FUSED_CFG), weights="int4", device=CPU)


# --- serve.generate -----------------------------------------------------------


@pytest.mark.parametrize("which", ["w1a1", "bc"])
def test_generate_greedy_matches_jax(which, request):
    jm, v, tm = request.getfixturevalue(which)
    vocab = jm.vocab
    prompt = np.random.default_rng(5).integers(0, vocab, (2, 7)).astype(np.int32)
    ref = np.asarray(jserve.generate(jm, v["params"], jnp.asarray(prompt), 6))
    got = serve.generate(tm, prompt, 6, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generate_sampling_is_deterministic_under_seed(bc):
    _, _, tm = bc
    prompt = np.random.default_rng(6).integers(0, 32, (3, 5)).astype(np.int32)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return serve.generate(tm, prompt, 8, temperature=1.0, generator=g, device=CPU)

    a, b = draw(7), draw(7)
    assert torch.equal(a, b) and a.min() >= 0 and a.max() < 32
    assert not torch.equal(draw(7), draw(8)) or not torch.equal(draw(7), draw(9))
    with pytest.raises(ValueError, match="cache capacity"):
        serve.generate(tm, np.zeros((1, 30), np.int32), 5, device=CPU)


# --- serve.DecodeEngine -------------------------------------------------------


def _prompts(seed=0, lens=(3, 7, 5, 9, 4), vocab=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]


_EXPECTED = {}


def _expected(jm, v, prompt, n_new):
    """JAX ``serve.generate`` tokens, batch 1, memoised across tests."""
    key = (jm.vocab, jm.a_bits, prompt.tobytes(), n_new)
    if key not in _EXPECTED:
        _EXPECTED[key] = np.asarray(jserve.generate(jm, v["params"], jnp.asarray(prompt[None]), n_new)[0])
    return _EXPECTED[key]


def _serve(engine, prompts, max_new, **kw):
    try:
        futs = [engine.submit(p, max_new=max_new, **kw) for p in prompts]
        return [f.result(timeout=120) for f in futs]
    finally:
        engine.shutdown()


def _engine(tm, backend, **kw):
    if backend == "fused":
        kw["fused"] = infer.export_fused_decode(tm, device=CPU)
    elif backend == "packed":
        kw["packed"] = infer.pack_model(tm)
    return serve.DecodeEngine(tm, device=CPU, **kw)


@pytest.mark.parametrize("backend", ["fake", "packed", "fused"])
def test_engine_matches_jax_generate_mixed_lengths(w1a1, backend):
    """4 slots, 5 requests of mixed lengths: the fifth reuses a slot."""
    jm, v, tm = w1a1
    prompts = _prompts(lens=(5, 9, 12, 3, 7), vocab=128)
    eng = _engine(tm, backend, n_slots=4)
    got = _serve(eng, prompts, 6)
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _expected(jm, v, p, 6))
    assert eng.stats.requests == len(prompts) and eng.stats.tokens == 6 * len(prompts)
    assert 0 < eng.stats.mean_occupancy <= 1


@pytest.mark.parametrize("backend", ["fake", "packed"])
def test_engine_slot_reuse_more_requests_than_slots(bc, backend):
    """2 slots, 5 requests: stale rows of a retired request must not leak
    into the next one's tokens."""
    jm, v, tm = bc
    prompts = _prompts(seed=3, lens=(9, 3, 6, 11, 5))
    got = _serve(_engine(tm, backend, n_slots=2), prompts, 5)
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _expected(jm, v, p, 5))


def test_engine_eos_early_stop(bc):
    jm, v, tm = bc
    p = _prompts()[0]
    full = _expected(jm, v, p, 6)
    got = _serve(_engine(tm, "fake", n_slots=2), [p], 6, eos=int(full[0]))
    np.testing.assert_array_equal(got[0], full[:1])


def test_engine_long_prompt_beyond_buckets(bc):
    jm, v, tm = bc
    p = _prompts(seed=11, lens=(27,))[0]  # 27 > 8, <= 32
    got = _serve(_engine(tm, "fake", n_slots=2, prompt_buckets=(4, 8)), [p], 3)
    np.testing.assert_array_equal(got[0], _expected(jm, v, p, 3))


def test_engine_submit_validation_and_exclusive_backends(bc, w1a1):
    _, _, tm = bc
    eng = _engine(tm, "fake", n_slots=2)
    try:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((2, 2), np.int32), max_new=2)
        with pytest.raises(ValueError):
            eng.submit(np.zeros((30,), np.int32), max_new=10)  # 40 > 32
    finally:
        eng.shutdown()
    _, _, tw = w1a1
    fm = infer.export_fused_decode(tw, device=CPU)
    with pytest.raises(ValueError, match="exclusive"):
        serve.DecodeEngine(tw, fused=fm, packed={}, device=CPU)
    with pytest.raises(NotImplementedError, match="item 6"):
        serve.DecodeEngine(tw, mesh=object(), device=CPU)


def test_unported_parts_raise():
    # the MoE FFN is ported (tests/test_torch_moe.py): n_experts > 0 builds a
    # QuantMoE in each block in place of the dense FFN
    moe_lm = QuantTransformerLM(**dict(ENGINE_CFG, n_experts=4, capacity_factor=1.0))
    assert all(blk.moe.n_experts == 4 and blk.moe.capacity_factor == 1.0
               and not hasattr(blk, "ffn_in") for blk in moe_lm.blocks())
    with pytest.raises(NotImplementedError, match="item 6"):
        QuantTransformerLM(**dict(ENGINE_CFG, attention_fn=lambda q, k, v: q))
    # the JAX LM has no xnor weight quantizer either (tests/test_torch_ternary.py)
    with pytest.raises(ValueError, match="unknown scheme"):
        QuantTransformerLM(**dict(ENGINE_CFG, scheme="xnor"))
    with pytest.raises(ValueError, match="1-bit"):
        QuantTransformerLM(**dict(ENGINE_CFG, a_bits=2))
    with pytest.raises(ValueError, match="decode mode"):
        QuantTransformerLM(**ENGINE_CFG)(torch.zeros(1, 2, dtype=torch.int32), {})

