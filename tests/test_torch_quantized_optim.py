"""The port's 8-bit log-coded Adam (``train.QuantizedAdam``) held against the
JAX package's ``quantized_adam``.

Updates are compared per step from one state: before each of five updates
the port takes JAX's codes, scales, float32 moments and count, and both
apply the same gradients. The rule, per update:

* codes bit-equal, except where the scaled log ``1 + (log2(x / absmax) + r)
  levels / r`` lies within 1e-4 of a .5 (``log2`` is not bit-equal between
  XLA's CPU and PyTorch), and there within 1;
* scales, and the moments decoded from the codes, within 1e-6 relative
  (XLA's CPU ``exp2`` is up to ~9e-7 off the exact level; the port's is not);
* each step within 1e-6 of the size of its terms: ``lr (b1 |m_old| + (1 -
  b1) |g|) / bc1 / (sqrt(v / bc2) + eps)``, since ``b1 m_old + (1 - b1) g``
  cancels where the gradient turns, and there JAX's decode error survives
  the cancellation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_quantize_impls_tpu.train import quantized_optim as jq
from pytorch_quantize_impls_tpu_torch import data, models, train
from pytorch_quantize_impls_tpu_torch.train import quantized_optim as tq
from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig, build_model

LR = 1e-2
B1, B2, EPS = 0.9, 0.999, 1e-8
BLOCK = 256
SHAPES = {"w": (1000,), "k": (300, 3), "conv": (3, 3, 8, 16), "b": (7,), "edge": (256,)}
NEAR_HALF = 1e-4
RTOL = 1e-6


def _grads(rng, step):
    """Gradients spanning six decades, a block of exact zeros and a lone
    zero (code 0), so absmax, the floor and code 1 are all exercised."""
    out = {}
    for k, s in SHAPES.items():
        g = rng.normal(size=s) * 10.0 ** rng.uniform(-6, 0, size=s)
        flat = g.reshape(-1)
        if flat.size > BLOCK and step % 2 == 0:
            flat[:BLOCK] = 0.0
        flat[-1] = 0.0
        out[k] = g.astype(np.float32)
    return out


def _scaled_log(x: np.ndarray, signed: bool) -> np.ndarray:
    """The pre-round code of every element of ``x``, blocked as the codes."""
    r, levels = (12.0, 126.0) if signed else (24.0, 254.0)
    flat = np.pad(np.abs(x.astype(np.float64).reshape(-1)), (0, (-x.size) % BLOCK))
    flat = flat.reshape(-1, BLOCK)
    absmax = flat.max(axis=1, keepdims=True)
    xn = np.where(absmax > 0, flat / np.where(absmax > 0, absmax, 1.0), 0.0)
    lg = np.clip(np.log2(np.maximum(xn, 2.0 ** (-r - 1))), -r, 0.0)
    return 1.0 + (lg + r) * (levels / r)


def _codes_agree(ours: np.ndarray, theirs: np.ndarray, scaled: np.ndarray) -> None:
    ours, theirs = ours.astype(np.int32), theirs.astype(np.int32)
    off = ours != theirs
    near_half = np.abs(scaled - np.floor(scaled) - 0.5) <= NEAR_HALF
    assert not (off & ~near_half).any(), np.argwhere(off & ~near_half)[:5]
    assert np.abs(ours - theirs).max(initial=0) <= 1


def _load_jax_state(opt, params, js):
    """Teacher-force: the port's moments and count := JAX's."""
    for k, p in zip(SHAPES, params):
        st = opt.state[p]
        if "mu_codes" in st:
            for name in ("mu", "nu"):
                q = getattr(js, name)[k]
                st[f"{name}_codes"] = torch.from_numpy(np.array(q.codes))
                st[f"{name}_scale"] = torch.from_numpy(np.array(q.scale))
        else:
            st["mu"], st["nu"] = (torch.from_numpy(np.array(getattr(js, n)[k]))
                                  for n in ("mu", "nu"))
    opt.param_groups[0]["count"] = int(js.count)


def _decoded(st, name, shape):
    if f"{name}_codes" in st:
        return tq.decode(st[f"{name}_codes"], st[f"{name}_scale"], shape).numpy()
    return st[name].numpy()


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_update_matches_jax_per_step(schedule):
    rng = np.random.default_rng(0)
    # one schedule for both (the port's cosine is held to optax's elsewhere):
    # what is compared is where each optimizer reads it
    lr_t = train.cosine_decay_schedule(LR, 8) if schedule == "cosine" else LR
    lr_j = (lambda count: jnp.float32(lr_t(int(count)))) if schedule == "cosine" else LR
    tx = jq.quantized_adam(lr_j)
    js = tx.init({k: jnp.zeros(s) for k, s in SHAPES.items()})
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    opt = tq.QuantizedAdam(params, lr=lr_t)
    assert tq.optimizer_state_bytes(opt) == jq.optimizer_state_bytes(js)
    for step in range(5):
        grads = _grads(rng, step)
        _load_jax_state(opt, params, js)
        old = {k: (_decoded(opt.state[p], "mu", p.shape), _decoded(opt.state[p], "nu", p.shape))
               for k, p in zip(SHAPES, params)}
        for k, p in zip(SHAPES, params):
            p.data.zero_()
            p.grad = torch.from_numpy(grads[k])
        lr = float(lr_j(step) if callable(lr_j) else lr_j)
        updates, js = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, js)
        opt.step()
        assert opt.param_groups[0]["count"] == int(js.count) == step + 1
        assert opt.param_groups[0]["lr"] == lr
        bc1, bc2 = 1 - B1 ** (step + 1), 1 - B2 ** (step + 1)
        for k, p in zip(SHAPES, params):
            g = grads[k].astype(np.float64)
            m_old, v_old = old[k]
            m = B1 * m_old + (1 - B1) * g
            v = B2 * v_old + (1 - B2) * g * g
            terms = lr * (B1 * np.abs(m_old) + (1 - B1) * np.abs(g)) / bc1 / (
                np.sqrt(v / bc2) + EPS)
            ours, theirs = p.detach().numpy(), np.asarray(updates[k])
            np.testing.assert_array_less(np.abs(ours - theirs), RTOL * terms + 1e-30,
                                         err_msg=f"{k} step {step}")
            st = opt.state[p]
            for name, signed, moment in (("mu", True, m), ("nu", False, v)):
                q = getattr(js, name)[k]
                if f"{name}_codes" not in st:
                    np.testing.assert_allclose(st[name].numpy(), np.asarray(q), rtol=RTOL)
                    continue
                _codes_agree(st[f"{name}_codes"].numpy(), np.asarray(q.codes),
                             _scaled_log(moment, signed))
                np.testing.assert_allclose(st[f"{name}_scale"].numpy(), np.asarray(q.scale),
                                           rtol=RTOL)
                np.testing.assert_allclose(_decoded(st, name, p.shape),
                                           np.asarray(jq._decode(q, p.shape)), rtol=RTOL,
                                           atol=0)


def test_roundtrip_encode_decode_error_bounded():
    """JAX's ``test_roundtrip_encode_decode_error_bounded`` on the port, and
    its codes against JAX's on the same input."""
    x = np.random.default_rng(1).normal(size=(1000,)).astype(np.float32)
    for signed in (True, False):
        v = x if signed else np.abs(x)
        codes, scale = tq.encode(torch.from_numpy(v), BLOCK, signed)
        back = tq.decode(codes, scale, v.shape).numpy()
        absmax = np.repeat(scale.numpy(), BLOCK)[: v.size]
        floor = absmax * 2.0 ** (-12.0 if signed else -24.0)
        big = np.abs(v) >= floor
        rel = np.abs(back - v) / np.maximum(np.abs(v), 1e-30)
        assert rel[big].max() <= 0.04
        assert np.abs(back[~big]).max(initial=0.0) <= floor.max() * 1.01
        np.testing.assert_array_equal(np.sign(back), np.sign(v))
        q = jq._encode(jnp.asarray(v), BLOCK, signed)
        _codes_agree(codes.numpy(), np.asarray(q.codes), _scaled_log(v, signed))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(q.scale))
        assert codes.dtype == (torch.int8 if signed else torch.uint8)


@pytest.mark.parametrize("shape", [(7,), (256,), (300, 3)])
def test_odd_shapes_roundtrip(shape):
    """Odd shapes: codes (n_blocks, block) with a zero-padded tail, equal to
    JAX's, and the decode back at ``shape``."""
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    codes, scale = tq.encode(torch.from_numpy(x), BLOCK, True)
    n = int(np.prod(shape))
    assert codes.shape == (-(-n // BLOCK), BLOCK)
    assert not codes.reshape(-1)[n:].any()
    q = jq._encode(jnp.asarray(x), BLOCK, True)
    _codes_agree(codes.numpy(), np.asarray(q.codes), _scaled_log(x, True))
    back = tq.decode(codes, scale, shape)
    assert back.shape == shape
    np.testing.assert_allclose(back.numpy(), np.asarray(jq._decode(q, shape)), rtol=RTOL)


def test_state_bytes_match_jax_and_quarter_adam():
    """``optimizer_state_bytes`` as JAX counts it, on the same shapes (a big
    leaf and a small one), under 0.3x of float32 Adam's; and bnn_lenet's
    (width 128, BASELINE config 2) 8-bit state is 10,221,548 bytes."""
    shapes = {"k": (4096, 64), "b": (8,)}
    js = jq.quantized_adam().init({k: jnp.zeros(s) for k, s in shapes.items()})
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes.values()]
    opt = tq.QuantizedAdam(params)
    assert tq.optimizer_state_bytes(opt) == jq.optimizer_state_bytes(js)
    adam = torch.optim.Adam(params)
    for p in params:
        p.grad = torch.ones_like(p)
    adam.step()
    assert tq.optimizer_state_bytes(opt) < 0.3 * tq.optimizer_state_bytes(adam)
    assert (tq.optimizer_state_bytes(opt) - 4) * 4 > tq.optimizer_state_bytes(adam) - 4 * 2

    model = build_model(RunConfig(**SCHEME_CONFIGS["bnn_lenet"]), device="cpu")[0]
    lenet = tq.QuantizedAdam(model.parameters())
    assert sum(p.numel() for p in model.parameters()) == 5_029_760
    assert tq.optimizer_state_bytes(lenet) == 10_221_548
    jshapes = {n: jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
               for n, p in model.named_parameters()}
    jstate = jax.eval_shape(jq.quantized_adam().init, jshapes)
    assert sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(jstate)) == 10_221_548


def test_state_dict_round_trip_keeps_codes(tmp_path):
    """``state_dict`` -> ``torch.save`` -> ``load_state_dict`` keeps int8 and
    uint8 codes (the base class would cast them to float32), scales, the
    float32 moments of small parameters and the count."""
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(600)), torch.nn.Parameter(torch.randn(5))]
    opt = tq.QuantizedAdam(params, lr=1e-3)
    for _ in range(3):
        for p in params:
            p.grad = torch.randn_like(p)
        opt.step()
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    fresh = [torch.nn.Parameter(p.detach().clone()) for p in params]
    other = tq.QuantizedAdam(fresh, lr=1e-3)
    other.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
    assert other.param_groups[0]["count"] == 3
    for p, q in zip(params, fresh):
        a, b = opt.state[p], other.state[q]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert other.state[fresh[0]]["mu_codes"].dtype == torch.int8
    assert other.state[fresh[0]]["nu_codes"].dtype == torch.uint8


def test_schedule_belongs_to_the_optimizer():
    """With an optimizer handed in, the state sets no rate (one schedule
    mechanism, not two), the optimizer reads its schedule at the count
    before each update, and a rate passed to both is refused."""
    model = models.BinaryConnectMLP(784, 16)
    sched = train.cosine_decay_schedule(1e-2, 4)
    state = train.QuantTrainState.create_for(
        model, optimizer=tq.QuantizedAdam(model.parameters(), lr=sched))
    assert state.lr is None
    step = train.make_train_step()
    x, y = np.zeros((4, 784), np.float32), np.arange(4, dtype=np.int32)
    for i in range(4):
        step(state, (x, y))
        assert state.optimizer.param_groups[0]["lr"] == sched(i)
    assert state.optimizer.param_groups[0]["count"] == state.step == 4
    with pytest.raises(ValueError, match="optimizer"):
        train.QuantTrainState.create_for(model, lr=1e-3,
                                         optimizer=tq.QuantizedAdam(model.parameters()))


def test_trains_binaryconnect_mlp_to_adam_accuracy():
    """JAX's ``test_trains_binaryconnect_mlp_to_fp32_adam_accuracy`` on the
    port: the BinaryConnect MLP (hidden 64), 80 steps of 128 on the
    synthetic MNIST stand-in from one init, the 8-bit Adam against
    ``torch.optim.Adam`` under the same clamp; the 8-bit accuracy is at
    least Adam's - 0.02 and every kernel stays in [-1, 1]."""
    (xtr, ytr), (xte, yte) = data.mnist(flatten=True)
    init = models.BinaryConnectMLP(784, 64)
    accs = {}
    for name in ("adam8", "adam32"):
        model = models.BinaryConnectMLP(784, 64)
        model.load_state_dict(init.state_dict())
        if name == "adam8":
            state = train.QuantTrainState.create_for(
                model, optimizer=tq.QuantizedAdam(model.parameters(), lr=3e-3))
        else:
            state = train.QuantTrainState.create_for(model, lr=3e-3)
        step = train.make_train_step()
        for i, batch in enumerate(data.iterate_batches((xtr, ytr), 128)):
            if i >= 80:
                break
            step(state, batch)
        ev = train.make_eval_step()(state, (xte[:512], yte[:512]))
        accs[name] = float(ev["accuracy"])
        assert max(float(p.detach().abs().max()) for p, _ in state.clamp.params) <= 1.0
    assert accs["adam8"] >= accs["adam32"] - 0.02, accs
