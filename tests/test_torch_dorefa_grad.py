"""DoReFa's gradient quantizer (paper eq. 12) and the one-bit DoReFa scale
in the packed paths, the port held against the JAX package.

The quantizer's backward runs on one shared draw ``u`` in both packages and
must agree bit for bit, at 2, 4, 6 and 8 bits and on an all-zero cotangent.
The draws themselves differ (threefry against Philox), so a G6 step is not
compared with JAX's: the drawing form is checked statistically (unbiased,
on its 2^k levels) and in ``LinearDorefa(g_bits=6)``, and the W1A2 MLP's
step with G0 against JAX's by ``tests/test_torch_train.py``'s per-step rule.

One-bit DoReFa weights are ``E|W| sign(W)``. Both packages' packers kept
only the sign; the port's records now carry ``E|W|`` as alpha, and every
packed route applies it: packed within 1e-5 (1 + |ref|) of fake-quant on the
CPU, where JAX's packed path stays more than 10x that far off on the same
weights; a record without alpha (a JAX artifact) raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu.ops import dorefa as jdorefa
from pytorch_quantize_impls_tpu_torch import infer, models, nn as tnn, ops, train
from pytorch_quantize_impls_tpu_torch.infer import packed as tpacked
from pytorch_quantize_impls_tpu_torch.kernels import conv as tconv
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as tpm
from pytorch_quantize_impls_tpu_torch.utils import (
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
    load_flax_variables,
)
from _torch_train_helpers import LR, steps_against_jax

SEAM = 1e-5  # packed against fake-quant: |gap| <= SEAM (1 + |ref|)


def _draw(shape, seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=shape) * 3e-3).astype(np.float32)
    u = rng.uniform(size=shape).astype(np.float32)
    u.flat[:4] = [0.0, 0.25, 0.5, 0.75]
    return rng.normal(size=shape).astype(np.float32), g, u


@pytest.mark.parametrize("zero", [False, True], ids=["normal", "zero_g"])
@pytest.mark.parametrize("bits", [2, 4, 6, 8])
def test_grad_prim_matches_jax_on_shared_u(bits, zero):
    """Forward the identity, backward bit for bit against the vjp of JAX's
    ``_dorefa_grad_prim`` on the same u; an all-zero cotangent takes the
    max|g| = 0 guard in both."""
    x, g, u = _draw((37, 24), bits)
    if zero:
        g = np.zeros_like(g)
    n = jnp.asarray(float(2**bits - 1), jnp.float32)
    jy, vjp = jax.vjp(lambda v: jdorefa._dorefa_grad_prim(v, jnp.asarray(u), n),
                      jnp.asarray(x))
    jg = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.tensor(x, requires_grad=True)
    y = ops.dorefa_grad_prim(xt, torch.from_numpy(u), bits)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(xt.grad.numpy(), jg)
    assert np.isfinite(jg).all()


@pytest.mark.parametrize("bits", [2, 6])
def test_gradient_draws_are_unbiased_on_the_levels(bits):
    """4000 draws of one cotangent row: the mean of g_q within 4 sigma of g
    per entry (E[g_q] = g); each g_q on its grid, ``g_q / 2m + 1/2 + N`` an
    integer multiple of 1/(2^k - 1) in [0, 1], with at most 2^k levels."""
    n_draws, n = 4000, float(2**bits - 1)
    g_row = torch.linspace(-1.0, 1.0, 33) * 2e-3
    x = torch.zeros(n_draws, g_row.numel(), requires_grad=True)
    gen = torch.Generator().manual_seed(5)
    ops.dorefa_gradient(x, gen, bits).backward(g_row.expand(n_draws, -1))
    m = float(g_row.abs().max())
    mean = x.grad.double().mean(0)
    sigma = (2 * m / n) / 2 / np.sqrt(n_draws)  # a draw's spread is at most a level
    assert ((mean - g_row.double()).abs() <= 4 * sigma + 1e-9).all()
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(5))
    noise = (u.double() - 0.5) / n
    levels = (x.grad.double() / (2 * m) + 0.5 + noise) * n
    assert (levels - levels.round()).abs().max() < 1e-3
    assert levels.round().min() >= 0 and levels.round().max() <= n
    assert len(torch.unique(levels.round())) <= 2**bits
    assert ops.dorefa_gradient(x, gen, 32) is x


def test_dorefa_quantizers_match_jax():
    """The factory's weight and activation callables against JAX's; its
    gradient callable is the identity forward."""
    w = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
    jq, tq = jops.dorefa_quantizers(2, 3, 6), ops.dorefa_quantizers(2, 3, 6)
    np.testing.assert_array_equal(tq["weight"](torch.from_numpy(w)).numpy(),
                                  np.asarray(jq["weight"](jnp.asarray(w))))
    np.testing.assert_array_equal(tq["activation"](torch.from_numpy(w)).numpy(),
                                  np.asarray(jq["activation"](jnp.asarray(w))))
    xt = torch.from_numpy(w)
    assert torch.equal(tq["gradient"](xt, torch.Generator()), xt)


def _layer_pair(seed=0):
    torch.manual_seed(seed)
    g6 = tnn.LinearDorefa(24, 16, bits=1, a_bits=2, g_bits=6)
    g0 = tnn.LinearDorefa(24, 16, bits=1, a_bits=2)
    g0.load_state_dict(g6.state_dict())
    return g6, g0


def test_linear_dorefa_g6_forward_grid_and_refusal():
    """g_bits=6: the forward equals the G0 layer's; the input gradient is
    the G0 gradient through the primitive on the draw of the step's
    generator, on its 64 levels; the weight gradient is the G0 layer's of
    the same upstream; outside a train step it raises, in eval mode it
    draws nothing."""
    g6, g0 = _layer_pair()
    x = torch.from_numpy(np.random.default_rng(2).uniform(-0.5, 1.5, (32, 24)).astype(np.float32))
    gy = torch.from_numpy(np.random.default_rng(3).normal(size=(32, 16)).astype(np.float32))
    x6, x0 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    with tnn.quant_generator(torch.Generator().manual_seed(9)):
        y6 = g6(x6)
    y0 = g0(x0)
    assert torch.equal(y6, y0)
    y6.backward(gy)
    y0.backward(gy)
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(9))
    ref = x0.grad.clone().requires_grad_(False)
    xr = x.clone().requires_grad_(True)
    ops.dorefa_grad_prim(xr, u, 6).backward(ref)
    assert torch.equal(x6.grad, xr.grad)
    assert not torch.equal(x6.grad, x0.grad)
    m = float(ref.abs().max())
    levels = (x6.grad.double() / (2 * m) + 0.5 + (u.double() - 0.5) / 63) * 63
    assert (levels - levels.round()).abs().max() < 1e-3
    assert torch.equal(g6.dense.weight.grad, g0.dense.weight.grad)
    with pytest.raises(RuntimeError, match="train step"):
        g6(x)
    g6.eval()
    assert torch.equal(g6(x), g0.eval()(x))


def test_w1a2_g0_mlp_steps_match_jax():
    """The W1A2 MLP (64-32-32-10, BatchNorm) with G0, from flax-like initial
    weights: three teacher-forced steps against JAX's by the per-step rule,
    after one step of JAX's alone. At step 0 every BatchNorm bias is 0, and
    one-bit weights times 2-bit codes put the BatchNorm inputs on a coarse
    grid, where a row often equals its batch mean: its normalized value is
    then a rounding residue on the ReLU's boundary, which each package
    rounds its own way (here two channels of bn1 at step 0). Once the bias
    has moved, such a row sits at the bias, off the boundary."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(128, 64)).astype(np.float32)
    y = rng.integers(0, 10, 128).astype(np.int32)
    jm = jmodels.MLP(features=(32, 32, 10), layer="dorefa", bits=1, a_bits=2)
    tm = tnn.init_like_flax(models.MLP(64, (32, 32, 10), layer="dorefa", bits=1, a_bits=2), 0)
    steps_against_jax(jm, tm, x, y, first_step=1)


def test_g6_config_builds_trains_and_draws_per_step():
    """dorefa_digits_g6 through build_model and the train step on the CPU
    (width cut to 32): W1A2G6 in every layer, the head included; the loss
    finite; the same seed twice bit-equal, another seed different."""
    cfg = RunConfig(**SCHEME_CONFIGS["dorefa_digits_g6"])
    assert (cfg.w_bits, cfg.a_bits, cfg.g_bits, cfg.deterministic) == (1, 2, 6, False)
    model = build_model(cfg, device="cpu")[0]
    assert [m.g_bits for m in (model.layer0, model.layer1, model.head)] == [6, 6, 6]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64, 64)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)

    def run(seed):
        tm = models.MLP(64, (32, 32, 10), layer="dorefa", bits=1, a_bits=2, g_bits=6)
        tnn.init_like_flax(tm, 0)
        ts = train.QuantTrainState.create_for(tm, lr=LR, seed=seed)
        step = train.make_train_step()
        for i in range(3):
            _, met = step(ts, (x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16]))
            assert np.isfinite(float(met["loss"]))
        return torch.cat([p.detach().flatten() for p in tm.parameters()])

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


# --- the one-bit DoReFa scale in the packed paths -------------------------------


class _Net(nn.Module):
    """One-bit DoReFa dense and conv layers, with quantized (A2) and real
    inputs."""

    def __init__(self):
        super().__init__()
        self.conv_a2 = tnn.DorefaConv(3, 8, (3, 3), bits=1, a_bits=2)
        self.conv_real = tnn.DorefaConv(8, 8, (3, 3), strides=(2, 2), bits=1)
        self.dense_a2 = tnn.LinearDorefa(4 * 4 * 8, 32, bits=1, a_bits=2)
        self.dense_real = tnn.LinearDorefa(32, 10, bits=1)

    def forward(self, x):
        x = self.conv_real(torch.relu(self.conv_a2(x)))
        x = self.dense_a2(x.reshape(x.shape[0], -1))
        return self.dense_real(torch.relu(x))


def _small_scale(model, target=0.006):
    """Every weight scaled to E|W| ~ target, far from the grid's 1: the
    scale the parent's packers dropped."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (tnn.QuantDense, tnn.QuantConv)):
                m.weight.mul_(target / m.weight.abs().mean())
    return model.eval()


def _layer_gaps(model, packed, x):
    """Per quantized layer: max |packed - fake-quant| / (1 + |ref|) on the
    same input."""
    gaps = {}

    def interceptor(m, xin, fake_quant_forward):
        ref = fake_quant_forward(xin)
        path = next(p for p, mm in tpacked._quant_layers(model) if mm is m)
        rec = packed[path]
        got = (tpacked._conv_forward(m, rec, xin, m.bias) if isinstance(m, tnn.QuantConv)
               else tpacked._dense_forward(rec, xin, m.bias))
        gaps[path] = float(((got - ref).abs() / (1 + ref.abs())).max())
        return ref

    with torch.no_grad(), tnn.intercept_quant_layers(interceptor):
        model(x)
    return gaps


@pytest.mark.parametrize("route", ["fused", "decode"])
def test_w1_packed_equals_fake_quant_on_every_route(route, monkeypatch):
    """The records carry E|W| (alpha, one value per out channel); every
    layer's packed output, unprepared (K6, K5 by the route, the real-input
    decode) and prepared (K7 then K3), is within SEAM (1 + |ref|) of its
    fake-quant forward on the same input, and so are the logits; the conv
    by im2col (K6) too."""
    monkeypatch.setattr(tconv, "conv_route", lambda *shape: route)
    torch.manual_seed(1)
    model = _small_scale(_Net())
    x = torch.from_numpy(np.random.default_rng(7).uniform(-0.2, 1.2, (4, 8, 8, 3))
                         .astype(np.float32))
    packed = infer.pack_model(model)
    for path, rec in packed.items():
        w = model.get_submodule(".".join(path)).weight
        assert rec.alpha.shape == (rec.kernel_shape[-1],)
        assert torch.equal(rec.alpha, w.abs().mean().expand(rec.kernel_shape[-1]))
    with torch.no_grad():
        fq = model(x)
    for recs in (packed, infer.prepare(packed)):
        assert max(_layer_gaps(model, recs, x).values()) <= SEAM
        got = infer.packed_apply(model, recs, x)
        assert float(((got - fq).abs() / (1 + fq.abs())).max()) <= SEAM
    rec = packed[("conv_a2", "conv")]
    pc = tconv.PackedConv("dorefa", rec.packed, (3, 3), 3, 8, None, 1, 2,
                          w_scale=rec.alpha_host)
    xq = ops.dorefa_activation(x, 2)
    direct = tconv.packed_conv2d(xq, pc)
    im2col = tconv.packed_conv2d(xq, pc, mode="im2col")
    np.testing.assert_allclose(im2col.numpy(), direct.numpy(), rtol=1e-6, atol=1e-9)
    with torch.no_grad():
        ref = model.conv_a2.conv.fake_quant_forward(x) - model.conv_a2.conv.bias
    assert float(((direct - ref).abs() / (1 + ref.abs())).max()) <= SEAM


def test_epilogue_scale_is_one_float32_product_on_both_routes():
    """K6's scalar and K3's vector epilogue give the same bits: f32(f32(1 /
    (n_w n_a)) alpha); so the plain K6 equals the plain K7 + K3 route."""
    alpha = np.float32(0.0058123)
    assert tpm.epilogue_scale(1, 2, float(alpha)) == float(np.float32(1 / 3) * alpha)
    vec = tpm.epilogue_vector(1, 2, 5, torch.full((5,), float(alpha)), "cpu")
    assert torch.equal(vec, torch.full((5,), tpm.epilogue_scale(1, 2, float(alpha))))
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.integers(0, 4, (9, 70)).astype(np.int8))
    w = torch.from_numpy(np.where(rng.normal(size=(70, 12)) >= 0, 1.0, -1.0).astype(np.float32))
    wp = tpm.pack_dorefa_weights(w * float(alpha), 1)
    k6 = tpm.dorefa_gemm(a, wp, w_bits=1, a_bits=2, alpha=float(alpha))
    k3 = tpm.dorefa_gemm_decoded(a, tpm.decode_dorefa_weights(wp, w_bits=1), w_bits=1, a_bits=2,
                                 alpha=torch.full((12,), float(alpha)))
    assert torch.equal(k6, k3)
    np.testing.assert_allclose(k6.numpy(), (a.double() @ w.double() / 3 * alpha).numpy(),
                               rtol=1e-6)


def test_jax_drifts_where_the_port_holds(tmp_path):
    """The same weights in both packages (64-64-10, W1A2, no BatchNorm):
    JAX's packed_apply is more than 10x the seam off its fake-quant logits
    (the dropped E|W|), the port's within it; JAX's artifact, which has no
    alpha, raises on load, and a hand-made record without alpha raises in
    the forward and in prepare()."""
    rng = np.random.default_rng(10)
    x = rng.uniform(-0.2, 1.2, (16, 64)).astype(np.float32)
    jm = jmodels.MLP(features=(64, 10), layer="dorefa", bits=1, a_bits=2, use_batchnorm=False)
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init({"params": jax.random.PRNGKey(0)},
                                                        jnp.asarray(x), train=False)))
    xj = jnp.asarray(x)
    jref = np.asarray(jm.apply(v, xj, train=False))
    jpk = jinfer.pack_model(jm, v, xj)
    jgot = np.asarray(jinfer.packed_apply(jm, v, jpk, xj))
    jax_gap = float((np.abs(jgot - jref) / (1 + np.abs(jref))).max())
    tm = load_flax_variables(models.MLP(64, (64, 10), layer="dorefa", bits=1, a_bits=2,
                                        use_batchnorm=False), v, device="cpu").eval()
    with torch.no_grad():
        tref = tm(torch.from_numpy(x))
    np.testing.assert_allclose(tref.numpy(), jref, rtol=1e-5, atol=1e-6)
    tgot = infer.packed_apply(tm, infer.pack_model(tm), torch.from_numpy(x))
    port_gap = float(((tgot - tref).abs() / (1 + tref.abs())).max())
    assert port_gap <= SEAM < 10 * SEAM < jax_gap, (port_gap, jax_gap)
    path = str(tmp_path / "jax.npz")
    jinfer.save_packed(path, jpk)
    with pytest.raises(ValueError, match="ROADMAP section 3"):
        infer.load_packed(path, device="cpu")
    rec = infer.pack_model(tm)[("layer0", "dense")]
    bare = tpacked.PackedLayer(packed=rec.packed, kind="dense", scheme="dorefa", w_bits=1,
                               a_bits=2, kernel_shape=rec.kernel_shape)
    with pytest.raises(ValueError, match="ROADMAP section 3"):
        tpacked._dense_forward_2d(bare, torch.zeros(2, 64), None)
    with pytest.raises(ValueError, match="ROADMAP section 3"):
        infer.prepare({("layer0", "dense"): bare})


def test_fused_resnet_refuses_one_bit_weights():
    model = models.DorefaResNet20(w_bits=1, a_bits=2, width=4).eval()
    with pytest.raises(NotImplementedError, match="w_bits >= 2"):
        infer.export_fused_resnet20(model)
