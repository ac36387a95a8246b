"""The port's quantizer registry (``ops.get_quantizer``, ``SCHEMES``,
``STOCHASTIC_SCHEMES``), held against the JAX package's
(``pytorch_quantize_impls_tpu/ops/registry.py``, tests/test_registry.py).

The same numpy input goes through both registries. Deterministic schemes:
forward bit for bit, except ``xnor`` (alpha^2 sign(w), alpha a float32 mean
that XLA sums in order and PyTorch pairwise) within 2e-6 relative and
``log`` within 2 ulp (XLA's CPU ``exp2`` is inexact: here 2^-16 at x = 0,
one ulp off); the STE gradient of ``sum(q(x) * r)`` bit for bit, except
``dorefa_weight`` (the gradient of tanh and of its max normalizer) and
``xnor`` (alpha's, a sum over the tensor), float32 in another order, within
1e-6. The edge values in ``X`` (0, the clip bounds +-1, a rounding tie) hold
the gradients where ``jnp.abs`` (+1 at 0) and ``jnp.clip`` (half at a
bound) differ from PyTorch's defaults. Stochastic schemes take a
``torch.Generator`` where JAX takes a key: each equals its op on a
generator of the same seed. Unknown schemes and knobs raise as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu_torch import ops

RNG = np.random.default_rng(7)
X = RNG.normal(size=(16, 32)).astype(np.float32)
X[0, :4] = [0.0, 1.0, -1.0, 0.5]  # sign(0), the clip bounds, a rounding tie
R = RNG.normal(size=(16, 32)).astype(np.float32)
DETERMINISTIC = [s for s in jops.SCHEMES if s not in jops.STOCHASTIC_SCHEMES]


def _knobs(scheme):
    return {"bits": 4} if scheme.startswith("dorefa") or scheme in ("log", "lin") else {}


def _jax_forward_and_grad(jq):
    """JAX's q(X) op by op (jitted, XLA rewrites ``round(x n) / n`` and
    moves an ulp) and the gradient of sum(q(X) * R), jitted (op by op each
    primitive of the backward compiles on its own)."""
    g = jax.jit(jax.grad(lambda v: jnp.sum(jq(v) * R)))(jnp.asarray(X))
    return np.asarray(jq(jnp.asarray(X))), np.asarray(g)


def test_scheme_tuples_equal_jax():
    assert ops.SCHEMES == jops.SCHEMES
    assert ops.STOCHASTIC_SCHEMES == jops.STOCHASTIC_SCHEMES
    assert len(ops.SCHEMES) == 10


@pytest.mark.parametrize("scheme", DETERMINISTIC)
def test_deterministic_scheme_matches_jax(scheme):
    knobs = _knobs(scheme)
    jq, q = jops.get_quantizer(scheme, **knobs), ops.get_quantizer(scheme, **knobs)
    ref, ref_g = _jax_forward_and_grad(jq)
    x = torch.from_numpy(X.copy()).requires_grad_(True)
    y = q(x)
    (y * torch.from_numpy(R)).sum().backward()
    got = y.detach().numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if scheme == "xnor":
        np.testing.assert_allclose(got, ref, rtol=2e-6)
    elif scheme == "log":  # XLA's exp2 on the CPU is off by an ulp at some levels
        np.testing.assert_allclose(got, ref, rtol=2.5e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, ref)
    if scheme in ("dorefa_weight", "xnor"):
        np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(x.grad.numpy(), ref_g)


@pytest.mark.parametrize("scheme, knobs", [
    ("binary", {"ste_mode": "identity"}), ("binary", {"clip_bound": 0.5}),
    ("ternary", {"ste_mode": "identity"}), ("dorefa_weight", {"bits": 1}),
    ("dorefa_activation", {"bits": 2}), ("log", {"fsr": 1.0, "bits": 3, "with_sign": False}),
    ("log", {"bits": 4, "lin_back": False}), ("lin", {"fsr": 1.0, "bits": 3}),
    ("xnor", {"channel_axis": 0}),
])
def test_knobs_match_jax(scheme, knobs):
    """The knobs reach the op as in JAX: forward and gradient."""
    jq, q = jops.get_quantizer(scheme, **knobs), ops.get_quantizer(scheme, **knobs)
    ref, ref_g = _jax_forward_and_grad(jq)
    x = torch.from_numpy(X.copy()).requires_grad_(True)
    y = q(x)
    (y * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=2e-6, atol=0)
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scheme, op", [("binary_stoch", ops.binary_connect_stoch),
                                        ("ternary_stoch", ops.ternary_connect_stoch)])
def test_stochastic_scheme_equals_its_op(scheme, op):
    """(x, generator): the op on a generator of the same seed, the same
    draw; another seed draws otherwise; the STE gradient flows."""
    q = ops.get_quantizer(scheme)
    x = torch.from_numpy(X.copy()).requires_grad_(True)
    y = q(x, torch.Generator().manual_seed(3))
    assert torch.equal(y, op(x, torch.Generator().manual_seed(3)))
    assert not torch.equal(y, q(x, torch.Generator().manual_seed(4)))
    y.sum().backward()
    assert float(x.grad.abs().sum()) > 0


def test_unknown_scheme_raises_as_jax():
    with pytest.raises(ValueError, match="unknown scheme"):
        jops.get_quantizer("int3_magic")
    with pytest.raises(ValueError, match="unknown scheme"):
        ops.get_quantizer("int3_magic")


@pytest.mark.parametrize("scheme, knobs, at_call", [
    ("binary_stoch", {"bits": 1}, False), ("ternary_stoch", {"ste_mode": "clip"}, False),
    ("xnor", {"bits": 1}, False), ("binary", {"bits": 3}, True),
    ("binary_tanh", {"ste_mode": "clip"}, True), ("dorefa_weight", {"fsr": 1.0}, True),
])
def test_unknown_knobs_raise_as_jax(scheme, knobs, at_call):
    """TypeError in both packages: at lookup for xnor and the stochastic
    schemes, when the quantizer is called for the others."""
    for get, x in ((jops.get_quantizer, jnp.asarray(X)), (ops.get_quantizer, torch.from_numpy(X))):
        with pytest.raises(TypeError):
            q = get(scheme, **knobs)
            assert at_call
            q(x)
