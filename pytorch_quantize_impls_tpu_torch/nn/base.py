"""Generic quantized Dense/Conv modules.

Counterpart of ``pytorch_quantize_impls_tpu/nn/base.py``. ``QuantDense`` and
``QuantConv`` hold a float32 master ``weight`` and apply a weight quantizer
(and optionally an input quantizer) on every forward call: the fake-quant
forward. ``out_scale`` (the XNOR layers' alpha) is a per-output-channel
scale computed from the master weight and applied to the output, after the
op and before the bias, as the JAX package does: the op itself stays an
integer sum of signs, bit-identical to the packed kernels' alpha epilogue.
They carry the ``scheme/w_bits/a_bits/fsr`` metadata that
``infer.pack_model`` reads.

Layouts follow the JAX package at the module boundary: ``QuantDense`` takes
(..., in) and ``QuantConv`` NHWC. Weights use PyTorch's layouts, (out, in)
and OIHW (``utils.bridge`` converts).

:func:`intercept_quant_layers` is the counterpart of flax's
``intercept_methods`` for these two classes: while it is active in a thread,
each of their forward calls goes to the interceptor instead, which is how
``infer.packed_apply`` runs a model on its packed weights.

Stochastic quantizers (tagged by :func:`stochastic`) take ``(x, generator)``.
In training mode they draw from the generator that :func:`quant_generator`
holds for the running thread: the train step sets it from (seed, step), as
the JAX package folds the step into its ``'quant'`` key. Outside such a
block a stochastic layer in training mode raises; it never draws from the
global RNG. In eval mode (``not module.training``) they call their
``eval_fn`` instead. DoReFa's gradient quantizer draws in training mode
from the same generator (:func:`current_generator`), and draws nothing in
eval mode.

:func:`sharded_step` holds a sharded train or eval step's mesh
(``parallel.collectives.MeshContext``) for the running thread. Under it a
layer whose weight is a column shard (one of the context's ``columns``)
runs Megatron's column-parallel order: its input through ``copy_to_model``
(the cotangent all-reduced over the model group), the weight quantized as
a shard of the whole kernel (DoReFa's statistic reduced over the model
group, a stochastic draw of the whole kernel cut to the shard), its block of
out-features, the blocks all-gathered, then the epilogue with the gathered
scale and the replicated bias. A stochastic draw on the batch
(:func:`batch_generator`, DoReFa's gradient noise) draws the whole batch's
and keeps this data rank's rows. With no context, nothing changes.

A layer with a training penalty (PACT's L2 on its clip level, the elastic
layers' grid penalty, the MoE's switch aux loss of its last forward)
exposes it as ``penalty()``;
:func:`collect_elastic_losses` sums every such penalty of a model, as the
JAX package sums its ``losses`` collection.

``dtype`` is the compute dtype (``None`` or ``torch.bfloat16``), the JAX
layers' ``dtype``: the input is quantized at its own dtype and the float32
master at float32, then both are cast to ``dtype`` before the product, and
the output scale and the bias are cast to the output's dtype. ``None``
computes at the promoted dtype of input and weight, as ``jnp.dot`` does.
Where the product is a sum of +-1 terms (``_integer_sums``) and ``dtype`` is
narrower than float32, it is taken in float32, where it is the exact
integer, and rounded once to ``dtype``: what the JAX package's bf16 product
gives on the CPU, on any device.

``Dense`` and ``Conv`` are the plain layers of the ``quantized=False``
twins (flax's ``nn.Dense``/``nn.Conv``, input, kernel and bias cast to
``dtype``). :func:`init_like_flax` draws every
layer's weight as flax's initializers do (``glorot_normal`` for quantized
layers, ``lecun_normal`` for the plain ones, both truncated normals), from a
seeded generator on the CPU, so a model draws the same weights on any
device.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc
from pytorch_quantize_impls_tpu_torch.ops.common import round_ste

Quantizer = Callable[[torch.Tensor], torch.Tensor]
# (module, x, fake_quant_forward) -> y
Interceptor = Callable[[nn.Module, torch.Tensor, Callable], torch.Tensor]

_interceptor: contextvars.ContextVar[Optional[Interceptor]] = contextvars.ContextVar(
    "quant_layer_interceptor", default=None
)


@contextlib.contextmanager
def intercept_quant_layers(fn: Interceptor):
    """Route every ``QuantDense``/``QuantConv`` forward in this thread to
    ``fn(module, x, fake_quant_forward)`` until the block exits."""
    token = _interceptor.set(fn)
    try:
        yield
    finally:
        _interceptor.reset(token)


_sharded: contextvars.ContextVar[Optional[object]] = contextvars.ContextVar(
    "sharded_step", default=None
)


@contextlib.contextmanager
def sharded_step(context):
    """Let the modules in this thread reduce over ``context``'s mesh (a
    ``parallel.collectives.MeshContext``) until the block exits; ``None``
    is no mesh."""
    token = _sharded.set(context)
    try:
        yield
    finally:
        _sharded.reset(token)


def mesh_context():
    """The mesh context :func:`sharded_step` holds for this thread, or None."""
    return _sharded.get()


def column_context(module: nn.Module):
    """The mesh context where ``module``'s weight is a column shard, else None."""
    context = _sharded.get()
    return context if context is not None and module in context.columns else None


_generator: contextvars.ContextVar[Optional[torch.Generator]] = contextvars.ContextVar(
    "quant_generator", default=None
)


@contextlib.contextmanager
def quant_generator(generator: torch.Generator):
    """Let stochastic quantizers in training mode draw from ``generator`` in
    this thread until the block exits."""
    token = _generator.set(generator)
    try:
        yield
    finally:
        _generator.reset(token)


class _Stochastic:
    """A quantizer ``fn(x, generator)`` tagged stochastic, with the
    deterministic ``eval_fn(x)`` used in eval mode."""

    stochastic = True

    def __init__(self, fn, eval_fn):
        self.fn = fn
        self.eval_fn = eval_fn

    def __call__(self, x, generator):
        return self.fn(x, generator)


def stochastic(fn, eval_fn: Quantizer) -> _Stochastic:
    """Tag ``fn(x, generator)`` as a stochastic quantizer; ``eval_fn`` is its
    deterministic replacement at eval time."""
    return _Stochastic(fn, eval_fn)


def clipped_master(w: torch.Tensor) -> torch.Tensor:
    """The eval rule of the stochastic weight quantizers: ``clip(w, -1, 1)``,
    the expectation of a draw."""
    return torch.clamp(w, -1.0, 1.0)


def current_generator() -> torch.Generator:
    """The generator :func:`quant_generator` holds for this thread; raises
    outside such a block."""
    generator = _generator.get()
    if generator is None:
        raise RuntimeError(
            "a stochastic quantizer in training mode draws from the train step's generator: "
            "run it inside train.make_train_step's step (or nn.quant_generator), or call "
            ".eval() first"
        )
    return generator


def batch_generator(x: torch.Tensor):
    """The generator of a draw of ``x``'s shape over the batch:
    :func:`current_generator`, or under a sharded step its block draw of the
    whole batch's rows (``MeshContext.batch_draw``)."""
    context = _sharded.get()
    generator = current_generator()
    return generator if context is None else context.batch_draw(generator, x)


def _apply_quant(q, x: torch.Tensor, module: nn.Module, draw=None) -> torch.Tensor:
    """``q(x)``; a stochastic ``q`` in training mode draws from the step's
    generator, or from ``draw(generator)`` where given (a shard's block)."""
    if q is None:
        return x
    if not getattr(q, "stochastic", False):
        return q(x)
    if not module.training:
        return q.eval_fn(x)
    generator = current_generator()
    return q(x, generator if draw is None else draw(generator))


def scheme_weight_quant(scheme: str, w_bits: int = 1, fsr: float = 0.0):
    """The weight quantizer of a transformer ``scheme``: the LM's
    projections and its MoE experts take it (``None`` for ``"none"``)."""
    if scheme == "none":
        return None
    if scheme == "binary":
        return ops.binary_connect_det
    if scheme == "ternary":
        return ops.ternary_connect_det
    if scheme == "dorefa":
        return functools.partial(ops.dorefa_weight, bits=w_bits)
    if scheme == "log":
        return functools.partial(ops.log_quant, fsr=fsr, bits=w_bits)
    if scheme == "lin":
        return functools.partial(ops.lin_quant, fsr=fsr, bits=w_bits)
    raise ValueError(f"unknown scheme {scheme!r}")


# dtypes that hold every sum of +-1 terms a layer makes exactly
_WIDE = (torch.float32, torch.float64)


class _QuantLayer(nn.Module):
    kernel_init = "glorot_normal"  # init_like_flax's rule: or lecun_normal, uniform

    def __init__(self, weight_quant, input_quant, out_scale, scheme, w_bits, a_bits, fsr,
                 act_scale, dtype):
        super().__init__()
        self.weight_quant = weight_quant
        self.input_quant = input_quant
        self.out_scale = out_scale  # master weight -> (out,) scale of the output
        self.scheme = scheme  # none|binary|xnor|dorefa|log|lin|ternary
        self.w_bits = w_bits
        self.a_bits = a_bits  # 0 = inputs not quantized
        self.fsr = fsr
        self.dtype = dtype  # compute dtype; None: the promoted dtype of input and weight
        # +-1 inputs and weights: every output of the product is an integer
        self._integer_sums = (scheme in ("binary", "xnor") and a_bits == 1 and not act_scale
                              and not getattr(weight_quant, "stochastic", False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = _interceptor.get()
        if fn is not None:
            return fn(self, x, self.fake_quant_forward)
        return self.fake_quant_forward(x)

    def _quantized(self, x, tp=None):
        """The quantized input and weight, both at the compute dtype; under
        ``tp`` (the layer's column context) the weight is a shard's."""
        x = _apply_quant(self.input_quant, x, self)
        if tp is None:
            w = _apply_quant(self.weight_quant, self.weight, self)
        else:
            w = self._quantized_shard(self.weight, tp.reduce,
                                      lambda generator: tp.weight_draw(generator, self.weight))
        cdt = self.dtype or torch.promote_types(x.dtype, w.dtype)
        return x.to(cdt), w.to(cdt)

    def _quantized_shard(self, w, reduce, draw):
        """The weight quantizer on ``w``, a block of out-features of the
        whole kernel: DoReFa with the whole kernel's statistic
        (``reduce``), a stochastic quantizer on the block ``draw`` gives of
        the whole kernel's draw, any other entry by entry."""
        if self.scheme == "dorefa" and self.weight_quant is not None:
            return ops.dorefa_weight(w, self.w_bits, reduce=reduce)
        return _apply_quant(self.weight_quant, w, self, draw)

    def _column_input(self, x):
        """The input, and this layer's column context (None off the mesh)."""
        tp = column_context(self)
        return (x, None) if tp is None else (tp.copy_to_model(x), tp)

    def _exact(self, x: torch.Tensor) -> bool:
        """True where the product's integer sums are taken in float32 and
        rounded once to the narrower compute dtype."""
        return self._integer_sums and x.dtype not in _WIDE

    def _finish(self, y, tp=None):
        """The epilogue on the op's output; under ``tp`` the output blocks
        and the output scale are first gathered over the model group."""
        scale = None if self.out_scale is None else self.out_scale(self.weight)
        if tp is not None:
            y = tp.gather(y, -1)
            scale = None if scale is None else tp.gather(scale, 0)
        return self._epilogue(y, scale)

    def _epilogue(self, y, scale):
        if scale is not None:
            y = y * scale.to(y.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class QuantDense(_QuantLayer):
    """Dense layer with quantized weights (and optionally inputs)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        weight_quant: Optional[Quantizer] = None,
        input_quant: Optional[Quantizer] = None,
        out_scale: Optional[Quantizer] = None,
        use_bias: bool = True,
        scheme: str = "none",
        w_bits: int = 1,
        a_bits: int = 0,
        fsr: float = 0.0,
        act_scale: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(weight_quant, input_quant, out_scale, scheme, w_bits, a_bits, fsr,
                         act_scale, dtype)
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.xavier_normal_(self.weight)

    def fake_quant_forward(self, x: torch.Tensor) -> torch.Tensor:
        x, tp = self._column_input(x)
        x, w = self._quantized(x, tp)
        return self._finish(self._op(x, w), tp)

    def _op(self, x, w):
        if self._exact(x):
            return (x.float() @ w.float().T).to(x.dtype)
        return x @ w.T


class QuantConv(_QuantLayer):
    """2-D conv (NHWC input, OIHW weight) with quantized weights (and
    optionally inputs). ``act_scale=True`` says that the input quantizer
    scales its +-1 codes by a learnable per-channel g, so one-bit sums are
    not integers and are not rounded."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        *,
        strides: Tuple[int, int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        weight_quant: Optional[Quantizer] = None,
        input_quant: Optional[Quantizer] = None,
        out_scale: Optional[Quantizer] = None,
        use_bias: bool = True,
        scheme: str = "none",
        w_bits: int = 1,
        a_bits: int = 0,
        fsr: float = 0.0,
        act_scale: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(weight_quant, input_quant, out_scale, scheme, w_bits, a_bits, fsr,
                         act_scale, dtype)
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.xavier_normal_(self.weight)

    def fake_quant_forward(self, x: torch.Tensor) -> torch.Tensor:
        x, tp = self._column_input(x)
        x, w = self._quantized(x, tp)
        return self._finish(self._op(x, w), tp)

    def _op(self, x, w):
        exact = self._exact(x)
        y = conv2d_nhwc(x.float() if exact else x, w.float() if exact else w, self.strides,
                        self.padding)
        if self._integer_sums:
            # +-1 inputs and weights: every output is an integer, which the
            # algorithm cuDNN picks misses by up to ~1e-4 at some shapes; the
            # JAX package's convs are exact, and ties among the sums decide
            # where a max pool's gradient goes. Rounded before the one
            # rounding to a narrower compute dtype.
            y = round_ste(y)
        return y.to(x.dtype)


class Dense(QuantDense):
    """Plain dense layer (flax ``nn.Dense``): no quantizer, ``lecun_normal``
    init, float32 weights, computed at ``dtype``."""

    kernel_init = "lecun_normal"

    def __init__(self, in_features: int, features: int, *, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, features, use_bias=use_bias, dtype=dtype)


class Conv(QuantConv):
    """Plain NHWC conv (flax ``nn.Conv``): no quantizer, ``lecun_normal``
    init, JAX's padding, float32 weights, computed at ``dtype``."""

    kernel_init = "lecun_normal"

    def __init__(self, in_channels: int, features: int, kernel_size: Tuple[int, int] = (3, 3), *,
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, kernel_size, strides=strides, padding=padding,
                         use_bias=use_bias, dtype=dtype)


# flax's variance_scaling: the std of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax(model: nn.Module, seed: int) -> nn.Module:
    """Draw every quantized and plain layer's weight as flax does, in module
    order from one generator seeded with ``seed`` on the CPU: a truncated
    normal of variance 2 / (fan_in + fan_out) (``glorot_normal``) or
    1 / fan_in (``lecun_normal``), or uniform(-1, 1) (the ternary layers);
    the MoE router and stacked expert kernels (``glorot_params()``) by
    ``glorot_normal`` over their last two axes; biases 0; every learnable
    activation scale (``act_scale``) 1. Returns ``model``."""
    gen = torch.Generator().manual_seed(seed)

    def truncated(shape, denom):
        w = torch.empty(shape)
        std = math.sqrt(1.0 / denom) / _TRUNCATED_STD
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)

    for m in model.modules():
        if isinstance(getattr(m, "act_scale", None), nn.Parameter):
            m.act_scale.fill_(1.0)
        if callable(getattr(m, "glorot_params", None)):
            # stacked expert kernels (nn.QuantMoE): fans of the last two
            # axes, flax's glorot_normal(batch_axis=(0,))
            for p in m.glorot_params():
                p.copy_(truncated(p.shape, (p.shape[-2] + p.shape[-1]) / 2))
            continue
        if not isinstance(m, _QuantLayer):
            continue
        if m.kernel_init == "uniform":
            w = torch.empty(m.weight.shape).uniform_(-1.0, 1.0, generator=gen)
        else:
            shape = m.weight.shape
            receptive = math.prod(shape[2:])
            fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
            denom = fan_in if m.kernel_init == "lecun_normal" else (fan_in + fan_out) / 2
            w = truncated(shape, denom)
        m.weight.copy_(w)
        if m.bias is not None:
            m.bias.zero_()
    return model


def collect_elastic_losses(model: nn.Module) -> torch.Tensor:
    """The sum of every ``penalty()`` of ``model``'s modules (the JAX
    package's sum over the ``losses`` collection); a 0-d zero when none has
    one."""
    terms = [m.penalty() for m in model.modules() if callable(getattr(m, "penalty", None))]
    if not terms:
        return torch.zeros((), device=next(model.parameters()).device)
    return sum(terms[1:], terms[0])
