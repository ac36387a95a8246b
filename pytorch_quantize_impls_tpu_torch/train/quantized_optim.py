"""Block-wise 8-bit Adam: the optimizer's moments stored as 8-bit log codes.

Counterpart of ``pytorch_quantize_impls_tpu/train/quantized_optim.py``
(``quantized_adam``). Adam's two float32 moments are 8 bytes per parameter;
this optimizer keeps them as

* ``m`` (signed)       -> int8 sign x log-magnitude codes,
* ``v`` (non-negative) -> uint8 log codes,

each with a float32 absmax per block of ``block`` elements: about 2 bytes
per parameter. Codes count octaves below the block's absmax (127 levels over
2^-12..1 for m, 255 over 2^-24..1 for v), so the relative error is bounded
everywhere, which ``1 / sqrt(v)`` needs; code 0 is kept for an exact 0, and
a value below the floor keeps code 1. Each update decodes the moments, runs
Adam's arithmetic in float32 in the JAX package's order
(``-lr (m / bc1) / (sqrt(v / bc2) + eps)``, bias corrections in float32),
and encodes them again. Parameters of fewer than ``min_quantized_size``
elements (biases, BatchNorm) keep float32 moments.

Usage, where ``torch.optim.Adam`` went::

    opt = QuantizedAdam(model.parameters(), lr=train.cosine_decay_schedule(3e-3, steps))
    state = train.QuantTrainState.create_for(model, optimizer=opt)

``lr`` is a float or a schedule ``count -> lr``, read at the count before
the update, as optax reads it: the optimizer owns its schedule, and the
train state leaves its rate alone. The count lives in each parameter group
(``group["count"]``), so ``state_dict()``/``load_state_dict()`` carry it
with the codes and scales.

The update is plain PyTorch, as the JAX package's is XLA-fused ``jnp``: no
kernel of the port runs here. The decode reads a 256-entry table of the
levels (``exp2`` of each code's exponent, computed once on the CPU), so the
card and the CPU decode the same codes to the same floats.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

# (octaves below the block's absmax, magnitude levels), signed m / unsigned v
_RANGES = {True: (12.0, 126.0), False: (24.0, 254.0)}
_CODE_DTYPE = {True: torch.int8, False: torch.uint8}

Schedule = Callable[[int], float]


def _level_table(signed: bool) -> torch.Tensor:
    """Decoded value of every code byte, indexed by the byte as uint8:
    ``sign(c) exp2((|c| - 1) r / levels - r)``, 0 for code 0."""
    r, levels = _RANGES[signed]
    c = torch.arange(256, dtype=torch.int32)
    if signed:
        c = torch.where(c >= 128, c - 256, c)
    c = c.to(torch.float32)
    mag = torch.where(c.abs() > 0, torch.exp2((c.abs() - 1.0) * (r / levels) - r), 0.0)
    return torch.sign(c) * mag if signed else mag


_TABLES: Dict[Tuple[bool, torch.device], torch.Tensor] = {}


def _table(signed: bool, device: torch.device) -> torch.Tensor:
    key = (signed, device)
    if key not in _TABLES:
        _TABLES[key] = _level_table(signed).to(device)
    return _TABLES[key]


def encode(x: torch.Tensor, block: int, signed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> (codes (n_blocks, block) int8 or uint8, absmax (n_blocks,)
    float32); the tail of the last block is padded with zeros."""
    flat = x.reshape(-1).to(torch.float32)
    flat = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    mag = flat.abs()
    absmax = mag.amax(dim=1)
    nonzero = absmax > 0
    inv = torch.where(nonzero, torch.reciprocal(torch.where(nonzero, absmax, 1.0)), 0.0)
    xn = mag * inv[:, None]
    r, levels = _RANGES[signed]
    # log2 of the normalized magnitude, floored at -r: a value below the
    # floor keeps code 1, not 0, so its decode never collapses to 0
    lg = torch.clamp(torch.log2(torch.clamp(xn, min=2.0 ** (-r - 1))), -r, 0.0)
    code = torch.round(1.0 + (lg + r) * (levels / r))
    code = torch.where(xn > 0, code, 0.0)
    if signed:
        code = torch.sign(flat) * code
    return code.to(_CODE_DTYPE[signed]), absmax


def decode(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`encode`, as float32 of ``shape``."""
    signed = codes.dtype == torch.int8
    index = codes.view(torch.uint8).reshape(-1).to(torch.int32)
    levels = torch.index_select(_table(signed, codes.device), 0, index)
    flat = levels.reshape(codes.shape) * scale[:, None]
    n = int(np.prod(shape, dtype=np.int64))
    return flat.reshape(-1)[:n].reshape(shape)


class QuantizedAdam(torch.optim.Optimizer):
    """Adam with block-quantized 8-bit moments (module docstring).

    ``block``: elements per scale block. ``min_quantized_size``: parameters
    with fewer elements keep float32 moments."""

    def __init__(self, params: Iterable, lr: Union[float, Schedule] = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, block: int = 256,
                 min_quantized_size: int = 2 * 256):
        self.schedule = lr if callable(lr) else None
        defaults = dict(lr=float(lr(0) if callable(lr) else lr), b1=b1, b2=b2, eps=eps,
                        block=block, min_quantized_size=min_quantized_size, count=0)
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = self._zeros(p, group)

    @staticmethod
    def _zeros(p: torch.Tensor, group) -> dict:
        if p.numel() < group["min_quantized_size"]:
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return {"mu": zeros, "nu": zeros.clone()}
        nb = -(-p.numel() // group["block"])
        out = {}
        for name, signed in (("mu", True), ("nu", False)):
            out[f"{name}_codes"] = torch.zeros((nb, group["block"]), dtype=_CODE_DTYPE[signed],
                                               device=p.device)
            out[f"{name}_scale"] = torch.zeros((nb,), dtype=torch.float32, device=p.device)
        return out

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        # the base class casts every state tensor to its parameter's float dtype
        for st in self.state.values():
            for name, signed in (("mu", True), ("nu", False)):
                if f"{name}_codes" in st:
                    st[f"{name}_codes"] = st[f"{name}_codes"].to(_CODE_DTYPE[signed])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            count = group["count"]
            lr = self.schedule(count) if self.schedule is not None else group["lr"]
            group["lr"] = lr
            count += 1
            b1, b2 = np.float32(group["b1"]), np.float32(group["b2"])
            # float32 bias corrections, as the JAX package's (scalar powf)
            bc = (np.float32(1.0) - b1 ** np.float32(count),
                  np.float32(1.0) - b2 ** np.float32(count))
            bc_on = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._zeros(p, group))
                if p.device not in bc_on:
                    # device tensors: a CPU scalar divisor becomes a
                    # multiply by its reciprocal on the card
                    bc_on[p.device] = torch.tensor(bc, dtype=torch.float32,
                                                   device=p.device).unbind()
                p.add_(self._update(p, st, group, lr, *bc_on[p.device]))
            group["count"] = count
        return loss

    @staticmethod
    def _update(p, st, group, lr, bc1, bc2) -> torch.Tensor:
        g = p.grad.to(torch.float32)
        b1, b2, block = group["b1"], group["b2"], group["block"]
        quantized = "mu_codes" in st
        if quantized:
            m = decode(st["mu_codes"], st["mu_scale"], g.shape)
            v = decode(st["nu_codes"], st["nu_scale"], g.shape)
        else:
            m, v = st["mu"], st["nu"]
        m = m * b1 + g * (1.0 - b1)
        v = v * b2 + g * (1.0 - b2) * g
        step = (m / bc1) * -lr / (torch.sqrt(v / bc2) + group["eps"])
        if quantized:
            st["mu_codes"], st["mu_scale"] = encode(m, block, True)
            st["nu_codes"], st["nu_scale"] = encode(v, block, False)
        else:
            st["mu"], st["nu"] = m, v
        return step.to(p.dtype)


def optimizer_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes held by the optimizer's state tensors, plus 4 for each group's
    int32 count (the JAX package's count; ``torch.optim.Adam`` keeps a
    ``step`` tensor per parameter instead, counted with its state)."""
    n = sum(t.numel() * t.element_size() for st in optimizer.state.values()
            for t in st.values() if isinstance(t, torch.Tensor))
    return n + 4 * sum("count" in g for g in optimizer.param_groups)
