"""Clamp-after-step: the master weights clipped into the quantizer's domain.

Counterpart of ``pytorch_quantize_impls_tpu/train/clipping.py``. After every
``optimizer.step()`` the master kernels go back into [-bound, bound]
(load-bearing for BinaryConnect accuracy, paper §2.3). The JAX package
rewrites the optimizer's update ``u`` as ``clip(p + u, -b, b) - p`` and adds
it to ``p``; :class:`ClampAfterStep` lands where that does: with ``p0``
the value before the step and ``p`` after it, ``p0 + (clip(p, -b, b) - p0)``
(which can sit an ulp inside +-b, as JAX's does).

What is clipped is chosen as in the JAX package, by flax path
(``utils.bridge.flax_paths``, as ``"['fc1']['dense']['kernel']"``): by
default every Dense and Conv ``kernel``, the float32 twin's too, and never a
BatchNorm ``scale``, although both are ``weight`` in PyTorch.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.utils.bridge import flax_paths

PathFilter = Callable[[str], Optional[float]]


def keystr(path: Tuple[str, ...]) -> str:
    """A flax path as ``jax.tree_util.keystr`` prints it: ``['a']['b']``."""
    return "".join(f"['{k}']" for k in path)


def default_clip_filter(bound: float = 1.0) -> PathFilter:
    """Clip every ``kernel`` to ``[-bound, bound]``; leave biases, BatchNorm
    and other parameters alone."""
    return lambda path: bound if "kernel" in path else None


def _clipped(model: nn.Module, path_filter: Optional[PathFilter]) -> List[Tuple[nn.Parameter, float]]:
    pf = path_filter or default_clip_filter()
    params = dict(model.named_parameters())
    out = []
    for key, (collection, path) in flax_paths(model).items():
        bound = pf(keystr(path)) if collection == "params" else None
        if bound is not None:
            out.append((params[key], bound))
    return out


class ClampAfterStep:
    """Runs ``optimizer.step()`` and clamps the selected parameters after it,
    in the JAX package's arithmetic (module docstring)."""

    def __init__(self, model: nn.Module, path_filter: Optional[PathFilter] = None):
        self.params = _clipped(model, path_filter)

    @torch.no_grad()
    def step(self, optimizer: torch.optim.Optimizer) -> None:
        before = [p.clone() for p, _ in self.params]
        optimizer.step()
        for (p, bound), p0 in zip(self.params, before):
            p.copy_(p0 + (p.clamp(-bound, bound) - p0))


def clip_quantized_weights(model: nn.Module,
                           path_filter: Optional[PathFilter] = None) -> ClampAfterStep:
    """The clamp after each step for ``model``; ``path_filter`` maps a flax
    path string to a bound or None (default: every kernel to [-1, 1])."""
    return ClampAfterStep(model, path_filter)


@torch.no_grad()
def clip_params(model: nn.Module, path_filter: Optional[PathFilter] = None) -> nn.Module:
    """One-shot clamp of the selected parameters in place (e.g. after a
    load). Returns ``model``."""
    for p, bound in _clipped(model, path_filter):
        p.clamp_(-bound, bound)
    return model
