"""Carry the JAX package's model variables onto the port's modules.

The JAX package keeps a model's state in flax ``variables``: nested dicts
``{"params": {...}, "batch_stats": {...}}`` keyed by module name. Given those
as nested dicts of numpy arrays, :func:`load_flax_variables` fills the
port's module of the same architecture:

* Dense ``kernel (in, out)`` -> ``weight (out, in)``;
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* ``bias`` -> ``bias``;
* BatchNorm and LayerNorm ``scale``/``bias`` -> ``weight``/``bias``, and
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* Embed ``embedding (vocab, d)`` -> ``weight (vocab, d)``, not transposed;
* a parameter the model declares itself (the LM's ``pos_embed``) keeps its
  name and layout, and so do PACT's scalar ``alpha``, the binary layers'
  learnable activation scale ``act_scale`` (``("fc1", "act_scale")`` ->
  ``"fc1.act_scale"``) and the MoE's ``router (d, E)``, ``wi_kernel (E, d,
  f)`` and ``wo_kernel (E, f, d)`` (stacked on the expert axis, not
  transposed: ``("block0", "moe", "wi_kernel")`` -> ``"block0.moe.wi_kernel"``);
* the ``losses`` collection is dropped: it holds what layers sow for the
  training loss (PACT's alpha penalty), which ``model.init`` returns beside
  the state. Any other collection raises.

A flax path ``("fc1", "dense", "kernel")`` becomes the state-dict key
``"fc1.dense.weight"``. Loading is strict: a missing or extra entry raises.

:func:`flax_variables` goes the other way: a module's state as flax-layout
numpy ``{"params": ..., "batch_stats": ...}``, which the JAX package's
``apply``, ``pack_model`` and training steps take. :func:`flax_paths` names
each state-dict entry's flax collection and path: a 1-D ``weight`` is a
norm layer's ``scale``, an ``nn.Embedding``'s its ``embedding``, any other
``weight`` a ``kernel`` (``train.clipping`` selects by these paths: the
MoE's ``wi_kernel`` and ``wo_kernel`` are clamped, its ``router`` is not).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device

# parameters that keep their flax name and layout
_SAME_NAMES = ("alpha", "act_scale", "router", "wi_kernel", "wo_kernel")
_PARAM_NAMES = {
    "kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight",
    **{name: name for name in _SAME_NAMES},
}
# collections that hold no state of the model
_DROPPED = {"losses"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _to_torch_layout(name: str, value: np.ndarray) -> np.ndarray:
    if name != "kernel":
        return value
    if value.ndim == 2:  # (in, out) -> (out, in)
        return value.T
    if value.ndim == 4:  # HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    raise ValueError(f"kernel of rank {value.ndim} has no port layout")


def flax_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``variables`` (numpy leaves) -> a PyTorch state dict on the CPU."""
    sd: Dict[str, torch.Tensor] = {}
    for collection, names in (("params", _PARAM_NAMES), ("batch_stats", _STAT_NAMES)):
        for path, value in _leaves(variables.get(collection, {})):
            leaf = path[-1]
            if collection == "params" and len(path) == 1:
                key = leaf  # the model's own parameter, e.g. pos_embed
            elif leaf in names:
                key = ".".join(path[:-1] + (names[leaf],))
            else:
                raise ValueError(f"{collection} leaf {'/'.join(path)} has no port counterpart")
            # np.array, not np.ascontiguousarray: that makes a scalar 1-D
            arr = np.array(_to_torch_layout(leaf, value), dtype=np.float32, order="C")
            sd[key] = torch.from_numpy(arr)
    extra = set(variables) - {"params", "batch_stats"} - _DROPPED
    if extra:
        raise ValueError(f"variable collections {sorted(extra)} have no port counterpart")
    return sd


def flax_paths(module: nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """State-dict key -> (flax collection, flax path) for every entry of
    ``module.state_dict()``."""
    stats = {v: k for k, v in _STAT_NAMES.items()}
    out = {}
    for key, value in module.state_dict().items():
        *prefix, leaf = key.split(".")
        if leaf in stats:
            out[key] = ("batch_stats", (*prefix, stats[leaf]))
            continue
        if leaf == "weight":
            sub = module.get_submodule(".".join(prefix))
            if value.ndim == 1:
                leaf = "scale"
            elif isinstance(sub, nn.Embedding):
                leaf = "embedding"
            else:
                leaf = "kernel"
        elif prefix and leaf != "bias" and leaf not in _SAME_NAMES:
            raise ValueError(f"state entry {key} has no flax counterpart")
        out[key] = ("params", (*prefix, leaf))
    return out


def _to_flax_layout(name: str, value: np.ndarray) -> np.ndarray:
    if name != "kernel":
        return value
    if value.ndim == 2:  # (out, in) -> (in, out)
        return value.T
    if value.ndim == 4:  # OIHW -> HWIO
        return value.transpose(2, 3, 1, 0)
    raise ValueError(f"kernel of rank {value.ndim} has no flax layout")


def flax_variables(module: nn.Module) -> Dict[str, Any]:
    """``module``'s parameters and running statistics as flax ``variables``
    (nested dicts of float32 numpy arrays in flax's layouts); the inverse of
    :func:`flax_state_dict`."""
    sd = module.state_dict()
    out: Dict[str, Any] = {}
    for key, (collection, path) in flax_paths(module).items():
        node = out.setdefault(collection, {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        value = sd[key].detach().to("cpu", torch.float32).numpy()
        node[path[-1]] = np.array(_to_flax_layout(path[-1], value), order="C")
    return out


def load_flax_variables(
    module: nn.Module, variables: Mapping[str, Any], device="cuda"
) -> nn.Module:
    """Copy flax ``variables`` into ``module`` (strict) and move it to
    ``device`` (the card unless ``device="cpu"``; raises without a GPU).
    Returns ``module``."""
    device = resolve_device(device)
    module.load_state_dict(flax_state_dict(variables), strict=True)
    return module.to(device)
