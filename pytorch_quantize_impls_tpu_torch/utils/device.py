"""Where the port's entry points run.

Every entry point that places weights, caches or inputs (``build_model``,
``load_flax_variables``, ``load_packed``, ``InferenceEngine``,
``export_fused_decode``, ``fused_init_cache``, ``generate``,
``DecodeEngine``) takes ``device`` and defaults to ``"cuda"``. Running on
the CPU takes an explicit ``device="cpu"``: without a GPU the default
raises rather than falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` (``"cuda"`` becomes the current CUDA
    device, with its index); raise if it names CUDA and there is no CUDA
    device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
