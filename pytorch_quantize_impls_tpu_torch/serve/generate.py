"""Autoregressive generation over the quantized-KV decode path.

Counterpart of ``pytorch_quantize_impls_tpu/serve/generate.py``: one
full-prompt forward (prefill) fills the cache, then single-token decode
steps follow. ``lax.scan`` becomes a Python loop, and ``jax.random`` keys
become a ``torch.Generator`` that the caller seeds. Greedy decoding
(``temperature == 0``) gives the JAX package's tokens; sampled decoding is
deterministic under its generator's seed but draws other numbers than JAX.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import numpy as np
import torch

from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device


def _sample(
    logits: torch.Tensor, temperature: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """(b, vocab) logits -> (b,) int32 tokens: argmax when ``temperature``
    is 0 (ties go to the lowest index, as ``jnp.argmax``), else a draw from
    ``softmax(logits / temperature)`` with ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def decode_model(model):
    """The decode-mode twin of a ``QuantTransformerLM``: a shallow copy that
    shares every parameter and submodule, takes ``(tokens, cache)`` and is in
    eval mode (``infer.packed_apply`` reads that flag)."""
    twin = copy.copy(model)
    twin.decode = True
    twin.training = False
    return twin


@torch.no_grad()
def prefill(model, prompt: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Run the whole prompt through the decode-mode ``model`` in one
    forward. Returns ``(last_logits, cache)``, the cache filled for
    positions ``[0, prompt_len)``."""
    if prompt.shape[1] > model.max_len:
        raise ValueError(
            f"prompt length {prompt.shape[1]} exceeds cache capacity max_len ({model.max_len})"
        )
    logits, cache = model(prompt)
    return logits[:, -1], cache


def _require_on(device: torch.device, module: torch.nn.Module) -> None:
    p = next(module.parameters())
    if p.device != device:
        raise ValueError(f"model is on {p.device}, expected {device}: move it first")


@torch.no_grad()
def generate(
    model,
    prompt,
    n_new: int,
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """Generate ``n_new`` tokens after ``prompt`` (b, prompt_len) with the
    train-mode ``QuantTransformerLM`` ``model`` (its decode twin is derived
    here), on ``device`` (the card unless ``device="cpu"``; raises without a
    GPU). The model must already be on ``device``. Greedy by default; with
    ``temperature > 0`` it samples with ``generator`` (seeded 0 on
    ``device`` when not given). Returns (b, n_new) int32 tokens."""
    device = resolve_device(device)
    _require_on(device, model)
    prompt = torch.as_tensor(np.asarray(prompt), device=device)
    if prompt.shape[1] + n_new > model.max_len:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + n_new ({n_new}) exceeds the model's "
            f"cache capacity max_len ({model.max_len})"
        )
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    md = decode_model(model)
    last, cache = prefill(md, prompt)
    tok = _sample(last, temperature, generator)
    out = [tok]
    for _ in range(n_new - 1):
        logits, cache = md(tok[:, None], cache)
        tok = _sample(logits[:, -1], temperature, generator)
        out.append(tok)
    return torch.stack(out, dim=1)
