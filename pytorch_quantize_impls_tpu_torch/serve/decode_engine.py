"""Slot-based continuous batching for autoregressive decode.

Counterpart of ``pytorch_quantize_impls_tpu/serve/decode_engine.py``. Each
request owns a slot, one row of a batched int8-quantized KV cache; every
engine tick runs ONE single-token step over all slots, and new requests join
mid-flight through a batch-1 prefill inserted into their slot's row, so
short requests never wait for long ones. Prompts are padded to buckets
(powers of two past the configured ones), as in the JAX engine. Idle slots
step a dummy token with their cursors pinned to 0; admitting a request
rewrites the whole row. With an MoE LM (``n_experts > 0``) the slots are not
independent, as in the JAX engine: each step routes every slot's token
together, the idle slots' dummy tokens included, and lower slots take the
experts' capacity first; a bucketed prefill routes its pad tokens too. So an
answer depends on the requests served beside it.

Backends: the fake-quant decode model (default), ``packed=`` records from
``infer.pack_model`` run through ``infer.packed_apply`` (binary, dorefa, log
or lin), or ``fused=`` a program from ``infer.export_fused_decode`` (the
fused step with the ``decode_attention`` kernel; it refuses MoE). A mesh
(``mesh=``) waits for ROADMAP queue 1 item 6. The cache is updated in place
by every call (see ``models.transformer``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from pytorch_quantize_impls_tpu_torch.infer.fused_decode import (
    fused_decode_apply,
    fused_init_cache,
)
from pytorch_quantize_impls_tpu_torch.infer.packed import packed_apply
from pytorch_quantize_impls_tpu_torch.serve.generate import _require_on, _sample, decode_model
from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device


def _next_bucket(n: int, buckets: Sequence[int], max_len: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    # past every configured bucket but within the cache: the next power of
    # two, capped at max_len
    b = 1
    while b < n:
        b *= 2
    return min(b, max_len)


def _map_leaves(fn, tree, path=()):
    """Rebuild the dict ``tree`` with ``fn(path, leaf)`` at every leaf."""
    return {
        k: _map_leaves(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
        for k, v in tree.items()
    }


def _is_cursor(path) -> bool:
    return "index" in path[-1]


@dataclass
class DecodeStats:
    requests: int = 0
    steps: int = 0
    tokens: int = 0
    slot_occupancy: float = 0.0  # summed active fraction over steps

    @property
    def mean_occupancy(self) -> float:
        return self.slot_occupancy / self.steps if self.steps else 0.0


# eq=False: requests and slots are found by identity (``list.index``); a
# field-wise == would compare the numpy prompts and raise
@dataclass(eq=False)
class _GenRequest:
    prompt: np.ndarray
    max_new: int
    eos: Optional[int]
    future: Future
    t_submit: float = field(default_factory=time.perf_counter)


@dataclass(eq=False)
class _Slot:
    request: _GenRequest
    generated: list = field(default_factory=list)
    last_token: int = 0


class DecodeEngine:
    """Continuous-batching generation server over a quantized-KV cache.

    ``model`` is a ``QuantTransformerLM`` (its decode twin is derived here);
    ``n_slots`` bounds concurrent sequences, each slot's cache row holding
    ``model.max_len`` positions per layer. Everything runs on ``device``
    (the card unless ``device="cpu"``; raises without a GPU), where the
    weights the backend uses must already be: the model's, the ``packed``
    records', or the ``fused`` program's. Greedy when ``temperature == 0``,
    else sampled with a ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(
        self,
        model,
        *,
        packed=None,
        fused=None,
        n_slots: int = 8,
        prompt_buckets: Sequence[int] = (16, 32, 64, 128),
        temperature: float = 0.0,
        seed: int = 0,
        mesh=None,
        device="cuda",
    ):
        if fused is not None and (packed is not None or mesh is not None):
            raise ValueError("fused backend is exclusive with packed/mesh")
        if mesh is not None:
            raise NotImplementedError(
                "serving over a mesh is not ported yet (ROADMAP queue 1, item 6)"
            )
        self._device = resolve_device(device)
        self._md = decode_model(model)
        self._fused = fused
        self._packed = packed
        if fused is not None:
            if fused.device != self._device:
                raise ValueError(f"fused program is on {fused.device}, expected {self._device}")
        else:
            _require_on(self._device, model)
            for path, rec in (packed or {}).items():
                if rec.packed.device != self._device:
                    raise ValueError(f"packed record {path} is on {rec.packed.device}")
        self._n_slots = n_slots
        self._max_len = model.max_len
        self._buckets = sorted(b for b in prompt_buckets if b <= self._max_len)
        if not self._buckets:
            raise ValueError("no prompt bucket fits the model's max_len")
        self._temperature = temperature
        self._generator = torch.Generator(device=self._device).manual_seed(seed)
        self._cache = self._fresh_cache()
        self._stats_lock = threading.Lock()
        self._slots: list = [None] * n_slots
        self._queue: "queue.Queue[Optional[_GenRequest]]" = queue.Queue()
        self.stats = DecodeStats()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API ---------------------------------------------------------

    def submit(self, prompt, max_new: int, eos: Optional[int] = None) -> Future:
        """Enqueue a prompt (1-D int tokens); the Future resolves to the 1-D
        int32 array of generated tokens (stopping early at ``eos``, which is
        included)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if prompt.size + max_new > self._max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds the "
                f"cache capacity ({self._max_len})"
            )
        req = _GenRequest(prompt=prompt, max_new=max_new, eos=eos, future=Future())
        self._queue.put(req)
        return req.future

    def __call__(self, prompt, max_new: int, eos: Optional[int] = None):
        return self.submit(prompt, max_new, eos).result()

    def shutdown(self) -> None:
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=30)

    # -- internals ----------------------------------------------------------

    def _apply(self, cache, toks):
        if self._fused is not None:
            return fused_decode_apply(self._fused, cache, toks)
        if self._packed is not None:
            return packed_apply(self._md, self._packed, toks, cache)
        return self._md(toks, cache)

    def _fresh_cache(self):
        """Batched (n_slots) cache, every cursor at 0."""
        if self._fused is not None:
            return fused_init_cache(self._fused, self._n_slots, device=self._device)
        return self._md.init_cache(self._n_slots, device=self._device)

    def _prefill(self, toks: torch.Tensor):
        """Batch-1 prefill from a fresh cache: (logits of the row, cache)."""
        logits, cache1 = self._apply(None, toks)
        return logits[0], cache1

    def _step(self, toks: torch.Tensor, active: torch.Tensor):
        """One token for every slot. Idle slots run the dummy token like the
        others (one shape), with their cursors pinned to 0 after."""
        logits, cache = self._apply(self._cache, toks[:, None])
        nxt = _sample(logits[:, 0], self._temperature, self._generator)
        self._cache = _map_leaves(
            lambda p, leaf: torch.where(active, leaf, 0) if _is_cursor(p) else leaf, cache
        )
        return nxt

    def _admit(self, req: _GenRequest, slot_idx: int) -> None:
        """Bucketed batch-1 prefill, inserted into the slot's cache row."""
        n = int(req.prompt.size)
        bucket = _next_bucket(n, self._buckets, self._max_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = req.prompt
        logits, cache1 = self._prefill(torch.from_numpy(toks).to(self._device))
        first = int(_sample(logits[n - 1][None], self._temperature, self._generator)[0])

        def insert(batched, one):
            for k, v in one.items():
                if isinstance(v, dict):
                    insert(batched[k], v)
                else:  # a cursor gets the true length, not the bucket
                    batched[k][slot_idx] = n if _is_cursor((k,)) else v[0]

        insert(self._cache, cache1)
        slot = _Slot(request=req, last_token=first)
        self._slots[slot_idx] = slot
        self._emit(slot, first)

    def _emit(self, slot: _Slot, token: int) -> None:
        slot.generated.append(token)
        req = slot.request
        done = len(slot.generated) >= req.max_new or (req.eos is not None and token == req.eos)
        if done:
            req.future.set_result(np.asarray(slot.generated, np.int32))
            self._slots[self._slots.index(slot)] = None
            with self._stats_lock:
                self.stats.requests += 1
                self.stats.tokens += len(slot.generated)

    def _loop(self) -> None:
        with torch.no_grad():
            self._serve()
        # drain: fail anything still in flight or queued
        for s in self._slots:
            if s is not None and not s.request.future.done():
                s.request.future.set_exception(RuntimeError("engine shutdown"))
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("engine shutdown"))

    def _serve(self) -> None:
        while self._running:
            # admit whatever is waiting into free slots
            while None in self._slots:
                block = all(s is None for s in self._slots)
                try:
                    req = self._queue.get(block=block, timeout=0.1 if block else None)
                except queue.Empty:
                    break
                if req is None:
                    self._running = False
                    break
                try:
                    self._admit(req, self._slots.index(None))
                except Exception as e:  # deliver failures, keep serving
                    req.future.set_exception(e)
            active = [s for s in self._slots if s is not None]
            if not active or not self._running:
                continue
            toks = torch.tensor(
                [s.last_token if s is not None else 0 for s in self._slots],
                dtype=torch.int32, device=self._device,
            )
            mask = torch.tensor([s is not None for s in self._slots], device=self._device)
            nxt = self._step(toks, mask).tolist()
            with self._stats_lock:
                self.stats.steps += 1
                self.stats.slot_occupancy += len(active) / self._n_slots
            for i, s in enumerate(list(self._slots)):
                if s is not None:
                    s.last_token = nxt[i]
                    self._emit(s, nxt[i])

