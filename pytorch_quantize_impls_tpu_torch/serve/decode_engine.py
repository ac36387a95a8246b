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
fused step with the ``decode_attention`` kernel; it refuses MoE). The
cache is updated in place by every call (see ``models.transformer``).

Over a ``(data, model)`` mesh (``mesh=``, ``parallel.make_mesh``; exclusive
with ``fused``) the engine runs one process per device, as the JAX engine's
``shard_map`` runs one body per device. The slots are sharded over
``"data"``: data rank ``d`` of ``D`` owns slots ``[d S/D, (d + 1) S/D)``
of the cache and steps only them (``n_slots % D != 0`` raises). With
``packed`` records and a model axis of more than one rank, each rank steps
on its column shards of the dense records (``infer.shard_packed``, cut once
here) and every dense layer all-gathers its columns over the model group;
otherwise the model's ranks step alike on whole weights. Every rank builds
the engine; only rank 0 takes requests (``submit`` raises on another rank)
and schedules. Each tick rank 0 runs the admitted requests' batch-1
prefills with the whole model (as the JAX engine's replicated prefill) and
samples their first tokens, then broadcasts one fixed-shape int64 tensor:
the op (run, idle or stop), the admissions (slot, length, bucket), the
active mask and every slot's last token; the admitted prompts follow it.
The ranks of the owning data index then prefill each admitted prompt into
their own cache row, every rank steps its slots in the same order of
collectives, and the next tokens are gathered over the data group for rank
0, which resolves the futures. Rank 0 ticks idle when it has nothing to do
(``parallel.control`` carries the ticks for both engines). A data rank
samples with a generator seeded by (``seed``, its data index),
the counterpart of the JAX engine's ``fold_in(key, axis_index("data"))``
(a Philox draw, not threefry's). ``shutdown()`` on rank 0 stops every rank;
on another rank it waits until then. On every rank it raises what failed in
the engine's thread. As in the JAX engine, an MoE LM's step routes each
data rank's slots on their own. Every rank holds the whole packed records
for the replicated prefill, and its column shards beside them, so tensor
parallelism here saves no weight memory. An MoE LM placed by
``parallel.shard_experts`` is refused: its collectives would run in rank
0's lone prefill.
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
import torch.distributed as dist

from pytorch_quantize_impls_tpu_torch.infer.fused_decode import (
    fused_decode_apply,
    fused_init_cache,
)
from pytorch_quantize_impls_tpu_torch.infer.packed import packed_apply, shard_packed
from pytorch_quantize_impls_tpu_torch.nn.moe import QuantMoE
from pytorch_quantize_impls_tpu_torch.parallel.control import (
    IDLE,
    IDLE_TICK_S,
    RUN,
    ServingThread,
    shutdown_error,
)
from pytorch_quantize_impls_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
)
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


def _insert_row(batched, one, row: int, n: int) -> None:
    """Write the batch-1 cache ``one`` into row ``row`` of ``batched``; a
    cursor gets the prompt's true length ``n``, not the bucket."""
    for k, v in one.items():
        if isinstance(v, dict):
            _insert_row(batched[k], v, row, n)
        else:
            batched[k][row] = n if _is_cursor((k,)) else v[0]


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
    else sampled with a ``torch.Generator`` seeded with ``seed``. With
    ``mesh`` (module docstring), ``device`` is this rank's.
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
        if any(isinstance(m, QuantMoE) and m.ep is not None for m in model.modules()):
            raise ValueError("DecodeEngine serves an MoE LM with its experts whole: this one was "
                             "placed by parallel.shard_experts")
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
        # the slots this rank steps, the records it steps on, its sampler
        self._lo, self._hi = 0, n_slots
        self._step_packed, self._tp_group = packed, None
        self._step_generator = self._generator
        self._mesh = mesh
        if mesh is not None:
            self._place_on(mesh, seed)
        self._cache = self._fresh_cache()
        self._stats_lock = threading.Lock()
        self._slots: list = [None] * n_slots
        self._admitted: list = []
        self._queue: "queue.Queue[Optional[_GenRequest]]" = queue.Queue()
        self.stats = DecodeStats()
        self._running = True
        # a tick: the admissions' count, then per slot the admissions' (slot,
        # length, bucket), the active mask and the last tokens
        self._server = ServingThread(mesh, self._device, 1 + 5 * n_slots, lead=self._serve,
                                     drain=self._drain, follow=self._follow)
        self._leader = self._server.leader
        self._server.start()

    def _place_on(self, mesh, seed: int) -> None:
        if self._device.type != mesh.device_type:
            raise ValueError(f"a {mesh.device_type} mesh serves on {mesh.device_type}, "
                             f"not {self._device}")
        n_data, d = axis_size(mesh, DATA_AXIS), mesh.get_local_rank(DATA_AXIS)
        if self._n_slots % n_data:
            raise ValueError(
                f"n_slots ({self._n_slots}) must divide over the data axis ({n_data})")
        per = self._n_slots // n_data
        self._lo, self._hi = d * per, (d + 1) * per
        self._data_group = mesh.get_group(DATA_AXIS)
        if self._packed is not None and axis_size(mesh, MODEL_AXIS) > 1:
            self._step_packed = shard_packed(self._packed, mesh, MODEL_AXIS)
            self._tp_group = mesh.get_group(MODEL_AXIS)
        data_seed = int(np.random.SeedSequence([seed, d]).generate_state(1)[0])
        self._step_generator = torch.Generator(device=self._device).manual_seed(data_seed)

    # -- client API ---------------------------------------------------------

    def submit(self, prompt, max_new: int, eos: Optional[int] = None) -> Future:
        """Enqueue a prompt (1-D int tokens); the Future resolves to the 1-D
        int32 array of generated tokens (stopping early at ``eos``, which is
        included)."""
        if not self._leader:
            raise RuntimeError("only rank 0 of the mesh takes requests")
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

    def shutdown(self, timeout: Optional[float] = 30) -> None:
        """Stop serving. Over a mesh, rank 0 stops every rank; another rank
        waits (up to ``timeout`` seconds, None for no limit) until rank 0
        has. On every rank, raises what failed in the engine's thread, if
        anything."""
        if self._leader:
            self._running = False
            self._queue.put(None)
        self._server.join(timeout)

    # -- internals ----------------------------------------------------------

    def _apply(self, cache, toks):
        if self._fused is not None:
            return fused_decode_apply(self._fused, cache, toks)
        if self._packed is not None:
            return packed_apply(self._md, self._packed, toks, cache)
        return self._md(toks, cache)

    def _fresh_cache(self):
        """Batched cache of this rank's slots, every cursor at 0."""
        if self._fused is not None:
            return fused_init_cache(self._fused, self._n_slots, device=self._device)
        return self._md.init_cache(self._hi - self._lo, device=self._device)

    def _prefill(self, toks: torch.Tensor):
        """Batch-1 prefill from a fresh cache: (logits of the row, cache)."""
        logits, cache1 = self._apply(None, toks)
        return logits[0], cache1

    def _step(self, toks: torch.Tensor, active: torch.Tensor):
        """One token for every slot of this rank. Idle slots run the dummy
        token like the others (one shape), with their cursors pinned to 0
        after."""
        if self._tp_group is None:
            logits, cache = self._apply(self._cache, toks[:, None])
        else:
            logits, cache = packed_apply(self._md, self._step_packed, toks[:, None], self._cache,
                                         tp_group=self._tp_group)
        nxt = _sample(logits[:, 0], self._temperature, self._step_generator)
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
        logits = self._prefill_into(slot_idx, n, toks)
        first = int(_sample(logits[n - 1][None], self._temperature, self._generator)[0])
        if self._mesh is not None:
            self._admitted.append((slot_idx, n, toks))
        slot = _Slot(request=req, last_token=first)
        self._slots[slot_idx] = slot
        self._emit(slot, first)

    def _prefill_into(self, slot_idx: int, n: int, toks: np.ndarray) -> torch.Tensor:
        """Prefill the (1, bucket) prompt ``toks`` of true length ``n`` and
        write its cache into the slot's row where this rank owns the slot;
        returns the row's logits."""
        logits, cache1 = self._prefill(torch.from_numpy(toks).to(self._device))
        if self._lo <= slot_idx < self._hi:
            _insert_row(self._cache, cache1, slot_idx - self._lo, n)
        return logits

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

    def _drain(self, error: Optional[BaseException]) -> None:
        """Fail anything still in flight or queued, with what stopped the
        engine as the cause."""
        for s in self._slots:
            if s is not None and not s.request.future.done():
                s.request.future.set_exception(shutdown_error(error))
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(shutdown_error(error))

    @torch.no_grad()
    def _serve(self) -> None:
        while self._running:
            # admit whatever is waiting into free slots
            while None in self._slots:
                block = all(s is None for s in self._slots)
                try:
                    req = self._queue.get(block=block, timeout=IDLE_TICK_S if block else None)
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
            if self._running:
                self._tell(RUN if active or self._admitted else IDLE)
            if not active or not self._running:
                continue
            toks = torch.tensor(
                [s.last_token if s is not None else 0 for s in self._slots],
                dtype=torch.int32, device=self._device,
            )
            mask = torch.tensor([s is not None for s in self._slots], device=self._device)
            if self._mesh is None:
                nxt = self._step(toks, mask).tolist()
            else:
                nxt = self._step_gather(toks, mask).tolist()
            with self._stats_lock:
                self.stats.steps += 1
                self.stats.slot_occupancy += len(active) / self._n_slots
            for i, s in enumerate(list(self._slots)):
                if s is not None:
                    s.last_token = nxt[i]
                    self._emit(s, nxt[i])

    # -- over a mesh ----------------------------------------------------------

    def _tell(self, op: int) -> None:
        """Rank 0: broadcast this tick's decisions (the admissions made
        since the last tick, the active mask, every slot's last token), then
        the admitted prompts. Nothing without a mesh."""
        if self._mesh is None:
            return
        s = self._n_slots
        admitted = self._admitted if op == RUN else []
        self._admitted = []
        fields = np.zeros(1 + 5 * s, np.int64)
        fields[0] = len(admitted)
        for i, (slot, n, toks) in enumerate(admitted):
            fields[1 + i], fields[1 + s + i], fields[1 + 2 * s + i] = slot, n, toks.shape[1]
        for i, slot in enumerate(self._slots):
            if slot is not None:
                fields[1 + 3 * s + i], fields[1 + 4 * s + i] = 1, slot.last_token
        self._server.tell(op, fields)
        if admitted:
            prompts = np.concatenate([toks[0] for _, _, toks in admitted])
            self._server.broadcast(torch.from_numpy(prompts).to(self._device))

    def _step_gather(self, toks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """Every rank: step this rank's slots, then gather every data rank's
        next tokens (rank 0's result is every slot's)."""
        mine = self._step(toks[self._lo:self._hi], active[self._lo:self._hi]).contiguous()
        every = mine.new_empty(self._n_slots)
        dist.all_gather_into_tensor(every, mine, group=self._data_group)
        return every

    @torch.no_grad()
    def _follow(self, op: int, fields: np.ndarray) -> None:
        """A rank other than 0: this tick's part of what rank 0 decided
        (``fields`` as :meth:`_tell` lays them out)."""
        s, n_admit = self._n_slots, int(fields[0])
        slots = fields[1:1 + n_admit]
        lens = fields[1 + s:1 + s + n_admit]
        buckets = fields[1 + 2 * s:1 + 2 * s + n_admit]
        if n_admit:
            prompts = torch.zeros(int(buckets.sum()), dtype=torch.int32, device=self._device)
            prompts = self._server.broadcast(prompts).cpu().numpy()
            start = 0
            for slot, n, b in zip(slots.tolist(), lens.tolist(), buckets.tolist()):
                if self._lo <= slot < self._hi:
                    self._prefill_into(slot, n, prompts[None, start:start + b])
                start += b
        active = fields[1 + 3 * s:1 + 4 * s]
        if active.any():
            self._step_gather(
                torch.from_numpy(fields[1 + 4 * s:].astype(np.int32)).to(self._device),
                torch.from_numpy(active.astype(bool)).to(self._device))
