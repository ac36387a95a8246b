"""Continuous-batching engine over the packed forward path.

Counterpart of ``pytorch_quantize_impls_tpu/serve/engine.py``. Requests
(single examples) stream in from many client threads; a dispatch thread
assembles them into padded buckets (powers of two by default) and runs ONE
forward per bucket, so the device always sees a handful of fixed batch shapes
and large batches. A deadline (``max_delay_ms``) bounds latency when traffic
is sparse.

The forward runs under ``torch.inference_mode()`` on the engine's device.
``from_fused_chain`` serves a fused binary chain (the XNOR convnet, BNN
LeNet), ``from_fused_resnet`` a fused DoReFa ResNet.

Over a ``(data, model)`` mesh (``mesh=``, ``parallel.make_mesh``) the engine
serves data-parallel, one process per device. Every rank builds the engine
with the same forward; only rank 0 takes requests (``submit`` raises on
another rank) and assembles the buckets. For each bucket rank 0 broadcasts
the tick ``(op, bucket size)`` (``parallel.control``, which also ticks idle
when there is nothing to run), then scatters the bucket's rows: data rank
``d`` gets block ``d`` of the ``D`` equal blocks, which each of its model
ranks computes alike; the outputs are gathered over the data group and rank
0 answers. ``shutdown()`` on rank 0 stops every rank; on another rank it
waits for that. On every rank it raises what failed in the engine's thread.
A bucket size that does not divide over the data axis raises
``ValueError`` when the engine is built.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pytorch_quantize_impls_tpu_torch.parallel.control import (
    IDLE,
    IDLE_TICK_S,
    RUN,
    ServingThread,
    shutdown_error,
)
from pytorch_quantize_impls_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device


@dataclass
class EngineStats:
    requests: int = 0
    batches: int = 0
    padded_examples: int = 0
    total_latency_s: float = 0.0

    @property
    def mean_batch_size(self) -> float:
        return self.requests / self.batches if self.batches else 0.0

    @property
    def mean_latency_ms(self) -> float:
        return 1e3 * self.total_latency_s / self.requests if self.requests else 0.0


@dataclass
class _Request:
    x: np.ndarray
    future: Future
    t_submit: float = field(default_factory=time.perf_counter)


@dataclass
class _Warmup:
    done: Future


class InferenceEngine:
    """Continuous-batching server around a ``forward(x) -> y`` function.

    ``forward`` is typically ``lambda x: infer.packed_apply(model, prepared,
    x)``. It receives a ``(bucket, *example_shape)`` tensor of ``dtype`` on
    ``device`` and returns a tensor whose first axis is the batch. Answers
    are numpy rows; a bf16 output (a model with ``dtype=torch.bfloat16``)
    comes back widened to float32, which holds it exactly (numpy has no
    bf16). With ``mesh``, ``forward`` gets this data rank's rows of each
    bucket (module docstring) on ``device``, the rank's own.
    """

    def __init__(
        self,
        forward: Callable[[torch.Tensor], torch.Tensor],
        example_shape: Tuple[int, ...],
        *,
        batch_sizes: Sequence[int] = (1, 4, 16, 64, 256),
        max_delay_ms: float = 2.0,
        mesh=None,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        self._device = resolve_device(device)
        self._forward = forward
        self._example_shape = tuple(example_shape)
        self._buckets = sorted(batch_sizes)
        self._max_delay_s = max_delay_ms / 1e3
        self._dtype = dtype
        self._mesh = mesh
        if mesh is not None:
            if self._device.type != mesh.device_type:
                raise ValueError(f"a {mesh.device_type} mesh serves on {mesh.device_type}, "
                                 f"not {self._device}")
            self._n_data = axis_size(mesh, DATA_AXIS)
            bad = [b for b in self._buckets if b % self._n_data]
            if bad:
                raise ValueError(f"batch sizes {bad} do not divide over the data axis "
                                 f"({self._n_data})")
            self._data_group = mesh.get_group(DATA_AXIS)
            # the data index of every global rank: where it sits in the mesh
            self._data_of = {int(r): d for d, row in enumerate(mesh.mesh.tolist())
                             for r in (row if isinstance(row, list) else [row])}
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self.stats = EngineStats()
        self._lock = threading.Lock()
        self._running = True
        # a tick: (op, bucket size)
        self._server = ServingThread(mesh, self._device, 1, lead=self._assemble,
                                     drain=self._drain,
                                     follow=lambda op, fields: self._run_shard(int(fields[0])))
        self._leader = self._server.leader
        self._server.start()

    @classmethod
    def from_fused_chain(cls, chain, example_shape, **kw):
        """Serve a fused binary chain (``infer.export_fused_chain`` or
        ``infer.export_fused_lenet``): the engine's forward is the int8 code
        chain; ``device`` (default the card) must be where its weights are."""
        from pytorch_quantize_impls_tpu_torch.infer.fused_chain import fused_apply

        return cls(lambda x: fused_apply(chain, x), example_shape, **kw)

    @classmethod
    def from_fused_resnet(cls, net, example_shape, **kw):
        """Serve a fused DoReFa ResNet (``infer.export_fused_resnet20``);
        ``device`` (default the card) must be where its weights are."""
        from pytorch_quantize_impls_tpu_torch.infer.fused_chain import fused_resnet_apply

        return cls(lambda x: fused_resnet_apply(net, x), example_shape, **kw)

    # -- client API --------------------------------------------------------

    def submit(self, x) -> Future:
        """Enqueue one example (shape == example_shape); returns a Future
        that resolves to the example's output as a numpy array."""
        if not self._leader:
            raise RuntimeError("only rank 0 of the mesh takes requests")
        x = np.asarray(x)
        if x.shape != self._example_shape:
            raise ValueError(f"expected {self._example_shape}, got {x.shape}")
        req = _Request(x=x, future=Future())
        self._queue.put(req)
        return req.future

    def __call__(self, x):
        """Synchronous convenience wrapper."""
        return self.submit(x).result()

    def warmup(self) -> None:
        """Run every bucket size once (builds kernels, picks conv
        algorithms), so no request pays for it. Over a mesh (rank 0 only)
        the dispatch thread runs them, every rank taking part."""
        if self._mesh is None:
            for b in self._buckets:
                self._run(np.zeros((b, *self._example_shape), np.float32))
            return
        if not self._leader:
            raise RuntimeError("only rank 0 of the mesh warms the engine up")
        done = Future()
        self._queue.put(_Warmup(done))
        done.result()

    def shutdown(self, timeout: Optional[float] = 10) -> None:
        """Stop serving. Over a mesh, rank 0 stops every rank; another rank
        waits (up to ``timeout`` seconds, None for no limit) until rank 0
        has. On every rank, raises what failed in the engine's thread, if
        anything."""
        if self._leader:
            self._running = False
            self._queue.put(None)
        self._server.join(timeout)

    # -- dispatch ----------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _run(self, x: np.ndarray) -> np.ndarray:
        if self._mesh is not None:
            self._server.tell(RUN, (x.shape[0],))
            y = self._run_shard(x.shape[0], x)
        else:
            with torch.inference_mode():
                y = self._forward(torch.from_numpy(x).to(self._device, self._dtype))
        return (y.float() if y.dtype == torch.bfloat16 else y).cpu().numpy()

    # -- over a mesh -------------------------------------------------------

    def _run_shard(self, b: int, x: Optional[np.ndarray] = None) -> torch.Tensor:
        """Every rank's part of one bucket of ``b`` rows (``x`` on rank 0):
        scatter the data blocks, run the forward on this rank's, gather the
        outputs over the data group (rank 0's result is the bucket's)."""
        rows = b // self._n_data
        with torch.inference_mode():
            mine = torch.empty((rows, *self._example_shape), dtype=self._dtype,
                               device=self._device)
            blocks = None
            if x is not None:
                xt = torch.from_numpy(x).to(self._device, self._dtype)
                blocks = [xt[self._data_of[r] * rows:(self._data_of[r] + 1) * rows]
                          for r in range(dist.get_world_size())]
            dist.scatter(mine, blocks, src=0)
            y = self._forward(mine).contiguous()
            every = y.new_empty((b, *y.shape[1:]))
            dist.all_gather_into_tensor(every, y, group=self._data_group)
        return every

    def _drain(self, error: Optional[BaseException]) -> None:
        """Fail anything still queued, with what stopped the engine as the
        cause."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(req, _Warmup):
                req.done.set_exception(shutdown_error(error))
            elif req is not None and not req.future.done():
                req.future.set_exception(shutdown_error(error))

    def _assemble(self) -> None:
        max_b = self._buckets[-1]
        while self._running:
            try:
                first = self._queue.get(timeout=IDLE_TICK_S)
            except queue.Empty:
                self._server.tell(IDLE)
                continue
            if first is None:
                break
            if isinstance(first, _Warmup):
                for b in self._buckets:
                    self._run(np.zeros((b, *self._example_shape), np.float32))
                first.done.set_result(None)
                continue
            batch = [first]
            deadline = first.t_submit + self._max_delay_s
            # continuous assembly: take whatever arrives until the bucket is
            # full or the oldest request's deadline passes
            while len(batch) < max_b:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._running = False
                    break
                if isinstance(nxt, _Warmup):  # after this batch
                    self._queue.put(nxt)
                    break
                batch.append(nxt)
            self._execute(batch)

    def _execute(self, batch) -> None:
        n = len(batch)
        b = self._bucket_for(n)
        x = np.zeros((b, *self._example_shape), dtype=np.float32)
        for i, req in enumerate(batch):
            x[i] = req.x
        try:
            y = self._run(x)
        except Exception as e:  # deliver the failure to every waiter
            for req in batch:
                req.future.set_exception(e)
            if self._mesh is not None:
                raise
            return
        t_done = time.perf_counter()
        with self._lock:
            self.stats.requests += n
            self.stats.batches += 1
            self.stats.padded_examples += b - n
            self.stats.total_latency_s += sum(t_done - r.t_submit for r in batch)
        for i, req in enumerate(batch):
            req.future.set_result(y[i])
