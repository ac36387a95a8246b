"""Continuous-batching engine over the packed forward path.

Counterpart of ``pytorch_quantize_impls_tpu/serve/engine.py``. Requests
(single examples) stream in from many client threads; a dispatch thread
assembles them into padded buckets (powers of two by default) and runs ONE
forward per bucket, so the device always sees a handful of fixed batch shapes
and large batches. A deadline (``max_delay_ms``) bounds latency when traffic
is sparse.

The forward runs under ``torch.inference_mode()`` on the engine's device.
``from_fused_chain`` serves a fused binary chain (the XNOR convnet, BNN
LeNet), ``from_fused_resnet`` a fused DoReFa ResNet; data-parallel serving
over a mesh waits for ROADMAP queue 1, item 6.
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


class InferenceEngine:
    """Continuous-batching server around a ``forward(x) -> y`` function.

    ``forward`` is typically ``lambda x: infer.packed_apply(model, prepared,
    x)``. It receives a ``(bucket, *example_shape)`` tensor of ``dtype`` on
    ``device`` and returns a tensor whose first axis is the batch. Answers
    are numpy rows; a bf16 output (a model with ``dtype=torch.bfloat16``)
    comes back widened to float32, which holds it exactly (numpy has no
    bf16).
    """

    def __init__(
        self,
        forward: Callable[[torch.Tensor], torch.Tensor],
        example_shape: Tuple[int, ...],
        *,
        batch_sizes: Sequence[int] = (1, 4, 16, 64, 256),
        max_delay_ms: float = 2.0,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        self._device = resolve_device(device)
        self._forward = forward
        self._example_shape = tuple(example_shape)
        self._buckets = sorted(batch_sizes)
        self._max_delay_s = max_delay_ms / 1e3
        self._dtype = dtype
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self.stats = EngineStats()
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

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
        algorithms), so no request pays for it."""
        for b in self._buckets:
            self._run(np.zeros((b, *self._example_shape), np.float32))

    def shutdown(self) -> None:
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=10)

    # -- dispatch ----------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _run(self, x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            xt = torch.from_numpy(x).to(self._device, self._dtype)
            y = self._forward(xt)
            return (y.float() if y.dtype == torch.bfloat16 else y).cpu().numpy()

    def _dispatch_loop(self) -> None:
        max_b = self._buckets[-1]
        while self._running:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
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
            return
        t_done = time.perf_counter()
        with self._lock:
            self.stats.requests += n
            self.stats.batches += 1
            self.stats.padded_examples += b - n
            self.stats.total_latency_s += sum(t_done - r.t_submit for r in batch)
        for i, req in enumerate(batch):
            req.future.set_result(y[i])
