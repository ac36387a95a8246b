"""The serving thread of an engine, and rank 0's control channel over a mesh.

The JAX package's engines are single-controller; the port's are
multi-controller: over a mesh every rank builds the engine, and its
:class:`ServingThread` runs one of two loops. Rank 0 (the leader) takes the
requests and decides each tick; it broadcasts the tick as one fixed-width
int64 tensor, the op (:data:`IDLE`, :data:`RUN` or :data:`STOP`) and the
engine's fields, and any payload of the tick follows it
(:meth:`ServingThread.broadcast`). Every other rank receives the ticks and
does its part of each until :data:`STOP`, so all ranks issue the same
collectives in the same order. A leader with nothing to do ticks idle every
:data:`IDLE_TICK_S` seconds, so that the group's timeout finds a lost rank
and not a quiet one. Without a mesh the thread is the leader alone and the
channel sends nothing.

Whatever the loop raises is kept and raised again by
:meth:`ServingThread.join` on that rank, and the requests still waiting
fail with it as their cause.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

IDLE, RUN, STOP = 0, 1, 2
IDLE_TICK_S = 0.1


def shutdown_error(cause: Optional[BaseException]) -> RuntimeError:
    """The error a request gets when its engine stops before answering it:
    ``cause`` is what stopped the engine, if anything failed."""
    err = RuntimeError("engine shutdown")
    err.__cause__ = cause
    return err


class ServingThread:
    """An engine's serving thread. On the leader it runs ``lead()``, then
    tells the other ranks to stop, then ``drain(error)`` with what
    ``lead`` raised (None if nothing). On another rank it calls
    ``follow(op, fields)`` for every tick that is not idle, ``fields``
    being the ``width`` int64 numbers after the op, until the leader
    stops."""

    def __init__(self, mesh, device: torch.device, width: int, *, lead: Callable[[], None],
                 drain: Callable[[Optional[BaseException]], None],
                 follow: Optional[Callable[[int, np.ndarray], None]] = None):
        self.mesh, self.device, self.width = mesh, device, width
        self.leader = mesh is None or dist.get_rank() == 0
        self.error: Optional[BaseException] = None
        self._lead, self._drain, self._follow = lead, drain, follow
        self._thread = threading.Thread(
            target=self._run_leader if self.leader else self._run_follower, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def tell(self, op: int, fields: Sequence[int] = ()) -> None:
        """The leader: broadcast one tick (nothing without a mesh)."""
        if self.mesh is None:
            return
        ctl = np.zeros(1 + self.width, np.int64)
        ctl[0] = op
        ctl[1:1 + len(fields)] = fields
        dist.broadcast(torch.from_numpy(ctl).to(self.device), src=0)

    def broadcast(self, payload: torch.Tensor) -> torch.Tensor:
        """A tick's payload, from the leader to every rank, in place."""
        dist.broadcast(payload, src=0)
        return payload

    def join(self, timeout: Optional[float]) -> None:
        """Wait for the loop to end (the leader's ``lead`` must have been
        told to stop). Over a mesh, a loop still running after ``timeout``
        seconds raises ``TimeoutError``; what the loop raised is raised
        here, on every rank."""
        self._thread.join(timeout=timeout)
        if self.mesh is not None and self._thread.is_alive():
            raise TimeoutError(f"the engine's thread still runs after {timeout} s")
        if self.error is not None:
            raise RuntimeError("the engine failed on this rank") from self.error

    def _use_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _run_leader(self) -> None:
        self._use_device()
        try:
            self._lead()
            self.tell(STOP)
        except Exception as e:  # a failed collective leaves the ranks out of step
            self.error = e
        self._drain(self.error)

    def _run_follower(self) -> None:
        self._use_device()
        try:
            while True:
                ctl = torch.zeros(1 + self.width, dtype=torch.int64, device=self.device)
                ctl = self.broadcast(ctl).cpu().numpy()
                op = int(ctl[0])
                if op == STOP:
                    return
                if op != IDLE:
                    self._follow(op, ctl[1:])
        except Exception as e:  # raised again by join()
            self.error = e
