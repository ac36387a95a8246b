"""Checkpoint and resume of a train state, with ``torch.save``.

Counterpart of ``pytorch_quantize_impls_tpu/utils/checkpoint.py`` (orbax).
A checkpoint holds what the next step needs: ``step``, ``seed``, the
model's ``state_dict`` (master parameters, BatchNorm statistics, PACT's
alpha) and the optimizer's (Adam's moments or :class:`QuantizedAdam`'s codes
and scales, and its count). The learning-rate schedule and the step's
generator are functions of (seed, step), so they need no state; packed
weights are derived and are never checkpointed (the serving artifact has
its own format, ``infer.save_packed``).

Layout: ``<directory>/<step>/state.pt`` beside a ``FINALIZED`` marker. A
save writes into ``<step>.tmp-<pid>``, writes the marker last and renames
the directory, so a step directory exists only once it is whole; a writer
killed mid-save leaves a ``.tmp-`` directory that no reader lists.

As in the JAX package: saving a step already on disk is a no-op;
``restore`` without a step walks newest first past checkpoints that fail to
load (torn or removed under it); an empty directory restores ``None``. A
step that fails to load is set aside as ``<step>.torn-<ns>``, out of the
listing, so the resumed run saves that step anew when it reaches it.

An async save copies every tensor to host memory on the caller's thread
(``.to("cpu")`` waits for the card's stream), so the file holds the state
of the step it was called at even though the caller goes on updating the
parameters in place; only the write runs on the background thread, one at a
time.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"
MARKER = "FINALIZED"


def _to_host(obj):
    """``obj`` with every tensor copied to the CPU (a private copy)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def snapshot(state) -> Dict[str, Any]:
    """A train state's checkpoint contents, on the host."""
    return {
        "step": int(state.step),
        "seed": int(state.seed),
        "model": _to_host(state.model.state_dict()),
        "optimizer": _to_host(state.optimizer.state_dict()),
    }


class CheckpointManager:
    """Numbered checkpoints of a ``train.QuantTrainState`` in ``directory``."""

    def __init__(self, directory: str, *, max_to_keep: int = 3, save_interval_steps: int = 1,
                 async_save: bool = True):
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def all_steps(self) -> List[int]:
        """Finalized steps on disk, oldest first."""
        steps = []
        for d in self._dir.iterdir():
            if d.name.isdigit() and (d / MARKER).exists():
                steps.append(int(d.name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> Path:
        return self._dir / str(step) / STATE_FILE

    def save(self, state, *, force: bool = False, contents: Optional[Dict[str, Any]] = None
             ) -> bool:
        """Save at ``state.step`` (async unless configured otherwise).
        Returns whether a save was started: a step already on disk, or one
        off ``save_interval_steps`` without ``force``, is skipped.
        ``contents`` (host tensors) is written in place of
        :func:`snapshot` of ``state``: a sharded state's whole contents."""
        step = int(state.step)
        if not force and step % self.save_interval_steps:
            return False
        self.wait()  # one write at a time; the one in flight may be this step's
        if step in self.all_steps():
            return False
        payload = snapshot(state) if contents is None else contents
        if self.async_save:
            self._writer = threading.Thread(target=self._write_guarded, args=(step, payload),
                                            name=f"checkpoint-{step}", daemon=False)
            self._writer.start()
        else:
            self._write(step, payload)
        return True

    def _write_guarded(self, step: int, payload) -> None:
        try:
            self._write(step, payload)
        except Exception as e:  # re-raised by wait() on the caller's thread
            self._error = e

    def _write(self, step: int, payload) -> None:
        final = self._dir / str(step)
        tmp = self._dir / f"{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        with open(tmp / STATE_FILE, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        (tmp / MARKER).touch()
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else ():
            shutil.rmtree(self._dir / str(old), ignore_errors=True)

    def load(self, step: Optional[int] = None, map_location="cpu") -> Optional[Dict[str, Any]]:
        """The checkpoint dict of ``step``, or of the newest step that loads;
        None when there is none."""
        if step is not None:
            return torch.load(self.path(step), map_location=map_location, weights_only=True)
        for s in reversed(self.all_steps()):
            try:
                return torch.load(self.path(s), map_location=map_location, weights_only=True)
            except Exception as e:  # torn: torch.load raises what the bytes lead it to
                aside = self._set_aside(s)
                warnings.warn(f"checkpoint {s} does not load ({e!r}); set aside as {aside}, "
                              "trying the one before")
        return None

    def _set_aside(self, step: int) -> str:
        """Move a step that does not load out of the listing (kept for
        inspection); returns its new name, or why it stayed."""
        aside = self._dir / f"{step}.torn-{time.time_ns()}"
        try:
            os.replace(self._dir / str(step), aside)
        except OSError as e:  # a read-only directory: the step stays listed
            return f"nothing ({e!r})"
        return aside.name

    def restore(self, state, step: Optional[int] = None):
        """Load the latest (or the given) step into ``state`` in place, on
        its device; returns ``state``, or None if no checkpoint loads."""
        ckpt = self.load(step, map_location=state.device)
        if ckpt is None:
            return None
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = ckpt["step"]
        state.seed = ckpt["seed"]
        return state

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
