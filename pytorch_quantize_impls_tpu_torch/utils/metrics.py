"""Metrics and logging: a JSON-lines metrics stream and stdlib logging.

Counterpart of ``pytorch_quantize_impls_tpu/utils/metrics.py``. One JSON
object per written step (``{"step", "t", ...}``, ``t`` the seconds since the
writer opened), appended to the file. Under ``torch.distributed`` only rank
0 writes; without a process group every process writes.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch

log = logging.getLogger("qtpu")


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(level=level, format="%(asctime)s %(name)s %(levelname)s %(message)s",
                        force=True)


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class MetricsWriter:
    """Appends one JSON line per :meth:`write` to ``path`` (None: writes
    nothing)."""

    def __init__(self, path: Optional[str], *, rank0_only: bool = True):
        self._f = None
        if path and (not rank0_only or _rank() == 0):
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def write(self, step: int, metrics: Dict[str, Any]) -> None:
        """One line: the step, the seconds since the writer opened, and
        each metric as a float where it converts (a device scalar waits for
        its step), else as it is."""
        if self._f is None:
            return
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
