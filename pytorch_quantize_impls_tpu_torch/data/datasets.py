"""Dataset loaders: real MNIST/CIFAR-10 from disk when available, otherwise
deterministic synthetic stand-ins (see package docstring).

A numpy copy of ``pytorch_quantize_impls_tpu/data/datasets.py``: the same
seeds, difficulty constants and batch order give the same arrays bit for
bit, so the two packages train on the same data.

Real-data formats:
* MNIST — the four idx files (``train-images-idx3-ubyte`` etc., optionally
  ``.gz``) under ``<data_dir>/mnist/``.
* CIFAR-10 — the python pickle batches (``data_batch_1..5``, ``test_batch``)
  under ``<data_dir>/cifar-10-batches-py/``.

``data_dir`` is the loader's argument, else ``$QTPU_DATA_DIR``.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]

DATA_DIR_ENV = "QTPU_DATA_DIR"

# Difficulty settings for the synthetic MNIST/CIFAR stand-ins, calibrated so
# the fp32 twin lands at ~80-95% test accuracy at the BASELINE configs' full
# step budgets (VERDICT r3 #1: a gate where both twins score 1.0000 cannot
# detect a 1-2% quantization regression). Calibration runs recorded in
# ACCURACY.md. Module-level so the calibration script can sweep them.
SYNTH_MNIST_DIFFICULTY = dict(parts=24, part_sparsity=4, max_shift=2, noise=2.0)
SYNTH_CIFAR_DIFFICULTY = dict(parts=32, part_sparsity=4, max_shift=3, noise=2.5)


def _data_dir(data_dir: Optional[str] = None) -> Optional[Path]:
    d = data_dir or os.environ.get(DATA_DIR_ENV)
    return Path(d) if d else None


def _open_maybe_gz(path: Path):
    gz = path.with_name(path.name + ".gz")
    if path.exists():
        return open(path, "rb")
    if gz.exists():
        return gzip.open(gz, "rb")
    raise FileNotFoundError(path)


def _read_idx(path: Path) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def synthetic_image_classification(
    shape: Tuple[int, ...],
    num_classes: int,
    n_train: int,
    n_test: int,
    *,
    seed: int = 0,
    noise: float = 0.7,
    parts: int = 0,
    part_sparsity: int = 4,
    max_shift: int = 0,
) -> Tuple[Batch, Batch]:
    """Learnable synthetic task with a tunable difficulty dial.

    Base form (``parts=0, max_shift=0``): per-class fixed random template +
    Gaussian noise — trivially separable; every model saturates at 1.0000,
    which makes a Δ-accuracy gate vacuous (VERDICT r3 weak #1).

    Hard form (the MNIST/CIFAR stand-ins use this):

    * ``parts``: class templates are sparse ±1 combinations of ``parts``
      SHARED basis patterns (``part_sparsity`` parts per class). Sharing
      makes class means correlated, so discrimination needs the *difference*
      directions, not template matching — pairwise separation shrinks from
      ``sqrt(2·D)`` to ``sqrt(2·s/parts·D)``-ish and the Bayes error becomes
      a real number instead of ~0.
    * ``max_shift``: per-sample random circular shift of the image in H/W
      (uniform in ``[-max_shift, max_shift]``). Breaks pure linear template
      matching and makes the conv stack (pooling, locality) load-bearing —
      the point of gating conv configs on this task.
    * ``noise``: i.i.d. Gaussian pixel noise on top.

    Templates are unit-RMS so ``noise`` is calibrated in signal units.
    Deterministic given ``seed``. Normalized to ~zero-mean/unit-var inputs.
    """
    rng = np.random.default_rng(seed)
    if parts > 0:
        basis = rng.normal(size=(parts, int(np.prod(shape)))).astype(np.float32)
        basis /= np.linalg.norm(basis, axis=1, keepdims=True) + 1e-8
        templates = np.zeros((num_classes, int(np.prod(shape))), np.float32)
        for c in range(num_classes):
            idx = rng.choice(parts, size=part_sparsity, replace=False)
            signs = rng.choice([-1.0, 1.0], size=part_sparsity)
            templates[c] = (signs[:, None] * basis[idx]).sum(0)
        templates = templates.reshape(num_classes, *shape)
    else:
        templates = rng.normal(size=(num_classes, *shape)).astype(np.float32)
    # unit RMS per template so `noise` has a fixed meaning
    rms = np.sqrt((templates ** 2).mean(axis=tuple(range(1, templates.ndim)),
                                        keepdims=True))
    templates = templates / (rms + 1e-8)

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        y = r.integers(0, num_classes, size=n)
        x = templates[y].copy()
        if max_shift > 0 and len(shape) >= 2:
            dy = r.integers(-max_shift, max_shift + 1, size=n)
            dx = r.integers(-max_shift, max_shift + 1, size=n)
            for i in range(n):  # ~µs/roll; a few ms total
                x[i] = np.roll(x[i], (int(dy[i]), int(dx[i])), axis=(0, 1))
        x = x + noise * r.normal(size=(n, *shape)).astype(np.float32)
        # normalize like real image pipelines (zero-mean/unit-var overall)
        x /= np.sqrt(1.0 + noise * noise)
        return x.astype(np.float32), y.astype(np.int32)

    return make(n_train, seed + 1), make(n_test, seed + 2)


def mnist(flatten: bool = False, data_dir: Optional[str] = None) -> Tuple[Batch, Batch]:
    """(train, test) MNIST; real data if on disk (under ``data_dir``, else
    ``$QTPU_DATA_DIR``), else synthetic 28x28x1."""
    d = _data_dir(data_dir)
    if d and (d / "mnist").exists():
        m = d / "mnist"
        xtr = _read_idx(m / "train-images-idx3-ubyte").astype(np.float32) / 255.0
        ytr = _read_idx(m / "train-labels-idx1-ubyte").astype(np.int32)
        xte = _read_idx(m / "t10k-images-idx3-ubyte").astype(np.float32) / 255.0
        yte = _read_idx(m / "t10k-labels-idx1-ubyte").astype(np.int32)
        xtr, xte = xtr[..., None], xte[..., None]
        xtr, xte = (xtr - 0.1307) / 0.3081, (xte - 0.1307) / 0.3081
    else:
        (xtr, ytr), (xte, yte) = synthetic_image_classification(
            (28, 28, 1), 10, 12800, 2560, seed=0, **SYNTH_MNIST_DIFFICULTY
        )
    if flatten:
        xtr = xtr.reshape(len(xtr), -1)
        xte = xte.reshape(len(xte), -1)
    return (xtr, ytr), (xte, yte)


def cifar10(data_dir: Optional[str] = None) -> Tuple[Batch, Batch]:
    """(train, test) CIFAR-10 NHWC; real data if on disk (under ``data_dir``,
    else ``$QTPU_DATA_DIR``), else synthetic."""
    d = _data_dir(data_dir)
    if d and (d / "cifar-10-batches-py").exists():
        c = d / "cifar-10-batches-py"
        xs, ys = [], []
        for i in range(1, 6):
            with open(c / f"data_batch_{i}", "rb") as f:
                b = pickle.load(f, encoding="bytes")
            xs.append(b[b"data"])
            ys.append(b[b"labels"])
        xtr = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        ytr = np.concatenate(ys).astype(np.int32)
        with open(c / "test_batch", "rb") as f:
            b = pickle.load(f, encoding="bytes")
        xte = np.asarray(b[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        yte = np.asarray(b[b"labels"], dtype=np.int32)
        mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
        std = np.array([0.247, 0.243, 0.261], np.float32)
        xtr = (xtr.astype(np.float32) / 255.0 - mean) / std
        xte = (xte.astype(np.float32) / 255.0 - mean) / std
        return (xtr, ytr), (xte, yte)
    return synthetic_image_classification(
        (32, 32, 3), 10, 12800, 2560, seed=1, **SYNTH_CIFAR_DIFFICULTY
    )


# the synthetic stand-in of sklearn's digits: its shape, classes and split
SYNTH_DIGITS_DIFFICULTY = dict(parts=16, part_sparsity=4, max_shift=0, noise=2.0)
DIGITS_SPLIT = (1438, 359)


def synthetic_digits(flatten: bool = False, *, seed: int = 3) -> Tuple[Batch, Batch]:
    """(train, test) of the digits' shape (8x8x1, 10 classes, 1438/359
    examples) for a machine without sklearn: a synthetic task of
    :func:`synthetic_image_classification` (16 shared parts, 4 per class,
    noise 2.0), deterministic given ``seed``."""
    (xtr, ytr), (xte, yte) = synthetic_image_classification(
        (8, 8, 1), 10, *DIGITS_SPLIT, seed=seed, **SYNTH_DIGITS_DIFFICULTY)
    if flatten:
        xtr, xte = xtr.reshape(len(xtr), -1), xte.reshape(len(xte), -1)
    return (xtr, ytr), (xte, yte)


def digits(flatten: bool = False, *, test_frac: float = 0.2) -> Tuple[Batch, Batch]:
    """Real handwritten digits (sklearn's bundled UCI optdigits, 1797x8x8).

    The one image-classification dataset shipped on this machine — used as a
    REAL-data accuracy anchor next to the synthetic MNIST/CIFAR stand-ins
    (SURVEY.md §0: no network, no torchvision data). Pixels are 0..16;
    normalized to ~zero-mean/unit-var. Deterministic split.
    """
    from sklearn.datasets import load_digits

    d = load_digits()
    x = d.images.astype(np.float32)[..., None]  # (1797, 8, 8, 1)
    y = d.target.astype(np.int32)
    x = (x - x.mean()) / (x.std() + 1e-8)
    rng = np.random.default_rng(42)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_test = int(len(x) * test_frac)
    xtr, ytr, xte, yte = x[n_test:], y[n_test:], x[:n_test], y[:n_test]
    if flatten:
        xtr = xtr.reshape(len(xtr), -1)
        xte = xte.reshape(len(xte), -1)
    return (xtr, ytr), (xte, yte)


def iterate_batches(
    data: Batch,
    batch_size: int,
    *,
    seed: int = 0,
    epochs: Optional[int] = None,
    start_step: int = 0,
) -> Iterator[Batch]:
    """Shuffled batch iterator (drops the ragged tail batch for static shapes
    — XLA-friendly; the reference's DataLoader pads instead).

    ``start_step`` fast-forwards the deterministic stream: a run resumed from
    a step-``k`` checkpoint passes ``start_step=k`` and consumes exactly the
    batches the unkilled run would have seen — the data half of
    resume-determinism (the RNG half lives in the checkpointed train state).
    """
    x, y = data
    n = len(x) // batch_size * batch_size
    steps_per_epoch = max(n // batch_size, 1)
    epoch = start_step // steps_per_epoch
    skip = start_step - epoch * steps_per_epoch
    while epochs is None or epoch < epochs:
        perm = np.random.default_rng(seed + epoch).permutation(len(x))[:n]
        for i in range(skip * batch_size, n, batch_size):
            idx = perm[i : i + batch_size]
            yield x[idx], y[idx]
        skip = 0
        epoch += 1
