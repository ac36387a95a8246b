"""Checkpoints, resume, metrics and profiling of the port's training
(``utils.checkpoint``, ``utils.metrics``, ``utils.profiling``,
``train.run --checkpoint-dir``), on the CPU.

The checkpoint semantics are the JAX package's (``tests/test_fault_tolerance.py``,
``tests/test_utils.py``): a round trip restores the train state with its
optimizer, an empty directory restores None, a step already on disk is a
no-op, ``max_to_keep`` prunes, a torn newest checkpoint falls back to the
one before, and a resumed run ends on the bits of one that was not
interrupted: in process, and through ``train.run`` killed with SIGKILL.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_quantize_impls_tpu_torch import data, models, train
from pytorch_quantize_impls_tpu_torch.train import run as trun
from pytorch_quantize_impls_tpu_torch.utils import CheckpointManager, MetricsWriter, StepTimer
from pytorch_quantize_impls_tpu_torch.utils import metrics, profiling
from pytorch_quantize_impls_tpu_torch.utils.checkpoint import MARKER

REPO = Path(__file__).resolve().parents[1]
BATCH = 32
SUBPROCESS_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def mnist():
    return data.mnist(flatten=True)[0]


def _state(optimizer: str, seed: int = 0):
    torch.manual_seed(seed)
    model = models.BinaryConnectMLP(784, 32)
    sched = train.cosine_decay_schedule(3e-3, 40)
    if optimizer == "adam8":
        return train.QuantTrainState.create_for(
            model, optimizer=train.QuantizedAdam(model.parameters(), lr=sched, block=64,
                                                 min_quantized_size=128))
    return train.QuantTrainState.create_for(model, lr=sched)


def _run(state, batches, steps: int):
    step = train.make_train_step()
    for _ in range(steps):
        step(state, next(batches))


def _flat(obj, prefix=""):
    """Every leaf of a nested checkpoint dict, by its path."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def _assert_same(a, b) -> None:
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def _contents(state):
    return {"step": state.step, "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}


@pytest.mark.parametrize("optimizer", ["adam", "adam8"])
def test_round_trip_with_optimizer_state(tmp_path, mnist, optimizer):
    state = _state(optimizer)
    _run(state, data.iterate_batches(mnist, BATCH), 3)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(state)
    mgr.wait()
    assert mgr.latest_step() == 3 and (tmp_path / "3" / MARKER).exists()
    fresh = _state(optimizer, seed=1)
    assert mgr.restore(fresh) is fresh
    _assert_same(_contents(fresh), _contents(state))
    assert fresh.seed == state.seed


def test_empty_directory_restores_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None
    assert mgr.restore(_state("adam")) is None


def test_existing_step_is_a_no_op(tmp_path, mnist):
    state = _state("adam")
    _run(state, data.iterate_batches(mnist, BATCH), 2)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.save(state)
    before = mgr.path(2).stat().st_mtime_ns
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    assert not mgr.save(state) and not mgr.save(state, force=True)
    assert mgr.path(2).stat().st_mtime_ns == before
    assert mgr.all_steps() == [2]


def test_max_to_keep_prunes_and_interval_skips(tmp_path, mnist):
    state = _state("adam8")
    batches = data.iterate_batches(mnist, BATCH)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_steps=2)
    for _ in range(6):
        _run(state, batches, 1)
        mgr.save(state)
    mgr.wait()
    assert mgr.all_steps() == [4, 6]
    _run(state, batches, 1)
    assert not mgr.save(state)  # step 7 is off the interval
    assert mgr.save(state, force=True)
    mgr.close()
    assert mgr.all_steps() == [6, 7]
    assert sorted(os.listdir(tmp_path)) == ["6", "7"]  # no temporary left


def test_torn_newest_falls_back(tmp_path, mnist):
    """A truncated newest checkpoint, and one whose directory lost its file,
    fall back to the step before and are set aside; a step that never
    finalized (no marker) is not listed; an explicit step does not fall
    back."""
    state = _state("adam8")
    batches = data.iterate_batches(mnist, BATCH)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5, async_save=False)
    for _ in range(3):
        _run(state, batches, 1)
        mgr.save(state)
    with open(mgr.path(3), "r+b") as f:
        f.truncate(os.path.getsize(mgr.path(3)) // 2)
    with pytest.raises(RuntimeError, match="zip archive"):
        mgr.restore(_state("adam8"), step=3)
    assert mgr.all_steps() == [1, 2, 3]
    with pytest.warns(UserWarning, match="checkpoint 3 does not load"):
        restored = mgr.restore(_state("adam8", seed=1))
    assert restored.step == 2
    mgr.path(2).unlink()
    with pytest.warns(UserWarning, match="checkpoint 2 does not load"):
        assert mgr.restore(_state("adam8", seed=1)).step == 1
    (tmp_path / "9").mkdir()  # a writer's directory without the marker
    assert mgr.all_steps() == [1]
    aside = sorted(d.name.split(".")[0] for d in tmp_path.iterdir() if ".torn-" in d.name)
    assert aside == ["2", "3"]


def test_torn_step_is_saved_again_after_resume(tmp_path, mnist):
    """A run resumed from the step before a torn one saves the torn step
    anew when it reaches it: the newest checkpoint loads, at the last step,
    with the resumed run's bits."""
    state = _state("adam")
    batches = data.iterate_batches(mnist, BATCH)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    for _ in range(3):
        _run(state, batches, 1)
        mgr.save(state)
    mgr.path(3).write_bytes(b"torn")
    resumed = _state("adam", seed=1)
    with pytest.warns(UserWarning, match="checkpoint 3 does not load"):
        assert mgr.restore(resumed).step == 2
    _run(resumed, data.iterate_batches(mnist, BATCH, start_step=resumed.step), 1)
    assert mgr.save(resumed, force=True)
    assert mgr.latest_step() == 3
    ckpt = mgr.load()
    assert ckpt["step"] == 3
    _assert_same({k: ckpt[k] for k in ("step", "model", "optimizer")}, _contents(resumed))
    _assert_same(_contents(resumed), _contents(state))


@pytest.mark.parametrize("optimizer", ["adam", "adam8"])
def test_in_process_resume_is_bit_identical(tmp_path, mnist, optimizer):
    """Save at step 6, restore into a fresh state, run to 12 on the batch
    stream from step 6: the same bits as 12 uninterrupted steps, the
    optimizer's state and count included."""
    whole = _state(optimizer)
    _run(whole, data.iterate_batches(mnist, BATCH), 12)
    first = _state(optimizer)
    _run(first, data.iterate_batches(mnist, BATCH), 6)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(first)
    mgr.close()
    resumed = _state(optimizer, seed=1)
    mgr.restore(resumed)
    assert resumed.step == 6
    _run(resumed, data.iterate_batches(mnist, BATCH, start_step=resumed.step), 6)
    _assert_same(_contents(resumed), _contents(whole))


def test_async_save_holds_one_step(tmp_path, mnist):
    """The caller updates the parameters in place right after an async save
    returns; the file holds the state of the step it was called at."""
    state = _state("adam8")
    batches = data.iterate_batches(mnist, BATCH)
    _run(state, batches, 2)
    at_save = {"step": 2, "model": {k: v.clone() for k, v in state.model.state_dict().items()},
               "optimizer": {i: {k: v.clone() for k, v in st.items()}
                             for i, st in state.optimizer.state_dict()["state"].items()}}
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(state)
    _run(state, batches, 3)
    mgr.wait()
    ckpt = mgr.load(2)
    _assert_same({"step": ckpt["step"], "model": ckpt["model"],
                  "optimizer": ckpt["optimizer"]["state"]}, at_save)
    assert not any(torch.equal(v, state.model.state_dict()[k])
                   for k, v in at_save["model"].items())


def test_metrics_writer_and_step_timer(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    with MetricsWriter(str(path)) as mw:
        mw.write(100, {"loss": torch.tensor(0.5), "images_per_s": 12.5, "tag": "x"})
        mw.write(200, {"loss": np.float32(0.25)})
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [100, 200]
    assert recs[0]["loss"] == 0.5 and recs[0]["tag"] == "x" and recs[1]["loss"] == 0.25
    assert all(r["t"] >= 0 for r in recs)
    MetricsWriter(None).write(1, {"loss": 1.0})  # no path: writes nothing
    metrics.setup_logging(logging.WARNING)
    assert logging.getLogger().level == logging.WARNING and metrics.log.name == "qtpu"

    synced = []
    timer = StepTimer(warmup=2, sync=lambda: synced.append(1))
    assert np.isnan(timer.throughput(8))
    for _ in range(5):
        with timer:
            time.sleep(0.002)
    assert len(timer._times) == 3 and len(synced) == 10
    assert timer.mean_s >= 0.002 and timer.throughput(8) == pytest.approx(8 / timer.mean_s)


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.named_scope("qtpu_scope"):
            torch.ones(8) @ torch.ones(8)
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    assert any(e.get("name") == "qtpu_scope" for e in trace["traceEvents"])
    assert any(e.key == "qtpu_scope" for e in prof.key_averages())


def test_train_run_killed_and_resumed_is_bit_identical(tmp_path):
    """``train.run`` of binaryconnect_mlp on the CPU, checkpointing every 20
    steps: one run killed with SIGKILL right after its first finalized
    checkpoint, then run again, prints ``resumed from step`` and ends on a
    final checkpoint equal, tensor by tensor and the optimizer included, to
    an uninterrupted run's; its metrics stream has the last step."""
    steps = 100
    args = [sys.executable, "-m", "pytorch_quantize_impls_tpu_torch.train.run",
            "--config", "binaryconnect_mlp", "--device", "cpu", "--batch-size", "64",
            "--steps", str(steps), "--ckpt-every", "20"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    deadline = time.monotonic() + SUBPROCESS_TIMEOUT_S
    procs = [subprocess.Popen(args + ["--checkpoint-dir", str(d)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for d in (whole, cut)]
    try:
        while not (cut / "20" / MARKER).exists():
            assert procs[1].poll() is None, procs[1].communicate()[0]
            assert time.monotonic() < deadline, "no checkpoint in time"
            time.sleep(0.005)
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=10)
        rerun = subprocess.run(args + ["--checkpoint-dir", str(cut), "--metrics",
                                       str(tmp_path / "m.jsonl")], cwd=REPO, env=env,
                               capture_output=True, text=True,
                               timeout=max(deadline - time.monotonic(), 1))
        out, _ = procs[0].communicate(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert procs[0].returncode == 0 and rerun.returncode == 0, rerun.stderr
    resumed = [line for line in rerun.stdout.splitlines() if line.startswith("resumed from step")]
    assert resumed and int(resumed[0].split()[-1]) < steps, rerun.stdout
    assert json.loads(rerun.stdout.splitlines()[-1])["steps"] == steps
    a = torch.load(whole / str(steps) / "state.pt", weights_only=True)
    b = torch.load(cut / str(steps) / "state.pt", weights_only=True)
    _assert_same(a, b)
    assert json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])["step"] == steps


def test_train_run_expect_acc_gate(capsys):
    """``--expect-acc``: exit 1 below the gate, 0 at or above it."""
    args = ["--config", "binaryconnect_mlp", "--device", "cpu", "--batch-size", "16",
            "--steps", "2"]
    assert trun.main(args + ["--expect-acc", "1.01"]) == 1
    assert "below the gate" in capsys.readouterr().err
    assert trun.main(args + ["--expect-acc", "0.0"]) == 0
