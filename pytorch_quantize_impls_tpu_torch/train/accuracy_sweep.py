"""Δ-accuracy harness: train each config's float32 twin and its quantized
model, and report the accuracy gap.

    python -m pytorch_quantize_impls_tpu_torch.train.accuracy_sweep \\
        --configs xnor_cifar [--seeds N] [--steps N] [--lr LR] [--warm-start] \\
        [--set K=V ...] [--json-out rows.json] [--device cpu]

Counterpart of the JAX package's ``scripts/accuracy_sweep.py``. For each
config and seed it trains the twin, then the quantized model, warm-started
from the trained twin (:func:`warm_start`) when the config says so
(``warm_start``) or ``--warm-start`` is given. Each run is cosine-decayed
Adam with the clamp, the config's elastic weight (ramped over the first 60%
of the run where ``elastic_ramp`` is set), batches from
``data.iterate_batches`` with the config's seed, and an evaluation over the
whole test split, tail included; a quantized model is evaluated packed too
(``infer.prepare(infer.pack_model(model))``), but for one with a learnable
activation scale (``bnn_lenet_as``), which the packed paths refuse. Data: real MNIST/CIFAR-10 from
``$QTPU_DATA_DIR`` when present, else the synthetic stand-ins. One line per
config gives the seed-mean Δacc; the last line is one JSON object with the
rows. An elastic config's quantized model is hard-projected after training
(:func:`project_elastic`) and evaluated so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch import data, infer, train
from pytorch_quantize_impls_tpu_torch.infer.packed import scaled_layers
from pytorch_quantize_impls_tpu_torch.train.clipping import keystr
from pytorch_quantize_impls_tpu_torch.train.run import accuracy, load_data
from pytorch_quantize_impls_tpu_torch.utils.bridge import flax_paths
from pytorch_quantize_impls_tpu_torch.utils.config import SCHEME_CONFIGS, RunConfig, build_model

LOG_EVERY = 1000
# the quantized layers nest their parameters one module deeper than the twin's
_WRAPPERS = ("['conv']", "['dense']")


def _flax_keyed(model: nn.Module) -> dict:
    """flax key string (collection first, as ``jax.tree_util.keystr`` of a
    variables dict prints it) -> state-dict key."""
    return {keystr((collection, *path)): key
            for key, (collection, path) in flax_paths(model).items()}


@torch.no_grad()
def warm_start(q_model: nn.Module, fp_model: nn.Module) -> int:
    """Copy the trained twin ``fp_model`` into ``q_model``, as the JAX
    package's ``_warm_start``: each of the quantized model's entries takes
    the twin's entry at its own flax path or, failing that, at the path with
    the ``['conv']``/``['dense']`` segments stripped, where the shapes match.
    BatchNorm's running statistics transfer; an entry with no twin of its
    shape (PACT's alpha) keeps its value. Returns the number of entries
    copied."""
    fp_sd, q_sd = fp_model.state_dict(), q_model.state_dict()
    fp_keys = _flax_keyed(fp_model)
    matched = 0
    for path, key in _flax_keyed(q_model).items():
        stripped = path
        for wrapper in _WRAPPERS:
            stripped = stripped.replace(wrapper, "")
        for candidate in (path, stripped):
            src = fp_keys.get(candidate)
            if src is not None and fp_sd[src].shape == q_sd[key].shape:
                q_sd[key].copy_(fp_sd[src])
                matched += 1
                break
    return matched


@torch.no_grad()
def project_elastic(model: nn.Module) -> int:
    """Hard-project every kernel of an elastic-trained model onto the binary
    grid in place, as the JAX package's ``_project_elastic``: ``alpha *
    where(w >= 0, 1, -1)`` with ``alpha = mean|w|`` over axis 0 of flax's
    kernel, the inputs of a dense (in, out) kernel, so one alpha per output
    channel (dim 1 of the port's (out, in) weight; of a conv's OIHW weight,
    dim 2, flax's H). Returns the number of kernels projected."""
    params = dict(model.named_parameters())
    n = 0
    for key, (collection, path) in flax_paths(model).items():
        if collection != "params" or path[-1] != "kernel":
            continue
        w = params[key]
        alpha = w.abs().mean(dim=1 if w.dim() == 2 else 2, keepdim=True)
        w.copy_(alpha * torch.where(w >= 0, 1.0, -1.0))
        n += 1
    return n


def elastic_weight(cfg: RunConfig, steps: int):
    """The config's penalty weight: a constant, or with ``elastic_ramp`` the
    JAX runs' ramp ``lambda min(step / (0.6 steps), 1)`` in float32."""
    if not (cfg.elastic_ramp and cfg.elastic_weight):
        return cfg.elastic_weight
    lam, total = np.float32(cfg.elastic_weight), np.float32(0.6 * steps)
    return lambda step: float(lam * np.minimum(np.float32(step) / total, np.float32(1.0)))


def run_one(cfg: RunConfig, fp32: bool, steps: int, lr: float, init_from=None,
            device="cuda", splits=None, log=print):
    """Train ``cfg``'s twin (``fp32``) or quantized model for ``steps`` steps
    from ``lr``, warm-started from the trained twin ``init_from`` if given,
    on ``splits`` (train, test) or the config's data. Returns (the result
    dict, the model in eval mode, the splits)."""
    model, input_shape, dataset = build_model(cfg, fp32=fp32, device=device)
    dev = next(model.parameters()).device
    train_set, test_set = splits or load_data(dataset, input_shape, cfg.data_dir)
    out = {}
    if init_from is not None:
        out["warm_matched"] = warm_start(model, init_from)
    state = train.QuantTrainState.create_for(
        model, lr=train.cosine_decay_schedule(lr, steps), seed=cfg.seed)
    step_fn = train.make_train_step(elastic_weight=elastic_weight(cfg, steps))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for batch in data.iterate_batches(train_set, cfg.batch_size, seed=cfg.seed):
        if state.step >= steps:
            break
        _, metrics = step_fn(state, batch)
        if state.step % LOG_EVERY == 0:
            log(f"{cfg.config} {'fp32' if fp32 else 'quantized'} step {state.step} loss "
                f"{float(metrics['loss']):.4f}")
    sync()
    train_s = time.perf_counter() - t0
    if not fp32 and cfg.config.startswith("elastic"):
        out["projected"] = project_elastic(model)
    model.eval()
    out.update(accuracy=accuracy(model, test_set, dev), loss=float(metrics["loss"]),
               steps=state.step, train_s=train_s, ms_per_step=1e3 * train_s / max(state.step, 1))
    packed = {} if scaled_layers(model) else infer.pack_model(model)
    if packed:
        ready = infer.prepare(packed)
        out["packed_accuracy"] = accuracy(lambda x: infer.packed_apply(model, ready, x),
                                          test_set, dev)
    return out, model, (train_set, test_set)


def _overrides(pairs) -> dict:
    """``--set K=V`` pairs -> RunConfig field values of the field's type."""
    types = {f.name: f.type for f in dataclasses.fields(RunConfig)}
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if k not in types:
            raise SystemExit(f"--set: unknown RunConfig field {k!r}")
        t = str(types[k])
        out[k] = (v if "str" in t else bool(int(v)) if "bool" in t
                  else int(v) if "int" in t else float(v))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--configs", nargs="*", default=sorted(SCHEME_CONFIGS),
                   choices=sorted(SCHEME_CONFIGS))
    p.add_argument("--seeds", type=int, default=1,
                   help="seeds base..base+N-1 per config; the row gives their mean Δacc")
    p.add_argument("--steps", type=int, default=None, help="default: each config's")
    p.add_argument("--lr", type=float, default=None, help="default: each config's")
    p.add_argument("--warm-start", action="store_true",
                   help="warm-start every quantized run from its twin (configs opt in by "
                        "warm_start)")
    p.add_argument("--set", nargs="*", default=[], metavar="K=V",
                   help="override RunConfig fields for every config, e.g. --set width=8")
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    overrides = _overrides(a.set)
    rows = []
    for name in a.configs:
        base = RunConfig(**{**SCHEME_CONFIGS[name], **overrides})
        steps = a.steps if a.steps is not None else base.steps
        lr = a.lr if a.lr is not None else base.lr
        warm = a.warm_start or base.warm_start
        runs = []
        for s in range(a.seeds):
            cfg = dataclasses.replace(base, seed=base.seed + s)
            print(f"=== {name} fp32 twin (seed {cfg.seed}, {steps} steps) ===", flush=True)
            f, twin, splits = run_one(cfg, True, steps, lr, device=a.device)
            print(f"=== {name} quantized (seed {cfg.seed}{', warm-started' if warm else ''}) ===",
                  flush=True)
            q, _, _ = run_one(cfg, False, steps, lr, init_from=twin if warm else None,
                              device=a.device, splits=splits)
            del twin
            runs.append((q, f))
            print(f"{name} seed {cfg.seed}: quant {q['accuracy']:.4f} fp32 {f['accuracy']:.4f} "
                  f"Δ {q['accuracy'] - f['accuracy']:+.4f}", flush=True)
        deltas = [q["accuracy"] - f["accuracy"] for q, f in runs]
        row = {
            "config": name,
            "quant_acc": float(np.mean([q["accuracy"] for q, _ in runs])),
            "fp32_acc": float(np.mean([f["accuracy"] for _, f in runs])),
            "delta_acc": float(np.mean(deltas)),
            "delta_spread": float(np.max(deltas) - np.min(deltas)) / 2,
            "deltas": deltas,
            "seeds": a.seeds,
            "steps": steps,
            "warm_start": bool(warm),
            "warm_matched": [q.get("warm_matched") for q, _ in runs],
            "packed_acc": [q.get("packed_accuracy") for q, _ in runs],
            "quant_ms_per_step": float(np.mean([q["ms_per_step"] for q, _ in runs])),
            "fp32_ms_per_step": float(np.mean([f["ms_per_step"] for _, f in runs])),
        }
        rows.append(row)
        print(f"{name}: quant {row['quant_acc']:.4f} fp32 {row['fp32_acc']:.4f} mean Δacc "
              f"{row['delta_acc']:+.4f} ±{row['delta_spread']:.4f} over {a.seeds} seed(s), "
              f"{steps} steps{', warm' if warm else ''}", flush=True)
    dev = torch.device(a.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    real = data.datasets._data_dir() is not None
    if a.json_out:
        Path(a.json_out).write_text(json.dumps(rows, indent=1))
    print(json.dumps({"rows": rows, "device": kind, "data": "real" if real else "synthetic"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
