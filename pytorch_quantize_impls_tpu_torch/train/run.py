"""Train a named config end to end on the card (or the CPU).

    python -m pytorch_quantize_impls_tpu_torch.train.run --config bnn_lenet \\
        [--steps N] [--fp32] [--schedule constant|cosine] [--device cpu] \\
        [--checkpoint-dir D] [--ckpt-every 500] [--metrics m.jsonl] \\
        [--expect-acc A] [--export model.npz]

The loop of the JAX package's ``scripts/train.py`` without its mesh (the
sharded steps and ``--mesh`` are ROADMAP queue 1, item 6 (b2)): build the config's model (weights drawn as flax
draws them, from ``--seed``), load its data (real MNIST/CIFAR-10 from
``$QTPU_DATA_DIR`` or ``--data-dir`` when present, else the synthetic
stand-ins; sklearn's digits), restore the newest checkpoint of
``--checkpoint-dir`` if there is one (``resumed from step N``), train over
``data.iterate_batches`` from that step, save every ``--ckpt-every`` steps
and once at the end (``utils.CheckpointManager``: a run killed at any point
resumes and ends on the same bits as one that was not), evaluate on the
whole test split in batches of 256, and for a quantized model evaluate its
packed form too (``infer.prepare(infer.pack_model(model))``; not for
``bnn_lenet_as``, whose learnable activation scale the packed paths refuse).
``--export`` writes the packed artifact (``infer.save_packed``), which either
package loads (``bnn_lenet_as`` refuses it before training); ``infer.host_export`` writes it from a checkpoint on a host without
a card. ``--schedule cosine`` decays the learning rate as the JAX package's
accuracy runs do (``scripts/accuracy_sweep.py``); the default is constant,
as ``scripts/train.py``. Every 100 steps and at the last, a line gives the
loss, the accuracy and images/s over the steps since the last line (the
card is synchronized there only, so the host queues each step while the
card runs the one before), and ``--metrics`` appends it as JSON
(``utils.MetricsWriter``). A ``torch.profiler`` trace is the API's
(``utils.trace``), as in the JAX package. The last line is one JSON object
with the result; with
``--expect-acc`` the exit code is 1 when the test accuracy is below it. The
8-bit Adam is reached through the API (``train.QuantTrainState.create_for(
optimizer=train.QuantizedAdam(...))``), as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from pytorch_quantize_impls_tpu_torch import data, infer, train
from pytorch_quantize_impls_tpu_torch.infer.packed import refuse_act_scale, scaled_layers
from pytorch_quantize_impls_tpu_torch.utils.checkpoint import CheckpointManager
from pytorch_quantize_impls_tpu_torch.utils.config import SCHEME_CONFIGS, RunConfig, build_model
from pytorch_quantize_impls_tpu_torch.utils.metrics import MetricsWriter

LOG_EVERY = 100
EVAL_BATCH = 256


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="bnn_lenet", choices=sorted(SCHEME_CONFIGS))
    p.add_argument("--steps", type=int, default=None, help="default: the config's")
    p.add_argument("--batch-size", type=int, default=None, help="default: the config's")
    p.add_argument("--lr", type=float, default=None, help="default: the config's")
    p.add_argument("--schedule", choices=("constant", "cosine"), default="constant")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=None, help="bnn_lenet's width (default 128)")
    p.add_argument("--fp32", action="store_true", help="train the float32 twin")
    p.add_argument("--device", default="cuda")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--checkpoint-dir", default=None, help="save here, and resume from here")
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--metrics", default=None, help="append JSON lines of metrics here")
    p.add_argument("--expect-acc", type=float, default=None,
                   help="exit 1 if the test accuracy is below this")
    p.add_argument("--export", default=None, help="write the packed .npz artifact here")
    return p.parse_args(argv)


def load_data(dataset: str, input_shape, data_dir=None):
    flat = len(input_shape) == 1
    if dataset == "mnist":
        return data.mnist(flatten=flat, data_dir=data_dir)
    if dataset == "digits":
        return data.digits(flatten=flat)
    return data.cifar10(data_dir=data_dir)


@torch.no_grad()
def accuracy(forward, test, device) -> float:
    """Share of the test split ``forward`` classifies right, tail included."""
    xs, ys = test
    correct = 0
    for i in range(0, len(xs), EVAL_BATCH):
        x = torch.from_numpy(xs[i:i + EVAL_BATCH]).to(device)
        y = torch.from_numpy(ys[i:i + EVAL_BATCH]).to(device)
        correct += int((forward(x).argmax(-1) == y).sum())
    return correct / len(xs)


def train_config(args):
    """Train, evaluate and export as ``args`` say; returns (the model in eval
    mode, the result dict)."""
    cfg = RunConfig(**SCHEME_CONFIGS[args.config])
    cfg.seed = args.seed
    for field in ("steps", "batch_size", "lr", "width", "data_dir"):
        if getattr(args, field) is not None:
            setattr(cfg, field, getattr(args, field))
    cfg.checkpoint_dir, cfg.metrics_path = args.checkpoint_dir, args.metrics
    model, input_shape, dataset = build_model(cfg, fp32=args.fp32, device=args.device)
    device = next(model.parameters()).device
    if args.export:
        refuse_act_scale(model, "--export")
    train_data, test_data = load_data(dataset, input_shape, cfg.data_dir)
    lr = train.cosine_decay_schedule(cfg.lr, cfg.steps) if args.schedule == "cosine" else cfg.lr
    state = train.QuantTrainState.create_for(model, lr=lr, seed=cfg.seed)
    step_fn = train.make_train_step()
    print(f"config={cfg.config} fp32={args.fp32} model={type(model).__name__} "
          f"dataset={dataset} train={train_data[0].shape} test={test_data[0].shape} "
          f"device={device}", flush=True)
    mgr = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    if mgr is not None and mgr.restore(state) is not None:
        print(f"resumed from step {state.step}", flush=True)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    metrics = None
    first_step = last_log = state.step
    t_start = t_log = time.perf_counter()
    with MetricsWriter(cfg.metrics_path) as mw:
        for batch in data.iterate_batches(train_data, cfg.batch_size, seed=cfg.seed,
                                          start_step=state.step):
            if state.step >= cfg.steps:
                break
            state, metrics = step_fn(state, batch)
            if state.step % LOG_EVERY == 0 or state.step == cfg.steps:
                sync()
                now = time.perf_counter()
                m = {"loss": float(metrics["loss"]), "accuracy": float(metrics["accuracy"]),
                     "images_per_s": (state.step - last_log) * cfg.batch_size / (now - t_log)}
                t_log, last_log = now, state.step
                mw.write(state.step, m)
                print(f"step {state.step} loss {m['loss']:.4f} accuracy {m['accuracy']:.4f} "
                      f"images/s {m['images_per_s']:.1f}", flush=True)
            if mgr is not None and state.step % args.ckpt_every == 0:
                mgr.save(state)
    sync()
    train_s = time.perf_counter() - t_start
    if mgr is not None:
        mgr.save(state, force=True)
        mgr.close()

    model.eval()
    trained = state.step - first_step
    out = {"config": cfg.config, "fp32": args.fp32, "steps": state.step,
           "schedule": args.schedule, "device": str(device),
           "loss": float(metrics["loss"]) if metrics is not None else None,
           "ms_per_step": 1e3 * train_s / max(trained, 1),
           "accuracy": accuracy(model, test_data, device)}
    packed = {} if scaled_layers(model) else infer.pack_model(model)
    if packed:
        ready = infer.prepare(packed)
        out["packed_accuracy"] = accuracy(
            lambda x: infer.packed_apply(model, ready, x), test_data, device)
    if args.export:
        infer.save_packed(args.export, packed)
        out["export"] = args.export
    return model, out


def main(argv=None) -> int:
    args = parse_args(argv)
    _, out = train_config(args)
    print(json.dumps(out), flush=True)
    if args.expect_acc is not None and out["accuracy"] < args.expect_acc:
        print(f"accuracy {out['accuracy']:.4f} below the gate {args.expect_acc:.4f}",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
