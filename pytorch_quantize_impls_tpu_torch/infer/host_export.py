"""Device-free packed export: trained weights -> serving artifact, on the host.

Counterpart of ``pytorch_quantize_impls_tpu/infer/host_export.py`` and of
``scripts/export_packed.py``. A deployment pipeline takes the training
checkpoint on a host with no accelerator and writes the artifact that
serving hosts load (``infer.load_packed``). The model stays on the CPU:
``infer.pack_model``'s own records (the same layers, the same refusals, each
scheme's codes stated once in ``infer.packed``), whose planar words the host
codec writes (:mod:`utils.native`, threaded C++; numpy fallback), saved
through ``infer.save_packed``. So the artifact equals ``pack_model`` +
``save_packed`` of the same weights, and it loads in either package.

    python -m pytorch_quantize_impls_tpu_torch.infer.host_export --config C \\
        --checkpoint-dir D [--step N] --out model.npz

reads the newest checkpoint that loads (or step N), written by
``train.run --checkpoint-dir``, on the CPU, and prints which codec ran.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.infer.packed import PackedModel, pack_model, save_packed
from pytorch_quantize_impls_tpu_torch.utils import native


def _host_planes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(K, N) int32 codes -> planar words by the host codec, as int32 bit
    patterns (``ops.pack.pack_bitplanes``'s words)."""
    return torch.from_numpy(native.pack_bitplanes(codes.numpy(), bits).view(np.int32))


def host_pack_model(model: nn.Module) -> PackedModel:
    """``infer.pack_model`` of a model on the CPU, its words packed by the
    host codec."""
    if any(p.device.type != "cpu" for p in model.parameters()):
        raise ValueError("the host export packs a model on the CPU")
    return pack_model(model, pack_planes=_host_planes)


def export_packed(path: str, model: nn.Module) -> int:
    """Pack on the host and write the artifact; returns the number of layers."""
    packed = host_pack_model(model)
    save_packed(path, packed)
    return len(packed)


def main(argv=None) -> int:
    from pytorch_quantize_impls_tpu_torch.utils.checkpoint import CheckpointManager
    from pytorch_quantize_impls_tpu_torch.utils.config import SCHEME_CONFIGS, RunConfig, build_model

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", required=True, choices=sorted(SCHEME_CONFIGS))
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--step", type=int, default=None, help="default: the newest that loads")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)

    model = build_model(RunConfig(**SCHEME_CONFIGS[a.config]), device="cpu")[0]
    ckpt = CheckpointManager(a.checkpoint_dir, async_save=False).load(a.step)
    if ckpt is None:
        print(f"no checkpoint found in {a.checkpoint_dir}", file=sys.stderr)
        return 1
    model.load_state_dict(ckpt["model"])
    n = export_packed(a.out, model)
    codec = "native C++" if native.available() else "numpy fallback"
    print(f"wrote {n} packed layers (step {ckpt['step']}, {codec}) -> {a.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
