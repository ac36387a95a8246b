"""Inference: the train (fake-quant) -> infer (packed) seam.

    packed = infer.pack_model(model)              # once
    ready  = infer.prepare(packed)                # decode hot buffers
    y      = infer.packed_apply(model, ready, x)  # fast path
"""

from pytorch_quantize_impls_tpu_torch.infer.packed import (  # noqa: F401
    PackedLayer,
    load_packed,
    pack_model,
    packed_apply,
    prepare,
    save_packed,
)
