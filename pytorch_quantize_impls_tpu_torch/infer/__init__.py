"""Inference: the train (fake-quant) -> infer (packed) seam, the fused
int8 chain of the DoReFa ResNet-20, and the fused decode step of the 1-bit
transformer LM.

    packed = infer.pack_model(model)              # once
    ready  = infer.prepare(packed)                # decode hot buffers
    y      = infer.packed_apply(model, ready, x)  # fast path

    net = infer.export_fused_resnet20(resnet)
    logits = infer.fused_resnet_apply(net, images)

    fm = infer.export_fused_decode(lm, device="cuda")
    logits, cache = infer.fused_decode_apply(fm, None, tokens)
"""

from pytorch_quantize_impls_tpu_torch.infer.packed import (  # noqa: F401
    PackedLayer,
    load_packed,
    pack_model,
    packed_apply,
    prepare,
    save_packed,
)
from pytorch_quantize_impls_tpu_torch.infer.fused_chain import (  # noqa: F401
    FusedResBlock,
    FusedResNet,
    export_fused_resnet20,
    fused_resnet_apply,
)
from pytorch_quantize_impls_tpu_torch.infer.fused_decode import (  # noqa: F401
    FusedDecodeLayer,
    FusedDecodeModel,
    export_fused_decode,
    fused_decode_apply,
    fused_init_cache,
)
