"""Inference: the train (fake-quant) -> infer (packed) seam, the fused
int8 chains (the binary convnets and the DoReFa ResNet-20), and the fused
decode step of the 1-bit transformer LM.

    packed = infer.pack_model(model)              # once
    ready  = infer.prepare(packed)                # decode hot buffers
    y      = infer.packed_apply(model, ready, x)  # fast path
    mine   = infer.shard_packed(ready, mesh, "model")  # a model rank's columns
    y      = infer.packed_apply(model, mine, x, tp_group=mesh.get_group("model"))

    chain = infer.export_fused_chain(xnor_net)    # or export_fused_lenet(lenet)
    logits = infer.fused_apply(chain, images)

    net = infer.export_fused_resnet20(resnet)
    logits = infer.fused_resnet_apply(net, images)

    fm = infer.export_fused_decode(lm, device="cuda")
    logits, cache = infer.fused_decode_apply(fm, None, tokens)

    infer.host_export.export_packed("model.npz", model)   # on the host (CLI too)
"""

from pytorch_quantize_impls_tpu_torch.infer.packed import (  # noqa: F401
    PackedLayer,
    load_packed,
    pack_model,
    packed_apply,
    prepare,
    save_packed,
    shard_packed,
    shard_packed_columns,
)
from pytorch_quantize_impls_tpu_torch.infer.fused_chain import (  # noqa: F401
    FusedChain,
    FusedHead,
    FusedResBlock,
    FusedResNet,
    FusedStage,
    export_fused_chain,
    export_fused_lenet,
    export_fused_resnet20,
    fused_apply,
    fused_resnet_apply,
)
from pytorch_quantize_impls_tpu_torch.infer.fused_decode import (  # noqa: F401
    FusedDecodeLayer,
    FusedDecodeModel,
    export_fused_decode,
    fused_decode_apply,
    fused_init_cache,
)
from pytorch_quantize_impls_tpu_torch.infer import host_export  # noqa: F401
