"""Distribution on ``torch.distributed``: the (data, model) mesh and its
placement rules, for serving.

Counterpart of part of ``pytorch_quantize_impls_tpu/parallel``: one process
per device, a ``DeviceMesh`` with the dimensions ``("data", "model")``,
``Shard``/``Replicate`` placements in place of ``PartitionSpec``s, and the
collectives of each ``shard_map`` body written out over the mesh's groups.
The engines take the mesh (``serve.InferenceEngine(mesh=)``,
``serve.DecodeEngine(mesh=)``) and run their ticks through
``parallel.control``; the packed dense records are cut into column shards
by ``infer.shard_packed``, and :func:`shard_experts` places a model's MoE
experts by :func:`param_shardings`' expert rule. The sharded train steps,
their batch placement and ``assert_host_sync`` are ROADMAP queue 1 item 6
(b2); pipeline, ring and Ulysses attention, the collective matmuls and the
quantized collectives are its other parts.
"""

from pytorch_quantize_impls_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
    initialize,
    make_mesh,
)
from pytorch_quantize_impls_tpu_torch.parallel.sharding import (  # noqa: F401
    local_shard,
    param_shardings,
    shard_experts,
)
