"""Distribution on ``torch.distributed``: the (data, model) mesh, its
placement rules, serving over it, and training over it.

Counterpart of part of ``pytorch_quantize_impls_tpu/parallel``: one process
per device, a ``DeviceMesh`` with the dimensions ``("data", "model")``,
``Shard``/``Replicate`` placements in place of ``PartitionSpec``s, and the
collectives of each ``shard_map`` body written out over the mesh's groups.
The engines take the mesh (``serve.InferenceEngine(mesh=)``,
``serve.DecodeEngine(mesh=)``) and run their ticks through
``parallel.control``; the packed dense records are cut into column shards
by ``infer.shard_packed``, and :func:`shard_experts` places a model's MoE
experts by :func:`param_shardings`' expert rule. Training:
:func:`shard_train_state`, :func:`shard_batch`,
:func:`make_sharded_train_step` and :func:`make_sharded_eval_step` (data
and tensor parallelism, the statistics and draws made global by
``parallel.collectives``), :func:`unshard_params` and
:func:`assert_host_sync`; ``train.run --mesh D,M`` drives them. Left of
ROADMAP queue 1 item 6: (b3) the decode engine's prefill through the
column shards, expert parallelism under autograd and the 8-bit Adam under
a model axis > 1; then the collective matmuls and quantized collectives,
the pipeline, and ring and Ulysses attention.
"""

from pytorch_quantize_impls_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    assert_host_sync,
    axis_size,
    initialize,
    make_mesh,
)
from pytorch_quantize_impls_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    local_shard,
    make_sharded_eval_step,
    make_sharded_train_step,
    mesh_device,
    param_shardings,
    replicate,
    shard_batch,
    shard_experts,
    shard_train_state,
    unshard_optimizer_state,
    unshard_params,
)
