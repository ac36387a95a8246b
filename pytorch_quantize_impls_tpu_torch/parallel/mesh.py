"""The (data, model) device mesh on ``torch.distributed``.

Counterpart of ``pytorch_quantize_impls_tpu/parallel/mesh.py``. The JAX
package runs one controller over every device of a ``jax.sharding.Mesh``;
here every device has a process of its own (a rank, as ``torchrun`` starts
them) and the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
the dimension names ``("data", "model")``. Ranks are laid out row-major:
rank ``d * M + m`` sits at data index ``d`` and model index ``m`` of a
``(D, M)`` mesh, so the model groups are runs of neighbouring ranks (the
devices of one host where there are several hosts).

The group runs NCCL on ``cuda`` (a rank's device is ``cuda:{local rank}``)
and gloo on ``cpu``, which a caller asks for by name, as the tests do; every
group is made with a timeout, so that a rank that never answers fails the
collective instead of hanging it. Only one card has run these groups (a
world of size 1); more ranks run on the CPU only.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def _backend_for(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no process group backend for device type {device_type!r}")


def initialize(
    init_method: Optional[str] = None,
    *,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: str = "cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Start this process's default group: NCCL for ``device="cuda"``, gloo
    for ``device="cpu"``, with ``timeout`` on every collective. Without an
    ``init_method`` the rendezvous is read from the environment
    (``torchrun``'s ``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``). On cuda the
    process's current device becomes ``cuda:{LOCAL_RANK}`` (else the rank
    modulo the visible cards). Does nothing if a default group is up."""
    if dist.is_initialized():
        return
    dev_type = torch.device(device).type
    backend = _backend_for(dev_type)
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL group needs a CUDA device; pass device='cpu' for gloo")
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (rank if rank is not None else int(os.environ.get("RANK", 0)))
            local = int(local) % torch.cuda.device_count()
        torch.cuda.set_device(int(local))
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://", timeout=timeout,
                            **kwargs)


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
    *,
    device: str = "cuda",
) -> DeviceMesh:
    """A 2-D ``(data, model)`` mesh over the default group's ranks.

    ``shape=None`` puts every rank on the data axis (pure data parallelism);
    a shape whose product is not the world size raises ``ValueError``. The
    default group must be up (:func:`initialize`) with the backend of
    ``device``'s type: a cuda mesh over a gloo group raises."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.initialize first")
    dev_type = torch.device(device).type
    backend = dist.get_backend()
    if _backend_for(dev_type) not in backend:
        raise ValueError(f"a {dev_type} mesh needs a {_backend_for(dev_type)} group, "
                         f"not {backend}")
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != world size {n}")
    return init_device_mesh(dev_type, shape, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` (a rank's index there is
    ``mesh.get_local_rank(axis)``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))
