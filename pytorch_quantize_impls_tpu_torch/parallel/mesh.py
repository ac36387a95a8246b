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

:func:`assert_host_sync` is the JAX package's divergence guard
(``parallel/mesh.py:60-89``) over the ranks.
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


def _bits_digest(t: torch.Tensor) -> int:
    """The sum of a tensor's bit patterns as int32 words (a float's
    bits), in int64: one ulp anywhere moves it."""
    t = t.detach().reshape(-1)
    if t.is_floating_point():
        t = (t.to(torch.float32) if t.element_size() == 2 else t).view(torch.int32)
    return int(t.to(torch.int64).sum())


def assert_host_sync(state, mesh: DeviceMesh, *, atol: float = 0.0) -> None:
    """Raise ``AssertionError`` on every rank where ranks that must agree
    have not (the JAX package's divergence guard): each rank all-gathers
    (step, seed, a digest of the replicated entries of its model's state, a
    digest of its shard's entries) as float64; the first three must match
    over every rank, the shard digest over each data group (the ranks that
    hold the same shards), within ``atol``. A digest is the sum of the
    entries' bit patterns as integers, modulo 2^52 (exact in float64), so
    one ulp anywhere moves it; JAX's sum of ``|entry|`` would round a
    small one away. Call it at each checkpoint (a collective: every rank
    calls it); a world of one rank does nothing."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    from pytorch_quantize_impls_tpu_torch.parallel.collectives import all_gather
    from pytorch_quantize_impls_tpu_torch.parallel.sharding import param_shardings

    model_dim = mesh.mesh_dim_names.index(MODEL_AXIS)
    digests = [0, 0]
    placements = param_shardings(state.model, mesh)
    for key, t in state.model.state_dict().items():
        sharded = getattr(placements[key][model_dim], "dim", None) is not None
        digests[sharded] += _bits_digest(t)
    row = torch.tensor([float(state.step), float(state.seed), float(digests[0] % 2**52),
                        float(digests[1] % 2**52), float(mesh.get_local_rank(MODEL_AXIS))],
                       dtype=torch.float64)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    table = all_gather(row[None].to(device), None, 0).cpu()
    names = ("step", "seed", "replicated digest", "shard digest")
    for r, other in enumerate(table):
        for col, name in enumerate(names):
            if col == 3:
                peers = table[table[:, 4] == other[4]]
                ref, what = peers[0, 3], f"the first rank of model index {int(other[4])}"
            else:
                ref, what = table[0, col], "rank 0"
            if abs(float(other[col]) - float(ref)) > atol:
                raise AssertionError(f"rank {r} diverged: its {name} {float(other[col])!r} "
                                     f"against {what}'s {float(ref)!r} (atol {atol})")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` (a rank's index there is
    ``mesh.get_local_rank(axis)``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))
