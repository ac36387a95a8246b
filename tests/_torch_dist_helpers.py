"""Rank code for the port's multi-process tests: ``torch.distributed`` over
gloo on the CPU, one process per rank.

The test process (which has JAX) calls :func:`start`, which runs ``python
tests/_torch_dist_helpers.py JOB TIMEOUT``: a launcher that blocks ``jax``,
``flax`` and ``optax``, imports torch and the port while the test prepares
the job, then forks one process per rank.
Each rank joins one gloo group through a ``file://`` store in the test's
temporary directory (so parallel test workers never share a port), runs
every case of the job in order on one thread and pickles what they return.
The test process computes the JAX side meanwhile, then joins the ranks with
a timeout and kills them past it, so a hung group fails its test instead of
stalling the run; the group's own timeout (``GROUP_TIMEOUT_S``) ends a
collective whose peer has died.
"""

import datetime
import os
import pickle
import signal
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 240


class Ranks:
    """``world`` ranks (:func:`start`): one launcher process imports torch
    and the port once, then waits for the job (:meth:`run`) and forks the
    ranks, each a fresh process from there on, which saves every rank the
    import. :meth:`join` waits for them and returns one ``{case name:
    result}`` per rank, in rank order."""

    def __init__(self, world: int, tmp_dir, timeout: float):
        self.tmp_dir, self.world, self.timeout = str(tmp_dir), world, timeout
        self.job = os.path.join(self.tmp_dir, "job.pkl")
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        with open(os.path.join(self.tmp_dir, "launcher.log"), "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), self.job, str(timeout)], cwd=REPO,
                env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        self.deadline = time.monotonic() + timeout

    def run(self, cases) -> "Ranks":
        """Hand the ranks the job ``cases``: a list of ``(case name,
        kwargs)``, the name a ``case_*`` function of this module, optionally
        followed by ``:label``."""
        part = self.job + ".part"
        with open(part, "wb") as f:
            pickle.dump({"cases": cases, "world": self.world,
                         "init": "file://" + os.path.join(self.tmp_dir, "store")}, f)
        os.replace(part, self.job)  # the launcher never reads a partial job
        return self

    def join(self) -> list:
        """Raises AssertionError, with the failed ranks' logs, if a rank
        failed or the job outlived its timeout (its processes are then
        killed)."""
        try:
            self.proc.wait(timeout=max(0.1, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
            raise AssertionError(f"the ranks did not finish in {self.timeout} s\n"
                                 + self._logs()) from None
        if self.proc.returncode != 0:
            raise AssertionError(f"the ranks failed (exit {self.proc.returncode})\n"
                                 + self._logs())
        out = []
        for r in range(self.world):
            with open(os.path.join(self.tmp_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    def _logs(self) -> str:
        tails = []
        for name in ["launcher"] + [f"rank{r}" for r in range(self.world)]:
            path = os.path.join(self.tmp_dir, f"{name}.log")
            if os.path.exists(path):
                with open(path) as f:
                    text = f.read()
                if text.strip():
                    tails.append(f"--- {name} ---\n{text[-3000:]}")
        return "\n".join(tails)


def start(world: int, tmp_dir, timeout: float = JOIN_TIMEOUT_S) -> Ranks:
    """Start ``world`` ranks' launcher and return at once: the caller
    prepares the job meanwhile, hands it over with ``run(cases)``, computes
    its references while the ranks run, then calls ``join()``."""
    return Ranks(world, tmp_dir, timeout)


def _np(t):
    return t.detach().cpu().numpy()


# --- the cases (each runs on every rank; collectives in the same order) -----


def case_mesh_shapes():
    """parallel.make_mesh: the default, (4, 2), and the refusals."""
    from pytorch_quantize_impls_tpu_torch import parallel

    auto = parallel.make_mesh(device="cpu")
    m = parallel.make_mesh((4, 2), device="cpu")
    out = {"auto": (tuple(auto.shape), auto.mesh_dim_names),
           "4x2": (tuple(m.shape), m.mesh_dim_names),
           "coord": (m.get_local_rank(parallel.DATA_AXIS),
                     m.get_local_rank(parallel.MODEL_AXIS))}
    for label, kw in (("3x2", dict(shape=(3, 2), device="cpu")), ("cuda", dict(device="cuda"))):
        try:
            parallel.make_mesh(**kw)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


def case_placement(variables, moe_params):
    """param_shardings of the DoReFa MLP over (4, 2) and each rank's block
    of every entry; a QuantMoE's placements by the TP rule and by the EP
    rule, and the stacks shard_experts leaves it."""
    from pytorch_quantize_impls_tpu_torch import models, parallel
    from pytorch_quantize_impls_tpu_torch import nn as tnn
    from pytorch_quantize_impls_tpu_torch.parallel import sharding
    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    model = load_flax_variables(models.MLP(32, features=(64, 10), layer="dorefa", bits=4),
                                variables, device="cpu")
    mesh = parallel.make_mesh((4, 2), device="cpu")
    placements = parallel.param_shardings(model, mesh)
    sd = model.state_dict()
    local = {k: _np(parallel.local_shard(sd[k], mesh, p)) for k, p in placements.items()}
    e, d, f = moe_params["wi_kernel"].shape
    moe = tnn.QuantMoE(d, e, f, device="cpu")
    moe.load_state_dict({k: torch_from(v) for k, v in moe_params.items()})
    rules = {name: parallel.param_shardings(moe, mesh, rule)
             for name, rule in (("tp", sharding.tp_rule), ("ep", sharding.ep_rule))}
    parallel.shard_experts(moe, mesh)

    def names(pl):
        return {k: tuple(repr(p) for p in v) for k, v in pl.items()}

    return {"coord": (mesh.get_local_rank("data"), mesh.get_local_rank("model")),
            "placements": names(placements), "local": local,
            "moe": {name: names(pl) for name, pl in rules.items()},
            "moe_stacks": {k: _np(getattr(moe, k)) for k in moe_params},
            "first_expert": moe.ep.first_expert}


def torch_from(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _lm(cfg, variables):
    from pytorch_quantize_impls_tpu_torch.models import QuantTransformerLM
    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    return load_flax_variables(QuantTransformerLM(**cfg), variables, device="cpu").eval()


def case_decode(cfg, variables, prompts, max_new, shape, backend):
    """DecodeEngine(mesh=) over ``shape``: rank 0 serves ``prompts``; the
    others check that submit refuses them. On a 4-way data axis, 6 slots
    must raise."""
    import torch.distributed as dist

    from pytorch_quantize_impls_tpu_torch import infer, parallel, serve

    model = _lm(cfg, variables)
    packed = None
    if backend != "fake":
        packed = infer.pack_model(model)
        if backend == "prepared":
            packed = infer.prepare(packed)
    mesh = parallel.make_mesh(shape, device="cpu")
    out = {}
    if shape[0] == 4:
        try:
            serve.DecodeEngine(model, packed=packed, n_slots=6, mesh=mesh, device="cpu")
            out["six_slots"] = None
        except ValueError as e:
            out["six_slots"] = str(e)
    eng = serve.DecodeEngine(model, packed=packed, n_slots=8, mesh=mesh, device="cpu")
    if dist.get_rank() == 0:
        try:
            futs = [eng.submit(p, max_new=max_new) for p in prompts]
            out["tokens"] = [f.result(timeout=120) for f in futs]
        finally:
            eng.shutdown()
        out["stats"] = (eng.stats.requests, eng.stats.tokens)
    else:
        try:
            eng.submit(prompts[0], max_new=1)
            out["refused"] = None
        except RuntimeError as e:
            out["refused"] = str(e)
        eng.shutdown(timeout=120)
    out["tp"] = eng._tp_group is not None
    out["slots"] = (eng._lo, eng._hi)
    return out


def case_serving(variables, xs):
    """InferenceEngine(mesh=) over (8, 1) with the packed binary MLP: rank
    0 warms up and serves ``xs`` as one bucket of 32; the others check that
    submit refuses. Batch sizes that do not divide the data axis raise."""
    import torch.distributed as dist

    from pytorch_quantize_impls_tpu_torch import infer, models, parallel
    from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine
    from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

    model = load_flax_variables(models.MLP(64, features=(32, 10), layer="bin"), variables,
                                device="cpu").eval()
    packed = infer.prepare(infer.pack_model(model))
    mesh = parallel.make_mesh((8, 1), device="cpu")
    out = {}
    try:
        InferenceEngine(lambda x: x, (64,), batch_sizes=(4, 32), mesh=mesh, device="cpu")
        out["four"] = None
    except ValueError as e:
        out["four"] = str(e)
    rows = []

    def forward(x):
        rows.append(x.shape[0])
        return infer.packed_apply(model, packed, x)

    eng = InferenceEngine(forward, (64,), batch_sizes=(8, 32), max_delay_ms=1000, mesh=mesh,
                          device="cpu")
    if dist.get_rank() == 0:
        try:
            eng.warmup()
            futs = [eng.submit(x) for x in xs]
            out["answers"] = np.stack([f.result(timeout=120) for f in futs])
        finally:
            eng.shutdown()
        out["batches"] = eng.stats.batches
    else:
        try:
            eng.submit(xs[0])
            out["refused"] = None
        except RuntimeError as e:
            out["refused"] = str(e)
        eng.shutdown(timeout=120)
    out["rows"] = rows
    return out


def case_moe_layer(layers, x, capacity_factor):
    """QuantMoE over (2, 4) with shard_experts, one layer per scheme of
    ``layers`` ({label: (kwargs, params)}): this data rank's tokens' output,
    aux loss, routing and keep mask; and, for the negative control, DoReFa
    4-bit experts quantized with the shard's own statistic."""
    import torch
    import torch.distributed as dist

    from pytorch_quantize_impls_tpu_torch import nn as tnn
    from pytorch_quantize_impls_tpu_torch import ops, parallel
    from pytorch_quantize_impls_tpu_torch.nn import moe

    mesh = parallel.make_mesh((2, 4), device="cpu")
    d = mesh.get_local_rank("data")
    rows = x.shape[0] // 2
    xl = torch.from_numpy(x[d * rows:(d + 1) * rows])
    out = {"coord": (d, mesh.get_local_rank("model"))}
    for label, (kw, params) in layers.items():
        e, d_model, f = params["wi_kernel"].shape
        m = tnn.QuantMoE(d_model, e, f, capacity_factor=capacity_factor, device="cpu", **kw)
        with torch.no_grad():
            for k, v in params.items():
                getattr(m, k).copy_(torch.from_numpy(v))
        parallel.shard_experts(m, mesh)
        with torch.no_grad():
            y = m(xl)
            r = moe.switch_route(xl, m.router, capacity_factor, m.ep.data_group)
            res = {"out": _np(y), "aux": float(m.penalty()), "expert": _np(r.expert),
                   "keep": _np(r.keep), "experts_held": m.wi_kernel.shape[0]}
            if label == "dorefa4":
                wi, wo = (ops.dorefa_weight(w, 4) for w in (m.wi_kernel, m.wo_kernel))
                res["local_stat_out"] = _np(moe.switch_ffn(
                    xl, m.router, wi, wo, capacity_factor=capacity_factor, ep=m.ep)[0])
        out[label] = res
    try:
        with torch.enable_grad():
            m(xl)
        out["grad_refused"] = None
    except NotImplementedError as e:
        out["grad_refused"] = str(e)
    dist.barrier()
    return out


def case_moe_lm(cfg, variables, tokens):
    """The MoE LM over (2, 4): tokens over data, experts over model; this
    data rank's logits and the summed aux loss."""
    import torch

    from pytorch_quantize_impls_tpu_torch import nn as tnn
    from pytorch_quantize_impls_tpu_torch import parallel, serve

    model = _lm(cfg, variables)
    mesh = parallel.make_mesh((2, 4), device="cpu")
    parallel.shard_experts(model, mesh)
    d = mesh.get_local_rank("data")
    rows = tokens.shape[0] // 2
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens[d * rows:(d + 1) * rows]))
        aux = float(tnn.collect_elastic_losses(model))
    out = {"logits": _np(logits), "aux": aux,
           "experts_held": [blk.moe.wi_kernel.shape[0] for blk in model.blocks()]}
    for label, kw in (("decode_mesh", dict(mesh=mesh)), ("decode_alone", {})):
        try:
            serve.DecodeEngine(model, n_slots=2, device="cpu", **kw)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


def _rank(job: dict, rank: int, tmp_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from pytorch_quantize_impls_tpu_torch import parallel

    torch.set_num_threads(1)
    parallel.initialize(job["init"], world_size=job["world"], rank=rank, device="cpu",
                        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    results = {}
    for name, kwargs in job["cases"]:
        results[name] = globals()["case_" + name.split(":")[0]](**kwargs)
    results["jax_imported"] = [k for k in sys.modules if k.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "pytorch_quantize_impls_tpu")
        and sys.modules[k] is not None]
    with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def _launch(job_path: str, timeout: float) -> None:
    """Import once, wait for the job, fork every rank, wait for them all;
    exit 1 if one failed. The fork comes before this process starts any
    thread (it has only imported), so each rank starts from a
    single-threaded copy."""
    for name in ("jax", "jaxlib", "flax", "optax"):
        sys.modules[name] = None
    import torch  # noqa: F401

    import pytorch_quantize_impls_tpu_torch  # noqa: F401

    deadline = time.monotonic() + timeout
    while not os.path.exists(job_path):
        if time.monotonic() > deadline:
            sys.exit(f"no job at {job_path} after {timeout} s")
        time.sleep(0.02)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    tmp_dir = os.path.dirname(job_path)
    pids = []
    for rank in range(job["world"]):
        pid = os.fork()
        if pid == 0:
            fd = os.open(os.path.join(tmp_dir, f"rank{rank}.log"),
                         os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
            os.dup2(fd, 1)
            os.dup2(fd, 2)
            code = 0
            try:
                _rank(job, rank, tmp_dir)
            except BaseException:
                traceback.print_exc()
                code = 1
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
        pids.append(pid)
    failed = [r for r, pid in enumerate(pids) if os.waitpid(pid, 0)[1] != 0]
    if failed:
        print(f"ranks {failed} failed", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    _launch(sys.argv[1], float(sys.argv[2]))
