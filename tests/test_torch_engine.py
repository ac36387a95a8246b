"""PyTorch port of the serving engine, and the port's import boundary.

The engine's answers, requested from several client threads, must be the
rows of ``packed_apply`` on the padded batch each request rode in, and those
batches must give the JAX package's packed logits. The port must import with
``jax`` unavailable, and ``chip_smoke.py`` must refuse to run without a GPU.
"""

import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu import models as jmodels
from pytorch_quantize_impls_tpu_torch import infer, models, serve
from pytorch_quantize_impls_tpu_torch.serve import InferenceEngine
from pytorch_quantize_impls_tpu_torch.utils import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 8
SHAPE = (28, 28, 1)


def test_engine_answers_from_threads_match_packed_apply():
    rng = np.random.default_rng(1)
    variables = chip_smoke.seeded_variables(WIDTH, rng)
    model = load_flax_variables(models.BNNLeNet(width=WIDTH), variables, device="cpu").eval()
    prepared = infer.prepare(infer.pack_model(model))
    batches = []

    def forward(x):
        y = infer.packed_apply(model, prepared, x)
        batches.append((x.clone(), y.clone()))
        return y

    engine = InferenceEngine(forward, SHAPE, batch_sizes=(1, 4, 16), max_delay_ms=5.0,
                             device="cpu")
    inputs = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(24)]
    answers = [None] * len(inputs)

    def client(idx):
        futs = [(i, engine.submit(inputs[i])) for i in idx]
        for i, f in futs:
            answers[i] = f.result(timeout=60)

    threads = [threading.Thread(target=client, args=(range(c, 24, 3),)) for c in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        engine.shutdown()
    assert engine.stats.requests == 24
    assert sum(x.shape[0] for x, _ in batches) == 24 + engine.stats.padded_examples
    assert all(x.shape[0] in (1, 4, 16) for x, _ in batches)

    jm = jmodels.BNNLeNet(width=WIDTH)
    jprep = jinfer.prepare(jinfer.pack_model(jm, variables, jnp.zeros((1, *SHAPE))))
    row_of = {}
    for x, y in batches:
        np.testing.assert_array_equal(y.numpy(), infer.packed_apply(model, prepared, x).numpy())
        ref = np.asarray(jinfer.packed_apply(jm, variables, jprep, jnp.asarray(x.numpy())))
        np.testing.assert_array_equal(y.numpy(), ref)
        for xr, yr in zip(x.numpy(), y.numpy()):
            row_of[xr.tobytes()] = yr
    for x, a in zip(inputs, answers):
        assert a.shape == (10,)
        np.testing.assert_array_equal(a, row_of[x.tobytes()])


def test_engine_buckets_stats_and_errors():
    engine = InferenceEngine(lambda x: x.sum(dim=(1, 2)), (2, 3), batch_sizes=(4, 1, 2),
                             device="cpu")
    try:
        assert [engine._bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
        np.testing.assert_array_equal(engine(np.ones((2, 3), np.float32)), [6.0])
        with pytest.raises(ValueError, match="expected"):
            engine.submit(np.ones((3, 2)))
        engine.warmup()
    finally:
        engine.shutdown()
    assert engine.stats.requests == 1 and engine.stats.batches == 1
    assert engine.stats.mean_batch_size == 1.0 and engine.stats.mean_latency_ms > 0

    def broken(x):
        raise RuntimeError("forward failed")

    engine = InferenceEngine(broken, (2,), batch_sizes=(1,), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="forward failed"):
            engine.submit(np.ones(2)).result(timeout=30)
    finally:
        engine.shutdown()


def test_engine_runs_forward_in_inference_mode():
    seen = []

    def forward(x):
        seen.append((torch.is_inference_mode_enabled(), x.dtype, x.device.type))
        return x

    engine = InferenceEngine(forward, (3,), batch_sizes=(1,), dtype=torch.float64, device="cpu")
    try:
        engine(np.zeros(3))
    finally:
        engine.shutdown()
    assert seen == [(True, torch.float64, "cpu")]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "import pytorch_quantize_impls_tpu_torch as p\n"
        "from pytorch_quantize_impls_tpu_torch.infer import fused_decode\n"
        "from pytorch_quantize_impls_tpu_torch.kernels import decode_attention\n"
        "from pytorch_quantize_impls_tpu_torch.models import transformer\n"
        "from pytorch_quantize_impls_tpu_torch.ops import kv_cache\n"
        "from pytorch_quantize_impls_tpu_torch.serve import decode_engine, generate\n"
        "from pytorch_quantize_impls_tpu_torch.infer import fused_chain\n"
        "from pytorch_quantize_impls_tpu_torch.kernels import int8_conv, packed_matmul\n"
        "from pytorch_quantize_impls_tpu_torch.nn import dorefa, pact\n"
        "from pytorch_quantize_impls_tpu_torch.ops import dorefa, pact\n"
        "from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul\n"
        "from pytorch_quantize_impls_tpu_torch.models import convnets\n"
        "from pytorch_quantize_impls_tpu_torch.nn import log_lin\n"
        "from pytorch_quantize_impls_tpu_torch.ops import log_lin\n"
        "m = p.models.BNNLeNet(width=4).eval()\n"
        "y = p.infer.packed_apply(m, p.infer.pack_model(m), torch.zeros(2, 28, 28, 1))\n"
        "assert y.shape == (2, 10)\n"
        "r = p.models.DorefaResNet20(width=4).eval()\n"
        "x = torch.rand(2, 16, 16, 3)\n"
        "y = p.infer.packed_apply(r, p.infer.prepare(p.infer.pack_model(r)), x)\n"
        "assert y.shape == (2, 10)\n"
        "assert p.infer.fused_resnet_apply(p.infer.export_fused_resnet20(r), x).shape == (2, 10)\n"
        "v = p.models.LogQuantVGGSmall(widths=(4, 4)).eval()\n"
        "for rec in (p.infer.pack_model(v), p.infer.prepare(p.infer.pack_model(v))):\n"
        "    assert p.infer.packed_apply(v, rec, torch.rand(2, 32, 32, 3)).shape == (2, 10)\n"
        "lg = p.models.QuantTransformerLM(16, 32, 2, 1, 32, 16, scheme='log', w_bits=4).eval()\n"
        "eng = p.serve.DecodeEngine(lg, packed=p.infer.pack_model(lg), n_slots=2, device='cpu')\n"
        "assert eng(np.array([1, 2]), max_new=2).shape == (2,)\n"
        "eng.shutdown()\n"
        "lm = p.models.QuantTransformerLM(16, 32, 2, 1, 32, 16, a_bits=1).eval()\n"
        "fm = p.infer.export_fused_decode(lm, device='cpu')\n"
        "eng = p.serve.DecodeEngine(lm, fused=fm, n_slots=2, device='cpu')\n"
        "out = eng(np.array([1, 2, 3]), max_new=3)\n"
        "eng.shutdown()\n"
        "assert out.shape == (3,)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'pytorch_quantize_impls_tpu') and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card_and_raise_without_one(tmp_path):
    """Without an explicit ``device="cpu"`` every entry point asks for the
    card; with no GPU it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults would run on it")
    from pytorch_quantize_impls_tpu_torch.utils import SCHEME_CONFIGS, RunConfig, build_model

    path = os.path.join(tmp_path, "m.npz")
    m = models.BNNLeNet(width=4).eval()
    infer.save_packed(path, infer.pack_model(m))
    lm = models.QuantTransformerLM(16, 32, 2, 1, 32, 16, a_bits=1).eval()
    fm = infer.export_fused_decode(lm, device="cpu")
    net = infer.export_fused_resnet20(models.DorefaResNet20(width=4).eval())
    calls = {
        "from_fused_resnet": lambda: InferenceEngine.from_fused_resnet(net, (16, 16, 3)),
        "build_model dorefa_resnet20": lambda: build_model(
            RunConfig(**SCHEME_CONFIGS["dorefa_resnet20"])),
        "load_packed": lambda: infer.load_packed(path),
        "InferenceEngine": lambda: InferenceEngine(lambda x: x, (2,)),
        "DecodeEngine": lambda: serve.DecodeEngine(lm),
        "build_model": lambda: build_model(RunConfig(**SCHEME_CONFIGS["bnn_lenet"])),
        "build_model logquant_vgg": lambda: build_model(RunConfig(**SCHEME_CONFIGS["logquant_vgg"])),
        "load_flax_variables": lambda: load_flax_variables(m, {"params": {}}),
        "export_fused_decode": lambda: infer.export_fused_decode(lm),
        "fused_init_cache": lambda: infer.fused_init_cache(fm, 2),
        "generate": lambda: serve.generate(lm, np.zeros((1, 2), np.int32), 2),
        "init_cache": lambda: lm.init_cache(2),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
            pytest.fail(f"{name} ran without a GPU")


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a CUDA GPU" in out.stderr
