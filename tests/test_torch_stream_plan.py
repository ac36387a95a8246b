"""The launch plan of the streamed GEMMs K1 ``binary_gemm``, K6
``dorefa_gemm`` and K8 ``shift_gemm`` (``kernels/common.py``
``stream_plan``), on the CPU.

The CUDA kernels (``csrc/stream_tile.cuh``) split K into the plan's chunks
where the output grid is small and sum the chunks' partials in index order.
Here: the plan at every shape the port gives the two kernels, a property
over random shapes, and the split itself through the plain versions: exact
for K6's int32 sums, within the K8 gate of ``chip_smoke.py`` for float32
partials, both held to the JAX package's functions on the same inputs.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu_torch.bench import stream_sweep
from pytorch_quantize_impls_tpu_torch.kernels import common
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as tpm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as tsm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as tbg

jpm = sys.modules["pytorch_quantize_impls_tpu.kernels.packed_matmul"]
jsm = sys.modules["pytorch_quantize_impls_tpu.kernels.shift_matmul"]
STAGE_K = {"dorefa_gemm": tpm.STAGE_K, "shift_gemm": tsm.STAGE_K, "binary_gemm": tbg.STAGE_K}


def _lm_shapes():
    d, ff = chip_smoke.LM_CFG["d_model"], chip_smoke.LM_CFG["d_ff"]
    return [(f"lm {name} M={m}", m, k, n) for name, k, n in chip_smoke.lm_gemms(chip_smoke.LM_CFG)
            for m in (1, 8, 32, 128)] + [("lm d", 32, d, ff)]


# (label, M, K, N): every shape the port's paths and chip_smoke.py give K1, K6
# and K8 (BNN LeNet's fc1 and head: K1's)
SHAPES = _lm_shapes() + [
    *[(f"lenet {name} M={m}", m, k, n) for name, k, n in (("fc1", 4096, 1024), ("head", 1024, 10))
      for m in (1, 16, 256)],
    *[(f"vgg head M={m}", m, 512 * 4 * 4, 10) for m in (1, 16, 256)],
    ("resnet im2col stage1 conv1", chip_smoke.RESNET_IM2COL_BATCH * 256,
     9 * chip_smoke.RESNET_WIDTH, 2 * chip_smoke.RESNET_WIDTH),
    ("vgg im2col conv3", chip_smoke.VGG_IM2COL_BATCH * 256, 9 * 256, 256),
    ("headline 4096^3", 4096, 4096, 4096),
    # chip_smoke.py's edges and splits
    ("edge M=1 K=576 N=64", 1, 576, 64), ("edge M=33 K=2304 N=130", 33, 2304, 130),
    ("edge M=17 K=301 N=64", 17, 301, 64), ("edge M=64 K=700 N=24", 64, 700, 24),
    ("edge M=5 K=300 N=40", 5, 300, 40), ("edge M=8 K=1500 N=24", 8, 1500, 24),
    ("edge M=3 K=64 N=8", 3, 64, 8), ("edge M=1 K=27 N=128", 1, 27, 128),
    ("edge M=33 K=300 N=10", 33, 300, 10), ("edge M=70 K=2100 N=130", 70, 2100, 130),
    ("edge M=5 K=128 N=65", 5, 128, 65), ("split M=1 K=300 N=10", 1, 300, 10),
    ("split M=65 K=1500 N=130", 65, 1500, 130), ("split M=65 K=2100 N=130", 65, 2100, 130),
    ("split M=8 K=2100 N=64", 8, 2100, 64), ("split M=65 K=1501 N=130", 65, 1501, 130),
    ("split M=256 K=8192 N=10", 256, 8192, 10), ("split M=32 K=1024 N=1024", 32, 1024, 1024),
    ("split M=65 K=300 N=10", 65, 300, 10), ("split M=1 K=1500 N=10", 1, 1500, 10),
    ("split M=1 K=1501 N=10", 1, 1501, 10), ("split M=1 K=2100 N=10", 1, 2100, 10),
]


def check_plan(m: int, n: int, k: int, stage_k: int):
    """Every rule of the plan; returns it with its chunks [(k0, k1)]."""
    bm, s, chunk = common.stream_plan(m, n, k, stage_k)
    stages = -(-k // stage_k)
    grid = -(-m // bm) * -(-n // common.STREAM_BN)
    big = -(-m // 128) * -(-n // common.STREAM_BN) >= 2 * common.STREAM_SMS
    assert bm == (32 if m <= 32 else 128 if big else 64)
    assert s >= 1 and chunk % stage_k == 0
    # the chunks tile [0, Kp) on stage boundaries, none empty
    kp = stages * stage_k
    chunks = [(z * chunk, min((z + 1) * chunk, kp)) for z in range(s)]
    assert all(k1 > k0 for k0, k1 in chunks) or kp == 0
    assert chunks[0][0] == 0 and chunks[-1][1] == kp
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert s == 1 or bm <= 64  # only 32- and 64-row tiles split
    if 2 * grid > common.STREAM_SMS or stages <= common.STREAM_MIN_CHUNK:
        assert s == 1  # the tile grid alone fills the card, or K is too short
    else:
        # at its cap every chunk holds the fewest stages a chunk may
        assert grid * s >= common.STREAM_SMS or chunk == common.STREAM_MIN_CHUNK * stage_k
    assert s == 1 or chunk >= common.STREAM_MIN_CHUNK * stage_k
    assert common.stream_workspace_bytes(m, n, s) <= common.STREAM_WORKSPACE_CAP
    # a pure function of the shape: the same plan when computed anew
    common.stream_plan.cache_clear()
    assert common.stream_plan(m, n, k, stage_k) == (bm, s, chunk)
    return (bm, s, chunk), chunks


@pytest.mark.parametrize("kernel", sorted(STAGE_K))
@pytest.mark.parametrize("label,m,k,n", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_at_the_ports_shapes(kernel, label, m, k, n):
    (bm, s, _), _ = check_plan(m, n, k, STAGE_K[kernel])
    if label.startswith("split"):
        assert s > 1, "chip_smoke.py's split cases must split K"
    if label.startswith(("resnet", "vgg im2col", "headline")):
        assert s == 1  # large grids keep the single-pass write


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 5000), n=st.integers(1, 5000), k=st.integers(0, 20000),
       kernel=st.sampled_from(sorted(STAGE_K)))
def test_plan_property(m, n, k, kernel):
    check_plan(m, n, k, STAGE_K[kernel])


@pytest.mark.parametrize("case", stream_sweep.CASES, ids=lambda c: f"{c[0]} {c[1]}x{c[2]}x{c[3]}")
def test_sweep_plans(case):
    """bench/stream_sweep.py's forced plans are whole plans: a tile height
    the kernels have, chunks of whole stages covering K, none empty; the
    first is stream_plan's own."""
    kernel, m, k, n, others = case
    stage_k = STAGE_K[kernel]
    assert stream_sweep.plan_of(m, n, k, stage_k, common.stream_plan(m, n, k, stage_k)[0]) == (
        common.stream_plan(m, n, k, stage_k))
    stages = -(-k // stage_k)
    for bm, splits in others:
        bm_, s, chunk = stream_sweep.plan_of(m, n, k, stage_k, bm, splits)
        assert bm_ in (32, 64, 128) and chunk % stage_k == 0
        assert (s - 1) * chunk < stages * stage_k <= s * chunk
        if splits is not None:
            assert s == splits


def test_sweep_refuses_without_a_gpu():
    with pytest.raises(RuntimeError, match="times the card"):
        stream_sweep.run("cpu")


def test_workspace_bytes():
    assert common.stream_workspace_bytes(32, 4096, 1) == 0
    assert common.stream_workspace_bytes(32, 4096, 4) == 4 * 4 * 32 * 4096


# (M, K, N, bits) narrowed from the serving shapes (LM d 1024 -> 256, the VGG
# head's 8192 -> 2048), each split by its plan
SPLIT_SHAPES = [(32, 1024, 512, 4), (8, 1024, 256, 2), (1, 300, 10, 4), (64, 2048, 10, 1),
                (65, 1500, 130, 4)]


@pytest.mark.parametrize("m,k,n,w_bits", SPLIT_SHAPES)
def test_dorefa_split_is_exact(m, k, n, w_bits):
    """K6: int64 partials per chunk, summed in any order, give the unsplit
    sum exactly, and with the one f32 epilogue the plain version's and the
    JAX function's bits."""
    a_bits = 4
    rng = np.random.default_rng(m + k + n)
    wq = np.asarray(jops.dorefa_weight(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)),
                                       w_bits))
    jw = jpm.pack_dorefa_weights(jnp.asarray(wq), w_bits)
    tw = torch.from_numpy(np.asarray(jw).view(np.int32).copy())
    a = rng.integers(0, 2**a_bits, size=(m, k)).astype(np.int8)
    (_, s, _), chunks = check_plan(m, n, k, tpm.STAGE_K)
    assert s > 1
    d = tpm.decode_dorefa_weights_reference(tw, w_bits=w_bits).to(torch.int64)
    x = torch.from_numpy(a).to(torch.int64)
    parts = [x[:, k0:min(k1, k)] @ d[k0:min(k1, k)] for k0, k1 in chunks]
    whole = x @ d[:k]
    assert torch.equal(sum(parts), whole) and torch.equal(sum(reversed(parts)), whole)
    got = whole.to(torch.float32) * torch.tensor(tpm.inv_scale(w_bits, a_bits))
    ref = tpm.dorefa_gemm_reference(torch.from_numpy(a), tw, w_bits=w_bits, a_bits=a_bits)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jpm.dorefa_gemm_reference(jnp.asarray(a), jw, w_bits=w_bits, a_bits=a_bits)))


@pytest.mark.parametrize("m,k,n,fsr,bits", [(32, 256, 512, 0.0, 4), (8, 1024, 256, 1.0, 4),
                                            (1, 300, 10, 0.0, 3), (64, 2048, 10, 1.0, 4),
                                            (65, 1501, 130, 1.0, 6)])
def test_shift_split_within_the_gate(m, k, n, fsr, bits):
    """K8: float32 partials per chunk (each the exact chunk sum rounded
    once), added in index order, stay within SHIFT_RTOL (|bf16(x)| @ |w|) of
    the plain version and of the JAX function."""
    rng = np.random.default_rng(m + k + n + bits)
    w = (rng.normal(size=(k, n)) * (2.0 / k) ** 0.5).astype(np.float32)
    jw = jsm.pack_log_weights(jnp.asarray(w), fsr, bits)
    tw = torch.from_numpy(np.asarray(jw).view(np.int32).copy())
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    (_, s, _), chunks = check_plan(m, n, k, tsm.STAGE_K)
    assert s > 1
    wd = tsm.decode_log_weights_reference(tw, fsr=fsr, bits=bits)[:k].to(torch.float64)
    xb = x.to(torch.bfloat16).to(torch.float64)
    split = torch.zeros(m, n, dtype=torch.float32)
    for k0, k1 in chunks:
        k1 = min(k1, k)
        split = split + (xb[:, k0:k1] @ wd[k0:k1]).to(torch.float32)
    bound = xb.abs() @ wd.abs()
    ref = tsm.shift_gemm_reference(x, tw, fsr=fsr, bits=bits)
    jref = torch.from_numpy(np.array(jsm.shift_gemm_reference(jnp.asarray(x.numpy()), jw,
                                                              fsr=fsr, bits=bits)))
    for other in (ref, jref):
        assert ((split.double() - other.double()).abs()
                <= chip_smoke.SHIFT_RTOL * bound).all()
