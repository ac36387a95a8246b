"""The port's host codec (``utils.native``) and device-free export
(``infer.host_export``) held against the JAX package's and against the
port's own ``pack_model``.

JAX's ``_Zoo`` (``tests/test_native.py``: one quantized layer of every
packable scheme, seven dense and two conv) is rebuilt in the port from the
same weights (through the bridge). The port's ``host_pack_model`` must equal
its ``pack_model`` exactly (the same codes, packed by the host codec) and
JAX's ``host_pack_model`` in the words bit for bit and the record fields,
with alpha within 1e-6 relative (the two packages sum ``|W|`` in other
orders); the artifact it writes loads in both packages.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pytorch_quantize_impls_tpu import infer as jinfer
from pytorch_quantize_impls_tpu.infer import host_export as jhost
from pytorch_quantize_impls_tpu.nn.base import QuantConv as JQuantConv
from pytorch_quantize_impls_tpu.nn.base import QuantDense as JQuantDense
from pytorch_quantize_impls_tpu.ops import pack as jpack
from pytorch_quantize_impls_tpu_torch import data, infer, models, train
from pytorch_quantize_impls_tpu_torch.infer import host_export
from pytorch_quantize_impls_tpu_torch.nn import QuantConv, QuantDense
from pytorch_quantize_impls_tpu_torch.ops import pack
from pytorch_quantize_impls_tpu_torch.utils import CheckpointManager, load_flax_variables, native

RNG = np.random.default_rng(7)
ALPHA_RTOL = 1e-6

# (name, scheme, w_bits, a_bits, fsr) of the zoo's dense layers, then its convs
ZOO_DENSE = (("binary", 1, 1, 0.0), ("xnor", 1, 1, 0.0), ("dorefa", 4, 4, 0.0),
             ("dorefa", 1, 0, 0.0), ("log", 4, 0, 1.0), ("lin", 4, 0, 1.0),
             ("ternary", 1, 0, 0.0))
ZOO_CONV = (("binary", 1, 1), ("xnor", 1, 1))


class _JZoo(fnn.Module):
    """``tests/test_native.py``'s ``_Zoo``."""

    @fnn.compact
    def __call__(self, x, train: bool = True):
        for scheme, w_bits, a_bits, fsr in ZOO_DENSE:
            x = JQuantDense(features=16, scheme=scheme, w_bits=w_bits, a_bits=a_bits, fsr=fsr)(x)
        x = x.reshape(x.shape[0], 4, 4, 1)
        for i, (scheme, w_bits, a_bits) in enumerate(ZOO_CONV):
            x = JQuantConv(features=8, kernel_size=(3, 3), scheme=scheme, w_bits=w_bits,
                           a_bits=a_bits)(x)
        return x.reshape(x.shape[0], -1)


class _Zoo(nn.Module):
    """The port's ``_Zoo``: the same layers under flax's automatic names."""

    def __init__(self):
        super().__init__()
        for i, (scheme, w_bits, a_bits, fsr) in enumerate(ZOO_DENSE):
            setattr(self, f"QuantDense_{i}", QuantDense(16, 16, scheme=scheme, w_bits=w_bits,
                                                        a_bits=a_bits, fsr=fsr))
        for i, (scheme, w_bits, a_bits) in enumerate(ZOO_CONV):
            setattr(self, f"QuantConv_{i}", QuantConv(1 if i == 0 else 8, 8, (3, 3),
                                                      scheme=scheme, w_bits=w_bits,
                                                      a_bits=a_bits))

    def forward(self, x):
        for i in range(len(ZOO_DENSE)):
            x = getattr(self, f"QuantDense_{i}")(x)
        x = x.reshape(x.shape[0], 4, 4, 1)
        for i in range(len(ZOO_CONV)):
            x = getattr(self, f"QuantConv_{i}")(x)
        return x.reshape(x.shape[0], -1)


@pytest.fixture(scope="module")
def zoo():
    """(JAX model, its variables as numpy, the port's model from them, x)."""
    x = RNG.normal(size=(2, 16)).astype(np.float32)
    jm = _JZoo()
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)))
    model = load_flax_variables(_Zoo(), variables, device="cpu").eval()
    return jm, variables, model, x


def _artifact(path):
    with np.load(path, allow_pickle=False) as f:
        return json.loads(str(f["__meta__"])), {k: f[k] for k in f.files if k != "__meta__"}


def _w1_dorefa(rec) -> bool:
    return rec.scheme == "dorefa" and rec.w_bits == 1


def _assert_records_equal(ours, theirs, alpha_rtol=0.0, jax=False) -> None:
    """Packed words bit for bit, the record fields equal, alpha within
    ``alpha_rtol``. Against the JAX package's (``jax``), a one-bit DoReFa
    record carries the port's alpha (its E|W|, which JAX's packing drops)
    where JAX's has none."""
    assert set(ours) == set(theirs)
    for path in ours:
        a, b = ours[path], theirs[path]
        assert (a.kind, a.scheme, a.w_bits, a.a_bits, a.fsr, tuple(a.kernel_shape)) == (
            b.kind, b.scheme, b.w_bits, b.a_bits, b.fsr, tuple(b.kernel_shape)), path
        wa, wb = (np.asarray(r.packed).view(np.uint32) for r in (a, b))
        np.testing.assert_array_equal(wa, wb, err_msg=str(path))
        if jax and _w1_dorefa(a):
            assert a.alpha is not None and b.alpha is None, path
            continue
        assert (a.alpha is None) == (b.alpha is None), path
        if a.alpha is not None:
            np.testing.assert_allclose(np.asarray(a.alpha), np.asarray(b.alpha),
                                       rtol=alpha_rtol, atol=0, err_msg=str(path))


def test_native_builds_and_loads():
    assert native.available(), "the host codec should build with g++; see stderr"
    assert native.library_path().parent.parent.name == "csrc"
    assert native.library_path().parent.parent.parent.name == "pytorch_quantize_impls_tpu_torch"


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [32, 100, 1500])
def test_planar_codec_matches_port_and_jax(bits, k):
    """The host codec's grouped-planar words against the port's torch
    packer and JAX's, batched too."""
    codes = RNG.integers(0, 2**bits, size=(k, 40)).astype(np.int32)
    got = native.pack_bitplanes(codes, bits)
    np.testing.assert_array_equal(
        got, pack.pack_bitplanes(torch.from_numpy(codes), bits).numpy().view(np.uint32))
    np.testing.assert_array_equal(got, np.asarray(jpack.pack_bitplanes(jnp.asarray(codes),
                                                                       bits)))
    batched = RNG.integers(0, 2**bits, size=(3, k, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        native.pack_bitplanes(batched, bits),
        pack.pack_bitplanes(torch.from_numpy(batched), bits).numpy().view(np.uint32))


def test_numpy_fallback_parity(monkeypatch):
    """Without the library the numpy fallback writes the same words, and
    the host export the same records."""
    codes = {bits: RNG.integers(0, 2**bits, size=(2, 1100, 20)).astype(np.int32)
             for bits in (1, 2, 4, 8)}
    with_lib = {bits: native.pack_bitplanes(c, bits) for bits, c in codes.items()}
    model = nn.Sequential()
    model.add_module("q", QuantDense(1100, 20, scheme="dorefa", w_bits=2, a_bits=2))
    exported = host_export.host_pack_model(model)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    for bits, c in codes.items():
        np.testing.assert_array_equal(native.pack_bitplanes(c, bits), with_lib[bits])
    _assert_records_equal(host_export.host_pack_model(model), exported)


def test_host_export_matches_device_pack_and_jax(zoo):
    jm, variables, model, x = zoo
    host = host_export.host_pack_model(model)
    assert len(host) == 9
    assert all(r.packed.dtype == torch.int32 for r in host.values())
    _assert_records_equal(host, infer.pack_model(model))
    _assert_records_equal(host, jhost.host_pack_model(jm, variables, jnp.asarray(x)),
                          alpha_rtol=ALPHA_RTOL, jax=True)


def test_host_artifact_loads_in_both_packages(zoo, tmp_path):
    """The host export's artifact holds the arrays and records of
    ``pack_model`` + ``save_packed``; JAX's ``packed_apply`` gives on it the
    logits it gives on its own pack with the port's alpha in the one-bit
    DoReFa record (within ALPHA_RTOL: alpha), and the port's on it those of
    its own."""
    jm, variables, model, x = zoo
    path, ref = tmp_path / "host.npz", tmp_path / "device.npz"
    assert host_export.export_packed(str(path), model) == 9
    infer.save_packed(str(ref), infer.pack_model(model))
    (meta, arrays), (meta_ref, arrays_ref) = _artifact(path), _artifact(ref)
    assert meta == meta_ref and arrays.keys() == arrays_ref.keys()
    for k in arrays:
        assert arrays[k].dtype == arrays_ref[k].dtype, k
        np.testing.assert_array_equal(arrays[k], arrays_ref[k], err_msg=k)
    xj = jnp.asarray(x)
    apply = jax.jit(lambda packed: jinfer.packed_apply(jm, variables, packed, xj))
    theirs = jinfer.load_packed(str(path))
    own = jinfer.pack_model(jm, variables, xj)
    w1 = [k for k, rec in theirs.items() if _w1_dorefa(rec)]
    assert len(w1) == 1 and own[w1[0]].alpha is None
    own = {**own, w1[0]: own[w1[0]].replace(alpha=theirs[w1[0]].alpha)}
    theirs, own = apply(theirs), apply(own)
    np.testing.assert_allclose(np.asarray(theirs), np.asarray(own), rtol=1e-6, atol=1e-6)
    ours = infer.packed_apply(model, infer.load_packed(str(path), device="cpu"),
                              torch.from_numpy(x))
    own = infer.packed_apply(model, infer.pack_model(model), torch.from_numpy(x))
    assert torch.equal(ours, own)


def test_host_export_refuses_what_pack_model_refuses():
    model = nn.Sequential()
    model.add_module("q", QuantDense(8, 4, scheme="log", w_bits=4, a_bits=4, fsr=1.0))
    for fn in (infer.pack_model, host_export.host_pack_model):
        with pytest.raises(NotImplementedError, match="quantize_input"):
            fn(model)
    model.q.scheme = "elastic"
    for fn in (infer.pack_model, host_export.host_pack_model):
        with pytest.raises(ValueError, match="unpackable scheme"):
            fn(model)
    model.q.scheme = "binary"
    with pytest.raises(ValueError, match="on the CPU"):
        host_export.host_pack_model(model.to("meta"))


def test_export_cli_from_a_checkpoint(tmp_path, capsys):
    """``python -m ...infer.host_export`` from a ``train.run``-style
    checkpoint of binaryconnect_mlp (a few steps, then a newer torn one):
    the artifact equals ``pack_model`` + ``save_packed`` of the checkpoint's
    weights, and the CLI says which codec ran."""
    model = models.BinaryConnectMLP(784)
    state = train.QuantTrainState.create_for(
        model, optimizer=train.QuantizedAdam(model.parameters(), lr=3e-3))
    step = train.make_train_step()
    batches = data.iterate_batches(data.mnist(flatten=True)[0], 32)
    for _ in range(3):
        step(state, next(batches))
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(state)
    ref = tmp_path / "ref.npz"
    infer.save_packed(str(ref), infer.pack_model(model))
    step(state, next(batches))
    mgr.save(state)
    mgr.path(4).write_bytes(b"torn")
    out = tmp_path / "m.npz"
    assert host_export.main(["--config", "binaryconnect_mlp", "--checkpoint-dir",
                             str(tmp_path / "ck"), "--out", str(out)]) == 0
    assert "(step 3, native C++)" in capsys.readouterr().out
    assert mgr.all_steps() == [3]  # the torn step 4 was set aside
    (meta, arrays), (meta_ref, arrays_ref) = _artifact(out), _artifact(ref)
    assert meta == meta_ref and arrays.keys() == arrays_ref.keys()
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], arrays_ref[k], err_msg=k)
    assert host_export.main(["--config", "binaryconnect_mlp", "--checkpoint-dir",
                             str(tmp_path / "none"), "--out", str(out)]) == 1
