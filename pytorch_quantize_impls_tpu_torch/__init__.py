"""PyTorch/CUDA port of ``pytorch_quantize_impls_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference this port is held against: both
run the same numpy inputs and must agree bit for bit where the reference is
integer-exact. Sub-packages and modules keep the JAX package's names, so each
counterpart is easy to find. The port imports ``torch`` and never ``jax``.

Ported so far, each through hand-written CUDA kernels (``kernels``, sources
in ``csrc/``): packed serving of the BNN LeNet (``utils.config`` entry
``bnn_lenet``); decode serving of the 1-bit transformer LM (fused step,
int8 KV cache); DoReFa serving, the ResNet-20 packed and fused
(``dorefa_resnet20``) and the transformer LM packed (``scheme="dorefa"``);
log-quant serving (``logquant_vgg``, ``scheme="log"``); and the GEMM
measurements at 4096^3 (``bench``: the headline bench, the kernel bench and
the tensor-core dtype probe). Training (``train``, ``data``) runs the
STE fake-quant steps of the MLPs (``binaryconnect_mlp``, the digits
configs) and of ``bnn_lenet`` in plain PyTorch, as the JAX package runs them
in XLA; the trained weights serve through the kernels. On a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.
ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

from pytorch_quantize_impls_tpu_torch import (  # noqa: F401
    data,
    infer,
    kernels,
    models,
    nn,
    ops,
    parallel,
    serve,
    train,
    utils,
)
