"""PyTorch/CUDA port of ``pytorch_quantize_impls_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference this port is held against: both
run the same numpy inputs and must agree bit for bit where the reference is
integer-exact. Sub-packages and modules keep the JAX package's names, so each
counterpart is easy to find. The port imports ``torch`` and never ``jax``.

Ported so far, each through hand-written CUDA kernels (``kernels``, sources
in ``csrc/``): packed serving of the BNN LeNet (``utils.config`` entry
``bnn_lenet``); decode serving of the 1-bit transformer LM (fused step,
int8 KV cache); and DoReFa serving, the ResNet-20 packed and fused
(``dorefa_resnet20``) and the transformer LM packed (``scheme="dorefa"``).
On a CPU tensor each kernel wrapper runs its plain PyTorch version instead.
ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

from pytorch_quantize_impls_tpu_torch import (  # noqa: F401
    infer,
    kernels,
    models,
    nn,
    ops,
    serve,
    utils,
)
