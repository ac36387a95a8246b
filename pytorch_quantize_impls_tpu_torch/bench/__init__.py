"""The port's GEMM measurements on the card, counterparts of the JAX
package's ``bench.py`` (``headline``), ``scripts/kernel_bench.py``
(``kernel_bench``) and ``scripts/mxu_probe.py`` (``mxu_probe``, which also
holds the probe's tiled-matmul kernel). Each runs as
``python -m pytorch_quantize_impls_tpu_torch.bench.<name>`` and refuses to
run without a CUDA GPU: a time taken on the CPU is not a device number."""
