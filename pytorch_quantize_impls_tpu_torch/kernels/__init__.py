"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with its
plain PyTorch version beside it. A wrapper launches its kernel for CUDA
tensors (or raises) and runs the plain version for CPU tensors; kernels are
built with nvcc at first launch (``kernels._build``)."""

from pytorch_quantize_impls_tpu_torch.kernels.xnor_gemm import (  # noqa: F401
    binarize_to_int8,
    binary_gemm,
    binary_gemm_decoded,
    binary_gemm_reference,
    decode_binary_weights,
    decode_binary_weights_reference,
    pack_binary_weights,
)
from pytorch_quantize_impls_tpu_torch.kernels.int8_matmul import (  # noqa: F401
    int8_gemm,
    int8_gemm_reference,
)
from pytorch_quantize_impls_tpu_torch.kernels.packed_matmul import (  # noqa: F401
    decode_dorefa_weights,
    decode_dorefa_weights_reference,
    dorefa_act_to_int8,
    dorefa_gemm,
    dorefa_gemm_decoded,
    dorefa_gemm_reference,
    pack_dorefa_weights,
)
from pytorch_quantize_impls_tpu_torch.kernels.shift_matmul import (  # noqa: F401
    decode_log_weights,
    decode_log_weights_reference,
    pack_log_weights,
    shift_gemm,
    shift_gemm_decoded,
    shift_gemm_reference,
)
from pytorch_quantize_impls_tpu_torch.kernels.int8_conv import (  # noqa: F401
    int8_conv2d,
    int8_conv2d_reference,
)
# the module kernels.decode_attention is imported by name, not re-exported:
# its function shares its name
from pytorch_quantize_impls_tpu_torch.kernels import decode_attention  # noqa: F401
