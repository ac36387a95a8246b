"""Datasets and the input pipeline, in numpy.

Counterpart of ``pytorch_quantize_impls_tpu/data``: loaders read raw files
from ``$QTPU_DATA_DIR`` when present and otherwise make deterministic
*synthetic* classification tasks of the same shapes (fixed class templates
+ noise); ``digits`` is sklearn's bundled optdigits (imported on call),
``synthetic_digits`` a synthetic task of its shape.
"""

from pytorch_quantize_impls_tpu_torch.data.datasets import (  # noqa: F401
    cifar10,
    digits,
    iterate_batches,
    mnist,
    synthetic_digits,
    synthetic_image_classification,
)
