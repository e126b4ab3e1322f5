"""Dataset dispatch (JAX twin: ardae_tpu/data/__init__.py).

``get_dataset(name)`` returns ``{"train", "val", "test", "info"}`` with host
numpy float32 [N, D] splits; ``final_mode`` folds val into train for the
image datasets (the toys have none). Every dataset of the JAX package is
ported: the MNIST family (mnist32 among it), sbMNIST and the toy datasets;
another name raises NotImplementedError.
"""

from .mnist import get_image_dataset
from .toy import NAMES as _TOY
from .toy import get_toy_dataset


def get_dataset(name, root="data", final_mode=False, toy_sizes=None):
    if name in _TOY:
        return get_toy_dataset(name, root=root, sizes=toy_sizes)
    return get_image_dataset(name, root=root, final_mode=final_mode)
