"""Dataset dispatch (JAX twin: ardae_tpu/data/__init__.py).

``get_dataset(name)`` returns ``{"train", "val", "test", "info"}`` with host
numpy float32 [N, D] splits; ``final_mode`` folds val into train for the
image datasets (the toys have none). The MNIST family, sbMNIST and the toy
datasets are ported; mnist32 waits (ROADMAP queue 1, slice 6).
"""

from .mnist import get_mnist, get_sbmnist
from .toy import NAMES as _TOY
from .toy import get_toy_dataset

_IMAGE = ("mnist", "cmnist", "dbmnist", "dbmnist-val5k")


def get_dataset(name, root="data", final_mode=False, toy_sizes=None):
    if name in _TOY:
        return get_toy_dataset(name, root=root, sizes=toy_sizes)
    if name in _IMAGE:
        return get_mnist(name, root=root, final_mode=final_mode)
    if name == "sbmnist":
        return get_sbmnist(root=root, final_mode=final_mode)
    if name == "mnist32":
        raise NotImplementedError(
            "dataset 'mnist32' is not ported yet: ROADMAP queue 1, slice 6")
    raise NotImplementedError(f"unknown dataset: {name!r}")
