"""Dataset dispatch (JAX twin: ardae_tpu/data/__init__.py).

``get_dataset(name)`` returns ``{"train", "val", "test", "info"}`` with host
numpy float32 [N, D] splits; ``final_mode`` folds val into train. The MNIST
family and sbMNIST are ported; the toy datasets and mnist32 wait (ROADMAP
queue 1, slices 4 and 6).
"""

from .mnist import get_mnist, get_sbmnist

_IMAGE = ("mnist", "cmnist", "dbmnist", "dbmnist-val5k")
_LATER = {"mnist32": "slice 6 (mnist32)"}


def get_dataset(name, root="data", final_mode=False):
    if name in _IMAGE:
        return get_mnist(name, root=root, final_mode=final_mode)
    if name == "sbmnist":
        return get_sbmnist(root=root, final_mode=final_mode)
    raise NotImplementedError(
        f"dataset {name!r} is not ported yet: ROADMAP queue 1, "
        + _LATER.get(name, "slice 4 (toy data)"))
