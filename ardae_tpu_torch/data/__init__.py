"""Dataset dispatch (JAX twin: ardae_tpu/data/__init__.py).

``get_dataset(name)`` returns ``{"train", "val", "test", "info"}`` with host
numpy float32 [N, D] splits. The MNIST family is ported; the toy datasets
and sbmnist wait (ROADMAP queue 1, slices 2 and 4).
"""

from .mnist import get_mnist

_IMAGE = ("mnist", "cmnist", "dbmnist", "dbmnist-val5k")
_LATER = {"sbmnist": "slice 2 (sbmnist)", "mnist32": "slice 6 (mnist32)"}


def get_dataset(name, root="data", final_mode=False):
    if name in _IMAGE:
        return get_mnist(name, root=root, final_mode=final_mode)
    raise NotImplementedError(
        f"dataset {name!r} is not ported yet: ROADMAP queue 1, "
        + _LATER.get(name, "slice 4 (toy data)"))
