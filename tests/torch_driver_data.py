"""The datasets of the port's driver tests (tests/test_torch_cli*.py).

``shared_datasets`` (autouse where imported) memoises the drivers'
get_dataset by (name, final mode) for the life of the test process: every
driver run of these tests reads the synthetic MNIST surrogate, which takes
seconds to make and is the same for any data root. ``small_splits`` cuts
val and test to 64 items so eval runs take seconds.
"""

import pytest

_MADE = {}


@pytest.fixture(autouse=True)
def shared_datasets(monkeypatch):
    import ardae_tpu_torch.data as data

    real = data.get_dataset

    def get_dataset(name, root="data", final_mode=False):
        key = (name, final_mode)
        if key not in _MADE:
            _MADE[key] = real(name, root=root, final_mode=final_mode)
        return dict(_MADE[key])

    monkeypatch.setattr(data, "get_dataset", get_dataset)


@pytest.fixture
def small_splits(monkeypatch, shared_datasets):
    """The driver's get_dataset with val and test cut to 64 items."""
    import ardae_tpu_torch.data as data

    full = data.get_dataset

    def get_dataset(name, root="data", final_mode=False):
        s = full(name, root=root, final_mode=final_mode)
        s["val"] = None if s["val"] is None else s["val"][:64]
        s["test"] = s["test"][:64]
        return s

    monkeypatch.setattr(data, "get_dataset", get_dataset)
