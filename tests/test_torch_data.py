"""The port's MNIST splits are byte-identical to ardae_tpu.data.get_dataset:
the synthetic surrogate and, with idx files on disk, the real-file path."""

import os
import struct

import numpy as np
import pytest

from ardae_tpu.data import get_dataset as j_get
from ardae_tpu_torch.data import get_dataset as t_get


def _same(a, b):
    for split in ("train", "val", "test"):
        assert a[split].dtype == b[split].dtype == np.float32
        assert a[split].tobytes() == b[split].tobytes(), split
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(a["info"]["labels"][split],
                                      b["info"]["labels"][split])
    for k in ("binarize", "center", "synthetic", "image_size"):
        assert a["info"][k] == b["info"][k], k


@pytest.mark.parametrize("name", ["dbmnist-val5k", "dbmnist"])
def test_surrogate_splits_identical(tmp_path, name):
    # separate roots: each package computes and caches its own split
    a = j_get(name, root=str(tmp_path / "jax"))
    b = t_get(name, root=str(tmp_path / "port"))
    assert b["info"]["synthetic"] and b["info"]["binarize"]
    assert b["train"].shape == (60_000 - (5_000 if name.endswith("5k") else 10_000), 784)
    _same(a, b)


def _write_idx(path, arr, magic):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_real_idx_files_identical(tmp_path):
    raw = tmp_path / "MNIST" / "raw"
    os.makedirs(raw)
    rng = np.random.default_rng(0)
    _write_idx(raw / "train-images-idx3-ubyte", rng.integers(0, 256, (6_000, 28, 28)), 2051)
    _write_idx(raw / "t10k-images-idx3-ubyte", rng.integers(0, 256, (50, 28, 28)), 2051)
    _write_idx(raw / "train-labels-idx1-ubyte", rng.integers(0, 10, (6_000,)), 2049)
    _write_idx(raw / "t10k-labels-idx1-ubyte", rng.integers(0, 10, (50,)), 2049)
    a = j_get("dbmnist-val5k", root=str(tmp_path))
    os.remove(tmp_path / "MNIST" / "dbmnist-val5k-val5000-split.npz")
    b = t_get("dbmnist-val5k", root=str(tmp_path))
    assert not b["info"]["synthetic"]
    _same(a, b)


def test_unported_datasets_raise():
    for name in ("sbmnist", "25gaussians", "mnist32"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_get(name)
