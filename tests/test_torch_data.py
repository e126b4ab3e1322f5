"""The port's MNIST splits are byte-identical to ardae_tpu.data.get_dataset:
the synthetic surrogates (dbMNIST, sbMNIST, each also in final mode) and,
with idx or amat files on disk, the real-file paths."""

import os
import struct

import numpy as np
import pytest

from ardae_tpu.data import get_dataset as j_get
from ardae_tpu_torch.data import get_dataset as t_get


def _same(a, b, labels=True):
    for split in ("train", "val", "test"):
        if a[split] is None:
            assert b[split] is None, split
            continue
        assert a[split].dtype == b[split].dtype == np.float32
        assert a[split].tobytes() == b[split].tobytes(), split
    for split in ("train", "val", "test") if labels else ():
        if a["info"]["labels"][split] is None:
            assert b["info"]["labels"][split] is None
            continue
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


def test_final_mode_splits_identical(tmp_path):
    """Final mode trains on all 60,000 training images and has no val."""
    a = j_get("dbmnist-val5k", root=str(tmp_path / "jax"), final_mode=True)
    b = t_get("dbmnist-val5k", root=str(tmp_path / "port"), final_mode=True)
    assert b["train"].shape == (60_000, 784) and b["val"] is None
    _same(a, b)


@pytest.mark.parametrize("final_mode", [False, True])
def test_sbmnist_surrogate_identical(tmp_path, final_mode):
    a = j_get("sbmnist", root=str(tmp_path), final_mode=final_mode)
    b = t_get("sbmnist", root=str(tmp_path), final_mode=final_mode)
    assert b["info"]["synthetic"] and not b["info"]["binarize"]
    assert b["train"].shape == ((60_000 if final_mode else 50_000), 784)
    assert set(np.unique(b["train"])) == {0.0, 1.0}
    _same(a, b, labels=False)


def test_sbmnist_amat_files_identical(tmp_path):
    d = tmp_path / "bmnist"
    os.makedirs(d)
    rng = np.random.default_rng(1)
    for split, n in (("train", 7), ("valid", 3), ("test", 4)):
        rows = rng.integers(0, 2, (n, 784))
        (d / f"binarized_mnist_{split}.amat").write_text(
            "\n".join(" ".join(map(str, r)) for r in rows) + "\n")
    a = j_get("sbmnist", root=str(tmp_path))
    b = t_get("sbmnist", root=str(tmp_path))
    assert not b["info"]["synthetic"] and b["val"].shape == (3, 784)
    _same(a, b, labels=False)


def test_amat_reader_rejects_malformed_files(tmp_path):
    from ardae_tpu_torch.data.mnist import load_amat

    bad = tmp_path / "bad.amat"
    bad.write_text("0 1 0\n1 x 0\n")
    with pytest.raises(ValueError):
        load_amat(str(bad), 3)
    bad.write_text("0 1 0\n1 1\n")
    with pytest.raises(ValueError):
        load_amat(str(bad), 3)
    bad.write_text("")
    with pytest.raises(ValueError):
        load_amat(str(bad), 3)


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_get("mnist32")
