"""Toy 2-D datasets: swissroll, one Gaussian, three Gaussians and the
25-Gaussian grid (JAX twin: ardae_tpu/data/toy.py; reference
datasets/toy.py:55-345).

numpy draws every split from an explicit seed, so the arrays are byte for
byte the JAX package's: the same distributions, the same split sizes (2M
train / 2k val / 20k test by default), drawn in the same order (train, val,
test) from ``np.random.default_rng(20_200_616)``. The swiss roll is
sklearn's ``make_swiss_roll`` (noise 0.75, no hole) written out in numpy on
the same ``RandomState`` stream, so no sklearn is needed. The splits are
cached as ``.npz`` under ``<root>/toy``; nothing is downloaded.
"""

import math
import os

import numpy as np

_DEFAULT_SIZES = dict(train=2_000_000, test=20_000, val=2_000)
SEED = 20_200_616


def mixture_modes(name):
    """(means (N, 2), std) of the Gaussian-mixture toys."""
    if name == "25gaussians":
        # reference exp4 (datasets/toy.py:196-254): a 5 x 5 grid over
        # [-4, 4]^2, variance 0.1 a mode
        lin = np.linspace(-4.0, 4.0, 5)
        xv, yv = np.meshgrid(lin, lin)
        return np.stack([xv.ravel(), yv.ravel()], axis=1), math.sqrt(0.1)
    if name == "gaussian":
        return np.zeros((1, 2)), 1.0   # reference exp1 (:78-128)
    if name == "toy3":
        # reference exp3 (:125-185)
        return np.array([[2.0, 2.0], [2.0, -2.0], [-2.0, -2.0]]), 0.5
    raise NotImplementedError(f"no mixture modes for toy data: {name}")


def _sample_mixture(rng, num_data, mu, std):
    """Equal shares, block i holding mode i's samples (reference :216-224);
    the remainder goes to the first modes."""
    n_modes = mu.shape[0]
    counts = np.full(n_modes, num_data // n_modes, np.int64)
    counts[:num_data - counts.sum()] += 1
    x = np.empty((num_data, 2), np.float32)
    label = np.empty(num_data, np.int64)
    pos = 0
    for i, c in enumerate(counts):
        x[pos:pos + c] = rng.normal(mu[i], std, size=(c, 2))
        label[pos:pos + c] = i
        pos += c
    return x, label


def _swissroll(rng, num_data):
    """Reference get_swissroll (:55-76): sklearn's swiss roll, noise 0.75,
    the (x, z) plane over 3."""
    gen = np.random.RandomState(rng.integers(0, 2**31 - 1))
    t = 1.5 * np.pi * (1 + 2 * gen.uniform(size=num_data))
    y = 21 * gen.uniform(size=num_data)
    data = np.vstack((t * np.cos(t), y, t * np.sin(t)))
    data += 0.75 * gen.standard_normal(size=(3, num_data))
    x = (data.T[:, [0, 2]] / 3.0).astype(np.float32)
    return x, np.zeros(num_data, np.int64)


def _generate(name, rng, num_data):
    if name == "swissroll":
        return _swissroll(rng, num_data)
    return _sample_mixture(rng, num_data, *mixture_modes(name))


NAMES = ("swissroll", "gaussian", "toy3", "25gaussians")


def generate_toy_data(name, sizes=None, cache_dir="data/toy"):
    """{"train", "val", "test": (x float32 (N, 2), labels int64 (N,))},
    generated once and then read from the cache."""
    if name not in NAMES:
        raise NotImplementedError(f"no toy data: {name}")
    sizes = dict(_DEFAULT_SIZES, **(sizes or {}))
    os.makedirs(cache_dir, exist_ok=True)
    tag = "-".join(f"{k}{sizes[k]}" for k in ("train", "val", "test"))
    path = os.path.join(cache_dir, f"{name}-{tag}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return {s: (z[f"{s}_x"], z[f"{s}_y"]) for s in ("train", "val", "test")}
    rng = np.random.default_rng(SEED)
    splits = {s: _generate(name, rng, int(sizes[s])) for s in ("train", "val", "test")}
    np.savez_compressed(path, **{f"{s}_x": v[0] for s, v in splits.items()},
                        **{f"{s}_y": v[1] for s, v in splits.items()})
    return splits


def toy_logpdf(name):
    """The normalised log-density of a mixture toy, a numpy function of
    points (..., 2) (the reference computes these pdfs but returns None,
    datasets/toy.py:120-122). The swiss roll has no closed form: raises."""
    mu, std = mixture_modes(name)
    log_norm = -math.log(2.0 * math.pi * std * std)
    log_w = -math.log(mu.shape[0])

    def logpdf(x):
        d2 = np.sum((np.asarray(x, np.float64)[..., None, :] - mu) ** 2, axis=-1)
        a = log_w + log_norm - d2 / (2.0 * std * std)
        m = np.max(a, axis=-1, keepdims=True)
        return (m + np.log(np.sum(np.exp(a - m), axis=-1, keepdims=True)))[..., 0]

    return logpdf


def get_toy_dataset(name, root="data", sizes=None):
    """Splits and info as the other datasets give them; toys have no final
    mode (reference vae.py:271 forwards final_mode to image datasets only)."""
    splits = generate_toy_data(name, sizes=sizes,
                               cache_dir=os.path.join(root, "toy"))
    if name == "swissroll":
        logpdf, nclasses = None, 1
    else:
        logpdf, nclasses = toy_logpdf(name), mixture_modes(name)[0].shape[0]
    return {
        "train": splits["train"][0], "val": splits["val"][0],
        "test": splits["test"][0],
        "info": {"binarize": False, "center": False, "synthetic": False,
                 "nclasses": nclasses, "logpdf": logpdf,
                 "labels": {s: v[1] for s, v in splits.items()}},
    }
