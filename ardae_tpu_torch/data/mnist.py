"""MNIST splits (JAX twin: ardae_tpu/data/mnist.py): dynamically binarized
MNIST (mnist, cmnist, dbmnist, dbmnist-val5k), the gray 32 x 32 mnist32,
Larochelle's statically binarized MNIST (sbmnist), and 3-channel
StackedMNIST items (``make_stacked_mnist``).

Real files are used when present: idx files under ``{root}/MNIST/raw/``,
amat files under ``{root}/bmnist/``; otherwise a deterministic
class-structured synthetic surrogate stands in and ``info["synthetic"]``
says so. The train/val split permutation is seeded and cached under
``{root}/MNIST/``. The arrays are byte-identical to the JAX package's (the
tests check it). Splits are float32 numpy [N, 784] ([N, 1024] for
mnist32); the driver moves them to the device once.
"""

import os
import struct
import warnings

import numpy as np

_N_TRAIN, _N_TEST = 60_000, 10_000
_SB_TRAIN, _SB_VAL, _SB_TEST = 50_000, 10_000, 10_000


# ----------------------------- idx readers --------------------------------

def _read_idx(path, magic_expected):
    with open(path, "rb") as f:
        header = f.read(4)
        if len(header) < 4:
            return None
        magic = struct.unpack(">I", header)[0]
        if magic != magic_expected:
            return None
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        payload = np.frombuffer(f.read(), dtype=np.uint8)
    if payload.size != int(np.prod(dims)):
        return None
    return payload.reshape(dims)


def load_idx_images(path):
    """idx3-ubyte images -> float32 [N, H*W] in [0, 1]; None if absent."""
    if not os.path.exists(path):
        return None
    arr = _read_idx(path, 2051)
    if arr is None:
        return None
    return arr.reshape(arr.shape[0], -1).astype(np.float32) / 255.0


def load_idx_labels(path):
    """idx1-ubyte labels -> int64 [N]; None if absent."""
    if not os.path.exists(path):
        return None
    arr = _read_idx(path, 2049)
    return None if arr is None else arr.astype(np.int64)


def load_amat(path, n_cols):
    """Whitespace-separated text matrix -> float32 [N, n_cols] (a one-time
    host parse); the values are one flat stream, which must fill whole
    rows."""
    with warnings.catch_warnings():
        # numpy warns, and stops, at text it cannot parse
        warnings.simplefilter("error", DeprecationWarning)
        try:
            flat = np.fromfile(path, dtype=np.float32, sep=" ")
        except DeprecationWarning as e:
            raise ValueError(f"{path}: {e}") from None
    if flat.size == 0 or flat.size % n_cols:
        raise ValueError(
            f"{path}: {flat.size} values do not fill rows of {n_cols}")
    return flat.reshape(-1, n_cols)


# ------------------------- synthetic surrogate -----------------------------

def _upsample_bilinear_field(f, out):
    """[h, w] -> [out, out] align-corners bilinear (template synthesis)."""
    h, w = f.shape
    yi = np.linspace(0, h - 1, out)
    xi = np.linspace(0, w - 1, out)
    y0 = np.clip(yi.astype(np.int64), 0, h - 2)
    x0 = np.clip(xi.astype(np.int64), 0, w - 2)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    a = f[y0][:, x0]
    b = f[y0][:, x0 + 1]
    c = f[y0 + 1][:, x0]
    d = f[y0 + 1][:, x0 + 1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def _class_templates(n_classes=10, size=28, seed=777):
    """Crisp per-class ink patterns in [0, 1]: a steep sigmoid over a smooth
    random field (exactly-0 background, mostly saturated ink)."""
    rng = np.random.default_rng(seed)
    tpl = np.empty((n_classes, size, size), np.float32)
    for c in range(n_classes):
        field = _upsample_bilinear_field(rng.normal(size=(7, 7)), size)
        field = (field - field.mean()) / (field.std() + 1e-8)
        tpl[c] = 1.0 / (1.0 + np.exp(-12.0 * (field - 1.1)))
    return tpl


def _synthetic_mnist(n, seed):
    """Class template + small integer shift + amplitude jitter + ink-masked
    pixel noise, clipped to [0, 1], background snapped to exactly 0."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    tpl = _class_templates()
    imgs = tpl[labels].copy()
    sx = rng.integers(-2, 3, n)
    sy = rng.integers(-2, 3, n)
    for dx in range(-2, 3):
        for dy in range(-2, 3):
            m = (sx == dx) & (sy == dy)
            if m.any():
                imgs[m] = np.roll(np.roll(imgs[m], dx, axis=1), dy, axis=2)
    amp = rng.uniform(0.9, 1.0, (n, 1, 1)).astype(np.float32)
    noise = rng.normal(0.0, 0.08, (n, 28, 28)).astype(np.float32)
    out = imgs * amp + noise * (imgs > 0.05)
    out = np.clip(out, 0.0, 1.0).astype(np.float32)
    out[out < 1e-3] = 0.0
    return out.reshape(n, 784), labels.astype(np.int64)


def _load_mnist_arrays(root):
    """(train_x, train_y, test_x, test_y, synthetic, labels_fallback)."""
    raw = os.path.join(root, "MNIST", "raw")
    tr_x = load_idx_images(os.path.join(raw, "train-images-idx3-ubyte"))
    te_x = load_idx_images(os.path.join(raw, "t10k-images-idx3-ubyte"))
    if tr_x is not None and te_x is not None:
        tr_y = load_idx_labels(os.path.join(raw, "train-labels-idx1-ubyte"))
        te_y = load_idx_labels(os.path.join(raw, "t10k-labels-idx1-ubyte"))
        labels_fallback = tr_y is None or te_y is None
        if tr_y is None:
            tr_y = np.zeros(tr_x.shape[0], np.int64)
        if te_y is None:
            te_y = np.zeros(te_x.shape[0], np.int64)
        return tr_x, tr_y, te_x, te_y, False, labels_fallback
    tr_x, tr_y = _synthetic_mnist(_N_TRAIN, seed=1_000_001)
    te_x, te_y = _synthetic_mnist(_N_TEST, seed=1_000_003)
    return tr_x, tr_y, te_x, te_y, True, False


def _load_sbmnist_arrays(root):
    """Larochelle's statically binarized splits (reference
    datasets/sbmnist.py:44-80) or one fixed Bernoulli draw of the surrogate."""
    d = os.path.join(root, "bmnist")
    paths = {s: os.path.join(d, f"binarized_mnist_{s}.amat")
             for s in ("train", "valid", "test")}
    if all(os.path.exists(p) for p in paths.values()):
        tr, va, te = (load_amat(paths[s], n_cols=784)
                      for s in ("train", "valid", "test"))
        return tr, va, te, False
    rng = np.random.default_rng(1_000_007)
    gray, _ = _synthetic_mnist(_SB_TRAIN + _SB_VAL + _SB_TEST, seed=1_000_005)
    binary = (rng.random(gray.shape) < gray).astype(np.float32)
    return (binary[:_SB_TRAIN], binary[_SB_TRAIN:_SB_TRAIN + _SB_VAL],
            binary[_SB_TRAIN + _SB_VAL:], True)


def _resize_bilinear(x, out_size, in_size=28):
    """[N, in^2] -> [N, out^2] half-pixel-centre bilinear: the reference's
    mnist32 path (torchvision Resize, bilinear with align_corners=False,
    datasets/mnist.py:69-72). The same numpy steps, and dtypes, as the JAX
    twin's: the source rows ``yi`` float64, the weights ``wy`` float32."""
    n = x.shape[0]
    imgs = x.reshape(n, in_size, in_size)
    scale = in_size / out_size
    yi = np.clip((np.arange(out_size) + 0.5) * scale - 0.5, 0, in_size - 1)
    y0 = np.clip(yi.astype(np.int64), 0, in_size - 2)
    wy = (yi - y0).astype(np.float32)
    rows = (imgs[:, y0, :] * (1 - wy)[None, :, None]
            + imgs[:, y0 + 1, :] * wy[None, :, None])
    cols = (rows[:, :, y0] * (1 - wy)[None, None, :]
            + rows[:, :, y0 + 1] * wy[None, None, :])
    return cols.reshape(n, out_size * out_size).astype(np.float32)


def make_stacked_mnist(x, y, n, seed=0):
    """n 3-channel StackedMNIST items (reference StackedMNIST,
    datasets/mnist.py:16-33): channels 1 and 2 random items of x, channel
    3 item index mod len(x); label 100*y1 + 10*y2 + y3."""
    rng = np.random.default_rng(seed)
    m = x.shape[0]
    i1 = rng.integers(0, m, n)
    i2 = rng.integers(0, m, n)
    i3 = np.arange(n) % m
    imgs = np.concatenate([x[i1], x[i2], x[i3]], axis=1)
    labels = 100 * y[i1] + 10 * y[i2] + y[i3]
    return imgs.astype(np.float32), labels.astype(np.int64)


def _val_split_indices(root, dataset, n, val_size):
    """Cached, seeded split permutation (reference datasets/mnist.py:60-67);
    the same file and content as the JAX package's."""
    d = os.path.join(root, "MNIST")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{dataset}-val{val_size}-split.npz")
    if os.path.exists(path):
        return np.load(path)["indices"]
    indices = np.random.default_rng(n + val_size).permutation(n)
    tmp = path + f".{os.getpid()}.tmp.npz"
    np.savez(tmp, indices=indices)
    os.replace(tmp, path)
    return indices


MNIST_NAMES = ("mnist", "cmnist", "dbmnist", "dbmnist-val5k", "mnist32")


def get_mnist(dataset, root="data", final_mode=False):
    """mnist / cmnist / dbmnist / dbmnist-val5k / mnist32 splits (reference
    get_mnist, datasets/mnist.py:49-92). mnist32 resizes the whole train
    and test arrays to 32 x 32 before the split; its gray values are not
    binarized."""
    if dataset not in MNIST_NAMES:
        raise NotImplementedError(f"dataset: {dataset}")
    binary = dataset in ("dbmnist", "dbmnist-val5k")
    image_size = 32 if dataset == "mnist32" else 28
    val_size = 5_000 if dataset == "dbmnist-val5k" else 10_000
    tr_x, tr_y, te_x, te_y, synthetic, labels_fallback = _load_mnist_arrays(root)
    if image_size != 28:
        tr_x = _resize_bilinear(tr_x, image_size)
        te_x = _resize_bilinear(te_x, image_size)
    if final_mode:
        train_x, train_y, val_x, val_y = tr_x, tr_y, None, None
    else:
        n = tr_x.shape[0]
        idx = _val_split_indices(root, dataset, n, val_size)
        train_x, train_y = tr_x[idx[: n - val_size]], tr_y[idx[: n - val_size]]
        val_x, val_y = tr_x[idx[n - val_size:]], tr_y[idx[n - val_size:]]
    return {
        "train": train_x,
        "val": val_x,
        "test": te_x,
        "info": {
            "binarize": binary,
            "center": dataset == "cmnist",
            "synthetic": synthetic,
            "labels_fallback": labels_fallback,
            "nclasses": 10,
            "image_size": image_size,
            "labels": {"train": train_y, "val": val_y, "test": te_y},
        },
    }


def get_sbmnist(root="data", final_mode=False):
    """Statically binarized MNIST (reference get_sbmnist,
    datasets/mnist.py:94-123); final mode folds val into train."""
    tr, va, te, synthetic = _load_sbmnist_arrays(root)
    if final_mode:
        tr, va = np.concatenate([tr, va], axis=0), None
    return {
        "train": tr,
        "val": va,
        "test": te,
        "info": {
            "binarize": False,  # binary on disk already
            "center": False,
            "synthetic": synthetic,
            "nclasses": 10,
            "image_size": 28,
        },
    }


def get_image_dataset(dataset, root="data", final_mode=False):
    """Name dispatch over the image datasets (reference get_image_dataset,
    datasets/mnist.py:125-145)."""
    if dataset in MNIST_NAMES:
        return get_mnist(dataset, root=root, final_mode=final_mode)
    if dataset == "sbmnist":
        return get_sbmnist(root=root, final_mode=final_mode)
    raise NotImplementedError(f"dataset: {dataset}")
