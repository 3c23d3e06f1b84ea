"""MNIST and CIFAR10 loaders as NumPy pipelines (counterpart of those parts
of ``pytorch_generative_tpu/datasets.py``; the port keeps its own copy,
since importing the JAX package imports JAX).

Batches are NHWC float32 NumPy arrays; the Trainer moves them to the
device. Shuffling and stochastic transforms draw from explicit NumPy streams
seeded by (seed, epoch, batch), so the same seed gives the same batches as
the JAX package. Files are looked up under ``$PGT_DATA_DIR``, ``/tmp/data``,
``./data`` and ``~/.cache/pytorch_generative_tpu``; nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

_MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}


def _data_roots():
    roots = []
    if os.environ.get("PGT_DATA_DIR"):
        roots.append(os.environ["PGT_DATA_DIR"])
    roots += ["/tmp/data", "./data",
              os.path.expanduser("~/.cache/pytorch_generative_tpu")]
    return roots


def _find(relpath: str) -> str:
    searched = [os.path.join(root, relpath) for root in _data_roots()]
    for path in searched:
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"Dataset file {relpath} not found; searched {searched}. Place it "
        "there or point $PGT_DATA_DIR at its root (nothing is downloaded).")


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i: 8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def load_mnist():
    """Returns ((train_x, train_y), (test_x, test_y)); images uint8 (N, 28, 28)."""
    arrays = {key: _read_idx(_find(os.path.join("MNIST", "raw", fname)))
              for key, fname in _MNIST_FILES.items()}
    return ((arrays["train_images"], arrays["train_labels"]),
            (arrays["test_images"], arrays["test_labels"]))


def load_cifar10():
    """Returns ((train_x, train_y), (test_x, test_y)); images uint8 NHWC
    32x32x3. Reads an unpacked ``cifar-10-batches-py`` (the python pickles)
    under the data roots; nothing is downloaded."""
    searched = [os.path.join(root, "cifar-10-batches-py") for root in _data_roots()]
    base = next((p for p in searched if os.path.isdir(p)), None)
    if base is None:
        raise FileNotFoundError(
            f"CIFAR10 (cifar-10-batches-py) not found; searched {searched}. "
            "Unpack it there or point $PGT_DATA_DIR at its root (nothing is "
            "downloaded).")

    def read_batch(name):
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.asarray(d[b"labels"], np.int64)

    xs, ys = zip(*[read_batch(f"data_batch_{i}") for i in range(1, 6)])
    test_x, test_y = read_batch("test_batch")
    return (np.concatenate(xs), np.concatenate(ys)), (test_x, test_y)


def dynamically_binarize(rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
    """Bernoulli(probs=x) per presentation — fresh noise every epoch."""
    return (rng.random(x.shape, dtype=np.float32) < x).astype(np.float32)


_binarize = dynamically_binarize  # get_mnist_loaders' flag shadows the name


class DataLoader:
    """An iterable over (x, y) NumPy batches with per-epoch shuffling.

    ``transform(rng, x) -> x`` runs per batch with a fresh, deterministic RNG
    stream derived from (seed, epoch, batch index), so stochastic transforms
    like dynamic binarization re-sample every epoch.
    """

    def __init__(self, xs, ys=None, batch_size=128, shuffle=False, transform=None,
                 seed=0):
        self.xs = xs
        self.ys = ys
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.transform = transform
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return -(-len(self.xs) // self.batch_size)

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        order = np.arange(len(self.xs))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        for i in range(len(self)):
            idx = order[i * self.batch_size: (i + 1) * self.batch_size]
            x = self.xs[idx]
            if self.transform is not None:
                rng = np.random.default_rng((self.seed, epoch, i))
                x = self.transform(rng, x)
            y = self.ys[idx] if self.ys is not None else None
            yield x, y


def _to_float_nhwc(images: np.ndarray) -> np.ndarray:
    """uint8 (N, H, W[, C]) -> float32 NHWC in [0, 1]."""
    if images.ndim == 3:
        images = images[..., None]
    return images.astype(np.float32) / 255.0


def get_mnist_loaders(batch_size, dynamically_binarize=False, seed=0):
    """Train/test loaders for MNIST: the JAX package's NumPy pipeline (its
    C++ prefetching loader, dequantization and 32x32 padding are not
    ported)."""
    (train_x, train_y), (test_x, test_y) = load_mnist()
    train_x, test_x = _to_float_nhwc(train_x), _to_float_nhwc(test_x)
    transform = _binarize if dynamically_binarize else None
    train_loader = DataLoader(train_x, train_y, batch_size, shuffle=True,
                              transform=transform, seed=seed)
    test_loader = DataLoader(test_x, test_y, batch_size, transform=transform,
                             seed=seed + 1)
    return train_loader, test_loader


_CIFAR10_MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
_CIFAR10_STD = np.asarray([0.2023, 0.1994, 0.2010], np.float32)


def _normalize_cifar10(rng, x):  # noqa: ARG001 - the DataLoader transform signature
    return (x - _CIFAR10_MEAN) / _CIFAR10_STD


def get_cifar10_loaders(batch_size, normalize=False, seed=0):
    """Train/test loaders for CIFAR10: the JAX package's NumPy pipeline,
    images in [0, 1], with ``normalize`` the per-channel standardization."""
    (train_x, train_y), (test_x, test_y) = load_cifar10()
    train_x, test_x = _to_float_nhwc(train_x), _to_float_nhwc(test_x)
    transform = _normalize_cifar10 if normalize else None
    train_loader = DataLoader(train_x, train_y, batch_size, shuffle=True,
                              transform=transform, seed=seed)
    test_loader = DataLoader(test_x, test_y, batch_size, transform=transform)
    return train_loader, test_loader


def get_synthetic_mnist_loaders(batch_size, n_train=4096, n_test=512, image_size=28,
                                seed=0):
    """Random binary MNIST-shaped data for benchmarks and tests when real
    data is absent (the JAX package's ``binary=True`` stream)."""
    rng = np.random.default_rng(seed)
    train = (rng.random((n_train, image_size, image_size, 1)) < 0.13).astype(np.float32)
    test = (rng.random((n_test, image_size, image_size, 1)) < 0.13).astype(np.float32)
    return (DataLoader(train, None, batch_size, shuffle=True, seed=seed),
            DataLoader(test, None, batch_size))
