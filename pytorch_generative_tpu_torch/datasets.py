"""MNIST loaders as NumPy pipelines (counterpart of the MNIST part of
``pytorch_generative_tpu/datasets.py``; the port keeps its own copy, since
importing the JAX package imports JAX).

Batches are NHWC float32 NumPy arrays; the Trainer moves them to the
device. Shuffling and stochastic transforms draw from explicit NumPy streams
seeded by (seed, epoch, batch), so the same seed gives the same batches as
the JAX package. Files are looked up under ``$PGT_DATA_DIR``, ``/tmp/data``,
``./data`` and ``~/.cache/pytorch_generative_tpu``; nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os

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


def get_synthetic_mnist_loaders(batch_size, n_train=4096, n_test=512, image_size=28,
                                seed=0):
    """Random binary MNIST-shaped data for benchmarks and tests when real
    data is absent (the JAX package's ``binary=True`` stream)."""
    rng = np.random.default_rng(seed)
    train = (rng.random((n_train, image_size, image_size, 1)) < 0.13).astype(np.float32)
    test = (rng.random((n_test, image_size, image_size, 1)) < 0.13).astype(np.float32)
    return (DataLoader(train, None, batch_size, shuffle=True, seed=seed),
            DataLoader(test, None, batch_size))
