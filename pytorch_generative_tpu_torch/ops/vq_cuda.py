"""Fused vector quantization: the CUDA kernel ``csrc/vq.cu``, its plain
PyTorch version and its launch count (counterpart of
``pytorch_generative_tpu/ops/vq_pallas.py::vq_quantize_fused``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor takes
the plain version. The outputs carry no gradient: the VQ-VAE calls this
only in EMA mode, on detached inputs, as the JAX package wraps its inputs in
``stop_gradient``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pytorch_generative_tpu_torch.ops import _build
from pytorch_generative_tpu_torch.ops.vq import nearest_codebook

KERNEL = "vq"
MAX_DIM = 256  # D the kernel takes (a 64-row tile of x stays in shared memory)
# R: rows a CTA of the assign launch owns. Block b (rows b R .. b R + R - 1)
# writes the count and the row sum of each code it holds into row b of an
# (ceil(M / R), R) table, codes in ascending order, and each code's slot
# there (or -1) into row b of an (ceil(M / R), K) byte map. The gather
# launch adds each code's entries in a fixed order: a CTA owns GATHER_CODES
# codes and reads GATHER_THREADS blocks a round; the entries of a code are
# split over the GATHER_THREADS // (GATHER_CODES * D / 4) threads of each
# of its float4s, each adding its share in block order, the shares then
# added in order (csrc/vq.cu, vq_gather_kernel).
BLOCK_ROWS = 64
GATHER_CODES = 4
GATHER_THREADS = 256

# Kernel launches since the last reset; only _vq_cuda adds to it (one per
# call, which runs the assign and gather launches).
launches = 0


def vq_quantize_plain(flat_x, codebook):
    """The kernel's plain version: (quantized (M, D), counts (K,), sums
    (K, D)) for (M, D) rows and a (K, D) codebook, through a one-hot
    matrix, as the JAX package's unfused path computes them."""
    one_hot = F.one_hot(nearest_codebook(flat_x, codebook),
                        codebook.shape[0]).to(flat_x.dtype)
    return one_hot @ codebook, one_hot.sum(dim=0), one_hot.T @ flat_x


def check_shapes(flat_x, codebook):
    """Raises unless the kernel takes these shapes: (M, D) rows and a
    (K, D) codebook, M and K at least 1, D a multiple of 4 from 4 to
    MAX_DIM; returns (M, K, D)."""
    if flat_x.dim() != 2 or codebook.dim() != 2:
        raise ValueError(f"expected (M, D) rows and a (K, D) codebook, got "
                         f"{tuple(flat_x.shape)} and {tuple(codebook.shape)}")
    (m, d), k = flat_x.shape, codebook.shape[0]
    if codebook.shape[1] != d:
        raise ValueError(f"codebook width {codebook.shape[1]} != row width {d}")
    if d % 4 or not 0 < d <= MAX_DIM or m < 1 or k < 1:
        raise ValueError(f"M = {m}, K = {k}, D = {d}: the kernel takes M, K >= 1 "
                         f"and D a multiple of 4 from 4 to {MAX_DIM}")
    return m, k, d


def scratch_bytes(m, k, d):
    """Bytes of the assign launch's table for M rows, K codes of width D,
    with B = ceil(M / R) blocks: sums (B, R, D) float32, counts (B, R)
    int32, then the map (B, K rounded up to 4) int8."""
    n_blocks = -(-m // BLOCK_ROWS)
    return 4 * n_blocks * BLOCK_ROWS * (d + 1) + n_blocks * (-(-k // 4) * 4)


def _vq_cuda(flat_x, codebook):
    global launches
    m, k, d = check_shapes(flat_x, codebook)
    for name, t, shape in (("x", flat_x, (m, d)), ("codebook", codebook, (k, d))):
        _build.check_tensor(name, t, shape, flat_x.device, KERNEL)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    dev = flat_x.device
    quantized = torch.empty_like(flat_x)
    counts = torch.empty((k,), device=dev)
    sums = torch.empty((k, d), device=dev)
    table = torch.empty((scratch_bytes(m, k, d),), device=dev, dtype=torch.uint8)
    slots = -(-m // BLOCK_ROWS) * BLOCK_ROWS
    t_sum = table.data_ptr()
    t_count = t_sum + 4 * slots * d
    t_pos = t_count + 4 * slots
    fn = _build.declare(_build.load(KERNEL).vq_f32,
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(flat_x.data_ptr(), codebook.data_ptr(), quantized.data_ptr(),
                 counts.data_ptr(), sums.data_ptr(), t_pos, t_count, t_sum, m, k, d,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vq_f32")
    launches += 1
    return quantized, counts, sums


def vq_quantize_fused(flat_x, codebook):
    """Nearest-codebook quantization and the EMA batch statistics of (M, D)
    rows against a (K, D) codebook: (quantized (M, D), counts (K,), sums
    (K, D)), counts and sums exactly ``one_hot.sum(0)`` and
    ``one_hot.T @ flat_x``."""
    return _build.dispatch(_vq_cuda, vq_quantize_plain, flat_x, codebook)
