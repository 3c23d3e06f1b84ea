"""Fused vector quantization: the CUDA kernel ``csrc/vq.cu``, its plain
PyTorch version and its launch count (counterpart of
``pytorch_generative_tpu/ops/vq_pallas.py::vq_quantize_fused``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor takes
the plain version. The outputs carry no gradient: the VQ-VAE calls this
only in EMA mode, on detached inputs, as the JAX package wraps its inputs in
``stop_gradient``.

The rows may be float32 or bfloat16 (the VQ-VAE under a bf16 compute
dtype); the codebook, counts and sums are float32 either way, and the
quantized rows take the rows' type, as the TPU kernel casts them. bf16
rows take the kernel's bf16 entry (``vq_bf16``, counted in
``bf16_launches``), whose codes, counts and sums equal the f32 entry's on
the rows widened to f32, bit for bit; on the card their D is a multiple
of 8.
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

# Kernel launches since the last reset; only _vq_cuda adds to them (one per
# call, which runs the assign and gather launches): `launches` for float32
# rows, `bf16_launches` for bfloat16 ones (entry BF16_KERNEL).
BF16_KERNEL = "vq_bf16"
launches = 0
bf16_launches = 0


def vq_quantize_plain(flat_x, codebook):
    """The kernel's plain version: (quantized (M, D), counts (K,), sums
    (K, D)) for (M, D) rows and a (K, D) codebook, through a one-hot
    matrix, as the JAX package's unfused path computes them: in the
    codebook's type (bf16 rows widened to it), the quantized rows cast to
    the rows' type."""
    one_hot = F.one_hot(nearest_codebook(flat_x, codebook),
                        codebook.shape[0]).to(codebook.dtype)
    rows = flat_x.to(codebook.dtype)
    return (one_hot @ codebook).to(flat_x.dtype), one_hot.sum(dim=0), one_hot.T @ rows


def check_shapes(flat_x, codebook):
    """Raises unless the kernel takes these shapes: (M, D) rows and a
    (K, D) codebook, M and K at least 1, D a multiple of 4 (of 8 for bf16
    rows) from 4 to MAX_DIM; returns (M, K, D)."""
    if flat_x.dim() != 2 or codebook.dim() != 2:
        raise ValueError(f"expected (M, D) rows and a (K, D) codebook, got "
                         f"{tuple(flat_x.shape)} and {tuple(codebook.shape)}")
    (m, d), k = flat_x.shape, codebook.shape[0]
    if codebook.shape[1] != d:
        raise ValueError(f"codebook width {codebook.shape[1]} != row width {d}")
    vec = 8 if flat_x.dtype == torch.bfloat16 else 4  # values a 16-byte load
    if d % vec or not 0 < d <= MAX_DIM or m < 1 or k < 1:
        raise ValueError(f"M = {m}, K = {k}, D = {d}: the kernel takes M, K >= 1 "
                         f"and D a multiple of {vec} from {vec} to {MAX_DIM} for "
                         f"{flat_x.dtype} rows")
    return m, k, d


def scratch_bytes(m, k, d):
    """Bytes of the assign launch's table for M rows, K codes of width D,
    with B = ceil(M / R) blocks: sums (B, R, D) float32, counts (B, R)
    int32, then the map (B, K rounded up to 4) int8."""
    n_blocks = -(-m // BLOCK_ROWS)
    return 4 * n_blocks * BLOCK_ROWS * (d + 1) + n_blocks * (-(-k // 4) * 4)


def _vq_cuda(flat_x, codebook):
    global launches, bf16_launches
    if flat_x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: the vq kernel takes float32 or bfloat16 rows, got {flat_x.dtype}")
    m, k, d = check_shapes(flat_x, codebook)
    for name, t, shape, dtype in (("x", flat_x, (m, d), flat_x.dtype),
                                  ("codebook", codebook, (k, d), torch.float32)):
        _build.check_tensor(name, t, shape, flat_x.device, KERNEL, dtype)
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
    bf16 = flat_x.dtype == torch.bfloat16
    entry = BF16_KERNEL if bf16 else "vq_f32"
    fn = _build.declare(getattr(_build.load(KERNEL), entry),
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(flat_x.data_ptr(), codebook.data_ptr(), quantized.data_ptr(),
                 counts.data_ptr(), sums.data_ptr(), t_pos, t_count, t_sum, m, k, d,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return quantized, counts, sums


def vq_quantize_fused(flat_x, codebook):
    """Nearest-codebook quantization and the EMA batch statistics of (M, D)
    rows (float32 or bfloat16) against a (K, D) float32 codebook:
    (quantized (M, D) in the rows' type, counts (K,), sums (K, D)), counts
    and sums exactly ``one_hot.sum(0)`` and ``one_hot.T @ flat_x`` in
    float32."""
    return _build.dispatch(_vq_cuda, vq_quantize_plain, flat_x, codebook)
