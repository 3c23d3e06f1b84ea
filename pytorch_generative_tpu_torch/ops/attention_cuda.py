"""Packed causal flash attention: the CUDA kernel ``csrc/flash_fwd.cu``, its
plain PyTorch version and its launch count (counterpart of
``pytorch_generative_tpu/ops/attention_pallas.py``, forward only).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor takes
the plain version. The backward (the TPU package's ``_bwd_fused_kernel``) is
not ported yet, so serving runs this under ``torch.no_grad()``.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_generative_tpu_torch.ops import _build
from pytorch_generative_tpu_torch.ops.attention import causal_attention_with_lse

KERNEL = "flash_fwd"
HEAD_DIMS = (16, 32, 64)

# Kernel launches since the last reset; only _flash_forward_cuda adds to it.
launches = 0


def _pack(t):
    n, h, l, d = t.shape
    return t.transpose(1, 2).reshape(n, l, h * d)


def _unpack(t, n_heads):
    b, l, hd = t.shape
    return t.reshape(b, l, n_heads, hd // n_heads).transpose(1, 2)


def flash_forward_plain(q, k, v, mask_center: bool, n_heads: int):
    """The kernel's plain version: (out (B, L, H*d_v), lse (B, H, L))."""
    out, lse = causal_attention_with_lse(
        _unpack(q, n_heads), _unpack(k, n_heads), _unpack(v, n_heads),
        mask_center)
    return _pack(out), lse


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.flash_fwd_f32
    if fn.argtypes is None:  # 64-bit pointers need declared argtypes
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _check_operand(name, t, b, l):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the flash kernel takes float32, got {t.dtype}")
    if t.dim() != 3 or t.shape[0] != b or t.shape[1] != l:
        raise ValueError(f"{name}: expected (B={b}, L={l}, H*d), got {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(0) != l * t.stride(1):
        raise ValueError(f"{name}: features must have unit stride and rows "
                         f"one batch stride apart, got strides {t.stride()}")


def _flash_forward_cuda(q, k, v, mask_center: bool, n_heads: int):
    global launches
    b, l, ck = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        _check_operand(name, t, b, l)
    if k.shape[2] != ck or v.shape[2] != ck or ck % n_heads:
        raise ValueError(f"q/k/v widths {ck}/{k.shape[2]}/{v.shape[2]} must be "
                         f"equal and divisible by n_heads={n_heads}")
    d = ck // n_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    out = torch.empty((b, l, ck), device=q.device, dtype=torch.float32)
    lse = torch.empty((b, n_heads, l), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, l, n_heads, d, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            int(mask_center), stream)
    _build.check(err, "flash_fwd_f32")
    launches += 1
    return out, lse


def flash_forward(q, k, v, mask_center: bool, n_heads: int):
    """Forward over packed q/k/v (B, L, H*d): returns (out, lse (B, H, L))."""
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v, mask_center, n_heads)
    if q.device.type != "cpu":
        raise ValueError(f"no kernel for device {q.device}")
    return flash_forward_plain(q, k, v, mask_center, n_heads)


class _CausalAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask_center, n_heads):
        return flash_forward(q, k, v, mask_center, n_heads)[0]

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the flash attention backward (attention_pallas.py::"
            "_bwd_fused_kernel) is not ported yet; run under torch.no_grad()")


def causal_attention_packed(q, k, v, mask_center: bool, n_heads: int):
    """Causal attention over packed (B, L, heads*d) tensors, head-major
    features; returns (B, L, heads*d_v)."""
    if q.is_cuda:
        return _CausalAttentionPacked.apply(q, k, v, mask_center, n_heads)
    return flash_forward(q, k, v, mask_center, n_heads)[0]
