"""Packed causal flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, their plain PyTorch versions, their launch counts and
the autograd Function that joins them (counterpart of
``pytorch_generative_tpu/ops/attention_pallas.py``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor takes
the plain version. The (d_k, d_v) pairs are those of ``HEAD_DIM_PAIRS``.
The d_k == d_v instances run on the tensor cores (3xTF32,
``csrc/flash_mma.cuh``) and stage their tiles 16 bytes at a time, so on the
card each of their operands must start 16-byte aligned and have batch and
row strides that are multiples of 4 elements (a contiguous tensor, or a
column slice of one at a multiple of 4, passes); else the wrapper raises a
ValueError. (4, 32) and (4, 8) run on the CUDA cores and take any view with
unit feature stride. ``causal_attention_packed`` is one autograd Function
on both devices: its forward saves q, k, v, out and lse, as the JAX
package's ``_vjp_fwd`` does, and its backward is the flash backward.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_generative_tpu_torch.ops import _build
from pytorch_generative_tpu_torch.ops.attention import causal_attention_with_lse
from pytorch_generative_tpu_torch.ops.masks import causal_attention_mask

KERNEL = "flash_fwd"
BWD_KERNEL = "flash_bwd"
# The (d_k, d_v) head widths the kernels are built for: ImageGPT's d_k ==
# d_v on the tensor cores (128: bench.py's C = 512 model with 4 heads),
# PixelSNAIL's (4, 32) and (4, 8) for small tests on the CUDA cores. The
# d_k == d_v instances also need aligned operands (module docstring).
HEAD_DIM_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (4, 32), (4, 8))

# Kernel launches since the last reset; only _flash_forward_cuda adds to
# `launches`, only _flash_backward_cuda to `bwd_launches` (one per call,
# which runs the dq pass and then the dk/dv pass).
launches = 0
bwd_launches = 0


def _pack(t):
    n, h, l, d = t.shape
    return t.transpose(1, 2).reshape(n, l, h * d)


def _unpack(t, n_heads):
    b, l, hd = t.shape
    return t.reshape(b, l, n_heads, hd // n_heads).transpose(1, 2)


def flash_forward_plain(q, k, v, mask_center: bool, n_heads: int):
    """The kernel's plain version: (out (B, L, H*d_v), lse (B, H, L)) for
    q, k (B, L, H*d_k) and v (B, L, H*d_v)."""
    out, lse = causal_attention_with_lse(
        _unpack(q, n_heads), _unpack(k, n_heads), _unpack(v, n_heads),
        mask_center)
    return _pack(out), lse


def flash_backward_plain(q, k, v, out, lse, dout, mask_center: bool,
                         n_heads: int):
    """The backward kernel's plain version, on a materialised p: (dq, dk,
    dv), dq and dk (B, L, H*d_k), dv (B, L, H*d_v)."""
    q, k, v, out, dout = (_unpack(t, n_heads) for t in (q, k, v, out, dout))
    scale = 1.0 / (q.shape[-1] ** 0.5)
    mask = causal_attention_mask(q.shape[-2], mask_center, device=q.device)
    lse = lse[..., None]
    live = mask & torch.isfinite(lse)  # fully-masked rows get p = 0
    logits = torch.einsum("nhqd,nhkd->nhqk", q, k) * scale
    p = torch.where(live, torch.exp(logits - torch.where(live, lse, 0.0)), 0.0)
    delta = (dout * out).sum(dim=-1, keepdim=True)
    dv = torch.einsum("nhqk,nhqd->nhkd", p, dout)
    ds = p * (torch.einsum("nhqd,nhkd->nhqk", dout, v) - delta)
    dq = torch.einsum("nhqk,nhkd->nhqd", ds, k) * scale
    dk = torch.einsum("nhqk,nhqd->nhkd", ds, q) * scale
    return _pack(dq), _pack(dk), _pack(dv)


def _check_operand(name, t, b, l):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the flash kernels take float32, got {t.dtype}")
    if t.dim() != 3 or t.shape[0] != b or t.shape[1] != l:
        raise ValueError(f"{name}: expected (B={b}, L={l}, H*d), got {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(0) != l * t.stride(1):
        raise ValueError(f"{name}: features must have unit stride and rows "
                         f"one batch stride apart, got strides {t.stride()}")


def _check_operands(n_heads, **operands):
    """Checks packed operands on one device: q and k (B, L, H*d_k), the rest
    (v, out, dout) (B, L, H*d_v); returns (d_k, d_v)."""
    q, v = operands["q"], operands["v"]
    b, l, ck = q.shape
    cv = v.shape[-1]
    for name, t in operands.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        _check_operand(name, t, b, l)
        ref = "q" if name in ("q", "k") else "v"
        if t.shape[2] != operands[ref].shape[2]:
            raise ValueError(f"{name} width {t.shape[2]} != {ref} width "
                             f"{operands[ref].shape[2]}")
    dims = (ck // n_heads, cv // n_heads)
    if ck % n_heads or cv % n_heads or dims not in HEAD_DIM_PAIRS:
        raise ValueError(f"widths q/k {ck}, v {cv} over {n_heads} heads: "
                         f"(d_k, d_v) not one of {HEAD_DIM_PAIRS}")
    if dims[0] == dims[1]:
        for name, t in operands.items():  # the tensor-core kernels copy 16 bytes at a time
            if t.data_ptr() % 16 or t.stride(0) % 4 or t.stride(1) % 4:
                raise ValueError(f"{name}: the d_k == d_v kernels need a 16-byte aligned "
                                 f"start and strides that are multiples of 4, got "
                                 f"offset {t.data_ptr() % 16} bytes, strides {t.stride()}")
    return dims


def _strides(*tensors):
    return [s for t in tensors for s in (t.stride(0), t.stride(1))]


def _flash_forward_cuda(q, k, v, mask_center: bool, n_heads: int):
    global launches
    d_k, d_v = _check_operands(n_heads, q=q, k=k, v=v)
    b, l, _ = q.shape
    out = torch.empty((b, l, n_heads * d_v), device=q.device, dtype=torch.float32)
    lse = torch.empty((b, n_heads, l), device=q.device, dtype=torch.float32)
    fn = _build.declare(_build.load(KERNEL).flash_fwd_f32,
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                        + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, l, n_heads, d_k, d_v, *_strides(q, k, v),
                 int(mask_center), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd_f32")
    launches += 1
    return out, lse


def _flash_backward_cuda(q, k, v, out, lse, dout, mask_center: bool,
                         n_heads: int):
    global bwd_launches
    dout = dout.contiguous()
    d_k, d_v = _check_operands(n_heads, q=q, k=k, v=v, out=out, dout=dout)
    b, l, ck = q.shape
    if lse.shape != (b, n_heads, l) or not lse.is_contiguous() \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be contiguous float32 ({b}, {n_heads}, {l}) "
                         f"on {q.device}")
    dq, dk = (torch.empty((b, l, ck), device=q.device) for _ in range(2))
    dv = torch.empty((b, l, n_heads * d_v), device=q.device)
    delta = torch.empty((b, n_heads, l), device=q.device)
    fn = _build.declare(_build.load(BWD_KERNEL).flash_bwd_f32,
                        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                        + [ctypes.c_int64] * 10 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(), b, l, n_heads, d_k, d_v,
                 *_strides(q, k, v, out, dout), int(mask_center),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd_f32")
    bwd_launches += 1
    return dq, dk, dv


def flash_forward(q, k, v, mask_center: bool, n_heads: int):
    """Forward over packed q, k (B, L, H*d_k) and v (B, L, H*d_v): returns
    (out (B, L, H*d_v), lse (B, H, L))."""
    return _build.dispatch(_flash_forward_cuda, flash_forward_plain, q, k, v,
                           mask_center, n_heads)


def flash_backward(q, k, v, out, lse, dout, mask_center: bool, n_heads: int):
    """Backward over packed tensors, from the forward's out and lse:
    returns (dq, dk, dv), shaped as q, k and v."""
    return _build.dispatch(_flash_backward_cuda, flash_backward_plain, q, k, v,
                           out, lse, dout, mask_center, n_heads)


class _CausalAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask_center, n_heads):
        out, lse = flash_forward(q, k, v, mask_center, n_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask_center, ctx.n_heads = mask_center, n_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = flash_backward(*ctx.saved_tensors, dout, ctx.mask_center,
                                    ctx.n_heads)
        return dq, dk, dv, None, None


def causal_attention_packed(q, k, v, mask_center: bool, n_heads: int):
    """Differentiable causal attention over packed q, k (B, L, heads*d_k) and
    v (B, L, heads*d_v), head-major features; returns (B, L, heads*d_v)."""
    return _CausalAttentionPacked.apply(q, k, v, mask_center, n_heads)
