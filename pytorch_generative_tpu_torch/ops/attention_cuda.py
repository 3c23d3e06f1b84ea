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
ValueError. (4, 32) and (4, 8) take any view with unit feature stride: their
forward runs on the CUDA cores, their backward on the tensor cores by
3xTF32 ``mma.sync`` (``csrc/flash_bwd_mma_small.cuh``), 16-byte copies
where an operand's start and strides allow, else 4-byte ones.
``causal_attention_packed`` is one autograd Function
on both devices: its forward saves q, k, v, out and lse, as the JAX
package's ``_vjp_fwd`` does, and its backward is the flash backward.

bf16 operands (the Trainer's ``compute_dtype=torch.bfloat16``) take the
kernels' bf16 mode, for d_k == d_v in ``BF16_HEAD_DIMS`` and for the
pairs of ``BF16_SMALL_PAIRS``: out, dq, dk and dv bf16, lse f32, rounded
where the JAX kernel rounds for bf16 operands (the plain versions say
where). On the card the d_k == d_v operands start 16-byte aligned with
strides that are multiples of 8 values; (4, 32) and (4, 8) take any view
with unit feature stride, as in f32: their forward and backward on bf16
``mma.sync`` (``csrc/flash_fwd_small_bf16.cuh``,
``csrc/flash_bwd_mma_bf16.cuh``, d_k zero-padded to the product's depth).
Any other pair raises a TypeError for bf16 on both devices.
"""

from __future__ import annotations

import ctypes
import os

import torch

from pytorch_generative_tpu_torch.ops import _build
from pytorch_generative_tpu_torch.ops.attention import causal_attention_with_lse
from pytorch_generative_tpu_torch.ops.masks import causal_attention_mask

KERNEL = "flash_fwd"
BWD_KERNEL = "flash_bwd"
# The (d_k, d_v) head widths the kernels are built for: ImageGPT's d_k ==
# d_v on the tensor cores (128: bench.py's C = 512 model with 4 heads),
# PixelSNAIL's (4, 32) and its (4, 8) for small tests (module docstring).
# The d_k == d_v instances also need aligned operands.
HEAD_DIM_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (4, 32), (4, 8))

# Kernel launches since the last reset; only _flash_forward_cuda adds to
# `launches`, only _flash_backward_cuda to `bwd_launches` (one per call,
# which runs the dq pass and then the dk/dv pass).
launches = 0
bwd_launches = 0
# The same for the bf16 mode's entries (flash_fwd_bf16, flash_bwd_bf16).
BF16_KERNEL = "flash_fwd_bf16"
BF16_BWD_KERNEL = "flash_bwd_bf16"
BF16_HEAD_DIMS = (16, 32, 64, 128)
# PixelSNAIL's pairs in bf16 (same entries and counters as the d_k == d_v
# instances): forward and backward on bf16 mma.sync.
BF16_SMALL_PAIRS = ((4, 32), (4, 8))
bf16_launches = 0
bf16_bwd_launches = 0
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _pack(t):
    n, h, l, d = t.shape
    return t.transpose(1, 2).reshape(n, l, h * d)


def _unpack(t, n_heads):
    b, l, hd = t.shape
    return t.reshape(b, l, n_heads, hd // n_heads).transpose(1, 2)


def _bf16(t):
    """t rounded to bf16 (nearest even) and back to f32."""
    return t.to(torch.bfloat16).float()


def _q2(q):
    """q * scale * log2(e) in f32, rounded to bf16: the bf16 kernels' (and
    the JAX kernel's) operand in place of q (attention_pallas.py:137-138)."""
    return _bf16(q * ((1.0 / q.shape[-1] ** 0.5) * _LOG2E))


def _flash_forward_bf16_plain(q, k, v, mask_center, n_heads, q2=True):
    """The bf16 kernel's plain version, in f32 with the JAX kernel's bf16
    rounding points: q2 = bf16(q * scale * log2(e)), S = q2 k^T, the softmax
    in base 2 on the row's max, P rounded to bf16 for P v while the row sums
    take the f32 P, out rounded to bf16, lse f32. With ``q2=False`` (the
    fused attention block's rounding points) S = (q k^T) * scale * log2(e)
    in f32 from q as it is."""
    q, k, v = (_unpack(t, n_heads).float() for t in (q, k, v))
    mask = causal_attention_mask(q.shape[-2], mask_center, device=q.device)
    if q2:
        s = torch.einsum("nhqd,nhkd->nhqk", _q2(q), k)
    else:
        s = torch.einsum("nhqd,nhkd->nhqk", q, k) * ((1.0 / q.shape[-1] ** 0.5) * _LOG2E)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp2(s - m)  # masked: exp2(-inf) == 0
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("nhqk,nhkd->nhqd", _bf16(p), v)
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l == 0.0, torch.full_like(l, float("-inf")),
                      m * _LN2 + torch.log(torch.clamp(l, min=1e-38)))
    return _pack(out).to(torch.bfloat16), lse[..., 0]


def _flash_backward_bf16_plain(q, k, v, out, lse, dout, mask_center, n_heads):
    """The bf16 backward kernel's plain version, in f32 with the JAX
    kernel's bf16 rounding points (attention_pallas.py:250-290): p rebuilt
    from q2 and lse, delta = rowsum(dO O) in f32, dV = bf16(p)^T dO,
    dS = p (dO v^T - delta) in f32, dQ = bf16(dS) k * scale, dK = bf16(dS)^T
    q2 * ln 2; dq, dk and dv rounded to bf16 once, at the end."""
    q, k, v, out, dout = (_unpack(t, n_heads).float() for t in (q, k, v, out, dout))
    scale = 1.0 / q.shape[-1] ** 0.5
    q2 = _q2(q)
    mask = causal_attention_mask(q.shape[-2], mask_center, device=q.device)
    lse = lse[..., None]
    live = mask & torch.isfinite(lse)  # fully-masked rows get p = 0
    s = torch.einsum("nhqd,nhkd->nhqk", q2, k)
    p = torch.where(live, torch.exp2(s - torch.where(live, lse * _LOG2E, 0.0)), 0.0)
    delta = (dout * out).sum(dim=-1, keepdim=True)
    dv = torch.einsum("nhqk,nhqd->nhkd", _bf16(p), dout)
    ds = _bf16(p * (torch.einsum("nhqd,nhkd->nhqk", dout, v) - delta))
    dq = torch.einsum("nhqk,nhkd->nhqd", ds, k) * scale
    dk = torch.einsum("nhqk,nhqd->nhkd", ds, q2) * _LN2
    return tuple(_pack(t).to(torch.bfloat16) for t in (dq, dk, dv))


def flash_forward_plain(q, k, v, mask_center: bool, n_heads: int):
    """The kernel's plain version: (out (B, L, H*d_v), lse (B, H, L)) for
    q, k (B, L, H*d_k) and v (B, L, H*d_v); bf16 operands take the bf16
    kernel's."""
    if q.dtype == torch.bfloat16:
        return _flash_forward_bf16_plain(q, k, v, mask_center, n_heads)
    out, lse = causal_attention_with_lse(
        _unpack(q, n_heads), _unpack(k, n_heads), _unpack(v, n_heads),
        mask_center)
    return _pack(out), lse


def flash_backward_plain(q, k, v, out, lse, dout, mask_center: bool,
                         n_heads: int):
    """The backward kernel's plain version, on a materialised p: (dq, dk,
    dv), dq and dk (B, L, H*d_k), dv (B, L, H*d_v); bf16 operands take the
    bf16 kernel's."""
    if q.dtype == torch.bfloat16:
        return _flash_backward_bf16_plain(q, k, v, out, lse, dout, mask_center, n_heads)
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


def _check_operand(name, t, b, l, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype} beside q's {dtype}; the flash kernels take "
                        "float32 or bfloat16 operands of one type")
    if t.dim() != 3 or t.shape[0] != b or t.shape[1] != l:
        raise ValueError(f"{name}: expected (B={b}, L={l}, H*d), got {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(0) != l * t.stride(1):
        raise ValueError(f"{name}: features must have unit stride and rows "
                         f"one batch stride apart, got strides {t.stride()}")


def _check_operands(n_heads, **operands):
    """Checks packed operands on one device: q and k (B, L, H*d_k), the rest
    (v, out, dout) (B, L, H*d_v); returns (d_k, d_v)."""
    q, v = operands["q"], operands["v"]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: the flash kernels take float32 or bfloat16, got {q.dtype}")
    b, l, ck = q.shape
    cv = v.shape[-1]
    for name, t in operands.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        _check_operand(name, t, b, l, q.dtype)
        ref = "q" if name in ("q", "k") else "v"
        if t.shape[2] != operands[ref].shape[2]:
            raise ValueError(f"{name} width {t.shape[2]} != {ref} width "
                             f"{operands[ref].shape[2]}")
    dims = (ck // n_heads, cv // n_heads)
    if ck % n_heads or cv % n_heads or dims not in HEAD_DIM_PAIRS:
        raise ValueError(f"widths q/k {ck}, v {cv} over {n_heads} heads: "
                         f"(d_k, d_v) not one of {HEAD_DIM_PAIRS}")
    if dims[0] == dims[1]:
        vec = 16 // q.element_size()  # the tensor-core kernels copy 16 bytes at a time
        for name, t in operands.items():
            if t.data_ptr() % 16 or t.stride(0) % vec or t.stride(1) % vec:
                raise ValueError(f"{name}: the d_k == d_v kernels need a 16-byte aligned "
                                 f"start and strides that are multiples of {vec}, got "
                                 f"offset {t.data_ptr() % 16} bytes, strides {t.stride()}")
    return dims


def _check_bf16_pair(dtype, dims):
    """Raises a TypeError for bf16 operands at a (d_k, d_v) pair that the
    bf16 mode does not take, on either device."""
    if dtype != torch.bfloat16 or dims in BF16_SMALL_PAIRS:
        return
    if dims[0] != dims[1] or dims[0] not in BF16_HEAD_DIMS:
        raise TypeError(
            f"(d_k, d_v) = {dims}: the flash kernels' bf16 mode takes d_k == d_v in "
            f"{BF16_HEAD_DIMS} and {BF16_SMALL_PAIRS}; bf16 at other widths is not ported "
            "yet: ROADMAP.md queue B item 1")


def _strides(*tensors):
    return [s for t in tensors for s in (t.stride(0), t.stride(1))]


def _flash_forward_cuda(q, k, v, mask_center: bool, n_heads: int):
    global launches, bf16_launches
    d_k, d_v = _check_operands(n_heads, q=q, k=k, v=v)
    b, l, _ = q.shape
    out = torch.empty((b, l, n_heads * d_v), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, n_heads, l), device=q.device, dtype=torch.float32)
    entry = "flash_fwd_bf16" if q.dtype == torch.bfloat16 else "flash_fwd_f32"
    fn = _build.declare(getattr(_build.load(KERNEL), entry),
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                        + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, l, n_heads, d_k, d_v, *_strides(q, k, v),
                 int(mask_center), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    if q.dtype == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return out, lse


def _flash_backward_cuda(q, k, v, out, lse, dout, mask_center: bool,
                         n_heads: int):
    global bwd_launches, bf16_bwd_launches
    dout = dout.contiguous()
    d_k, d_v = _check_operands(n_heads, q=q, k=k, v=v, out=out, dout=dout)
    b, l, ck = q.shape
    if lse.shape != (b, n_heads, l) or not lse.is_contiguous() \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be contiguous float32 ({b}, {n_heads}, {l}) "
                         f"on {q.device}")
    dq, dk = (torch.empty((b, l, ck), device=q.device, dtype=q.dtype) for _ in range(2))
    dv = torch.empty((b, l, n_heads * d_v), device=q.device, dtype=q.dtype)
    delta = torch.empty((b, n_heads, l), device=q.device)
    entry = "flash_bwd_bf16" if q.dtype == torch.bfloat16 else "flash_bwd_f32"
    fn = _build.declare(getattr(_build.load(BWD_KERNEL), entry),
                        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                        + [ctypes.c_int64] * 10 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(), b, l, n_heads, d_k, d_v,
                 *_strides(q, k, v, out, dout), int(mask_center),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    if q.dtype == torch.bfloat16:
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return dq, dk, dv


def _check_precision(dtype):
    """Raises a ValueError for ``PGT_FLASH_PRECISION=default`` with float32
    operands, read at every call as the JAX package reads it: there it casts
    each product's f32 operands to bf16, a mode the port does not have."""
    if dtype == torch.float32 and os.environ.get("PGT_FLASH_PRECISION", "highest") == "default":
        raise ValueError(
            "PGT_FLASH_PRECISION=default: the flash kernels' f32 mode with bf16 products "
            "is not ported (ROADMAP.md queue B item 1); unset it for the f32 kernels")


def flash_forward(q, k, v, mask_center: bool, n_heads: int):
    """Forward over packed q, k (B, L, H*d_k) and v (B, L, H*d_v): returns
    (out (B, L, H*d_v), lse (B, H, L))."""
    _check_precision(q.dtype)
    _check_bf16_pair(q.dtype, (q.shape[-1] // n_heads, v.shape[-1] // n_heads))
    return _build.dispatch(_flash_forward_cuda, flash_forward_plain, q, k, v,
                           mask_center, n_heads)


def flash_backward(q, k, v, out, lse, dout, mask_center: bool, n_heads: int):
    """Backward over packed tensors, from the forward's out and lse:
    returns (dq, dk, dv), shaped as q, k and v."""
    _check_precision(q.dtype)
    _check_bf16_pair(q.dtype, (q.shape[-1] // n_heads, v.shape[-1] // n_heads))
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
