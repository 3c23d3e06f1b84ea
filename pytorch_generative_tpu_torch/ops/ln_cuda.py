"""Channel LayerNorm: the CUDA kernels ``csrc/ln_fwd.cu`` and
``csrc/ln_bwd.cu``, their plain PyTorch versions, their launch counts and
the autograd Function that joins them (counterpart of
``pytorch_generative_tpu/ops/ln_pallas.py``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor takes
the plain version. ``channel_layernorm`` is one autograd Function on both
devices: its forward saves x and gamma, as the JAX package's ``_vjp_fwd``
does, and its backward recomputes the statistics from x.

bf16 rows (x, dy, gamma, beta all bf16: the Trainer's ``compute_dtype``)
take the kernels' bf16 mode: statistics and arithmetic in f32, out and dx
rounded to bf16, dgamma and dbeta summed in f32 and cast to gamma's type
by the autograd Function, as the JAX package's ``_vjp_bwd`` casts them.
bf16 takes C a multiple of 8.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_generative_tpu_torch.ops import _build

KERNEL = "ln_fwd"
BWD_KERNEL = "ln_bwd"
# C <= 512: a row in one warp's registers; wider rows, up to MAX_CHANNELS,
# in one CTA's registers (csrc/rows.cuh, kMaxChannels).
MAX_CHANNELS = 4096
# Rows per CTA of the backward's first launch; the (ceil(R / 64), 2, C)
# partial sums of dgamma and dbeta are added in a fixed order.
ROWS_PER_CTA = 64

# Kernel launches since the last reset; only _ln_forward_cuda adds to
# `launches`, only _ln_backward_cuda to `bwd_launches` (one per call).
launches = 0
bwd_launches = 0
# The same for the bf16 mode's entries (ln_fwd_bf16, ln_bwd_bf16).
BF16_KERNEL = "ln_fwd_bf16"
BF16_BWD_KERNEL = "ln_bwd_bf16"
bf16_launches = 0
bf16_bwd_launches = 0


def normalize(x2, eps):
    """(xhat, rstd) of (R, C) rows: statistics in f32, biased variance."""
    mu = x2.mean(dim=1, keepdim=True)
    var = (x2 - mu).square().mean(dim=1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x2 - mu) * inv, inv


def wide(t):
    """t in f32 if it is bf16 (exact), else as it is: the type the plain
    versions compute in."""
    return t.float() if t.dtype == torch.bfloat16 else t


def layernorm_forward_plain(x2, gamma, beta, eps):
    """The forward kernel's plain version over (R, C) rows, in f32 for bf16
    rows, whose out is rounded to bf16."""
    xhat, _ = normalize(wide(x2), eps)
    return (xhat * wide(gamma) + wide(beta)).to(x2.dtype)


def layernorm_backward_plain(x2, dy2, gamma, eps):
    """The backward kernel's plain version: (dx, dgamma, dbeta), dx in the
    m1/m2 form of ``ln_pallas.py::_bwd_kernel``, in f32 for bf16 rows: dx
    rounded to bf16, dgamma and dbeta f32."""
    xhat, inv = normalize(wide(x2), eps)
    dy2f = wide(dy2)
    dxhat = dy2f * wide(gamma)
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * inv
    return dx.to(x2.dtype), (dy2f * xhat).sum(0), dy2f.sum(0)


def check_rows(x2):
    """Raises unless x2 is (R, C) rows the row kernels take: C a multiple of
    4 (of 8 for bf16), at most MAX_CHANNELS; returns (R, C)."""
    if x2.dim() != 2:
        raise ValueError(f"expected (R, C) rows, got {tuple(x2.shape)}")
    r, c = x2.shape
    vec = 8 if x2.dtype == torch.bfloat16 else 4
    if c % vec or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"C = {c}: the kernels take a multiple of {vec} from {vec} to "
                         f"{MAX_CHANNELS} for {x2.dtype}")
    return r, c


def kernel_dtype(x2):
    """The rows' type, if the kernels take it (float32 or bfloat16)."""
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the row kernels take float32 or bfloat16, got {x2.dtype}")
    return x2.dtype


def _check(kernel, x2, **operands):
    """Raises unless x2 and the operands are what the row kernels take:
    contiguous, all float32 or all bfloat16, on x2's device, of x2's shapes,
    each starting on a 16-byte boundary (they are read 16 or 8 bytes at a
    time); returns (R, C)."""
    dtype = kernel_dtype(x2)
    r, c = check_rows(x2)
    shapes = {"x": (r, c), "dy": (r, c), "gamma": (c,), "beta": (c,)}
    for name, t in dict(x=x2, **operands).items():
        _build.check_tensor(name, t, shapes[name], x2.device, kernel, dtype=dtype,
                            aligned=True)
    return r, c


def _ln_forward_cuda(x2, gamma, beta, eps):
    global launches, bf16_launches
    r, c = _check(KERNEL, x2, gamma=gamma, beta=beta)
    out = torch.empty_like(x2)
    bf16 = x2.dtype == torch.bfloat16
    entry = "ln_fwd_bf16" if bf16 else "ln_fwd_f32"
    fn = _build.declare(getattr(_build.load(KERNEL), entry),
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                 r, c, eps, torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, entry)
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return out


def _ln_backward_cuda(x2, dy2, gamma, eps):
    global bwd_launches, bf16_bwd_launches
    r, c = _check(BWD_KERNEL, x2, dy=dy2, gamma=gamma)
    dx = torch.empty_like(x2)
    sums = torch.empty((2, c), device=x2.device)
    part = torch.empty((-(-r // ROWS_PER_CTA), 2, c), device=x2.device)
    bf16 = x2.dtype == torch.bfloat16
    entry = "ln_bwd_bf16" if bf16 else "ln_bwd_f32"
    fn = _build.declare(getattr(_build.load(BWD_KERNEL), entry),
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), dy2.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
                 sums.data_ptr(), part.data_ptr(), r, c, ROWS_PER_CTA, eps,
                 torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, entry)
    if bf16:
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return dx, sums[0], sums[1]


def ln_forward(x2, gamma, beta, eps):
    """LayerNorm of (R, C) rows."""
    return _build.dispatch(_ln_forward_cuda, layernorm_forward_plain, x2, gamma,
                           beta, eps)


def ln_backward(x2, dy2, gamma, eps):
    """(dx, dgamma, dbeta) of (R, C) rows."""
    return _build.dispatch(_ln_backward_cuda, layernorm_backward_plain, x2, dy2,
                           gamma, eps)


class _ChannelLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        ctx.save_for_backward(x2, gamma)
        ctx.eps = eps
        return ln_forward(x2, gamma, beta, eps).reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = ln_backward(x2, dy.reshape(x2.shape).contiguous(),
                                        gamma, ctx.eps)
        # The f32 sums cast to the parameters' type, as _vjp_bwd casts them.
        return dx.reshape(dy.shape), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def channel_layernorm(x, gamma, beta, eps=1e-5):
    """Differentiable LayerNorm over the last axis of ``x`` (leading dims
    flattened to rows), with (C,) ``gamma`` and ``beta``."""
    return _ChannelLayerNorm.apply(x.contiguous(), gamma, beta, eps)
