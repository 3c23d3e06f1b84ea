"""Channel LayerNorm: the CUDA kernels ``csrc/ln_fwd.cu`` and
``csrc/ln_bwd.cu``, their plain PyTorch versions, their launch counts and
the autograd Function that joins them (counterpart of
``pytorch_generative_tpu/ops/ln_pallas.py``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor takes
the plain version. ``channel_layernorm`` is one autograd Function on both
devices: its forward saves x and gamma, as the JAX package's ``_vjp_fwd``
does, and its backward recomputes the statistics from x.
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


def normalize(x2, eps):
    """(xhat, rstd) of (R, C) rows: statistics in f32, biased variance."""
    mu = x2.mean(dim=1, keepdim=True)
    var = (x2 - mu).square().mean(dim=1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x2 - mu) * inv, inv


def layernorm_forward_plain(x2, gamma, beta, eps):
    """The forward kernel's plain version over (R, C) rows."""
    xhat, _ = normalize(x2, eps)
    return xhat * gamma + beta


def layernorm_backward_plain(x2, dy2, gamma, eps):
    """The backward kernel's plain version: (dx, dgamma, dbeta), dx in the
    m1/m2 form of ``ln_pallas.py::_bwd_kernel``."""
    xhat, inv = normalize(x2, eps)
    dxhat = dy2 * gamma
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * inv, (dy2 * xhat).sum(0), dy2.sum(0)


def check_rows(x2):
    """Raises unless x2 is (R, C) rows the row kernels take: C a multiple of
    4, at most MAX_CHANNELS; returns (R, C)."""
    if x2.dim() != 2:
        raise ValueError(f"expected (R, C) rows, got {tuple(x2.shape)}")
    r, c = x2.shape
    if c % 4 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"C = {c}: the kernels take a multiple of 4 from 4 to "
                         f"{MAX_CHANNELS}")
    return r, c


def _check(kernel, x2, **operands):
    """Raises unless x2 and the operands are what the row kernels take:
    contiguous float32 on x2's device, of x2's shapes, each starting on a
    16-byte boundary (they are read by ``float4``); returns (R, C)."""
    r, c = check_rows(x2)
    shapes = {"x": (r, c), "dy": (r, c), "gamma": (c,), "beta": (c,)}
    for name, t in dict(x=x2, **operands).items():
        _build.check_tensor(name, t, shapes[name], x2.device, kernel, aligned=True)
    return r, c


def _ln_forward_cuda(x2, gamma, beta, eps):
    global launches
    r, c = _check(KERNEL, x2, gamma=gamma, beta=beta)
    out = torch.empty_like(x2)
    fn = _build.declare(_build.load(KERNEL).ln_fwd_f32,
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                 r, c, eps, torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "ln_fwd_f32")
    launches += 1
    return out


def _ln_backward_cuda(x2, dy2, gamma, eps):
    global bwd_launches
    r, c = _check(BWD_KERNEL, x2, dy=dy2, gamma=gamma)
    dx = torch.empty_like(x2)
    sums = torch.empty((2, c), device=x2.device)
    part = torch.empty((-(-r // ROWS_PER_CTA), 2, c), device=x2.device)
    fn = _build.declare(_build.load(BWD_KERNEL).ln_bwd_f32,
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), dy2.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
                 sums.data_ptr(), part.data_ptr(), r, c, ROWS_PER_CTA, eps,
                 torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "ln_bwd_f32")
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
        return dx.reshape(dy.shape), dgamma, dbeta, None


def channel_layernorm(x, gamma, beta, eps=1e-5):
    """Differentiable LayerNorm over the last axis of ``x`` (leading dims
    flattened to rows), with (C,) ``gamma`` and ``beta``."""
    return _ChannelLayerNorm.apply(x.contiguous(), gamma, beta, eps)
