"""Fused LayerNorm -> W1 -> exact GELU -> W2 -> residual: the CUDA kernels
``csrc/mlp_fwd.cu`` and ``csrc/mlp_bwd.cu``, their plain PyTorch versions,
their launch counts and the autograd Function that joins them (counterpart
of ``pytorch_generative_tpu/ops/mlp_pallas.py``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor takes
the plain version. ``ln_mlp_residual`` is one autograd Function on both
devices, with the JAX package's three backward routes:

- ``_SAVE_PREACT = True`` (the default): the forward saves x, the (R, F)
  pre-activation y and the parameters, and the backward starts from the
  saved y (``ln_mlp_backward``);
- ``_SAVE_PREACT = False``: the forward keeps no y, and the backward
  recomputes it (``ln_mlp_backward_recompute``);
- ``PGT_MLP_BWD=pipe`` with a saved y, read when the backward runs: the
  backward in two skewed stages (``ln_mlp_backward_pipe``), on two streams
  on the card.

All three give the same gradients: on the card bit for bit, from the same
forward.

bf16 operands (x, the LayerNorm parameters and the weights all bf16: the
Trainer's ``compute_dtype``) take the kernels' bf16 mode, which rounds to
bf16 where ``mlp_pallas.py`` casts for bf16 operands (the plain versions
say where); out, y and dx are bf16, the parameter gradients are summed in
f32 and cast to the parameters' type by the autograd Function, as the JAX
package's ``_vjp_bwd`` casts them. bf16 takes C and F multiples of 8.
Every bf16 product runs on the wgmma GEMM of ``csrc/gemm_wgmma_bf16.cuh``
(128 x 128 tiles, a persistent grid of one CTA an SM), and the bf16
backward cuts its rows by its own plan (``bf16_backward_plan``).
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from pytorch_generative_tpu_torch.ops import _build, ln_cuda

KERNEL = "mlp_fwd"
BWD_KERNEL = "mlp_bwd"
# The backward's other routes: entries of csrc/mlp_bwd.cu.
RECOMPUTE_KERNEL = "mlp_bwd_recompute"
PIPE_KERNEL = "mlp_bwd_pipe"
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
# Rows per chunk of the backward's db1 = sum dy column sums.
ROWS_PER_CHUNK = 512
# The f32 products' CTA tile (csrc/mlp.cuh's kBM x kBN) and the CTAs of one
# wave of it on an H100: 132 SMs, two 4-warp CTAs an SM.
GEMM_TILE = (64, 128)
_WAVE_CTAS = 2 * 132
# The backward's dW1 and dW2 grids: the R rows are cut into enough slices
# for each grid to reach this many CTAs (four waves).
_TARGET_CTAS = 4 * _WAVE_CTAS
# The bf16 GEMM (csrc/gemm_wgmma_bf16.cuh): its CTA tile, one persistent
# CTA an SM walking the work items (132 on an H100), the dW products cut
# into enough slices for four items an SM; the dy product writes db1's
# partials a 64-row block at a time (rows per chunk). A bf16 slice is a
# multiple of the tile's 128 rows, and so of the GEMM's k-step (64) and of
# ln_cuda.ROWS_PER_CTA.
BF16_GEMM_TILE = (128, 128)
_BF16_WAVE = 132
_BF16_TARGET_TILES = 4 * _BF16_WAVE
BF16_ROWS_PER_CHUNK = 64
_BF16_SLICE_STEP = 128

# Whether the forward keeps the (R, F) pre-activation for the backward
# (mlp_pallas.py's module constant of the same name).
_SAVE_PREACT = True

# Kernel launches since the last reset; only _mlp_forward_cuda adds to
# `launches`, only _mlp_backward_cuda to `bwd_launches`,
# _mlp_backward_recompute_cuda to `recompute_launches` and
# _mlp_backward_pipe_cuda to `pipe_launches` (one per call, which runs
# several launches).
launches = 0
bwd_launches = 0
recompute_launches = 0
pipe_launches = 0
# The same for the bf16 mode's entries.
BF16_KERNEL = "mlp_fwd_bf16"
BF16_BWD_KERNEL = "mlp_bwd_bf16"
BF16_RECOMPUTE_KERNEL = "mlp_bwd_recompute_bf16"
BF16_PIPE_KERNEL = "mlp_bwd_pipe_bf16"
bf16_launches = 0
bf16_bwd_launches = 0
bf16_recompute_launches = 0
bf16_pipe_launches = 0

# The pipelined backward's second stream, one per device.
_back_streams: dict = {}


def _use_pipelined_bwd():
    """PGT_MLP_BWD=pipe, read when the backward runs, and a saved y (as
    ``mlp_pallas.py::_use_pipelined_bwd``)."""
    return os.environ.get("PGT_MLP_BWD", "mono") == "pipe" and _SAVE_PREACT


def _round(t, dtype):
    """t rounded to bf16 and back (nearest even) if dtype is bf16: a bf16
    kernel's operand where the JAX kernel casts; else t."""
    return t.to(dtype).float() if dtype == torch.bfloat16 else t


def _preact_plain(x2, gamma, beta, w1, b1, eps):
    """y = LN(x) W1 + b1 in the compute type (f32 for bf16 rows, LN(x)
    rounded to bf16 before the product)."""
    wide = ln_cuda.wide
    xhat, _ = ln_cuda.normalize(wide(x2), eps)
    return _round(xhat * wide(gamma) + wide(beta), x2.dtype) @ wide(w1) + wide(b1)


def ln_mlp_forward_plain(x2, gamma, beta, w1, b1, w2, b2, eps):
    """The forward kernel's plain version over (R, C) rows: (out, y), y the
    (R, F) pre-activation LN(x) W1 + b1 that the backward starts from. For
    bf16 rows: y is stored bf16 while gelu takes the f32 y, gelu(y) is
    rounded before W2, out = f32 sum + x, rounded (mlp_pallas.py:83-99)."""
    wide = ln_cuda.wide
    y = _preact_plain(x2, gamma, beta, w1, b1, eps)
    out = _round(F.gelu(y), x2.dtype) @ wide(w2) + wide(b2) + wide(x2)
    return out.to(x2.dtype), y.to(x2.dtype)


def ln_mlp_backward_plain(x2, do2, y2, gamma, beta, w1, b1, w2, eps):
    """The backward kernel's plain version, from the saved y (b1 enters
    only through y): (dx, dgamma, dbeta, dw1, db1, dw2, db2), written out
    as ``mlp_pallas.py::_bwd_kernel`` computes them. For bf16 rows, in f32
    from the bf16 y: gelu(y) and LN(x) rounded as the products' operands,
    dy rounded for dW1 and dln while db1 sums the f32 dy, dx rounded; the
    parameter gradients stay f32."""
    dt, wide = x2.dtype, ln_cuda.wide
    del b1
    x2, do2, y2, gamma, beta, w1, w2 = map(wide, (x2, do2, y2, gamma, beta, w1, w2))
    xhat, inv = ln_cuda.normalize(x2, eps)
    cdf = 0.5 * (1.0 + torch.erf(y2 * _SQRT_HALF))
    dgelu = cdf + y2 * (torch.exp(-0.5 * y2 * y2) * _INV_SQRT_2PI)
    dw2 = _round(F.gelu(y2), dt).T @ do2
    dy = (do2 @ w2.T) * dgelu
    dyc = _round(dy, dt)
    dw1 = _round(xhat * gamma + beta, dt).T @ dyc
    dln = dyc @ w1.T
    dxhat = dln * gamma
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * inv + do2  # + the residual path
    return (dx.to(dt), (dln * xhat).sum(0), dln.sum(0), dw1, dy.sum(0), dw2,
            do2.sum(0))


def ln_mlp_backward_recompute_plain(x2, do2, gamma, beta, w1, b1, w2, eps):
    """The recompute route's plain version: y = LN(x) W1 + b1 as the
    forward's plain version computes and stores it (rounded to bf16 for
    bf16 rows), then ``ln_mlp_backward_plain``."""
    y2 = _preact_plain(x2, gamma, beta, w1, b1, eps).to(x2.dtype)
    return ln_mlp_backward_plain(x2, do2, y2, gamma, beta, w1, b1, w2, eps)


def _dw_tiles(c, f, tile=GEMM_TILE):
    """CTA tiles of one slice's dW2 (F x C) or dW1 (C x F) product, the
    larger count of the two."""
    bm, bn = tile
    return max(-(-f // bm) * -(-c // bn), -(-c // bm) * -(-f // bn))


def backward_plan(r, c, f):
    """How every backward route cuts the R rows: (part_rows, slices,
    granule).

    The dW products run a part of their grid for each slice of part_rows
    rows: enough slices for one grid over all of them to reach
    _TARGET_CTAS (at least 1024 rows a slice), each a multiple of
    ln_cuda.ROWS_PER_CTA (64, whole CTAs of the LayerNorm backward's
    partial sums) and so of the GEMM's k-step (32). The saved-y and
    recompute routes launch all slices in one grid; the pipelined route
    launches `granule` consecutive slices at a time, as many as one wave
    of CTAs holds (at least one), so that each of its dW launches fills
    the card. Every route adds the slices' partials in slice order, so they
    give the same bits. Each partial buffer holds slices x C x F floats: at
    most max(C F, _TARGET_CTAS x 64 x 128) (33 MiB below C F = 8.65M).
    At R 50,176: C 512 gives 8 slices of 6,272 rows in granules of 2; C
    1024 2 slices of 25,088 rows, granules of 1."""
    tiles = _dw_tiles(c, f)
    slices = max(1, min(r // 1024, _TARGET_CTAS // tiles))
    part_rows = -(-r // (slices * ln_cuda.ROWS_PER_CTA)) * ln_cuda.ROWS_PER_CTA
    return part_rows, -(-r // part_rows), max(1, _WAVE_CTAS // tiles)


def bf16_backward_plan(r, c, f):
    """``backward_plan`` for bf16 rows, by the bf16 GEMM's constants: a
    slice is a multiple of 128 rows (the dy product's tile, so that the
    pipelined route's granules start on a tile and on a block of db1's
    partials; also a multiple of the k-step and of ln_cuda.ROWS_PER_CTA),
    enough slices for the dW products to reach _BF16_TARGET_TILES work
    items (at least 1024 rows a slice), and granules of as many slices as
    one CTA an SM covers (at least one). At R 50,176: C 512 gives 8 slices
    of 6,272 rows (64 tiles each) in granules of 2; C 1024 2 slices of
    25,088 rows (256 tiles each), granules of 1."""
    tiles = _dw_tiles(c, f, BF16_GEMM_TILE)
    slices = max(1, min(r // 1024, _BF16_TARGET_TILES // tiles))
    step = _BF16_SLICE_STEP
    part_rows = -(-r // (slices * step)) * step
    return part_rows, -(-r // part_rows), max(1, _BF16_WAVE // tiles)


def _rows_per_chunk(dtype):
    """Rows a partial of db1 sums: the f32 column-sum kernel's chunk, or
    the bf16 dy product's 64-row block."""
    return BF16_ROWS_PER_CHUNK if dtype == torch.bfloat16 else ROWS_PER_CHUNK


def _bwd_scratch(r, c, f, dev, n_wparts, dtype):
    """Scratch of one backward call: LN(x), gelu(y) and dy of the rows'
    type, dln, n_wparts buffers of per-slice dW partials, the per-CTA and
    per-chunk partial sums; and the plan (``backward_plan``, or
    ``bf16_backward_plan`` for bf16 rows)."""
    plan = (bf16_backward_plan if dtype == torch.bfloat16 else backward_plan)(r, c, f)
    return plan, (
        torch.empty((r, c), device=dev, dtype=dtype),                      # xn
        torch.empty((r, f), device=dev, dtype=dtype),                      # g
        torch.empty((r, f), device=dev, dtype=dtype),                      # dy
        torch.empty((r, c), device=dev),                                   # dln
        *(torch.empty((plan[1], c * f), device=dev) for _ in range(n_wparts)),
        torch.empty((-(-r // ln_cuda.ROWS_PER_CTA), 3, c), device=dev),    # rpart
        torch.empty((-(-r // _rows_per_chunk(dtype)), f), device=dev))     # cpart


def _check(kernel, x2, w1, **operands):
    """Raises unless the operands are contiguous, all float32 or all
    bfloat16, on x2's device, of shapes that fit x2 and w1, each starting
    on a 16-byte boundary (the LayerNorm reads 16 or 8 bytes at a time,
    the f32 GEMM by 16-byte ``cp.async``, the bf16 one by TMA)."""
    dtype = ln_cuda.kernel_dtype(x2)
    r, c = ln_cuda.check_rows(x2)
    vec = 8 if dtype == torch.bfloat16 else 4
    f = w1.shape[-1] if w1.dim() == 2 else -1
    if f <= 0 or f % vec:
        raise ValueError(f"w1 {tuple(w1.shape)}: F must be a positive multiple of {vec}")
    shapes = {"x": (r, c), "do": (r, c), "y": (r, f), "gamma": (c,),
              "beta": (c,), "w1": (c, f), "b1": (f,), "w2": (f, c), "b2": (c,)}
    for name, t in dict(operands, x=x2, w1=w1).items():
        _build.check_tensor(name, t, shapes[name], x2.device, kernel, dtype=dtype,
                            aligned=True)
    return r, c, f


def _count(name):
    """Adds one to the launch count called `name`."""
    globals()[name] += 1


def _entry(route, x2):
    """(C entry's name, launch count's name) of a route (fwd, bwd,
    bwd_recompute, bwd_pipe) for x2's type."""
    bf16 = x2.dtype == torch.bfloat16
    count = {"fwd": "launches", "bwd": "bwd_launches", "bwd_recompute": "recompute_launches",
             "bwd_pipe": "pipe_launches"}[route]
    return f"mlp_{route}_{'bf16' if bf16 else 'f32'}", ("bf16_" + count) if bf16 else count


def _mlp_forward_cuda(x2, gamma, beta, w1, b1, w2, b2, eps):
    r, c, f = _check(KERNEL, x2, w1, gamma=gamma, beta=beta, b1=b1, w2=w2, b2=b2)
    dev = x2.device
    out = torch.empty_like(x2)
    y = torch.empty((r, f), device=dev, dtype=x2.dtype)
    xn, g = torch.empty_like(x2), torch.empty_like(y)  # LN(x) and gelu(y), scratch
    entry, count = _entry("fwd", x2)
    fn = _build.declare(getattr(_build.load(KERNEL), entry),
                        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(*_ptrs(x2, gamma, beta, w1, b1, w2, b2, out, y, xn, g),
                 r, c, f, eps, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    _count(count)
    return out, y


def _bwd_outputs(x2, c, f):
    dev = x2.device
    return (torch.empty_like(x2), torch.empty((c, f), device=dev),
            torch.empty((f,), device=dev), torch.empty((f, c), device=dev),
            torch.empty((3, c), device=dev))  # dx, dw1, db1, dw2, (dgamma, dbeta, db2)


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _mlp_backward_cuda(x2, do2, y2, gamma, beta, w1, b1, w2, eps):
    r, c, f = _check(BWD_KERNEL, x2, w1, do=do2, y=y2, gamma=gamma, beta=beta,
                     b1=b1, w2=w2)
    outs = _bwd_outputs(x2, c, f)
    (part_rows, _, _), scratch = _bwd_scratch(r, c, f, x2.device, 1, x2.dtype)
    entry, count = _entry("bwd", x2)
    fn = _build.declare(getattr(_build.load(BWD_KERNEL), entry),
                        [ctypes.c_void_p] * (12 + len(scratch)) + [ctypes.c_int] * 6
                        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x2.device):
        err = fn(*_ptrs(x2, do2, y2, gamma, beta, w1, w2, *outs, *scratch),
                 r, c, f, part_rows, ln_cuda.ROWS_PER_CTA, _rows_per_chunk(x2.dtype), eps,
                 torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, entry)
    _count(count)
    dx, dw1, db1, dw2, sums = outs
    return dx, sums[0], sums[1], dw1, db1, dw2, sums[2]


def _mlp_backward_recompute_cuda(x2, do2, gamma, beta, w1, b1, w2, eps):
    r, c, f = _check(RECOMPUTE_KERNEL, x2, w1, do=do2, gamma=gamma, beta=beta,
                     b1=b1, w2=w2)
    outs = _bwd_outputs(x2, c, f)
    (part_rows, _, _), (xn, g, *scratch) = _bwd_scratch(r, c, f, x2.device, 1, x2.dtype)
    # y lives only inside this call.
    y = torch.empty((r, f), device=x2.device, dtype=x2.dtype)
    entry, count = _entry("bwd_recompute", x2)
    fn = _build.declare(getattr(_build.load(BWD_KERNEL), entry),
                        [ctypes.c_void_p] * (15 + len(scratch)) + [ctypes.c_int] * 6
                        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x2.device):
        err = fn(*_ptrs(x2, do2, gamma, beta, w1, b1, w2, *outs, xn, g, y, *scratch),
                 r, c, f, part_rows, ln_cuda.ROWS_PER_CTA, _rows_per_chunk(x2.dtype), eps,
                 torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, entry)
    _count(count)
    dx, dw1, db1, dw2, sums = outs
    return dx, sums[0], sums[1], dw1, db1, dw2, sums[2]


def _mlp_backward_pipe_cuda(x2, do2, y2, gamma, beta, w1, b1, w2, eps):
    r, c, f = _check(PIPE_KERNEL, x2, w1, do=do2, y=y2, gamma=gamma, beta=beta,
                     b1=b1, w2=w2)
    outs = _bwd_outputs(x2, c, f)
    (part_rows, _, granule), scratch = _bwd_scratch(r, c, f, x2.device, 2, x2.dtype)
    back = _back_streams.get(x2.device)
    if back is None:
        back = _back_streams[x2.device] = torch.cuda.Stream(x2.device)
    entry, count = _entry("bwd_pipe", x2)
    fn = _build.declare(getattr(_build.load(BWD_KERNEL), entry),
                        [ctypes.c_void_p] * (12 + len(scratch)) + [ctypes.c_int] * 7
                        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(x2.device):
        err = fn(*_ptrs(x2, do2, y2, gamma, beta, w1, w2, *outs, *scratch),
                 r, c, f, part_rows, ln_cuda.ROWS_PER_CTA, _rows_per_chunk(x2.dtype), granule,
                 eps,
                 torch.cuda.current_stream(x2.device).cuda_stream, back.cuda_stream)
    _build.check(err, entry)
    _count(count)
    dx, dw1, db1, dw2, sums = outs
    return dx, sums[0], sums[1], dw1, db1, dw2, sums[2]


def ln_mlp_forward(x2, gamma, beta, w1, b1, w2, b2, eps):
    """(out, y) of (R, C) rows."""
    return _build.dispatch(_mlp_forward_cuda, ln_mlp_forward_plain, x2, gamma,
                           beta, w1, b1, w2, b2, eps)


def ln_mlp_backward(x2, do2, y2, gamma, beta, w1, b1, w2, eps):
    """(dx, dgamma, dbeta, dw1, db1, dw2, db2) of (R, C) rows, from the
    saved y."""
    return _build.dispatch(_mlp_backward_cuda, ln_mlp_backward_plain, x2, do2,
                           y2, gamma, beta, w1, b1, w2, eps)


def ln_mlp_backward_recompute(x2, do2, gamma, beta, w1, b1, w2, eps):
    """The same gradients without a saved y: it is recomputed."""
    return _build.dispatch(_mlp_backward_recompute_cuda,
                           ln_mlp_backward_recompute_plain, x2, do2, gamma, beta,
                           w1, b1, w2, eps)


def ln_mlp_backward_pipe(x2, do2, y2, gamma, beta, w1, b1, w2, eps):
    """The same gradients from the saved y, in two skewed stages on two
    streams; its plain version is ``ln_mlp_backward_plain``."""
    return _build.dispatch(_mlp_backward_pipe_cuda, ln_mlp_backward_plain, x2,
                           do2, y2, gamma, beta, w1, b1, w2, eps)


class _LnMlpResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        out, y = ln_mlp_forward(x2, gamma, beta, w1, b1, w2, b2, eps)
        # Without _SAVE_PREACT, y is dropped here, once the forward's second
        # product has read it.
        ctx.save_for_backward(x2, y if _SAVE_PREACT else None, gamma, beta, w1, b1, w2)
        ctx.eps, ctx.b2_dtype = eps, b2.dtype
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, dout):
        x2, y, gamma, beta, w1, b1, w2 = ctx.saved_tensors
        do2 = dout.reshape(x2.shape).contiguous()
        if y is None:
            grads = ln_mlp_backward_recompute(x2, do2, gamma, beta, w1, b1, w2, ctx.eps)
        elif _use_pipelined_bwd():
            grads = ln_mlp_backward_pipe(x2, do2, y, gamma, beta, w1, b1, w2, ctx.eps)
        else:
            grads = ln_mlp_backward(x2, do2, y, gamma, beta, w1, b1, w2, ctx.eps)
        # The f32 sums cast to the parameters' types, as _vjp_bwd casts them.
        dtypes = (gamma.dtype, beta.dtype, w1.dtype, b1.dtype, w2.dtype, ctx.b2_dtype)
        return (grads[0].reshape(dout.shape),
                *(g.to(dt) for g, dt in zip(grads[1:], dtypes)), None)


def ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, eps=1e-5):
    """``x + gelu(LN(x) @ w1 + b1) @ w2 + b2``, differentiable, over the last
    axis of x (leading dims flattened to rows): gamma, beta (C,); w1 (C, F),
    b1 (F,); w2 (F, C), b2 (C,)."""
    return _LnMlpResidual.apply(x.contiguous(), gamma, beta, w1, b1, w2, b2, eps)
