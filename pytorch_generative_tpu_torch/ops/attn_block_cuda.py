"""The fused attention block: the QKV projection, causal flash attention and
the output projection from one C call, ``csrc/attn_block_fwd.cu`` (its
products on ``csrc/gemm_tf32x3.cuh``, its attention the tensor-core flash
forward of ``csrc/flash_fwd_mma.cuh``, all by 3xTF32), with its plain
PyTorch version, its launch counts and the autograd Function around it
(counterpart of ``pytorch_generative_tpu/ops/attn_block_pallas.py``, reached
through ``PGT_FUSED_ATTN=1``).

A CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor takes
the plain version. The Function saves x, the pre-Wo attention, lse and the
weights, as the JAX package's ``_vjp_fwd`` does. Its backward recomputes q,
k and v by the forward's own projection stage (``project``: on the card the
kernel's projection launches, on the CPU the plain version's products), so
that it differentiates through the forward's bits; the JAX package
recomputes them at another precision than its forward (a defect not
copied). The attention's backward is the flash backward kernel
(``attention_cuda.flash_backward``), and the projection gradients and dx
are ``torch.matmul``, as the JAX package leaves them to XLA.

bf16 operands (the Trainer's ``compute_dtype=torch.bfloat16``) take the
kernel's bf16 entries (``attn_block_fwd_bf16``, ``attn_block_project_bf16``;
counted in ``bf16_launches`` and ``bf16_project_launches``): the products on
the wgmma GEMM's tile-store epilogue, each f32 sum plus its bias rounded
to bf16 once and the tile stored by TMA, q and [k | v] in one launch (3
launches a forward, 1 a recompute), and the attention at the JAX block's
rounding points (q as it is, S scaled in f32;
``project_plain`` and ``attention_block_plain`` say where). On the card
their widths are multiples of 8. The backward's flash call then runs the
flash kernels' bf16 mode, as the JAX block calls ``_flash_backward``.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_generative_tpu_torch.ops import _build, attention_cuda

KERNEL = "attn_block_fwd"
# The backward's recompute of q, k and v: the kernel's projection stage, an
# entry of the same source, counted apart.
PROJECT_KERNEL = "attn_block_project"
# The head widths (d_k == d_v) the kernel takes: reproduce()'s 32,
# LARGE_CONFIG's 64 and bench.py's C = 512 model with 4 heads, 128.
HEAD_DIMS = (32, 64, 128)

# Kernel launches since the last reset; only _block_forward_cuda adds to
# `launches` (one per call, which launches the projection stage's two
# products, the flash forward and the output projection), only
# _project_cuda to `project_launches` (one per call: the two products).
launches = 0
project_launches = 0
# The same for the bf16 entries (a forward call is 3 launches: q and
# [k | v] in one product, the flash forward, the output projection; a
# projection call 1).
BF16_KERNEL = "attn_block_fwd_bf16"
BF16_PROJECT_KERNEL = "attn_block_project_bf16"
bf16_launches = 0
bf16_project_launches = 0


def _widths(x, wq, wkv, wo):
    """(B, L, C, E, O, C') of the operands, without checking them."""
    b, l, c = x.shape
    e = wq.shape[-1]
    return b, l, c, e, wkv.shape[-1] - e, wo.shape[-1]


def _bf16_affine(x, w, b):
    """bf16(x @ w + b) with the sum and the bias add in f32."""
    return (x.float() @ w.float() + b.float()).to(torch.bfloat16)


def project_plain(x, wq, bq, wkv, bkv):
    """The projection stage's plain version: (x @ wq + bq, x @ wkv + bkv);
    for bf16 operands each sum and bias add in f32, rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        return _bf16_affine(x, wq, bq), _bf16_affine(x, wkv, bkv)
    return x @ wq + bq, x @ wkv + bkv


def attention_block_plain(x, wq, bq, wkv, bkv, wo, bo, mask_center: bool,
                          n_heads: int):
    """The kernel's plain version: x @ wq + bq and x @ wkv + bkv, the plain
    flash forward over n_heads heads, then attn @ wo + bo. Returns (y
    (B, L, C'), attn (B, L, O), lse (B, H, L)), C' = wo.shape[1]. For bf16
    operands, at the JAX block's rounding points (attn_block_pallas.py:66-78,
    :95-113, :183-185): q, k and v rounded to bf16 once after the f32 sum
    and bias; S = (q k^T) * scale in f32 from q as it is (the flash kernel
    rounds q * scale * log2(e) to bf16 instead); P rounded to bf16 for P v;
    attn = bf16(O / l); lse f32; y = bf16(attn wo + bo) from the f32 sum."""
    e = wq.shape[-1]
    q, kv = project_plain(x, wq, bq, wkv, bkv)
    if x.dtype == torch.bfloat16:
        attn, lse = attention_cuda._flash_forward_bf16_plain(
            q, kv[..., :e], kv[..., e:], mask_center, n_heads, q2=False)
        return _bf16_affine(attn, wo, bo), attn, lse
    attn, lse = attention_cuda.flash_forward_plain(q, kv[..., :e], kv[..., e:],
                                                   mask_center, n_heads)
    return attn @ wo + bo, attn, lse


def _check(kernel, x, wq, bq, wkv, bkv, wo=None, bo=None, n_heads=None):
    """Raises unless the operands are contiguous, of x's type (float32 or
    bfloat16) and on x's device, of shapes that fit x, each starting on a
    16-byte boundary (the GEMMs copy 16 bytes at a time), at widths the
    kernel takes: every width a multiple of 4 (8 for bf16) and, with
    n_heads, d_k == d_v in HEAD_DIMS."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: the {kernel} kernel takes float32 or bfloat16, got {x.dtype}")
    vec = 16 // x.element_size()
    b, l, c, e, o, cout = _widths(x, wq, wkv, wq if wo is None else wo)
    if n_heads is not None and (e % n_heads or o % n_heads or e != o
                                or e // n_heads not in HEAD_DIMS):
        raise ValueError(f"q/k width {e} and v width {o} over {n_heads} heads: the "
                         f"{kernel} kernel takes d_k == d_v in {HEAD_DIMS}")
    if any(w % vec for w in (c, e, o, cout)):
        raise ValueError(f"widths x {c}, q/k {e}, v {o}, y {cout}: the {kernel} kernel "
                         f"takes multiples of {vec} for {x.dtype}")
    shapes = {"x": (b, l, c), "wq": (c, e), "bq": (e,), "wkv": (c, e + o),
              "bkv": (e + o,), "wo": (o, cout), "bo": (cout,)}
    operands = dict(x=x, wq=wq, bq=bq, wkv=wkv, bkv=bkv, wo=wo, bo=bo)
    for name, t in operands.items():
        if t is not None:
            _build.check_tensor(name, t, shapes[name], x.device, kernel, x.dtype, aligned=True)


def _block_forward_cuda(x, wq, bq, wkv, bkv, wo, bo, mask_center: bool,
                        n_heads: int):
    global launches, bf16_launches
    _check(KERNEL, x, wq, bq, wkv, bkv, wo, bo, n_heads)
    b, l, c, e, _, cout = _widths(x, wq, wkv, wo)
    dev, dt = x.device, x.dtype
    q = torch.empty((b, l, e), device=dev, dtype=dt)          # scratch of the projection
    kv = torch.empty((b, l, 2 * e), device=dev, dtype=dt)     # stage, freed after the call
    attn = torch.empty((b, l, e), device=dev, dtype=dt)
    lse = torch.empty((b, n_heads, l), device=dev)
    y = torch.empty((b, l, cout), device=dev, dtype=dt)
    bf16 = dt == torch.bfloat16
    entry = BF16_KERNEL if bf16 else "attn_block_fwd_f32"
    fn = _build.declare(getattr(_build.load(KERNEL), entry),
                        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in (x, wq, bq, wkv, bkv, wo, bo, q, kv, attn, lse, y)),
                 b, l, c, n_heads, e // n_heads, cout, int(mask_center),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return y, attn, lse


def _project_cuda(x, wq, bq, wkv, bkv):
    global project_launches, bf16_project_launches
    _check(PROJECT_KERNEL, x, wq, bq, wkv, bkv)
    b, l, c, e, o, _ = _widths(x, wq, wkv, wq)
    dev, dt = x.device, x.dtype
    q = torch.empty((b, l, e), device=dev, dtype=dt)
    kv = torch.empty((b, l, e + o), device=dev, dtype=dt)
    bf16 = dt == torch.bfloat16
    entry = BF16_PROJECT_KERNEL if bf16 else "attn_block_project_f32"
    fn = _build.declare(getattr(_build.load(KERNEL), entry),
                        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in (x, wq, bq, wkv, bkv, q, kv)), b * l, c, e, o,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    if bf16:
        bf16_project_launches += 1
    else:
        project_launches += 1
    return q, kv


def attention_block_forward(x, wq, bq, wkv, bkv, wo, bo, mask_center: bool,
                            n_heads: int):
    """(y (B, L, C'), attn (B, L, O), lse (B, H, L)) of x (B, L, C): wq
    (C, E), wkv (C, E + O), wo (O, C') with packed head-major features,
    biases 1-D."""
    return _build.dispatch(_block_forward_cuda, attention_block_plain, x, wq, bq,
                           wkv, bkv, wo, bo, mask_center, n_heads)


def project(x, wq, bq, wkv, bkv):
    """(q, kv) of x (B, L, C) as the forward's projection stage computes
    them."""
    return _build.dispatch(_project_cuda, project_plain, x, wq, bq, wkv, bkv)


class _AttentionBlockPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, bq, wkv, bkv, wo, bo, mask_center, n_heads):
        y, attn, lse = attention_block_forward(x, wq, bq, wkv, bkv, wo, bo,
                                               mask_center, n_heads)
        ctx.save_for_backward(x, attn, lse, wq, bq, wkv, bkv, wo)
        ctx.mask_center, ctx.n_heads = mask_center, n_heads
        return y

    @staticmethod
    def backward(ctx, gy):
        x, attn, lse, wq, bq, wkv, bkv, wo = ctx.saved_tensors
        gy = gy.contiguous()
        e = wq.shape[-1]
        rows = lambda t: t.reshape(-1, t.shape[-1])
        # Bias gradients summed in f32 and cast, as the JAX block's _vjp_bwd.
        col_sum = lambda t: rows(t).sum(0, dtype=torch.float32).to(t.dtype)
        # The output projection, from the saved attention.
        dwo = rows(attn).T @ rows(gy)
        dbo = col_sum(gy)
        dattn = gy @ wo.T
        # q, k and v as the forward computed them; then the flash backward.
        q, kv = project(x, wq, bq, wkv, bkv)
        dq, dk, dv = attention_cuda.flash_backward(
            q, kv[..., :e], kv[..., e:], attn, lse, dattn, ctx.mask_center, ctx.n_heads)
        dkv = torch.cat([dk, dv], dim=-1)
        dwq = rows(x).T @ rows(dq)
        dwkv = rows(x).T @ rows(dkv)
        dx = dq @ wq.T + dkv @ wkv.T
        return (dx, dwq, col_sum(dq), dwkv, col_sum(dkv), dwo, dbo, None, None)


def attention_block_packed(x, wq, bq, wkv, bkv, wo, bo, mask_center: bool,
                           n_heads: int):
    """``out_proj(flash_attention(q_proj(x), kv_proj(x)))``, differentiable,
    in one kernel call on the card: x (B, L, C); wq (C, E), wkv (C, E + O),
    wo (O, C') with packed head-major features; biases 1-D. Returns y
    (B, L, C'). Operands are float32 or bfloat16, all of one type."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wq, bq, wkv, bkv, wo, bo)):
        # The JAX block reads PGT_FLASH_PRECISION in its backward alone; a
        # block that will be differentiated checks it before the forward.
        attention_cuda._check_precision(x.dtype)
    return _AttentionBlockPacked.apply(x.contiguous(), wq, bq, wkv, bkv, wo, bo,
                                       mask_center, n_heads)
