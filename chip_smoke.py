#!/usr/bin/env python3
"""Drives the PyTorch port's ImageGPT serving and training paths once on one
CUDA card, at the reproduce() config (C = 64) and at ``LARGE_CONFIG``
(C = 512, 8 heads of 64, where every block takes the fused LayerNorm and
MLP kernels), then PixelSNAIL's at its reproduce() config.

    python3 chip_smoke.py

Phases, each printing one line or a few: the device (name and power limit
from nvidia-smi, TF32 pinned off); the build of every kernel of the paths
from ``pytorch_generative_tpu_torch/csrc``, one ``nvcc`` per source, all at
once; each kernel against its plain PyTorch version at the paths' shapes
(the flash kernels' tensor-core instances run twice and must give equal
bits; the whole-loop sampler's cluster kernel at n = 16 and 64, free and
inpainted, twice, after a line of its plan, registers, shared memory and
cudaOccupancyMaxActiveClusters at n = 16, 64 and 256); at C = 64 the serving path (``ImageGPT.forward`` with the reproduce() loss
at batch 64, then ``ImageGPT.sample`` of 16 images) and the training path
(``Trainer``: one epoch of 8 steps with eval, a checkpoint and a sample
grid, then a second Trainer that resumes from the checkpoint and takes one
more epoch), each with its kernels' launch counts; the training gradients
and a 3-step trajectory against the plain path on the CPU; CUDA-event times
of each kernel beside its plain version (the sampler's at n = 16, 64 and
256, with the plain version, bound and latency floor at 16), one PyTorch
call (or, for the fused
MLP, a composition of calls) that computes the same function
(``library_ms``) and its bound (for the flash kernels, the fused block and
the fused MLP both the bound at the 3xTF32 tensor-core rate, that of their
route, and the one at the f32 CUDA-core rate); the train step's time and a
``torch.profiler`` breakdown of it; then the same at C = 512: forward at
batch 64, three train steps, gradients and a 3-step trajectory against the
CPU at batch 2, times and the profiled train step. Then sampling on the
per-position step route, which replays one captured position as a CUDA
graph: the decode step kernel against its plain version at C = 512,
n = 16 (f32 and bf16 K/V cache, NaN in the stale cache positions) and
n = 64 at i = 65, the position given as an int and as a device tensor
(equal bits);
``ImageGPT(**LARGE_CONFIG).sample`` of 16 images, free and inpainted, f32
and bf16 cache, against the plain step route (784 step runs a call, no
whole loop); at C = 64 the step route for n = 4 and for a model with a
custom ``sample_fn``; the times of the C = 512 sample call, of the step at
i = 391 (eager, and one captured step replayed) and of its plain version,
with bounds, a profile of one sample call, and the host's time a position
(eager ops, one step call, one replay of the route's graph). Then
PixelSNAIL (``pixel_snail_phases``: 8
blocks of 2 residual blocks, C = 64, attention d_k 4 / d_v 32 with
mask_center): the flash kernels at (B 128, L 784, H 1, 4, 32) against their
plain versions; ``PixelSNAIL.forward`` at batch 128 (8 flash launches)
against the CPU; ``PixelSNAIL.sample`` at n = 16 and 64, free and
inpainted, against the whole-loop kernel's plain version (1 ``snail_loop``
launch a call); a Trainer epoch at batch 128 with eval and a sample grid;
gradients and 3 Adam steps against the CPU; times (the flash kernels
beside masked SDPA, the train step with a profile, the sample call and
kernel at n = 16 and 64 with bounds and a latency floor, a profiled sample
call). Then the widths the JAX package runs (``wide_phases``), VQ-VAE
(``vq_vae_phases``) and ImageGPT at ``LARGE_CONFIG`` with the fused
attention block (``PGT_FUSED_ATTN=1``) under the MLP backward's saved-y,
recompute and pipelined routes (``fused_attn_phases``): the block kernel
(two calls giving equal bits) and both routes against their plain
versions, the forward and a train step a route with their launches,
gradients and 3 Adam steps against the CPU, times (the block at its three
widths beside its composition, and its 3xTF32 GEMM beside
``torch.addmm``). Then ImageGPT's mixed-precision training,
``Trainer(compute_dtype=torch.bfloat16)`` (``bf16_phases``): the bf16 modes
of the flash kernels at d = 32, 64 and 128 (B 64, L 784) and of the
LayerNorm and fused MLP kernels at R = 50,176, C = 512 (and a ragged R)
against their plain versions, two calls giving equal bits and the MLP's
three backward routes the same bits, each timed beside its plain version,
its bound at the bf16 tensor-core rate (989 TFLOP/s) and a bf16 library
yardstick (causal SDPA, ``F.layer_norm``, the ``F.layer_norm`` ->
``addmm`` -> ``F.gelu`` -> ``addmm`` composition); a Trainer epoch of 3
steps with eval and a checkpoint at batch 64 at C = 64 (2 heads), C = 512
with 8 heads and with 4, each with its launches (bf16 kernels only, no
plain version called) and its step time; one bf16 step on each opt-in MLP
route; 3 Adam steps against the CPU's bf16 Trainer at C = 64 and C = 512.
Then the last three paths under ``compute_dtype=torch.bfloat16``
(``bf16_slice_phases``): PixelSNAIL at its reproduce() config, batch 128,
through the flash kernels' bf16 mode at (d_k, d_v) = (4, 32) (the backward
on bf16 ``mma.sync``, timed by pass); VQ-VAE at
its reproduce() config, batch 128, on the fused route (``PGT_FUSED_VQ=1``,
the vq kernel's bf16 rows, held bit for bit to the f32 kernel on the rows
widened to f32) and the unfused one; ImageGPT with the fused block
(``PGT_FUSED_ATTN=1``, its bf16 entries; the backward's recompute held bit
for bit to the forward's projection; the forward's 3 launches and the
recompute's 1 counted; its outputs, and the fused MLP's bf16 ones, held
to SHA-256 digests recorded on an H100 before its products moved to the
GEMM's tile-store epilogue) at C = 64 / 2 heads, C = 512 / 8 and / 4
heads, batch 64: each new kernel mode against its plain version and
timed beside it, its bound and a bf16 library yardstick; a bf16 Trainer
epoch of each with its launches, step time and a profiled step; 3 Adam
steps against the CPU's bf16 Trainer.
The line before the last is the per-kernel JSON summary;
the last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line; without a CUDA device it fails at once.
"""

import concurrent.futures
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
SEED = 0
N_SAMPLES = 16
# The whole-loop sampler is also checked at bench.py's n = 64 and timed at
# 16, 64 and 256 (its three cells).
SAMPLER_NS = (N_SAMPLES, 64, 256)
BATCH = 64
FLASH_TOL = 5e-5  # f32, another summation order than the dense version
# f32 too, but each gradient sums up to 784 rows or keys of p * dO or
# ds * q/k terms in another order than the dense einsum.
FLASH_BWD_TOL = 1e-4
FORWARD_TOL = 1e-4  # kernel path on the card vs plain path on the CPU
# Gradients, card kernel path vs CPU plain path, as a share of each group's
# largest gradient: f32 through 8 blocks, with the reductions of the
# attention, the GEMMs and the 784-pixel loss in other orders.
GRAD_RTOL = 1e-4
# Losses of 3 Adam steps, card vs CPU, relative: the step-1 gradients differ
# in their last bits (GRAD_RTOL), Adam's first updates are nearly
# sign(gradient) * lr, and the loss sums 784 pixels per image.
TRAJ_RTOL = 1e-4
TRAJ_BATCH = 8
# The fused LayerNorm and MLP kernels against their plain versions, as a
# share of each output's largest magnitude (f32 both). The LayerNorm sums
# run over 512 channels and, for dgamma and dbeta, over 50,176 rows; the
# MLP's over 512, 2048 and 50,176 terms; each in another order than the
# plain version's (cuBLAS, torch reductions).
LN_RTOL = 1e-5
MLP_RTOL = 1e-4
TRAIN_STEPS_LARGE = 3
# PixelSNAIL: reproduce()'s batch, the n of bench.py's two sampler cells,
# and the steps of its one training epoch.
SNAIL_BATCH = 128
SNAIL_N = (16, 64)
SNAIL_TRAIN_STEPS = 3
# The decode step kernel against its plain version, as a share of the
# largest |act|: f32 sums over 512, 2048 and up to 784 terms in another
# order (kv_new in bf16 may also round to the neighbouring bf16 value).
STEP_RTOL = 1e-4
STEP_POSITIONS = (0, 1, 391, 783)
TIMED_POSITION = 391
# Uniforms within this distance of the plain route's own probability are
# moved twice as far away before two sampler routes are compared.
NUDGE = 1e-3
# The wide instances, widths the JAX package runs: bench.py's C = 512
# ImageGPT with 4 heads has d = 128; ImageGPT routes every
# C % 128 == 0 to the fused LayerNorm and MLP kernels, so C = 640 and 1024
# are checked too (R = 8192 and a ragged R; times at C = 1024, R = 50,176).
WIDE_HEADS = 4
WIDE_C = (640, 1024)
WIDE_ROWS = 8192
# VQ-VAE reproduce(): batch 128, 8 x 8 latents a image, so M = 8192 rows
# against a 512 x 64 codebook; bench.py draws its batch as
# np.random.default_rng(1).random((128, 32, 32, 3)).
VQ_BATCH = 128
VQ_TRAIN_STEPS = 3
# Skewed inputs of the VQ kernel: rows next to 1 code (a collapsed
# codebook, as early VQ-VAE training gives) and next to 8.
VQ_SKEWS = (1, 8)
# Rows whose top-two scores (2 x.e - |e|^2, f32 sums over D = 64 terms in
# another order on each side) are closer than this share of the largest
# |score| may take either code; they are counted, and only they may differ.
VQ_NEAR_TIE = 1e-5
# The VQ kernel's sums against the plain version's one_hot.T @ x, as a share
# of the largest |sum|: row-order f32 sums of up to 8192 rows against a
# matrix product.
VQ_SUMS_RTOL = 1e-5
# The fused attention block (PGT_FUSED_ATTN=1) against its plain version:
# y and attn as a share of each one's largest magnitude (3xTF32 sums over C
# = 512 and the keys in another order than cuBLAS's), lse absolutely, as the
# flash forward's. Its widths: reproduce()'s C = 64 with 2 heads,
# LARGE_CONFIG's C = 512 with 8 and bench.py's C = 512 with 4.
BLOCK_RTOL = 1e-4
BLOCK_LSE_TOL = 5e-5
BLOCK_WIDTHS = ((64, 2), (512, 8), (512, 4))
# The MLP backward's routes: saved y (the default), recompute
# (_SAVE_PREACT = False) and the pipelined one (PGT_MLP_BWD=pipe).
MLP_ROUTES = ("saved", "recompute", "pipe")
# The bf16 modes (bf16_phases): kernel against plain version, both rounding
# to bf16 at the same points but summing in other orders, so an output may
# land one bf16 step (2^-8 of its size) apart: bf16 outputs within 2 steps
# of the plain version's largest magnitude; f32 statistics and the
# LayerNorm's parameter sums within 1e-6 and 1e-5 of it; the MLP's f32
# parameter sums within 5e-4 (dy is rounded to bf16 for dW1 and dln, and
# the two sides' dy may round apart).
BF16_TOL = 2.0 ** -7
BF16_LSE_RTOL = 1e-6
BF16_LN_SUM_RTOL = 1e-5
BF16_MLP_SUM_RTOL = 5e-4
# The bf16 Trainer's epoch at each configuration, and the steps timed after it.
BF16_TRAIN_STEPS = 3
BF16_TIMED_STEPS = 5
# Card against CPU, both Trainer(compute_dtype=torch.bfloat16), 3 Adam
# steps of lr 5e-3 from the same weights and batches: losses within
# BF16_LOSS_RTOL; each parameter tensor's update within BF16_UPDATE_RL2
# relative L2 of the CPU's (Adam turns a near-zero gradient's flipped sign
# into a step of about lr the other way; a wrong gradient gives about 1 or
# more); the key bias, whose exact gradient is 0 (both sides feed Adam
# rounding noise), within 3 steps of 4 lr: Adam's step exceeds lr where
# the noise's size changes from step to step.
BF16_LOSS_RTOL = 1e-2
# The bf16 fused block's lse against its plain version's, as a share of the
# largest |lse|: the two round q and k to bf16 from f32 sums taken in other
# orders, so an element may land one bf16 step apart and move the scores.
BF16_BLOCK_LSE_RTOL = 1e-3
# SHA-256 of the bf16 block's outputs (y, attn, lse, and the projection
# entry's q and kv) and of the fused MLP's bf16 outputs at fixed inputs
# (bf16_digest_outputs), as the kernels gave them on an H100 before the
# block's products moved to the GEMM's tile-store epilogue; every sum kept
# its order, so every bit stays (tests/test_torch_kernels.py holds the
# same digests).
BF16_DIGESTS = {
    "block C64 H2 mask_center": "44d92ec3aa7122ec1139a8c81a05c060e53655d1f8317ffd1d3652fc4b64a11d",
    "block C512 H8": "b755cfd87a012b4a6c6cda85e6a5b8497557e8daf3451c199c23147fb3d90135",
    "block C512 H4 mask_center": "42ea6604d61d7a6d54c49f1a67236ce4219a38617ba2e0b2fb78896efe961960",
    "mlp C512 forward": "6cf99f526ae3364a2d38d1227afbd2bf6b9f953b02eb33f761f28c460fc9a3d0",
    "mlp C512 backward": "b7bb8ae69104a8e75e8d690eab83075747f2a1ff32469440badabf078c9c026c",
}
BF16_UPDATE_RL2 = 0.35
BF16_KEY_BIAS_ATOL = 3 * 4 * 5e-3
# Bounds: NVIDIA's H100 SXM data sheet, at its 700 W limit.
F32_FLOPS = 67e12   # f32 on the CUDA cores, FMA = 2 operations
# f32-accurate products on the tensor cores: 3xTF32 (the flash kernels'
# d_k == d_v instances, the fused block's and the fused MLP's products)
# takes three TF32 products (495 TFLOP/s) per f32 one.
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES = 3.35e12  # HBM3 bytes/s
BF16_FLOPS = 989e12  # bf16 on the tensor cores, dense


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def max_err(a, b):
    """Max abs difference; equal infinities (lse of fully-masked rows) count 0."""
    same_inf = torch.isinf(a) & (a == b)
    diff = (a - b).abs().masked_fill(same_inf, 0.0)
    return float(diff.max())


def time_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, replays=10):
    """ms a call of fn on the card alone: replays of one CUDA graph of
    `calls` calls, so that the host's work a call is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / calls


def graph_kernels(fn):
    """The kernel launches of one call of fn: the kernel nodes of a CUDA
    graph captured from it (cudaGraphGetNodes and cudaGraphNodeGetType on
    the captured cudaGraph_t). torch.profiler is not used for this: once a
    process has profiled before, it may drop a share of the kernel
    records."""
    import ctypes

    fn()  # warm: builds, allocator blocks
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    rt = ctypes.CDLL("libcudart.so.12")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(rt.cudaGraphGetNodes(graph, None, ctypes.byref(count)) == 0, "cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(count)) == 0, "cudaGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cudaGraphNodeGetType failed")
        kinds.append(kind.value)
    del g
    return kinds.count(0)  # cudaGraphNodeTypeKernel


def launch_split(fn, n=20):
    """'kernel ms (launches), ...' a call of fn: device time by kernel from
    torch.profiler over n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key.replace("(anonymous namespace)::", "").split("(")[0],
             e.self_device_time_total / 1e3 / n, e.count / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return ", ".join(f"{name} {ms:.4f} ms ({count:g}x)" for name, ms, count in rows)


def ptxas_summary(log):
    """'function: registers, spills' for each entry function in an nvcc
    -Xptxas -v log (names demangled only as far as their template
    arguments)."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, spills = ln.split("'")[1], "spills not reported"
        elif "spill stores" in ln and name:
            spills = ln.split("bytes stack frame,")[-1].strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers, {spills}")
            name = None
    return " | ".join(out)


def bound(flops, nbytes, rate=F32_FLOPS):
    """(least ms, what binds): operations at ``rate`` (f32 on the CUDA cores
    unless given) vs bytes moved once at the HBM rate."""
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bounds(b, l, n_heads, d_k, d_v, mask_center, backward=False):
    """(route's bound, f32 bound, 3xTF32 bound) of a flash kernel, each
    (ms, what binds). The route's bound is the 3xTF32 one for the d_k ==
    d_v instances and for every backward, which run every product on the
    tensor cores, and the f32 one for the (4, 32) / (4, 8) forward (the
    SIMT pass on the CUDA cores)."""
    flops = flash_work(b, l, n_heads, d_k, d_v, mask_center, backward)
    nbytes = flash_bytes(b, l, n_heads, d_k, d_v, backward)
    f32, tc = bound(flops, nbytes), bound(flops, nbytes, TF32X3_FLOPS)
    return (tc if d_k == d_v or backward else f32), f32, tc


def flash_bounds_text(b, l, n_heads, d_k, d_v, mask_center, backward=False):
    """Both bounds of a flash kernel, the route's first."""
    _, f32, tc = flash_bounds(b, l, n_heads, d_k, d_v, mask_center, backward)
    f32_text = f"f32 bound {f32[0]:.4f} ms ({f32[1]})"
    tc_text = f"3xTF32 bound {tc[0]:.4f} ms ({tc[1]})"
    return f"{tc_text}, {f32_text}" if d_k == d_v or backward else f"{f32_text}, {tc_text}"


def check_flash_deterministic(q, k, v, dout, mask_center, n_heads, out, lse, grads, label):
    """Runs the flash kernels again on the same inputs and fails unless out,
    lse, dq, dk and dv equal the first call's bit for bit."""
    from pytorch_generative_tpu_torch.ops import attention_cuda

    out2, lse2 = attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
    grads2 = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, n_heads)
    same = [torch.equal(a, b) for a, b in zip((out, lse, *grads), (out2, lse2, *grads2))]
    print(f"phase flash {label}: two calls give equal bits (out, lse, dq, dk, dv): {same}",
          flush=True)
    check(all(same), f"the flash kernels gave other bits in a second call ({label})")


def flash_work(b, l, n_heads, d_k, d_v, mask_center, backward=False):
    """FLOPs over the causal (query, key) pairs: per pair and head 2 (d_k +
    d_v) forward (q.k and p.v), 2 (3 d_k + 2 d_v) backward (q.k, dO.v,
    p^T dO, ds k and ds^T q)."""
    pairs = l * (l - 1) // 2 if mask_center else l * (l + 1) // 2
    per_pair = 2 * (3 * d_k + 2 * d_v) if backward else 2 * (d_k + d_v)
    return per_pair * pairs * b * n_heads


def flash_bytes(b, l, n_heads, d_k, d_v, backward=False):
    """Bytes each read once or written once: forward q, k, v in, out and lse
    out; backward q, k, v, out, dout and lse in, dq, dk and dv out."""
    ck, cv = n_heads * d_k, n_heads * d_v
    if backward:
        return 4 * b * l * (2 * ck + 3 * cv + n_heads + 2 * ck + cv)
    return 4 * b * l * (2 * ck + 2 * cv + n_heads)


def sampler_flops(n, h, w, n_blocks, c):
    """Multiply-adds of the raster scan: per position the 4 conv taps and
    the head, per block QKV, out proj and MLP (24 C^2) and attention over
    the i + 1 cached positions (4 C (i + 1))."""
    seq = h * w
    per_block = 24 * c * c * seq + 2 * c * seq * (seq + 1)
    return n * (n_blocks * per_block + seq * 10 * c)


def sampler_latency_floor_ms(h, w, n_blocks):
    """A rough floor from the cluster sampler's dependency chain, not a
    measurement: per position and block 4 cluster barriers, each behind
    stores into the other ranks' shared memory (QKV, attention partials,
    out and MLP partials; 0.3 us each), one round of cache loads from L2
    (0.5 us), and 12 dependent CTA phases between them (products, their
    reductions, the merges, two LayerNorms; 0.05 us each, a shared-memory
    round trip and a CTA barrier)."""
    return h * w * n_blocks * (4 * 0.3 + 0.5 + 12 * 0.05) * 1e-3


def snail_work(n, h, w, n_blocks, n_rb, c, d_k, d_v):
    """FLOPs (2 per multiply-add) of the PixelSNAIL raster scan: per
    position the 4 input conv taps and the head (C x C/2, C/2 x 1); per
    block the residual blocks' 2x2 convs (4C x C and 4C x 2C, 24 C^2 each),
    q (C + 2 x d_k), out_proj (d_v x d_v), residual_out, attention_out,
    out and kv (C + 3 x d_k + d_v), and attention over the i cached
    positions (2 i (d_k + d_v)). Activations are not counted."""
    seq, c2 = h * w, c // 2
    per_block = n_rb * 24 * c * c + 2 * ((c + 2) * d_k + d_v * d_v + 2 * c * c + d_v * c
                                         + (c + 3) * (d_k + d_v))
    attention = 2 * (d_k + d_v) * seq * (seq - 1) // 2  # i keys at position i
    per_position = 2 * 4 * c + 2 * (c * c2 + c2)
    return n * (seq * (n_blocks * per_block + per_position) + n_blocks * attention)


def snail_latency_floor_ms(h, w, n_blocks, n_rb):
    """A rough floor from the cluster PixelSNAIL sampler's dependency chain,
    not a measurement: per position and block 2 cluster barriers a residual
    block and 1 after attention, each behind stores into the other ranks'
    shared memory (0.5 us: PR 13's `--stream` measured 0.49-0.61), one
    round of cache loads from L2 (0.5 us), and 4 dependent CTA phases a
    residual block plus 12 (q | kv, attention's parts, out_proj,
    residual_out, attention_out, out with their reductions; 0.05 us each, a
    shared-memory round trip and a CTA barrier); per position the head, the
    draw and the K/V append, 3 such phases."""
    per_block = (2 * n_rb + 1) * 0.5 + 0.5 + (4 * n_rb + 12) * 0.05
    return h * w * (n_blocks * per_block + 3 * 0.05) * 1e-3


def nudged_uniforms(model, canvas_sample, u, cond):
    """Moves every uniform within 1e-3 of sigmoid(teacher-forced logit) 2e-3
    away from it, on the side it was on, so that float-order differences
    between two samplers cannot flip a pixel."""
    with torch.no_grad():
        p = torch.sigmoid(model(canvas_sample)).reshape(u.shape[1], -1).T[..., None]
    return nudge_around(u, p, cond, NUDGE)


def nudge_around(u, p, cond, delta):
    """Moves every uniform of a sampled pixel within ``delta`` of ``p`` (the
    probability the reference route drew with) to 2 ``delta`` from it, on
    the side it was on: the reference's pixels stay, and a route whose
    probabilities differ by less than ``delta`` draws the same pixels."""
    d = u - p
    near = (d.abs() < delta) & (cond.reshape(u.shape[1], -1).T[..., None] < 0)
    side = torch.where(d >= 0, 1.0, -1.0)
    return torch.where(near, (p + 2 * delta * side).clamp(0.0, 1.0), u), int(near.sum())


def plain_step_route(model, cond, u, cache_dtype):
    """The step-route sampler with the step kernel's plain version, on the
    card: (images, the probability of every draw (L, N, 1))."""
    from pytorch_generative_tpu_torch.ops import decode_cuda, sampling

    acts = []

    def step(i, x, kv_cache, weights, n_heads):
        act, kv_new = decode_cuda.decode_step_plain(i, x, kv_cache, weights, n_heads)
        acts.append(act)
        return act, kv_new

    with torch.no_grad():
        images = sampling._image_gpt_decode_step(model, cond, u, cache_dtype, step=step)
        p = torch.sigmoid(torch.stack(acts) @ model.out_conv.weight + model.out_conv.bias)
    return images, p


def step_work(weights, n, i, cache_bytes):
    """(FLOPs, bytes) of one decode step at position i for n rows: per row
    and block the four products (2 (C F + c_v C + 2 C M)) and attention over
    i + 1 keys (2 (i + 1) (c_k + c_v)); every weight read once, the cache's i
    positions read, x read, act and kv_new (one position) written."""
    from pytorch_generative_tpu_torch.ops import decode_cuda

    n_blocks, c, f_qkv = weights["qkv_w"].shape
    c_v, m = weights["out_w"].shape[1], weights["mlp1_w"].shape[2]
    f = f_qkv - (f_qkv - c_v) // 2  # c_k + c_v
    flops = n * n_blocks * (2 * (c * f_qkv + c_v * c + 2 * c * m) + 2 * (i + 1) * f)
    nbytes = (4 * sum(weights[k].numel() for k in decode_cuda.STEP_WEIGHT_ORDER)
              + n_blocks * n * (i + 1) * f * cache_bytes + 2 * 4 * n * c)
    return flops, nbytes


def read_losses(log_dir):
    """{step: train loss} from a Trainer's metrics.jsonl (last record wins)."""
    losses, counts = {}, {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == "metrics/loss" and "train" in rec:
                losses[rec["step"]] = rec["train"]
                counts[rec["step"]] = counts.get(rec["step"], 0) + 1
    return losses, counts


def param_group(name):
    """ImageGPT: pos, input_conv, attn, ln (every LayerNorm), mlp or
    out_conv; PixelSNAIL: input_conv, residual_blocks, attention,
    branch_out (residual_out, attention_out, out), output_conv1 or
    output_conv2."""
    parts = name.split(".")
    part = parts[2] if parts[0] in ("blocks", "pixel_snail_blocks") else parts[0]
    return {"ln1": "ln", "ln2": "ln", "mlp_conv1": "mlp", "mlp_conv2": "mlp",
            "residual_out": "branch_out", "attention_out": "branch_out",
            "out": "branch_out"}.get(part, part)


def rel_err(got, want):
    """(max abs error, max |want|)."""
    return float((got - want).abs().max()), float(want.abs().max())


def ln_work(r, c):
    """(FLOPs, bytes) of the LayerNorm forward and backward over (r, c)
    rows: ~8 and ~18 operations per element; x read and y written, or x
    and dy read and dx written, plus the (c,) vectors."""
    return (8 * r * c, 4 * (2 * r * c + 2 * c)), (18 * r * c, 4 * (3 * r * c + 3 * c))


def mlp_work(r, c, f):
    """(FLOPs, bytes) of the fused MLP forward (two r x c x f products; x,
    weights and biases read, out and y written) and backward (four
    products; x, dO, y, weights read, dx, dW1, dW2 and the vectors
    written)."""
    vec = 2 * c + f + c
    fwd = (4 * r * c * f, 4 * (r * c + 2 * c * f + vec + r * c + r * f))
    bwd = (8 * r * c * f, 4 * (2 * r * c + r * f + 2 * c * f + 2 * c + r * c + 2 * c * f
                                + f + 3 * c))
    return fwd, bwd


def vq_work(m, k, d):
    """(FLOPs, bytes) of the fused VQ: the scores 2 M K D (the argmax and
    the statistics' adds are not counted); x read, quantized written, the
    codebook read, counts and sums written."""
    return 2 * m * k * d, 4 * (2 * m * d + 2 * k * d + k)


def vq_composition(x, cb):
    """The unfused route as PyTorch calls, the VQ kernel's yardstick: addmm
    scores, argmax, index_select, bincount and index_add_."""
    scores = torch.addmm((cb * cb).sum(1), x, cb.T, beta=-1.0, alpha=2.0)
    idx = scores.argmax(1)
    counts = torch.bincount(idx, minlength=cb.shape[0]).float()
    return cb.index_select(0, idx), counts, torch.zeros_like(cb).index_add_(0, idx, x)


def vq_against_plain(x, cb):
    """The VQ kernel against its plain version on (x, cb): (rows whose code
    differs, near-tie rows, max |quantized error| where the codes agree,
    counts equal, sums error, max |sum|). Fails unless every differing row
    is a near-tie holding one of its two best codes exactly (rounded to x's
    type, as the kernel writes its rows), counts sum to
    M and, where no row differs, counts are exact and sums within
    VQ_SUMS_RTOL."""
    from pytorch_generative_tpu_torch.ops import vq_cuda

    q, counts, sums = vq_cuda.vq_quantize_fused(x, cb)
    pq, pcounts, psums = vq_cuda.vq_quantize_plain(x, cb)
    torch.cuda.synchronize()
    scores = 2.0 * (x.double() @ cb.double().T) - (cb.double() ** 2).sum(1)
    top2 = scores.topk(2, dim=1)
    near = (top2.values[:, 0] - top2.values[:, 1]) <= VQ_NEAR_TIE * float(scores.abs().max())
    differ = (q != pq).any(dim=1)
    best = [cb[top2.indices[differ, j]].to(q.dtype) for j in (0, 1)]  # rows in x's type
    check(not bool((differ & ~near).any()), "the VQ kernel picks another code on a clear row")
    check(bool(((q[differ] == best[0]).all(1) | (q[differ] == best[1]).all(1)).all()),
          "a near-tie row holds neither of its two best codes")
    check(float(counts.sum()) == x.shape[0], f"VQ counts sum to {float(counts.sum())}")
    q_err = float((q[~differ] - pq[~differ]).abs().max()) if bool((~differ).any()) else 0.0
    s_err, s_max = rel_err(sums, psums)
    n_differ = int(differ.sum())
    counts_equal = bool(torch.equal(counts, pcounts))
    if not n_differ:
        check(q_err == 0.0 and counts_equal, "VQ quantized rows or counts disagree")
        check(s_err <= VQ_SUMS_RTOL * s_max, "VQ sums disagree")
    return n_differ, int(near.sum()), q_err, counts_equal, s_err, s_max


def fused_checks(rows, c, gen, dev):
    """The LayerNorm and MLP kernels (F = 4C) against their plain versions at
    each R of ``rows``, the MLP backward from the forward's own saved y;
    every output within LN_RTOL or MLP_RTOL of its largest magnitude.
    Returns the largest errors of (ln_fwd, ln_bwd, mlp_fwd, mlp_bwd)."""
    from pytorch_generative_tpu_torch.ops import ln_cuda, mlp_cuda

    f = 4 * c
    ln_err = ln_bwd_err = mlp_err = mlp_bwd_err = 0.0
    for r in rows:
        xr = (2.0 * torch.randn((r, c), generator=gen) + 0.5).to(dev)
        gamma = (1.0 + 0.1 * torch.randn((c,), generator=gen)).to(dev)
        beta = (0.1 * torch.randn((c,), generator=gen)).to(dev)
        dyr = torch.randn((r, c), generator=gen).to(dev)
        w1 = (torch.randn((c, f), generator=gen) / c ** 0.5).to(dev)
        b1 = (0.1 * torch.randn((f,), generator=gen)).to(dev)
        w2 = (torch.randn((f, c), generator=gen) / f ** 0.5).to(dev)
        b2 = (0.1 * torch.randn((c,), generator=gen)).to(dev)
        errs = {}
        errs["ln y"] = rel_err(ln_cuda.ln_forward(xr, gamma, beta, 1e-5),
                               ln_cuda.layernorm_forward_plain(xr, gamma, beta, 1e-5))
        for name, g_, w_ in zip(("ln dx", "ln dgamma", "ln dbeta"),
                                ln_cuda.ln_backward(xr, dyr, gamma, 1e-5),
                                ln_cuda.layernorm_backward_plain(xr, dyr, gamma, 1e-5)):
            errs[name] = rel_err(g_, w_)
        out_k, y_k = mlp_cuda.ln_mlp_forward(xr, gamma, beta, w1, b1, w2, b2, 1e-5)
        out_p, y_p = mlp_cuda.ln_mlp_forward_plain(xr, gamma, beta, w1, b1, w2, b2, 1e-5)
        errs["mlp out"], errs["mlp y"] = rel_err(out_k, out_p), rel_err(y_k, y_p)
        del out_p, y_p
        for name, g_, w_ in zip(
                ("mlp dx", "mlp dgamma", "mlp dbeta", "mlp dw1", "mlp db1", "mlp dw2", "mlp db2"),
                mlp_cuda.ln_mlp_backward(xr, dyr, y_k, gamma, beta, w1, b1, w2, 1e-5),
                mlp_cuda.ln_mlp_backward_plain(xr, dyr, y_k, gamma, beta, w1, b1, w2, 1e-5)):
            errs[name] = rel_err(g_, w_)
        torch.cuda.synchronize()
        print(f"phase fused kernels: R={r} C={c} F={f} max_abs_err (max |plain|): " + ", ".join(
            f"{k}={e:.3e} ({m:.3e})" for k, (e, m) in errs.items())
            + f" (tol LayerNorm {LN_RTOL}, MLP {MLP_RTOL} x max |plain|)", flush=True)
        for k, (e, m) in errs.items():
            check(e <= (LN_RTOL if k.startswith("ln") else MLP_RTOL) * m,
                  f"{k} kernel disagrees at C = {c}")
        ln_err = max(ln_err, errs["ln y"][0])
        ln_bwd_err = max(ln_bwd_err, *(errs[k][0] for k in ("ln dx", "ln dgamma", "ln dbeta")))
        mlp_err = max(mlp_err, errs["mlp out"][0], errs["mlp y"][0])
        mlp_bwd_err = max(mlp_bwd_err, *(e for k, (e, _) in errs.items()
                                         if k.startswith("mlp d")))
        del out_k, y_k
    return ln_err, ln_bwd_err, mlp_err, mlp_bwd_err


def fused_times_at(r, c, gen, dev, smi):
    """CUDA-event ms of the LayerNorm and MLP kernels (F = 4C) at (R, C)
    beside their plain versions, their bounds and a library yardstick the
    port never calls (F.layer_norm; for the MLP the composition F.layer_norm
    -> addmm -> F.gelu -> addmm -> + x, since no one PyTorch call computes
    it), each backward as autograd.grad through the yardstick. The MLP
    kernels' bound is the 3xTF32 one (their route: every product on the
    tensor cores), printed beside the f32 one. Returns ({kernel: {plain,
    kernel, library, kernel2}}, {kernel: bound}, {MLP kernel: f32 bound})."""
    from pytorch_generative_tpu_torch.ops import ln_cuda, mlp_cuda

    f = 4 * c
    xr = torch.randn((r, c), generator=gen).to(dev).requires_grad_()
    gamma = (1.0 + 0.1 * torch.randn((c,), generator=gen)).to(dev).requires_grad_()
    beta = (0.1 * torch.randn((c,), generator=gen)).to(dev).requires_grad_()
    w1 = (torch.randn((c, f), generator=gen) / c ** 0.5).to(dev).requires_grad_()
    b1 = (0.1 * torch.randn((f,), generator=gen)).to(dev).requires_grad_()
    w2 = (torch.randn((f, c), generator=gen) / f ** 0.5).to(dev).requires_grad_()
    b2 = (0.1 * torch.randn((c,), generator=gen)).to(dev).requires_grad_()
    dyr = torch.randn((r, c), generator=gen).to(dev)
    xd, gd, bd, w1d, b1d, w2d, b2d = (t.detach() for t in (xr, gamma, beta, w1, b1, w2, b2))
    _, y_k = mlp_cuda.ln_mlp_forward(xd, gd, bd, w1d, b1d, w2d, b2d, 1e-5)
    ln_lib_out = F.layer_norm(xr, (c,), gamma, beta, 1e-5)
    mlp_lib_out = torch.addmm(b2, F.gelu(torch.addmm(b1, F.layer_norm(
        xr, (c,), gamma, beta, 1e-5), w1)), w2) + xr

    def mlp_lib():
        with torch.no_grad():
            return torch.addmm(b2d, F.gelu(torch.addmm(b1d, F.layer_norm(
                xd, (c,), gd, bd, 1e-5), w1d)), w2d) + xd

    def ln_lib():
        with torch.no_grad():
            return F.layer_norm(xd, (c,), gd, bd, 1e-5)

    fused_fns = {
        "ln_fwd": (lambda: ln_cuda.ln_forward(xd, gd, bd, 1e-5),
                   lambda: ln_cuda.layernorm_forward_plain(xd, gd, bd, 1e-5), ln_lib, 20),
        "ln_bwd": (lambda: ln_cuda.ln_backward(xd, dyr, gd, 1e-5),
                   lambda: ln_cuda.layernorm_backward_plain(xd, dyr, gd, 1e-5),
                   lambda: torch.autograd.grad(ln_lib_out, (xr, gamma, beta), dyr,
                                               retain_graph=True), 20),
        "mlp_fwd": (lambda: mlp_cuda.ln_mlp_forward(xd, gd, bd, w1d, b1d, w2d, b2d, 1e-5),
                    lambda: mlp_cuda.ln_mlp_forward_plain(xd, gd, bd, w1d, b1d, w2d, b2d,
                                                          1e-5), mlp_lib, 5),
        "mlp_bwd": (lambda: mlp_cuda.ln_mlp_backward(xd, dyr, y_k, gd, bd, w1d, b1d, w2d, 1e-5),
                    lambda: mlp_cuda.ln_mlp_backward_plain(xd, dyr, y_k, gd, bd, w1d, b1d, w2d,
                                                           1e-5),
                    lambda: torch.autograd.grad(mlp_lib_out, (xr, gamma, beta, w1, b1, w2, b2),
                                                dyr, retain_graph=True), 5),
    }
    times = {}
    for name, (kern, plain, lib, iters) in fused_fns.items():
        times[name] = {"plain": time_ms(plain, iters, 2), "kernel": time_ms(kern, iters, 2),
                       "library": time_ms(lib, iters, 2), "kernel2": time_ms(kern, iters, 2)}
    (ln_fwd_work, ln_bwd_work), (mlp_fwd_work, mlp_bwd_work) = ln_work(r, c), mlp_work(r, c, f)
    bounds = {"ln_fwd": bound(*ln_fwd_work), "ln_bwd": bound(*ln_bwd_work),
              "mlp_fwd": bound(*mlp_fwd_work, TF32X3_FLOPS),
              "mlp_bwd": bound(*mlp_bwd_work, TF32X3_FLOPS)}
    bounds_f32 = {"mlp_fwd": bound(*mlp_fwd_work), "mlp_bwd": bound(*mlp_bwd_work)}
    lib_names = {"ln_fwd": "F.layer_norm", "ln_bwd": "autograd.grad through F.layer_norm",
                 "mlp_fwd": "composition", "mlp_bwd": "autograd.grad through the composition"}
    for name, t in times.items():
        b_ms, b_by = bounds[name]
        f32 = (f", f32 bound {bounds_f32[name][0]:.4f} ms ({bounds_f32[name][1]})"
               if name in bounds_f32 else "")
        print(f"phase times C={c} [{smi}]: {name} (R={r}, C={c}, F={f}) kernel "
              f"{t['kernel']:.4f}/{t['kernel2']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"{lib_names[name]} {t['library']:.4f} ms, "
              f"{'3xTF32 ' if name in bounds_f32 else ''}bound {b_ms:.4f} ms ({b_by}){f32}",
              flush=True)
    return times, bounds, bounds_f32


def grads_vs_cpu(model, cpu_model, xg, label):
    """Gradients of the reproduce loss on the card's kernel path vs the CPU
    plain path of the same weights, per parameter group, within GRAD_RTOL
    of the group's largest gradient."""
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt

    for net in (model, cpu_model):
        net.zero_grad(set_to_none=True)
    image_gpt.reproduce_loss(xg, None, model(xg)).backward()
    image_gpt.reproduce_loss(xg.cpu(), None, cpu_model(xg.cpu())).backward()
    grad_errs, grad_scales = {}, {}
    for (name, p), (_, pc) in zip(model.named_parameters(), cpu_model.named_parameters()):
        group = param_group(name)
        grad_errs[group] = max(grad_errs.get(group, 0.0), float((p.grad.cpu() - pc.grad).abs().max()))
        grad_scales[group] = max(grad_scales.get(group, 0.0), float(pc.grad.abs().max()))
    print(f"phase grads{label}: max_abs_err per group (max |grad|): " + ", ".join(
        f"{g}={grad_errs[g]:.3e} ({grad_scales[g]:.3e})" for g in grad_errs)
        + f" (tol {GRAD_RTOL} x max |grad|)", flush=True)
    check(all(grad_errs[g] <= GRAD_RTOL * grad_scales[g] for g in grad_errs),
          f"card gradients disagree with the CPU plain path{label}")


def trajectory(model, cpu_model, dev, batches, label, lr=5e-3):
    """Adam steps (reproduce()'s optimizer, ImageGPT's learning rate by
    default) on the card and on the CPU from the same weights and batches;
    the losses agree within TRAJ_RTOL."""
    from pytorch_generative_tpu_torch import optim, trainer
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt

    traj = {}
    for (where, net), key in zip(((dev, model), ("cpu", cpu_model)), ("card", "cpu")):
        t = trainer.Trainer(net, image_gpt.reproduce_loss,
                            optim.adam_multiplicative(lr, 0.999977), [], [],
                            log_dir=tempfile.mkdtemp(prefix="chip_smoke_traj_"),
                            use_tensorboard=False, device=where)
        traj[key] = [float(t.train_one_step(xb, None)[0]["loss"]) for xb in batches]
        shutil.rmtree(t.log_dir, ignore_errors=True)
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj["card"], traj["cpu"]))
    print(f"phase trajectory{label}: losses card {traj['card']} cpu {traj['cpu']} "
          f"max rel err {traj_err:.3e} (tol {TRAJ_RTOL})", flush=True)
    check(traj_err <= TRAJ_RTOL, f"{len(batches)}-step trajectory disagrees with the CPU{label}")


def flash_times(q, k, v, dout, n_heads, mask_center=False):
    """CUDA-event ms of the flash kernels, their plain versions and SDPA
    (forward; autograd.grad through it for the backward): causal SDPA, or
    with ``mask_center`` SDPA with an explicit boolean mask of the keys
    strictly before each query (row 0 has none and gives NaN there; it is
    only timed)."""
    from pytorch_generative_tpu_torch.ops import attention_cuda

    out, lse = attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
    q4, k4, v4 = (attention_cuda._unpack(t, n_heads).contiguous().requires_grad_()
                  for t in (q, k, v))
    l = q.shape[1]
    sdpa_kw = (dict(attn_mask=torch.ones((l, l), dtype=torch.bool, device=q.device).tril(-1))
               if mask_center else dict(is_causal=True))
    sdpa_out = F.scaled_dot_product_attention(q4, k4, v4, **sdpa_kw)
    dout4 = attention_cuda._unpack(dout, n_heads).contiguous()
    fwd = lambda: attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
    fwd_plain = lambda: attention_cuda.flash_forward_plain(q, k, v, mask_center, n_heads)

    def fwd_lib():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q4, k4, v4, **sdpa_kw)

    bwd = lambda: attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, n_heads)
    bwd_plain = lambda: attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, mask_center,
                                                            n_heads)
    bwd_lib = lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), dout4, retain_graph=True)
    times = {}
    for key, fn, iters in (("fwd_plain", fwd_plain, 10), ("fwd", fwd, 20), ("fwd_lib", fwd_lib, 20),
                           ("bwd_plain", bwd_plain, 5), ("bwd", bwd, 20), ("bwd_lib", bwd_lib, 20),
                           ("fwd2", fwd, 20), ("bwd2", bwd, 20)):
        times[key] = time_ms(fn, iters, 2)
    return times


def flash_times_line(label, smi, q, k, v, dout, n_heads):
    """Times the flash kernels (flash_times) at q's causal shape and prints
    them beside the plain versions, causal SDPA and the bounds."""
    b, l, ck = q.shape
    d = ck // n_heads
    t = flash_times(q, k, v, dout, n_heads)
    print(f"phase times {label} [{smi}]: flash_fwd (B={b}, L={l}, H={n_heads}, d={d}) "
          f"kernel {t['fwd']:.4f}/{t['fwd2']:.4f} ms, plain {t['fwd_plain']:.4f} ms, causal SDPA "
          f"{t['fwd_lib']:.4f} ms, {flash_bounds_text(b, l, n_heads, d, d, False)}; flash_bwd "
          f"kernel {t['bwd']:.4f}/{t['bwd2']:.4f} ms, plain {t['bwd_plain']:.4f} ms, SDPA "
          f"autograd.grad {t['bwd_lib']:.4f} ms, "
          f"{flash_bounds_text(b, l, n_heads, d, d, False, backward=True)}", flush=True)


def profile_steps(step, n_steps, step_ms, what, per_call, label, smi, focus, host=False):
    """torch.profiler over n_steps calls of ``step`` (``what``, of
    ``per_call`` = (count, unit) items): kernel time per call by kernel
    (user annotations dropped: Optimizer.step also carries a device range
    and would count its kernels twice), the device's idle share of the
    unprofiled call, the share of the kernels whose names hold one of
    ``focus`` and, with ``host``, the PyTorch ops' self CPU time. Returns
    a function of names: the ms a call of the kernels whose names hold any
    of them, and their share of the kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    wall0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - wall0) * 1e3
    events = [e for e in prof.key_averages() if not getattr(e, "is_user_annotation", False)]
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / n_steps
    shares = ", ".join(
        f"{name} {sum(r[1] for r in rows if name in r[0]) / n_steps:.3f} ms/call "
        f"({100 * sum(r[1] for r in rows if name in r[0]) / n_steps / device_ms:.1f}%)"
        for name in focus)
    count, unit = per_call
    # The profiler slows the host, so the idle share is taken against the
    # unprofiled call time.
    print(f"phase {label} [{smi}]: {what} {step_ms:.3f} ms "
          f"({count * 1000 / step_ms:.2f} {unit}/s); profiled ({n_steps} calls, "
          f"{window_ms / n_steps:.3f} ms/call under the profiler): kernel time {device_ms:.3f} "
          f"ms/call, device idle {100 * (1 - device_ms / step_ms):.1f}% of the unprofiled "
          f"call; {shares} of kernel time", flush=True)
    for key, ms, count in rows[:15]:
        print(f"phase {label}:   {ms / n_steps:9.4f} ms/call {count // n_steps:6d} "
              f"launches/call  {key[:110]}", flush=True)
    if host:
        ops = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0),
                     key=lambda r: -r[1])
        print(f"phase {label}: host, PyTorch ops' self CPU time under the profiler "
              f"{sum(r[1] for r in ops) / n_steps:.3f} ms/call; top: " + ", ".join(
                  f"{key} {ms / n_steps:.3f} ms/{count // n_steps}" for key, ms, count in ops[:8]),
              flush=True)

    def share(*names):
        ms = sum(r[1] for r in rows if any(n in r[0] for n in names)) / n_steps
        return ms, 100 * ms / device_ms

    return share


def wide_phases(dev, gen, smi, reset_counts, read_counts):
    """The widths the JAX package runs beyond the first kernels' reach:
    the flash kernels' d = 128 instance at bench.py's C = 512
    4-head shape (B 64, L 784, H 4) against the plain version, with times;
    the LayerNorm and MLP kernels at C = 640 and 1024 (R = 8192 and a
    ragged R) against theirs, with times at C = 1024, R = 50,176; and
    ImageGPT(**LARGE_CONFIG) with 4 heads through the entry points: a
    forward at batch 64 against the CPU at batch 2 and one Trainer step.
    Returns d, the largest errors and the launch counts."""
    from pytorch_generative_tpu_torch import optim, trainer
    from pytorch_generative_tpu_torch.models import ImageGPT
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
    from pytorch_generative_tpu_torch.ops import attention_cuda, ln_cuda, mlp_cuda

    cfg = dict(image_gpt.LARGE_CONFIG, n_attention_heads=WIDE_HEADS)
    h, w, _ = cfg["in_shape"]
    c, nb = cfg["n_embedding_channels"], cfg["n_transformer_blocks"]
    d = c // WIDE_HEADS
    l = h * w

    # Phase W1: flash at d = 128, (B 64, L 784, H 4) and a ragged L with
    # mask_center, k and v feature slices of one kv tensor.
    flash_err = bwd_err = 0.0
    for ll, mask_center in ((l, False), (200, True)):
        q = torch.randn((BATCH, ll, c), generator=gen).to(dev)
        kv = torch.randn((BATCH, ll, 2 * c), generator=gen).to(dev)
        dout = torch.randn((BATCH, ll, c), generator=gen).to(dev)
        k, v = kv[..., :c], kv[..., c:]
        out, lse = attention_cuda.flash_forward(q, k, v, mask_center, WIDE_HEADS)
        ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, mask_center, WIDE_HEADS)
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        del ref_out, ref_lse
        grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, WIDE_HEADS)
        e_grads = [max_err(g, r) for g, r in zip(grads, attention_cuda.flash_backward_plain(
            q, k, v, out, lse, dout, mask_center, WIDE_HEADS))]
        torch.cuda.synchronize()
        flash_err, bwd_err = max(flash_err, e_out, e_lse), max(bwd_err, *e_grads)
        print(f"phase flash d={d}: B={BATCH} L={ll} H={WIDE_HEADS} mask_center={mask_center} "
              f"max_abs_err out={e_out:.3e} lse={e_lse:.3e} (tol {FLASH_TOL}); backward "
              f"dq={e_grads[0]:.3e} dk={e_grads[1]:.3e} dv={e_grads[2]:.3e} (tol "
              f"{FLASH_BWD_TOL})", flush=True)
        check(e_out <= FLASH_TOL and e_lse <= FLASH_TOL, "flash forward disagrees at d = 128")
        check(max(e_grads) <= FLASH_BWD_TOL, "flash backward disagrees at d = 128")
        if mask_center:
            check(bool((out[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all())
                  and bool((grads[0][:, 0] == 0).all()),
                  "row 0 under mask_center is not out 0, lse -inf, dq 0 at d = 128")
        check_flash_deterministic(q, k, v, dout, mask_center, WIDE_HEADS, out, lse, grads,
                                  f"d={d} L={ll} mask_center={mask_center}")
        del kv, out, lse, grads
    q = torch.randn((BATCH, l, c), generator=gen).to(dev)
    kv = torch.randn((BATCH, l, 2 * c), generator=gen).to(dev)
    dout = torch.randn((BATCH, l, c), generator=gen).to(dev)
    flash_times_line(f"d={d}", smi, q, kv[..., :c], kv[..., c:], dout, WIDE_HEADS)
    del q, kv, dout

    # Phase W2: the LayerNorm and MLP kernels at C = 640 and 1024, on the
    # CTA-per-row path, then their times at C = 1024, R = 50,176 (ImageGPT's
    # rows at batch 64).
    fused_errs = [0.0] * 4
    for cw in WIDE_C:
        fused_errs = [max(a, b) for a, b in zip(
            fused_errs, fused_checks((WIDE_ROWS, WIDE_ROWS - 7), cw, gen, dev))]
    fused_times_at(BATCH * l, WIDE_C[-1], gen, dev, smi)

    # Phase W3: ImageGPT at C = 512 with 4 heads (d = 128) through the entry
    # points: per forward 9 LayerNorms, 8 fused MLPs and 8 flash forwards at
    # d = 128; the same weights on the CPU's plain path at batch 2; then one
    # Trainer step (forward and backward of each).
    model = ImageGPT(**cfg, generator=gen, device=dev)
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape, generator=gen))
    model.eval()
    x = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.3).float().to(dev)
    reset_counts()
    with torch.no_grad():
        logits = model(x)
        loss = image_gpt.reproduce_loss(x, None, logits)
    torch.cuda.synchronize()
    serve_counts = read_counts()
    want = {k_: 0 for k_ in serve_counts}
    want.update({ln_cuda.KERNEL: nb + 1, mlp_cuda.KERNEL: nb, attention_cuda.KERNEL: nb})
    print(f"phase serve C={c} H={WIDE_HEADS}: forward logits {tuple(logits.shape)} "
          f"nll={float(loss):.4f} nats/image; launches={serve_counts}", flush=True)
    check(logits.shape == (BATCH, h, w, 1) and bool(torch.isfinite(logits).all()),
          "bad logits at C = 512, 4 heads")
    check(serve_counts == want, f"4-head forward launches {serve_counts}, expected {want}")
    cpu_model = ImageGPT(**cfg, device="cpu")
    cpu_model.load_state_dict({k_: t.cpu() for k_, t in model.state_dict().items()})
    with torch.no_grad():
        ref = cpu_model(x[:2].cpu())
    fwd_err = float((logits[:2].cpu() - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"phase serve C={c} H={WIDE_HEADS}: forward vs plain CPU forward (batch 2) "
          f"max_abs_err={fwd_err:.3e} (tol {FORWARD_TOL} x max(1, max |logit|) = "
          f"{FORWARD_TOL * scale:.3e})", flush=True)
    check(fwd_err <= FORWARD_TOL * scale, "4-head forward disagrees with the CPU")
    del cpu_model, logits, ref
    step_trainer = trainer.Trainer(
        model, image_gpt.reproduce_loss, optim.adam_multiplicative(5e-3, 0.999977), [], [],
        log_dir=tempfile.mkdtemp(prefix="chip_smoke_wide_"), use_tensorboard=False, device=dev)
    xb = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
    reset_counts()
    step_loss = float(step_trainer.train_one_step(xb, None)[0]["loss"])
    torch.cuda.synchronize()
    train_counts = read_counts()
    want.update({ln_cuda.BWD_KERNEL: nb + 1, mlp_cuda.BWD_KERNEL: nb,
                 attention_cuda.BWD_KERNEL: nb})
    step_ms = time_ms(lambda: step_trainer.train_one_step(xb, None), 2, 1)
    print(f"phase train C={c} H={WIDE_HEADS} [{smi}]: one step at batch {BATCH}, loss "
          f"{step_loss:.3f}; launches={train_counts}; step {step_ms:.3f} ms "
          f"({BATCH * 1000 / step_ms:.2f} samples/s)", flush=True)
    check(math.isfinite(step_loss), "the 4-head train step gave a non-finite loss")
    check(train_counts == want, f"4-head train launches {train_counts}, expected {want}")
    profile_steps(lambda: step_trainer.train_one_step(xb, None), 2, step_ms,
                  f"train step batch {BATCH}", (BATCH, "samples"), f"step C={c} H={WIDE_HEADS}",
                  smi, ("gemm_kernel", "flash_bwd", "flash_fwd", "ln_bwd_rows", "ln_fwd"))
    shutil.rmtree(step_trainer.log_dir, ignore_errors=True)
    return {"d": d, "flash_err": flash_err, "bwd_err": bwd_err, "fused_errs": fused_errs,
            "counts": [serve_counts, train_counts]}


def vq_group(name):
    """VQ-VAE parameter groups: the module path's first two parts
    (encoder.down_convs, quantizer.conv, decoder.up_convs, ...)."""
    return ".".join(name.split(".")[:2])


def vq_vae_phases(dev, gen, smi, reset_counts, read_counts):
    """VQ-VAE at its reproduce() config (32x32x3, hidden 128, 2 residual
    blocks of 32, a 512 x 64 EMA codebook, batch 128, adam_multiplicative(
    2e-4, 0.999977)), with PGT_FUSED_VQ=1 so that the quantizer takes the
    fused kernel: the kernel against its plain version at M = 8192, 8191
    and 300, on a codebook with duplicated rows and on rows next to 1 and to
    8 codes, two calls giving equal bits, with times (eager and as a CUDA
    graph, the skewed inputs too), both bounds and the device time by
    launch; the forward
    (eval mode) at batch 128 on bench.py's data against the CPU, launches
    on both routes; a Trainer epoch at batch 128; gradients and 3 steps
    (parameters and EMA buffers) against the CPU; step and forward times on
    both routes and a profiled step. Returns the launch counts of the runs
    of its main path and the vq kernel's entry of the per-kernel summary."""
    from pytorch_generative_tpu_torch import optim, trainer
    from pytorch_generative_tpu_torch.models import VectorQuantizedVAE
    from pytorch_generative_tpu_torch.models.vae import vq_vae
    from pytorch_generative_tpu_torch.ops import vq as vq_ops
    from pytorch_generative_tpu_torch.ops import vq_cuda

    os.environ["PGT_FUSED_VQ"] = "1"  # read when a VectorQuantizer is built
    cfg = vq_vae.REPRODUCE_CONFIG
    k, d = cfg["n_embeddings"], cfg["embedding_dim"]
    h, w, c_in = cfg["in_shape"]
    m = VQ_BATCH * (h // 4) * (w // 4)

    # Phase V1: the kernel against its plain version at the path's shape
    # (M = 8192 rows of N(0, 1) against a N(0, 1) codebook), ragged M and a
    # codebook whose rows 7 and 300 repeat row 3 (ties go to 3).
    x = torch.randn((m, d), generator=gen).to(dev)
    cb = torch.randn((k, d), generator=gen).to(dev)
    cb_dup = cb.clone()
    cb_dup[[7, 300]] = cb[3]
    x_dup = x.clone()
    x_dup[:1000] = cb[3] + 0.01 * torch.randn((1000, d), generator=gen).to(dev)
    vq_err = 0.0
    for label, xx, cc in ((f"M={m}", x, cb), (f"M={m - 1}", x[:m - 1], cb),
                          ("M=300", x[:300], cb), ("duplicated rows", x_dup, cb_dup)):
        n_differ, n_near, q_err, counts_eq, s_err, s_max = vq_against_plain(xx, cc)
        vq_err = max(vq_err, q_err, s_err)
        extra = ""
        if label == "duplicated rows":
            _, counts, _ = vq_cuda.vq_quantize_fused(xx, cc)
            extra = (f"; counts of code 3 / 7 / 300: {int(counts[3])} / {int(counts[7])} / "
                     f"{int(counts[300])}")
            check(int(counts[3]) >= 1000 and int(counts[7]) == int(counts[300]) == 0,
                  "an exact tie did not go to the first index")
        print(f"phase vq kernel: {label} K={cc.shape[0]} D={d}: rows whose code differs "
              f"{n_differ} (near-tie rows {n_near}, gap <= {VQ_NEAR_TIE} x max |score|); "
              f"quantized max_abs_err where codes agree {q_err:.3e}; counts equal "
              f"{counts_eq}; sums max_abs_err {s_err:.3e} (max |sum| {s_max:.3e}, tol "
              f"{VQ_SUMS_RTOL} x max |sum|){extra}", flush=True)
    # Two calls give equal bits (no atomics); the kernel on a collapsed
    # codebook (every row next to one code) and on rows next to 8 codes.
    first, second = vq_cuda.vq_quantize_fused(x, cb), vq_cuda.vq_quantize_fused(x, cb)
    same = [torch.equal(a_, b_) for a_, b_ in zip(first, second)]
    print(f"phase vq kernel: two calls give equal bits (quantized, counts, sums): {same}",
          flush=True)
    check(all(same), "the VQ kernel gave other bits in a second call")
    del first, second
    skewed = {}
    for n_codes in VQ_SKEWS:
        codes = torch.arange(m, device=dev) % n_codes * 61 % k
        skewed[n_codes] = cb[codes] + 0.01 * torch.randn((m, d), generator=gen).to(dev)
        n_differ, _, q_err, counts_eq, s_err, s_max = vq_against_plain(skewed[n_codes], cb)
        vq_err = max(vq_err, q_err, s_err)
        print(f"phase vq kernel: rows next to {n_codes} code(s): rows whose code differs "
              f"{n_differ}; counts equal {counts_eq}; sums max_abs_err {s_err:.3e} (max |sum| "
              f"{s_max:.3e})", flush=True)
        check(n_differ == 0 and counts_eq, f"VQ kernel on rows next to {n_codes} code(s)")
    vq_times = {"kernel": time_ms(lambda: vq_cuda.vq_quantize_fused(x, cb), 50, 5),
                "plain": time_ms(lambda: vq_cuda.vq_quantize_plain(x, cb), 20, 3),
                "library": time_ms(lambda: vq_composition(x, cb), 50, 5),
                "kernel2": time_ms(lambda: vq_cuda.vq_quantize_fused(x, cb), 50, 5),
                "graph": graph_ms(lambda: vq_cuda.vq_quantize_fused(x, cb)),
                **{f"skew{n}": time_ms(lambda: vq_cuda.vq_quantize_fused(xs_, cb), 50, 5)
                   for n, xs_ in skewed.items()},
                **{f"skew{n}_graph": graph_ms(lambda: vq_cuda.vq_quantize_fused(xs_, cb))
                   for n, xs_ in skewed.items()}}
    vq_bound = bound(*vq_work(m, k, d), TF32X3_FLOPS)  # the route's: 3xTF32 products
    vq_bound_f32 = bound(*vq_work(m, k, d))
    print(f"phase times vq [{smi}]: (M={m}, K={k}, D={d}) kernel {vq_times['kernel']:.4f}/"
          f"{vq_times['kernel2']:.4f} ms (the card's alone, as a CUDA graph of 20 calls, "
          f"{vq_times['graph']:.4f} ms), plain {vq_times['plain']:.4f} ms, composition "
          f"(addmm, argmax, index_select, bincount, index_add_) {vq_times['library']:.4f} ms, "
          f"3xTF32 bound {vq_bound[0]:.4f} ms ({vq_bound[1]}), f32 bound {vq_bound_f32[0]:.4f} "
          f"ms ({vq_bound_f32[1]}); rows next to " + ", ".join(
              f"{n} code(s) {vq_times[f'skew{n}']:.4f} ms (graph {vq_times[f'skew{n}_graph']:.4f})"
              for n in VQ_SKEWS), flush=True)
    print("phase times vq: device ms a call by launch (torch.profiler, 20 calls): " + " | ".join(
        f"{label}: {launch_split(lambda: vq_cuda.vq_quantize_fused(xs_, cb))}"
        for label, xs_ in (("spread", x), *((f"{n} code(s)", v_) for n, v_ in skewed.items()))),
        flush=True)
    del x, cb, cb_dup, x_dup, skewed

    # Phase V2: serving: the forward in eval mode at batch 128 on bench.py's
    # data through the entry point, on the fused route (1 vq launch) and
    # the unfused one (none); then against the CPU's plain path with the
    # same weights: the encoder's latents, the codes (near-ties counted),
    # and the decoder on the card's codes.
    xs = torch.from_numpy(np.random.default_rng(1).random(
        (VQ_BATCH, h, w, c_in)).astype(np.float32)).to(dev)
    model = VectorQuantizedVAE(**cfg, generator=torch.Generator().manual_seed(SEED),
                               device=dev).eval()
    unfused = VectorQuantizedVAE(**cfg, use_fused=False, device=dev).eval()
    unfused.load_state_dict(model.state_dict())
    check(model.quantizer.vq.fused(xs) and not unfused.quantizer.vq.fused(xs),
          "PGT_FUSED_VQ=1 did not select the fused route")
    serve_counts = {}
    outs = {}
    for route, net in (("fused", model), ("unfused", unfused)):
        reset_counts()
        with torch.no_grad():
            outs[route] = net(xs)
        torch.cuda.synchronize()
        serve_counts[route] = read_counts()
        want = {k_: 0 for k_ in serve_counts[route]}
        want[vq_cuda.KERNEL] = 1 if route == "fused" else 0
        check(serve_counts[route] == want,
              f"VQ-VAE {route} forward launches {serve_counts[route]}, expected {want}")
    out, loss = outs["fused"]
    route_diff = float((out - outs["unfused"][0]).abs().max())
    print(f"phase serve VQ-VAE: forward (eval) reconstruction {tuple(out.shape)} vq_loss "
          f"{float(loss):.6f}; launches fused {serve_counts['fused']}, unfused "
          f"{serve_counts['unfused']}; fused vs unfused route max_abs_err {route_diff:.3e}",
          flush=True)
    check(out.shape == (VQ_BATCH, h, w, c_in) and bool(torch.isfinite(out).all()),
          "bad VQ-VAE reconstruction")
    cpu = VectorQuantizedVAE(**cfg, device="cpu").eval()
    cpu.load_state_dict({k_: t.cpu() for k_, t in model.state_dict().items()})
    with torch.no_grad():
        z = model.quantizer.conv(model.encoder(xs)).reshape(-1, d)
        z_cpu = cpu.quantizer.conv(cpu.encoder(xs.cpu())).reshape(-1, d)
        codebook = model.quantizer.vq.ema_embedding
        n_differ, n_near, q_err, _, _, _ = vq_against_plain(z, codebook)
        q_card, _, _ = vq_cuda.vq_quantize_fused(z, codebook)
        ref_out, ref_loss = cpu(xs.cpu())
        ref_dec = cpu.decoder(q_card.cpu().reshape(VQ_BATCH, h // 4, w // 4, d))
    cb_cpu = codebook.cpu().double()
    scores = 2.0 * z_cpu.double() @ cb_cpu.T - (cb_cpu ** 2).sum(1)
    top2 = scores.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= VQ_NEAR_TIE * float(scores.abs().max())
    code_differ = vq_ops.nearest_codebook(z.cpu(), codebook.cpu()) != vq_ops.nearest_codebook(
        z_cpu, codebook.cpu())
    z_err = float((z.cpu() - z_cpu).abs().max())
    z_scale = max(1.0, float(z_cpu.abs().max()))
    dec_err = float((out.cpu() - ref_dec).abs().max())
    scale = max(1.0, float(ref_dec.abs().max()))
    full_err = float((out.cpu() - ref_out).abs().max())
    print(f"phase serve VQ-VAE: vs the CPU plain path (batch {VQ_BATCH}): latents max_abs_err "
          f"{z_err:.3e} (tol {FORWARD_TOL} x {z_scale:.3e}); codes differing card vs CPU "
          f"{int(code_differ.sum())} of {z.shape[0]} (near-tie latents {int(near.sum())}); "
          f"kernel vs plain on the card's latents: codes differing {n_differ}; reconstruction "
          f"from the card's codes max_abs_err {dec_err:.3e} (tol {FORWARD_TOL} x {scale:.3e}); "
          f"whole forward max_abs_err {full_err:.3e}, vq_loss {float(loss):.6f} vs "
          f"{float(ref_loss):.6f}", flush=True)
    check(z_err <= FORWARD_TOL * z_scale, "VQ-VAE latents disagree with the CPU")
    check(not bool((code_differ & ~near).any()), "VQ-VAE codes disagree with the CPU on a clear latent")
    check(dec_err <= FORWARD_TOL * scale, "VQ-VAE reconstruction disagrees with the CPU")
    if not bool(code_differ.any()):
        check(full_err <= FORWARD_TOL * scale
              and abs(float(loss) - float(ref_loss)) <= FORWARD_TOL * max(1.0, float(ref_loss)),
              "VQ-VAE forward disagrees with the CPU")
    del outs, out, ref_out, ref_dec, z, z_cpu, q_card

    # Phase V3: training through the Trainer: reproduce()'s model, optimizer
    # and loss at batch 128, one epoch of VQ_TRAIN_STEPS steps on seeded
    # batches (the first bench.py's) and one eval batch: one vq launch a
    # step and one for the eval forward; the EMA buffers move.
    batches = [(np.random.default_rng(1 + i).random((VQ_BATCH, h, w, c_in)).astype(np.float32),
                None) for i in range(VQ_TRAIN_STEPS)]
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_vq_")
    try:
        vq_trainer = trainer.Trainer(
            VectorQuantizedVAE(**cfg, generator=torch.Generator().manual_seed(SEED), device=dev),
            vq_vae.reproduce_loss, optim.adam_multiplicative(2e-4, 0.999977), batches,
            batches[:1], log_dir=log_dir, sample_epochs=None, use_tensorboard=False,
            device=dev)
        ema0 = vq_trainer.model.quantizer.vq.ema_cluster_size.clone()
        reset_counts()
        vq_trainer.interleaved_train_and_eval(1)
        torch.cuda.synchronize()
        train_counts = read_counts()
        losses, _ = read_losses(log_dir)
        print(f"phase train VQ-VAE: {vq_trainer._step} steps at batch {VQ_BATCH}, losses "
              f"{[round(losses[s_], 5) for s_ in sorted(losses)]}; files "
              f"{sorted(os.listdir(log_dir))}; launches={train_counts}", flush=True)
        want = {k_: 0 for k_ in train_counts}
        want[vq_cuda.KERNEL] = VQ_TRAIN_STEPS + 1
        check(train_counts == want, f"VQ-VAE train launches {train_counts}, expected {want}")
        check(sorted(losses) == list(range(VQ_TRAIN_STEPS))
              and all(math.isfinite(v_) for v_ in losses.values()), "bad VQ-VAE losses")
        check(not torch.equal(vq_trainer.model.quantizer.vq.ema_cluster_size, ema0),
              "the EMA buffers did not move")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    # Phase V4: gradients at batch 128 in training mode (which also moves
    # the EMA buffers once), then 3 Trainer steps, card (fused) against the
    # CPU (plain) from the same weights and batches: gradients within
    # GRAD_RTOL of each group's largest; losses, parameters and the three
    # EMA buffers within TRAJ_RTOL of each tensor's largest magnitude.
    card = VectorQuantizedVAE(**cfg, generator=torch.Generator().manual_seed(SEED + 1),
                              device=dev)
    cpu = VectorQuantizedVAE(**cfg, device="cpu")
    cpu.load_state_dict({k_: t.cpu() for k_, t in card.state_dict().items()})
    xb = torch.from_numpy(batches[0][0])
    for net, xx in ((card, xb.to(dev)), (cpu, xb)):
        net.train()
        vq_vae.reproduce_loss(xx, None, net(xx))["loss"].backward()
    grad_errs, grad_scales = {}, {}
    for (name, p_), (_, pc) in zip(card.named_parameters(), cpu.named_parameters()):
        g = vq_group(name)
        grad_errs[g] = max(grad_errs.get(g, 0.0), float((p_.grad.cpu() - pc.grad).abs().max()))
        grad_scales[g] = max(grad_scales.get(g, 0.0), float(pc.grad.abs().max()))
    print("phase grads VQ-VAE: max_abs_err per group (max |grad|): " + ", ".join(
        f"{g}={grad_errs[g]:.3e} ({grad_scales[g]:.3e})" for g in grad_errs)
        + f" (tol {GRAD_RTOL} x max |grad|)", flush=True)
    check(all(grad_errs[g] <= GRAD_RTOL * grad_scales[g] for g in grad_errs),
          "VQ-VAE card gradients disagree with the CPU plain path")
    traj = {}
    for where, net in ((dev, card), ("cpu", cpu)):
        t_ = trainer.Trainer(net, vq_vae.reproduce_loss, optim.adam_multiplicative(2e-4, 0.999977),
                             [], [], log_dir=tempfile.mkdtemp(prefix="chip_smoke_vqtraj_"),
                             use_tensorboard=False, device=where)
        traj[str(where)] = [float(t_.train_one_step(xx, None)[0]["loss"]) for xx, _ in batches]
        shutil.rmtree(t_.log_dir, ignore_errors=True)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(traj[str(dev)], traj["cpu"]))
    # Each parameter tensor by its relative L2 error |card - cpu| / |cpu|:
    # Adam divides each gradient by its own magnitude (eps 1e-8), so a
    # weight whose gradient is at rounding level (~1e-9 on the dead ReLU
    # paths of the residual stacks) takes a step of another fraction of lr
    # on each side, and an element-wise maximum measures those few weights
    # (it is printed beside). The EMA buffers row by row (element by element
    # for the cluster sizes), since a code no row picks keeps a cluster size
    # near 0 and its ema_embedding row grows by 1 / (size + 1e-5), far above
    # the rows in use.
    cpu_state = cpu.state_dict()
    worst, elementwise = {}, {}
    for name, t_ in card.state_dict().items():
        a, b = t_.cpu(), cpu_state[name]
        elementwise[name] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        if ".ema_" in name:
            a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
            err, scale = (a - b).abs().amax(1), b.abs().amax(1)
            worst[name] = float((err / scale.clamp(min=1e-30)).max())
        else:
            worst[name] = float((a - b).norm() / b.norm().clamp(min=1e-30))
    params = [n_ for n_ in worst if ".ema_" not in n_]
    name_w = max(params, key=worst.get)
    name_e = max(params, key=elementwise.get)
    print(f"phase trajectory VQ-VAE: losses card {traj[str(dev)]} cpu {traj['cpu']} max rel err "
          f"{loss_err:.3e}; after {len(batches)} steps: parameters, largest relative L2 error "
          f"{worst[name_w]:.3e} ({name_w}), largest element error over max |cpu| "
          f"{elementwise[name_e]:.3e} ({name_e}); EMA buffers, largest row error over the row's "
          "max |cpu|: " + ", ".join(f"{n_.rsplit('.', 1)[-1]} {e:.3e}" for n_, e in worst.items()
                                    if ".ema_" in n_) + f" (tol {TRAJ_RTOL})", flush=True)
    check(loss_err <= TRAJ_RTOL, "VQ-VAE 3-step losses disagree with the CPU")
    check(all(e <= TRAJ_RTOL for e in worst.values()),
          "VQ-VAE parameters or EMA buffers after 3 steps disagree with the CPU")
    del cpu, card

    # Phase V5: times on both routes: the train step at batch 128
    # (Trainer.train_one_step, the H2D copy of the batch included) and the
    # eval forward, then a profile of the fused route's step.
    xb = batches[0][0]
    route_times = {}
    for route, use_fused in (("fused", None), ("unfused", False)):
        net = VectorQuantizedVAE(**cfg, use_fused=use_fused,
                                 generator=torch.Generator().manual_seed(SEED), device=dev)
        t_ = trainer.Trainer(net, vq_vae.reproduce_loss, optim.adam_multiplicative(2e-4, 0.999977),
                             [], [], log_dir=tempfile.mkdtemp(prefix="chip_smoke_vqstep_"),
                             use_tensorboard=False, device=dev)

        def forward():
            net.eval()
            with torch.no_grad():
                return net(xs)

        route_times[route] = {"step": time_ms(lambda: t_.train_one_step(xb, None), 10, 3),
                              "forward": time_ms(forward, 10, 3)}
        print(f"phase times VQ-VAE {route} route [{smi}]: train step batch {VQ_BATCH} "
              f"{route_times[route]['step']:.3f} ms "
              f"({VQ_BATCH * 1000 / route_times[route]['step']:.2f} samples/s); forward "
              f"{route_times[route]['forward']:.3f} ms "
              f"({VQ_BATCH * 1000 / route_times[route]['forward']:.2f} images/s)", flush=True)
        if route == "fused":
            profile_steps(lambda: t_.train_one_step(xb, None), 3, route_times[route]["step"],
                          f"train step batch {VQ_BATCH}", (VQ_BATCH, "samples"),
                          "step VQ-VAE", smi, ("vq_", "conv", "gemm", "elementwise",
                                               "reduce_kernel", "Adam"))
        shutil.rmtree(t_.log_dir, ignore_errors=True)

    return {
        "counts": [serve_counts["fused"], serve_counts["unfused"], train_counts],
        "kernel": {"name": vq_cuda.KERNEL, "route": "cuda",
                   "source": "pytorch_generative_tpu_torch/csrc/vq.cu",
                   "replaces": "pytorch_generative_tpu/ops/vq_pallas.py:27",
                   "max_abs_err": vq_err, "ms": vq_times["kernel"], "plain_ms": vq_times["plain"],
                   "bound_ms": vq_bound[0], "bound_by": vq_bound[1],
                   "library_ms": vq_times["library"], "bound_f32_ms": vq_bound_f32[0],
                   "graph_ms": vq_times["graph"]},
    }


def pixel_snail_phases(dev, gen, smi, reset_counts, read_counts):
    """PixelSNAIL at its reproduce() config: 28x28x1, C = 64, 8 blocks of 2
    residual blocks, one attention head with d_k 4, d_v 32 and mask_center,
    batch 128, adam_multiplicative(1e-3, 0.999977). Returns the flash
    forward's largest error here, the launch counts of the runs of its main
    path, and the per-kernel summary's entries of the snail_loop kernel and
    of the f32 (4, 32) flash backward (3xTF32 mma.sync, with its launches
    in the train run)."""
    from pytorch_generative_tpu_torch import datasets, optim, trainer
    from pytorch_generative_tpu_torch.models import PixelSNAIL
    from pytorch_generative_tpu_torch.models.autoregressive import pixel_snail
    from pytorch_generative_tpu_torch.ops import attention_cuda, sampling, snail_decode_cuda

    scfg = pixel_snail.REPRODUCE_CONFIG
    h, w, _ = scfg["in_shape"]
    s_blocks, s_rb, s_c = (scfg["n_pixel_snail_blocks"], scfg["n_residual_blocks"],
                           scfg["n_channels"])
    s_dk, s_dv = scfg["attention_key_channels"], scfg["attention_value_channels"]
    l = h * w

    # Phase 23: the flash kernels at PixelSNAIL's shape (B 128, L 784, H 1,
    # d_k 4, d_v 32, mask_center), k and v column slices of one (B, L, 36)
    # kv tensor as the layer passes them; row 0 gives out 0 and dq 0.
    q = torch.randn((SNAIL_BATCH, l, s_dk), generator=gen).to(dev)
    kv = torch.randn((SNAIL_BATCH, l, s_dk + s_dv), generator=gen).to(dev)
    dout = torch.randn((SNAIL_BATCH, l, s_dv), generator=gen).to(dev)
    k, v = kv[..., :s_dk], kv[..., s_dk:]
    out, lse = attention_cuda.flash_forward(q, k, v, True, 1)
    ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, True, 1)
    grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, True, 1)
    e_grads = [max_err(g, r) for g, r in zip(grads, attention_cuda.flash_backward_plain(
        q, k, v, out, lse, dout, True, 1))]
    torch.cuda.synchronize()
    e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
    print(f"phase flash PixelSNAIL: B={SNAIL_BATCH} L={l} H=1 d_k={s_dk} d_v={s_dv} "
          f"mask_center=True max_abs_err out={e_out:.3e} lse={e_lse:.3e} (tol {FLASH_TOL}); "
          f"backward dq={e_grads[0]:.3e} dk={e_grads[1]:.3e} dv={e_grads[2]:.3e} "
          f"(tol {FLASH_BWD_TOL}); row 0 out==0 {bool((out[:, 0] == 0).all())} "
          f"dq==0 {bool((grads[0][:, 0] == 0).all())}", flush=True)
    check(e_out <= FLASH_TOL and e_lse <= FLASH_TOL, "flash forward disagrees at d_k 4, d_v 32")
    check(max(e_grads) <= FLASH_BWD_TOL, "flash backward disagrees at d_k 4, d_v 32")
    check(bool((out[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all())
          and bool((grads[0][:, 0] == 0).all()),
          "row 0 under mask_center is not out 0, lse -inf, dq 0 at d_k 4, d_v 32")
    check_flash_deterministic(q, k, v, dout, True, 1, out, lse, grads,
                              f"PixelSNAIL (d_k={s_dk}, d_v={s_dv})")
    snail_flash_times = flash_times(q, k, v, dout, 1, mask_center=True)
    del q, kv, dout, k, v, out, lse, ref_out, ref_lse, grads

    # Phase 24: serving: PixelSNAIL(**REPRODUCE_CONFIG).forward at batch 128
    # with the reproduce loss through the entry point (8 flash forwards,
    # nothing else), then the same weights on the CPU's plain path.
    snail = PixelSNAIL(**scfg, generator=gen, device=dev).eval()
    xs = (torch.rand((SNAIL_BATCH, h, w, 1), generator=gen) < 0.3).float().to(dev)
    reset_counts()
    with torch.no_grad():
        logits = snail(xs)
        loss = pixel_snail.reproduce_loss(xs, None, logits)
    torch.cuda.synchronize()
    snail_serve_counts = read_counts()
    print(f"phase serve PixelSNAIL: forward logits {tuple(logits.shape)} nll={float(loss):.4f} "
          f"nats/image; launches={snail_serve_counts}", flush=True)
    check(logits.shape == (SNAIL_BATCH, h, w, 1) and bool(torch.isfinite(logits).all()),
          "bad PixelSNAIL logits")
    want_counts = {k_: 0 for k_ in snail_serve_counts}
    want_counts[attention_cuda.KERNEL] = s_blocks
    check(snail_serve_counts == want_counts,
          f"PixelSNAIL forward launches {snail_serve_counts}, expected {want_counts}")
    cpu_snail = PixelSNAIL(**scfg, device="cpu").eval()
    cpu_snail.load_state_dict({k_: t.cpu() for k_, t in snail.state_dict().items()})
    with torch.no_grad():
        ref = cpu_snail(xs.cpu())
    s_fwd_err = float((logits.cpu() - ref).abs().max())
    s_scale = max(1.0, float(ref.abs().max()))
    print(f"phase serve PixelSNAIL: forward vs plain CPU forward (batch {SNAIL_BATCH}) "
          f"max_abs_err={s_fwd_err:.3e} (tol {FORWARD_TOL} x max(1, max |logit|) = "
          f"{FORWARD_TOL * s_scale:.3e})", flush=True)
    check(s_fwd_err <= FORWARD_TOL * s_scale, "PixelSNAIL forward disagrees with the CPU")
    del logits, loss, ref

    # Phase 25: PixelSNAIL.sample through the entry point at n = 16 and 64,
    # free and with the top half kept: 1 snail_loop launch a call and no
    # plain decode; pixel-equal to the kernel's plain version on uniforms
    # moved off its decision boundary. The plain version runs once per n,
    # over the free and the inpainted batch side by side, and records the
    # probability of every draw: nudging the uniforms away from those
    # leaves its pixels as they were, so it is not run again.
    sdc = snail_decode_cuda
    plain_decode = sdc.snail_decode
    decode_calls = [0]

    def counted_decode(*args):
        decode_calls[0] += 1
        return plain_decode(*args)

    snail_sample_counts, snail_err, snail_plans = [], 0.0, {}
    for n in SNAIL_N:
        check(sampling.pixel_snail_sample_route(snail, n) == sampling.LOOP_ROUTE,
              f"n = {n} does not take the whole-loop route")
        conds = {"free": -torch.ones((n, h, w, 1), device=dev)}
        conds["inpaint"] = conds["free"].clone()
        conds["inpaint"][:, : h // 2] = (torch.rand((n, h // 2, w, 1), generator=gen)
                                         < 0.3).float().to(dev)
        cond = torch.cat([conds["free"], conds["inpaint"]])
        u = torch.rand((h * w, 2 * n, 1), generator=gen).to(dev)
        probs = []

        def draw(uu, logits):
            """The kernel's draw rule, u < sigmoid(logit), recorded."""
            p = torch.sigmoid(logits)
            probs.append(p)
            return (uu < p).to(logits.dtype)

        # snail_sample_loop_plain is snail_decode with that draw rule.
        with torch.no_grad():
            plain = plain_decode(F.pad(cond, (0, 0, 1, 1, 1, 1)), u,
                                 sdc.stack_pixel_snail_weights(snail), h, w, draw)[:, 1:-1, 1:-1]
        u, n_nudged = nudge_around(u, torch.stack(probs), cond, NUDGE)
        # Both the kernel's plain version and the incremental sampler decode
        # through snail_decode: count its calls.
        sdc.snail_decode = counted_decode
        for m, mode in enumerate(("free", "inpaint")):
            kw = dict(n_samples=n) if mode == "free" else dict(conditioned_on=conds[mode])
            reset_counts()
            decode_calls[0] = 0
            got = snail.sample(uniforms=u[:, m * n:(m + 1) * n].contiguous(), **kw)
            torch.cuda.synchronize()
            counts = read_counts()
            snail_sample_counts.append(counts)
            want = plain[m * n:(m + 1) * n]
            mismatched = int((got != want).sum())
            snail_err = max(snail_err, float((got - want).abs().max()))
            kept = (bool((got[:, : h // 2] == conds[mode][:, : h // 2]).all())
                    if mode == "inpaint" else True)
            binary = bool(((got == 0) | (got == 1)).all())
            print(f"phase sample PixelSNAIL: {mode} n={n} nudged={n_nudged} (both modes) "
                  f"mismatched_pixels={mismatched} kept_pixels_ok={kept} binary={binary} "
                  f"mean={float(got.mean()):.4f}; launches={counts} plain decodes="
                  f"{decode_calls[0]}", flush=True)
            check(got.shape == (n, h, w, 1) and binary, "bad PixelSNAIL samples")
            check(mismatched == 0 and kept,
                  f"snail_loop disagrees with its plain version ({mode}, n = {n})")
            want_counts = {k_: 0 for k_ in counts}
            want_counts[sdc.KERNEL] = 1
            check(counts == want_counts and decode_calls[0] == 0,
                  f"PixelSNAIL sample launches {counts}, plain decodes {decode_calls[0]}")
        sdc.snail_decode = plain_decode
        # The plan, and two calls on the same inputs give equal bits.
        inputs = sampling.snail_loop_inputs(snail, cond[:n], u[:, :n].contiguous())
        plan = sdc.plan_for(*inputs)
        cap, regs = sdc.occupancy(plan.samples, plan.cluster, plan.smem)
        snail_plans[n] = dict(plan._asdict(), registers=regs, clusters_fit=cap)
        first = sdc.fused_snail_sample_loop(*inputs)
        same = bool(torch.equal(first, sdc.fused_snail_sample_loop(*inputs)))
        torch.cuda.synchronize()
        print(f"phase sample PixelSNAIL: n={n} plan {plan}, {regs} registers a thread, "
              f"{plan.smem} bytes of shared memory a CTA, {cap} clusters fit at once; "
              f"two calls equal bits: {same}", flush=True)
        check(plan.clusters <= cap, f"the n = {n} plan asks for {plan.clusters} clusters, "
                                    f"{cap} fit")
        check(same, f"two snail_loop calls at n = {n} differ")

    # Phase 26: training through the Trainer: reproduce()'s model, optimizer
    # and loss on seeded synthetic MNIST at batch 128, one epoch of
    # SNAIL_TRAIN_STEPS steps, eval on one batch and a 16-image sample grid
    # (the Trainer prints a sampling failure and goes on, so only the
    # snail_loop count shows that the grid was drawn by the kernel).
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_snail_")
    try:
        train_loader, test_loader = datasets.get_synthetic_mnist_loaders(
            SNAIL_BATCH, n_train=SNAIL_TRAIN_STEPS * SNAIL_BATCH, n_test=SNAIL_BATCH,
            image_size=h, seed=0)
        snail_trainer = trainer.Trainer(
            PixelSNAIL(**scfg, generator=torch.Generator().manual_seed(SEED), device=dev),
            pixel_snail.reproduce_loss, optim.adam_multiplicative(1e-3, 0.999977),
            train_loader, test_loader, log_dir=log_dir, sample_epochs=1,
            use_tensorboard=False, device=dev)
        reset_counts()
        snail_trainer.interleaved_train_and_eval(1)
        torch.cuda.synchronize()
        snail_train_counts = read_counts()
        losses, _ = read_losses(log_dir)
        files = sorted(os.listdir(log_dir))
        grid_file = f"sample_{SNAIL_TRAIN_STEPS}.npy"
        print(f"phase train PixelSNAIL: {snail_trainer._step} steps at batch {SNAIL_BATCH}, "
              f"losses {[round(losses[s], 3) for s in sorted(losses)]}; files {files}; "
              f"launches={snail_train_counts}", flush=True)
        want_counts = {k_: 0 for k_ in snail_train_counts}
        want_counts.update({attention_cuda.KERNEL: (SNAIL_TRAIN_STEPS + 1) * s_blocks,
                            attention_cuda.BWD_KERNEL: SNAIL_TRAIN_STEPS * s_blocks,
                            sdc.KERNEL: 1})
        check(snail_train_counts == want_counts,
              f"PixelSNAIL train launches {snail_train_counts}, expected {want_counts}")
        check(sorted(losses) == list(range(SNAIL_TRAIN_STEPS))
              and all(math.isfinite(v_) for v_ in losses.values()), "bad PixelSNAIL losses")
        check(grid_file in files, f"{grid_file} was not written")
        grid = torch.from_numpy(np.load(os.path.join(log_dir, grid_file)))
        check(grid.shape == (16, h, w, 1) and bool(((grid == 0) | (grid == 1)).all()),
              "the sample grid is not 16 binary images")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    # Phases 27 and 28: gradients at batch 2 and 3 Adam steps (reproduce()'s
    # learning rate 1e-3) at batch TRAJ_BATCH, card against the CPU's plain
    # path; the key half of each kv_proj.bias has an exact gradient of 0 on
    # both and counts against its group's largest gradient.
    grads_vs_cpu(snail, cpu_snail, xs[:2], " PixelSNAIL")
    trajectory(snail, cpu_snail, dev,
               [(torch.rand((TRAJ_BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
                for _ in range(3)], " PixelSNAIL", lr=1e-3)
    del cpu_snail

    # Phase 29: times. The flash kernels at PixelSNAIL's shape beside their
    # plain versions, bounds and masked SDPA; the train step at batch 128
    # and a profile of it; the forward at batch 128; the sample call, the
    # kernel and its plain version (one call each, ~7 s) at n = 16 and 64
    # beside the bound and the latency floor; a profile of one n = 16
    # sample call.
    st = snail_flash_times
    print(f"phase times PixelSNAIL [{smi}]: flash_fwd (B={SNAIL_BATCH}, L={l}, H=1, d_k={s_dk}, "
          f"d_v={s_dv}, mask_center) kernel {st['fwd']:.4f}/{st['fwd2']:.4f} ms, plain "
          f"{st['fwd_plain']:.4f} ms, masked SDPA {st['fwd_lib']:.4f} ms, "
          f"{flash_bounds_text(SNAIL_BATCH, l, 1, s_dk, s_dv, True)}; flash_bwd kernel "
          f"{st['bwd']:.4f}/{st['bwd2']:.4f} ms, plain {st['bwd_plain']:.4f} ms, SDPA "
          f"autograd.grad {st['bwd_lib']:.4f} ms, "
          f"{flash_bounds_text(SNAIL_BATCH, l, 1, s_dk, s_dv, True, backward=True)}", flush=True)
    def s_forward():
        with torch.no_grad():
            return snail(xs)

    s_forward_ms = time_ms(s_forward, 5, 2)
    print(f"phase times PixelSNAIL [{smi}]: forward batch {SNAIL_BATCH} {s_forward_ms:.3f} ms "
          f"({SNAIL_BATCH * 1000 / s_forward_ms:.2f} images/s)", flush=True)
    xb = (torch.rand((SNAIL_BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
    s_step = lambda: snail_trainer.train_one_step(xb, None)
    s_step_ms = time_ms(s_step, 5, 2)
    # cuDNN's convolutions show as xmma GEMMs, FFTs, filter flips and
    # layout transforms; the rest is PyTorch's elementwise and reductions.
    share = profile_steps(s_step, 2, s_step_ms, f"train step batch {SNAIL_BATCH}",
                          (SNAIL_BATCH, "samples"), "step PixelSNAIL", smi,
                          ("fsmall::dq_kernel", "fsmall::dkdv_kernel", "flash_fwd", "xmma", "fft",
                           "flip_filter", "cudnn", "elementwise", "reduce_kernel"))
    flash_ms, flash_pct = share("fsmall::", "flash_fwd")
    print(f"phase step PixelSNAIL [{smi}]: the flash kernels (fsmall:: backward, SIMT forward) "
          f"{flash_ms:.3f} ms a step, {flash_pct:.1f}% of kernel time", flush=True)
    del snail_trainer
    s_weights = sdc.stack_pixel_snail_weights(snail)
    s_weight_bytes = 4 * sum(t.numel() for t in s_weights.values())
    snail_times, snail_bounds = {}, {}
    sample_gen = lambda: torch.Generator().manual_seed(SEED)
    for n in SNAIL_N:
        inputs = sampling.snail_loop_inputs(
            snail, -torch.ones((n, h, w, 1), device=dev),
            torch.rand((h * w, n, 1), generator=gen).to(dev))
        snail_times[n] = {
            "sample": time_ms(lambda: snail.sample(n_samples=n, generator=sample_gen()), 2, 1),
            "kernel": time_ms(lambda: sdc.fused_snail_sample_loop(*inputs), 2, 0)}
        with torch.no_grad():
            snail_times[n]["plain"] = time_ms(lambda: sdc.snail_sample_loop_plain(*inputs), 1, 0)
        snail_bounds[n] = bound(
            snail_work(n, h, w, s_blocks, s_rb, s_c, s_dk, s_dv),
            s_weight_bytes + 4 * (2 * inputs[0].numel() + inputs[1].numel()))
        t_ = snail_times[n]
        print(f"phase times sample PixelSNAIL [{smi}]: n={n} sample call {t_['sample']:.2f} ms "
              f"({n * 1000 / t_['sample']:.2f} img/s); snail_loop kernel {t_['kernel']:.2f} ms, "
              f"plain {t_['plain']:.2f} ms, bound {snail_bounds[n][0]:.4f} ms "
              f"({snail_bounds[n][1]}), latency floor estimate "
              f"{snail_latency_floor_ms(h, w, s_blocks, s_rb):.1f} ms, library none", flush=True)
    profile_steps(lambda: snail.sample(n_samples=SNAIL_N[0], generator=sample_gen()), 1,
                  snail_times[SNAIL_N[0]]["sample"], f"sample call n={SNAIL_N[0]}",
                  (SNAIL_N[0], "images"), "profile sample PixelSNAIL", smi, ("snail_loop",),
                  host=True)

    bwd_bounds = flash_bounds(SNAIL_BATCH, l, 1, s_dk, s_dv, True, backward=True)
    return {
        "flash_err": e_out,
        "counts": [snail_serve_counts, *snail_sample_counts, snail_train_counts],
        "bwd_launches": snail_train_counts[attention_cuda.BWD_KERNEL],
        "bwd_kernel": {"name": f"{attention_cuda.BWD_KERNEL} 4x32", "route": "cuda",
                       "source": "pytorch_generative_tpu_torch/csrc/flash_bwd_mma_small.cuh",
                       "replaces": "pytorch_generative_tpu/ops/attention_pallas.py:205",
                       "launches": snail_train_counts[attention_cuda.BWD_KERNEL],
                       "max_abs_err": max(e_grads), "ms": st["bwd"], "plain_ms": st["bwd_plain"],
                       "bound_ms": bwd_bounds[0][0], "bound_by": bwd_bounds[0][1],
                       "library_ms": st["bwd_lib"], "bound_f32_ms": bwd_bounds[1][0],
                       "instances": ["4x32", "4x8"]},
        "kernel": {"name": sdc.KERNEL, "route": "cuda",
                   "source": "pytorch_generative_tpu_torch/csrc/snail_loop.cu",
                   "replaces": "pytorch_generative_tpu/ops/snail_decode_pallas.py:71",
                   "max_abs_err": snail_err, "ms": snail_times[SNAIL_N[0]]["kernel"],
                   "plain_ms": snail_times[SNAIL_N[0]]["plain"],
                   "bound_ms": snail_bounds[SNAIL_N[0]][0],
                   "bound_by": snail_bounds[SNAIL_N[0]][1], "library_ms": None,
                   "plan": snail_plans[SNAIL_N[0]]},
    }

def block_work(b, l, c, e, c_out, n_heads, mask_center):
    """(FLOPs, bytes) of the fused attention block's forward: the
    projections 2 B L C (2E + O) and 2 B L O C' (O = E) plus the attention
    (flash_work); x and the weights read once, y, attn and lse written
    once."""
    d = e // n_heads
    flops = (2 * b * l * c * 3 * e + 2 * b * l * e * c_out
             + flash_work(b, l, n_heads, d, d, mask_center))
    nbytes = 4 * (b * l * c + 3 * c * e + 3 * e + e * c_out + c_out
                  + b * l * (c_out + e + n_heads))
    return flops, nbytes


def block_operands(b, l, c, gen, dev):
    """x (B, L, C) and seeded weights of a block of width C (E = O = C'):
    wq, bq, wkv, bkv, wo, bo."""
    x = torch.randn((b, l, c), generator=gen)
    ws = [torch.randn(shape, generator=gen) * s for shape, s in (
        ((c, c), c ** -0.5), ((c,), 0.1), ((c, 2 * c), c ** -0.5), ((2 * c,), 0.1),
        ((c, c), c ** -0.5), ((c,), 0.1))]
    return [t.to(dev) for t in (x, *ws)]


def block_composition(x, wq, bq, wkv, bkv, wo, bo, n_heads):
    """addmm -> causal SDPA -> addmm: the composition the fused block
    replaces, its library yardstick (the port never calls it)."""
    b, l, c = x.shape
    e = wq.shape[1]
    x2 = x.reshape(-1, c)
    q = torch.addmm(bq, x2, wq).view(b, l, n_heads, -1).transpose(1, 2)
    kv = torch.addmm(bkv, x2, wkv).view(b, l, 2, n_heads, -1)
    att = F.scaled_dot_product_attention(q, kv[:, :, 0].transpose(1, 2),
                                         kv[:, :, 1].transpose(1, 2), is_causal=True)
    return torch.addmm(bo, att.transpose(1, 2).reshape(b * l, e), wo)


def set_mlp_route(route):
    """The MLP backward's route as a user picks it: mlp_cuda._SAVE_PREACT
    and PGT_MLP_BWD."""
    from pytorch_generative_tpu_torch.ops import mlp_cuda

    mlp_cuda._SAVE_PREACT = route != "recompute"
    os.environ["PGT_MLP_BWD"] = "pipe" if route == "pipe" else "mono"


def fused_attn_phases(dev, gen, smi, reset_counts, read_counts):
    """ImageGPT at LARGE_CONFIG with the fused attention block
    (PGT_FUSED_ATTN=1) under the MLP backward's three routes: the block
    kernel against its plain version at its three widths (B 64, L 784, and
    L 200 with mask_center), two calls giving equal bits; the recompute and
    pipelined MLP backwards against the saved-y route's plain version at R =
    50,176, C = 512 and 1024, and bit for bit against the saved-y kernel;
    the forward at batch 64 against the CPU with its launches; one train
    step a route with its launches; gradients and 3 Adam steps a route
    against the CPU at batch 2; times of the new kernels beside their plain
    versions, bounds and library yardsticks (the block at its three widths,
    and its 3xTF32 GEMM beside torch.addmm), of the forward and the step
    with the gate on and off and under each route; a profiled gated step.
    Returns the launch counts of its main path runs and the three kernels'
    entries of the per-kernel summary."""
    from pytorch_generative_tpu_torch import optim, trainer
    from pytorch_generative_tpu_torch.models import ImageGPT
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
    from pytorch_generative_tpu_torch.ops import (
        attention_cuda,
        attn_block_cuda,
        ln_cuda,
        mlp_cuda,
    )

    cfg = image_gpt.LARGE_CONFIG
    h, w, _ = cfg["in_shape"]
    c, hb, nb = cfg["n_embedding_channels"], cfg["n_attention_heads"], cfg["n_transformer_blocks"]
    l = h * w
    rows = BATCH * l
    route_kernel = {"saved": mlp_cuda.BWD_KERNEL, "recompute": mlp_cuda.RECOMPUTE_KERNEL,
                    "pipe": mlp_cuda.PIPE_KERNEL}

    # Phase A1: the block kernel against its plain version at its widths.
    block_err = 0.0
    for cw, heads in BLOCK_WIDTHS:
        for ll, mask_center in ((l, False), (200, True)):
            ops = block_operands(BATCH, ll, cw, gen, dev)
            y, attn, lse = attn_block_cuda.attention_block_forward(*ops, mask_center, heads)
            again = attn_block_cuda.attention_block_forward(*ops, mask_center, heads)
            ry, rattn, rlse = attn_block_cuda.attention_block_plain(*ops, mask_center, heads)
            torch.cuda.synchronize()
            same = [torch.equal(a_, b_) for a_, b_ in zip((y, attn, lse), again)]
            (e_y, m_y), (e_a, m_a) = rel_err(y, ry), rel_err(attn, rattn)
            e_l = max_err(lse, rlse)
            block_err = max(block_err, e_y, e_a, e_l)
            print(f"phase block C={cw} H={heads}: B={BATCH} L={ll} mask_center={mask_center} "
                  f"max_abs_err y={e_y:.3e} ({m_y:.3e}) attn={e_a:.3e} ({m_a:.3e}) (tol "
                  f"{BLOCK_RTOL} x max |plain|) lse={e_l:.3e} (tol {BLOCK_LSE_TOL}); two calls "
                  f"give equal bits (y, attn, lse): {same}", flush=True)
            check(e_y <= BLOCK_RTOL * m_y and e_a <= BLOCK_RTOL * m_a and e_l <= BLOCK_LSE_TOL,
                  f"the block kernel disagrees at C = {cw}, {heads} heads")
            check(all(same), f"the block kernel gave other bits in a second call at C = {cw}, "
                  f"{heads} heads")
            if mask_center:
                check(bool((attn[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all()),
                      "row 0 under mask_center is not attn 0 with lse -inf in the block")
            del ops, y, attn, lse, again, ry, rattn, rlse

    # Phase A2: the recompute and pipelined MLP backwards at the path's rows
    # and C = 1024, from the forward kernel's y: within MLP_RTOL of the
    # saved-y route's plain version, and equal to the saved-y kernel.
    route_err = {"recompute": 0.0, "pipe": 0.0}
    for cw in (c, WIDE_C[-1]):
        f = 4 * cw
        x = (2.0 * torch.randn((rows, cw), generator=gen) + 0.5).to(dev)
        gamma = (1.0 + 0.1 * torch.randn((cw,), generator=gen)).to(dev)
        beta = (0.1 * torch.randn((cw,), generator=gen)).to(dev)
        dout = torch.randn((rows, cw), generator=gen).to(dev)
        w1 = (torch.randn((cw, f), generator=gen) / cw ** 0.5).to(dev)
        b1 = (0.1 * torch.randn((f,), generator=gen)).to(dev)
        w2 = (torch.randn((f, cw), generator=gen) / f ** 0.5).to(dev)
        b2 = (0.1 * torch.randn((cw,), generator=gen)).to(dev)
        _, y = mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5)
        saved = mlp_cuda.ln_mlp_backward(x, dout, y, gamma, beta, w1, b1, w2, 1e-5)
        want = mlp_cuda.ln_mlp_backward_plain(x, dout, y, gamma, beta, w1, b1, w2, 1e-5)
        got = {"recompute": mlp_cuda.ln_mlp_backward_recompute(x, dout, gamma, beta, w1, b1,
                                                               w2, 1e-5),
               "pipe": mlp_cuda.ln_mlp_backward_pipe(x, dout, y, gamma, beta, w1, b1, w2, 1e-5)}
        torch.cuda.synchronize()
        for route, grads in got.items():
            errs = [rel_err(g_, w_) for g_, w_ in zip(grads, want)]
            equal = all(torch.equal(g_, s_) for g_, s_ in zip(grads, saved))
            route_err[route] = max(route_err[route], *(e for e, _ in errs))
            print(f"phase mlp route {route}: R={rows} C={cw} F={f} max_abs_err (max |plain|) "
                  + ", ".join(f"{n}={e:.3e} ({m:.3e})" for n, (e, m) in zip(
                      ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), errs))
                  + f" (tol {MLP_RTOL} x max |plain|); equal to the saved-y kernel: {equal}",
                  flush=True)
            check(all(e <= MLP_RTOL * m for e, m in errs),
                  f"the {route} MLP backward disagrees at C = {cw}")
            check(equal, f"the {route} MLP backward's bits differ from the saved-y route's")
        del x, dout, y, saved, want, got

    # Phase A3: the forward at batch 64 through the entry point with the
    # gate on: per forward 8 block kernels, no flash forward, 9 LayerNorms
    # and 8 fused MLPs; the same weights on the CPU's plain path at batch 2.
    os.environ["PGT_FUSED_ATTN"] = "1"
    big = ImageGPT(**cfg, generator=gen, device=dev)
    with torch.no_grad():
        big.pos.copy_(0.1 * torch.randn(big.pos.shape, generator=gen))
    big.eval()
    x = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.3).float().to(dev)
    reset_counts()
    with torch.no_grad():
        logits = big(x)
        loss = image_gpt.reproduce_loss(x, None, logits)
    torch.cuda.synchronize()
    serve_counts = read_counts()
    want = {k_: 0 for k_ in serve_counts}
    want.update({attn_block_cuda.KERNEL: nb, ln_cuda.KERNEL: nb + 1, mlp_cuda.KERNEL: nb})
    print(f"phase serve gated C={c}: forward logits {tuple(logits.shape)} nll={float(loss):.4f} "
          f"nats/image; launches={serve_counts}", flush=True)
    check(logits.shape == (BATCH, h, w, 1) and bool(torch.isfinite(logits).all()),
          "bad logits with the fused block")
    check(serve_counts == want, f"gated forward launches {serve_counts}, expected {want}")
    cpu_big = ImageGPT(**cfg, device="cpu")
    cpu_big.load_state_dict({k_: t.cpu() for k_, t in big.state_dict().items()})
    with torch.no_grad():
        ref = cpu_big(x[:2].cpu())
    fwd_err = float((logits[:2].cpu() - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"phase serve gated C={c}: forward vs plain CPU forward (batch 2) max_abs_err="
          f"{fwd_err:.3e} (tol {FORWARD_TOL} x max(1, max |logit|) = {FORWARD_TOL * scale:.3e})",
          flush=True)
    check(fwd_err <= FORWARD_TOL * scale, "the gated forward disagrees with the CPU")
    del logits, ref

    # Phase A4: one Trainer step a route at batch 64: per step 8 block
    # kernels and 8 projection recomputes, 8 flash backwards and no flash
    # forward, 9 LayerNorm forwards and backwards, 8 fused MLP forwards and
    # 8 of the route's backward; then, at batch 2 against the CPU,
    # gradients and 3 Adam steps under each route.
    step_trainer = trainer.Trainer(
        ImageGPT(**cfg, generator=torch.Generator().manual_seed(SEED), device=dev),
        image_gpt.reproduce_loss, optim.adam_multiplicative(5e-3, 0.999977), [], [],
        log_dir=tempfile.mkdtemp(prefix="chip_smoke_gated_"), use_tensorboard=False, device=dev)
    xb = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
    train_counts = []
    for route in MLP_ROUTES:
        set_mlp_route(route)
        reset_counts()
        step_loss = float(step_trainer.train_one_step(xb, None)[0]["loss"])
        torch.cuda.synchronize()
        counts = read_counts()
        train_counts.append(counts)
        want = {k_: 0 for k_ in counts}
        want.update({attn_block_cuda.KERNEL: nb, attn_block_cuda.PROJECT_KERNEL: nb,
                     attention_cuda.BWD_KERNEL: nb, ln_cuda.KERNEL: nb + 1,
                     ln_cuda.BWD_KERNEL: nb + 1, mlp_cuda.KERNEL: nb, route_kernel[route]: nb})
        print(f"phase train gated C={c} route {route}: one step at batch {BATCH}, loss "
              f"{step_loss:.3f}; launches={counts}", flush=True)
        check(math.isfinite(step_loss), f"the gated step gave a non-finite loss ({route})")
        check(counts == want, f"gated train launches {counts} ({route}), expected {want}")
    for route in MLP_ROUTES[1:]:
        set_mlp_route(route)
        cpu_big.load_state_dict({k_: t.cpu() for k_, t in big.state_dict().items()})
        grads_vs_cpu(big, cpu_big, x[:2], f" gated C={c} route {route}")
        trajectory(big, cpu_big, dev,
                   [(torch.rand((2, h, w, 1), generator=gen) < 0.13).float().numpy()
                    for _ in range(3)], f" gated C={c} route {route}")
    del big, cpu_big

    # Phase A5: times. The block at its three widths beside its plain
    # version, the composition it replaces and its bounds (the 3xTF32 rate
    # of its route, the f32 one beside it); its GEMM alone at the
    # projection's shape (the projection stage: x (B L, C) by wq and wkv,
    # N = E and 2E) beside the same two products by torch.addmm in f32
    # (TF32 off); the MLP backward routes at the path's shapes, the saved-y
    # kernel beside the pipelined one in the same call.
    block_t = {}
    for cw, heads in BLOCK_WIDTHS:
        ops = block_operands(BATCH, l, cw, gen, dev)
        t_ = {"kernel": time_ms(lambda: attn_block_cuda.attention_block_forward(
                  *ops, False, heads), 10, 2),
              "plain": time_ms(lambda: attn_block_cuda.attention_block_plain(
                  *ops, False, heads), 5, 1),
              "library": time_ms(lambda: block_composition(*ops, heads), 10, 2),
              "kernel2": time_ms(lambda: attn_block_cuda.attention_block_forward(
                  *ops, False, heads), 10, 2)}
        work = block_work(BATCH, l, cw, cw, cw, heads, False)
        t_["bound"], t_["bound_f32"] = bound(*work, TF32X3_FLOPS), bound(*work)
        block_t[(cw, heads)] = t_
        print(f"phase times block [{smi}]: attn_block_fwd (B={BATCH}, L={l}, C={cw}, H={heads}) "
              f"kernel {t_['kernel']:.4f}/{t_['kernel2']:.4f} ms, plain {t_['plain']:.4f} ms, "
              f"addmm -> causal SDPA -> addmm {t_['library']:.4f} ms, 3xTF32 bound "
              f"{t_['bound'][0]:.4f} ms ({t_['bound'][1]}), f32 bound {t_['bound_f32'][0]:.4f} "
              f"ms ({t_['bound_f32'][1]}); {work[0] / 1e9:.1f} GFLOP, "
              f"{work[0] / t_['kernel'] / 1e9:.1f} TFLOP/s", flush=True)
        if (cw, heads) == (c, hb):
            x2 = ops[0].reshape(-1, cw)
            gemm_flops = 2 * x2.shape[0] * cw * 3 * cw
            gemm_t = [time_ms(lambda: attn_block_cuda.project(*ops[:5]), 10, 2),
                      time_ms(lambda: (torch.addmm(ops[2], x2, ops[1]),
                                       torch.addmm(ops[4], x2, ops[3])), 10, 2),
                      time_ms(lambda: attn_block_cuda.project(*ops[:5]), 10, 2)]
            gemm_bound = bound(gemm_flops, 4 * (x2.numel() + 3 * cw * cw + 3 * cw
                                                + 3 * x2.shape[0] * cw), TF32X3_FLOPS)
            print(f"phase times gemm [{smi}]: gemm_tf32x3 at the projection (M={x2.shape[0]}, "
                  f"K={cw}, N={cw} and {2 * cw}) {gemm_t[0]:.4f}/{gemm_t[2]:.4f} ms ("
                  f"{gemm_flops / min(gemm_t[0], gemm_t[2]) / 1e9:.1f} TFLOP/s), torch.addmm f32 "
                  f"{gemm_t[1]:.4f} ms ({gemm_flops / gemm_t[1] / 1e9:.1f} TFLOP/s), 3xTF32 bound "
                  f"{gemm_bound[0]:.4f} ms ({gemm_bound[1]})", flush=True)
            del x2
        del ops
    f = 4 * c
    xr = torch.randn((rows, c), generator=gen).to(dev).requires_grad_()
    params = [(1.0 + 0.1 * torch.randn((c,), generator=gen)), 0.1 * torch.randn((c,), generator=gen),
              torch.randn((c, f), generator=gen) / c ** 0.5, 0.1 * torch.randn((f,), generator=gen),
              torch.randn((f, c), generator=gen) / f ** 0.5, 0.1 * torch.randn((c,), generator=gen)]
    gamma, beta, w1, b1, w2, b2 = (t.to(dev).requires_grad_() for t in params)
    dout = torch.randn((rows, c), generator=gen).to(dev)
    xd, gd, bd, w1d, b1d, w2d, b2d = (t.detach() for t in (xr, gamma, beta, w1, b1, w2, b2))
    _, y = mlp_cuda.ln_mlp_forward(xd, gd, bd, w1d, b1d, w2d, b2d, 1e-5)

    def composition():
        return torch.addmm(b2, F.gelu(torch.addmm(b1, F.layer_norm(
            xr, (c,), gamma, beta, 1e-5), w1)), w2) + xr

    saved_graph = composition()
    leaves = (xr, gamma, beta, w1, b1, w2, b2)
    route_fns = {
        "saved": (lambda: mlp_cuda.ln_mlp_backward(xd, dout, y, gd, bd, w1d, b1d, w2d, 1e-5),
                  lambda: mlp_cuda.ln_mlp_backward_plain(xd, dout, y, gd, bd, w1d, b1d, w2d,
                                                         1e-5),
                  lambda: torch.autograd.grad(saved_graph, leaves, dout, retain_graph=True)),
        "recompute": (lambda: mlp_cuda.ln_mlp_backward_recompute(xd, dout, gd, bd, w1d, b1d,
                                                                 w2d, 1e-5),
                      lambda: mlp_cuda.ln_mlp_backward_recompute_plain(xd, dout, gd, bd, w1d,
                                                                       b1d, w2d, 1e-5),
                      lambda: torch.autograd.grad(composition(), leaves, dout)),
        "pipe": (lambda: mlp_cuda.ln_mlp_backward_pipe(xd, dout, y, gd, bd, w1d, b1d, w2d, 1e-5),
                 lambda: mlp_cuda.ln_mlp_backward_plain(xd, dout, y, gd, bd, w1d, b1d, w2d, 1e-5),
                 lambda: torch.autograd.grad(saved_graph, leaves, dout, retain_graph=True)),
    }
    _, mlp_bwd_work = mlp_work(rows, c, f)
    # The routes' work: the recompute route does one more R x C x F product
    # and reads no y. Their bound is the 3xTF32 one (every product on the
    # tensor cores), with the f32 one beside it.
    route_work = {"saved": mlp_bwd_work, "pipe": mlp_bwd_work,
                  "recompute": (mlp_bwd_work[0] + 2 * rows * c * f,
                                mlp_bwd_work[1] - 4 * rows * f)}
    route_bounds = {k_: bound(*w_, TF32X3_FLOPS) for k_, w_ in route_work.items()}
    route_bounds_f32 = {k_: bound(*w_) for k_, w_ in route_work.items()}
    route_t = {}
    for route in ("saved", "pipe", "recompute", "pipe", "saved"):
        kern, plain, lib = route_fns[route]
        t = route_t.setdefault(route, {"kernel": []})
        t["kernel"].append(time_ms(kern, 5, 2))
        if "plain" not in t:
            t["plain"], t["library"] = time_ms(plain, 5, 1), time_ms(lib, 5, 1)
    for route, t in route_t.items():
        b_ms, b_by = route_bounds[route]
        print(f"phase times mlp route {route} [{smi}]: {route_kernel[route]} (R={rows}, C={c}, "
              f"F={f}) kernel {'/'.join(f'{v:.4f}' for v in t['kernel'])} ms, plain "
              f"{t['plain']:.4f} ms, library {t['library']:.4f} ms, 3xTF32 bound {b_ms:.4f} ms "
              f"({b_by}), f32 bound {route_bounds_f32[route][0]:.4f} ms; "
              f"{route_work[route][0] / min(t['kernel']) / 1e9:.1f} TFLOP/s", flush=True)
    del xr, dout, y, saved_graph, route_fns

    # Phase A6: the forward and the train step at batch 64, the gate on and
    # off, the step under each route; a profiled gated step.
    xf = torch.from_numpy(xb).to(dev)
    model = step_trainer.model
    path_t = {}
    for gate in ("1", "0", "1"):
        os.environ["PGT_FUSED_ATTN"] = gate
        set_mlp_route("saved")
        with torch.no_grad():
            path_t.setdefault(f"forward gate={gate}", []).append(time_ms(lambda: model(xf), 5, 2))
        for route in MLP_ROUTES if gate == "1" else ("saved",):
            set_mlp_route(route)
            path_t.setdefault(f"step gate={gate} {route}", []).append(
                time_ms(lambda: step_trainer.train_one_step(xb, None), 3, 1))
    print(f"phase times gated C={c} [{smi}]: batch {BATCH}: " + "; ".join(
        f"{k_} {'/'.join(f'{v:.3f}' for v in vs)} ms" for k_, vs in path_t.items()), flush=True)
    os.environ["PGT_FUSED_ATTN"] = "1"
    set_mlp_route("saved")
    step = lambda: step_trainer.train_one_step(xb, None)
    profile_steps(step, 2, min(path_t["step gate=1 saved"]), f"train step batch {BATCH}",
                  (BATCH, "samples"), f"step gated C={c}", smi,
                  ("gemm3::gemm_kernel", "mlp::", "flash_fwd_mma", "flash_bwd", "ln_bwd_rows",
                   "ln_fwd"))
    shutil.rmtree(step_trainer.log_dir, ignore_errors=True)
    del os.environ["PGT_FUSED_ATTN"], os.environ["PGT_MLP_BWD"]

    def entry(name, replaces, err, t_kernel, t_plain, t_lib, b):
        return {"name": name, "route": "cuda",
                "source": "pytorch_generative_tpu_torch/csrc/" + (
                    "attn_block_fwd.cu" if name == attn_block_cuda.KERNEL else "mlp_bwd.cu"),
                "replaces": replaces, "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": t_lib}

    # Row 9 at LARGE_CONFIG's width and rows 6c, 6d: bound_ms at the 3xTF32
    # rate of their route, bound_f32_ms the f32 one beside it.
    bt = block_t[(c, hb)]
    return {"counts": [serve_counts, *train_counts], "kernels": [
        dict(entry(attn_block_cuda.KERNEL, "pytorch_generative_tpu/ops/attn_block_pallas.py:57",
                   block_err, bt["kernel"], bt["plain"], bt["library"], bt["bound"]),
             bound_f32_ms=bt["bound_f32"][0]),
        *(dict(entry(route_kernel[route], f"pytorch_generative_tpu/ops/mlp_pallas.py:{line}",
                     route_err[route], route_t[route]["kernel"][0], route_t[route]["plain"],
                     route_t[route]["library"], route_bounds[route]),
               bound_f32_ms=route_bounds_f32[route][0])
          for route, line in (("recompute", 112), ("pipe", 187)))]}


def bf16_flash_bytes(b, l, n_heads, d, backward=False):
    """flash_bytes for the bf16 mode: q, k, v, out, dout, dq, dk and dv of 2
    bytes, lse of 4."""
    c = n_heads * d
    if backward:
        return 2 * b * l * 8 * c + 4 * b * l * n_heads
    return 2 * b * l * 4 * c + 4 * b * l * n_heads


def bf16_ln_work(r, c):
    """ln_work for bf16 rows: x, y, dy and dx of 2 bytes, gamma and beta of
    2, dgamma and dbeta written as f32."""
    return (8 * r * c, 2 * (2 * r * c + 2 * c)), (18 * r * c, 2 * (3 * r * c + c) + 4 * 2 * c)


def bf16_mlp_work(r, c, f):
    """mlp_work for bf16 rows and weights: inputs and dx of 2 bytes, the
    parameter gradients written as f32."""
    vec = 2 * c + f + c
    fwd = (4 * r * c * f, 2 * (r * c + 2 * c * f + vec + r * c + r * f))
    bwd = (8 * r * c * f, 2 * (2 * r * c + r * f + 2 * c * f + 2 * c + r * c)
           + 4 * (2 * c * f + f + 3 * c))
    return fwd, bwd


class PlainCalls:
    """Counts the calls of the given modules' plain versions (flash,
    LayerNorm, MLP, VQ, fused block) while it is entered (the wrappers look
    them up by module attribute)."""

    NAMES = {"attention_cuda": ("flash_forward_plain", "flash_backward_plain"),
             "ln_cuda": ("layernorm_forward_plain", "layernorm_backward_plain"),
             "mlp_cuda": ("ln_mlp_forward_plain", "ln_mlp_backward_plain",
                          "ln_mlp_backward_recompute_plain"),
             "vq_cuda": ("vq_quantize_plain",),
             "attn_block_cuda": ("attention_block_plain", "project_plain")}

    def __init__(self, modules):
        self.modules = {m.__name__.rsplit(".", 1)[1]: m for m in modules}
        self.calls = 0

    def __enter__(self):
        self.saved = []
        for key, mod in self.modules.items():
            for name in self.NAMES[key]:
                real = getattr(mod, name)
                self.saved.append((mod, name, real))

                def counted(*args, _real=real):
                    self.calls += 1
                    return _real(*args)

                setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def bf16_digest_outputs(case, dev):
    """The outputs BF16_DIGESTS holds for one case, made as
    tests/test_torch_kernels.py makes them (torch.Generator seeds, randn on
    the CPU, scaled on the card, rounded to bf16)."""
    from pytorch_generative_tpu_torch.ops import attn_block_cuda, mlp_cuda

    def rand(shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)

    bf = torch.bfloat16
    if case.startswith("block"):
        _, c, h, *mc = case.split()
        c, n_heads = int(c[1:]), int(h[1:])
        seed = c + n_heads
        ops = [rand((2, 200, c), seed), rand((c, c), seed + 1) / c ** 0.5,
               0.1 * rand((c,), seed + 2), rand((c, 2 * c), seed + 3) / c ** 0.5,
               0.1 * rand((2 * c,), seed + 4), rand((c, c), seed + 5) / c ** 0.5,
               0.1 * rand((c,), seed + 6)]
        ops = [t.to(bf) for t in ops]
        y, attn, lse = attn_block_cuda.attention_block_forward(*ops, bool(mc), n_heads)
        return (y, attn, lse, *attn_block_cuda.project(*ops[:5]))
    r, c, f = 4097, 512, 2048
    x, gamma, beta, w1, b1, w2, b2 = (t.to(bf) for t in (
        2.0 * rand((r, c), 5) + 0.5, 1.0 + 0.1 * rand((c,), 6), 0.1 * rand((c,), 7),
        rand((c, f), 8) / c ** 0.5, 0.1 * rand((f,), 9), rand((f, c), 10) / f ** 0.5,
        0.1 * rand((c,), 11)))
    out, y = mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5)
    if case.endswith("forward"):
        return out, y
    return mlp_cuda.ln_mlp_backward(x, rand((r, c), 11).to(bf), y, gamma, beta, w1, b1, w2,
                                    1e-5)


def sha256_of(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()


def bf16_against_cpu(label, make, loss_fn, lr, batches, dev, key_bias=None, buffers=()):
    """3 Adam steps of the bf16 Trainer on the card and on the CPU (the
    plain versions) from the same weights (``make(device)``) and batches:
    losses within BF16_LOSS_RTOL; each parameter's update and each named
    buffer's change within BF16_UPDATE_RL2 relative L2 of the CPU's; the
    first n entries of every bias whose name ends like key_bias = (suffix,
    n), whose exact gradient is 0, within BF16_KEY_BIAS_ATOL x lr / 5e-3."""
    from pytorch_generative_tpu_torch import optim, trainer

    model, cpu_model = make(dev), make("cpu")
    cpu_model.load_state_dict({k_: v_.cpu() for k_, v_ in model.state_dict().items()})
    init = {k_: v_.detach().cpu().double().clone() for k_, v_ in
            [*model.named_parameters(),
             *((n_, b_) for n_, b_ in model.named_buffers() if n_ in buffers)]}
    losses = {}
    for where, net in ((dev, model), ("cpu", cpu_model)):
        t = trainer.Trainer(net, loss_fn, optim.adam_multiplicative(lr, 0.999977), [], [],
                            log_dir=tempfile.mkdtemp(prefix="chip_smoke_bf16_traj_"),
                            use_tensorboard=False, device=where, compute_dtype=torch.bfloat16)
        losses[str(where)] = [float(t.train_one_step(xb_, None)[0]["loss"]) for xb_ in batches]
        shutil.rmtree(t.log_dir, ignore_errors=True)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses[str(dev)], losses["cpu"]))
    card = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    ref = {**dict(cpu_model.named_parameters()), **dict(cpu_model.named_buffers())}
    updates, key_err = {}, 0.0
    for name, start in init.items():
        got, want = card[name].detach().cpu().double(), ref[name].detach().double()
        if key_bias and name.endswith(key_bias[0]):
            n = key_bias[1]
            key_err = max(key_err, float((got[:n] - want[:n]).abs().max()))
            got, want, start = got[n:], want[n:], start[n:]
        updates[name] = float((got - want).norm() / (want - start).norm().clamp(min=1e-30))
    worst = max(updates, key=updates.get)
    key_tol = BF16_KEY_BIAS_ATOL * lr / 5e-3
    print(f"phase bf16 trajectory {label} batch {len(batches[0])}: losses card "
          f"{losses[str(dev)]} cpu {losses['cpu']} max rel err {loss_err:.3e} (tol "
          f"{BF16_LOSS_RTOL}); update relative L2 largest {updates[worst]:.3e} ({worst}), "
          f"median {sorted(updates.values())[len(updates) // 2]:.3e} (tol {BF16_UPDATE_RL2})"
          + "".join(f"; {n_.rsplit('.', 1)[-1]} {updates[n_]:.3e}" for n_ in buffers)
          + (f"; key bias max abs diff {key_err:.3e} (tol {key_tol:.3g})" if key_bias else ""),
          flush=True)
    if buffers:  # a code that one side picks and the other not moves its row far
        sizes = [dict(m_.named_buffers())[buffers[0]].detach().cpu() for m_ in (model, cpu_model)]
        print(f"phase bf16 trajectory {label}: codes whose EMA cluster size differs card vs "
              f"CPU {int((sizes[0] != sizes[1]).sum())} of {sizes[0].numel()}", flush=True)
    check(loss_err <= BF16_LOSS_RTOL, f"bf16 losses disagree with the CPU ({label})")
    check(updates[worst] <= BF16_UPDATE_RL2 and key_err <= key_tol,
          f"bf16 updates disagree with the CPU ({label})")


def bf16_phases(dev, gen, smi, reset_counts, read_counts):
    """ImageGPT's mixed-precision training, Trainer(compute_dtype=
    torch.bfloat16), at the reproduce() config (C = 64, 2 heads of 32) and
    at LARGE_CONFIG (C = 512, 8 heads of 64 and 4 of 128), batch 64: the
    bf16 modes of the flash kernels (at the three head widths), of the
    LayerNorm kernels and of the fused MLP's forward and three backward
    routes against their plain versions (two calls give equal bits, and
    the MLP routes the saved-y route's bits), each timed beside its plain
    version, its bound at the bf16 tensor-core rate and a bf16 library
    yardstick; one Trainer epoch of BF16_TRAIN_STEPS steps with eval at
    each configuration, with its bf16 launches (f32 ones and plain calls
    0) and its step time; one step on each opt-in MLP route; 3 Adam steps
    against the CPU's bf16 Trainer. Returns the runs' launch counts and
    the bf16 entries of the per-kernel JSON."""
    from pytorch_generative_tpu_torch import datasets, optim, trainer
    from pytorch_generative_tpu_torch.models import ImageGPT
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
    from pytorch_generative_tpu_torch.ops import attention_cuda, ln_cuda, mlp_cuda

    bf = torch.bfloat16
    h = w = 28
    l = h * w
    large = image_gpt.LARGE_CONFIG
    configs = (("C=64 H=2", image_gpt.REPRODUCE_CONFIG),
               ("C=512 H=8", large), ("C=512 H=4", dict(large, n_attention_heads=4)))

    # Phase bf16-1: the flash kernels' bf16 mode at the three widths, (B 64,
    # L 784), k and v feature slices of one kv tensor, as the layer passes
    # them.
    flash = {}
    for c, n_heads in ((64, 2), (512, 8), (512, 4)):
        d = c // n_heads
        q = torch.randn((BATCH, l, c), generator=gen).to(dev, bf)
        kv = torch.randn((BATCH, l, 2 * c), generator=gen).to(dev, bf)
        dout = torch.randn((BATCH, l, c), generator=gen).to(dev, bf)
        k, v = kv[..., :c], kv[..., c:]
        out, lse = attention_cuda.flash_forward(q, k, v, False, n_heads)
        grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, False, n_heads)
        again = (*attention_cuda.flash_forward(q, k, v, False, n_heads),
                 *attention_cuda.flash_backward(q, k, v, out, lse, dout, False, n_heads))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip((out, lse, *grads), again))
        ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, False, n_heads)
        e_out, e_lse = rel_err(out.float(), ref_out.float()), rel_err(lse, ref_lse)
        ref_grads = attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, False, n_heads)
        e_grads = [rel_err(g.float(), r.float()) for g, r in zip(grads, ref_grads)]
        print(f"phase bf16 flash d={d} (B={BATCH}, L={l}, H={n_heads}): max_abs_err (max |plain|) "
              f"out={e_out[0]:.3e} ({e_out[1]:.3e}) lse={e_lse[0]:.3e} ({e_lse[1]:.3e}); "
              + " ".join(f"{n}={e[0]:.3e} ({e[1]:.3e})" for n, e in zip(("dq", "dk", "dv"), e_grads))
              + f" (tol {BF16_TOL:.4g} x max |plain|, lse {BF16_LSE_RTOL}); two calls give "
              f"equal bits: {same}", flush=True)
        check(same, f"the bf16 flash kernels gave other bits in a second call (d = {d})")
        check(e_out[0] <= BF16_TOL * e_out[1] and e_lse[0] <= BF16_LSE_RTOL * e_lse[1],
              f"the bf16 flash forward disagrees with its plain version (d = {d})")
        check(all(e[0] <= BF16_TOL * e[1] for e in e_grads),
              f"the bf16 flash backward disagrees with its plain version (d = {d})")
        del ref_out, ref_lse, ref_grads, again
        t = flash_times(q, k, v, dout, n_heads)
        fb = bound(flash_work(BATCH, l, n_heads, d, d, False),
                   bf16_flash_bytes(BATCH, l, n_heads, d), BF16_FLOPS)
        bb = bound(flash_work(BATCH, l, n_heads, d, d, False, backward=True),
                   bf16_flash_bytes(BATCH, l, n_heads, d, backward=True), BF16_FLOPS)
        print(f"phase bf16 times flash d={d} [{smi}]: flash_fwd_bf16 (B={BATCH}, L={l}, "
              f"H={n_heads}) kernel {t['fwd']:.4f}/{t['fwd2']:.4f} ms, plain {t['fwd_plain']:.4f} "
              f"ms, bf16 causal SDPA {t['fwd_lib']:.4f} ms, bf16 bound {fb[0]:.4f} ms ({fb[1]}); "
              f"flash_bwd_bf16 kernel {t['bwd']:.4f}/{t['bwd2']:.4f} ms, plain "
              f"{t['bwd_plain']:.4f} ms, bf16 SDPA autograd.grad {t['bwd_lib']:.4f} ms, bf16 "
              f"bound {bb[0]:.4f} ms ({bb[1]})", flush=True)
        flash[d] = dict(fwd_err=e_out[0], bwd_err=max(e[0] for e in e_grads), t=t,
                        fwd_bound=fb, bwd_bound=bb)
        del q, kv, dout, out, lse, grads

    # Phase bf16-2: the LayerNorm and MLP kernels' bf16 mode at the blocks'
    # rows at batch 64 (R = 50,176, C = 512, F = 2048) and a ragged R; the
    # MLP's three backward routes from the forward's own saved y.
    c = large["n_embedding_channels"]
    f = 4 * c
    r = BATCH * l
    errs = {}
    for rows in (r, r - 7):
        x = (2.0 * torch.randn((rows, c), generator=gen) + 0.5).to(dev, bf)
        gamma = (1.0 + 0.1 * torch.randn((c,), generator=gen)).to(dev, bf)
        beta = (0.1 * torch.randn((c,), generator=gen)).to(dev, bf)
        w1 = (torch.randn((c, f), generator=gen) / c ** 0.5).to(dev, bf)
        b1 = (0.1 * torch.randn((f,), generator=gen)).to(dev, bf)
        w2 = (torch.randn((f, c), generator=gen) / f ** 0.5).to(dev, bf)
        b2 = (0.1 * torch.randn((c,), generator=gen)).to(dev, bf)
        dy = torch.randn((rows, c), generator=gen).to(dev, bf)
        y_ln = ln_cuda.ln_forward(x, gamma, beta, 1e-5)
        g_ln = ln_cuda.ln_backward(x, dy, gamma, 1e-5)
        same_ln = torch.equal(y_ln, ln_cuda.ln_forward(x, gamma, beta, 1e-5)) and all(
            torch.equal(a, b) for a, b in zip(g_ln, ln_cuda.ln_backward(x, dy, gamma, 1e-5)))
        e = {"ln_fwd_bf16": rel_err(y_ln.float(), ln_cuda.layernorm_forward_plain(
            x, gamma, beta, 1e-5).float())}
        for name, got, want in zip(("dx", "dgamma", "dbeta"), g_ln,
                                   ln_cuda.layernorm_backward_plain(x, dy, gamma, 1e-5)):
            e[f"ln_bwd_bf16 {name}"] = rel_err(got.float(), want.float())
        out, y = mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5)
        out2, y2 = mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5)
        routes = {
            "saved": lambda: mlp_cuda.ln_mlp_backward(x, dy, y, gamma, beta, w1, b1, w2, 1e-5),
            "recompute": lambda: mlp_cuda.ln_mlp_backward_recompute(x, dy, gamma, beta, w1, b1,
                                                                    w2, 1e-5),
            "pipe": lambda: mlp_cuda.ln_mlp_backward_pipe(x, dy, y, gamma, beta, w1, b1, w2,
                                                          1e-5)}
        grads = {route: (fn(), fn()) for route, fn in routes.items()}
        torch.cuda.synchronize()
        same_mlp = torch.equal(out, out2) and torch.equal(y, y2) and all(
            all(torch.equal(a, b) for a, b in zip(first, second)) for first, second in grads.values())
        routes_equal = all(all(torch.equal(a, b) for a, b in zip(g[0], grads["saved"][0]))
                           for g in grads.values())
        want_out, want_y = mlp_cuda.ln_mlp_forward_plain(x, gamma, beta, w1, b1, w2, b2, 1e-5)
        e["mlp_fwd_bf16 out"] = rel_err(out.float(), want_out.float())
        e["mlp_fwd_bf16 y"] = rel_err(y.float(), want_y.float())
        want = mlp_cuda.ln_mlp_backward_plain(x, dy, y, gamma, beta, w1, b1, w2, 1e-5)
        for name, got, wnt in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"),
                                  grads["saved"][0], want):
            e[f"mlp_bwd_bf16 {name}"] = rel_err(got.float(), wnt.float())
        print(f"phase bf16 ln/mlp R={rows} C={c} F={f}: max_abs_err (max |plain|) " + ", ".join(
            f"{k_} {v_[0]:.3e} ({v_[1]:.3e})" for k_, v_ in e.items())
            + f"; two calls give equal bits: ln {same_ln}, mlp {same_mlp}; the recompute and "
            f"pipelined routes give the saved-y route's bits: {routes_equal}", flush=True)
        check(same_ln and same_mlp, "a bf16 LayerNorm or MLP kernel gave other bits in a second call")
        check(routes_equal, "the bf16 MLP backward routes gave other bits than the saved-y route")
        for k_, (err, scale) in e.items():
            tol = (BF16_LN_SUM_RTOL if k_ in ("ln_bwd_bf16 dgamma", "ln_bwd_bf16 dbeta") else
                   BF16_MLP_SUM_RTOL if k_.startswith("mlp_bwd") and not k_.endswith("dx") else
                   BF16_TOL)
            check(err <= tol * scale, f"{k_} disagrees with its plain version (R = {rows})")
            kern = k_.split()[0]
            errs[kern] = max(errs.get(kern, 0.0), err)
        del grads, out, out2, y2, want, want_out, want_y, g_ln, y_ln

    # Times at R = 50,176 (the last loop's tensors are at R - 7: make them
    # again at R), each backward's yardstick autograd.grad through bf16
    # F.layer_norm or through the bf16 composition F.layer_norm -> addmm ->
    # F.gelu -> addmm -> + x.
    x = (2.0 * torch.randn((r, c), generator=gen) + 0.5).to(dev, bf)
    dy = torch.randn((r, c), generator=gen).to(dev, bf)
    leaves = [t.requires_grad_() for t in (x.clone(), gamma.clone(), beta.clone(), w1.clone(),
                                           b1.clone(), w2.clone(), b2.clone())]
    xr, gr, br, w1r, b1r, w2r, b2r = leaves
    ln_lib_out = F.layer_norm(xr, (c,), gr, br, 1e-5)
    comp = lambda: torch.addmm(b2r, F.gelu(torch.addmm(b1r, F.layer_norm(xr, (c,), gr, br, 1e-5),
                                                       w1r)), w2r) + xr
    mlp_lib_out = comp()
    _, y = mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5)

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    fns = {
        "ln_fwd_bf16": (lambda: ln_cuda.ln_forward(x, gamma, beta, 1e-5),
                        lambda: ln_cuda.layernorm_forward_plain(x, gamma, beta, 1e-5),
                        no_grad(lambda: F.layer_norm(x, (c,), gamma, beta, 1e-5)), 20),
        "ln_bwd_bf16": (lambda: ln_cuda.ln_backward(x, dy, gamma, 1e-5),
                        lambda: ln_cuda.layernorm_backward_plain(x, dy, gamma, 1e-5),
                        lambda: torch.autograd.grad(ln_lib_out, (xr, gr, br), dy,
                                                    retain_graph=True), 20),
        "mlp_fwd_bf16": (lambda: mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5),
                         lambda: mlp_cuda.ln_mlp_forward_plain(x, gamma, beta, w1, b1, w2, b2,
                                                               1e-5), no_grad(comp), 5),
    }
    bwd_lib = lambda: torch.autograd.grad(mlp_lib_out, leaves, dy, retain_graph=True)
    bwd_plain = lambda: mlp_cuda.ln_mlp_backward_plain(x, dy, y, gamma, beta, w1, b1, w2, 1e-5)
    for kern, route in ((mlp_cuda.BF16_BWD_KERNEL, lambda: mlp_cuda.ln_mlp_backward(
            x, dy, y, gamma, beta, w1, b1, w2, 1e-5)),
            (mlp_cuda.BF16_RECOMPUTE_KERNEL, lambda: mlp_cuda.ln_mlp_backward_recompute(
                x, dy, gamma, beta, w1, b1, w2, 1e-5)),
            (mlp_cuda.BF16_PIPE_KERNEL, lambda: mlp_cuda.ln_mlp_backward_pipe(
                x, dy, y, gamma, beta, w1, b1, w2, 1e-5))):
        fns[kern] = (route, bwd_plain, bwd_lib, 5)
    errs[mlp_cuda.BF16_RECOMPUTE_KERNEL] = errs[mlp_cuda.BF16_PIPE_KERNEL] = errs["mlp_bwd_bf16"]
    (ln_f, ln_b), (mlp_f, mlp_b) = bf16_ln_work(r, c), bf16_mlp_work(r, c, f)
    # The recompute route also computes y = LN(x) W1 + b1 (2 R C F more
    # operations) and reads b1 where the others read y.
    works = {"ln_fwd_bf16": ln_f, "ln_bwd_bf16": ln_b, "mlp_fwd_bf16": mlp_f,
             mlp_cuda.BF16_RECOMPUTE_KERNEL: (mlp_b[0] + 2 * r * c * f,
                                              mlp_b[1] - 2 * r * f + 2 * f)}
    rows_times = {}
    for kern, (fn, plain, lib, iters) in fns.items():
        tt = {"plain": time_ms(plain, iters, 2), "kernel": time_ms(fn, iters, 2),
              "library": time_ms(lib, iters, 2), "kernel2": time_ms(fn, iters, 2)}
        b_ = bound(*works.get(kern, mlp_b), BF16_FLOPS)
        rows_times[kern] = dict(tt, bound=b_)
        print(f"phase bf16 times {kern} (R={r}, C={c}, F={f}) [{smi}]: kernel "
              f"{tt['kernel']:.4f}/{tt['kernel2']:.4f} ms, plain {tt['plain']:.4f} ms, bf16 "
              f"library {tt['library']:.4f} ms, bf16 bound {b_[0]:.4f} ms ({b_[1]})", flush=True)
    del leaves, ln_lib_out, mlp_lib_out, x, dy, y

    # Phase bf16-3: the Trainer with compute_dtype=torch.bfloat16 through
    # its entry point, one epoch of BF16_TRAIN_STEPS steps at batch 64 with
    # eval and a checkpoint, at each configuration: every launch of the
    # flash, LayerNorm and MLP kernels is a bf16 one, no plain version runs;
    # then the step's time.
    counts_all = []
    mods = (attention_cuda, ln_cuda, mlp_cuda)
    bf16_fwd_bwd = (attention_cuda.BF16_KERNEL, attention_cuda.BF16_BWD_KERNEL)
    bf16_fused = (ln_cuda.BF16_KERNEL, ln_cuda.BF16_BWD_KERNEL, mlp_cuda.BF16_KERNEL,
                  mlp_cuda.BF16_BWD_KERNEL)
    f32_kernels = (attention_cuda.KERNEL, attention_cuda.BWD_KERNEL, ln_cuda.KERNEL,
                   ln_cuda.BWD_KERNEL, mlp_cuda.KERNEL, mlp_cuda.BWD_KERNEL)
    step_ms = {}
    for label, cfg in configs:
        train_loader, test_loader = datasets.get_synthetic_mnist_loaders(
            BATCH, n_train=BF16_TRAIN_STEPS * BATCH, n_test=BATCH, image_size=h, seed=0)
        log_dir = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
        try:
            net = ImageGPT(**cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
            t = trainer.Trainer(net, image_gpt.reproduce_loss,
                                optim.adam_multiplicative(5e-3, 0.999977), train_loader,
                                test_loader, log_dir=log_dir, sample_epochs=None,
                                use_tensorboard=False, device=dev, compute_dtype=torch.bfloat16)
            reset_counts()
            with PlainCalls(mods) as plain:
                t.interleaved_train_and_eval(1)
                torch.cuda.synchronize()
            counts = read_counts()
            counts_all.append(counts)
            losses, _ = read_losses(log_dir)
            saved = torch.load(os.path.join(log_dir, "trainer_state_1.ckpt"), weights_only=False)
            master = all(t_.dtype == torch.float32 for t_ in saved["state"]["model"].values()
                         if t_.is_floating_point())
            fused_on = cfg["n_embedding_channels"] % 128 == 0
            want = bf16_fwd_bwd + (bf16_fused if fused_on else ())
            print(f"phase bf16 train {label}: steps {t._step}, losses "
                  f"{[round(losses[k_], 3) for k_ in sorted(losses)]}; checkpoint float32: "
                  f"{master}; plain calls {plain.calls}; launches " + ", ".join(
                      f"{k_}={v_}" for k_, v_ in counts.items() if v_), flush=True)
            check(t._step == BF16_TRAIN_STEPS and all(math.isfinite(v_) for v_ in losses.values()),
                  f"the bf16 Trainer epoch failed ({label})")
            check(master, f"the bf16 Trainer's checkpoint is not float32 ({label})")
            check(plain.calls == 0, f"a plain version served the bf16 path ({label})")
            check(all(counts[k_] > 0 for k_ in want),
                  f"a bf16 kernel of the path never launched ({label}): {counts}")
            check(all(counts[k_] == 0 for k_ in f32_kernels),
                  f"an f32 kernel launched on the bf16 path ({label})")
            check(fused_on or all(counts[k_] == 0 for k_ in bf16_fused),
                  f"a fused kernel launched at C = 64 ({label})")
            xb = next(iter(train_loader))[0]
            step_ms[label] = time_ms(lambda: t.train_one_step(xb, None), BF16_TIMED_STEPS, 1)
            print(f"phase bf16 step {label} batch {BATCH} [{smi}]: {step_ms[label]:.2f} ms a "
                  f"step, {BATCH * 1000 / step_ms[label]:.1f} samples/s", flush=True)
            profile_steps(lambda: t.train_one_step(xb, None), 2, step_ms[label],
                          f"bf16 train step batch {BATCH}", (BATCH, "samples"),
                          f"profile bf16 step {label}", smi,
                          ("wgemm::", "flash_bwd", "flash_fwd", "ln_", "elementwise"),
                          host=True)
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
        del t, net

    # Phase bf16-4: one bf16 step at LARGE_CONFIG on each opt-in MLP
    # backward route (the routes' launches).
    xb = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
    t = trainer.Trainer(ImageGPT(**large, generator=torch.Generator().manual_seed(SEED),
                                 device=dev), image_gpt.reproduce_loss,
                        optim.adam_multiplicative(5e-3, 0.999977), [], [],
                        log_dir=tempfile.mkdtemp(prefix="chip_smoke_bf16_routes_"),
                        use_tensorboard=False, device=dev, compute_dtype=torch.bfloat16)
    nb = large["n_transformer_blocks"]
    for route, kern in (("recompute", mlp_cuda.BF16_RECOMPUTE_KERNEL),
                        ("pipe", mlp_cuda.BF16_PIPE_KERNEL)):
        set_mlp_route(route)
        try:
            reset_counts()
            with PlainCalls(mods) as plain:
                loss = float(t.train_one_step(xb, None)[0]["loss"])
                torch.cuda.synchronize()
            counts = read_counts()
            counts_all.append(counts)
            route_ms = time_ms(lambda: t.train_one_step(xb, None), 3, 1)
        finally:
            set_mlp_route("saved")
        print(f"phase bf16 route {route} C={c}: loss {loss:.3f}, {kern} launches {counts[kern]}, "
              f"{mlp_cuda.BF16_BWD_KERNEL} {counts[mlp_cuda.BF16_BWD_KERNEL]}, plain calls "
              f"{plain.calls}; step {route_ms:.2f} ms [{smi}]", flush=True)
        check(counts[kern] == nb and counts[mlp_cuda.BF16_BWD_KERNEL] == 0 and plain.calls == 0,
              f"the bf16 step on the {route} route did not run its kernel once a block")
    shutil.rmtree(t.log_dir, ignore_errors=True)
    del t

    # Phase bf16-5: 3 Adam steps of the bf16 Trainer on the card and on the
    # CPU (the plain versions), same weights and batches.
    for label, cfg, batch in (("C=64 H=2", image_gpt.REPRODUCE_CONFIG, TRAJ_BATCH),
                              ("C=512 H=8", large, 2)):
        bf16_against_cpu(label, lambda where, cfg=cfg: ImageGPT(
            **cfg, generator=torch.Generator().manual_seed(SEED + 3), device=where),
            image_gpt.reproduce_loss, 5e-3,
            [(torch.rand((batch, h, w, 1), generator=gen) < 0.13).float().numpy()
             for _ in range(3)], dev, key_bias=("attn.kv_proj.bias", cfg["n_embedding_channels"]))

    def entry(name, source, replaces, err, tt, bound_, instances=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "max_abs_err": err, "ms": tt["kernel"], "plain_ms": tt["plain"],
                "bound_ms": bound_[0], "bound_by": bound_[1], "library_ms": tt["library"],
                **({"instances": instances} if instances else {})}

    # The flash entries' ms, plain_ms, library_ms and bound at LARGE_CONFIG's
    # d = 64; every instance was held against its plain version above.
    f64 = flash[64]
    instances = [f"{d}x{d}" for d in sorted(flash)]
    src = "pytorch_generative_tpu_torch/csrc/"
    kernels = [
        entry(attention_cuda.BF16_KERNEL, src + "flash_wgmma_bf16.cuh",
              "pytorch_generative_tpu/ops/attention_pallas.py:100",
              max(v_["fwd_err"] for v_ in flash.values()),
              {"kernel": f64["t"]["fwd"], "plain": f64["t"]["fwd_plain"],
               "library": f64["t"]["fwd_lib"]}, f64["fwd_bound"], instances),
        entry(attention_cuda.BF16_BWD_KERNEL, src + "flash_wgmma_bf16.cuh",
              "pytorch_generative_tpu/ops/attention_pallas.py:205",
              max(v_["bwd_err"] for v_ in flash.values()),
              {"kernel": f64["t"]["bwd"], "plain": f64["t"]["bwd_plain"],
               "library": f64["t"]["bwd_lib"]}, f64["bwd_bound"], instances),
        *(entry(kern, src + source, replaces, errs[kern], rows_times[kern],
                rows_times[kern]["bound"])
          for kern, source, replaces in (
              (ln_cuda.BF16_KERNEL, "ln_fwd.cu", "pytorch_generative_tpu/ops/ln_pallas.py:41"),
              (ln_cuda.BF16_BWD_KERNEL, "ln_bwd.cu", "pytorch_generative_tpu/ops/ln_pallas.py:48"),
              (mlp_cuda.BF16_KERNEL, "gemm_wgmma_bf16.cuh",
               "pytorch_generative_tpu/ops/mlp_pallas.py:81"),
              (mlp_cuda.BF16_BWD_KERNEL, "gemm_wgmma_bf16.cuh",
               "pytorch_generative_tpu/ops/mlp_pallas.py:102"),
              (mlp_cuda.BF16_RECOMPUTE_KERNEL, "gemm_wgmma_bf16.cuh",
               "pytorch_generative_tpu/ops/mlp_pallas.py:112"),
              (mlp_cuda.BF16_PIPE_KERNEL, "gemm_wgmma_bf16.cuh",
               "pytorch_generative_tpu/ops/mlp_pallas.py:187")))]
    return {"counts": counts_all, "kernels": kernels, "step_ms": step_ms}


def bf16_slice_phases(dev, gen, smi, reset_counts, read_counts):
    """The last three paths under Trainer(compute_dtype=torch.bfloat16), at
    full width: (P1) PixelSNAIL at its reproduce() config, batch 128, whose
    attention runs the flash kernels' bf16 mode at (d_k, d_v) = (4, 32)
    (forward and backward on bf16 mma.sync); (P2) VQ-VAE at
    its reproduce() config, batch 128, on the fused route (PGT_FUSED_VQ=1,
    the vq kernel's bf16 rows) and the unfused one; (P3) ImageGPT with the
    fused attention block (PGT_FUSED_ATTN=1, its bf16 entries) at C = 64
    with 2 heads, C = 512 with 8 and with 4, batch 64. For each: the new
    kernel mode against its plain version (the VQ's bit for bit against
    the f32 kernel on the rows widened to f32; the block's recompute bit
    for bit against its forward's projection, its outputs and the MLP's
    against BF16_DIGESTS, its launches a forward and a recompute counted),
    timed beside its plain version, its bound and a
    library yardstick; one Trainer epoch of BF16_TRAIN_STEPS steps with
    eval, its launches (no plain version called) and step time, a profiled
    step; 3 Adam steps against the CPU's bf16 Trainer. Returns the runs'
    launch counts and the per-kernel JSON entries."""
    from pytorch_generative_tpu_torch import datasets, optim, trainer
    from pytorch_generative_tpu_torch.models import ImageGPT, PixelSNAIL, VectorQuantizedVAE
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt, pixel_snail
    from pytorch_generative_tpu_torch.models.vae import vq_vae
    from pytorch_generative_tpu_torch.ops import (
        attention_cuda,
        attn_block_cuda,
        ln_cuda,
        mlp_cuda,
        vq_cuda,
    )

    bf = torch.bfloat16
    src = "pytorch_generative_tpu_torch/csrc/"
    counts_all, kernels = [], []

    def epoch(label, net, loss_fn, lr, loaders, want, mods, others=()):
        """One bf16 Trainer epoch with eval, no plain version of ``mods``
        called: the launches of ``want`` exactly, those of ``others``
        (another module's bf16 kernels on the path) at least once, no other
        kernel; returns (trainer, counts)."""
        log_dir = tempfile.mkdtemp(prefix="chip_smoke_slice_")
        t = trainer.Trainer(net, loss_fn, optim.adam_multiplicative(lr, 0.999977), *loaders,
                            log_dir=log_dir, sample_epochs=None, use_tensorboard=False,
                            device=dev, compute_dtype=bf)
        reset_counts()
        with PlainCalls(mods) as plain:
            t.interleaved_train_and_eval(1)
            torch.cuda.synchronize()
        counts = read_counts()
        counts_all.append(counts)
        losses, _ = read_losses(log_dir)
        shutil.rmtree(log_dir, ignore_errors=True)
        print(f"phase bf16 train {label}: steps {t._step}, losses "
              f"{[round(losses[k_], 4) for k_ in sorted(losses)]}; plain calls {plain.calls}; "
              "launches " + ", ".join(f"{k_}={v_}" for k_, v_ in counts.items() if v_), flush=True)
        check(t._step == BF16_TRAIN_STEPS and all(math.isfinite(v_) for v_ in losses.values()),
              f"the bf16 Trainer epoch failed ({label})")
        check(plain.calls == 0, f"a plain version served the bf16 path ({label})")
        got = {k_: v_ for k_, v_ in counts.items() if v_ and k_ not in others}
        check(got == want and all(counts[k_] > 0 for k_ in others),
              f"bf16 {label} launches {counts}, expected {want} and {others}")
        return t, counts

    # ---- P1: PixelSNAIL. ----
    scfg = pixel_snail.REPRODUCE_CONFIG
    h, w, _ = scfg["in_shape"]
    l = h * w
    s_dk, s_dv = scfg["attention_key_channels"], scfg["attention_value_channels"]
    nb = scfg["n_pixel_snail_blocks"]
    # Phase S1: the bf16 flash pair at (B 128, L 784, H 1, 4, 32,
    # mask_center) against their plain versions, k and v column views of
    # one (B, L, 36) kv tensor; two calls give equal bits.
    q = torch.randn((SNAIL_BATCH, l, s_dk), generator=gen).to(dev, bf)
    kv = torch.randn((SNAIL_BATCH, l, s_dk + s_dv), generator=gen).to(dev, bf)
    dout = torch.randn((SNAIL_BATCH, l, s_dv), generator=gen).to(dev, bf)
    k, v = kv[..., :s_dk], kv[..., s_dk:]
    out, lse = attention_cuda.flash_forward(q, k, v, True, 1)
    grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, True, 1)
    check_flash_deterministic(q, k, v, dout, True, 1, out, lse, grads,
                              f"bf16 PixelSNAIL (d_k={s_dk}, d_v={s_dv})")
    ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, True, 1)
    ref_grads = attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, True, 1)
    fin = torch.isfinite(ref_lse)
    e_out, e_lse = rel_err(out.float(), ref_out.float()), rel_err(lse[fin], ref_lse[fin])
    e_grads = [rel_err(g.float(), r.float()) for g, r in zip(grads, ref_grads)]
    row0 = (bool((out[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all())
            and bool((grads[0][:, 0] == 0).all()))
    print(f"phase bf16 flash PixelSNAIL (B={SNAIL_BATCH}, L={l}, H=1, d_k={s_dk}, d_v={s_dv}, "
          f"mask_center): max_abs_err (max |plain|) out={e_out[0]:.3e} ({e_out[1]:.3e}) "
          f"lse={e_lse[0]:.3e} ({e_lse[1]:.3e}); " + " ".join(
              f"{n}={e[0]:.3e} ({e[1]:.3e})" for n, e in zip(("dq", "dk", "dv"), e_grads))
          + f" (tol {BF16_TOL:.4g} x max |plain|, lse {BF16_LSE_RTOL}); row 0 out 0, lse -inf, "
          f"dq 0: {row0}", flush=True)
    check(row0, "row 0 under mask_center is not out 0, lse -inf, dq 0 in bf16")
    check(e_out[0] <= BF16_TOL * max(1.0, e_out[1])
          and e_lse[0] <= BF16_LSE_RTOL * max(1.0, e_lse[1]),
          "the bf16 flash forward disagrees with its plain version at (4, 32)")
    check(all(e[0] <= BF16_TOL * max(1.0, e[1]) for e in e_grads),
          "the bf16 flash backward disagrees with its plain version at (4, 32)")
    st = flash_times(q, k, v, dout, 1, mask_center=True)
    # The bound at the bf16 operands' rate (989 TFLOP/s) and bytes: both
    # run on bf16 mma.sync.
    works = {"fwd": (flash_work(SNAIL_BATCH, l, 1, s_dk, s_dv, True),
                     2 * SNAIL_BATCH * l * (2 * s_dk + 2 * s_dv) + 4 * SNAIL_BATCH * l),
             "bwd": (flash_work(SNAIL_BATCH, l, 1, s_dk, s_dv, True, backward=True),
                     2 * SNAIL_BATCH * l * (4 * s_dk + 4 * s_dv) + 4 * SNAIL_BATCH * l)}
    sb = {k_: bound(*w_, BF16_FLOPS) for k_, w_ in works.items()}
    print(f"phase bf16 times flash PixelSNAIL [{smi}]: " + "; ".join(
        f"flash_{k_}_bf16 (4, 32) kernel {st[k_]:.4f}/{st[k_ + '2']:.4f} ms, plain "
        f"{st[k_ + '_plain']:.4f} ms, "
        + ("bf16 masked SDPA" if k_ == "fwd" else "bf16 masked SDPA autograd.grad")
        + f" {st[k_ + '_lib']:.4f} ms, bf16 bound {b_[0]:.4f} ms ({b_[1]}, bf16 mma.sync)"
        for k_, b_ in sb.items()), flush=True)
    del q, kv, dout, k, v, out, lse, grads, ref_out, ref_lse, ref_grads
    # Phase S2: a bf16 Trainer epoch at batch 128 (BF16_TRAIN_STEPS steps
    # and one eval batch): bf16 flash launches only, at (4, 32).
    loaders = datasets.get_synthetic_mnist_loaders(
        SNAIL_BATCH, n_train=BF16_TRAIN_STEPS * SNAIL_BATCH, n_test=SNAIL_BATCH, image_size=h,
        seed=0)
    snail = PixelSNAIL(**scfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    t, counts = epoch("PixelSNAIL", snail, pixel_snail.reproduce_loss, 1e-3, loaders,
                      {attention_cuda.BF16_KERNEL: (BF16_TRAIN_STEPS + 1) * nb,
                       attention_cuda.BF16_BWD_KERNEL: BF16_TRAIN_STEPS * nb}, (attention_cuda,))
    snail_launches = (counts[attention_cuda.BF16_KERNEL], counts[attention_cuda.BF16_BWD_KERNEL])
    counts_all.pop()  # these launches are the 4x32 entries' own, not flash_*_bf16's
    xb = next(iter(loaders[0]))[0]
    snail_ms = time_ms(lambda: t.train_one_step(xb, None), BF16_TIMED_STEPS, 1)
    print(f"phase bf16 step PixelSNAIL batch {SNAIL_BATCH} [{smi}]: {snail_ms:.2f} ms a step, "
          f"{SNAIL_BATCH * 1000 / snail_ms:.1f} samples/s", flush=True)
    share = profile_steps(lambda: t.train_one_step(xb, None), 2, snail_ms,
                          f"bf16 train step batch {SNAIL_BATCH}", (SNAIL_BATCH, "samples"),
                          "profile bf16 step PixelSNAIL", smi,
                          ("smma::fwd_kernel", "smma::dq_kernel", "smma::dkdv_kernel", "xmma",
                           "cudnn", "elementwise", "reduce_kernel"), host=True)
    flash_ms, flash_pct = share("smma::")
    print(f"phase bf16 step PixelSNAIL [{smi}]: the flash kernels (smma::) {flash_ms:.3f} ms a "
          f"step, {flash_pct:.1f}% of kernel time", flush=True)
    del t, snail
    bf16_against_cpu("PixelSNAIL", lambda where: PixelSNAIL(
        **scfg, generator=torch.Generator().manual_seed(SEED + 7), device=where),
        pixel_snail.reproduce_loss, 1e-3,
        [(torch.rand((TRAJ_BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
         for _ in range(3)], dev, key_bias=("attention.kv_proj.bias", s_dk))
    for name, lib, line in ((attention_cuda.BF16_KERNEL, "fwd", 100),
                            (attention_cuda.BF16_BWD_KERNEL, "bwd", 205)):
        b_ = sb[lib]
        kernels.append({
            "name": f"{name} 4x32", "route": "cuda",
            "source": src + ("flash_fwd_small_bf16.cuh" if lib == "fwd"
                             else "flash_bwd_mma_bf16.cuh"),
            "replaces": f"pytorch_generative_tpu/ops/attention_pallas.py:{line}",
            "launches": snail_launches[lib == "bwd"],
            "max_abs_err": e_out[0] if lib == "fwd" else max(e[0] for e in e_grads),
            "ms": st[lib], "plain_ms": st[f"{lib}_plain"], "bound_ms": b_[0],
            "bound_by": b_[1], "library_ms": st[f"{lib}_lib"], "instances": ["4x32", "4x8"]})

    # ---- P2: VQ-VAE. ----
    vcfg = vq_vae.REPRODUCE_CONFIG
    vh, vw, vc = vcfg["in_shape"]
    m, kk, d = VQ_BATCH * (vh // 4) * (vw // 4), vcfg["n_embeddings"], vcfg["embedding_dim"]
    # Phase Q1: the vq kernel's bf16 rows at a ragged M and (M 8192, K 512,
    # D 64), timed at the latter: codes, counts and sums bit for bit the f32 kernel's on the
    # rows widened to f32, the quantized rows its rows rounded to bf16; and
    # against the plain version as vq_against_plain holds the f32 entry.
    vq_err = 0.0
    for rows_ in (m - 1, m):
        x = torch.randn((rows_, d), generator=gen).to(dev, bf)
        cb = (torch.rand((kk, d), generator=gen) * 2 - 1).to(dev) * 0.5
        qb, cnt, sm = vq_cuda.vq_quantize_fused(x, cb)
        qf, cntf, smf = vq_cuda.vq_quantize_fused(x.float(), cb)
        torch.cuda.synchronize()
        bits = (torch.equal(qb, qf.to(bf)) and torch.equal(cnt, cntf) and torch.equal(sm, smf))
        n_differ, n_near, q_err, counts_equal, s_err, s_max = vq_against_plain(x, cb)
        vq_err = max(vq_err, q_err, s_err)
        print(f"phase bf16 vq M={rows_} K={kk} D={d}: against the f32 kernel on x.float(): "
              f"codes, counts and sums equal bits and quantized = its rows in bf16: {bits}; "
              f"against the plain version: rows differing {n_differ} (near-tie rows {n_near}), "
              f"quantized max_abs_err {q_err:.3e}, counts equal {counts_equal}, sums "
              f"max_abs_err {s_err:.3e} (max |plain| {s_max:.3e})", flush=True)
        check(bits, "the bf16 vq mode is not the f32 kernel's bits on the widened rows")
    vq_t = {"kernel": time_ms(lambda: vq_cuda.vq_quantize_fused(x, cb), 50, 3),
            "graph": graph_ms(lambda: vq_cuda.vq_quantize_fused(x, cb)),
            "plain": time_ms(lambda: vq_cuda.vq_quantize_plain(x, cb), 10, 2),
            "library": time_ms(lambda: vq_composition(x.float(), cb), 20, 2)}
    # A bf16 row is exact in TF32, so the function needs two TF32 products
    # (x by the codebook's two parts); the route's three beside it.
    vq_bytes = 2 * 2 * m * d + 4 * (2 * kk * d + kk)
    vq_b = bound(2 * 2 * m * kk * d, vq_bytes, 3 * TF32X3_FLOPS)
    vq_b3 = bound(2 * m * kk * d, vq_bytes, TF32X3_FLOPS)
    print(f"phase bf16 times vq (M={m}, K={kk}, D={d}) [{smi}]: kernel {vq_t['kernel']:.4f} ms "
          f"eager, {vq_t['graph']:.4f} ms in a CUDA graph, plain {vq_t['plain']:.4f} ms, "
          f"composition on x.float() (addmm, argmax, index_select, bincount, index_add_) "
          f"{vq_t['library']:.4f} ms, bound with two TF32 products {vq_b[0]:.4f} ms ({vq_b[1]}), "
          f"with the route's three {vq_b3[0]:.4f} ms ({vq_b3[1]})", flush=True)
    del x, cb, qb, qf
    # Phase Q2: a bf16 Trainer epoch at batch 128 on each route; the fused
    # one (PGT_FUSED_VQ=1, read when the quantizer is built) launches the
    # bf16 entry once a step and once for the eval batch.
    batches = [(np.random.default_rng(1 + i).random((VQ_BATCH, vh, vw, vc)).astype(np.float32),
                None) for i in range(BF16_TRAIN_STEPS)]
    vq_launches = 0
    vae_ms = {}
    for route, env in (("fused", "1"), ("unfused", "0")):
        os.environ["PGT_FUSED_VQ"] = env
        net = VectorQuantizedVAE(**vcfg, generator=torch.Generator().manual_seed(SEED),
                                 device=dev)
        ema0 = net.quantizer.vq.ema_cluster_size.clone()
        want = {vq_cuda.BF16_KERNEL: BF16_TRAIN_STEPS + 1} if route == "fused" else {}
        t, counts = epoch(f"VQ-VAE {route}", net, vq_vae.reproduce_loss, 2e-4,
                          (batches, batches[:1]), want, (vq_cuda,))
        vq_launches += counts[vq_cuda.BF16_KERNEL]
        check(net.quantizer.vq.ema_cluster_size.dtype == torch.float32
              and not torch.equal(net.quantizer.vq.ema_cluster_size, ema0),
              f"the f32 EMA buffers did not move ({route})")
        vae_ms[route] = time_ms(lambda: t.train_one_step(batches[0][0], None),
                                BF16_TIMED_STEPS, 1)
        print(f"phase bf16 step VQ-VAE {route} batch {VQ_BATCH} [{smi}]: {vae_ms[route]:.2f} ms "
              f"a step, {VQ_BATCH * 1000 / vae_ms[route]:.1f} samples/s", flush=True)
        if route == "fused":
            profile_steps(lambda: t.train_one_step(batches[0][0], None), 2, vae_ms[route],
                          f"bf16 train step batch {VQ_BATCH}", (VQ_BATCH, "samples"),
                          "profile bf16 step VQ-VAE fused", smi,
                          ("vq_", "xmma", "cudnn", "elementwise", "reduce_kernel"), host=True)
        del t, net
        bf16_against_cpu(f"VQ-VAE {route}", lambda where: VectorQuantizedVAE(
            **vcfg, generator=torch.Generator().manual_seed(SEED + 8), device=where),
            vq_vae.reproduce_loss, 2e-4,
            [np.random.default_rng(20 + i).random((2, vh, vw, vc)).astype(np.float32)
             for i in range(3)], dev, buffers=("quantizer.vq.ema_cluster_size",
                                          "quantizer.vq.ema_embedding_avg",
                                          "quantizer.vq.ema_embedding"))
    del os.environ["PGT_FUSED_VQ"]
    kernels.append({"name": vq_cuda.BF16_KERNEL, "route": "cuda", "source": src + "vq.cu",
                    "replaces": "pytorch_generative_tpu/ops/vq_pallas.py:27",
                    "launches": vq_launches, "max_abs_err": vq_err, "ms": vq_t["kernel"],
                    "plain_ms": vq_t["plain"], "bound_ms": vq_b[0], "bound_by": vq_b[1],
                    "library_ms": vq_t["library"], "graph_ms": vq_t["graph"],
                    "bound_3xtf32_ms": vq_b3[0]})

    # ---- P3: ImageGPT with the fused attention block. ----
    os.environ["PGT_FUSED_ATTN"] = "1"
    l = 28 * 28
    large = image_gpt.LARGE_CONFIG
    block_t, block_err, block_b = {}, 0.0, {}
    # Phase B1: the bf16 block against its plain version at its three widths
    # (B 64, L 784; and L 200 with mask_center), and two calls' bits. The
    # forward's C entry runs the projection entry, the backward's
    # recompute, on its own scratch: two recomputes give equal bits, and
    # the forward's attention agrees with the plain attention on the
    # recompute's q and kv at the flash kernels' lse gate, a thousand
    # times tighter than the block's against project_plain's q and kv.
    # The block's and the MLP's bf16 outputs at fixed inputs, bit for bit
    # the digests recorded before the tile-store epilogue.
    digests_ok = {case: sha256_of(*bf16_digest_outputs(case, dev)) == want
                  for case, want in BF16_DIGESTS.items()}
    print("phase bf16 block digests (bits of the block's y, attn, lse, q, kv and the MLP's "
          "outputs against those recorded before the tile-store epilogue): " + ", ".join(
              f"{k_} {'equal' if v_ else 'DIFFER'}" for k_, v_ in digests_ok.items()), flush=True)
    check(all(digests_ok.values()), "the bf16 block's or MLP's outputs changed their bits")
    for c, n_heads in BLOCK_WIDTHS:
        for b_, ll, mc in ((BATCH, l, False), (4, 200, True)):
            ops = [t_.to(bf) for t_ in block_operands(b_, ll, c, gen, dev)]
            y, attn, lse = attn_block_cuda.attention_block_forward(*ops, mc, n_heads)
            again = attn_block_cuda.attention_block_forward(*ops, mc, n_heads)
            pq, pkv = attn_block_cuda.project(*ops[:5])
            pq2, pkv2 = attn_block_cuda.project(*ops[:5])
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip((y, attn, lse), again))
            proj_bits = torch.equal(pq, pq2) and torch.equal(pkv, pkv2)
            ry, ra, rl = attn_block_cuda.attention_block_plain(*ops, mc, n_heads)
            fin = torch.isfinite(rl)
            e = {"y": rel_err(y.float(), ry.float()), "attn": rel_err(attn.float(), ra.float()),
                 "lse": rel_err(lse[fin], rl[fin])}
            for name, got, ref in zip(("q", "kv"), (pq, pkv),
                                      attn_block_cuda.project_plain(*ops[:5])):
                e[name] = rel_err(got.float(), ref.float())
            ea = ops[1].shape[-1]
            sa, sl = attention_cuda._flash_forward_bf16_plain(
                pq, pkv[..., :ea], pkv[..., ea:], mc, n_heads, q2=False)
            e_on = {"attn": rel_err(attn.float(), sa.float()), "lse": rel_err(lse[fin], sl[fin])}
            print(f"phase bf16 block C={c} H={n_heads} (B={b_}, L={ll}, mask_center={mc}): "
                  "max_abs_err (max |plain|) " + ", ".join(
                      f"{k_} {v_[0]:.3e} ({v_[1]:.3e})" for k_, v_ in e.items())
                  + f" (tol {BF16_TOL:.4g} x max |plain|, lse {BF16_BLOCK_LSE_RTOL}); against "
                  "the plain attention on the recompute's q and kv: " + ", ".join(
                      f"{k_} {v_[0]:.3e} ({v_[1]:.3e})" for k_, v_ in e_on.items())
                  + f" (lse {BF16_LSE_RTOL}); two recomputes give equal bits: {proj_bits}; two "
                  f"calls give equal bits: {same}", flush=True)
            check(proj_bits, "the bf16 block's recompute gave other bits in a second call")
            check(same, "the bf16 block gave other bits in a second call")
            check(all(v_[0] <= (BF16_BLOCK_LSE_RTOL if k_ == "lse" else BF16_TOL)
                      * max(1.0, v_[1]) for k_, v_ in e.items()),
                  f"the bf16 block disagrees with its plain version (C = {c}, {n_heads} heads)")
            check(e_on["attn"][0] <= BF16_TOL * max(1.0, e_on["attn"][1])
                  and e_on["lse"][0] <= BF16_LSE_RTOL * max(1.0, e_on["lse"][1]),
                  "the bf16 block's attention disagrees with the plain attention on its "
                  f"recompute's q and kv (C = {c}, {n_heads} heads)")
            if mc:
                check(bool((attn[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all()),
                      "the bf16 block's row 0 under mask_center is not 0 with lse -inf")
            block_err = max(block_err, e["y"][0], e["attn"][0])
            if ll == l:
                block_t[(c, n_heads)] = {
                    "plain": time_ms(lambda: attn_block_cuda.attention_block_plain(
                        *ops, mc, n_heads), 3, 1),
                    "kernel": time_ms(lambda: attn_block_cuda.attention_block_forward(
                        *ops, mc, n_heads), 10, 2),
                    "library": time_ms(lambda: block_composition(*ops, n_heads), 10, 2),
                    "project": time_ms(lambda: attn_block_cuda.project(*ops[:5]), 10, 2)}
                # 3 launches a forward (q and [k | v] in one), 1 a recompute.
                n_fwd = graph_kernels(lambda: attn_block_cuda.attention_block_forward(
                    *ops, mc, n_heads))
                n_proj = graph_kernels(lambda: attn_block_cuda.project(*ops[:5]))
                print(f"phase bf16 block launches C={c} H={n_heads}: {n_fwd} kernels a forward, "
                      f"{n_proj} a recompute (kernel nodes of a captured call)", flush=True)
                check((n_fwd, n_proj) == (3, 1),
                      f"the bf16 block ran {n_fwd} launches a forward and {n_proj} a "
                      "recompute, not 3 and 1")
                flops, nbytes = block_work(b_, ll, c, c, c, n_heads, mc)
                # bf16 operands: half of block_work's f32 bytes, lse still f32
                block_b[(c, n_heads)] = bound(flops, nbytes // 2 + 2 * b_ * ll * n_heads,
                                              BF16_FLOPS)
                bt, bb_ = block_t[(c, n_heads)], block_b[(c, n_heads)]
                print(f"phase bf16 times block C={c} H={n_heads} (B={b_}, L={ll}) [{smi}]: "
                      f"kernel {bt['kernel']:.4f} ms, plain {bt['plain']:.4f} ms, bf16 addmm -> "
                      f"causal SDPA -> addmm {bt['library']:.4f} ms, projection entry "
                      f"{bt['project']:.4f} ms, bf16 bound {bb_[0]:.4f} ms ({bb_[1]}; "
                      f"{flops / 1e9:.1f} GFLOP, {flops / bt['kernel'] / 1e9:.1f} TFLOP/s)",
                      flush=True)
            del ops, y, attn, lse, again, pq, pkv, pq2, pkv2, ry, ra, rl, sa, sl
    # Phase B2: a bf16 Trainer epoch at batch 64 at each width with the
    # gate on: one bf16 block launch a block and step (and eval), one
    # projection recompute and one bf16 flash backward a block and step, no
    # flash forward.
    block_launches = {attn_block_cuda.BF16_KERNEL: 0, attn_block_cuda.BF16_PROJECT_KERNEL: 0}
    loaders = datasets.get_synthetic_mnist_loaders(
        BATCH, n_train=BF16_TRAIN_STEPS * BATCH, n_test=BATCH, image_size=28, seed=0)
    mods = (attention_cuda, attn_block_cuda, ln_cuda, mlp_cuda)
    step_ms = {}
    for label, cfg in (("C=64 H=2", image_gpt.REPRODUCE_CONFIG), ("C=512 H=8", large),
                       ("C=512 H=4", dict(large, n_attention_heads=4))):
        nblk = cfg["n_transformer_blocks"]
        net = ImageGPT(**cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
        want = {attn_block_cuda.BF16_KERNEL: (BF16_TRAIN_STEPS + 1) * nblk,
                attn_block_cuda.BF16_PROJECT_KERNEL: BF16_TRAIN_STEPS * nblk,
                attention_cuda.BF16_BWD_KERNEL: BF16_TRAIN_STEPS * nblk}
        # C % 128 == 0: the blocks' fused LayerNorm and MLP (bf16) too.
        others = ((ln_cuda.BF16_KERNEL, ln_cuda.BF16_BWD_KERNEL, mlp_cuda.BF16_KERNEL,
                   mlp_cuda.BF16_BWD_KERNEL) if cfg["n_embedding_channels"] % 128 == 0 else ())
        t, counts = epoch(f"gated {label}", net, image_gpt.reproduce_loss, 5e-3, loaders, want,
                          mods, others)
        for k_ in block_launches:
            block_launches[k_] += counts[k_]
        xb = next(iter(loaders[0]))[0]
        step_ms[label] = time_ms(lambda: t.train_one_step(xb, None), BF16_TIMED_STEPS, 1)
        print(f"phase bf16 step gated {label} batch {BATCH} [{smi}]: {step_ms[label]:.2f} ms a "
              f"step, {BATCH * 1000 / step_ms[label]:.1f} samples/s", flush=True)
        profile_steps(lambda: t.train_one_step(xb, None), 2, step_ms[label],
                      f"bf16 gated train step batch {BATCH}", (BATCH, "samples"),
                      f"profile bf16 gated step {label}", smi,
                      ("flash_fwd_wgmma", "flash_bwd", "wgemm::", "wgemm::tile_kernel", "ln_",
                       "elementwise"), host=True)
        del t, net
    # Phase B3: 3 Adam steps of the gated bf16 Trainer against the CPU's.
    for label, cfg, batch in (("gated C=64 H=2", image_gpt.REPRODUCE_CONFIG, TRAJ_BATCH),
                              ("gated C=512 H=8", large, 2)):
        bf16_against_cpu(label, lambda where, cfg=cfg: ImageGPT(
            **cfg, generator=torch.Generator().manual_seed(SEED + 9), device=where),
            image_gpt.reproduce_loss, 5e-3,
            [(torch.rand((batch, 28, 28, 1), generator=gen) < 0.13).float().numpy()
             for _ in range(3)], dev, key_bias=("attn.kv_proj.bias", cfg["n_embedding_channels"]))
    del os.environ["PGT_FUSED_ATTN"]
    bt, bb_ = block_t[(512, 8)], block_b[(512, 8)]
    kernels.append({"name": attn_block_cuda.BF16_KERNEL, "route": "cuda",
                    "source": src + "attn_block_fwd.cu",
                    "replaces": "pytorch_generative_tpu/ops/attn_block_pallas.py:57",
                    "launches": block_launches[attn_block_cuda.BF16_KERNEL],
                    "max_abs_err": block_err, "ms": bt["kernel"], "plain_ms": bt["plain"],
                    "bound_ms": bb_[0], "bound_by": bb_[1], "library_ms": bt["library"],
                    "instances": [f"C{c}x{h_}" for c, h_ in block_t],
                    "ms_by_width": {f"C{c}x{h_}": v_["kernel"] for (c, h_), v_ in block_t.items()},
                    "recompute_launches": block_launches[attn_block_cuda.BF16_PROJECT_KERNEL],
                    "recompute_ms": bt["project"]})
    return {"counts": counts_all, "kernels": kernels,
            "step_ms": {"PixelSNAIL": snail_ms, **{f"VQ-VAE {k_}": v_ for k_, v_ in vae_ms.items()},
                        **{f"gated {k_}": v_ for k_, v_ in step_ms.items()}}}


def main():
    # Phase 1: device.
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from pytorch_generative_tpu_torch import datasets, optim, trainer
    from pytorch_generative_tpu_torch.models import ImageGPT
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
    from pytorch_generative_tpu_torch.ops import (
        _build,
        attention_cuda,
        attn_block_cuda,
        decode_cuda,
        ln_cuda,
        mlp_cuda,
        sampling,
        snail_decode_cuda,
        vq_cuda,
    )

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # Phase 2: build every kernel of the paths from the checkout's sources,
    # one nvcc per source, all started together.
    names = (attention_cuda.KERNEL, attention_cuda.BWD_KERNEL, decode_cuda.KERNEL,
             decode_cuda.DECODE_STEP_KERNEL, ln_cuda.KERNEL, ln_cuda.BWD_KERNEL,
             mlp_cuda.KERNEL, mlp_cuda.BWD_KERNEL, snail_decode_cuda.KERNEL, vq_cuda.KERNEL,
             attn_block_cuda.KERNEL)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(_build.build, names)))
    for name in names:
        _build.load(name)
        log = paths[name].with_suffix('.log').read_text()
        serialized = [ln.strip() for ln in log.splitlines() if "C7514" in ln]
        print(f"phase build: {name}; ptxas: {ptxas_summary(log)}; wgmma serialised (C7514): "
              f"{' | '.join(serialized) or 'none'}", flush=True)
    print(f"phase build: all kernels {time.perf_counter() - t0:.1f}s", flush=True)

    gen = torch.Generator().manual_seed(SEED)
    cfg = image_gpt.REPRODUCE_CONFIG
    h, w, _ = cfg["in_shape"]
    n_heads = cfg["n_attention_heads"]
    c = cfg["n_embedding_channels"]
    n_blocks = cfg["n_transformer_blocks"]
    d = c // n_heads

    # Phase 3: the flash kernels against their plain versions at the path's
    # shapes: q and k/v as the layer passes them (k, v feature slices of one
    # kv tensor), the backward from the forward's own out and lse.
    flash_err = bwd_err = 0.0
    for l, mask_center in ((h * w, False), (h * w, True), (200, True)):
        q = torch.randn((BATCH, l, c), generator=gen).to(dev)
        kv = torch.randn((BATCH, l, 2 * c), generator=gen).to(dev)
        dout = torch.randn((BATCH, l, c), generator=gen).to(dev)
        k, v = kv[..., :c], kv[..., c:]
        out, lse = attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
        ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, mask_center, n_heads)
        grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, n_heads)
        ref_grads = attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, mask_center,
                                                        n_heads)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        e_grads = [max_err(g, r) for g, r in zip(grads, ref_grads)]
        flash_err = max(flash_err, e_out)
        bwd_err = max(bwd_err, *e_grads)
        print(f"phase flash: L={l} mask_center={mask_center} max_abs_err out={e_out:.3e} "
              f"lse={e_lse:.3e} (tol {FLASH_TOL}); backward dq={e_grads[0]:.3e} "
              f"dk={e_grads[1]:.3e} dv={e_grads[2]:.3e} (tol {FLASH_BWD_TOL})", flush=True)
        check(e_out <= FLASH_TOL and e_lse <= FLASH_TOL, "flash forward kernel disagrees")
        check(max(e_grads) <= FLASH_BWD_TOL, "flash backward kernel disagrees")
        if mask_center:
            check(bool((out[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all()),
                  "row 0 under mask_center is not exactly 0 with lse -inf")
            check(bool((grads[0][:, 0] == 0).all()),
                  "row 0 under mask_center has a non-zero dq")
        check_flash_deterministic(q, k, v, dout, mask_center, n_heads, out, lse, grads,
                                  f"d={d} L={l} mask_center={mask_center}")

    # The model of the serving path: reproduce() widths, random seeded
    # weights, a non-zero positional embedding.
    model = ImageGPT(**cfg, generator=gen, device=dev)
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape, generator=gen))
    model.eval()

    # Phase 4: the sampler kernel against its plain version, n = 16 and 64,
    # free and inpainted; two calls give equal bits; its plan on this card.
    def sampler_inputs(cond, u):
        return sampling.sample_loop_inputs(model, cond, u)

    def to_image(canvas):
        return sampling.canvas_to_images(canvas, h, w)

    free = -torch.ones((N_SAMPLES, h, w, 1), device=dev)
    sample_err = 0.0
    for n in SAMPLER_NS:
        inputs = sampler_inputs(-torch.ones((n, h, w, 1), device=dev),
                                torch.rand((h * w, n, 1), generator=gen).to(dev))
        plan = decode_cuda.plan_for(*inputs)
        _, dims = decode_cuda.check_sample_loop(*inputs)
        max_clusters, regs = decode_cuda.occupancy(dims[5], dims[6], plan.samples, plan.cluster,
                                                   plan.smem)
        print(f"phase sampler plan n={n}: cluster {plan.cluster} CTAs, {plan.clusters} clusters, "
              f"{plan.samples} samples a cluster, {plan.groups} groups, weights "
              f"{'resident' if plan.resident else f'streamed ({plan.stage} floats a stage)'}; "
              f"{regs} registers, {plan.smem} bytes of shared memory a CTA, "
              f"cudaOccupancyMaxActiveClusters {max_clusters}", flush=True)
        check(plan.clusters <= max_clusters, "the plan launches more clusters than fit at once")
    for n in SAMPLER_NS[:2]:
        for mode in ("free", "inpaint"):
            cond = -torch.ones((n, h, w, 1), device=dev)
            if mode == "inpaint":
                cond[:, : h // 2] = (torch.rand((n, h // 2, w, 1), generator=gen) < 0.3).float().to(dev)
            u = torch.rand((h * w, n, 1), generator=gen).to(dev)
            plain = to_image(decode_cuda.sample_loop_plain(*sampler_inputs(cond, u)))
            u, n_nudged = nudged_uniforms(model, plain, u, cond)
            plain = to_image(decode_cuda.sample_loop_plain(*sampler_inputs(cond, u)))
            kern = to_image(decode_cuda.fused_sample_loop(*sampler_inputs(cond, u)))
            again = to_image(decode_cuda.fused_sample_loop(*sampler_inputs(cond, u)))
            torch.cuda.synchronize()
            mismatched = int((kern != plain).sum())
            sample_err = max(sample_err, float((kern - plain).abs().max()))
            kept = bool((kern[:, : h // 2] == cond[:, : h // 2]).all()) if mode == "inpaint" else True
            same = torch.equal(kern, again)
            print(f"phase sampler: {mode} n={n} nudged={n_nudged} mismatched_pixels={mismatched} "
                  f"kept_pixels_ok={kept} two_calls_equal_bits={same}", flush=True)
            check(mismatched == 0 and kept, f"sampler kernel disagrees ({mode}, n={n})")
            check(same, f"the sampler kernel gave other bits in a second call ({mode}, n={n})")
    # A streamed plan whose ring stages hold a few rows of a slice, so the
    # products take each slice in chunks (MLP 1 in 3 or more): C = 128, 4
    # heads, 3 blocks on 8x8 images at n = 256, inpainted.
    wide = ImageGPT(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=3,
                    n_attention_heads=4, n_embedding_channels=128,
                    generator=torch.Generator().manual_seed(SEED + 5), device=dev).eval()
    wgen = torch.Generator().manual_seed(SEED + 6)  # leaves gen's draws to later phases
    cond = -torch.ones((256, 8, 8, 1), device=dev)
    cond[:, :4] = (torch.rand((256, 4, 8, 1), generator=wgen) < 0.3).float().to(dev)
    u = torch.rand((64, 256, 1), generator=wgen).to(dev)
    plain = sampling.canvas_to_images(decode_cuda.sample_loop_plain(
        *sampling.sample_loop_inputs(wide, cond, u)), 8, 8)
    u, n_nudged = nudged_uniforms(wide, plain, u, cond)
    wide_inputs = sampling.sample_loop_inputs(wide, cond, u)
    plan = decode_cuda.plan_for(*wide_inputs)
    _, dims = decode_cuda.check_sample_loop(*wide_inputs)
    mlp1_cols = decode_cuda._slices(dims, plan.cluster)[2][1]
    chunks = -(-dims[3] // min(dims[3], max(plan.stage, 1) // mlp1_cols))
    plain = decode_cuda.sample_loop_plain(*wide_inputs)
    kern = decode_cuda.fused_sample_loop(*wide_inputs)
    torch.cuda.synchronize()
    mismatched = int((kern != plain).sum())
    sample_err = max(sample_err, float((kern - plain).abs().max()))
    print(f"phase sampler: streamed C=128 n=256 stage={plan.stage} mlp1_chunks={chunks} "
          f"nudged={n_nudged} mismatched_pixels={mismatched}", flush=True)
    check(not plan.resident and chunks >= 3, "the wide model's plan does not take chunks")
    check(mismatched == 0, "sampler kernel disagrees (streamed in chunks)")

    pairs = (attention_cuda, ln_cuda, mlp_cuda)  # modules with a forward and a backward

    def reset_counts():
        for mod in pairs:
            mod.launches = mod.bwd_launches = 0
            mod.bf16_launches = mod.bf16_bwd_launches = 0
        mlp_cuda.bf16_recompute_launches = mlp_cuda.bf16_pipe_launches = 0
        decode_cuda.launches = decode_cuda.step_launches = 0
        snail_decode_cuda.launches = vq_cuda.launches = 0
        attn_block_cuda.launches = attn_block_cuda.project_launches = 0
        attn_block_cuda.bf16_launches = attn_block_cuda.bf16_project_launches = 0
        vq_cuda.bf16_launches = 0
        mlp_cuda.recompute_launches = mlp_cuda.pipe_launches = 0

    def read_counts():
        counts = {decode_cuda.KERNEL: decode_cuda.launches,
                  decode_cuda.DECODE_STEP_KERNEL: decode_cuda.step_launches,
                  snail_decode_cuda.KERNEL: snail_decode_cuda.launches,
                  vq_cuda.KERNEL: vq_cuda.launches,
                  attn_block_cuda.KERNEL: attn_block_cuda.launches,
                  attn_block_cuda.PROJECT_KERNEL: attn_block_cuda.project_launches,
                  attn_block_cuda.BF16_KERNEL: attn_block_cuda.bf16_launches,
                  attn_block_cuda.BF16_PROJECT_KERNEL: attn_block_cuda.bf16_project_launches,
                  vq_cuda.BF16_KERNEL: vq_cuda.bf16_launches,
                  mlp_cuda.RECOMPUTE_KERNEL: mlp_cuda.recompute_launches,
                  mlp_cuda.PIPE_KERNEL: mlp_cuda.pipe_launches}
        for mod in pairs:
            counts[mod.KERNEL], counts[mod.BWD_KERNEL] = mod.launches, mod.bwd_launches
            counts[mod.BF16_KERNEL] = mod.bf16_launches
            counts[mod.BF16_BWD_KERNEL] = mod.bf16_bwd_launches
        counts[mlp_cuda.BF16_RECOMPUTE_KERNEL] = mlp_cuda.bf16_recompute_launches
        counts[mlp_cuda.BF16_PIPE_KERNEL] = mlp_cuda.bf16_pipe_launches
        return counts

    # At C = 64 the fused LayerNorm and MLP kernels stay off, as on the TPU.
    small_path = (attention_cuda.KERNEL, attention_cuda.BWD_KERNEL, decode_cuda.KERNEL)
    fused = (ln_cuda.KERNEL, ln_cuda.BWD_KERNEL, mlp_cuda.KERNEL, mlp_cuda.BWD_KERNEL)

    # Phase 5: the serving path through the entry points a user calls.
    x = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.3).float().to(dev)
    sample_gen = torch.Generator().manual_seed(SEED + 1)
    reset_counts()
    with torch.no_grad():
        logits = model(x)
        loss = image_gpt.reproduce_loss(x, None, logits)
        samples = model.sample(n_samples=N_SAMPLES, generator=sample_gen)
    torch.cuda.synchronize()
    serve_counts = read_counts()
    nll = float(loss)
    binary = bool(((samples == 0) | (samples == 1)).all())
    print(f"phase serve: forward logits {tuple(logits.shape)} nll={nll:.4f} nats/image; "
          f"samples {tuple(samples.shape)} binary={binary} mean={float(samples.mean()):.4f}; "
          f"launches={serve_counts}", flush=True)
    check(logits.shape == (BATCH, h, w, 1) and bool(torch.isfinite(logits).all()), "bad logits")
    check(torch.isfinite(loss).item(), "non-finite NLL")
    check(samples.shape == (N_SAMPLES, h, w, 1) and binary, "samples are not binary (16, 28, 28, 1)")
    check(serve_counts[attention_cuda.KERNEL] > 0 and serve_counts[decode_cuda.KERNEL] > 0,
          f"a kernel of the serving path never launched: {serve_counts}")
    check(all(serve_counts[k] == 0 for k in fused), "a fused kernel launched at C = 64")
    check(serve_counts[decode_cuda.DECODE_STEP_KERNEL] == 0
          and sampling.sample_route(model, N_SAMPLES) == sampling.LOOP_ROUTE,
          "n = 16 at C = 64 did not take the whole-loop route")
    # The kernel path agrees with the same model's plain path on the CPU.
    cpu_model = ImageGPT(**cfg, device="cpu")
    cpu_model.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    with torch.no_grad():
        ref = cpu_model(x[:2].cpu())
    fwd_err = float((logits[:2].cpu() - ref).abs().max())
    print(f"phase serve: forward vs plain CPU forward max_abs_err={fwd_err:.3e} (tol {FORWARD_TOL})",
          flush=True)
    check(fwd_err <= FORWARD_TOL, "forward disagrees with the plain CPU forward")
    check(sampling._whole_loop_eligible(model), "reproduce model not covered by the sampler")

    # Phase 6: the training path through the entry points a user calls:
    # reproduce()'s model, optimizer and loss on seeded synthetic MNIST.
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def new_trainer(seed):
            train_loader, test_loader = datasets.get_synthetic_mnist_loaders(
                BATCH, n_train=8 * BATCH, n_test=2 * BATCH, image_size=h, seed=0)
            net = ImageGPT(**cfg, generator=torch.Generator().manual_seed(seed), device=dev)
            return trainer.Trainer(
                net, image_gpt.reproduce_loss, optim.adam_multiplicative(5e-3, 0.999977),
                train_loader, test_loader, log_dir=log_dir, sample_epochs=1,
                use_tensorboard=False, device=dev)

        first = new_trainer(SEED)
        reset_counts()
        first.interleaved_train_and_eval(1)
        # A fresh model from another seed: only the checkpoint makes it resume.
        second = new_trainer(SEED + 7)
        second.interleaved_train_and_eval(2)
        torch.cuda.synchronize()
        train_counts = read_counts()
        losses, counts = read_losses(log_dir)
        files = sorted(os.listdir(log_dir))
        print(f"phase train: steps {first._step} + {second._step - first._step}, "
              f"losses {[round(losses[s], 3) for s in sorted(losses)]}; files {files}; "
              f"launches={train_counts}", flush=True)
        check(train_counts[attention_cuda.BWD_KERNEL] >= 2 * 8 * n_blocks,
              f"flash_bwd launched {train_counts[attention_cuda.BWD_KERNEL]} < 2 x 8 x "
              f"{n_blocks} times")
        check(all(train_counts[k] > 0 for k in small_path),
              f"a kernel never launched: {train_counts}")
        check(all(train_counts[k] == 0 for k in fused), "a fused kernel launched at C = 64")
        check(sorted(losses) == list(range(16)) and set(counts.values()) == {1},
              "the resumed Trainer did not start at step 8")
        check(all(math.isfinite(v) for v in losses.values()), "non-finite loss")
        check(second._step == 16 and second._epoch == 2, "second epoch not taken")
        for name in ("trainer_state_1.ckpt", "trainer_state_2.ckpt", "sample_8.npy",
                     "sample_16.npy"):
            check(name in files, f"{name} was not written")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    # Phase 7: gradients at full width, batch 2, the card's kernel path vs
    # the CPU plain path of the same weights, per parameter group.
    grads_vs_cpu(model, cpu_model, x[:2], "")

    # Phase 8: 3 Adam steps on the card and on the CPU, same weights and
    # batches; the losses agree.
    trajectory(model, cpu_model, dev,
               [(torch.rand((TRAJ_BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
                for _ in range(3)], "")

    # Phase 9: times, CUDA events around warmed-up runs, at the paths' shapes.
    l = h * w
    q = torch.randn((BATCH, l, c), generator=gen).to(dev)
    kv = torch.randn((BATCH, l, 2 * c), generator=gen).to(dev)
    dout = torch.randn((BATCH, l, c), generator=gen).to(dev)
    times = flash_times(q, kv[..., :c], kv[..., c:], dout, n_heads)
    inputs = sampler_inputs(free, torch.rand((h * w, N_SAMPLES, 1), generator=gen).to(dev))
    times["sample"] = time_ms(lambda: decode_cuda.fused_sample_loop(*inputs), 3, 1)
    times["sample_plain"] = time_ms(lambda: decode_cuda.sample_loop_plain(*inputs), 1, 1)
    sample_ms = {N_SAMPLES: times["sample"]}
    for n in SAMPLER_NS[1:]:
        n_inputs = sampler_inputs(-torch.ones((n, h, w, 1), device=dev),
                                  torch.rand((h * w, n, 1), generator=gen).to(dev))
        sample_ms[n] = time_ms(lambda: decode_cuda.fused_sample_loop(*n_inputs), 3, 1)

    fwd_bound, fwd_bound_f32, _ = flash_bounds(BATCH, l, n_heads, d, d, False)
    bwd_bound, bwd_bound_f32, _ = flash_bounds(BATCH, l, n_heads, d, d, False, backward=True)
    weight_bytes = 4 * sum(t.numel() for t in inputs[3].values())
    sample_bound = bound(sampler_flops(N_SAMPLES, h, w, n_blocks, c),
                         weight_bytes + 4 * (2 * inputs[0].numel() + inputs[2].numel()))
    print(f"phase times [{smi}]: flash_fwd (B={BATCH}, L={l}, H={n_heads}, d={d}) "
          f"kernel {times['fwd']:.4f}/{times['fwd2']:.4f} ms, plain {times['fwd_plain']:.4f} ms, "
          f"causal SDPA {times['fwd_lib']:.4f} ms, "
          f"{flash_bounds_text(BATCH, l, n_heads, d, d, False)}; "
          f"flash_bwd kernel {times['bwd']:.4f}/{times['bwd2']:.4f} ms, "
          f"plain {times['bwd_plain']:.4f} ms, SDPA autograd.grad {times['bwd_lib']:.4f} ms, "
          f"{flash_bounds_text(BATCH, l, n_heads, d, d, False, backward=True)}; "
          "sample_loop kernel " + ", ".join(
              f"n={n} {ms:.2f} ms ({n * 1000 / ms:.2f} img/s)" for n, ms in sample_ms.items())
          + f"; n={N_SAMPLES}: plain {times['sample_plain']:.2f} ms "
          f"({N_SAMPLES * 1000 / times['sample_plain']:.2f} img/s), bound "
          f"{sample_bound[0]:.4f} ms ({sample_bound[1]}), latency floor estimate "
          f"{sampler_latency_floor_ms(h, w, n_blocks):.1f} ms", flush=True)

    # Phase 10: the train step at batch 64 (Trainer.train_one_step, H2D copy
    # of the batch included), then a profile of 3 steps by kernel.
    step_trainer = trainer.Trainer(
        ImageGPT(**cfg, generator=torch.Generator().manual_seed(SEED), device=dev),
        image_gpt.reproduce_loss, optim.adam_multiplicative(5e-3, 0.999977), [], [],
        log_dir=tempfile.mkdtemp(prefix="chip_smoke_step_"), use_tensorboard=False, device=dev)
    xb = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
    step_ms = time_ms(lambda: step_trainer.train_one_step(xb, None), 10, 3)
    profile_steps(lambda: step_trainer.train_one_step(xb, None), 3, step_ms,
                  f"train step batch {BATCH}", (BATCH, "samples"), "step", smi,
                  ("flash_bwd", "flash_fwd"))
    shutil.rmtree(step_trainer.log_dir, ignore_errors=True)

    # ---- ImageGPT at LARGE_CONFIG (C = 512, 8 heads of 64): every block
    # takes the fused LayerNorm and MLP kernels. ----
    big_cfg = image_gpt.LARGE_CONFIG
    cb = big_cfg["n_embedding_channels"]
    hb = big_cfg["n_attention_heads"]
    fb = 4 * cb
    nb = big_cfg["n_transformer_blocks"]
    rows_big = BATCH * h * w

    # Phase 11: the LayerNorm and MLP kernels against their plain versions
    # at the path's shapes (R = 64 x 784 rows) and a ragged R; the MLP
    # backward from the forward's own saved y.
    ln_err, ln_bwd_err, mlp_err, mlp_bwd_err = fused_checks(
        (rows_big, rows_big - 7), cb, gen, dev)

    # Phase 12: the flash kernels at d = 64, the path's (B 64, L 784, H 8).
    db = cb // hb
    for l, mask_center in ((h * w, False), (200, True)):
        q = torch.randn((BATCH, l, cb), generator=gen).to(dev)
        kv = torch.randn((BATCH, l, 2 * cb), generator=gen).to(dev)
        dout = torch.randn((BATCH, l, cb), generator=gen).to(dev)
        k, v = kv[..., :cb], kv[..., cb:]
        out, lse = attention_cuda.flash_forward(q, k, v, mask_center, hb)
        ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, mask_center, hb)
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        del ref_out, ref_lse
        grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, hb)
        e_grads = [max_err(g, r) for g, r in zip(grads, attention_cuda.flash_backward_plain(
            q, k, v, out, lse, dout, mask_center, hb))]
        torch.cuda.synchronize()
        flash_err = max(flash_err, e_out)
        bwd_err = max(bwd_err, *e_grads)
        print(f"phase flash d={db}: L={l} H={hb} mask_center={mask_center} max_abs_err "
              f"out={e_out:.3e} lse={e_lse:.3e} (tol {FLASH_TOL}); backward dq={e_grads[0]:.3e} "
              f"dk={e_grads[1]:.3e} dv={e_grads[2]:.3e} (tol {FLASH_BWD_TOL})", flush=True)
        check(e_out <= FLASH_TOL and e_lse <= FLASH_TOL, "flash forward kernel disagrees at d = 64")
        check(max(e_grads) <= FLASH_BWD_TOL, "flash backward kernel disagrees at d = 64")
        check_flash_deterministic(q, k, v, dout, mask_center, hb, out, lse, grads,
                                  f"d={db} L={l} mask_center={mask_center}")
        del q, kv, dout, k, v, out, lse, grads

    # Phase 13: serving at C = 512: forward at batch 64 with the reproduce
    # loss through the entry point; per forward 9 LayerNorms (8 ln1 and the
    # final one), 8 fused MLPs and 8 flash forwards. Then the same weights
    # on the CPU's plain path at batch 2.
    big = ImageGPT(**big_cfg, generator=gen, device=dev)
    with torch.no_grad():
        big.pos.copy_(0.1 * torch.randn(big.pos.shape, generator=gen))
    big.eval()
    reset_counts()
    with torch.no_grad():
        logits = big(x)
        loss = image_gpt.reproduce_loss(x, None, logits)
    torch.cuda.synchronize()
    big_serve_counts = read_counts()
    print(f"phase serve C={cb}: forward logits {tuple(logits.shape)} nll={float(loss):.4f} "
          f"nats/image; launches={big_serve_counts}", flush=True)
    check(logits.shape == (BATCH, h, w, 1) and bool(torch.isfinite(logits).all()),
          "bad logits at C = 512")
    want_counts = {k: 0 for k in big_serve_counts}
    want_counts.update({ln_cuda.KERNEL: nb + 1, mlp_cuda.KERNEL: nb, attention_cuda.KERNEL: nb})
    check(big_serve_counts == want_counts, f"C = 512 forward launches {big_serve_counts}, "
          f"expected {want_counts}")
    cpu_big = ImageGPT(**big_cfg, device="cpu")
    cpu_big.load_state_dict({k: t.cpu() for k, t in big.state_dict().items()})
    with torch.no_grad():
        ref = cpu_big(x[:2].cpu())
    fwd_err_big = float((logits[:2].cpu() - ref).abs().max())
    fwd_scale = max(1.0, float(ref.abs().max()))
    print(f"phase serve C={cb}: forward vs plain CPU forward (batch 2) max_abs_err="
          f"{fwd_err_big:.3e} (tol {FORWARD_TOL} x max(1, max |logit|) = "
          f"{FORWARD_TOL * fwd_scale:.3e})", flush=True)
    check(fwd_err_big <= FORWARD_TOL * fwd_scale, "C = 512 forward disagrees with the CPU")
    del logits, loss

    # Phase 14: training at C = 512 through the Trainer: reproduce()'s
    # optimizer and loss on seeded synthetic MNIST at batch 64; per step
    # 9 LayerNorm, 8 MLP and 8 flash forwards and backwards.
    train_loader, _ = datasets.get_synthetic_mnist_loaders(
        BATCH, n_train=TRAIN_STEPS_LARGE * BATCH, n_test=BATCH, image_size=h, seed=0)
    big_trainer = trainer.Trainer(
        ImageGPT(**big_cfg, generator=torch.Generator().manual_seed(SEED), device=dev),
        image_gpt.reproduce_loss, optim.adam_multiplicative(5e-3, 0.999977), [], [],
        log_dir=tempfile.mkdtemp(prefix="chip_smoke_big_"), use_tensorboard=False, device=dev)
    reset_counts()
    big_losses = [float(big_trainer.train_one_step(xb, yb)[0]["loss"])
                  for xb, yb in train_loader]
    torch.cuda.synchronize()
    big_train_counts = read_counts()
    print(f"phase train C={cb}: {len(big_losses)} steps at batch {BATCH}, losses "
          f"{[round(v, 3) for v in big_losses]}; launches={big_train_counts}", flush=True)
    n = TRAIN_STEPS_LARGE
    want_counts = {k: 0 for k in big_train_counts}
    want_counts.update({ln_cuda.KERNEL: (nb + 1) * n, ln_cuda.BWD_KERNEL: (nb + 1) * n,
                        mlp_cuda.KERNEL: nb * n, mlp_cuda.BWD_KERNEL: nb * n,
                        attention_cuda.KERNEL: nb * n, attention_cuda.BWD_KERNEL: nb * n})
    check(len(big_losses) == n and all(math.isfinite(v) for v in big_losses),
          "C = 512 training gave a non-finite loss")
    check(big_train_counts == want_counts, f"C = 512 train launches {big_train_counts}, "
          f"expected {want_counts}")

    # Phases 15 and 16: gradients and 3 Adam steps at C = 512, batch 2,
    # card against the CPU's plain path.
    grads_vs_cpu(big, cpu_big, x[:2], f" C={cb}")
    trajectory(big, cpu_big, dev,
               [(torch.rand((2, h, w, 1), generator=gen) < 0.13).float().numpy()
                for _ in range(3)], f" C={cb}")
    del big, cpu_big

    # Phase 17: times at C = 512: each fused kernel at the path's shapes
    # beside its plain version, its bound and a library yardstick the port
    # never calls; then the flash kernels at d = 64.
    fused_times, fused_bounds, fused_bounds_f32 = fused_times_at(rows_big, cb, gen, dev, smi)
    q = torch.randn((BATCH, h * w, cb), generator=gen).to(dev)
    kv = torch.randn((BATCH, h * w, 2 * cb), generator=gen).to(dev)
    dout = torch.randn((BATCH, h * w, cb), generator=gen).to(dev)
    flash_times_line(f"C={cb}", smi, q, kv[..., :cb], kv[..., cb:], dout, hb)
    del q, kv, dout

    # Phase 18: the C = 512 train step at batch 64, timed, then profiled.
    xb = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
    big_step = lambda: big_trainer.train_one_step(xb, None)
    big_step_ms = time_ms(big_step, 5, 2)
    profile_steps(big_step, 2, big_step_ms, f"train step batch {BATCH}", (BATCH, "samples"),
                  f"step C={cb}", smi,
                  ("gemm_kernel", "flash_bwd", "flash_fwd", "ln_bwd_rows", "ln_fwd"))
    shutil.rmtree(big_trainer.log_dir, ignore_errors=True)
    del big_trainer

    # ---- The widths the JAX package runs (wide_phases): flash at d = 128,
    # LayerNorm and MLP at C = 640 and 1024, ImageGPT at C = 512 with 4
    # heads. ----
    wide = wide_phases(dev, gen, smi, reset_counts, read_counts)
    flash_err = max(flash_err, wide["flash_err"])
    bwd_err = max(bwd_err, wide["bwd_err"])
    ln_err, ln_bwd_err, mlp_err, mlp_bwd_err = (
        max(a, b) for a, b in zip((ln_err, ln_bwd_err, mlp_err, mlp_bwd_err), wide["fused_errs"]))

    # ---- Sampling on the per-position step route. ----
    # Phase 19: the decode step kernel against its plain version at
    # LARGE_CONFIG, n = 16, f32 and bf16 cache, NaN in the cache's stale
    # positions >= i (reading one would poison the result); then one step
    # at n = 64 (four row groups of the products) at i = 65, past the first
    # key chunk's edge.
    sbig = ImageGPT(**big_cfg, generator=gen, device=dev)
    with torch.no_grad():
        sbig.pos.copy_(0.1 * torch.randn(sbig.pos.shape, generator=gen))
    sbig.eval()
    sweights = decode_cuda.stack_image_gpt_weights(sbig)
    f_kv = 2 * cb
    x_step = torch.randn((N_SAMPLES, cb), generator=gen).to(dev)
    cache_f32 = torch.randn((nb, N_SAMPLES, h * w, f_kv), generator=gen).to(dev)
    cache_dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    step_err, logit_diff = 0.0, {}

    def check_step(i, x, full, dtype, dname):
        """The step at i as an int and as the 0-dim int32 tensor the step
        route's graph reads (equal bits), against the plain version; returns
        the act error and the largest logit difference."""
        n = x.shape[0]
        cache = full.clone()
        cache[:, :, i:] = float("nan")
        cache = cache.to(dtype)
        # Each on its own cache: the step writes its k|v there at i.
        cache_int, cache_dev = cache.clone(), cache.clone()
        act, kv_new = decode_cuda.fused_decode_step(i, x, cache_int, sweights, hb)
        pos = torch.tensor(i, dtype=torch.int32, device=dev)
        act_dev, kv_dev = decode_cuda.fused_decode_step(pos, x, cache_dev, sweights, hb)
        ref_act, ref_kv = decode_cuda.decode_step_plain(i, x, cache, sweights, hb)
        torch.cuda.synchronize()
        same = (torch.equal(act, act_dev) and torch.equal(kv_new, kv_dev)
                and bool(((cache_int == cache_dev)
                          | (cache_int.isnan() & cache_dev.isnan())).all()))
        scale = float(ref_act.abs().max())
        e_act = float((act - ref_act).abs().max())
        e_kv = float((kv_new.float() - ref_kv.float()).abs().max())
        kv_ulps = int(((kv_new.float() - ref_kv.float()).abs() > STEP_RTOL * scale).sum())
        d_logit = float(((act - ref_act) @ sbig.out_conv.weight.detach()).abs().max())
        print(f"phase decode step C={cb} {dname} cache: i={i} n={n} max_abs_err "
              f"act={e_act:.3e} kv_new={e_kv:.3e} (max |act| {scale:.3e}, tol {STEP_RTOL} x "
              f"max |act|; kv_new entries past it {kv_ulps}) logit diff {d_logit:.3e}; "
              f"device position gives equal bits: {same}", flush=True)
        check(same, f"the step at a device position disagrees with the int one "
                    f"({dname}, i={i}, n={n})")
        check(bool(torch.isfinite(act).all()) and bool(torch.isfinite(kv_new.float()).all()),
              f"the step kernel read a stale cache position ({dname}, i={i}, n={n})")
        check(e_act <= STEP_RTOL * scale, f"decode step act disagrees ({dname}, i={i}, n={n})")
        # bf16: an entry may round to the neighbouring bf16 value, one
        # unit in the last place (2^-7 relative at most).
        ulp = 0.0 if dtype == torch.float32 else 2.0 ** -7
        check(bool(((kv_new.float() - ref_kv.float()).abs()
                    <= STEP_RTOL * scale + ulp * ref_kv.float().abs()).all()),
              f"decode step kv_new disagrees ({dname}, i={i}, n={n})")
        return e_act, d_logit

    for dname, dtype in cache_dtypes.items():
        logit_diff[dname] = 0.0
        for i in STEP_POSITIONS:
            e_act, d_logit = check_step(i, x_step, cache_f32, dtype, dname)
            step_err = max(step_err, e_act)
            logit_diff[dname] = max(logit_diff[dname], d_logit)
    x_wide = torch.randn((4 * N_SAMPLES, cb), generator=gen).to(dev)
    cache_wide = torch.randn((nb, 4 * N_SAMPLES, h * w, f_kv), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(SEED))
    for dname, dtype in cache_dtypes.items():
        step_err = max(step_err, check_step(65, x_wide, cache_wide, dtype, dname)[0])
    del cache_wide

    # Phase 20: ImageGPT(**LARGE_CONFIG).sample of 16 images through the
    # entry point, free and inpainted (top half kept), f32 and bf16 cache:
    # 784 step launches, no whole loop; pixel-equal to the plain step route
    # on uniforms moved off its own decision boundary. Nudging leaves the
    # plain route's pixels as they were, so it is not run again.
    check(sampling.sample_route(sbig, N_SAMPLES) == sampling.STEP_ROUTE,
          "LARGE_CONFIG n = 16 does not take the step route")
    big_sample_counts = []
    for dname, dtype in cache_dtypes.items():
        delta = max(NUDGE, 10 * logit_diff[dname])
        for mode in ("free", "inpaint"):
            cond = -torch.ones((N_SAMPLES, h, w, 1), device=dev)
            if mode == "inpaint":
                cond[:, : h // 2] = (torch.rand((N_SAMPLES, h // 2, w, 1), generator=gen)
                                     < 0.3).float().to(dev)
            u = torch.rand((h * w, N_SAMPLES, 1), generator=gen).to(dev)
            plain, p = plain_step_route(sbig, cond, u, dtype)
            u, n_nudged = nudge_around(u, p, cond, delta)
            kw = dict(n_samples=N_SAMPLES) if mode == "free" else dict(conditioned_on=cond)
            reset_counts()
            got = sbig.sample(uniforms=u, cache_dtype=dtype, **kw)
            torch.cuda.synchronize()
            counts = read_counts()
            big_sample_counts.append(counts)
            mismatched = int((got != plain).sum())
            kept = bool((got[:, : h // 2] == cond[:, : h // 2]).all()) if mode == "inpaint" else True
            binary = bool(((got == 0) | (got == 1)).all())
            print(f"phase sample C={cb} {dname} cache: {mode} n={N_SAMPLES} nudge margin "
                  f"{delta:.3e} (10 x the step's logit diff {logit_diff[dname]:.3e}, at least "
                  f"{NUDGE}) nudged={n_nudged} mismatched_pixels={mismatched} "
                  f"kept_pixels_ok={kept} binary={binary} mean={float(got.mean()):.4f}; "
                  f"launches={counts}", flush=True)
            check(got.shape == (N_SAMPLES, h, w, 1) and binary, "bad C = 512 samples")
            check(mismatched == 0 and kept,
                  f"C = 512 step route disagrees with its plain version ({dname}, {mode})")
            want_counts = {k: 0 for k in counts}
            want_counts[decode_cuda.DECODE_STEP_KERNEL] = h * w
            check(counts == want_counts, f"C = 512 sample launches {counts}, expected {want_counts}")

    # Phase 21: routes at C = 64. n = 4 takes the step route (the JAX tile
    # is 4 < 8), and so does a model with a custom sample_fn, which the
    # whole loop does not cover; both pixel-equal to the plain step route.
    custom = ImageGPT(**cfg, generator=gen, device=dev)
    with torch.no_grad():
        custom.pos.copy_(0.1 * torch.randn(custom.pos.shape, generator=gen))
    custom.eval()
    custom.sample_fn = lambda uu, logits: (uu < torch.sigmoid(logits)).float()
    route_counts = []
    for label, net, n in (("n=4", model, 4), ("custom sample_fn n=16", custom, N_SAMPLES)):
        cond = -torch.ones((n, h, w, 1), device=dev)
        u = torch.rand((h * w, n, 1), generator=gen).to(dev)
        plain, p = plain_step_route(net, cond, u, torch.float32)
        u, n_nudged = nudge_around(u, p, cond, NUDGE)
        reset_counts()
        got = net.sample(uniforms=u, n_samples=n)
        torch.cuda.synchronize()
        counts = read_counts()
        route_counts.append(counts)
        mismatched = int((got != plain).sum())
        route = sampling.sample_route(net, n)
        print(f"phase route C={c}: {label} route={route} nudged={n_nudged} "
              f"mismatched_pixels={mismatched}; launches={counts}", flush=True)
        want_counts = {k: 0 for k in counts}
        want_counts[decode_cuda.DECODE_STEP_KERNEL] = h * w
        check(route == sampling.STEP_ROUTE and counts == want_counts,
              f"{label} at C = 64 did not take the step route: {counts}")
        check(mismatched == 0, f"{label} at C = 64 disagrees with the plain step route")

    # Phase 22: times at C = 512, n = 16: the sample call (f32 and bf16
    # cache), the step kernel at i = 391 (an int position, and a device
    # position through one captured step replayed) and its plain version,
    # their bounds; then a profile of one f32 sample call.
    u16_big = torch.rand((h * w, N_SAMPLES, 1), generator=gen).to(dev)
    cache = cache_f32.clone()
    cache[:, :, TIMED_POSITION:] = 0.0
    step_times = {}
    for dname, dtype in cache_dtypes.items():
        cache_d = cache.to(dtype)
        step_times[dname] = time_ms(lambda: decode_cuda.fused_decode_step(
            TIMED_POSITION, x_step, cache_d, sweights, hb), 20, 3)
        step_times[dname + "_plain"] = time_ms(lambda: decode_cuda.decode_step_plain(
            TIMED_POSITION, x_step, cache_d, sweights, hb), 5, 1)
        step_times[dname + "_2"] = time_ms(lambda: decode_cuda.fused_decode_step(
            TIMED_POSITION, x_step, cache_d, sweights, hb), 20, 3)
        pos = torch.tensor(TIMED_POSITION, dtype=torch.int32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            decode_cuda.fused_decode_step(pos, x_step, cache_d, sweights, hb)
        torch.cuda.current_stream(dev).wait_stream(side)
        step_graph = decode_cuda.StepGraph()
        with torch.cuda.stream(side), step_graph.capture():
            decode_cuda.fused_decode_step(pos, x_step, cache_d, sweights, hb)
        torch.cuda.current_stream(dev).wait_stream(side)
        step_times[dname + "_graph"] = time_ms(step_graph.replay, 20, 3)
        del step_graph
    del cache, cache_d
    sample_times = {dname: time_ms(lambda: sbig.sample(
        n_samples=N_SAMPLES, generator=torch.Generator().manual_seed(SEED), cache_dtype=dtype), 2, 1)
        for dname, dtype in cache_dtypes.items()}
    step_bounds = {dname: bound(*step_work(sweights, N_SAMPLES, TIMED_POSITION, dtype.itemsize))
                   for dname, dtype in cache_dtypes.items()}
    call_bounds = {}
    for dname, dtype in cache_dtypes.items():
        works = [step_work(sweights, N_SAMPLES, i, dtype.itemsize) for i in range(h * w)]
        call_bounds[dname] = bound(sum(wk[0] for wk in works), sum(wk[1] for wk in works))
    for dname in cache_dtypes:
        print(f"phase times sample C={cb} {dname} cache [{smi}]: sample n={N_SAMPLES} "
              f"{sample_times[dname]:.2f} ms ({N_SAMPLES * 1000 / sample_times[dname]:.2f} img/s), "
              f"bound {call_bounds[dname][0]:.2f} ms ({call_bounds[dname][1]}); decode_step at "
              f"i={TIMED_POSITION} kernel {step_times[dname]:.4f}/{step_times[dname + '_2']:.4f} ms, "
              f"device position, one captured step replayed "
              f"{step_times[dname + '_graph']:.4f} ms, "
              f"plain {step_times[dname + '_plain']:.4f} ms, bound {step_bounds[dname][0]:.4f} ms "
              f"({step_bounds[dname][1]}), library none", flush=True)
    profile_steps(lambda: sbig.sample(n_samples=N_SAMPLES, generator=torch.Generator().manual_seed(
        SEED)), 1, sample_times["f32"], f"sample call n={N_SAMPLES}", (N_SAMPLES, "images"),
        f"profile sample C={cb} f32 cache", smi,
        ("decode_proj", "decode_attn", "decode_combine", "decode_lnf"), host=True)
    # The host's share of a position: the eager route with the step replaced
    # by a stub that returns one step's outputs (what remains is the
    # PyTorch ops around it: conv taps, head, draw, merge), the host time
    # to issue one step call (no synchronisation inside), and the graph of
    # one position that the route replays: its host time a replay and the
    # time a position to the last replay's end.
    stub = decode_cuda.fused_decode_step(TIMED_POSITION, x_step, cache_f32, sweights, hb)
    ops_ms = time_ms(lambda: sampling._image_gpt_decode_step(
        sbig, free, u16_big, torch.float32, step=lambda *_: stub), 2, 1) / (h * w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        decode_cuda.fused_decode_step(TIMED_POSITION, x_step, cache_f32, sweights, hb)
    issue_ms = (time.perf_counter() - t0) * 1e3 / 8
    torch.cuda.synchronize()
    with torch.no_grad():
        route = sampling.StepRoute(sbig, free, u16_big, torch.float32)
        position_graph = route.capture()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(h * w - 2):
            position_graph.replay()
        replay_host_ms = (time.perf_counter() - t0) * 1e3 / (h * w - 2)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3 / (h * w - 2)
    del route, position_graph
    print(f"phase host sample C={cb} [{smi}]: per position, the PyTorch ops around the step "
          f"{ops_ms:.4f} ms (the step stubbed, eager), issuing one step call {issue_ms:.4f} ms of "
          f"host time ({6 * nb + 1} launches); the route's graph of one position: "
          f"{replay_host_ms:.4f} ms of host time a replay, {replay_ms:.4f} ms a position to the "
          f"last replay's end; the whole call {sample_times['f32'] / (h * w):.4f} ms a position",
          flush=True)
    # The two routes at C = 64, n = 16, where the whole loop serves: the
    # step route on the same model and uniforms, beside the whole loop.
    u16 = torch.rand((h * w, N_SAMPLES, 1), generator=gen).to(dev)
    route_times = {
        "step": time_ms(lambda: sampling._image_gpt_decode_step(model, free, u16, torch.float32), 2, 1),
        "loop": time_ms(lambda: sampling._image_gpt_sample_loop(model, free, u16), 2, 1)}
    print(f"phase times routes C={c} [{smi}]: n={N_SAMPLES} whole loop {route_times['loop']:.2f} ms, "
          f"step route {route_times['step']:.2f} ms", flush=True)

    # ---- PixelSNAIL (pixel_snail_phases). ----
    snail = pixel_snail_phases(dev, gen, smi, reset_counts, read_counts)
    flash_err = max(flash_err, snail["flash_err"])

    # ---- VQ-VAE (vq_vae_phases). ----
    vq = vq_vae_phases(dev, gen, smi, reset_counts, read_counts)

    # ---- ImageGPT with the fused attention block, under the MLP
    # backward's three routes (fused_attn_phases). ----
    gated = fused_attn_phases(dev, gen, smi, reset_counts, read_counts)

    # ---- ImageGPT's mixed-precision training, compute_dtype=torch.bfloat16,
    # at C = 64 and C = 512 (bf16_phases). ----
    bf16 = bf16_phases(dev, gen, smi, reset_counts, read_counts)

    # ---- The last three paths under compute_dtype=torch.bfloat16:
    # PixelSNAIL, VQ-VAE on both routes, ImageGPT with the fused block
    # (bf16_slice_phases). ----
    slice_ = bf16_slice_phases(dev, gen, smi, reset_counts, read_counts)

    all_counts = (serve_counts, train_counts, big_serve_counts, big_train_counts,
                  *big_sample_counts, *route_counts, *snail["counts"], *wide["counts"],
                  *vq["counts"], *gated["counts"], *bf16["counts"], *slice_["counts"])
    # The flash kernels' (d_k, d_v) instances this run held against the
    # plain version; ms, plain_ms and library_ms are reproduce()'s d = 32,
    # bound_ms its 3xTF32 bound and bound_f32_ms the f32 one beside it. The
    # (4, 32) backward (flash_bwd_mma_small.cuh) has an entry of its own,
    # with PixelSNAIL's launches.
    instances = [f"{dk}x{dv}" for dk, dv in ((d, d), (db, db), (wide["d"], wide["d"]), (4, 32))]
    print(json.dumps({"kernels": [
        {"name": attention_cuda.KERNEL, "route": "cuda",
         "source": "pytorch_generative_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "pytorch_generative_tpu/ops/attention_pallas.py:100",
         "launches": sum(cs[attention_cuda.KERNEL] for cs in all_counts),
         "max_abs_err": flash_err, "ms": times["fwd"], "plain_ms": times["fwd_plain"],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": times["fwd_lib"],
         "bound_f32_ms": fwd_bound_f32[0], "instances": instances},
        {"name": attention_cuda.BWD_KERNEL, "route": "cuda",
         "source": "pytorch_generative_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "pytorch_generative_tpu/ops/attention_pallas.py:205",
         "launches": sum(cs[attention_cuda.BWD_KERNEL] for cs in all_counts)
         - snail["bwd_launches"],
         "max_abs_err": bwd_err, "ms": times["bwd"], "plain_ms": times["bwd_plain"],
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": times["bwd_lib"],
         "bound_f32_ms": bwd_bound_f32[0], "instances": instances[:-1]},
        snail["bwd_kernel"],
        {"name": decode_cuda.KERNEL, "route": "cuda",
         "source": "pytorch_generative_tpu_torch/csrc/sample_loop.cu",
         "replaces": "pytorch_generative_tpu/ops/decode_pallas.py:257",
         "launches": sum(cs[decode_cuda.KERNEL] for cs in all_counts),
         "max_abs_err": sample_err, "ms": times["sample"], "plain_ms": times["sample_plain"],
         "bound_ms": sample_bound[0], "bound_by": sample_bound[1], "library_ms": None},
        {"name": decode_cuda.DECODE_STEP_KERNEL, "route": "cuda",
         "source": "pytorch_generative_tpu_torch/csrc/decode_step.cu",
         "replaces": "pytorch_generative_tpu/ops/decode_pallas.py:69",
         "launches": sum(cs[decode_cuda.DECODE_STEP_KERNEL] for cs in all_counts),
         "max_abs_err": step_err, "ms": step_times["f32"], "plain_ms": step_times["f32_plain"],
         "bound_ms": step_bounds["f32"][0], "bound_by": step_bounds["f32"][1],
         "library_ms": None, "graph_ms": step_times["f32_graph"]},
        *({"name": kern, "route": "cuda",
           "source": f"pytorch_generative_tpu_torch/csrc/{kern}.cu", "replaces": replaces,
           "launches": sum(cs[kern] for cs in all_counts), "max_abs_err": err,
           "ms": fused_times[kern]["kernel"], "plain_ms": fused_times[kern]["plain"],
           "bound_ms": fused_bounds[kern][0], "bound_by": fused_bounds[kern][1],
           "library_ms": fused_times[kern]["library"],
           **({"bound_f32_ms": fused_bounds_f32[kern][0]} if kern in fused_bounds_f32 else {})}
          for kern, replaces, err in (
              (ln_cuda.KERNEL, "pytorch_generative_tpu/ops/ln_pallas.py:41", ln_err),
              (ln_cuda.BWD_KERNEL, "pytorch_generative_tpu/ops/ln_pallas.py:48", ln_bwd_err),
              (mlp_cuda.KERNEL, "pytorch_generative_tpu/ops/mlp_pallas.py:81", mlp_err),
              (mlp_cuda.BWD_KERNEL, "pytorch_generative_tpu/ops/mlp_pallas.py:102", mlp_bwd_err))),
        dict(snail["kernel"], launches=sum(cs[snail_decode_cuda.KERNEL] for cs in all_counts)),
        dict(vq["kernel"], launches=sum(cs[vq_cuda.KERNEL] for cs in all_counts)),
        *(dict(k_, launches=sum(cs[k_["name"]] for cs in all_counts)) for k_ in gated["kernels"]),
        *(dict(k_, launches=sum(cs[k_["name"]] for cs in all_counts)) for k_ in bf16["kernels"]),
        *slice_["kernels"],
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
