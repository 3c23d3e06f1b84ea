"""The ImageGPT decode kernels, each with its plain PyTorch version and its
launch count:

- ``csrc/sample_loop.cu``: the whole raster scan in one launch
  (``fused_sample_loop``, counterpart of
  ``pytorch_generative_tpu/ops/decode_pallas.py::fused_sample_loop``);
- ``csrc/decode_step.cu``: one raster position through the whole block
  stack (``fused_decode_step``, counterpart of
  ``decode_pallas.py::fused_decode_step``), float32 or bfloat16 K/V cache;
  the position an int or a 0-dim int32 device tensor that the kernel reads,
  so that one CUDA graph of the call serves every position.

Layouts follow the JAX package: the canvas is the zero-padded image
flattened to (position, batch), ``(Hp*Wp, N)``, with raw values (markers
< 0 are sampled, pixels >= 0 kept); ``pos_pad`` is the padded positional
embedding ``(Hp*Wp, 1)``; ``uniforms`` are ``(H*W, N, 1)``; the step's K/V
cache is packed ``(n_blocks, N, L, c_k + c_v)``, K and V side by side. A
CUDA tensor launches the kernel, or the wrapper raises; a CPU tensor takes
the plain version.

The whole-loop kernel runs on thread-block clusters of ``CLUSTER`` CTAs;
``sample_plan`` (pure Python) picks the samples a cluster serves together
and whether every block's weight slices stay in shared memory, from what
the card says fits at once (``cudaOccupancyMaxActiveClusters``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pytorch_generative_tpu_torch.nn.convolution import channel_layer_norm
from pytorch_generative_tpu_torch.ops import _build

KERNEL = "sample_loop"
DECODE_STEP_KERNEL = "decode_step"
WEIGHT_ORDER = ("in_w4", "in_b", "head_w", "head_b", "ln1_w", "ln1_b",
                "qkv_w", "qkv_b", "out_w", "out_b", "ln2_w", "ln2_b",
                "mlp1_w", "mlp1_b", "mlp2_w", "mlp2_b", "lnf_w", "lnf_b")
STEP_WEIGHT_ORDER = WEIGHT_ORDER[4:]
# The K/V cache types the step kernel takes (its template instances).
CACHE_DTYPES = (torch.float32, torch.bfloat16)

# The whole-loop kernel's weights that it copies 16 bytes at a time.
SAMPLE_LOOP_ALIGNED = ("qkv_w", "out_w", "mlp1_w", "mlp2_w")
# CTAs a cluster; dynamic shared memory a CTA may take: Hopper's 227 KB
# less 1 KB for the kernel's static shared memory (its weight feed).
CLUSTER = 8
HOPPER_SMEM = 232448
SMEM_LIMIT = HOPPER_SMEM - 1024
_RING = 3  # stages of the streamed weights' ring

# Kernel launches since the last reset: only _sample_loop_cuda adds to
# ``launches``. ``step_launches`` counts runs of the step kernel: an eager
# call of _decode_step_cuda adds one; a call captured into a CUDA graph adds
# one to ``captured_steps`` instead, and ``StepGraph.replay`` adds the
# steps its capture recorded, since a replay is where they run.
launches = 0
step_launches = 0
captured_steps = 0


class SamplePlan(NamedTuple):
    """How ``csrc/sample_loop.cu`` runs n samples."""
    cluster: int    # CTAs a cluster
    clusters: int   # clusters launched: at most as many as the card holds at once
    samples: int    # samples a cluster serves together (a group)
    groups: int     # ceil(n / samples); a cluster takes groups in turn
    resident: bool  # every block's weight slices stay in shared memory
    stage: int      # floats a ring stage when the slices are streamed, else 0
    smem: int       # bytes of shared memory a CTA


def stack_image_gpt_weights(model):
    """An ImageGPT's parameters, stacked per block, for the sampler.

    Per block: ``qkv_w`` (C, 2*c_k + c_v) is q_proj and kv_proj side by side;
    ``out_w`` (c_v, C), ``mlp1_w`` (C, 4C), ``mlp2_w`` (4C, C). ``in_w4``
    (4, C) holds the live taps of the masked 3x3 type-A input conv at
    (-1, -1), (-1, 0), (-1, +1), (0, -1); ``head_w`` (C,), ``head_b`` (1,).
    """
    blocks = model.blocks
    stack = lambda get: torch.stack([get(blk) for blk in blocks])
    wm = model.input_conv.weight * model.input_conv.mask    # (C, 1, 3, 3)
    weights = {
        "in_w4": torch.stack([wm[:, 0, 0, 0], wm[:, 0, 0, 1], wm[:, 0, 0, 2],
                              wm[:, 0, 1, 0]]),
        "in_b": model.input_conv.bias,
        "head_w": model.out_conv.weight[:, 0],
        "head_b": model.out_conv.bias,
        "ln1_w": stack(lambda b: b.ln1.scale),
        "ln1_b": stack(lambda b: b.ln1.offset),
        "qkv_w": stack(lambda b: torch.cat(
            [b.attn.q_proj.weight, b.attn.kv_proj.weight], dim=1)),
        "qkv_b": stack(lambda b: torch.cat(
            [b.attn.q_proj.bias, b.attn.kv_proj.bias])),
        "out_w": stack(lambda b: b.attn.out_proj.weight),
        "out_b": stack(lambda b: b.attn.out_proj.bias),
        "ln2_w": stack(lambda b: b.ln2.scale),
        "ln2_b": stack(lambda b: b.ln2.offset),
        "mlp1_w": stack(lambda b: b.mlp_conv1.weight),
        "mlp1_b": stack(lambda b: b.mlp_conv1.bias),
        "mlp2_w": stack(lambda b: b.mlp_conv2.weight),
        "mlp2_b": stack(lambda b: b.mlp_conv2.bias),
        "lnf_w": model.ln.scale,
        "lnf_b": model.ln.offset,
    }
    return {k: v.detach().float().contiguous() for k, v in weights.items()}


def _dims(weights, n_heads):
    n_blocks, c, f = weights["qkv_w"].shape
    c_v = weights["out_w"].shape[1]
    c_k = (f - c_v) // 2
    m = weights["mlp1_w"].shape[2]
    return n_blocks, c, c_k, c_v, m


def _weight_shapes(weights, n_heads):
    """The stacked weights' shapes, as the kernels take them."""
    n_blocks, c, c_k, c_v, m = _dims(weights, n_heads)
    if c_k % n_heads or c_v % n_heads:
        raise ValueError(f"widths {c_k}/{c_v} not divisible by {n_heads} heads")
    return {
        "in_w4": (4, c), "in_b": (c,), "head_w": (c,), "head_b": (1,),
        "ln1_w": (n_blocks, c), "ln1_b": (n_blocks, c),
        "qkv_w": (n_blocks, c, 2 * c_k + c_v), "qkv_b": (n_blocks, 2 * c_k + c_v),
        "out_w": (n_blocks, c_v, c), "out_b": (n_blocks, c),
        "ln2_w": (n_blocks, c), "ln2_b": (n_blocks, c),
        "mlp1_w": (n_blocks, c, m), "mlp1_b": (n_blocks, m),
        "mlp2_w": (n_blocks, m, c), "mlp2_b": (n_blocks, c),
        "lnf_w": (c,), "lnf_b": (c,),
    }


def _up4(v):
    return (v + 3) & ~3


def _max_cols(j, cluster):
    """Most columns of a J-column product a rank owns (units of 4 when J %
    4 == 0, else of 1, spread as evenly as they go)."""
    unit = 4 if j % 4 == 0 else 1
    return -(-(j // unit) // cluster) * unit


def _slices(dims, cluster):
    """(rows, columns) of each product's slice on the rank that owns the
    most: QKV by columns, out by rows (value features), MLP 1 by columns
    and MLP 2 by rows (hidden units)."""
    _, _, _, c, n_heads, d_k, d_v, m = dims
    c_k, c_v = n_heads * d_k, n_heads * d_v
    return ((c, _max_cols(2 * c_k + c_v, cluster)), (_max_cols(c_v, cluster), c),
            (c, _max_cols(m, cluster)), (_max_cols(m, cluster), c))


def sample_plan(n, dims, max_clusters_for, smem_for, smem_limit=SMEM_LIMIT, cluster=CLUSTER):
    """The whole-loop kernel's plan for n samples of a model of ``dims`` =
    (h, w, n_blocks, C, n_heads, d_k, d_v, M).

    ``max_clusters_for(smem, samples)`` is how many clusters of ``cluster``
    CTAs the card holds at once at ``smem`` bytes a CTA, for the kernel
    instance of ``samples`` a group (cudaOccupancyMaxActiveClusters on the
    card); ``smem_for(samples, resident, stage)`` is the shared memory a
    CTA of such a plan takes (the kernel's ``sample_loop_smem_bytes`` on
    the card; a stage of 0 gives what the ring leaves). The plan takes the fewest samples a cluster that serve all
    n in one wave of clusters, with every block's weight slices resident in
    shared memory if they fit, else streamed through a ring of ``_RING``
    stages (a stage holds a product's slice, or as many of its rows as
    fit). Where no
    plan serves n in one wave, it takes the one of fewest waves: each
    cluster then serves several groups in turn. It never plans more
    clusters than ``max_clusters_for`` gives; it raises where no plan fits.
    """
    if n < 1:
        raise ValueError(f"n = {n}: the sampler needs at least one sample")
    slices = [_up4(k * j) for k, j in _slices(dims, cluster)]
    widest = max(j for _, j in _slices(dims, cluster))
    best = None
    for resident in (True, False):
        for samples in range(1, n + 1):
            stage = 0
            if not resident:
                room = (smem_limit - smem_for(samples, False, 0)) // (4 * _RING)
                room = room // 4 * 4
                stage = min(max(slices), room)
                if stage < widest:
                    break
            smem = smem_for(samples, resident, stage)
            if smem > smem_limit:
                break
            cap = max_clusters_for(smem, samples)
            if cap < 1:
                break
            groups = -(-n // samples)
            plan = SamplePlan(cluster, min(cap, groups), samples, groups, resident, stage, smem)
            if groups <= cap:
                return plan
            waves = lambda p: -(-p.groups // p.clusters)
            if best is None or waves(plan) < waves(best):
                best = plan
    if best is None:
        raise ValueError(f"the whole-loop kernel has no plan for dims {dims}: no cluster of "
                         f"{cluster} CTAs fits in {smem_limit} bytes of shared memory a CTA")
    return best


def sample_loop_plain(canvas0, pos_pad, uniforms, weights, n_heads, h, w):
    """The kernel's plain version: KV-cache decoding, one position at a time
    over the whole batch (the JAX package's ``sampling._image_gpt_decode``)."""
    n = canvas0.shape[1]
    wp = w + 2
    n_blocks, _, c_k, c_v, _ = _dims(weights, n_heads)
    d_k, d_v = c_k // n_heads, c_v // n_heads
    wt = weights
    ln = channel_layer_norm
    canvas = canvas0.clone()
    pos = pos_pad[:, 0]
    k_cache = canvas.new_zeros((n_blocks, n, n_heads, h * w, d_k))
    v_cache = canvas.new_zeros((n_blocks, n, n_heads, h * w, d_v))
    for i in range(h * w):
        row, col = divmod(i, w)
        p0 = row * wp + col
        taps = torch.tensor([p0, p0 + 1, p0 + 2, p0 + wp], device=canvas.device)
        x = (canvas[taps] + pos[taps, None]).T @ wt["in_w4"] + wt["in_b"]
        for b in range(n_blocks):
            qkv = ln(x, wt["ln1_w"][b], wt["ln1_b"][b]) @ wt["qkv_w"][b] + wt["qkv_b"][b]
            q = qkv[:, :c_k].reshape(n, n_heads, d_k)
            k_cache[b, :, :, i] = qkv[:, c_k:2 * c_k].reshape(n, n_heads, d_k)
            v_cache[b, :, :, i] = qkv[:, 2 * c_k:].reshape(n, n_heads, d_v)
            scores = torch.einsum("nhd,nhld->nhl", q, k_cache[b, :, :, :i + 1])
            probs = torch.softmax(scores / d_k ** 0.5, dim=-1)
            attn = torch.einsum("nhl,nhlv->nhv", probs, v_cache[b, :, :, :i + 1])
            x1 = x + attn.reshape(n, c_v) @ wt["out_w"][b] + wt["out_b"][b]
            t = ln(x1, wt["ln2_w"][b], wt["ln2_b"][b])
            hmid = F.gelu(t @ wt["mlp1_w"][b] + wt["mlp1_b"][b])
            # Block residual + the model-level extra skip.
            x = x + (x1 + hmid @ wt["mlp2_w"][b] + wt["mlp2_b"][b])
        logits = ln(x, wt["lnf_w"], wt["lnf_b"]) @ wt["head_w"] + wt["head_b"]
        sampled = (uniforms[i, :, 0] < torch.sigmoid(logits)).to(canvas.dtype)
        pw = (row + 1) * wp + col + 1
        canvas[pw] = torch.where(canvas[pw] < 0, sampled, canvas[pw])
    return canvas


def _lib():
    lib = _build.load(KERNEL)
    _build.declare(lib.sample_loop_f32,
                   [ctypes.c_void_p] * 23 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
    _build.declare(lib.sample_loop_occupancy,
                   [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2)
    _build.declare(lib.sample_loop_smem_bytes, [ctypes.c_int] * 12, ctypes.c_longlong)
    return lib


def occupancy(d_k, d_v, samples, cluster, smem):
    """(cudaOccupancyMaxActiveClusters, registers a thread) of the kernel
    instance for (d_k, d_v) and ``samples`` a group at ``cluster`` CTAs a
    cluster and ``smem`` bytes a CTA, on the current device."""
    clusters, regs = ctypes.c_int(), ctypes.c_int()
    err = _lib().sample_loop_occupancy(d_k, d_v, samples, cluster, smem,
                                       ctypes.byref(clusters), ctypes.byref(regs))
    _build.check(err, "sample_loop_occupancy")
    return clusters.value, regs.value


_max_clusters: dict = {}


def check_sample_loop(canvas0, pos_pad, uniforms, weights, n_heads, h, w):
    """Raises unless the operands are what the whole-loop kernel takes:
    contiguous float32 on canvas0's device, of matching shapes, the weights
    it copies 16 bytes at a time (``SAMPLE_LOOP_ALIGNED``) starting on a
    16-byte boundary; returns n and the plan's dims (h, w, n_blocks, C,
    n_heads, d_k, d_v, M)."""
    lp, n = canvas0.shape
    expected = _weight_shapes(weights, n_heads)
    n_blocks, c, c_k, c_v, m = _dims(weights, n_heads)
    expected.update(canvas0=((h + 2) * (w + 2), n), pos_pad=(lp, 1), uniforms=(h * w, n, 1))
    operands = dict(weights, canvas0=canvas0, pos_pad=pos_pad, uniforms=uniforms)
    for k in ("canvas0", "pos_pad", "uniforms", *WEIGHT_ORDER):
        _build.check_tensor(k, operands[k], expected[k], canvas0.device, KERNEL,
                            aligned=k in SAMPLE_LOOP_ALIGNED)
    return n, (h, w, n_blocks, c, n_heads, c_k // n_heads, c_v // n_heads, m)


def plan_for(canvas0, pos_pad, uniforms, weights, n_heads, h, w):
    """``sample_plan`` for these operands on their card."""
    n, dims = check_sample_loop(canvas0, pos_pad, uniforms, weights, n_heads, h, w)
    return _card_plan(n, dims, canvas0.device)


def _card_plan(n, dims, dev):
    def max_clusters_for(smem, samples):
        # The kernel's instances: 1, 2, or 3 and more samples a group.
        key = (dev, dims[5], dims[6], min(samples, 3), CLUSTER, smem)
        if key not in _max_clusters:
            with torch.cuda.device(dev):
                _max_clusters[key] = occupancy(dims[5], dims[6], samples, CLUSTER, smem)[0]
        return _max_clusters[key]

    def smem_for(samples, resident, stage):
        return _lib().sample_loop_smem_bytes(*dims, CLUSTER, samples, int(resident), stage)

    return sample_plan(n, dims, max_clusters_for, smem_for)


def _sample_loop_cuda(canvas0, pos_pad, uniforms, weights, n_heads, h, w):
    global launches
    n, dims = check_sample_loop(canvas0, pos_pad, uniforms, weights, n_heads, h, w)
    _, _, n_blocks, c, _, d_k, d_v, m = dims
    dev = canvas0.device
    plan = _card_plan(n, dims, dev)
    canvas = torch.empty_like(canvas0)
    # The K/V cache, laid out as each rank reads it: rank r's positions
    # l = r (mod cluster) of every block and sample side by side.
    kv = torch.empty((n_blocks, n, plan.cluster, -(-(h * w) // plan.cluster),
                      n_heads * (d_k + d_v)), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().sample_loop_f32(
            canvas0.data_ptr(), pos_pad.data_ptr(), uniforms.data_ptr(),
            canvas.data_ptr(), kv.data_ptr(),
            *[weights[k].data_ptr() for k in WEIGHT_ORDER],
            n, h, w, n_blocks, c, n_heads, d_k, d_v, m, plan.cluster, plan.clusters,
            plan.samples, plan.groups, int(plan.resident), plan.stage, stream)
    _build.check(err, "sample_loop_f32")
    launches += 1
    return canvas


def fused_sample_loop(canvas0, pos_pad, uniforms, weights, n_heads, h, w):
    """Runs the whole raster scan; returns the final (Hp*Wp, N) canvas."""
    return _build.dispatch(_sample_loop_cuda, sample_loop_plain, canvas0, pos_pad,
                           uniforms, weights, n_heads, h, w)


def decode_step_plain(i, x, kv_cache, weights, n_heads):
    """The step kernel's plain version (the JAX package's ``_step_kernel``):
    one raster position ``i`` (a Python int or a 0-dim integer tensor)
    through every block for (N, C) ``x``.

    Attention reads the cache's positions < i and takes this position's own
    k and v, unrounded, as one more column; positions >= i are never read.
    This position's k|v is written into ``kv_cache[:, :, i]`` in the
    cache's dtype. Returns ``act`` (N, C), the final LayerNorm of x, and
    ``kv_new`` (n_blocks, N, c_k + c_v), a view of that cache position.
    """
    if isinstance(i, torch.Tensor):
        i = int(i)
    n_blocks, _, c_k, c_v, _ = _dims(weights, n_heads)
    n = x.shape[0]
    d_k, d_v = c_k // n_heads, c_v // n_heads
    wt = weights
    ln = channel_layer_norm
    for b in range(n_blocks):
        qkv = ln(x, wt["ln1_w"][b], wt["ln1_b"][b]) @ wt["qkv_w"][b] + wt["qkv_b"][b]
        q = (qkv[:, :c_k] * (1.0 / d_k ** 0.5)).reshape(n, n_heads, d_k)
        k_i = qkv[:, c_k:2 * c_k].reshape(n, n_heads, d_k)
        v_i = qkv[:, 2 * c_k:].reshape(n, n_heads, d_v)
        kv_cache[b, :, i] = qkv[:, c_k:]
        past = kv_cache[b, :, :i].float()
        k_p = past[..., :c_k].reshape(n, i, n_heads, d_k)
        v_p = past[..., c_k:].reshape(n, i, n_heads, d_v)
        scores = torch.cat([torch.einsum("nhd,nlhd->nhl", q, k_p),
                            (q * k_i).sum(-1, keepdim=True)], dim=-1)
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        denom = e[..., :i].sum(-1) + e[..., i]
        num = torch.einsum("nhl,nlhd->nhd", e[..., :i], v_p) + e[..., i:] * v_i
        attn = (num / denom[..., None]).reshape(n, c_v)
        x1 = x + (attn @ wt["out_w"][b] + wt["out_b"][b])
        hmid = F.gelu(ln(x1, wt["ln2_w"][b], wt["ln2_b"][b]) @ wt["mlp1_w"][b]
                      + wt["mlp1_b"][b])
        # Block residual + the model-level extra skip.
        x = x + (x1 + (hmid @ wt["mlp2_w"][b] + wt["mlp2_b"][b]))
    return ln(x, wt["lnf_w"], wt["lnf_b"]), kv_cache[:, :, i]


def _step_lib():
    lib = _build.load(DECODE_STEP_KERNEL)
    _build.declare(lib.decode_step_scratch_floats, [ctypes.c_int] * 7, ctypes.c_longlong)
    _build.declare(lib.decode_step_smem_bytes, [ctypes.c_int] * 8, ctypes.c_longlong)
    args = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_void_p] * 14
            + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    for fn in (lib.decode_step_f32, lib.decode_step_bf16):
        _build.declare(fn, args)
    return lib


def _check_position(i, l, dev):
    """(device pointer or None, host value) of the position: a 0-dim int32
    tensor on ``dev`` is read by the kernel (no host value); an int is
    checked against the cache's ``l`` positions."""
    if isinstance(i, torch.Tensor):
        if i.dim() != 0 or i.dtype != torch.int32 or i.device != dev:
            raise ValueError(f"a tensor position must be a 0-dim int32 tensor on {dev}, got "
                             f"{tuple(i.shape)} {i.dtype} on {i.device}")
        return i.data_ptr(), 0
    if not 0 <= i < l:
        raise ValueError(f"position {i} outside the cache's {l} positions")
    return None, i


def _decode_step_cuda(i, x, kv_cache, weights, n_heads):
    global step_launches, captured_steps
    expected = _weight_shapes(weights, n_heads)
    n_blocks, c, c_k, c_v, m = _dims(weights, n_heads)
    if kv_cache.dtype not in CACHE_DTYPES:
        raise TypeError(f"kv_cache: {DECODE_STEP_KERNEL} takes a cache of "
                        f"{CACHE_DTYPES}, got {kv_cache.dtype}")
    if kv_cache.dim() != 4:
        raise ValueError(f"kv_cache must be (n_blocks, N, L, c_k + c_v), got "
                         f"{tuple(kv_cache.shape)}")
    n, l = x.shape[0], kv_cache.shape[2]
    dev = x.device
    i_ptr, i_val = _check_position(i, l, dev)
    _build.check_tensor("x", x, (n, c), dev, DECODE_STEP_KERNEL)
    _build.check_tensor("kv_cache", kv_cache, (n_blocks, n, l, c_k + c_v), dev,
                        DECODE_STEP_KERNEL, kv_cache.dtype)
    for k in STEP_WEIGHT_ORDER:
        _build.check_tensor(k, weights[k], expected[k], dev, DECODE_STEP_KERNEL)
    d_k, d_v = c_k // n_heads, c_v // n_heads
    lib = _step_lib()
    bf16 = kv_cache.dtype == torch.bfloat16
    smem = lib.decode_step_smem_bytes(n, l, c, n_heads, d_k, d_v, m, int(bf16))
    if smem > HOPPER_SMEM:
        raise ValueError(f"{DECODE_STEP_KERNEL}: widths C={c}, M={m}, d_k={d_k}, d_v={d_v} "
                         f"need {smem} bytes of shared memory a CTA, more than the "
                         f"{HOPPER_SMEM} Hopper has")
    act = torch.empty((n, c), device=dev)
    scratch = torch.empty(lib.decode_step_scratch_floats(n, l, c, n_heads, d_k, d_v, m),
                          device=dev)
    entry = lib.decode_step_bf16 if bf16 else lib.decode_step_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = entry(i_ptr, i_val, x.data_ptr(), kv_cache.data_ptr(), act.data_ptr(),
                    scratch.data_ptr(), *[weights[k].data_ptr() for k in STEP_WEIGHT_ORDER],
                    n, l, n_blocks, c, n_heads, d_k, d_v, m, stream)
    _build.check(err, entry.__name__)
    if torch.cuda.is_current_stream_capturing():
        captured_steps += 1
    else:
        step_launches += 1
    if i_ptr is None:
        return act, kv_cache[:, :, i]
    return act, kv_cache.index_select(2, i.reshape(1)).squeeze(2)


class StepGraph:
    """A CUDA graph of code that calls ``fused_decode_step`` with a device
    position: ``capture()`` records it on the current stream, and each
    ``replay()`` runs it and adds to ``step_launches`` the step launches
    that the capture recorded (none, if the captured code launched no
    step)."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.steps = 0

    @contextlib.contextmanager
    def capture(self):
        """Captures the code run inside it. Without ``torch.cuda.graph``'s
        context, which empties the allocator's cache first: freeing a large
        cache synchronises."""
        before = captured_steps
        self.graph.capture_begin()
        try:
            yield self
        finally:
            self.graph.capture_end()
        self.steps = captured_steps - before

    def replay(self):
        global step_launches
        self.graph.replay()
        step_launches += self.steps


def fused_decode_step(i, x, kv_cache, weights, n_heads):
    """Runs the whole block stack for raster position ``i``.

    Args:
        i: the global position: a Python int, or a 0-dim int32 tensor on
            x's device, which the kernel reads from device memory (as the
            TPU kernel reads ``i_ref``), so that one CUDA graph of the call
            serves every position.
        x: (N, C) float32, the masked input conv plus the positional
            embedding at position i.
        kv_cache: (n_blocks, N, L, c_k + c_v) packed K|V cache, float32 or
            bfloat16; positions < i are read, and this position's k|v is
            written at i in place (as the JAX package's caller writes the
            step's kv_new with ``dynamic_update_slice``).
        weights: ``stack_image_gpt_weights(model)``.
        n_heads: attention heads.
    Returns:
        act: (N, C) float32 activations after the model's final LayerNorm.
        kv_new: (n_blocks, N, c_k + c_v) this position's k|v per block in the
            cache's dtype: a view of ``kv_cache[:, :, i]`` for an int i, a
            copy of it for a tensor i (on the card).
    """
    # By x's device: a tensor i lies where x does.
    return _build.dispatch(functools.partial(_decode_step_cuda, i),
                           functools.partial(decode_step_plain, i), x, kv_cache, weights, n_heads)
