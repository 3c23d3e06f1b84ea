"""The PixelSNAIL whole-loop sampler kernel ``csrc/snail_loop.cu``, its plain
PyTorch version and its launch count (counterpart of
``pytorch_generative_tpu/ops/snail_decode_pallas.py``).

Layouts follow the JAX package: the canvas is the zero-padded image flattened
to (position, batch), ``(Hp*Wp, N)``, with raw values (markers < 0 are
sampled, pixels >= 0 kept); ``uniforms`` are ``(H*W, N, 1)``. A CUDA tensor
launches the kernel, or the wrapper raises; a CPU tensor takes the plain
version. The kernel runs on thread-block clusters: ``snail_plan`` picks the
cluster size, the samples a cluster serves together, the clusters at once
and the weight ring's stages from the card's occupancy and the kernel's own
shared-memory size (``plan_for`` shows the plan of given operands); a model
whose widths the kernel cannot cut, or whose plan does not fit, raises a
ValueError before any launch.

Per raster position i and sample, both compute: the live taps of the masked
3x3 type-A input conv; per block, per residual block elu(res) into the elu
cache at i, mid = elu(2x2 conv of the elu cache) into the mid cache, out =
2x2 conv of the mid cache and res += out[:, :C] * sigmoid(out[:, C:]); q
from [pos, res]; attention over the cached keys < i (none at i = 0: the
output is out_proj's bias); the elu-conv-elu branches and the block skip;
then the head of two 1x1 convs, the draw ``u < sigmoid(logit)``, the
inpainting merge and, per block, kv_proj of [pos, res, merged pixel]
appended to the K/V cache at i: k/v read the merged pixel, so they are
appended only after it is drawn.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pytorch_generative_tpu_torch.ops import _build

KERNEL = "snail_loop"
WEIGHT_ORDER = ("in_w4", "in_b", "rb1_w", "rb1_b", "rb2_w", "rb2_b", "q_w", "q_b",
                "kv_w", "kv_b", "op_w", "op_b", "ro_w", "ro_b", "ao_w", "ao_b",
                "o_w", "o_b", "h1_w", "h1_b", "h2_w", "h2_b")

# The weights the kernel packs 16 bytes at a time into each rank's stream
# (which its ring then takes by bulk copies); it reads the biases, in_w4,
# h2_w, the canvas and the uniforms 4 bytes at a time.
SNAIL_LOOP_ALIGNED = ("rb1_w", "rb2_w", "q_w", "kv_w", "op_w", "ro_w", "ao_w", "o_w", "h1_w")
# Cluster sizes the plan tries, in order of preference (the order of their
# times at the reproduce() config, n = 1 a group, on an H100); ring depths; the
# kernel's instances (samples a group), the widest piece a thread block
# takes (2 columns a thread) and the least stage a piece is chunked into
# (floats); Hopper's shared memory a CTA.
CLUSTERS = (4, 2, 1, 8)
DEPTHS = (8, 7, 6, 5, 4, 3)
MAX_SAMPLES = 8
MAX_COLS = 516  # 512 columns of 2 a lane, and a row's padding
MIN_STAGE = 4096
HOPPER_SMEM = 232448

# Kernel launches since the last reset; only _snail_loop_cuda adds to it.
launches = 0


class SnailPlan(NamedTuple):
    """How ``csrc/snail_loop.cu`` runs n samples."""
    cluster: int   # CTAs a cluster (ranks)
    clusters: int  # clusters launched: at most as many as the card holds at once
    samples: int   # samples a cluster serves together (a group)
    groups: int    # ceil(n / samples); a cluster takes groups in turn
    stage: int     # floats a ring stage
    depth: int     # ring stages
    smem: int      # dynamic shared memory a CTA, bytes


def stack_pixel_snail_weights(model):
    """A PixelSNAIL's parameters, stacked per block, in the kernel's layout.

    ``in_w4`` (4 * Cin, C): the live taps of the masked 3x3 type-A input
    conv at (-1, -1), (-1, 0), (-1, +1), (0, -1), each (Cin, C). Per block
    and residual block: ``rb1_w`` (4C, C) and ``rb2_w`` (4C, 2C), the 2x2
    conv taps (0, 0), (0, 1), (1, 0), (1, 1) stacked over the input
    channels. Per block: ``q_w`` (C + 2, d_k), ``kv_w`` (C + 2 + Cin,
    d_k + d_v), ``op_w`` (d_v, d_v), ``ro_w`` (C, C), ``ao_w`` (d_v, C),
    ``o_w`` (C, C). The head: ``h1_w`` (C, C // 2), ``h2_w`` (C // 2, Cout).
    """
    blocks = model.pixel_snail_blocks
    wm = model.input_conv.weight * model.input_conv.mask      # (C, Cin, 3, 3)
    c = wm.shape[0]
    stack = lambda get: torch.stack([get(blk) for blk in blocks])
    # OIHW (Co, Ci, 2, 2) -> (2, 2, Ci, Co) -> (4 Ci, Co).
    taps = lambda conv: conv.weight.permute(2, 3, 1, 0).reshape(-1, conv.weight.shape[0])

    def per_rb(get, shape):
        if not blocks[0].residual_blocks:
            return wm.new_zeros((len(blocks), 0, *shape))
        return stack(lambda blk: torch.stack([get(rb) for rb in blk.residual_blocks]))

    weights = {
        "in_w4": torch.cat([wm[:, :, 0, 0].T, wm[:, :, 0, 1].T, wm[:, :, 0, 2].T,
                            wm[:, :, 1, 0].T]),
        "in_b": model.input_conv.bias,
        "rb1_w": per_rb(lambda rb: taps(rb.input_conv), (4 * c, c)),
        "rb1_b": per_rb(lambda rb: rb.input_conv.bias, (c,)),
        "rb2_w": per_rb(lambda rb: taps(rb.output_conv), (4 * c, 2 * c)),
        "rb2_b": per_rb(lambda rb: rb.output_conv.bias, (2 * c,)),
        "q_w": stack(lambda b: b.attention.q_proj.weight),
        "q_b": stack(lambda b: b.attention.q_proj.bias),
        "kv_w": stack(lambda b: b.attention.kv_proj.weight),
        "kv_b": stack(lambda b: b.attention.kv_proj.bias),
        "op_w": stack(lambda b: b.attention.out_proj.weight),
        "op_b": stack(lambda b: b.attention.out_proj.bias),
        "ro_w": stack(lambda b: b.residual_out.weight),
        "ro_b": stack(lambda b: b.residual_out.bias),
        "ao_w": stack(lambda b: b.attention_out.weight),
        "ao_b": stack(lambda b: b.attention_out.bias),
        "o_w": stack(lambda b: b.out.weight),
        "o_b": stack(lambda b: b.out.bias),
        "h1_w": model.output_conv1.weight,
        "h1_b": model.output_conv1.bias,
        "h2_w": model.output_conv2.weight,
        "h2_b": model.output_conv2.bias,
    }
    return {k: v.detach().float().contiguous() for k, v in weights.items()}


def _dims(weights):
    """(n_blocks, n_rb, C, C2, d_k, d_v, Cin, Cout) of stacked weights."""
    n_blocks, n_rb, _, c = weights["rb1_w"].shape
    d_k, d_v = weights["q_w"].shape[2], weights["op_w"].shape[1]
    c2, c_out = weights["h2_w"].shape
    return n_blocks, n_rb, c, c2, d_k, d_v, weights["in_w4"].shape[0] // 4, c_out


def _weight_shapes(weights):
    """The stacked weights' shapes, as the kernel takes them (Cin = Cout = 1)."""
    nb, nr, c, c2, d_k, d_v, _, _ = _dims(weights)
    return {
        "in_w4": (4, c), "in_b": (c,),
        "rb1_w": (nb, nr, 4 * c, c), "rb1_b": (nb, nr, c),
        "rb2_w": (nb, nr, 4 * c, 2 * c), "rb2_b": (nb, nr, 2 * c),
        "q_w": (nb, c + 2, d_k), "q_b": (nb, d_k),
        "kv_w": (nb, c + 3, d_k + d_v), "kv_b": (nb, d_k + d_v),
        "op_w": (nb, d_v, d_v), "op_b": (nb, d_v),
        "ro_w": (nb, c, c), "ro_b": (nb, c),
        "ao_w": (nb, d_v, c), "ao_b": (nb, c),
        "o_w": (nb, c, c), "o_b": (nb, c),
        "h1_w": (c, c2), "h1_b": (c2,), "h2_w": (c2, 1), "h2_b": (1,),
    }


def snail_decode(canvas, uniforms, weights, h, w, sample_fn):
    """KV-cache decoding of a PixelSNAIL, one raster position at a time over
    the whole batch (the JAX package's ``pixel_snail_sample_fast``).

    Args:
        canvas: (N, H + 2, W + 2, Cin) zero-padded images; entries < 0 are
            sampled, entries >= 0 kept. Updated in place.
        uniforms: (H*W, N, Cin) draws for ``sample_fn``.
        weights: ``stack_pixel_snail_weights(model)``.
        sample_fn: ``(u (N, Cin), logits (N, Cout)) -> (N, Cin)`` samples.
    Returns:
        ``canvas``, with every sampled entry drawn.
    """
    n, cin = canvas.shape[0], canvas.shape[-1]
    wt = weights
    nb, nr, c, _, d_k, d_v, _, _ = _dims(wt)
    seq_len = h * w
    # Per (block, residual block): elu(res) and mid as (h + 1, w + 1) maps
    # whose entry (r + 1, c + 1) holds position (r, c); row 0 and column 0
    # are the 2x2 convs' zero padding.
    elu_c = canvas.new_zeros((nb, nr, n, h + 1, w + 1, c))
    mid_c = torch.zeros_like(elu_c)
    k_cache = canvas.new_zeros((nb, n, seq_len, d_k))
    v_cache = canvas.new_zeros((nb, n, seq_len, d_v))
    hw = torch.tensor([h, w], dtype=torch.float32, device=canvas.device)
    for i in range(seq_len):
        row, col = divmod(i, w)
        pos = (torch.tensor([row, col], dtype=torch.float32, device=canvas.device)
               / hw - 0.5).expand(n, 2)
        patch = torch.cat([canvas[:, row, col], canvas[:, row, col + 1],
                           canvas[:, row, col + 2], canvas[:, row + 1, col]], dim=-1)
        x = patch @ wt["in_w4"] + wt["in_b"]
        q_ins = []
        for b in range(nb):
            res = x
            for j in range(nr):
                elu_c[b, j, :, row + 1, col + 1] = F.elu(res)
                taps = elu_c[b, j, :, row:row + 2, col:col + 2].reshape(n, 4 * c)
                mid = F.elu(taps @ wt["rb1_w"][b, j] + wt["rb1_b"][b, j])
                mid_c[b, j, :, row + 1, col + 1] = mid
                taps = mid_c[b, j, :, row:row + 2, col:col + 2].reshape(n, 4 * c)
                out = taps @ wt["rb2_w"][b, j] + wt["rb2_b"][b, j]
                res = res + out[:, :c] * torch.sigmoid(out[:, c:])
            q_in = torch.cat([pos, res], dim=-1)
            q_ins.append(q_in)
            att = canvas.new_zeros((n, d_v))
            if i > 0:  # mask_center: position i attends to positions < i
                q = (q_in @ wt["q_w"][b] + wt["q_b"][b]) / d_k ** 0.5
                probs = torch.softmax(torch.einsum("nd,nld->nl", q, k_cache[b, :, :i]), -1)
                att = torch.einsum("nl,nld->nd", probs, v_cache[b, :, :i])
            att = att @ wt["op_w"][b] + wt["op_b"][b]
            res2 = F.elu(F.elu(res) @ wt["ro_w"][b] + wt["ro_b"][b])
            att2 = F.elu(F.elu(att) @ wt["ao_w"][b] + wt["ao_b"][b])
            x = x + F.elu(F.elu(res2 + att2) @ wt["o_w"][b] + wt["o_b"][b])
        logits = (x @ wt["h1_w"] + wt["h1_b"]) @ wt["h2_w"] + wt["h2_b"]
        sampled = sample_fn(uniforms[i], logits).reshape(n, cin).to(canvas.dtype)
        current = canvas[:, row + 1, col + 1]
        merged = torch.where(current < 0, sampled, current)
        canvas[:, row + 1, col + 1] = merged
        for b, q_in in enumerate(q_ins):
            kv = torch.cat([q_in, merged], dim=-1) @ wt["kv_w"][b] + wt["kv_b"][b]
            k_cache[b, :, i], v_cache[b, :, i] = kv[:, :d_k], kv[:, d_k:]
    return canvas


def _draw(u, logits):
    """The kernel's draw: ``u < sigmoid(logit)`` as exact 0.0 or 1.0."""
    return (u < torch.sigmoid(logits)).to(logits.dtype)


def snail_sample_loop_plain(canvas0, uniforms, weights, h, w):
    """The kernel's plain version: ``snail_decode`` of a 1-channel model on
    the (Hp*Wp, N) canvas with the (H*W, N, 1) uniforms."""
    n = canvas0.shape[1]
    canvas = canvas0.T.reshape(n, h + 2, w + 2, 1).clone()
    out = snail_decode(canvas, uniforms, weights, h, w, _draw)
    return out.reshape(n, -1).T.contiguous()


def _lib():
    lib = _build.load(KERNEL)
    _build.declare(lib.snail_loop_f32,
                   [ctypes.c_void_p] * 6 + [ctypes.c_void_p] * len(WEIGHT_ORDER)
                   + [ctypes.c_int] * 15 + [ctypes.c_void_p])
    _build.declare(lib.snail_loop_stream_floats, [ctypes.c_int] * 9, ctypes.c_longlong)
    _build.declare(lib.snail_loop_taps_floats, [ctypes.c_int] * 4, ctypes.c_longlong)
    _build.declare(lib.snail_loop_smem_bytes, [ctypes.c_int] * 12, ctypes.c_longlong)
    _build.declare(lib.snail_loop_static_smem_bytes, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    _build.declare(lib.snail_loop_occupancy,
                   [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2)
    return lib


def _piece_shapes(dims, cluster):
    """(rows, floats a row) of each weight piece a rank streams, as the
    kernel cuts them (its ``piece_rows``, ``piece_cols`` and
    ``row_floats``: a row of J columns takes J floats, or J + 4 when J / 4
    is even): per residual block conv 1 and conv 2 (all four taps of the
    rank's C / cluster channels), then q | kv_proj, out_proj,
    residual_out, attention_out, out, and the head's first conv."""
    _, _, _, _, c, c2, d_k, d_v = dims
    cnt = c // cluster
    row = lambda j: j if (j // 4) % 2 else j + 4
    return tuple((k, row(j)) for k, j in (
        (c, 4 * cnt), (c, 8 * cnt), (c + 2, 2 * d_k + d_v), (d_v, d_v), (c, c), (d_v, c),
        (c, c), (c, c2)))


def check_dims(dims):
    """Raises a ValueError unless the kernel takes a model of ``dims`` = (h,
    w, n_blocks, n_rb, C, C2, d_k, d_v): every width a multiple of 4 (its
    16-byte copies and loads), d_k and d_v at most 32 (a group of 8 lanes
    holds a key's k and v)."""
    _, _, _, _, c, c2, d_k, d_v = dims
    if any(v % 4 or v < 4 for v in (c, c2, d_k, d_v)):
        raise ValueError(f"{KERNEL} takes widths C, C // 2, d_k, d_v that are multiples of 4, "
                         f"got {c}, {c2}, {d_k}, {d_v}")
    if d_k > 32 or d_v > 32:
        raise ValueError(f"{KERNEL} takes d_k, d_v <= 32, got {d_k}, {d_v}")


def snail_plan(n, dims, max_clusters_for, smem_for, smem_limit, clusters=CLUSTERS):
    """The whole-loop kernel's plan for n samples of a model of ``dims`` =
    (h, w, n_blocks, n_rb, C, C2, d_k, d_v).

    ``max_clusters_for(cluster, smem, samples)`` is how many clusters of
    ``cluster`` CTAs the card holds at once at ``smem`` bytes a CTA, for the
    kernel instance of ``samples`` a group (cudaOccupancyMaxActiveClusters
    on the card); ``smem_for(cluster, samples, stage, depth)`` is the
    dynamic shared memory such a CTA takes (the kernel's
    ``snail_loop_smem_bytes``; a stage of 0 gives what the rest takes).

    A cluster size must split C in units of 4 channels. A ring stage holds
    the largest piece a rank streams (``_piece_shapes``), or as many of its
    rows as fit but at least ``MIN_STAGE`` floats (or the largest piece):
    every chunk costs the chain a CTA barrier, so smaller stages do not
    pay; that least stage is tried too, for the CTAs an SM may then hold.
    Of every (cluster, samples, depth) that fits, the plan takes the
    fewest waves of clusters (a cluster serves groups in turn), then the
    fewest samples a group (every product and the attention pass grow with
    them, while clusters at once cost nothing), then the cluster size
    first in ``clusters``, the fewer chunks a position, the deeper ring
    (more bytes in flight). It never plans more clusters than
    ``max_clusters_for`` gives; it raises a ValueError where nothing fits.
    A stage of 0 in ``smem_for`` stands for a ring of none whose table
    lists every piece as one chunk.
    """
    if n < 1:
        raise ValueError(f"n = {n}: the sampler needs at least one sample")
    check_dims(dims)
    best, best_key = None, None
    for pref, cluster in enumerate(clusters):
        if dims[4] % (4 * cluster):
            continue
        shapes = _piece_shapes(dims, cluster)
        widest = max(j for _, j in shapes)
        largest = _up4(max(k * j for k, j in shapes))
        if widest > MAX_COLS:
            continue
        least = max(widest, min(largest, MIN_STAGE))
        for samples in range(1, min(n, MAX_SAMPLES) + 1):
            fitted = False
            for depth in DEPTHS:
                room = (smem_limit - smem_for(cluster, samples, 0, depth)) // (4 * depth)
                # The largest stage that fits (fewest chunks), and the least
                # (the most CTAs an SM holds).
                for stage in {min(largest, room // 4 * 4), least}:
                    if stage < least:
                        continue
                    smem = smem_for(cluster, samples, stage, depth)
                    if smem > smem_limit:  # more chunks, a longer table: a smaller stage
                        stage -= -(-(smem - smem_limit) // (16 * depth)) * 4
                        if stage < least:
                            continue
                        smem = smem_for(cluster, samples, stage, depth)
                        if smem > smem_limit:
                            continue
                    cap = max_clusters_for(cluster, smem, samples)
                    if cap < 1:
                        continue
                    fitted = True
                    groups = -(-n // samples)
                    plan = SnailPlan(cluster, min(cap, groups), samples, groups, stage, depth,
                                     smem)
                    key = (-(-groups // plan.clusters), samples, pref,
                           chunks_per_position(dims, cluster, stage), -depth)
                    if best_key is None or key < best_key:
                        best, best_key = plan, key
            if not fitted:
                break
    if best is None:
        raise ValueError(f"{KERNEL} has no plan for dims {dims}: no cluster of {clusters} CTAs "
                         f"fits in {smem_limit} bytes of shared memory a CTA")
    return best


def chunks_per_position(dims, cluster, stage):
    """Ring chunks a rank takes a position: each piece in chunks of as many
    whole rows as a stage holds (the kernel's ``stream_shape``)."""
    n_blocks, n_rb = dims[2], dims[3]
    chunks = [-(-k // min(k, stage // j)) for k, j in _piece_shapes(dims, cluster)]
    return n_blocks * (n_rb * (chunks[0] + chunks[1]) + sum(chunks[2:7])) + chunks[7]


def _up4(v):
    return (v + 3) & ~3


def occupancy(samples, cluster, smem):
    """(cudaOccupancyMaxActiveClusters, registers a thread) of the kernel
    instance for ``samples`` a group at ``cluster`` CTAs a cluster and
    ``smem`` bytes a CTA, on the current device."""
    clusters, regs = ctypes.c_int(), ctypes.c_int()
    err = _lib().snail_loop_occupancy(samples, cluster, smem, ctypes.byref(clusters),
                                      ctypes.byref(regs))
    _build.check(err, "snail_loop_occupancy")
    return clusters.value, regs.value


_max_clusters: dict = {}
_plans: dict = {}


def check_snail_loop(canvas0, uniforms, weights, h, w):
    """Raises unless the operands are what the whole-loop kernel takes:
    contiguous float32 on canvas0's device, of matching shapes, a 1-channel
    model, the weights it streams 16 bytes at a time (``SNAIL_LOOP_ALIGNED``)
    starting on a 16-byte boundary; returns n and the plan's dims (h, w,
    n_blocks, n_rb, C, C2, d_k, d_v)."""
    lp, n = canvas0.shape
    nb, nr, c, c2, d_k, d_v, c_in, c_out = _dims(weights)
    if (c_in, c_out) != (1, 1):
        raise ValueError(f"{KERNEL} samples 1-channel images, got {c_in} in, {c_out} out")
    expected = _weight_shapes(weights)
    expected.update(canvas0=((h + 2) * (w + 2), n), uniforms=(h * w, n, 1))
    operands = dict(weights, canvas0=canvas0, uniforms=uniforms)
    for k in ("canvas0", "uniforms", *WEIGHT_ORDER):
        _build.check_tensor(k, operands[k], expected[k], canvas0.device, KERNEL,
                            aligned=k in SNAIL_LOOP_ALIGNED)
    return n, (h, w, nb, nr, c, c2, d_k, d_v)


def plan_for(canvas0, uniforms, weights, h, w):
    """``snail_plan`` for these operands on their card."""
    n, dims = check_snail_loop(canvas0, uniforms, weights, h, w)
    return _card_plan(n, dims, canvas0.device)


def _card_plan(n, dims, dev):
    key = (dev, n, dims, CLUSTERS, DEPTHS)
    if key not in _plans:
        _plans[key] = _search_plan(n, dims, dev)
    return _plans[key]


def _search_plan(n, dims, dev):
    def max_clusters_for(cluster, smem, samples):
        key = (dev, cluster, smem, samples)
        if key not in _max_clusters:
            with torch.cuda.device(dev):
                _max_clusters[key] = occupancy(samples, cluster, smem)[0]
        return _max_clusters[key]

    def smem_for(cluster, samples, stage, depth):
        return _lib().snail_loop_smem_bytes(*dims, cluster, samples, stage, depth)

    static = ctypes.c_int()
    with torch.cuda.device(dev):
        # The instances share their static shared memory (the feed).
        _build.check(_lib().snail_loop_static_smem_bytes(1, ctypes.byref(static)),
                     "snail_loop_static_smem_bytes")
    return snail_plan(n, dims, max_clusters_for, smem_for, HOPPER_SMEM - static.value,
                      CLUSTERS)


def _snail_loop_cuda(canvas0, uniforms, weights, h, w):
    global launches
    n, dims = check_snail_loop(canvas0, uniforms, weights, h, w)
    _, _, nb, nr, c, c2, d_k, d_v = dims
    dev = canvas0.device
    plan = _card_plan(n, dims, dev)
    canvas = torch.empty_like(canvas0)
    # The K/V cache, laid out as each rank reads it: rank r's positions l = r
    # (mod cluster) of every sample and block side by side.
    kv = torch.empty((n, nb, plan.cluster, -(-(h * w) // plan.cluster), d_k + d_v), device=dev)
    # The convs' taps 0 and 1 a row ahead, and each rank's weights packed in
    # the order its ring takes them.
    taps = torch.empty(n * _lib().snail_loop_taps_floats(w, nb, nr, c), device=dev)
    packed = torch.empty(_lib().snail_loop_stream_floats(*dims, plan.cluster), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().snail_loop_f32(
            canvas0.data_ptr(), uniforms.data_ptr(), canvas.data_ptr(), kv.data_ptr(),
            taps.data_ptr(), packed.data_ptr(),
            *[weights[k].data_ptr() for k in WEIGHT_ORDER],
            n, h, w, nb, nr, c, c2, d_k, d_v, plan.cluster, plan.clusters, plan.samples,
            plan.groups, plan.stage, plan.depth, stream)
    _build.check(err, "snail_loop_f32")
    launches += 1
    return canvas


def fused_snail_sample_loop(canvas0, uniforms, weights, h, w):
    """Runs the whole PixelSNAIL raster scan of a 1-channel model.

    Args:
        canvas0: (Hp*Wp, N) float32, the zero-padded raw canvas in (position,
            batch) layout; values < 0 are sampled, pixels >= 0 kept.
        uniforms: (H*W, N, 1) float32 per-position uniform draws.
        weights: ``stack_pixel_snail_weights(model)``.
        h, w: the image size.
    Returns:
        (Hp*Wp, N) float32 final canvas; sampled pixels are exact 0.0 or 1.0.
    """
    return _build.dispatch(_snail_loop_cuda, snail_sample_loop_plain, canvas0, uniforms,
                           weights, h, w)
