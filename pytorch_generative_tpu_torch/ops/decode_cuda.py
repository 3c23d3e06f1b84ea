"""The whole-raster-scan ImageGPT sampler: the CUDA kernel
``csrc/sample_loop.cu``, its plain PyTorch version (the KV-cache decoder)
and its launch count (counterpart of
``pytorch_generative_tpu/ops/decode_pallas.py::fused_sample_loop``).

Layouts follow the JAX package: the canvas is the zero-padded image
flattened to (position, batch), ``(Hp*Wp, N)``, with raw values (markers
< 0 are sampled, pixels >= 0 kept); ``pos_pad`` is the padded positional
embedding ``(Hp*Wp, 1)``; ``uniforms`` are ``(H*W, N, 1)``. A CUDA tensor
launches the kernel, or the wrapper raises; a CPU tensor takes the plain
version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pytorch_generative_tpu_torch.nn.convolution import channel_layer_norm
from pytorch_generative_tpu_torch.ops import _build

KERNEL = "sample_loop"
WEIGHT_ORDER = ("in_w4", "in_b", "head_w", "head_b", "ln1_w", "ln1_b",
                "qkv_w", "qkv_b", "out_w", "out_b", "ln2_w", "ln2_b",
                "mlp1_w", "mlp1_b", "mlp2_w", "mlp2_b", "lnf_w", "lnf_b")

# Kernel launches since the last reset; only _sample_loop_cuda adds to it.
launches = 0


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
    fn = lib.sample_loop_f32
    if fn.argtypes is None:  # 64-bit pointers need declared argtypes
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    return lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the canvas on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the sampler kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _sample_loop_cuda(canvas0, pos_pad, uniforms, weights, n_heads, h, w):
    global launches
    lp, n = canvas0.shape
    seq_len = h * w
    n_blocks, c, c_k, c_v, m = _dims(weights, n_heads)
    if c_k % n_heads or c_v % n_heads:
        raise ValueError(f"widths {c_k}/{c_v} not divisible by {n_heads} heads")
    dev = canvas0.device
    expected = {
        "in_w4": (4, c), "in_b": (c,), "head_w": (c,), "head_b": (1,),
        "ln1_w": (n_blocks, c), "ln1_b": (n_blocks, c),
        "qkv_w": (n_blocks, c, 2 * c_k + c_v), "qkv_b": (n_blocks, 2 * c_k + c_v),
        "out_w": (n_blocks, c_v, c), "out_b": (n_blocks, c),
        "ln2_w": (n_blocks, c), "ln2_b": (n_blocks, c),
        "mlp1_w": (n_blocks, c, m), "mlp1_b": (n_blocks, m),
        "mlp2_w": (n_blocks, m, c), "mlp2_b": (n_blocks, c),
        "lnf_w": (c,), "lnf_b": (c,),
    }
    _check("canvas0", canvas0, ((h + 2) * (w + 2), n), dev)
    _check("pos_pad", pos_pad, (lp, 1), dev)
    _check("uniforms", uniforms, (seq_len, n, 1), dev)
    for k in WEIGHT_ORDER:
        _check(k, weights[k], expected[k], dev)
    canvas = torch.empty_like(canvas0)
    k_cache = torch.empty((n_blocks, n, seq_len, c_k), device=dev)
    v_cache = torch.empty((n_blocks, n, seq_len, c_v), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().sample_loop_f32(
            canvas0.data_ptr(), pos_pad.data_ptr(), uniforms.data_ptr(),
            canvas.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            *[weights[k].data_ptr() for k in WEIGHT_ORDER],
            n, h, w, n_blocks, c, n_heads, c_k // n_heads, c_v // n_heads, m,
            stream)
    _build.check(err, "sample_loop_f32")
    launches += 1
    return canvas


def fused_sample_loop(canvas0, pos_pad, uniforms, weights, n_heads, h, w):
    """Runs the whole raster scan; returns the final (Hp*Wp, N) canvas."""
    if canvas0.is_cuda:
        return _sample_loop_cuda(canvas0, pos_pad, uniforms, weights, n_heads, h, w)
    if canvas0.device.type != "cpu":
        raise ValueError(f"no kernel for device {canvas0.device}")
    return sample_loop_plain(canvas0, pos_pad, uniforms, weights, n_heads, h, w)
