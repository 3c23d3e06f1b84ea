"""Fast ImageGPT and PixelSNAIL sampling (counterpart of the ImageGPT and
PixelSNAIL parts of ``pytorch_generative_tpu/ops/sampling.py``).

ImageGPT:

Per raster position only the new position's activations are computed: the
masked input conv on its patch, attention over cached K/V, the MLP and
LayerNorms on one position. Two routes, chosen as the JAX package chooses
on its accelerator (``sample_route``):

- the whole loop, ``decode_cuda.fused_sample_loop``: the entire scan in one
  kernel, for 1-channel models with the default ``sample_fn``, a float32
  cache and a JAX batch tile of at least 8 (``_sample_loop_tile``);
- otherwise the step route: per position one ``decode_cuda.
  fused_decode_step`` (the whole block stack, float32 or bfloat16 K/V
  cache, which it writes at the position) between a few PyTorch ops (conv
  taps, head, draw, inpainting merge), for any model and any n. The
  position lives in a device counter (``StepRoute``), so on the card one
  position is captured as a CUDA graph and replayed at every position;
  ``model.sample_fn`` must therefore be capturable (no synchronisation
  with the host), as the JAX package traces it inside ``lax.scan``.

PixelSNAIL (``pixel_snail_sample_route``): the whole-loop kernel
``snail_decode_cuda.fused_snail_sample_loop`` for a 1-channel model with the
default ``sample_fn``, at any n; ``pixel_snail_sample_fast``, the
incremental sampler in PyTorch, for any other model.

On the card each route runs its kernel; on the CPU its plain version.
Uniforms are (H*W, N, C), so the port can be fed the JAX package's draws.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.nn.functional as F

from pytorch_generative_tpu_torch.ops import decode_cuda, snail_decode_cuda

LOOP_ROUTE = "loop"
STEP_ROUTE = "step"
INCREMENTAL_ROUTE = "incremental"


def _loop_eligible(model, head) -> bool:
    """The whole-loop kernels cover 1-channel images in and out (``head`` is
    the model's last 1x1 conv), a 3x3/pad-1 type-A input conv and the
    default Bernoulli ``sample_fn`` (they draw ``u < sigmoid(logit)``): the
    JAX package's rule."""
    from pytorch_generative_tpu_torch.models.base import _default_sample_fn

    _, _, c = model.in_shape
    conv = model.input_conv
    return (c == 1
            and head.weight.shape[-1] == 1
            and model.sample_fn is _default_sample_fn
            and tuple(conv.weight.shape[1:]) == (1, 3, 3)
            and conv.padding == (1, 1))


def _whole_loop_eligible(model) -> bool:
    """Whether an ImageGPT's shape is the whole-loop kernel's."""
    return _loop_eligible(model, model.out_conv)


def _sample_loop_tile(model, n, cache_dtype):
    """The JAX package's batch tile for its whole-loop kernel: the largest
    divisor-by-halving of n whose working set stays under 56 MB, or None.

    The 56 MB is the TPU kernel's VMEM budget: the K/V cache (linear in the
    tile), the MXU selector masks (quadratic in the tile) and the tiled
    output projection. The card has no such budget; the rule is kept so
    that both packages take the same route for the same (model, n, cache
    dtype).
    """
    h, w, _ = model.in_shape
    attn = model.blocks[0].attn
    c_k, c_v = attn.embed_channels, attn.out_channels
    n_heads = attn.n_heads
    n_blocks = len(model.blocks)
    per_row = n_blocks * h * w * (c_k + c_v) * cache_dtype.itemsize

    def working_set(tile):
        sel = tile * tile * (c_k + 2 * c_v + c_k * n_heads + n_heads * c_v) * 4
        return tile * per_row + sel + n_blocks * tile * c_v * c_v * 4

    budget = 56 * 1024 * 1024
    tile = n
    while tile > 1 and (working_set(tile) > budget or n % tile != 0):
        tile //= 2
    return tile if working_set(tile) <= budget and n % tile == 0 else None


def _check_no_fused_decode():
    """``PGT_NO_FUSED_DECODE=1`` sends the JAX package's samplers to its XLA
    scan, a route of the TPU's alone: on the card its counterpart would be a
    plain PyTorch sampler standing in for the kernels, so it raises."""
    if os.environ.get("PGT_NO_FUSED_DECODE") == "1":
        raise ValueError(
            "PGT_NO_FUSED_DECODE=1: the port samples on its decode kernels only; no "
            "kernel-free sampler route is ported (ROADMAP.md A.13)")


def sample_route(model, n, cache_dtype=torch.float32) -> str:
    """``LOOP_ROUTE`` where the JAX package runs its whole-loop kernel (an
    eligible model, a float32 cache, a tile >= 8, and ``PGT_SAMPLE_LOOP``
    not "0"), else ``STEP_ROUTE``. The switches are read at every call, as
    the JAX package reads them; ``PGT_NO_FUSED_DECODE=1`` raises a
    ValueError."""
    if cache_dtype not in decode_cuda.CACHE_DTYPES:
        raise ValueError(f"cache_dtype must be one of {decode_cuda.CACHE_DTYPES}, "
                         f"got {cache_dtype}")
    _check_no_fused_decode()
    if (os.environ.get("PGT_SAMPLE_LOOP", "1") != "0" and cache_dtype == torch.float32
            and _whole_loop_eligible(model)):
        tile = _sample_loop_tile(model, n, cache_dtype)
        if tile is not None and tile >= 8:
            return LOOP_ROUTE
    return STEP_ROUTE


def sample_loop_inputs(model, conditioned_on, uniforms):
    """The arguments of ``decode_cuda.fused_sample_loop`` for (N, H, W, 1)
    ``conditioned_on`` and (H*W, N, 1) uniforms: the zero-padded canvas and
    positional embedding flattened to (Hp*Wp, N) and (Hp*Wp, 1), the
    stacked weights, the head count and the image size."""
    n, h, w, _ = conditioned_on.shape
    pos_col = F.pad(model.pos.detach()[0, :, :, 0], (1, 1, 1, 1)).reshape(-1, 1)
    canvas0 = F.pad(conditioned_on[..., 0], (1, 1, 1, 1)).reshape(n, -1).T
    return (canvas0.contiguous(), pos_col.contiguous(), uniforms.contiguous(),
            decode_cuda.stack_image_gpt_weights(model),
            model.blocks[0].attn.n_heads, h, w)


def canvas_to_images(canvas, h, w):
    """(Hp*Wp, N) padded canvas -> (N, H, W, 1) images."""
    return canvas.T.reshape(-1, h + 2, w + 2, 1)[:, 1:-1, 1:-1, :]


def _image_gpt_sample_loop(model, conditioned_on, uniforms):
    """Whole-raster-scan sampling of (N, H, W, 1) ``conditioned_on`` with the
    given (H*W, N, 1) uniforms."""
    _, h, w, _ = conditioned_on.shape
    out = decode_cuda.fused_sample_loop(
        *sample_loop_inputs(model, conditioned_on, uniforms))
    return canvas_to_images(out, h, w)


_NOT_CAPTURABLE = (
    "the step route captures one raster position as a CUDA graph and replays it: the "
    "position's body, model.sample_fn included, must run on the device without "
    "synchronising with the host (no .item(), bool() or other host read of a device "
    "value), as the JAX package's sample_fn is traced inside lax.scan")


class StepRoute:
    """One call of the step route: its state, and the body of one raster
    position, which reads the position from a device counter (the JAX
    package's ``lax.scan`` over ``_image_gpt_decode_fused``'s step, whose
    kernel reads ``i`` from SMEM).

    ``body()`` decodes the position held in ``i`` (a 0-dim int32 tensor on
    the canvas's device) and advances it: the masked input conv on the
    position's patch of the canvas plus the positional embedding, gathered
    by device indices; ``step`` (the block stack, which writes its k|v into
    the cache at i); the ``out_conv`` head; ``model.sample_fn(uniforms[i],
    logits)``; the inpainting merge at a device index (pixels >= 0 kept);
    ``i += 1``. No host value depends on the position, so on the card one
    captured body serves every position (``run_graph``); ``run_eager``
    runs it as it is, once a position.
    """

    def __init__(self, model, conditioned_on, uniforms, cache_dtype,
                 step=decode_cuda.fused_decode_step):
        n, h, w, c = conditioned_on.shape
        dev = conditioned_on.device
        conv = model.input_conv
        _, cin, kh, kw = conv.weight.shape
        ph, pw = conv.padding
        pad = (0, 0, pw, pw, ph, ph)
        hp, wp = h + 2 * ph, w + 2 * pw
        self.size, self.pad, self.step = (h, w), (ph, pw), step
        self.canvas = F.pad(conditioned_on, pad)
        self._flat = self.canvas.view(n, hp * wp, c)
        self._pos = F.pad(model.pos.detach(), pad).reshape(1, hp * wp, cin)
        # Per position: the flat canvas indices of the conv's patch, in the
        # (kh, kw) order of its weight's rows, and of the pixel it samples.
        p = torch.arange(h * w)
        origin = (p // w) * wp + p % w
        patch = (torch.arange(kh)[:, None] * wp + torch.arange(kw)).reshape(-1)
        self._taps = (origin[:, None] + patch).to(dev)
        self._at = (origin + ph * wp + pw).to(dev)
        # Masked once, in the (kh * kw * Cin, Cout) layout of the patch.
        self._conv_w = ((conv.weight * conv.mask).detach().permute(2, 3, 1, 0)
                        .reshape(kh * kw * cin, -1).contiguous())
        self._conv_b = conv.bias.detach()
        self._head_w = model.out_conv.weight.detach()
        self._head_b = model.out_conv.bias.detach()
        self._sample_fn = model.sample_fn
        self._uniforms = uniforms
        self.weights = decode_cuda.stack_image_gpt_weights(model)
        attn = model.blocks[0].attn
        self.n_heads = attn.n_heads
        self.kv_cache = torch.zeros(
            (len(model.blocks), n, h * w, attn.embed_channels + attn.out_channels),
            dtype=cache_dtype, device=dev)
        self.i = torch.zeros((), dtype=torch.int32, device=dev)

    def body(self):
        n, _, c = self._flat.shape
        at = self.i.view(1)
        taps = self._taps.index_select(0, at).view(-1)
        patch = self._flat.index_select(1, taps) + self._pos.index_select(1, taps)
        x = torch.addmm(self._conv_b, patch.reshape(n, -1), self._conv_w)
        act, _ = self.step(self.i, x, self.kv_cache, self.weights, self.n_heads)
        logits = act @ self._head_w + self._head_b
        sampled = self._sample_fn(self._uniforms.index_select(0, at)[0], logits)
        pixel = self._at.index_select(0, at)
        current = self._flat.index_select(1, pixel)
        merged = torch.where(current < 0, sampled.reshape(n, 1, c), current)
        self._flat.index_copy_(1, pixel, merged)
        self.i += 1

    def run_eager(self):
        h, w = self.size
        for _ in range(h * w):
            self.body()

    def capture(self):
        """Decodes the first position on a side stream (the warm-up: the
        kernel's build, the libraries' workspaces), then captures one
        position into a ``decode_cuda.StepGraph`` and returns it; each
        replay decodes the next position (and counts the step launches its
        capture recorded). The warm-up runs with PyTorch's synchronisation
        check set to raise, so that a body that synchronises with the host
        (a ``sample_fn`` that reads a device value) raises before any
        capture begins; a capture that fails for another reason raises
        too."""
        dev = self.canvas.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        previous = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side), warnings.catch_warnings():
            # PyTorch warns that the check is a prototype at every switch.
            warnings.filterwarnings("ignore", message="Synchronization debug mode")
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.body()
            except RuntimeError as err:
                raise RuntimeError(_NOT_CAPTURABLE) from err
            finally:
                torch.cuda.set_sync_debug_mode(previous)
        graph = decode_cuda.StepGraph()
        try:
            with torch.cuda.stream(side), graph.capture():
                self.body()
        except RuntimeError as err:
            raise RuntimeError(_NOT_CAPTURABLE) from err
        torch.cuda.current_stream(dev).wait_stream(side)
        return graph

    def run_graph(self):
        """All positions: the first by the warm-up, the rest by replays of
        one captured position."""
        h, w = self.size
        if h * w == 1:
            self.body()
            return
        graph = self.capture()
        for _ in range(h * w - 1):
            graph.replay()

    def images(self):
        (h, w), (ph, pw) = self.size, self.pad
        return self.canvas[:, ph:ph + h, pw:pw + w]


def _image_gpt_decode_step(model, conditioned_on, uniforms, cache_dtype, step=None):
    """KV-cache decoding with one step per position (the JAX package's
    ``_image_gpt_decode_fused``) for (N, H, W, C) ``conditioned_on`` and
    (H*W, N, C) uniforms, by ``StepRoute``'s body.

    Without ``step``, the body runs ``decode_cuda.fused_decode_step``: on
    the card as one CUDA graph replayed a position, on the CPU eagerly.
    A given ``step`` (e.g. the kernel's plain version, to compare with)
    takes the eager body, once a position; it is called as
    ``step(i, x, kv_cache, weights, n_heads)`` with ``i`` the device
    counter.
    """
    route = StepRoute(model, conditioned_on, uniforms, cache_dtype,
                      step or decode_cuda.fused_decode_step)
    if step is None and route.canvas.is_cuda:
        route.run_graph()
    else:
        route.run_eager()
    return route.images()


@torch.no_grad()
def image_gpt_sample_fast(model, n_samples=None, conditioned_on=None, *,
                          generator=None, uniforms=None,
                          cache_dtype=torch.float32):
    """Incremental-decoding sampler for ImageGPT; exact inpainting semantics.

    The route is the JAX package's (``sample_route``): the whole-loop kernel
    for a 1-channel model with the default ``sample_fn``, a float32 cache
    and a batch tile of at least 8 (n = 16 at the reproduce() config);
    otherwise one step kernel per position (any n at C = 512, small n, a
    bfloat16 cache, multi-channel models, a custom ``sample_fn``). On the
    card each route launches its kernel; on the CPU it takes the kernel's
    plain version.

    Args:
        model: An ImageGPT.
        n_samples / conditioned_on: As in ``AutoregressiveModel.sample``.
        generator: ``torch.Generator`` for the uniforms, when not given.
        uniforms: (H*W, N, C) uniforms in [0, 1).
        cache_dtype: ``torch.float32`` or ``torch.bfloat16``, the K/V cache's
            type (the JAX package's ``PGT_DECODE_CACHE_DTYPE``); bfloat16
            takes the step route.
    Returns:
        (N, H, W, C) samples.
    """
    conditioned_on = model._get_conditioned_on(n_samples, conditioned_on)
    n, h, w, c = conditioned_on.shape
    route = sample_route(model, n, cache_dtype)
    uniforms = model._get_uniforms((h * w, n, c), generator, uniforms)
    if route == LOOP_ROUTE:
        return _image_gpt_sample_loop(model, conditioned_on.float(), uniforms)
    return _image_gpt_decode_step(model, conditioned_on.float(), uniforms, cache_dtype)


# ---- PixelSNAIL ----------------------------------------------------------

def _snail_loop_eligible(model) -> bool:
    """Whether a PixelSNAIL's shape is the whole-loop kernel's."""
    return _loop_eligible(model, model.output_conv2)


def pixel_snail_sample_route(model, n) -> str:
    """``LOOP_ROUTE`` for an eligible model at every ``n``, else
    ``INCREMENTAL_ROUTE``.

    This departs from the JAX package, which also sends an eligible model
    to its XLA scan when its batch takes more than two tiles
    (``n // tile > 2``, e.g. n = 256). That rule comes from the TPU: the
    tile is what its 72 MB VMEM budget holds, and the crossover was
    measured there. The card has neither: the kernel keeps its caches in
    device memory and takes any n in one launch, so on the card the
    kernel's plain version never serves an eligible model. ``n`` is kept
    in the signature for that reason: the route does not depend on it.

    ``PGT_SAMPLE_LOOP=0`` and ``PGT_NO_FUSED_DECODE=1`` (read at every
    call) both raise a ValueError: in the JAX package both send PixelSNAIL
    to its XLA scan, whose counterpart on the card would be the kernel's
    plain version standing in for it.
    """
    del n
    _check_no_fused_decode()
    if os.environ.get("PGT_SAMPLE_LOOP", "1") == "0":
        raise ValueError(
            "PGT_SAMPLE_LOOP=0: PixelSNAIL samples on its whole-loop kernel only; no "
            "kernel-free sampler route is ported (ROADMAP.md A.13)")
    return LOOP_ROUTE if _snail_loop_eligible(model) else INCREMENTAL_ROUTE


def snail_loop_inputs(model, conditioned_on, uniforms):
    """The arguments of ``snail_decode_cuda.fused_snail_sample_loop`` for
    (N, H, W, 1) ``conditioned_on`` and (H*W, N, 1) uniforms: the
    zero-padded canvas flattened to (Hp*Wp, N), the uniforms, the stacked
    weights and the image size."""
    n, h, w, _ = conditioned_on.shape
    canvas0 = F.pad(conditioned_on[..., 0], (1, 1, 1, 1)).reshape(n, -1).T
    return (canvas0.contiguous(), uniforms.contiguous(),
            snail_decode_cuda.stack_pixel_snail_weights(model), h, w)


@torch.no_grad()
def pixel_snail_sample_fast(model, n_samples=None, conditioned_on=None, *,
                            generator=None, uniforms=None):
    """Incremental-decoding sampler for PixelSNAIL, in PyTorch, for any
    channel count and ``sample_fn`` (``snail_decode_cuda.snail_decode``):
    per-(block, residual block) elu and mid caches for the 2x2 convs and
    per-block K/V caches; pixel i's k/v are appended after pixel i is
    merged, since they read it. Exact inpainting semantics: entries >= 0
    of ``conditioned_on`` are kept.

    Args:
        model: A PixelSNAIL.
        n_samples / conditioned_on: As in ``AutoregressiveModel.sample``.
        generator: ``torch.Generator`` for the uniforms, when not given.
        uniforms: (H*W, N, C) uniforms in [0, 1).
    Returns:
        (N, H, W, C) samples.
    """
    conditioned_on = model._get_conditioned_on(n_samples, conditioned_on)
    n, h, w, c = conditioned_on.shape
    uniforms = model._get_uniforms((h * w, n, c), generator, uniforms)
    canvas = F.pad(conditioned_on.float(), (0, 0, 1, 1, 1, 1))
    canvas = snail_decode_cuda.snail_decode(
        canvas, uniforms, snail_decode_cuda.stack_pixel_snail_weights(model), h, w,
        model.sample_fn)
    return canvas[:, 1:-1, 1:-1]


@torch.no_grad()
def pixel_snail_sample(model, n_samples=None, conditioned_on=None, *,
                       generator=None, uniforms=None):
    """PixelSNAIL sampling on ``pixel_snail_sample_route``'s route: the
    whole-loop kernel (its plain version on the CPU) for an eligible model,
    ``pixel_snail_sample_fast`` for any other. Arguments and result as in
    ``pixel_snail_sample_fast``."""
    conditioned_on = model._get_conditioned_on(n_samples, conditioned_on)
    n, h, w, c = conditioned_on.shape
    if pixel_snail_sample_route(model, n) == INCREMENTAL_ROUTE:
        return pixel_snail_sample_fast(model, conditioned_on=conditioned_on,
                                       generator=generator, uniforms=uniforms)
    uniforms = model._get_uniforms((h * w, n, c), generator, uniforms)
    out = snail_decode_cuda.fused_snail_sample_loop(
        *snail_loop_inputs(model, conditioned_on.float(), uniforms))
    return canvas_to_images(out, h, w)
