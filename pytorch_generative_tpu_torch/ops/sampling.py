"""Fast ImageGPT sampling (counterpart of the ImageGPT part of
``pytorch_generative_tpu/ops/sampling.py``).

Per raster position only the new position's activations are computed: the
masked input conv on its 4 live taps, attention over cached K/V, the MLP and
LayerNorms on one position. The whole scan is one call of
``decode_cuda.fused_sample_loop``: the CUDA kernel on the card, its plain
KV-cache decoder (the JAX package's ``_image_gpt_decode``) on the CPU.
Uniforms are (H*W, N, 1), so the port can be fed the JAX package's draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_generative_tpu_torch.ops import decode_cuda


def _whole_loop_eligible(model) -> bool:
    """The sampler handles the common ImageGPT shape: 1-channel images, a
    3x3/pad-1 type-A input conv and the default Bernoulli ``sample_fn`` (the
    kernel draws ``u < sigmoid(logit)``)."""
    from pytorch_generative_tpu_torch.models.base import _default_sample_fn

    _, _, c = model.in_shape
    conv = model.input_conv
    return (c == 1
            and model.out_conv.weight.shape[-1] == 1
            and model.sample_fn is _default_sample_fn
            and tuple(conv.weight.shape[1:]) == (1, 3, 3)
            and conv.padding == (1, 1))


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


@torch.no_grad()
def image_gpt_sample_fast(model, n_samples=None, conditioned_on=None, *,
                          generator=None, uniforms=None):
    """Incremental-decoding sampler for ImageGPT; exact inpainting semantics.

    Args:
        model: An ImageGPT.
        n_samples / conditioned_on: As in ``AutoregressiveModel.sample``.
        generator: ``torch.Generator`` for the uniforms, when not given.
        uniforms: (H*W, N, 1) uniforms in [0, 1).
    Returns:
        (N, H, W, 1) samples.
    Raises:
        NotImplementedError: on CUDA, for a model the sampler kernel does not
            cover (multi-channel input or a custom ``sample_fn``). On the CPU
            such a model takes the generic raster sampler.
    """
    conditioned_on = model._get_conditioned_on(n_samples, conditioned_on)
    n, h, w, c = conditioned_on.shape
    if not _whole_loop_eligible(model):
        if conditioned_on.is_cuda:
            raise NotImplementedError(
                "the CUDA ImageGPT sampler covers 1-channel images with the "
                "default sample_fn only")
        return model.sample_naive(conditioned_on=conditioned_on,
                                  generator=generator, uniforms=uniforms)
    uniforms = model._get_uniforms((h * w, n, c), generator, uniforms)
    return _image_gpt_sample_loop(model, conditioned_on.float(), uniforms)
