"""Every width that the JAX package's configs and ``bench.py`` build passes the
port's kernel-wrapper checks, and a width still left out raises naming what
the kernels take. The checks run on ``meta`` tensors: they read shapes,
strides and dtypes only, so nothing is allocated and no kernel is needed.
"""

import pytest
import torch

from pytorch_generative_tpu_torch.ops import attention_cuda, ln_cuda, mlp_cuda


def _meta(*shape):
    return torch.empty(shape, device="meta")


# (C, heads, d_k, d_v): ImageGPT reproduce() (C = 64, 2 heads), bench.py's
# C = 512 models with 8 heads (LARGE_CONFIG) and with 4 heads (bench.py's
# _make_imagegpt(0, n_channels=512, n_heads=4)), PixelSNAIL reproduce()
# (one head, d_k 4, d_v 32).
ATTENTION = [(64, 2, 32, 32), (512, 8, 64, 64), (512, 4, 128, 128), (None, 1, 4, 32)]


@pytest.mark.parametrize("c,heads,d_k,d_v", ATTENTION,
                         ids=["imagegpt", "large_8_heads", "large_4_heads", "pixel_snail"])
def test_flash_takes_every_head_width_the_configs_build(c, heads, d_k, d_v):
    q = _meta(2, 784, heads * d_k)
    v = _meta(2, 784, heads * d_v)
    assert attention_cuda._check_operands(heads, q=q, k=q, v=v, out=v, dout=v) == (d_k, d_v)


# C of the fused LayerNorm and MLP: LARGE_CONFIG's 512 and two more widths
# that ImageGPT's C % 128 == 0 gate routes to the kernels.
@pytest.mark.parametrize("c", [512, 640, 1024])
def test_ln_and_mlp_take_every_routed_width(c):
    x = _meta(1024, c)
    assert ln_cuda.check_rows(x) == (1024, c)
    f = 4 * c
    assert mlp_cuda._check(mlp_cuda.KERNEL, x, _meta(c, f), gamma=_meta(c), beta=_meta(c),
                           b1=_meta(f), w2=_meta(f, c), b2=_meta(c)) == (1024, c, f)


def test_widths_left_out_raise_naming_what_is_taken():
    q = _meta(2, 64, 64)
    with pytest.raises(ValueError, match=r"not one of .*\(128, 128\)"):
        attention_cuda._check_operands(8, q=q, k=q, v=q)  # (8, 8)
    for c in (ln_cuda.MAX_CHANNELS + 4, 6):
        with pytest.raises(ValueError, match=f"from 4 to {ln_cuda.MAX_CHANNELS}"):
            ln_cuda.check_rows(_meta(1024, c))
    assert ln_cuda.MAX_CHANNELS >= 2048
