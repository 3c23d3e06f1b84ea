"""The step route with the position on the device, on the CPU.

``decode_cuda.fused_decode_step`` takes the position as a Python int or as a
0-dim int32 tensor (the JAX kernel's ``i_ref``), so that on the card one
captured position serves every position. Here: its plain version at a
tensor position against an int position and the JAX Pallas step kernel in
interpret mode; and ``sampling.StepRoute``'s body, run eagerly with
tensor positions, against a loop over int positions written out in the
test. The kernel's attention split over key chunks is held against the
plain version on the card (``test_torch_kernels.py``, at the chunk edges).
Inputs come from numpy seeds; each case states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_generative_tpu import models as jmodels
from pytorch_generative_tpu.ops import decode_pallas
from pytorch_generative_tpu_torch import convert
from pytorch_generative_tpu_torch.models import ImageGPT
from pytorch_generative_tpu_torch.ops import decode_cuda, sampling

TINY = dict(in_channels=1, out_channels=1, in_size=6, n_transformer_blocks=2,
            n_attention_heads=2, n_embedding_channels=16, in_shape=(6, 6, 1))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores: keep
    torch's CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(config, seed=0):
    """A seeded JAX ImageGPT with a non-zero positional embedding and the
    port's model with its weights."""
    jm = jmodels.ImageGPT(jax.random.PRNGKey(seed), **config)
    jm = jm.replace(pos=jax.random.normal(jax.random.PRNGKey(seed + 1), jm.pos.shape) * 0.1)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jm)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}
    tm = ImageGPT(**config, device="cpu")
    tm.load_state_dict(convert.from_jax_params(flat))
    return jm, tm.eval()


def test_plain_step_at_a_tensor_position_matches_int_and_the_jax_kernel():
    """decode_step_plain at a 0-dim int32 tensor i gives the int i's act and
    cache bit for bit, and the JAX kernel's act and kv_new (interpret mode)
    within 1e-5, with junk x 100 in cache positions >= i; fused_decode_step
    on CPU tensors takes the plain version for a tensor i too."""
    jm, tm = _port(TINY)
    rng = np.random.default_rng(3)
    attn = jm.blocks[0].attn
    n, n_heads = 3, attn.n_heads
    d_k, d_v = attn.embed_channels // n_heads, attn.out_channels // n_heads
    seq = 36
    x = rng.standard_normal((n, attn.embed_channels)).astype(np.float32)
    cache = rng.standard_normal(
        (len(jm.blocks), n, seq, attn.embed_channels + attn.out_channels)).astype(np.float32)
    weights = decode_cuda.stack_image_gpt_weights(tm)
    for i in (0, 17):
        junk = cache.copy()
        junk[:, :, i:] *= 100.0
        c_int, c_tensor, c_fused = (torch.from_numpy(junk.copy()) for _ in range(3))
        act, kv = decode_cuda.decode_step_plain(i, torch.from_numpy(x), c_int, weights, n_heads)
        pos = torch.tensor(i, dtype=torch.int32)
        act_t, kv_t = decode_cuda.decode_step_plain(pos, torch.from_numpy(x), c_tensor, weights,
                                                    n_heads)
        before = decode_cuda.step_launches
        act_f, _ = decode_cuda.fused_decode_step(pos, torch.from_numpy(x), c_fused, weights,
                                                 n_heads)
        assert decode_cuda.step_launches == before
        assert torch.equal(act, act_t) and torch.equal(kv, kv_t) and torch.equal(act, act_f)
        assert torch.equal(c_int, c_tensor) and torch.equal(c_int, c_fused)
        want_act, want_kv = decode_pallas.fused_decode_step(
            jnp.int32(i), jnp.asarray(x), jnp.asarray(junk),
            decode_pallas.stack_image_gpt_weights(jm), n_heads, d_k, d_v, window=seq,
            interpret=True)
        np.testing.assert_allclose(act_t.numpy(), np.asarray(want_act), rtol=0, atol=1e-5)
        np.testing.assert_allclose(kv_t.numpy(), np.asarray(want_kv), rtol=0, atol=1e-5)


def test_a_tensor_position_must_be_a_0_dim_int32_tensor_on_the_device():
    dev = torch.device("cpu")
    assert decode_cuda._check_position(3, 10, dev) == (None, 3)
    for bad in (torch.tensor(3), torch.tensor([3], dtype=torch.int32),
                torch.tensor(3, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError):
            decode_cuda._check_position(bad, 10, dev)
    with pytest.raises(ValueError):
        decode_cuda._check_position(10, 10, dev)


def _int_position_route(model, cond, uniforms):
    """The step route as a loop over int positions, each position's patch
    cut by Python row and column: the reference for the body that reads
    the position from a device tensor."""
    n, h, w, c = cond.shape
    conv = model.input_conv
    ph, pw = conv.padding
    pad = (0, 0, pw, pw, ph, ph)
    canvas = F.pad(cond, pad)
    pos = F.pad(model.pos.detach(), pad)
    conv_w = (conv.weight * conv.mask).detach().permute(2, 3, 1, 0).contiguous()
    kh, kw, cin, cout = conv_w.shape
    weights = decode_cuda.stack_image_gpt_weights(model)
    attn = model.blocks[0].attn
    cache = torch.zeros((len(model.blocks), n, h * w, attn.embed_channels + attn.out_channels))
    for i in range(h * w):
        row, col = divmod(i, w)
        window = (slice(None), slice(row, row + kh), slice(col, col + kw))
        patch = (canvas[window] + pos[window]).reshape(-1, kh * kw * cin)
        x = torch.addmm(conv.bias.detach(), patch, conv_w.reshape(kh * kw * cin, cout))
        act, _ = decode_cuda.decode_step_plain(i, x, cache, weights, attn.n_heads)
        logits = act @ model.out_conv.weight.detach() + model.out_conv.bias.detach()
        sampled = model.sample_fn(uniforms[i], logits).reshape(n, c)
        current = canvas[:, row + ph, col + pw]
        canvas[:, row + ph, col + pw] = torch.where(current < 0, sampled, current)
    return canvas[:, ph:ph + h, pw:pw + w]


@pytest.mark.parametrize("inpaint", [False, True])
def test_route_body_at_device_positions_matches_the_int_position_loop(inpaint):
    """StepRoute's body, run eagerly with the position in a 0-dim tensor
    (what the card captures once and replays), gives the int-position
    loop's pixels, and _image_gpt_decode_step (the same body on the CPU)
    does too; the counter ends at H*W."""
    _, tm = _port(TINY)
    n, (h, w, _) = 3, TINY["in_shape"]
    rng = np.random.default_rng(5)
    cond = -np.ones((n, h, w, 1), np.float32)
    if inpaint:
        cond[:, : h // 2] = (rng.random((n, h // 2, w, 1)) < 0.4).astype(np.float32)
    u = torch.from_numpy(rng.random((h * w, n, 1)).astype(np.float32))
    cond = torch.from_numpy(cond)
    with torch.no_grad():
        want = _int_position_route(tm, cond, u)
        route = sampling.StepRoute(tm, cond, u, torch.float32)
        route.run_eager()
        got = sampling._image_gpt_decode_step(tm, cond, u, torch.float32)
    assert int(route.i) == h * w
    torch.testing.assert_close(route.images(), want, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if inpaint:
        torch.testing.assert_close(got[:, : h // 2], cond[:, : h // 2], rtol=0, atol=0)
