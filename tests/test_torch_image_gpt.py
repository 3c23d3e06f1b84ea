"""The PyTorch port's ImageGPT (forward and sampler) against the JAX package,
on the CPU, through ``convert.from_jax_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_generative_tpu import models as jmodels
from pytorch_generative_tpu.ops import attention_pallas
from pytorch_generative_tpu.ops import sampling as jsampling
from pytorch_generative_tpu_torch import convert
from pytorch_generative_tpu_torch.models import ImageGPT
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt as timage_gpt
from pytorch_generative_tpu_torch.ops import decode_cuda, sampling

TINY = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=3,
            n_attention_heads=2, n_embedding_channels=32, in_shape=(8, 8, 1))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores: keep
    torch's CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_model(config, seed=0, pos_seed=42):
    m = jmodels.ImageGPT(jax.random.PRNGKey(seed), **config)
    # pos is zero-init; randomize it so its handling is exercised.
    return m.replace(pos=jax.random.normal(jax.random.PRNGKey(pos_seed),
                                           m.pos.shape) * 0.1)


def _port(jmodel, config):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jmodel)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}
    model = ImageGPT(**config)
    model.load_state_dict(convert.from_jax_params(flat))
    return model.eval()


def _images(n, size, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, size, size, 1)) < 0.3).astype(np.float32)


def test_forward_matches_jax_at_reproduce_widths():
    """Full reproduce() widths (8 blocks, C=64, 2 heads, 28x28), batch 2:
    logits within atol 1e-4 of the JAX forward; the reproduce loss within
    1e-3 nats (summed over 784 pixels)."""
    config = timage_gpt.REPRODUCE_CONFIG
    jm = _jax_model(config)
    tm = _port(jm, config)
    x = _images(2, 28, seed=0)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    jloss = optax.sigmoid_binary_cross_entropy(
        want.reshape(2, -1), x.reshape(2, -1)).sum(axis=1).mean()
    tloss = timage_gpt.reproduce_loss(torch.from_numpy(x), got)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-3)


def test_forward_matches_jax_flash_blocks(monkeypatch):
    """Tiny shape with the JAX blocks on the Pallas flash kernel (interpret
    mode): logits within atol 1e-4."""
    monkeypatch.setattr(attention_pallas, "_INTERPRET", True)
    config = dict(TINY, n_transformer_blocks=2)
    jm = _jax_model(config)
    jm = jm.replace(blocks=tuple(
        b.replace(attn=b.attn.replace(use_flash=True)) for b in jm.blocks))
    tm = _port(jm, config)
    x = _images(2, 8, seed=1)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _jax_uniforms(rng, n, seq_len):
    """The per-position draws of the JAX samplers (jax.random.bernoulli's
    uniforms): (L, n, 1)."""
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (n, 1)))(
        jax.random.split(rng, seq_len)))  # a writable copy


@pytest.mark.parametrize("inpaint", [False, True])
def test_sampler_matches_jax_pixel_for_pixel(inpaint):
    """The port's sampler (its plain KV-cache decoder on the CPU) fed the JAX
    uniforms gives the same pixels as the JAX XLA decoder and the JAX
    whole-loop Pallas kernel (interpret mode), free and inpainted."""
    jm = _jax_model(TINY)
    tm = _port(jm, TINY)
    rng = jax.random.PRNGKey(7)
    n = 4
    if inpaint:
        cond = -np.ones((n, 8, 8, 1), np.float32)
        cond[:, :4] = _images(n, 8, seed=3)[:, :4]
        jkw = dict(conditioned_on=jnp.asarray(cond))
        tkw = dict(conditioned_on=torch.from_numpy(cond))
    else:
        cond = -np.ones((n, 8, 8, 1), np.float32)
        jkw = dict(n_samples=n)
        tkw = dict(n_samples=n)
    u = _jax_uniforms(rng, n, 64)
    xla = np.asarray(jsampling.image_gpt_sample_fast(
        jm, rng, use_fused_step=False, **jkw))
    loop = np.asarray(jsampling._image_gpt_sample_loop(
        jm, rng, jkw.get("n_samples"), jkw.get("conditioned_on"),
        interpret=True, tile=n))

    # The draws are decided away from the boundary for this seed, so a
    # ~1e-6 logit difference between the packages cannot flip a pixel.
    probs = np.asarray(jax.nn.sigmoid(jm(jnp.asarray(xla))))
    sampled = (cond < 0).reshape(n, -1)
    margin = np.abs(u[:, :, 0].T - probs.reshape(n, -1))[sampled]
    assert margin.min() > 1e-4

    before = decode_cuda.launches
    got = tm.sample(uniforms=torch.from_numpy(u), **tkw).numpy()
    assert decode_cuda.launches == before  # CPU tensors never launch
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, loop)
    assert set(np.unique(got)) <= {0.0, 1.0}
    if inpaint:
        np.testing.assert_array_equal(got[:, :4], cond[:, :4])


def test_naive_sampler_and_fallbacks_agree():
    """The generic raster sampler (one forward per pixel) equals the KV-cache
    sampler on the same uniforms; a model the whole-loop sampler does not
    cover (custom sample_fn) takes the generic sampler on the CPU."""
    config = dict(TINY, n_transformer_blocks=2)
    tm = _port(_jax_model(config), config)
    u = torch.rand((64, 3, 1), generator=torch.Generator().manual_seed(0))
    fast = tm.sample(n_samples=3, uniforms=u)
    naive = tm.sample_naive(n_samples=3, uniforms=u)
    torch.testing.assert_close(fast, naive, rtol=0, atol=0)

    assert sampling._whole_loop_eligible(tm)
    tm.sample_fn = lambda uu, logits: (uu < torch.sigmoid(logits)).float()
    assert not sampling._whole_loop_eligible(tm)
    torch.testing.assert_close(tm.sample(n_samples=3, uniforms=u), fast,
                               rtol=0, atol=0)


def test_model_from_generator_is_seeded():
    """A model built from a torch.Generator seed is reproducible, and samples
    drawn from a generator are binary of the expected shape."""
    config = dict(TINY, n_transformer_blocks=1)
    a = ImageGPT(**config, generator=torch.Generator().manual_seed(5))
    b = ImageGPT(**config, generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    s = a.sample(n_samples=2, generator=torch.Generator().manual_seed(1))
    assert s.shape == (2, 8, 8, 1)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
