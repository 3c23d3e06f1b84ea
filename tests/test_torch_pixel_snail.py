"""The PyTorch port's PixelSNAIL (forward, training, samplers) and its flash
attention at d_k != d_v against the JAX package, on the CPU.

Inputs and uniforms come from numpy seeds or the JAX package's own draws and
go through both packages in float32, weights through
``convert.from_jax_params``. Where the JAX side reaches a Pallas kernel it
runs in interpret mode. Each case states its tolerance.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_generative_tpu import core
from pytorch_generative_tpu import models as jmodels
from pytorch_generative_tpu import nn as jnn
from pytorch_generative_tpu import optim as joptim
from pytorch_generative_tpu.ops import attention_pallas
from pytorch_generative_tpu.ops import sampling as jsampling
from pytorch_generative_tpu_torch import convert, optim, trainer
from pytorch_generative_tpu_torch import nn as tnn
from pytorch_generative_tpu_torch.models import PixelSNAIL
from pytorch_generative_tpu_torch.models.autoregressive import pixel_snail
from pytorch_generative_tpu_torch.ops import attention_cuda, sampling, snail_decode_cuda

TINY = dict(in_channels=1, out_channels=1, n_channels=16, n_pixel_snail_blocks=2,
            n_residual_blocks=2, attention_key_channels=4, attention_value_channels=8,
            in_shape=(8, 8, 1))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores: keep
    torch's CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _models(config, seed):
    """(JAX model, port model) with the same weights. The weights are drawn
    by the port from a seed and filled into the JAX model's tree (built by
    jax.eval_shape, which runs none of JAX's initialisers: they take
    seconds a model here); the port model under test is then loaded from
    that tree through ``convert.from_jax_params``."""
    drawn = PixelSNAIL(**config, generator=torch.Generator().manual_seed(seed),
                       device="cpu").state_dict()
    skeleton = jax.eval_shape(functools.partial(jmodels.PixelSNAIL, **config),
                              jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(skeleton)
    values = []
    for path, leaf in leaves:
        t = drawn[convert._key(jax.tree_util.keystr(path))].numpy()
        if t.ndim == 4:
            t = t.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif len(leaf.shape) == 4:
            t = t[None, None]            # 1x1 conv (in, out) -> (1, 1, in, out)
        assert t.shape == leaf.shape, (path, t.shape, leaf.shape)
        values.append(jnp.asarray(t))
    jmodel = jax.tree_util.tree_unflatten(treedef, values)
    model = PixelSNAIL(**config, device="cpu")
    model.load_state_dict(convert.from_jax_params(_flat(jmodel)))
    for name, t in model.state_dict().items():
        assert torch.equal(t, drawn[name]), name
    return jmodel, model.eval()


def _images(n, shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, *shape)) < 0.3).astype(np.float32)


def _records(log_dir, tag):
    """{step: train value} of one tag in a Trainer's metrics.jsonl."""
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag and "train" in rec:
                out[rec["step"]] = rec["train"]
    return out


def _jax_loss(x, _, preds):
    n = x.shape[0]
    return optax.sigmoid_binary_cross_entropy(
        preds.reshape(n, -1), x.reshape(n, -1)).sum(axis=1).mean()


def test_layers_match_jax():
    """image_positional_encoding exactly; GatedActivation (tanh and
    identity) within atol 1e-6."""
    np.testing.assert_array_equal(
        tnn.image_positional_encoding((2, 5, 7, 1)).numpy(),
        jnn.image_positional_encoding((2, 5, 7, 1)))
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 6)).astype(np.float32)
    for fn, tfn in ((jnp.tanh, torch.tanh), (lambda t: t, lambda t: t)):
        want = np.asarray(jnn.GatedActivation(fn)(jnp.asarray(x)))
        got = tnn.GatedActivation(tfn)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_forward_matches_jax_at_reproduce_widths():
    """Full reproduce() widths (8 blocks, C = 64, d_k 4, d_v 32, 28x28),
    batch 2: logits within atol 1e-4 of the JAX forward; the reproduce loss
    within 1e-3 nats (summed over 784 pixels)."""
    jm, tm = _models(pixel_snail.REPRODUCE_CONFIG, seed=0)
    x = _images(2, (28, 28, 1), seed=0)
    want = np.asarray(jax.jit(lambda m, x: m(x))(jm, jnp.asarray(x)))
    before = attention_cuda.launches
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert attention_cuda.launches == before  # CPU tensors never launch
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    loss = pixel_snail.reproduce_loss(torch.from_numpy(x), None, got)
    np.testing.assert_allclose(float(loss), float(_jax_loss(x, None, want)), atol=1e-3)


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("n_heads", [1, 2])
def test_flash_plain_matches_jax_kernel_at_dk_ne_dv(monkeypatch, n_heads, mask_center):
    """The flash kernels' plain versions at d_k = 4, d_v = 8 (B 2, L 64)
    against the JAX Pallas kernels in interpret mode: out and lse within
    atol 2e-5, dq, dk, dv within atol 1e-4 (f32, another summation order);
    under mask_center row 0 gets out 0, lse -inf and dq 0."""
    monkeypatch.setattr(attention_pallas, "_INTERPRET", True)
    d_k, d_v, l = 4, 8, 64
    rng = np.random.default_rng(10 * n_heads + mask_center)
    q, k = (rng.standard_normal((2, l, n_heads * d_k)).astype(np.float32) for _ in range(2))
    v, g = (rng.standard_normal((2, l, n_heads * d_v)).astype(np.float32) for _ in range(2))
    blocks = (attention_pallas.DEFAULT_BLOCK_Q, attention_pallas.DEFAULT_BLOCK_K)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = attention_pallas._flash_forward(jq, jk, jv, n_heads, mask_center, *blocks, True)
    jgrads = attention_pallas._flash_backward(jq, jk, jv, jout, jlse, jg, n_heads, mask_center,
                                              *blocks, True)

    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = attention_cuda.flash_forward(tq, tk, tv, mask_center, n_heads)
    assert out.shape == (2, l, n_heads * d_v)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :l, 0], rtol=0, atol=2e-5)
    grads = attention_cuda.flash_backward(tq, tk, tv, out, lse, tg, mask_center, n_heads)
    for got, want in zip(grads, jgrads):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    if mask_center:
        np.testing.assert_array_equal(out[:, 0].numpy(), 0.0)
        assert np.all(np.isneginf(lse[:, :, 0].numpy()))
        np.testing.assert_array_equal(grads[0][:, 0].numpy(), 0.0)


def test_model_gradients_match_jax():
    """Gradients of the reproduce loss on TINY, port (its attention Function
    on the plain path) against jax.grad of the JAX model, parameter by
    parameter through the weight bridge: atol 2e-5 + rtol 1e-5 (f32, sums
    over 64 pixels x 2 images in another order)."""
    jm, tm = _models(TINY, seed=1)
    x = _images(2, (8, 8, 1), seed=1)
    params, rest = core.partition(jm)
    jgrads = jax.jit(jax.grad(
        lambda p: _jax_loss(x, None, core.combine(p, rest)(jnp.asarray(x)))))(params)
    want = convert.from_jax_params(_flat(jgrads))
    xt = torch.from_numpy(x)
    pixel_snail.reproduce_loss(xt, None, tm(xt)).backward()
    names = dict(tm.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5, atol=2e-5,
                                   err_msg=name)


def test_trainer_trajectory_matches_jax(tmp_path):
    """3 steps of the port's Trainer against 3 optax steps of the JAX
    package's optimizer on TINY, same weights and batches, reproduce()'s
    adam_multiplicative(1e-3, 0.999977): losses within rtol 1e-5 and final
    parameters within atol 1e-5. The key half of each kv_proj.bias has an
    exact gradient of 0 (it shifts every score of a row alike): both sides
    feed Adam rounding noise there, which moves it by up to lr a step with
    either sign."""
    jm, tm = _models(TINY, seed=2)
    batches = [_images(4, (8, 8, 1), seed=10 + i) for i in range(3)]
    params, rest = core.partition(jm)
    tx, _ = joptim.adam_multiplicative(1e-3, 0.999977)

    @jax.jit
    def step(params, opt_state, x):
        loss, grads = jax.value_and_grad(
            lambda p: _jax_loss(x, None, core.combine(p, rest)(x)))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    opt_state, want = tx.init(params), []
    for xb in batches:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(xb))
        want.append(float(loss))
    tt = trainer.Trainer(model=tm, loss_fn=pixel_snail.reproduce_loss,
                         optimizer=optim.adam_multiplicative(1e-3, 0.999977),
                         train_loader=[(xb, None) for xb in batches], eval_loader=[],
                         log_dir=str(tmp_path), sample_epochs=None, use_tensorboard=False,
                         device="cpu")
    tt.interleaved_train_and_eval(1)
    got = _records(tt.log_dir, "metrics/loss")
    assert sorted(got) == [0, 1, 2]
    np.testing.assert_allclose([got[s] for s in range(3)], want, rtol=1e-5)
    want = convert.from_jax_params(_flat(params))
    d_k = TINY["attention_key_channels"]
    for name, p in tt.model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("attention.kv_proj.bias"):
            np.testing.assert_allclose(got[:d_k], ref[:d_k], rtol=0, atol=3 * 2 * 1e-3)
            got, ref = got[d_k:], ref[d_k:]
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=name)


def _jax_uniforms(rng, n, seq_len, c):
    """The per-position draws of the JAX samplers (jax.random.bernoulli's
    uniforms): (L, n, c)."""
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (n, c)))(
        jax.random.split(rng, seq_len)))  # a writable copy


@pytest.mark.parametrize("inpaint", [False, True], ids=["free", "inpaint"])
def test_samplers_match_jax_pixel_for_pixel(inpaint):
    """Fed the JAX uniforms, the port's incremental sampler and the
    whole-loop kernel's plain version (the route of ``sample`` on the CPU)
    give the same pixels as the JAX XLA sampler on TINY, free and
    inpainted; the free case also those of the JAX whole-loop Pallas kernel
    (interpret mode)."""
    n, size = 4, 8
    jm, tm = _models(TINY, seed=3)
    rng = jax.random.PRNGKey(7)
    cond = -np.ones((n, size, size, 1), np.float32)
    if inpaint:
        cond[:, : size // 2] = _images(n, (size, size, 1), seed=3)[:, : size // 2]
        jkw, tkw = dict(conditioned_on=jnp.asarray(cond)), dict(conditioned_on=torch.from_numpy(cond))
    else:
        jkw, tkw = dict(n_samples=n), dict(n_samples=n)
    u = _jax_uniforms(rng, n, size * size, 1)
    xla = np.asarray(jsampling.pixel_snail_sample_fast(jm, rng, use_loop_kernel=False, **jkw))

    # The draws are decided away from the boundary for this seed, so a
    # ~1e-6 logit difference between the packages cannot flip a pixel.
    probs = np.asarray(jax.nn.sigmoid(jax.jit(lambda m, x: m(x))(jm, jnp.asarray(xla))))
    margin = np.abs(u.transpose(1, 0, 2).reshape(n, size, size, 1) - probs)[cond < 0]
    assert margin.min() > 1e-4

    assert sampling.pixel_snail_sample_route(tm, n) == sampling.LOOP_ROUTE
    before = snail_decode_cuda.launches
    got = tm.sample(uniforms=torch.from_numpy(u), **tkw).numpy()
    assert snail_decode_cuda.launches == before  # CPU tensors never launch
    np.testing.assert_array_equal(got, xla)
    fast = sampling.pixel_snail_sample_fast(tm, uniforms=torch.from_numpy(u), **tkw).numpy()
    np.testing.assert_array_equal(fast, xla)
    if not inpaint:
        loop = np.asarray(jsampling._pixel_snail_sample_loop(jm, rng, n, None, interpret=True,
                                                             tile=n))
        np.testing.assert_array_equal(got, loop)
    assert set(np.unique(got)) <= {0.0, 1.0}
    if inpaint:
        np.testing.assert_array_equal(got[:, : size // 2], cond[:, : size // 2])


def test_fast_sampler_equals_naive_and_routes():
    """Both routes equal the generic raster sampler (one forward per pixel)
    on the same uniforms, exactly. The route: an eligible model takes the
    whole loop at every n (16, 64, 256: no TPU tile rule); a custom
    sample_fn, or 3 channels, takes the incremental sampler, which equals
    the naive sampler there too, inpainting included; so does a model
    without residual blocks."""
    config = dict(TINY, in_shape=(6, 6, 1))
    tm = PixelSNAIL(**config, generator=torch.Generator().manual_seed(4), device="cpu").eval()
    u = torch.rand((36, 3, 1), generator=torch.Generator().manual_seed(5))
    naive = tm.sample_naive(n_samples=3, uniforms=u)
    torch.testing.assert_close(tm.sample(n_samples=3, uniforms=u), naive, rtol=0, atol=0)
    torch.testing.assert_close(sampling.pixel_snail_sample_fast(tm, n_samples=3, uniforms=u),
                               naive, rtol=0, atol=0)
    for n in (16, 64, 256):
        assert sampling.pixel_snail_sample_route(tm, n) == sampling.LOOP_ROUTE
    tm.sample_fn = lambda uu, logits: (uu < torch.sigmoid(logits)).float()
    assert sampling.pixel_snail_sample_route(tm, 16) == sampling.INCREMENTAL_ROUTE
    torch.testing.assert_close(tm.sample(n_samples=3, uniforms=u), naive, rtol=0, atol=0)

    rgb = PixelSNAIL(**dict(config, in_channels=3, out_channels=3, in_shape=(5, 5, 3)),
                     generator=torch.Generator().manual_seed(6), device="cpu").eval()
    assert sampling.pixel_snail_sample_route(rgb, 16) == sampling.INCREMENTAL_ROUTE
    cond = -torch.ones((2, 5, 5, 3))
    cond[:, :2] = (torch.rand((2, 2, 5, 3), generator=torch.Generator().manual_seed(7)) < 0.5).float()
    u3 = torch.rand((25, 2, 3), generator=torch.Generator().manual_seed(8))
    got = rgb.sample(conditioned_on=cond, uniforms=u3)
    torch.testing.assert_close(got, rgb.sample_naive(conditioned_on=cond, uniforms=u3),
                               rtol=0, atol=0)
    torch.testing.assert_close(got[:, :2], cond[:, :2], rtol=0, atol=0)

    # No residual blocks: both routes still decode.
    bare = PixelSNAIL(**dict(config, n_residual_blocks=0),
                      generator=torch.Generator().manual_seed(9), device="cpu").eval()
    torch.testing.assert_close(bare.sample(n_samples=3, uniforms=u),
                               bare.sample_naive(n_samples=3, uniforms=u), rtol=0, atol=0)


def test_pixel_snail_defaults_to_cuda():
    """The entry point defaults to CUDA and raises without it; seeded
    weights are reproducible."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="not available"):
        PixelSNAIL(**TINY)
    a, b = (PixelSNAIL(**TINY, generator=torch.Generator().manual_seed(6), device="cpu")
            for _ in range(2))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
