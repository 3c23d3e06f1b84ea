"""The port's per-position decode step and its sampler route against the JAX
package, on the CPU, through ``convert.from_jax_params``.

``decode_cuda.fused_decode_step`` on CPU tensors (its plain version) is held
to the JAX Pallas step kernel in interpret mode; the route choice to the JAX
package's choice on its accelerator; the step route for models the whole
loop does not cover to the generic raster sampler. Inputs come from numpy
seeds; each case states its tolerance. The step-route sampler against the
JAX samplers is in ``tests/test_torch_image_gpt.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_generative_tpu import models as jmodels
from pytorch_generative_tpu.ops import decode_pallas
from pytorch_generative_tpu.ops import sampling as jsampling
from pytorch_generative_tpu_torch import convert
from pytorch_generative_tpu_torch.models import ImageGPT
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
from pytorch_generative_tpu_torch.ops import decode_cuda, sampling

TINY = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=3,
            n_attention_heads=2, n_embedding_channels=32, in_shape=(8, 8, 1))
# C = 128, 2 heads of d = 64: LARGE_CONFIG's head width.
WIDE = dict(TINY, n_transformer_blocks=2, n_embedding_channels=128)


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
    model = ImageGPT(**config, device="cpu")
    model.load_state_dict(convert.from_jax_params(flat))
    return model.eval()


def _step_inputs(jm, n, seed):
    """x (N, C) and a packed cache (n_blocks, N, L, f) of seeded values; a
    step at i treats positions >= i as junk, which the test scales up so
    that reading them would show."""
    h, w, _ = jm.in_shape
    attn = jm.blocks[0].attn
    c = attn.embed_channels
    f = attn.embed_channels + attn.out_channels
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)).astype(np.float32)
    cache = rng.standard_normal((len(jm.blocks), n, h * w, f)).astype(np.float32)
    return x, cache


def _bf16_ulp(v):
    """One bfloat16 unit in the last place at each |v| (8 significand bits)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("config,positions,cache_dtype", [
    (TINY, (0, 5, 37), "float32"),
    (WIDE, (37,), "float32"),
    (TINY, (37,), "bfloat16"),
], ids=["c32", "c128_d64", "c32_bf16_cache"])
def test_decode_step_matches_jax_kernel(config, positions, cache_dtype):
    """act within atol 1e-5 and kv_new within 1e-5 (f32 cache) or one bf16
    ulp (bf16 cache: both frameworks round to nearest even) of the JAX
    kernel in interpret mode, with junk x 100 in cache positions >= i.
    The bf16 cache holds identical contents for both. The port writes
    kv_new into its cache at i, and nowhere else."""
    jm = _jax_model(config)
    tm = _port(jm, config)
    n = 4
    x, cache = _step_inputs(jm, n, seed=sum(positions))
    jweights = decode_pallas.stack_image_gpt_weights(jm)
    tweights = decode_cuda.stack_image_gpt_weights(tm)
    attn = jm.blocks[0].attn
    n_heads = attn.n_heads
    d_k, d_v = attn.embed_channels // n_heads, attn.out_channels // n_heads
    seq = cache.shape[2]
    for i in positions:
        junk = cache.copy()
        junk[:, :, i:] *= 100.0
        jcache = jnp.asarray(junk).astype(cache_dtype)
        tcache = torch.from_numpy(junk).to(getattr(torch, cache_dtype))
        np.testing.assert_array_equal(np.asarray(jcache.astype(jnp.float32)),
                                      tcache.float().numpy())
        want_act, want_kv = decode_pallas.fused_decode_step(
            jnp.int32(i), jnp.asarray(x), jcache, jweights, n_heads, d_k, d_v,
            window=seq, interpret=True)
        before = decode_cuda.step_launches
        tcache0 = tcache.clone()
        act, kv_new = decode_cuda.fused_decode_step(
            i, torch.from_numpy(x), tcache, tweights, n_heads)
        assert decode_cuda.step_launches == before  # CPU tensors never launch
        assert torch.equal(kv_new, tcache[:, :, i])
        assert torch.equal(tcache[:, :, :i], tcache0[:, :, :i])
        assert torch.equal(tcache[:, :, i + 1:], tcache0[:, :, i + 1:])
        assert kv_new.dtype == tcache.dtype
        np.testing.assert_allclose(act.numpy(), np.asarray(want_act), rtol=0, atol=1e-5)
        want_kv = np.asarray(want_kv.astype(jnp.float32))
        got_kv = kv_new.float().numpy()
        if cache_dtype == "float32":
            np.testing.assert_allclose(got_kv, want_kv, rtol=0, atol=1e-5)
        else:
            assert np.all(np.abs(got_kv - want_kv) <= _bf16_ulp(want_kv))


def _jax_route(monkeypatch, jm, n, cache_dtype):
    """The route the JAX package takes on its accelerator for (model, n,
    cache dtype): the samplers are replaced by recorders."""
    routes = []
    monkeypatch.setattr(jsampling.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jsampling, "_image_gpt_sample_loop",
                        lambda *a, **k: routes.append(sampling.LOOP_ROUTE))
    monkeypatch.setattr(jsampling, "_image_gpt_decode_fused",
                        lambda *a, **k: routes.append(sampling.STEP_ROUTE))
    for var in ("PGT_NO_FUSED_DECODE", "PGT_SAMPLE_LOOP", "PGT_FUSED_DECODE_MAX_N"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PGT_DECODE_CACHE_DTYPE", cache_dtype)
    jsampling.image_gpt_sample_fast(jm, jax.random.PRNGKey(0), n_samples=n)
    assert len(routes) == 1
    return routes[0]


def test_route_matches_jax(monkeypatch):
    """The port's route equals the JAX package's for the tiny model at
    n in {1, 3, 4, 8, 16}, reproduce() at n = 16 (whole loop), LARGE_CONFIG
    at n = 16 (step: tile 1) and a bf16 cache (step). The two big models
    are built without weights (jax.eval_shape, torch's meta device)."""
    jm = _jax_model(TINY)
    tm = _port(jm, TINY)
    cases = [(jm, tm, n, "float32") for n in (1, 3, 4, 8, 16)]
    for cfg in (image_gpt.REPRODUCE_CONFIG, image_gpt.LARGE_CONFIG):
        jbig = jax.eval_shape(lambda cfg=cfg: jmodels.ImageGPT(jax.random.PRNGKey(0), **cfg))
        with torch.device("meta"):
            tbig = ImageGPT(**cfg, device="meta")
        cases += [(jbig, tbig, 16, "float32"), (jbig, tbig, 16, "bfloat16")]
    got, want = [], []
    for j, t, n, dtype in cases:
        want.append(_jax_route(monkeypatch, j, n, dtype))
        got.append(sampling.sample_route(t, n, getattr(torch, dtype)))
    assert got == want
    assert want == ["step"] * 3 + ["loop"] * 2 + ["loop", "step", "step", "step"]
    with pytest.raises(ValueError):
        sampling.sample_route(tm, 4, torch.float16)


def _model(config, seed=0):
    model = ImageGPT(**config, generator=torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape,
                                          generator=torch.Generator().manual_seed(seed + 1)))
    return model.eval()


@pytest.mark.parametrize("kind", ["two_channels", "custom_sample_fn"])
def test_step_route_covers_other_models(kind):
    """Models the whole loop does not cover take the step route and give
    the generic raster sampler's pixels (one forward per pixel) on the same
    uniforms."""
    config = dict(TINY, n_transformer_blocks=2)
    if kind == "two_channels":
        config.update(in_channels=2, out_channels=2, in_shape=(8, 8, 2))
    model = _model(config)
    if kind == "custom_sample_fn":
        model.sample_fn = lambda u, logits: (u > torch.sigmoid(-logits)).float()
    c = config["in_shape"][2]
    assert not sampling._whole_loop_eligible(model)
    assert sampling.sample_route(model, 16) == sampling.STEP_ROUTE
    u = torch.rand((64, 3, c), generator=torch.Generator().manual_seed(2))
    cond = -torch.ones((3, 8, 8, c))
    cond[:, :2] = 1.0
    for kw in (dict(n_samples=3), dict(conditioned_on=cond)):
        fast = model.sample(uniforms=u, **kw)
        naive = model.sample_naive(uniforms=u, **kw)
        assert fast.shape == (3, 8, 8, c)
        torch.testing.assert_close(fast, naive, rtol=0, atol=0)
    assert bool((fast[:, :2] == 1.0).all())
