"""The bf16 modes of the port's kernels against the JAX package's Pallas
kernels at bf16, on the CPU.

The plain versions of ``ops/attention_cuda.py``, ``ops/ln_cuda.py`` and
``ops/mlp_cuda.py`` on bf16 operands (what the kernels' bf16 modes compute,
and what serves bf16 CPU tensors) are held to ``attention_pallas``,
``ln_pallas`` and ``mlp_pallas`` run in interpret mode, as
tests/test_kernels.py runs them at bf16. Inputs come from numpy seeds and
are rounded to bf16 on both sides alike (nearest even). Tensors cross
between the frameworks as float32 numpy arrays, which hold bf16 values
exactly.

Tolerances are in units of the reference's largest magnitude (``scale``
below: max(1, max |want|)). A bf16 value has 8 significant bits, so one
rounding that lands the other way moves an element by up to 2^-8 of its
size. The two sides round at the same points but sum in another order (and
the JAX flash forward rounds P against a running row max, the port against
the whole row's), so an element may land one bf16 step apart; each case
states its bound, measured and then given a margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_generative_tpu.ops import attention_pallas, ln_pallas, mlp_pallas
from pytorch_generative_tpu_torch.ops import attention_cuda, ln_cuda, mlp_cuda

EPS = 1e-5
BF16_STEP = 2.0 ** -8  # one bf16 rounding step, relative


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores: keep
    torch's CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_pair(a):
    """A float32 numpy array rounded to bf16, as (jax array, torch tensor)."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x):
    """A jax array or torch tensor of any float type as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _assert_scaled(got, want, name, tol):
    """max |got - want| <= tol x max(1, max |want|), infinities equal."""
    got, want = _np(got), _np(want)
    same_inf = np.isinf(want) & (got == want)
    scale = max(float(np.abs(np.where(np.isinf(want), 0, want)).max()), 1.0)
    with np.errstate(invalid="ignore"):  # -inf - -inf, replaced by 0
        err = float(np.abs(np.where(same_inf, 0, got - want)).max())
    assert err <= tol * scale, f"{name}: max abs error {err:.3e} > {tol:.1e} x {scale:.3f}"


# (1) Flash attention -------------------------------------------------------

FLASH_TOL = BF16_STEP  # out, dq, dk, dv: measured at most 0.29 of a step
LSE_TOL = 1e-6         # f32 statistics: measured 1.3e-7


def _flash_inputs(b, l, n_heads, d, seed):
    rng = np.random.default_rng(seed)
    c = n_heads * d
    return [_bf16_pair(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, l, c), (b, l, c), (b, l, c), (b, l, c))]


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_flash_bf16_plain_matches_jax_kernel(d, mask_center):
    """The bf16 plain forward (out bf16, lse f32) and backward (dq, dk, dv
    bf16, from the JAX kernel's own out and lse) against attention_pallas's
    forward and backward on bf16 operands in interpret mode: B 1, L 520
    (the JAX kernel walks 5 key blocks of 104), 2 heads. out, dq, dk, dv
    within 1 bf16 step x scale, lse within 1e-6 x scale."""
    b, l, h = 1, 520, 2
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _flash_inputs(b, l, h, d, seed=d + mask_center)
    blocks = (attention_pallas.DEFAULT_BLOCK_Q, attention_pallas.DEFAULT_BLOCK_K)
    jout, jlse = attention_pallas._flash_forward(jq, jk, jv, h, mask_center, *blocks, True)
    jgrads = attention_pallas._flash_backward(jq, jk, jv, jout, jlse, jdo, h, mask_center,
                                              *blocks, True)
    jlse = jlse[:, :, :l, 0]
    assert jout.dtype == jnp.bfloat16 and all(g.dtype == jnp.bfloat16 for g in jgrads)

    out, lse = attention_cuda.flash_forward(tq, tk, tv, mask_center, h)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_scaled(out, jout, "out", FLASH_TOL)
    _assert_scaled(lse, jlse, "lse", LSE_TOL)
    # The backward from the JAX kernel's out and lse, so that it is held
    # to the JAX backward alone.
    tout = torch.from_numpy(_np(jout)).to(torch.bfloat16)
    grads = attention_cuda.flash_backward(tq, tk, tv, tout, torch.from_numpy(_np(jlse)), tdo,
                                          mask_center, h)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.dtype == torch.bfloat16
        _assert_scaled(got, want, name, FLASH_TOL)
    if mask_center:
        assert bool((out[:, 0] == 0).all()) and bool((grads[0][:, 0] == 0).all())
        assert bool(torch.isneginf(lse[:, :, 0]).all())


# (2) LayerNorm ---------------------------------------------------------------

LN_TOL = BF16_STEP  # out, dx: measured equal; f32 statistics in another order
LN_SUM_TOL = 1e-5   # dgamma, dbeta: f32 sums of the same products, measured 1.3e-7


def test_ln_bf16_plain_matches_jax_kernel():
    """layernorm_forward_plain / layernorm_backward_plain on bf16 rows
    against ln_pallas's forward and backward on bf16 rows in interpret
    mode, C = 128, 50 rows (the TPU wrapper's pad route): out and dx bf16
    within 1 bf16 step x scale; dgamma and dbeta, the f32 sums before the
    cast, within 1e-5 x scale."""
    rng = np.random.default_rng(0)
    (jx, tx), (jdy, tdy) = (_bf16_pair(rng.standard_normal((50, 128)).astype(np.float32))
                            for _ in range(2))
    (jg, tg), (jb, tb) = (_bf16_pair(rng.standard_normal(128).astype(np.float32))
                          for _ in range(2))
    want = ln_pallas._ln_fwd(jx, jg, jb, EPS, True)
    jdx, jdg, jdb = ln_pallas._ln_bwd(jx, jdy, jg, EPS, True)
    assert want.dtype == jdx.dtype == jnp.bfloat16

    out = ln_cuda.layernorm_forward_plain(tx, tg, tb, EPS)
    dx, dg, db = ln_cuda.layernorm_backward_plain(tx, tdy, tg, EPS)
    assert out.dtype == dx.dtype == torch.bfloat16 and dg.dtype == torch.float32
    _assert_scaled(out, want, "out", LN_TOL)
    _assert_scaled(dx, jdx, "dx", LN_TOL)
    _assert_scaled(dg, jdg, "dgamma", LN_SUM_TOL)
    _assert_scaled(db, jdb, "dbeta", LN_SUM_TOL)


# (3) The fused MLP -----------------------------------------------------------

MLP_TOL = BF16_STEP  # out, y, dx: measured at most 0.07 of a step
MLP_SUM_TOL = 5e-4   # the f32 weight, bias and LayerNorm sums: measured 5.4e-5
NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def _mlp_args(r, c, f, seed):
    rng = np.random.default_rng(seed)
    return [_bf16_pair(rng.standard_normal(shape).astype(np.float32) * s)
            for shape, s in (((r, c), 1.0), ((c,), 1.0), ((c,), 1.0), ((c, f), 0.1),
                             ((f,), 1.0), ((f, c), 0.1), ((c,), 1.0))]


@pytest.fixture(scope="module")
def mlp_case():
    """C = 128, F = 512, 50 rows: the JAX kernels' bf16 forward (out and the
    saved y) and saved-y backward (f32 sums before the cast, and dx) in
    interpret mode, and the port's bf16 inputs."""
    pairs = _mlp_args(50, 128, 512, seed=2)
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    jdo, tdo = _bf16_pair(np.random.default_rng(3).standard_normal((50, 128)).astype(np.float32))
    jout, jy = mlp_pallas._fused_fwd(*jargs, EPS, True, save_y=True)
    x, gamma, beta, w1, b1, w2, _ = jargs
    jgrads = mlp_pallas._fused_bwd(x, jdo, gamma, beta, w1, b1, w2, EPS, True, y2=jy)
    return targs, tdo, (jout, jy), jgrads


def test_mlp_bf16_forward_matches_jax_kernel(mlp_case):
    """ln_mlp_forward_plain on bf16 operands against mlp_pallas's bf16
    forward: out and the saved y both bf16, within 1 bf16 step x scale
    (it also covers exact erf against the JAX kernel's A&S polynomial,
    1.5e-7 absolute, which can move a rounding of gelu(y))."""
    targs, _, (jout, jy), _ = mlp_case
    out, y = mlp_cuda.ln_mlp_forward(*targs, EPS)
    assert out.dtype == y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    _assert_scaled(out, jout, "out", MLP_TOL)
    _assert_scaled(y, jy, "y", MLP_TOL)


@pytest.mark.parametrize("route", ["saved", "recompute", "pipe"])
def test_mlp_bf16_backward_routes_match_jax_kernel(mlp_case, route):
    """Each backward route's plain version on bf16 operands (the saved-y
    and pipelined ones from the JAX kernel's saved y, the recompute one
    from the port's own forward) against mlp_pallas's saved-y backward: dx
    (bf16) within 1 bf16 step x scale, the f32 parameter sums within
    5e-4 x scale."""
    (x, gamma, beta, w1, b1, w2, _), tdo, (_, jy), jgrads = mlp_case
    y = torch.from_numpy(_np(jy)).to(torch.bfloat16)
    if route == "recompute":
        grads = mlp_cuda.ln_mlp_backward_recompute(x, tdo, gamma, beta, w1, b1, w2, EPS)
    else:
        fn = mlp_cuda.ln_mlp_backward if route == "saved" else mlp_cuda.ln_mlp_backward_pipe
        grads = fn(x, tdo, y, gamma, beta, w1, b1, w2, EPS)
    jdx, jdw1, jdb1, jdw2, jdb2, jdg, jdb = jgrads
    want = (jdx, jdg, jdb, jdw1, jdb1, jdw2, jdb2)
    assert grads[0].dtype == torch.bfloat16
    for name, got, w in zip(NAMES, grads, want):
        _assert_scaled(got, w, name, MLP_TOL if name == "dx" else MLP_SUM_TOL)


def test_mlp_bf16_plain_backward_routes_are_equal(mlp_case):
    """The three plain backward routes give the same values on bf16
    operands: the recompute route rounds its y to bf16 as the forward
    stores it."""
    (x, gamma, beta, w1, b1, w2, b2), tdo, _, _ = mlp_case
    _, y = mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, EPS)
    saved = mlp_cuda.ln_mlp_backward(x, tdo, y, gamma, beta, w1, b1, w2, EPS)
    recompute = mlp_cuda.ln_mlp_backward_recompute(x, tdo, gamma, beta, w1, b1, w2, EPS)
    pipe = mlp_cuda.ln_mlp_backward_pipe(x, tdo, y, gamma, beta, w1, b1, w2, EPS)
    for name, a, b, c in zip(NAMES, saved, recompute, pipe):
        assert torch.equal(a, b) and torch.equal(a, c), name


def test_bf16_functions_cast_parameter_gradients():
    """Through the autograd Functions on bf16 CPU tensors, every gradient
    comes back in its input's type (the f32 sums cast, as the JAX
    package's custom_vjp casts them), and out keeps bf16."""
    (_, x), (_, gamma), (_, beta), (_, w1), (_, b1), (_, w2), (_, b2) = _mlp_args(
        16, 128, 512, seed=4)
    args = [t.requires_grad_() for t in (x, gamma, beta, w1, b1, w2, b2)]
    out = mlp_cuda.ln_mlp_residual(*args, EPS)
    ln = ln_cuda.channel_layernorm(args[0], args[1], args[2], EPS)
    assert out.dtype == ln.dtype == torch.bfloat16
    (out.float().square().sum() + ln.float().sum()).backward()
    assert all(t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape for t in args)


# (4) The bf16 GEMM's sums, emulated -----------------------------------------
#
# csrc/gemm_wgmma_bf16.cuh (every product of the fused MLP's bf16 mode)
# runs wgmma m64n128k16: a bf16 product is exact in f32, and the tensor
# cores add a k-slice of 16 of them to the accumulator, cutting the sum
# toward zero to f32, as they do for TF32. The kernel sums the products of
# FOLD values (two k-steps of 64, eight k-slices deep) in a fresh part
# accumulator and adds the parts into the running sums by f32 adds (round
# to nearest). The emulation models a k-slice as the exact sum of its 16
# products and the accumulator, cut toward zero.

GEMM_RTOL = 1e-6  # fresh parts against float64: measured 2.7e-7 at K = 6272
FOLD = 128        # kFold x kBK of csrc/gemm_wgmma_bf16.cuh


def _toward_zero(x64):
    """float64 values cut to float32 toward zero."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def _gemm_bf16(a, b, fresh=True):
    """a @ b of bf16-valued float32 tensors as the kernel sums it: per FOLD
    values, k-slices of 16 into a fresh part accumulator added in float32
    (or, with fresh=False, all into one accumulator, which is what the
    kernel avoids)."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], FOLD):
        part = torch.zeros_like(acc) if fresh else acc
        for kk in range(k0, min(k0 + FOLD, a.shape[1]), 16):
            part = _toward_zero(part.double() + a[:, kk:kk + 16].double()
                                @ b[kk:kk + 16].double())
        acc = acc + part if fresh else part
    return acc


@pytest.mark.parametrize("k", [512, 2048, 6272])
def test_bf16_gemm_fresh_accumulators_hold_float32_accuracy(k):
    """At the MLP's depths (C = 512, F = 2048, and a dW slice of 6,272 rows)
    the kernel's fresh parts of 128 values sum bf16 products within 1e-6 x
    scale of float64; one accumulator for the whole K drifts toward zero,
    at K = 6272 over 4x further (measured 2.7e-7 against 8.2e-6)."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((16, k)).astype(np.float32)).bfloat16().float()
    b = torch.from_numpy((rng.standard_normal((k, 16)) + 0.5).astype(np.float32))
    b = b.bfloat16().float()
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    fresh = float((_gemm_bf16(a, b).double() - ref).abs().max()) / scale
    assert fresh <= GEMM_RTOL
    if k == 6272:
        drift = float((_gemm_bf16(a, b, fresh=False).double() - ref).abs().max()) / scale
        assert drift > 4 * fresh
