"""The numerics that ``csrc/gemm_tf32x3.cuh`` (the products of the fused
attention block and of the fused MLP) rests on, emulated in PyTorch on the
CPU.

The kernel splits each float32 operand x into big = tf32(x), rounded by two
integer operations as ``csrc/mma_tf32.cuh``'s ``round``, and small = x - big,
left unrounded (the tensor cores read its top 19 bits). Each k-step of 32
sums small_a big_b, big_a small_b and big_a big_b, eight terms an mma, in
fresh accumulators, and adds them into the running sums by float32 adds.
The emulation models an mma as the exact sum of its eight products and its
accumulator, cut toward zero to float32, as the tensor cores' sums round.
It shows that the product lies within the block's gate (``BLOCK_RTOL``, a
share of the largest magnitude, as ``chip_smoke.py`` holds the block to) of
a float64 product at the depths the block and the MLP kernels run: K = 64
and 512 (C), 2048 (the MLP's hidden width at C = 512).

For the fused MLP (``csrc/mlp.cuh``) it also emulates what its A operands
hold: LN(x) and gelu(y) (read as LN(x)^T and gelu(y)^T by dW1 and dW2),
each computed once in float32 for the R rows before the products, and past
the last row the zeros that the copies write, which nothing transforms; and
the weight-gradient products' slices of 6,272 rows (C = 512, R = 50,176),
whose partials are added in slice order. Each is held to float64 at the
MLP's gate (``MLP_RTOL``).
"""

import numpy as np
import pytest
import torch

BLOCK_RTOL = 1e-4  # chip_smoke.py's gate on the block's y and attn
MLP_RTOL = 1e-4    # chip_smoke.py's gate on the MLP's out, y and gradients
SLICE_ROWS = 6272  # one slice of the dW products at C = 512, R = 50,176
K_STEP = 32        # gemm_tf32x3.cuh's kBK
MMA_K = 8          # the depth of one mma.sync m16n8k8


def tf32_round(x):
    """x rounded to TF32 by mma_tf32.cuh's two integer operations: add half
    a TF32 ulp to the bits, clear the low 13."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x):
    """The top 19 bits of x: what an mma reads of an f32 operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def toward_zero(x64):
    """float64 values cut to float32 toward zero."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def mma(acc, a, b):
    """acc + a b for one k-slice of MMA_K: the exact sum, cut toward zero."""
    return toward_zero(acc.double() + tf32_cut(a).double() @ tf32_cut(b).double())


def gemm_tf32x3(a, b, fresh=True):
    """a @ b as the kernel sums it: per k-step, the three products of each
    k-slice in the kernel's sweep order, into fresh accumulators added into
    the running sums in float32 (or, with fresh=False, all into one
    accumulator, which is what the kernel avoids). Leading dimensions of a
    and b are batch dimensions (the parts of a split K)."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = a - a_big, b - b_big
    acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)
    for k0 in range(0, a.shape[-1], K_STEP):
        part = torch.zeros_like(acc) if fresh else acc
        for kk in range(k0, min(k0 + K_STEP, a.shape[-1]), MMA_K):
            ks = slice(kk, kk + MMA_K)
            for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
                part = mma(part, x[..., ks], y[..., ks, :])
        acc = acc + part if fresh else part
    return acc


def landed(a, pro, k_valid):
    """The A operand (M, K) as the kernel's k-steps see it: ``pro`` (LN or
    GELU in float32) applied to the first k_valid columns only, K padded
    to a whole k-step by the copies' zeros."""
    m, k = a.shape
    tile = torch.zeros((m, -(-k // K_STEP) * K_STEP), dtype=torch.float32)
    tile[:, :k] = a
    tile[:, :k_valid] = pro(tile[:, :k_valid])
    return tile


def ln_cols(x, gamma, beta):
    """mlp.cuh's LnCols over rows x (K, C): A(m = c, k = r) = (x - mean)
    * rstd * gamma + beta in float32, from rows.cuh's float32 statistics
    (two passes, biased variance, eps 1e-5), as an (C, K) -> (C, K)
    transform of x^T."""
    mean = x.mean(1)
    rstd = torch.rsqrt(((x - mean[:, None]) ** 2).mean(1) + 1e-5)
    return lambda a: (a - mean[:a.shape[1]]) * rstd[:a.shape[1]] * gamma[:, None] + beta[:, None]


def ln64(x, gamma, beta):
    """LN(x) in float64 from x (R, C)."""
    x = x.double()
    mean = x.mean(1, keepdim=True)
    return ((x - mean) / torch.sqrt(((x - mean) ** 2).mean(1, keepdim=True) + 1e-5)
            * gamma.double() + beta.double())


def _mlp_operands(r, c, seed):
    """x, gamma, beta (as chip_smoke.py draws them) and an (R, N) operand
    of unit scale."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((r, c)) + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    other = rng.standard_normal((r, 32)).astype(np.float32)
    return (torch.from_numpy(t) for t in (x, gamma, beta, other))


def _operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def test_tf32_round_is_round_to_nearest_at_ten_mantissa_bits():
    """big keeps 10 mantissa bits, lies within half a TF32 ulp of x, and
    small = x - big is exact in float32 and under 2^-11 |x|."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big = tf32_round(x)
    small = x - big
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 11)
    assert bool(((x.double() - big.double()).abs() <= ulp.double() / 2).all())
    assert torch.equal(small.double(), x.double() - big.double())
    assert bool((small.abs() <= x.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("k", [64, 512, 2048])
def test_tf32x3_product_lies_within_the_block_gate_of_float64(k):
    """At K = 64, 512 and 2048 the emulated kernel sum is within BLOCK_RTOL
    of the float64 product, as a share of its largest magnitude."""
    a, b = _operands(64, 64, k, seed=k)
    want = a.double() @ b.double()
    got = gemm_tf32x3(a, b)
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err <= BLOCK_RTOL, f"K={k}: {err:.3e}"


def test_fresh_accumulators_hold_back_the_drift_toward_zero():
    """At K = 2048 one accumulator that every mma adds into drifts toward
    zero; the kernel's fresh sums per k-step leave a smaller error."""
    a, b = _operands(64, 64, 2048, seed=1)
    want = a.double() @ b.double()
    fresh = float((gemm_tf32x3(a, b).double() - want).abs().max())
    single = float((gemm_tf32x3(a, b, fresh=False).double() - want).abs().max())
    assert fresh < single, (fresh, single)


def _gate_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("product", ["ln_rows K=512", "gelu K=2048 transposed B",
                                     "gelu^T K=6272", "ln_cols^T K=6272"])
def test_mlp_products_lie_within_the_mlp_gate_of_float64(product):
    """Each kind of the MLP's products, its A transformed in float32, within
    MLP_RTOL of float64: y = LN(x) W1 (K = C = 512);
    gelu(y) W2 with B read K-contiguous (W^T, as dy and dln read W2 and
    W1; K = F = 2048); and one slice of dW2 = gelu(y)^T dO and dW1 =
    LN(x)^T dy (A M-contiguous, K = 6,272 rows)."""
    rng = np.random.default_rng(7)
    if product.startswith("ln_rows"):
        x, gamma, beta, _ = _mlp_operands(32, 512, 0)
        w = torch.from_numpy((rng.standard_normal((512, 32)) / np.sqrt(512)).astype(np.float32))
        mean = x.mean(1, keepdim=True)
        rstd = torch.rsqrt(((x - mean) ** 2).mean(1, keepdim=True) + 1e-5)
        a = landed(x, lambda v: (v - mean) * rstd * gamma + beta, 512)
        got, want = gemm_tf32x3(a, w), ln64(x, gamma, beta) @ w.double()
    elif product.startswith("gelu K"):
        y = torch.from_numpy(rng.standard_normal((32, 2048)).astype(np.float32))
        w_t = torch.from_numpy((rng.standard_normal((32, 2048)) / 45.0).astype(np.float32))
        a = landed(y, torch.nn.functional.gelu, 2048)
        got = gemm_tf32x3(a, w_t.T.contiguous())
        want = torch.nn.functional.gelu(y.double()) @ w_t.double().T
    elif product.startswith("gelu^T"):
        y, _, _, dout = _mlp_operands(SLICE_ROWS, 32, 1)
        a = landed(y.T.contiguous(), torch.nn.functional.gelu, SLICE_ROWS)
        got = gemm_tf32x3(a, dout)
        want = torch.nn.functional.gelu(y.double()).T @ dout.double()
    else:
        x, gamma, beta, dy = _mlp_operands(SLICE_ROWS, 32, 2)
        a = landed(x.T.contiguous(), ln_cols(x, gamma, beta), SLICE_ROWS)
        got, want = gemm_tf32x3(a, dy), ln64(x, gamma, beta).T @ dy.double()
    err = _gate_err(got, want)
    assert err <= MLP_RTOL, f"{product}: {err:.3e}"


def test_slice_partials_added_in_order_lie_within_the_mlp_gate():
    """dW1 over R = 8 x 6,272 rows as the backward computes it: a partial
    for each slice (one part of the grid each), then the 8 partials added
    in slice order in float32 (rows.cuh's sum_slices), within MLP_RTOL of
    the float64 product over all rows."""
    r = 8 * SLICE_ROWS
    x, gamma, beta, dy = _mlp_operands(r, 16, 3)
    dy = dy[:, :16]
    pro = ln_cols(x, gamma, beta)
    a = pro(x.T.contiguous())  # every row in range: no padding at 8 x 6,272
    parts = gemm_tf32x3(a.reshape(16, 8, SLICE_ROWS).transpose(0, 1),
                        dy.reshape(8, SLICE_ROWS, 16))
    got = torch.zeros((16, 16))
    for p in parts:
        got = got + p
    err = _gate_err(got, ln64(x, gamma, beta).T @ dy.double())
    assert err <= MLP_RTOL, f"{err:.3e}"


def test_elements_past_the_edge_stay_untransformed():
    """A ragged slice (K = 6,272 - 13 rows: the last k-step is part zeros):
    LN applies to the rows only, not to the zeros the copies write past
    them, so the product is the one over the trimmed rows, bit for bit; LN
    applied to those zeros too (LN(0) = beta - mean * rstd * gamma, not 0)
    would leave the gate."""
    k = SLICE_ROWS - 13
    x, gamma, beta, dy = _mlp_operands(SLICE_ROWS, 16, 4)
    x, dy = x[:k], dy[:k, :16]
    pro = ln_cols(x, gamma, beta)
    a_t = x.T.contiguous()
    padded_dy = torch.cat([dy, torch.zeros((SLICE_ROWS - k, 16))])
    got = gemm_tf32x3(landed(a_t, pro, k), padded_dy)
    trimmed = torch.zeros((16, SLICE_ROWS))
    trimmed[:, :k] = pro(a_t)
    assert torch.equal(got, gemm_tf32x3(trimmed, padded_dy))
    want = ln64(x, gamma, beta).T @ dy.double()
    assert _gate_err(got, want) <= MLP_RTOL

    # The fault the kernel avoids, with the pad's rows given a gradient
    # (as the next slice's rows would hold): the pad's LN enters the sum.
    stats_pad = torch.cat([x, torch.zeros((SLICE_ROWS - k, 16))])
    pad_dy = torch.cat([dy, torch.ones((SLICE_ROWS - k, 16))])
    wrong = gemm_tf32x3(ln_cols(stats_pad, gamma, beta)(landed(a_t, lambda v: v, k)), pad_dy)
    assert _gate_err(wrong, want) > MLP_RTOL
