"""The numerics that ``csrc/gemm_tf32x3.cuh`` (the fused attention block's
products) rests on, emulated in PyTorch on the CPU.

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
"""

import numpy as np
import pytest
import torch

BLOCK_RTOL = 1e-4  # chip_smoke.py's gate on the block's y and attn
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
    accumulator, which is what the kernel avoids)."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = a - a_big, b - b_big
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], K_STEP):
        part = torch.zeros_like(acc) if fresh else acc
        for kk in range(k0, min(k0 + K_STEP, a.shape[1]), MMA_K):
            ks = slice(kk, kk + MMA_K)
            for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
                part = mma(part, x[:, ks], y[ks])
        acc = acc + part if fresh else part
    return acc


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
