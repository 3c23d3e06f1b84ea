"""The arithmetic of the fused VQ kernel (``csrc/vq.cu``), emulated in
PyTorch on the CPU.

(a) The scores: x and the codebook split into big = tf32(x), rounded as
``csrc/mma_tf32.cuh``'s ``round``, and small = x - big; per k-slice of 8
features the mma products small_a big_b, big_a small_b, big_a big_b, each
an mma modelled as the exact sum of its products and its accumulator, cut
toward zero to float32 (as the tensor cores' sums round); fresh
accumulators per k-step of 32 features, added in float32; |e|^2 summed as
the kernel's split step sums it (four threads a code, each a fixed share of
its float4s, the four sums added in a fixed order, chunk after chunk of 64
features); the score 2 acc - |e|^2 in float32. Its argmax is held to a
float64 argmax: a row may pick another code only where its two best scores
are closer than ``VQ_NEAR_TIE`` of the largest |score| (``chip_smoke.py``'s
gate).

(b) The statistics: each block of ``vq_cuda.BLOCK_ROWS`` rows sorted stably
by code, its (count, row-order sum) entries and its code-to-entry map laid
out as ``vq_cuda.scratch_bytes`` says, and the gather's fixed order
(``GATHER_THREADS`` blocks a round, a code's entries split over the threads
of each float4), held to ``one_hot.T @ x``: counts exact, sums within 1e-5
of the largest |sum|.
"""

import numpy as np
import pytest
import torch

from pytorch_generative_tpu_torch.ops import vq_cuda
from pytorch_generative_tpu_torch.ops.vq import nearest_codebook

VQ_NEAR_TIE = 1e-5  # chip_smoke.py's near-tie share of the largest |score|
SUMS_RTOL = 1e-5    # chip_smoke.py's VQ_SUMS_RTOL
K_STEP, MMA_K, CHUNK = 32, 8, 64  # the kernel's k-step, mma depth, features an item


def tf32_round(x):
    """x rounded to TF32 as mma_tf32.cuh's round: add half a TF32 ulp to
    the bits, clear the low 13."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x):
    """The top 19 bits of x: what an mma reads of an f32 operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def toward_zero(x64):
    """float64 values cut to float32 toward zero."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def padded_width(d):
    """D as the kernel pads it: to 8 up to 64, to a multiple of 64 above."""
    return -(-d // 8) * 8 if d <= CHUNK else -(-d // CHUNK) * CHUNK


def kernel_norms(cb):
    """|e_k|^2 in float32 as the split step sums it: per chunk of the
    padded width, thread q of a code sums the squares of its float4s
    (2q, 2q + 1, 2q + 8, 2q + 9 when a row has 8 or 16 of them, else q, q +
    4, ...) one feature at a time, the four sums are added as (p0 + p1) +
    (p2 + p3), and the chunks' sums are added in order."""
    k, d = cb.shape
    dp = padded_width(d)
    e = torch.zeros((k, dp), dtype=torch.float32)
    e[:, :d] = cb
    width = min(dp, CHUNK)
    f4 = width // 4
    total = None
    for c0 in range(0, dp, width):
        parts = []
        for q in range(4):
            if f4 % 8 == 0:
                order = [2 * q + jj % 2 + 8 * (jj // 2) for jj in range(f4 // 4)]
            else:
                order = list(range(q, f4, 4))
            p = torch.zeros(k, dtype=torch.float32)
            for j in order:
                for u in range(4):
                    v = e[:, c0 + 4 * j + u].double()
                    p = (v * v + p.double()).float()  # fmaf: one rounding
            parts.append(p)
        part = (parts[0] + parts[1]) + (parts[2] + parts[3])
        total = part if total is None else total + part
    return total


def kernel_scores(x, cb):
    """2 x.e - |e|^2 (M, K) as the kernel's products and epilogue compute
    them."""
    d, dp = x.shape[1], padded_width(x.shape[1])
    xp = torch.zeros((x.shape[0], dp), dtype=torch.float32)
    ep = torch.zeros((cb.shape[0], dp), dtype=torch.float32)
    xp[:, :d], ep[:, :d] = x, cb
    a_big, b_big = tf32_round(xp), tf32_round(ep)
    a_small, b_small = xp - a_big, ep - b_big
    acc = torch.zeros((x.shape[0], cb.shape[0]), dtype=torch.float32)
    for k0 in range(0, dp, K_STEP):
        part = torch.zeros_like(acc)
        for kk in range(k0, min(k0 + K_STEP, dp), MMA_K):
            ks = slice(kk, kk + MMA_K)
            for a, b in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
                part = toward_zero(part.double() + tf32_cut(a[:, ks]).double()
                                   @ tf32_cut(b[:, ks]).double().T)
        acc = acc + part
    return 2.0 * acc - kernel_norms(cb)


def _draw(m, k, d, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)))


def _near_boundaries(x, cb, seed):
    """x with every other row moved next to the boundary of two codes a and
    b: (e_a + e_b) / 2 + delta (e_a - e_b), delta log-uniform in [10^-5.5,
    10^-3], so that the two codes' scores differ by up to about a hundred
    times the near-tie gate. A 1xTF32 product takes the other code on some
    of these rows; random rows alone are too far from any boundary."""
    rng = np.random.default_rng(seed)
    m, k = x.shape[0], cb.shape[0]
    a, b = (torch.from_numpy(rng.integers(0, k, m)) for _ in range(2))
    delta = torch.from_numpy(10.0 ** rng.uniform(-5.5, -3.0, m)).float()[:, None]
    near = 0.5 * (cb[a] + cb[b]) + delta * (cb[a] - cb[b])
    return torch.where((torch.arange(m) % 2 == 0)[:, None], near, x)


@pytest.mark.parametrize("m,k,d", [(2048, 512, 64), (256, 512, 12), (256, 200, 256)])
def test_tf32x3_scores_pick_the_float64_code_but_on_near_ties(m, k, d):
    """The emulated kernel's argmax equals the float64 argmax on every row
    whose two best float64 scores are further apart than VQ_NEAR_TIE of the
    largest |score|; a differing row still takes one of its two best codes.
    Half the rows lie next to the boundary of two codes. D = 64 is
    VQ-VAE's, 12 pads to 16, 256 walks four chunks of 64."""
    x, cb = _draw(m, k, d, seed=m + k + d)
    x = _near_boundaries(x, cb, seed=d)
    want = 2.0 * (x.double() @ cb.double().T) - (cb.double() ** 2).sum(1)
    got = kernel_scores(x, cb).argmax(1)
    top2 = want.topk(2, dim=1)
    near = (top2.values[:, 0] - top2.values[:, 1]) <= VQ_NEAR_TIE * float(want.abs().max())
    differ = got != top2.indices[:, 0]
    assert not bool((differ & ~near).any())
    assert bool((got[differ] == top2.indices[differ, 1]).all())


def test_kernel_norms_lie_within_float32_rounding_of_float64():
    """|e|^2 in the split step's order, within a few float32 ulps of the
    float64 sum at D = 64, 12 and 256."""
    for d in (64, 12, 256):
        _, cb = _draw(1, 300, d, seed=d)
        want = (cb.double() ** 2).sum(1)
        assert float(((kernel_norms(cb).double() - want) / want).abs().max()) <= 8 * 2.0 ** -24


def table_and_gather(codes, x, k):
    """counts (K,) and sums (K, D) through the kernel's index math: each
    block of BLOCK_ROWS rows sorted stably by code into (count, row-order
    sum) entries, codes ascending, with a map code -> entry (-1 absent), in
    the scratch layout's shapes; then the gather's order: rounds of
    GATHER_THREADS blocks, a code's entries of a round split over `parts`
    threads (thread u adds entries u, u + parts, ... in block order), the
    parts added in order into the running sum."""
    m, d = x.shape
    r = vq_cuda.BLOCK_ROWS
    n_blocks = -(-m // r)
    row_bytes = -(-k // 4) * 4
    assert vq_cuda.scratch_bytes(m, k, d) == 4 * n_blocks * r * (d + 1) + n_blocks * row_bytes
    t_sum = torch.zeros((n_blocks, r, d), dtype=torch.float32)
    t_count = torch.zeros((n_blocks, r), dtype=torch.int32)
    t_pos = torch.full((n_blocks, row_bytes), -1, dtype=torch.int8)
    for b in range(n_blocks):
        rows = torch.arange(b * r, min(m, b * r + r))
        order = rows[torch.argsort(codes[rows], stable=True)]
        present = torch.unique_consecutive(codes[order])
        assert len(present) <= r and bool((present[1:] > present[:-1]).all())
        for e, c in enumerate(present.tolist()):
            members = order[codes[order] == c]  # row order within the code
            s = torch.zeros(d, dtype=torch.float32)
            for i in members.tolist():
                s = s + x[i]
            t_sum[b, e], t_count[b, e], t_pos[b, c] = s, len(members), e
    parts = vq_cuda.GATHER_THREADS // (vq_cuda.GATHER_CODES * (d // 4))
    counts = torch.zeros(k, dtype=torch.float32)
    sums = torch.zeros((k, d), dtype=torch.float32)
    for c in range(k):
        acc, cnt = torch.zeros(d, dtype=torch.float32), 0
        for b0 in range(0, n_blocks, vq_cuda.GATHER_THREADS):
            blocks = range(b0, min(n_blocks, b0 + vq_cuda.GATHER_THREADS))
            entries = [(b, int(t_pos[b, c])) for b in blocks if int(t_pos[b, c]) >= 0]
            shares = []
            for u in range(parts):
                s, n = torch.zeros(d, dtype=torch.float32), 0
                for b, e in entries[u::parts]:
                    s, n = s + t_sum[b, e], n + int(t_count[b, e])
                shares.append((s, n))
            for s, n in shares:
                acc, cnt = acc + s, cnt + n
        sums[c], counts[c] = acc, float(cnt)
    return counts, sums


@pytest.mark.parametrize("case", ["ragged M", "K=1", "K=2000", "one code", "many blocks D=4"])
def test_table_and_gather_match_the_one_hot_statistics(case):
    """Counts exact, sums within 1e-5 of the largest |sum| of one_hot.T @ x,
    at a ragged M (a last block of 40 rows), K = 1, K = 2000 (most codes
    unused, map rows of 2000 bytes), every row on one code (a code with an
    entry in every block), and more blocks than a gather round at D = 4
    (64 threads a float4)."""
    m, k, d = {"ragged M": (1000, 37, 12), "K=1": (300, 1, 8), "K=2000": (777, 2000, 16),
               "one code": (1000, 64, 64), "many blocks D=4": (260 * 64 + 5, 3, 4)}[case]
    x, cb = _draw(m, k, d, seed=k)
    if case == "one code":
        x = cb[5] + 0.01 * x
    codes = nearest_codebook(x, cb)
    one_hot = torch.nn.functional.one_hot(codes, k).float()
    want_counts, want_sums = one_hot.sum(0), one_hot.T.double() @ x.double()
    counts, sums = table_and_gather(codes, x, k)
    assert torch.equal(counts, want_counts)
    scale = float(want_sums.abs().max())
    assert float((sums.double() - want_sums).abs().max()) <= SUMS_RTOL * scale


def test_boundary_rows_tell_one_tf32_product_from_three():
    """The rows next to a two-code boundary are what give the score test
    its teeth: a single TF32 product (big_a big_b alone) picks another code
    than float64 on clear rows there, the kernel's 3xTF32 on none."""
    x, cb = _draw(2048, 512, 64, seed=2048 + 512 + 64)
    x = _near_boundaries(x, cb, seed=64)
    want = 2.0 * (x.double() @ cb.double().T) - (cb.double() ** 2).sum(1)
    top2 = want.topk(2, dim=1)
    clear = (top2.values[:, 0] - top2.values[:, 1]) > VQ_NEAR_TIE * float(want.abs().max())
    one = (2.0 * (tf32_round(x).double() @ tf32_round(cb).double().T).float()
           - kernel_norms(cb)).argmax(1)
    three = kernel_scores(x, cb).argmax(1)
    assert bool(((one != top2.indices[:, 0]) & clear).any())
    assert not bool(((three != top2.indices[:, 0]) & clear).any())
