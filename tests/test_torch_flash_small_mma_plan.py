"""PixelSNAIL's f32 flash backward by 3xTF32 ``mma.sync``
(``csrc/flash_bwd_mma_small.cuh``) and its bf16 flash forward on bf16
``mma.sync`` (``csrc/flash_fwd_small_bf16.cuh``), d_k 4, d_v 32 or 8: their
plan on the CPU (arithmetic only). Each kernel's shared memory and grid;
the fragment maps of ``mma.sync`` m16n8k4 and m16n8k8 with TF32 operands
and m16n8k8 and m16n8k16 with bf16 operands (PTX ISA), and the
accumulator read as an A fragment in permuted key order; fragment loads
free of bank conflicts; each causal (query, key) pair taken once, with and
without mask_center; a numpy emulation of both 3xTF32 passes (the split
into big + small, the mma's TF32 reads, fresh sums a tile) against the
plain f32 backward, and of the bf16 forward (q2, the online softmax a
64-key tile, bf16(P), fresh P V sums a tile) against the plain bf16
forward.

The plan is restated here from the kernels' source; the lines it restates
are listed in ``KERNEL_LINES``, and ``test_restated_lines_are_the_kernels``
fails once one of them changes. On the card, ``tests/test_torch_kernels.py``
holds the kernels to their plain versions.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_generative_tpu_torch.ops import attention_cuda

CSRC = Path(attention_cuda.__file__).resolve().parents[1] / "csrc"
BLOCK = 64        # kBlock: rows (keys) a CTA owns, and a streamed tile
WARPS = 4         # kWarps: 16 rows (keys) a warp
DK = 4            # kDK
NB = BLOCK // 8   # kNB: 8-key (8-row) blocks of a tile
GROUP = 4         # kGroup: blocks a sweep takes
STAGES = 2        # kStages
CHUNK = 16        # smma::kChunk: keys of one m16n8k16 P V product
T_LD = BLOCK + 8  # smma::kTLd: row stride of a transposed tile, in values
STATIC_SMEM = 48 * 1024
KERNEL_LINES = {
    "flash_bwd_mma_small.cuh": (
        "constexpr int kBlock = 64;   // rows (keys) a CTA owns, and a streamed tile",
        "constexpr int kWarps = 4;    // 16 rows (keys) a warp",
        "constexpr int kDK = 4;       // d_k",
        "constexpr int kGroup = 4;    // blocks a sweep takes",
        "constexpr int kStages = 2;   // of the cp.async ring",
        "  return D == kDK ? D : D + 4;",
        "  return kBlock * (stride<kDK>() + stride<DV>());",
        "  return dq_stage<DV>() + 2 * kBlock;",
        "  b[0] = g < n_valid ? x[2 * t * S + g] : 0.f;",
        "  b[1] = g < n_valid ? x[(2 * t + 1) * S + g] : 0.f;",
        "      const int row = rows[i % 2], d = 8 * kk + t + 4 * (i / 2);",
        "    lse2[i] = isinf(l) ? CUDART_INF_F : l * kLog2e;",
        "  for (int kt = 0; kt <= qt; ++kt) {",
        "    const int live = blocks_through<kNB>(r0 + 15 - offset - key0);",
        "      if (n0 < live) {",
        "          for (int n = 0; n < kGroup; ++n) bk[n] = ks[(8 * (n0 + n) + g) * SK + t];",
        "            bv[n][0] = vs[(8 * (n0 + n) + g) * SV + 8 * kk + t];",
        "            bv[n][1] = vs[(8 * (n0 + n) + g) * SV + 8 * kk + t + 4];",
        "        const bool diag = key0 + 8 * (n0 + kGroup) - 1 + offset > r0;",
        "            const int i = e / 2, key = key0 + 8 * (n0 + n) + 2 * t + e % 2;",
        "            if (diag && key + offset > rows[i]) p = 0.f;",
        "          b_rows<SK>(bk[0], ks + 8 * (n0 + n) * SK, g, t, kDK);",
        "          mma3(&part[n], a_big, a_small, bk);",
        "  if (t < 2) {  // columns 2 t, 2 t + 1 of d_k = 4",
        "  for (int qi = kt; qi < n_q; ++qi) {",
        "    const int skip = min(kNB, max(0, c0 + offset - row0) / 8);",
        "      if (n0 + kGroup > skip) {",
        "          for (int n = 0; n < kGroup; ++n) bq[n] = qs[(8 * (n0 + n) + g) * SK + t];",
        "            bo[n][0] = dos[(8 * (n0 + n) + g) * SV + 8 * kk + t];",
        "        const bool diag = c0 + 15 + offset > row0 + 8 * n0;",
        "            const int r = 8 * (n0 + n) + 2 * t + e % 2;",
        "            if (diag && keys[e / 2] + offset > row0 + r) p = 0.f;",
        "            b_rows<SV>(bo[nd], dos + 8 * (n0 + n) * SV + 8 * nd, g, t, 8);",
        "          b_rows<SK>(bq[0], qs + 8 * (n0 + n) * SK, g, t, kDK);",
        "    if (t < 2)  // columns 2 t, 2 t + 1 of d_k = 4",
    ),
    "flash_fwd_small_bf16.cuh": (
        "  static constexpr int kPer = kBlock * kQuads / kThreads;  // of them a thread",
        "  __shared__ __align__(16) unsigned short vt_s[DV * kTLd];",
        "  for (int kt = 0; kt <= qt; ++kt) {",
        "      const int key = 8 * nb + g;  // this lane's column of the B fragment",
        "      const uint32_t bk = t == 0 ? k_s[key].x : t == 1 ? k_s[key].y : 0u;",
        "        if (kt == qt && kt * kBlock + 8 * nb + 2 * t + e % 2 + offset > rows[i])",
        "      ms[i] = isinf(m_new) ? 0.f : m_new;",
        "      alpha[i] = isinf(m[i]) ? 0.f : exp2f(m[i] - ms[i]);",
        "    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + ps[i];",
        "        b_t(bv, vt_s, 8 * nd + g, kChunk * ch, t, DV);",
        "      for (int e = 0; e < 4; ++e) o[nd][e] = alpha[e / 2] * o[nd][e] + part[nd][e];",
        "    const float denom = l[i] == 0.f ? 1.f : l[i];",
        "          l[i] == 0.f ? -CUDART_INF_F : m[i] * kLn2 + logf(fmaxf(l[i], 1e-38f));",
    ),
    "mma_tf32.cuh": (
        '  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "',
        '      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(b)));',
        '  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n"',
        "  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);",
    ),
    "flash_mma.cuh": (
        "  a[0] = c[0];",
        "  a[1] = c[2];",
        "  a[2] = c[1];",
        "  a[3] = c[3];",
    ),
}
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4


def test_restated_lines_are_the_kernels():
    for name, lines in KERNEL_LINES.items():
        source = (CSRC / name).read_text()
        missing = [line for line in lines if line not in source]
        assert not missing, f"{name} no longer has: {missing}"


def stride(d):
    """Row stride of a staged f32 tile of d features, in floats."""
    return d if d == DK else d + 4


def smem(dv):
    """Static shared bytes of the f32 dq pass, the dk/dv pass and the bf16
    forward at d_v = dv."""
    dq_stage = BLOCK * (stride(DK) + stride(dv))
    return (4 * STAGES * dq_stage, 4 * STAGES * (dq_stage + 2 * BLOCK),
            8 * BLOCK + 2 * dv * T_LD)


@pytest.mark.parametrize("dv", [32, 8])
def test_shared_memory_and_grid(dv):
    """Static shared memory within 48 KB; every 16-byte cp.async lands on a
    16-byte boundary (rows of 4, 36 or 12 floats, stages of whole rows);
    the bf16 forward's v pieces spread evenly over its 128 threads; the grid
    at PixelSNAIL's main path (B 128, L 784, H 1) is 13 x 1 x 128 CTAs of
    128 threads a kernel."""
    assert smem(dv) == {32: (20480, 21504, 5120), 8: (8192, 9216, 1664)}[dv]
    assert max(smem(dv)) <= STATIC_SMEM
    for d in (DK, dv):
        assert (4 * stride(d)) % 16 == 0
    assert (4 * BLOCK * (stride(DK) + stride(dv))) % 16 == 0
    assert (BLOCK * dv // 4) % (32 * WARPS) == 0
    b, l, h = 128, 784, 1
    assert (-(-l // BLOCK), h, b) == (13, 1, 128)


# ---- The fragment maps (PTX ISA, mma.sync, lane = 4 g + t): (row, column)
# of each lane's value, [lane, register]; bf16 registers hold two values,
# [lane, register, half]. ----

def tf32_a_map(k):
    """A (16 x k): m16n8k4 registers 0, 1 = (g, t), (g + 8, t); m16n8k8
    adds (g, t + 4), (g + 8, t + 4)."""
    reg = np.arange(k // 2)[None, :]
    return G[:, None] + 8 * (reg % 2), T[:, None] + 4 * (reg // 2)


def tf32_b_map(k):
    """B (k x 8): register r holds (t + 4 r, g)."""
    reg = np.arange(k // 4)[None, :]
    return T[:, None] + 4 * reg, G[:, None] + 0 * reg


def c_map():
    """C (16 x 8): element e at (g + 8 (e / 2), 2 t + e % 2)."""
    e = np.arange(4)[None, :]
    return G[:, None] + 8 * (e // 2), 2 * T[:, None] + e % 2


def bf16_a_map(k):
    """A (16 x k), bf16: register r holds rows g + 8 (r % 2), columns 2 t +
    8 (r / 2) and the next."""
    reg, half = np.arange(k // 4)[None, :, None], np.arange(2)[None, None, :]
    return G[:, None, None] + 8 * (reg % 2) + 0 * half, 2 * T[:, None, None] + half + 8 * (reg // 2)


def bf16_b_map(k):
    """B (k x 8), bf16: register r holds rows 2 t + 8 r and the next, column g."""
    reg, half = np.arange(k // 8)[None, :, None], np.arange(2)[None, None, :]
    return 2 * T[:, None, None] + 8 * reg + half, G[:, None, None] + 0 * reg + 0 * half


def _covers(rows, cols, shape):
    flat = np.asarray(rows).ravel() * shape[1] + np.asarray(cols).ravel()
    return sorted(flat) == list(range(shape[0] * shape[1]))


@pytest.mark.parametrize("k", [4, 8])
def test_tf32_fragment_maps_cover_each_element_once(k):
    assert _covers(*tf32_a_map(k), (16, k))
    assert _covers(*tf32_b_map(k), (k, 8))
    assert _covers(*c_map(), (16, 8))


@pytest.mark.parametrize("k", [8, 16])
def test_bf16_fragment_maps_cover_each_element_once(k):
    assert _covers(*bf16_a_map(k), (16, k))
    assert _covers(*bf16_b_map(k), (k, 8))


def _matrix(vals, rows, cols, shape):
    m = np.full(shape, np.nan)
    m[rows, cols] = vals
    assert not np.isnan(m).any()
    return m


def test_accumulator_as_a_fragment_in_permuted_key_order():
    """flash_mma.cuh's a_from_acc (a = c0, c2, c1, c3) with B's rows loaded
    as b_rows loads them (k-index t is key 2 t, t + 4 is key 2 t + 1) is
    the product of the accumulator's 16 x 8 matrix and B: the order of the
    keys inside one mma is all that changes."""
    rng = np.random.default_rng(0)
    acc, bm = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
    crow, ccol = c_map()
    c = acc[crow, ccol]                       # [lane, e]
    a = c[:, [0, 2, 1, 3]]                    # a_from_acc
    b = np.stack([bm[2 * T, G], bm[2 * T + 1, G]], axis=1)  # b_rows
    am = _matrix(a, *tf32_a_map(8), (16, 8))  # the matrix the mma reads
    bmm = _matrix(b, *tf32_b_map(8), (8, 8))
    perm = np.array([0, 2, 4, 6, 1, 3, 5, 7])  # k-index -> key
    np.testing.assert_array_equal(am, acc[:, perm])
    np.testing.assert_array_equal(bmm, bm[perm])
    np.testing.assert_allclose(am @ bmm, acc @ bm, rtol=1e-12, atol=1e-12)


def test_m16n8k4_reads_d_k_exactly():
    """S = q k^T by m16n8k4: the A registers (q rows g, g + 8 at feature t)
    and the B register (k row g at feature t) hold each of d_k = 4
    features once, with no pad; dQ's and dK's B (b_rows with n_valid =
    d_k) is zero in columns 4-7, which the kernel does not store (t < 2)."""
    arow, acol = tf32_a_map(4)
    assert acol.max() == DK - 1 and _covers(arow, acol, (16, DK))
    brow, bcol = tf32_b_map(4)
    assert brow.max() == DK - 1
    crow, ccol = c_map()
    assert set(ccol[T < 2].ravel()) == set(range(DK))


def test_fragment_loads_have_no_bank_conflict():
    """Every shared load of a fragment touches 32 distinct banks, or as many
    as its loading lanes: k or q rows of 4 floats (S, S^T: word 4 g + t;
    dQ, dK: words 4 (2 t) + g and 4 (2 t + 1) + g, g < 4), v or dO rows of
    36 or 12 floats (dP, dP^T: word S g + t (+ 4); dV: S (2 t) + g (+ 8
    nd)); the bf16 forward's k_s (word 2 key + t, t < 2) and v^T (word 36
    n + 8 ch + t)."""
    assert len(set((4 * G + T) % 32)) == 32
    for r in (0, 1):
        w = (4 * (2 * T + r) + G)[G < DK]
        assert len(set(w % 32)) == len(w)
    for dv in (32, 8):
        s = stride(dv)
        for off in (0, 4):
            assert len(set((s * G + T + off) % 32)) == 32
        for nd in range(dv // 8):
            for r in (0, 1):
                assert len(set((s * (2 * T + r) + G + 8 * nd) % 32)) == 32
    for nb in range(NB):
        w = (2 * (8 * nb + G) + T)[T < 2]
        assert len(set(w % 32)) == len(w)
    for ch in range(BLOCK // CHUNK):
        for nd in range(4):
            assert len(set(((T_LD // 2) * (8 * nd + G) + 8 * ch + T) % 32)) == 32


# ---- Each causal pair once. ----

def _blocks_through(last):
    return 0 if last < 0 else min(NB, last // 8 + 1)


def _f32_pairs_counted(L, offset):
    """(dq pass, dk/dv pass) counts of each (row, key) whose p the kernel
    keeps: its group runs (live / skip), the diagonal's mask passes it, its
    row is before L (else lse2 = +inf and p = 0) and, in the dk/dv pass,
    its key is before L (else the key's sums are not stored)."""
    n = -(-L // BLOCK)
    counts = [np.zeros((L + BLOCK, L + BLOCK), np.int64) for _ in range(2)]
    lane_row = np.arange(16)[:, None]
    for a in range(n):
        for w in range(WARPS):
            r0 = a * BLOCK + 16 * w
            for b_ in range(a + 1):  # dq pass: q-tile a, k-tile b_
                key0 = b_ * BLOCK
                live = _blocks_through(r0 + 15 - offset - key0)
                for n0 in range(0, NB, GROUP):
                    if n0 >= live:
                        continue
                    diag = key0 + 8 * (n0 + GROUP) - 1 + offset > r0
                    rows = r0 + lane_row
                    keys = key0 + 8 * n0 + np.arange(8 * GROUP)[None, :]
                    ok = np.broadcast_to(rows < L, (16, 8 * GROUP)).copy()
                    if diag:
                        ok &= ~(keys + offset > rows)
                    np.add.at(counts[0], (np.broadcast_to(rows, ok.shape)[ok],
                                          np.broadcast_to(keys, ok.shape)[ok]), 1)
            c0 = a * BLOCK + 16 * w  # dk/dv pass: k-tile a, q-tiles from a on
            for qi in range(a, n):
                row0 = qi * BLOCK
                skip = min(NB, max(0, c0 + offset - row0) // 8)
                for n0 in range(0, NB, GROUP):
                    if n0 + GROUP <= skip:
                        continue
                    diag = c0 + 15 + offset > row0 + 8 * n0
                    keys = c0 + lane_row
                    rows = row0 + 8 * n0 + np.arange(8 * GROUP)[None, :]
                    ok = (keys < L) & (rows < L)
                    if diag:
                        ok &= ~(keys + offset > rows)
                    np.add.at(counts[1], (np.broadcast_to(rows, ok.shape)[ok],
                                          np.broadcast_to(keys, ok.shape)[ok]), 1)
    return [c[:L, :L] for c in counts] + [c.sum() - c[:L, :L].sum() for c in counts]


def _fwd_pairs_counted(L, offset):
    """The bf16 forward's count of each (row, key) it does not mask, over
    rows before L (the rows it stores): key tiles up to the diagonal, the
    mask on the diagonal tile only."""
    n = -(-L // BLOCK)
    counts = np.zeros((L, L + BLOCK), np.int64)
    for qt in range(n):
        rows = qt * BLOCK + np.arange(BLOCK)[:, None]
        for kt in range(qt + 1):
            keys = kt * BLOCK + np.arange(BLOCK)[None, :]
            ok = np.broadcast_to(rows < L, (BLOCK, BLOCK)).copy()
            if kt == qt:
                ok &= ~(keys + offset > rows)
            np.add.at(counts, (np.broadcast_to(rows, ok.shape)[ok],
                               np.broadcast_to(keys, ok.shape)[ok]), 1)
    return counts


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [1, 17, 64, 65, 200, 784])
def test_every_causal_pair_is_counted_once(l, mask_center):
    """Over the causal tiles and the groups each warp runs, each (query,
    key) with key + offset <= query is kept exactly once by each f32
    backward pass and by the bf16 forward, and no other pair (none past L
    either)."""
    offset = int(mask_center)
    rows, keys = np.indices((l, l))
    want = (keys + offset <= rows).astype(np.int64)
    dq, dkdv, dq_out, dkdv_out = _f32_pairs_counted(l, offset)
    assert (dq == want).all() and (dkdv == want).all()
    assert dq_out == 0 and dkdv_out == 0
    fwd = _fwd_pairs_counted(l, offset)
    assert (fwd[:, :l] == want).all() and fwd[:, l:].sum() == 0


# ---- numpy emulations. ----

def _tf32_round(x):
    """tf32::round: to nearest, ties away from zero, on the magnitude."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _tf32_read(x):
    """What the mma reads of an f32 register: its top 19 bits."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)


def _split(x):
    big = _tf32_round(x)
    return big, (np.asarray(x, np.float32) - big).astype(np.float32)


def _mma(acc, a, b):
    """One TF32 mma: acc + a b, the products of the TF32 reads summed and
    rounded to f32."""
    return (acc + (_tf32_read(a).astype(np.float64) @ _tf32_read(b).astype(np.float64))
            ).astype(np.float32)


def _mma3(acc, a, b):
    """mma3 / mma3_k4: small_a big_b, big_a small_b, big_a big_b."""
    (a_big, a_small), (b_big, b_small) = _split(a), _split(b)
    acc = _mma(acc, a_small, b_big)
    acc = _mma(acc, a_big, b_small)
    return _mma(acc, a_big, b_big)


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x, zeros past its end."""
    out = np.zeros((n, x.shape[1]), np.float32)
    part = x[r0:r0 + n]
    out[:len(part)] = part
    return out


def _pad8(x):
    out = np.zeros((x.shape[0], 8), np.float32)
    out[:, :x.shape[1]] = x
    return out


def _lse2(lse):
    """lse in base 2, +inf where it is -inf (p = 0)."""
    with np.errstate(invalid="ignore"):
        return np.where(np.isinf(lse), np.inf, lse * np.float32(LOG2E)).astype(np.float32)


def emulate_f32_backward(q, k, v, out, dout, lse, offset):
    """Both 3xTF32 passes for one (batch, head) of L rows, warp by warp, a
    group of 4 blocks of 8 keys (rows) at a time, each product by _mma3 in
    the kernel's order, each tile's dQ, dK, dV in fresh sums added in f32:
    returns (dq, dk, dv, delta)."""
    L, dv = q.shape[0], v.shape[1]
    scale = np.float32(0.5)
    sl2 = np.float32(scale * np.float32(LOG2E))
    n = -(-L // BLOCK)
    lse2_all = _lse2(lse.astype(np.float32))
    dq, dk, dvo = (np.zeros((L, d), np.float32) for d in (DK, DK, dv))
    # delta: the lane's columns 8 kk + t, then + 4, then the quad (x0 + x1) + (x2 + x3).
    prod = (dout * out).astype(np.float32)
    lane = np.zeros((L, 4), np.float32)
    for kk in range(dv // 8):
        for off in (0, 4):
            lane = (lane + prod[:, 8 * kk + off + np.arange(4)]).astype(np.float32)
    delta = ((lane[:, 0] + lane[:, 1]) + (lane[:, 2] + lane[:, 3])).astype(np.float32)
    for qt in range(n):
        for w in range(WARPS):
            r0 = qt * BLOCK + 16 * w
            rows = r0 + np.arange(16)
            aq, ado = _rows(q, r0, 16), _rows(dout, r0, 16)
            lse2 = np.where(rows < L, lse2_all[np.minimum(rows, L - 1)], np.inf)[:, None]
            dlt = np.where(rows < L, delta[np.minimum(rows, L - 1)], 0)[:, None]
            dqa = np.zeros((16, 8), np.float32)
            for kt in range(qt + 1):
                key0 = kt * BLOCK
                ks, vs = _rows(k, key0, BLOCK), _rows(v, key0, BLOCK)
                live = _blocks_through(r0 + 15 - offset - key0)
                part = np.zeros((GROUP, 16, 8), np.float32)
                for n0 in range(0, NB, GROUP):
                    if n0 >= live:
                        continue
                    diag = key0 + 8 * (n0 + GROUP) - 1 + offset > r0
                    for j in range(GROUP):
                        kb = slice(8 * (n0 + j), 8 * (n0 + j) + 8)
                        s = _mma3(np.zeros((16, 8), np.float32), aq, ks[kb].T)
                        dp = np.zeros((16, 8), np.float32)
                        for kk in range(dv // 8):
                            f = slice(8 * kk, 8 * kk + 8)
                            dp = _mma3(dp, ado[:, f], vs[kb, f].T)
                        keys = key0 + 8 * (n0 + j) + np.arange(8)[None, :]
                        with np.errstate(invalid="ignore"):
                            p = np.exp2((s * sl2 - lse2).astype(np.float32))
                        if diag:
                            p = np.where(keys + offset > rows[:, None], 0, p)
                        ds = (p * (dp - dlt)).astype(np.float32)
                        part[j] = _mma3(part[j], ds, _pad8(ks[kb]))
                for j in range(GROUP):
                    dqa = (dqa + part[j]).astype(np.float32)
            ok = rows < L
            dq[rows[ok]] = (dqa[ok, :DK] * scale).astype(np.float32)
    for kt in range(n):
        for w in range(WARPS):
            c0 = kt * BLOCK + 16 * w
            keys = c0 + np.arange(16)
            ak, av = _rows(k, c0, 16), _rows(v, c0, 16)
            dka, dva = np.zeros((16, 8), np.float32), np.zeros((16, dv), np.float32)
            for qi in range(kt, n):
                row0 = qi * BLOCK
                qs, dos = _rows(q, row0, BLOCK), _rows(dout, row0, BLOCK)
                r_all = row0 + np.arange(BLOCK)
                lse_s = np.where(r_all < L, lse2_all[np.minimum(r_all, L - 1)], np.inf)
                delta_s = np.where(r_all < L, delta[np.minimum(r_all, L - 1)], 0)
                skip = min(NB, max(0, c0 + offset - row0) // 8)
                dv_part = np.zeros((16, dv), np.float32)
                dk_part = np.zeros((GROUP, 16, 8), np.float32)
                for n0 in range(0, NB, GROUP):
                    if n0 + GROUP <= skip:
                        continue
                    diag = c0 + 15 + offset > row0 + 8 * n0
                    for j in range(GROUP):
                        rb = slice(8 * (n0 + j), 8 * (n0 + j) + 8)
                        st = _mma3(np.zeros((16, 8), np.float32), ak, qs[rb].T)
                        dpt = np.zeros((16, 8), np.float32)
                        for kk in range(dv // 8):
                            f = slice(8 * kk, 8 * kk + 8)
                            dpt = _mma3(dpt, av[:, f], dos[rb, f].T)
                        r = row0 + 8 * (n0 + j) + np.arange(8)[None, :]
                        with np.errstate(invalid="ignore"):
                            p = np.exp2((st * sl2 - lse_s[rb][None, :]).astype(np.float32))
                        if diag:
                            p = np.where(keys[:, None] + offset > r, 0, p)
                        ds = (p * (dpt - delta_s[rb][None, :])).astype(np.float32)
                        for nd in range(dv // 8):
                            f = slice(8 * nd, 8 * nd + 8)
                            dv_part[:, f] = _mma3(dv_part[:, f], p, dos[rb, f])
                        dk_part[j] = _mma3(dk_part[j], ds, _pad8(qs[rb]))
                dva = (dva + dv_part).astype(np.float32)
                for j in range(GROUP):
                    dka = (dka + dk_part[j]).astype(np.float32)
            ok = keys < L
            dk[keys[ok]] = (dka[ok, :DK] * scale).astype(np.float32)
            dvo[keys[ok]] = dva[ok]
    return dq, dk, dvo, delta


def _plain_inputs(l, dv, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((l, DK)).astype(np.float32) for _ in range(2))
    v, dout = (rng.standard_normal((l, dv)).astype(np.float32) for _ in range(2))
    return [torch.from_numpy(x)[None].to(dtype) for x in (q, k, v, dout)]


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [70, 130])
@pytest.mark.parametrize("dv", [32, 8])
def test_emulated_f32_passes_match_the_plain_backward(dv, l, mask_center):
    """The 3xTF32 emulation at L off the 64-row tile: dq, dk and dv within
    2e-6 of max(1, largest magnitude) of the plain f32 backward (f32-level:
    a 1xTF32 product misses it by ~1e-3), delta within 1e-6 of it, and
    under mask_center row 0's dq exactly 0."""
    tq, tk, tv, tdo = _plain_inputs(l, dv, l + dv + mask_center)
    out, lse = attention_cuda.flash_forward_plain(tq, tk, tv, mask_center, 1)
    want = attention_cuda.flash_backward_plain(tq, tk, tv, out, lse, tdo, mask_center, 1)
    got = emulate_f32_backward(*(t[0].numpy() for t in (tq, tk, tv, out, tdo)),
                               lse[0, 0].numpy(), int(mask_center))
    for name, g, r in zip(("dq", "dk", "dv"), got[:3], want):
        r = r[0].numpy()
        assert np.abs(g - r).max() <= 2e-6 * max(1.0, np.abs(r).max()), name
    ref_delta = (out[0] * tdo[0]).sum(-1).numpy()
    assert np.abs(got[3] - ref_delta).max() <= 1e-6 * max(1.0, np.abs(ref_delta).max())
    if mask_center:
        assert (got[0][0] == 0).all()


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        torch.bfloat16).float().numpy()


def emulate_bf16_forward(q, k, v, offset):
    """The bf16 forward for one (batch, head) of L rows (bf16 values as
    f32), a 64-key tile at a time as the kernel walks it: S = q2 k^T, the
    masked tile's row max, alpha, P = exp2(S - m_safe), l = alpha l + the
    tile's f32 row sum, bf16(P) V over 16-key chunks in fresh f32 sums,
    O = alpha O + them; returns (out as bf16 values, lse)."""
    L, dv = v.shape
    sl2 = np.float32((1.0 / DK ** 0.5) * LOG2E)
    q2 = _bf16(q * sl2)
    n = -(-L // BLOCK)
    out, lse = np.zeros((L, dv), np.float32), np.zeros(L, np.float32)
    for qt in range(n):
        rows = qt * BLOCK + np.arange(BLOCK)
        aq = _rows(q2, qt * BLOCK, BLOCK)
        m = np.full((BLOCK, 1), -np.inf, np.float32)
        l = np.zeros((BLOCK, 1), np.float32)
        o = np.zeros((BLOCK, dv), np.float32)
        for kt in range(qt + 1):
            ks, vs = _rows(k, kt * BLOCK, BLOCK), _rows(v, kt * BLOCK, BLOCK)
            s = (aq.astype(np.float64) @ ks.T.astype(np.float64)).astype(np.float32)
            if kt == qt:
                keys = kt * BLOCK + np.arange(BLOCK)[None, :]
                s = np.where(keys + offset > rows[:, None], -np.inf, s).astype(np.float32)
            m_new = np.maximum(m, s.max(1, keepdims=True))
            ms = np.where(np.isinf(m_new), 0, m_new).astype(np.float32)
            with np.errstate(invalid="ignore"):
                alpha = np.where(np.isinf(m), 0, np.exp2(m - ms)).astype(np.float32)
            p = np.exp2((s - ms).astype(np.float32)).astype(np.float32)
            l = (alpha * l + p.sum(1, keepdims=True, dtype=np.float32)).astype(np.float32)
            m = m_new
            pb, part = _bf16(p), np.zeros((BLOCK, dv), np.float32)
            for ch in range(BLOCK // CHUNK):
                c = slice(CHUNK * ch, CHUNK * ch + CHUNK)
                part = (part + pb[:, c].astype(np.float64) @ vs[c].astype(np.float64)
                        ).astype(np.float32)
            o = (alpha * o + part).astype(np.float32)
        ok = rows < L
        denom = np.where(l == 0, 1, l)
        out[rows[ok]] = _bf16(o / denom)[ok]
        with np.errstate(divide="ignore"):
            lse_t = np.where(l == 0, -np.inf,
                             m * np.float32(LN2) + np.log(np.maximum(l, 1e-38))).astype(np.float32)
        lse[rows[ok]] = lse_t[ok, 0]
    return out, lse


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [70, 130])
@pytest.mark.parametrize("dv", [32, 8])
def test_emulated_bf16_forward_matches_the_plain_bf16_forward(dv, l, mask_center):
    """The emulation at L off the 64-key tile: out within 2 bf16 steps of
    max(1, largest magnitude) of the plain bf16 forward (the card's gate),
    lse within 1e-6 of max(1, largest |lse|) where finite, -inf at the
    same rows; under mask_center row 0 gets out 0 and lse -inf."""
    tq, tk, tv, _ = _plain_inputs(l, dv, l + dv + mask_center, torch.bfloat16)
    want_out, want_lse = attention_cuda._flash_forward_bf16_plain(tq, tk, tv, mask_center, 1)
    out, lse = emulate_bf16_forward(*(t[0].float().numpy() for t in (tq, tk, tv)),
                                    int(mask_center))
    r_out, r_lse = want_out[0].float().numpy(), want_lse[0, 0].numpy()
    assert np.abs(out - r_out).max() <= 2.0 ** -7 * max(1.0, np.abs(r_out).max())
    fin = np.isfinite(r_lse)
    assert (np.isfinite(lse) == fin).all()
    assert np.abs(lse[fin] - r_lse[fin]).max() <= 1e-6 * max(1.0, np.abs(r_lse[fin]).max())
    if mask_center:
        assert (out[0] == 0).all() and np.isneginf(lse[0])
