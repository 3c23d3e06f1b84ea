"""PixelSNAIL's bf16 flash backward on bf16 ``mma.sync``
(``csrc/flash_bwd_mma_bf16.cuh``: d_k 4, d_v 32 or 8), its plan on the CPU
(arithmetic only): each pass's shared memory and grid; the fragment maps
of ``mma.sync`` m16n8k8 and m16n8k16 with bf16 operands (PTX ISA), by
which lane holds which (row, key) of S, dP and dS, the padded columns of
dQ and dK that the kernel does not store, and fragment loads free of bank
conflicts; a numpy emulation of both passes, fragment by fragment as the
kernel reads its operands and rounds, against the plain bf16 backward; and
a check that over the causal tiles, with and without mask_center, every
(query, key) pair is counted once.

The plan is restated here from the kernel's source; the lines it restates
are listed in ``KERNEL_LINES``, and ``test_restated_lines_are_the_kernels``
fails once one of them changes. On the card, ``tests/test_torch_kernels.py``
holds the kernel to its plain version.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_generative_tpu_torch.ops import attention_cuda

SOURCE = Path(attention_cuda.__file__).resolve().parents[1] / "csrc" / "flash_bwd_mma_bf16.cuh"
BLOCK = 64        # kBlock: rows (keys) a CTA owns, and a streamed tile
WARPS = 4         # kWarps: 16 rows (keys) a warp
CHUNK = 16        # kChunk
DK = 4            # kDK
T_LD = BLOCK + 8  # kTLd: row stride of a transposed tile, in values
STATIC_SMEM = 48 * 1024
KERNEL_LINES = (
    "constexpr int kBlock = 64;            // rows (keys) a CTA owns, and a streamed tile",
    "constexpr int kWarps = 4;             // 16 rows (keys) a warp",
    "constexpr int kChunk = 16;            // keys (rows) of one m16n8k16 product over them",
    "constexpr int kDK = 4;                // d_k",
    "constexpr int kTLd = kBlock + 8;      // row stride of a transposed tile, in values",
    "  return D / 2 + 4;",
    "  const int rows[2] = {qt * kBlock + 16 * warp + g, qt * kBlock + 16 * warp + g + 8};",
    "  const int keys[2] = {kt * kBlock + 16 * warp + g, kt * kBlock + 16 * warp + g + 8};",
    "    const int row = rows[i % 2], d = 16 * kb + 2 * t + 8 * (i / 2);",
    "    uint32_t v = t < 2 && rows[i] < L ? ld2<kDK>(o, b, rows[i], h, 2 * t) : 0u;",
    "    mma_k8(acc, a8, brow[t], zero);",
    "      const uint32_t bb[2] = {brow[8 * kb + t], brow[8 * kb + 4 + t]};",
    "  a[0] = bf16::pack(x[0][0], x[0][1]);",
    "  a[1] = bf16::pack(x[0][2], x[0][3]);",
    "  a[2] = bf16::pack(x[1][0], x[1][1]);",
    "  a[3] = bf16::pack(x[1][2], x[1][3]);",
    "  b[0] = n < n_valid ? row[t] : 0u;",
    "  b[1] = n < n_valid ? row[4 + t] : 0u;",
    "  for (int kt = 0; kt <= qt; ++kt) {",
    "        const int key = kChunk * ch + 8 * nb + g;  // this lane's column of the B fragments",
    "        const uint32_t bk = t == 0 ? k_s[key].x : t == 1 ? k_s[key].y : 0u;",
    "          const int key = kt * kBlock + kChunk * ch + 8 * nb + 2 * t + e % 2;",
    "          const bool ok = live[i] && key < L && key + offset <= rows[i];",
    "      b_t(bk, kt_s, g, kChunk * ch, t, kDK);",
    "  if (t < 2) {  // columns 2 t, 2 t + 1 of d_k = 4",
    "  for (int qt = kt; qt < n_q_tiles; ++qt) {",
    "        const int r = kChunk * ch + 8 * nb + g;  // this lane's column of the B fragments",
    "        const uint32_t bq = t == 0 ? q_s[r].x : t == 1 ? q_s[r].y : 0u;",
    "          const int r = kChunk * ch + 8 * nb + 2 * t + e % 2;",
    "          const bool ok = keys[i] < L && !isinf(l2) && keys[i] + offset <= qt * kBlock + r;",
    "        b_t(bo, dot_s, 8 * nd + g, kChunk * ch, t, DV);",
    "      b_t(bq, qt_s, g, kChunk * ch, t, kDK);",
    "    if (t < 2)  // dS^T q2 ln 2: columns 2 t, 2 t + 1 of d_k = 4",
)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4


def words(d):
    """Row stride of a staged tile of d values, in 32-bit words."""
    return d // 2 + 4


def smem(dv):
    """Static shared bytes of the dq and the dk/dv pass at d_v = dv."""
    dq = 8 * BLOCK + 2 * DK * T_LD + 4 * BLOCK * words(dv)
    dkdv = 8 * BLOCK + 2 * DK * T_LD + 4 * BLOCK * words(dv) + 2 * dv * T_LD + 2 * 4 * BLOCK
    return dq, dkdv


# ---- The fragment maps (PTX ISA, mma.sync with .bf16 operands, lane =
# 4 g + t): (row, column) of each lane's value, [lane, register, half]. ----

def a_map(k):
    """A (16 x k): m16n8k8 registers 0, 1 = rows g, g + 8 at columns 2 t,
    2 t + 1; m16n8k16 registers 2, 3 the same rows 8 columns on."""
    regs = k // 4
    reg, half = np.arange(regs)[None, :, None], np.arange(2)[None, None, :]
    rows = G[:, None, None] + 8 * (reg % 2) + 0 * half
    cols = 2 * T[:, None, None] + half + 8 * (reg // 2)
    return rows, cols


def b_map(k):
    """B (k x 8): register r holds rows (k index) 2 t + 8 r, + 1 of column g."""
    reg, half = np.arange(k // 8)[None, :, None], np.arange(2)[None, None, :]
    return 2 * T[:, None, None] + 8 * reg + half, G[:, None, None] + 0 * reg + 0 * half


def c_map():
    """C (16 x 8): element e at row g + 8 (e / 2), column 2 t + e % 2."""
    e = np.arange(4)[None, :]
    return G[:, None] + 8 * (e // 2), 2 * T[:, None] + e % 2


def _matrix(vals, rows, cols, shape):
    m = np.full(shape, np.nan)
    m[rows, cols] = vals
    assert not np.isnan(m).any()
    return m


def mma(a, b):
    """The product of per-lane fragments: a [32, k / 4, 2], b [32, k / 8, 2];
    returns C [32, 4] in f32."""
    k = 4 * a.shape[1]
    am = _matrix(a, *a_map(k), (16, k))
    bm = _matrix(b, *b_map(k), (k, 8))
    c = (am @ bm).astype(np.float32)
    return c[c_map()]


@pytest.mark.parametrize("k", [8, 16])
def test_fragment_maps_cover_each_element_once(k):
    """Each map puts every element of its matrix in exactly one lane's
    register half."""
    for (rows, cols), shape in ((a_map(k), (16, k)), (b_map(k), (k, 8))):
        flat = rows.ravel() * shape[1] + cols.ravel()
        assert sorted(flat) == list(range(shape[0] * shape[1]))
    rows, cols = c_map()
    assert sorted((rows * 8 + cols).ravel()) == list(range(128))


def test_two_accumulator_blocks_are_one_a_fragment():
    """The kernel's a_of: packed pairs of two neighbouring 8-column
    accumulator blocks (registers 0-3: block 0 elements 0-1, 2-3, block 1
    elements 0-1, 2-3) hold, by the m16n8k16 A map, the same (row, column)
    of the 16-column matrix as the accumulators: S, dP and dS never leave
    the registers."""
    crow, ccol = c_map()
    arow, acol = a_map(16)
    for lane in range(32):
        for reg in range(4):
            nb, e0 = reg // 2, 2 * (reg % 2)
            for half in range(2):
                assert (arow[lane, reg, half], acol[lane, reg, half]) == (
                    crow[lane, e0 + half], 8 * nb + ccol[lane, e0 + half])


def test_restated_lines_are_the_kernels():
    source = SOURCE.read_text()
    missing = [line for line in KERNEL_LINES if line not in source]
    assert not missing, f"{SOURCE.name} no longer has: {missing}"


@pytest.mark.parametrize("dv", [32, 8])
def test_shared_memory_and_grid(dv):
    """Static shared memory within 48 KB (ptxas on an H100 reported 6,208 /
    11,328 bytes at d_v 32, 3,136 / 4,800 at 8); every 32-bit fragment
    load's address 4-byte aligned; the grid at PixelSNAIL's main path (B
    128, L 784, H 1) is 13 x 1 x 128 CTAs of 128 threads a pass."""
    assert smem(dv) == {32: (6208, 11328), 8: (3136, 4800)}[dv]
    assert max(smem(dv)) <= STATIC_SMEM
    assert (2 * T_LD) % 4 == 0 and (2 * CHUNK) % 4 == 0
    b, l, h = 128, 784, 1
    assert (-(-l // BLOCK), h, b) == (13, 1, 128)


def test_fragment_loads_have_no_bank_conflict():
    """The B fragments the passes load each touch 32 banks: rows of a
    d_v = 32 tile at 20 words (v, dO: word 20 g + 8 kb + t), rows of a
    transposed tile at 36 words (k^T, q2^T, dO^T: word 36 n + 8 ch + t);
    k_s and q_s as 8-byte rows (word 2 g + t, t < 2)."""
    for kb in range(2):
        assert len({(words(32) * G + 8 * kb + T)[i] % 32 for i in range(32)}) == 32
    for ch in range(BLOCK // CHUNK):
        for nd in range(4):
            w = (T_LD // 2) * (8 * nd + G) + 8 * ch + T
            assert len(set(w % 32)) == 32
    w = (2 * G + T)[T < 2]
    assert len(set(w % 32)) == len(w)


# Each lane's pair of d_k columns (2 t, 2 t + 1), clamped: lanes t >= 2 hold
# the zero pad, which the kernel writes without a load.
_D_PAIR = np.minimum(2 * T[:, None] + np.arange(2), DK - 1)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16).float().numpy()


def _tile(x, row0):
    """Rows [row0, row0 + BLOCK) of x, zeros past its end."""
    out = np.zeros((BLOCK, x.shape[1]), np.float32)
    part = x[row0:row0 + BLOCK]
    out[:len(part)] = part
    return out


def _a_rows(x, rows, kb, dv):
    """a_rows: the A fragment of rows (g, g + 8) over columns [16 kb, 16 kb
    + 16) (d_v = 8: two registers), zeros past L."""
    L = x.shape[0]
    regs = 2 if dv == 8 else 4
    a = np.zeros((32, regs, 2), np.float32)
    for reg in range(regs):
        r = rows[reg % 2]
        for half in range(2):
            d = 16 * kb + 2 * T + 8 * (reg // 2) + half
            ok = r < L
            a[ok, reg, half] = x[r[ok], d[ok]]
    return a


def _a_dk(x, rows, scale=None):
    """a_dk: d_k 4 zero-padded to the m16n8k8 depth, times scale and
    rounded to bf16 when scaled."""
    L = x.shape[0]
    a = np.zeros((32, 2, 2), np.float32)
    for reg in range(2):
        for half in range(2):
            ok = (T < 2) & (rows[reg] < L)
            v = x[rows[reg][ok], (2 * T + half)[ok]]
            a[ok, reg, half] = _bf16(v * np.float32(scale)) if scale is not None else v
    return a


def _dot_dv(a, rows_tile, col, dv):
    """dot_dv: dP (dP^T) of the A fragments and the staged rows at column
    `col` of each lane's B fragment (word 8 kb + t, 8 kb + 4 + t)."""
    if dv == 8:
        b = rows_tile[col[:, None], 2 * T[:, None] + np.arange(2)][:, None, :]
        return mma(a[0], b)
    acc = np.zeros((32, 4), np.float32)
    for kb in range(dv // 16):
        b = np.stack([rows_tile[col[:, None], 16 * kb + 8 * r + 2 * T[:, None] + np.arange(2)]
                      for r in range(2)], axis=1)
        acc = acc + mma(a[kb], b)
    return acc


def _a_of(x):
    """a_of: the m16n8k16 A fragment of two accumulator blocks, rounded."""
    return _bf16(np.stack([x[0][:, 0:2], x[0][:, 2:4], x[1][:, 0:2], x[1][:, 2:4]], axis=1))


def _b_t(tr, n, c0, n_valid):
    """b_t: column n of a transposed tile tr ([n][c]) from column c0."""
    b = np.zeros((32, 2, 2), np.float32)
    ok = n < n_valid
    for reg in range(2):
        cols = c0 + 8 * reg + 2 * T[:, None] + np.arange(2)
        b[ok, reg] = tr[n[ok][:, None], cols[ok]]
    return b


def emulate(q, k, v, out, dout, lse, offset):
    """Both passes for one (batch, head) of L rows, fragment by fragment as
    the kernel reads its operands: returns (dq, dk, dv, delta) in f32 of
    bf16 values, and the largest |value| of dQ's and dK's padded columns."""
    L, dv = q.shape[0], v.shape[1]
    scale, scale_log2 = np.float32(0.5), np.float32(0.5 * LOG2E)
    n_tiles = -(-L // BLOCK)
    dq, dk, dvo = (np.zeros((L, d), np.float32) for d in (DK, DK, dv))
    delta = np.zeros(L, np.float32)
    pad = 0.0
    lse2_all = lse.astype(np.float32) * np.float32(LOG2E)
    for qt in range(n_tiles):
        for w in range(WARPS):
            rows = [qt * BLOCK + 16 * w + G, qt * BLOCK + 16 * w + G + 8]
            aq = _a_dk(q, rows, scale_log2)
            ado = [_a_rows(dout, rows, kb, dv) for kb in range(max(dv // 16, 1))]
            dlt, lse2, live = [], [], []
            for r in rows:
                ok = r < L
                part = np.zeros(32, np.float32)
                for c in range(dv // 8):
                    for half in range(2):
                        d = 8 * c + 2 * T + half
                        part[ok] += dout[r[ok], d[ok]] * out[r[ok], d[ok]]
                s = part.reshape(8, 4).sum(1).repeat(4)  # the row's 4 lanes
                dlt.append(s)
                l2 = np.where(ok, lse2_all[np.minimum(r, L - 1)], -np.inf)
                lse2.append(l2)
                live.append(ok & np.isfinite(l2))
                delta[r[ok]] = s[ok]
            acc = np.zeros((32, 4), np.float32)
            for kt in range(qt + 1):
                kt_rows, v_rows = _tile(k, kt * BLOCK), _tile(v, kt * BLOCK)
                for ch in range(BLOCK // CHUNK):
                    s, dp = [], []
                    for nb in range(2):
                        col = CHUNK * ch + 8 * nb + G
                        bk = np.where((T < 2)[:, None], kt_rows[col[:, None], _D_PAIR], 0)
                        s.append(mma(aq, bk[:, None, :]))
                        dp.append(_dot_dv(ado, v_rows, col, dv))
                    for nb in range(2):
                        for e in range(4):
                            i = e // 2
                            key = kt * BLOCK + CHUNK * ch + 8 * nb + 2 * T + e % 2
                            ok = live[i] & (key < L) & (key + offset <= rows[i])
                            p = np.where(ok, np.exp2(s[nb][:, e] - np.where(ok, lse2[i], 0)), 0)
                            s[nb][:, e] = p * (dp[nb][:, e] - dlt[i])
                    part = mma(_a_of(s), _b_t(kt_rows.T, G, CHUNK * ch, DK))
                    acc = acc + part
            pad = max(pad, float(np.abs(acc[T >= 2]).max()))
            for i in range(2):
                ok = (T < 2) & (rows[i] < L)
                for half in range(2):
                    dq[rows[i][ok], (2 * T + half)[ok]] = _bf16(acc[ok, 2 * i + half] * scale)
    for kt in range(n_tiles):
        for w in range(WARPS):
            keys = [kt * BLOCK + 16 * w + G, kt * BLOCK + 16 * w + G + 8]
            ak = _a_dk(k, keys)
            av = [_a_rows(v, keys, kb, dv) for kb in range(max(dv // 16, 1))]
            dk_acc, dv_acc = np.zeros((32, 4), np.float32), np.zeros((dv // 8, 32, 4), np.float32)
            for qt in range(kt, n_tiles):
                q_rows = _bf16(_tile(q, qt * BLOCK) * scale_log2)
                do_rows = _tile(dout, qt * BLOCK)
                row = qt * BLOCK + np.arange(BLOCK)
                lse_s = np.where(row < L, lse2_all[np.minimum(row, L - 1)], -np.inf)
                delta_s = np.where(row < L, delta[np.minimum(row, L - 1)], 0)
                for ch in range(BLOCK // CHUNK):
                    s, dp = [], []
                    for nb in range(2):
                        col = CHUNK * ch + 8 * nb + G
                        bq = np.where((T < 2)[:, None], q_rows[col[:, None], _D_PAIR], 0)
                        s.append(mma(ak, bq[:, None, :]))
                        dp.append(_dot_dv(av, do_rows, col, dv))
                    for nb in range(2):
                        for e in range(4):
                            i = e // 2
                            r = CHUNK * ch + 8 * nb + 2 * T + e % 2
                            l2 = lse_s[r]
                            ok = (keys[i] < L) & np.isfinite(l2) & (keys[i] + offset <= qt * BLOCK + r)
                            p = np.where(ok, np.exp2(s[nb][:, e] - np.where(ok, l2, 0)), 0)
                            s[nb][:, e] = p
                            dp[nb][:, e] = p * (dp[nb][:, e] - delta_s[r])
                    ap, ads = _a_of(s), _a_of(dp)
                    for nd in range(dv // 8):
                        dv_acc[nd] = dv_acc[nd] + mma(ap, _b_t(do_rows.T, 8 * nd + G, CHUNK * ch, dv))
                    dk_acc = dk_acc + mma(ads, _b_t(q_rows.T, G, CHUNK * ch, DK))
            pad = max(pad, float(np.abs(dk_acc[T >= 2]).max()))
            for i in range(2):
                ok = keys[i] < L
                for half in range(2):
                    okk = ok & (T < 2)
                    dk[keys[i][okk], (2 * T + half)[okk]] = _bf16(
                        dk_acc[okk, 2 * i + half] * np.float32(LN2))
                    for nd in range(dv // 8):
                        dvo[keys[i][ok], (8 * nd + 2 * T + half)[ok]] = _bf16(
                            dv_acc[nd][ok, 2 * i + half])
    return dq, dk, dvo, delta, pad


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [70, 130])
@pytest.mark.parametrize("dv", [32, 8])
def test_emulated_passes_match_the_plain_bf16_backward(dv, l, mask_center):
    """The emulation at L off the 64-row tile: dq, dk and dv within 2 bf16
    steps of max(1, largest magnitude) of the plain bf16 backward (the
    gate the card test holds the kernel to), delta within 1e-6 of it,
    dQ's and dK's padded columns 0 (the kernel does not store them), and
    under mask_center row 0's dq exactly 0."""
    rng = np.random.default_rng(l + dv + mask_center)
    q, k = (_bf16(rng.standard_normal((l, DK))) for _ in range(2))
    v, dout = (_bf16(rng.standard_normal((l, dv))) for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(x)[None].to(torch.bfloat16) for x in (q, k, v, dout))
    out, lse = attention_cuda._flash_forward_bf16_plain(tq, tk, tv, mask_center, 1)
    want = attention_cuda._flash_backward_bf16_plain(tq, tk, tv, out, lse, tdo, mask_center, 1)
    got = emulate(q, k, v, out[0].float().numpy(), dout, lse[0, 0].numpy(), int(mask_center))
    for name, g, r in zip(("dq", "dk", "dv"), got[:3], want):
        r = r[0].float().numpy()
        assert np.abs(g - r).max() <= 2.0 ** -7 * max(1.0, np.abs(r).max()), name
    ref_delta = (out[0].float() * tdo[0].float()).sum(-1).numpy()
    assert np.abs(got[3] - ref_delta).max() <= 1e-6 * max(1.0, np.abs(ref_delta).max())
    assert got[4] == 0.0
    if mask_center:
        assert (got[0][0] == 0).all()


def _pairs_counted(L, offset):
    """(dq pass, dk/dv pass) counts of each (row, key) that a lane's ok
    takes, over every tile, chunk, block, warp, lane and element."""
    n_tiles = -(-L // BLOCK)
    counts = [np.zeros((L, L), np.int64) for _ in range(2)]
    e = np.arange(4)
    w = np.arange(WARPS)[:, None, None]
    lane_row = 16 * w + G[None, :, None] + 8 * (e // 2)[None, None, :]        # [w, lane, e]
    for a in range(n_tiles):
        for b_ in range(n_tiles):
            for ch in range(BLOCK // CHUNK):
                for nb in range(2):
                    col = np.broadcast_to(CHUNK * ch + 8 * nb + 2 * T[None, :, None]
                                          + (e % 2)[None, None, :], lane_row.shape)
                    if b_ <= a:  # dq pass: q-tile a, k-tile b_
                        rows, keys = a * BLOCK + lane_row, b_ * BLOCK + col
                        ok = (rows < L) & (keys < L) & (keys + offset <= rows)
                        np.add.at(counts[0], (rows[ok], keys[ok]), 1)
                    if a <= b_:  # dk/dv pass: k-tile a, q-tile b_
                        keys, rows = a * BLOCK + lane_row, b_ * BLOCK + col
                        ok = (keys < L) & (rows < L) & (keys + offset <= rows)
                        np.add.at(counts[1], (rows[ok], keys[ok]), 1)
    return counts


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [1, 17, 64, 65, 200, 784])
def test_every_causal_pair_is_counted_once(l, mask_center):
    """Over the causal tiles (the dq pass's k-tiles up to its q-tile, the
    dk/dv pass's q-tiles from its k-tile), each (query, key) with key +
    offset <= query is taken exactly once in each pass, and no other."""
    offset = int(mask_center)
    rows, keys = np.indices((l, l))
    want = (keys + offset <= rows).astype(np.int64)
    for counts in _pairs_counted(l, offset):
        assert (counts == want).all()
