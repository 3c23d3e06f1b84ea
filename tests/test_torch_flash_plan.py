"""The bf16 wgmma flash kernels' launch plan and tile walk, on the CPU
(arithmetic and tiny tensors only): shared memory within the card's limit,
the key tiles each query group computes (and the query tiles of each key
group), and a torch emulation of the forward's walk at the kernels' tile
sizes against the plain bf16 version.

The plan is restated here from ``csrc/flash_wgmma_bf16.cuh``; the kernel
lines it restates are listed in ``KERNEL_LINES``, and
``test_restated_lines_are_the_kernels`` fails once one of them changes.
On the card, ``tests/test_torch_kernels.py`` holds ``smem_bytes`` to the
kernels' own ``flash_*_bf16_smem`` entries.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_generative_tpu_torch.ops import attention_cuda as ac

SOURCE = Path(ac.__file__).resolve().parents[1] / "csrc" / "flash_wgmma_bf16.cuh"
DIMS = ac.BF16_HEAD_DIMS
LENGTHS = [1, 16, 31, 32, 63, 64, 65, 127, 128, 129, 200, 257, 784]
BF16_TOL = 2.0 ** -7
SMEM_LIMIT = 232448  # shared memory a CTA may take on an H100

STAGES = 3                              # kStages
FWD_COLS, DQ_COLS, DKDV_ROWS = 64, 64, 32  # kFwdCols, kDqCols, kDkdvRows
KERNEL_LINES = (
    "constexpr int kStages = 3;",
    "constexpr int kFwdCols = 64;",
    "constexpr int kDqCols = 64;",
    "constexpr int kDkdvRows = 32;",
    "  return D <= 64 ? 3 : 2;",
    "  return R * D * 2;",
    "  static constexpr int kSmem = 1024 + kQ + kStages * kStage + 8 * (1 + 2 * kStages);",
    "  static constexpr int kSmem = 1024 + 2 * kQ + kStages * kStage + 8 * BM + 8 * (1 + 2 * "
    "kStages);",
    "  static constexpr int kStage = (2 * kQ + 8 * BQ + 1023) / 1024 * 1024;",
    "  static constexpr int kSmem = 1024 + 2 * kKV + kStages * kStage + 8 * (1 + 3 * kStages);",
    "  const int n_mine = r0 < L ? (min(L, r0 + 64) + BN - 1) / BN : 0;",
    "  const int mine = c0 < L ? c0 / BQ : n_q;",
)


def groups(d):
    """Consumer warpgroups of 64 rows a CTA (``groups<D>()``)."""
    return 3 if d <= 64 else 2


def smem_bytes(d):
    """Each kernel's shared-memory bytes at head width d (the ``kSmem``
    lines): 1024 of slack to align the tiles, the resident tiles, the ring,
    the dq pass's f32 lse and delta, 8 a barrier."""
    bm = 64 * groups(d)
    tile = lambda rows: rows * d * 2
    dkdv_stage = -(-(2 * tile(DKDV_ROWS) + 8 * DKDV_ROWS) // 1024) * 1024
    return {"fwd": 1024 + tile(bm) + STAGES * 2 * tile(FWD_COLS) + 8 * (1 + 2 * STAGES),
            "dq": 1024 + 2 * tile(bm) + STAGES * 2 * tile(DQ_COLS) + 8 * bm
            + 8 * (1 + 2 * STAGES),
            "dkdv": 1024 + 2 * tile(bm) + STAGES * dkdv_stage + 8 * (1 + 3 * STAGES)}


def _groups_walk(l, d):
    """(first row, rows) of every consumer group of every CTA tile: the
    grid's (L + BM - 1) / BM tiles of 64 groups(d) rows."""
    bm = 64 * groups(d)
    return [(r0, max(0, min(64, l - r0)))
            for r0 in range(0, -(-l // bm) * bm, 64)]


def test_restated_lines_are_the_kernels():
    source = SOURCE.read_text()
    missing = [line for line in KERNEL_LINES if line not in source]
    assert not missing, f"{SOURCE.name} no longer has: {missing}"


@pytest.mark.parametrize("d", DIMS)
def test_shared_memory_fits_and_leaves_the_ring_aligned(d):
    smem = smem_bytes(d)
    assert all(0 < v <= SMEM_LIMIT for v in smem.values()), smem
    # Every swizzled tile starts on a 1024-byte boundary: its rows times
    # its row bytes (d = 128 as two 128-byte parts) is a multiple of 1024.
    for rows in (64 * groups(d), FWD_COLS, DQ_COLS, DKDV_ROWS):
        assert rows * d * 2 % 1024 == 0 and rows * min(d, 64) * 2 % 1024 == 0


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("d", DIMS)
def test_query_groups_compute_every_visible_key(d, l, mask_center):
    """The forward's and the dq pass's key tiles (``n_mine``): each row's
    visible keys (j <= i - mask_center) lie in the tiles its group
    computes, the last of them holds a key < L, and every row < L lies in
    a group of the grid."""
    offset = int(mask_center)
    for bn in {FWD_COLS, DQ_COLS}:
        covered = set()
        for r0, rows in _groups_walk(l, d):
            n_mine = -(-min(l, r0 + 64) // bn) if r0 < l else 0
            assert rows == 0 or (n_mine - 1) * bn < l
            for i in range(r0, r0 + rows):
                covered.add(i)
                assert i - offset < n_mine * bn
        assert covered == set(range(l))


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("d", DIMS)
def test_key_groups_see_every_query_that_sees_them(d, l, mask_center):
    """The dk/dv pass (query tiles from ``mine`` on): each key's rows
    (i >= j + mask_center, i < L) lie in the query tiles its group
    computes, and every key < L lies in a group of the grid."""
    offset, bq = int(mask_center), DKDV_ROWS
    n_q = -(-l // bq)
    covered = set()
    for c0, keys in _groups_walk(l, d):
        mine = c0 // bq if c0 < l else n_q
        for j in range(c0, c0 + keys):
            covered.add(j)
            if j + offset < l:
                assert mine * bq <= j + offset < n_q * bq
    assert covered == set(range(l))


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _forward_walk(q, k, v, mask_center, n_heads, bn):
    """The bf16 forward kernel's arithmetic in f32 torch ops, one 64-row
    group at a time over key tiles of bn: S = q2 K^T, the tile's mask,
    the running max, P = exp2(S - max) rounded to bf16 for P V (the row sum
    takes the f32 P), the tile's P V summed fresh and added to alpha O;
    out = O / l rounded to bf16, lse natural."""
    b, l, _ = q.shape
    q, k, v = (ac._unpack(t, n_heads).float() for t in (q, k, v))
    q2 = ac._q2(q)
    offset = int(mask_center)
    out = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:-1])
    for r0 in range(0, l, 64):
        rows = torch.arange(r0, min(l, r0 + 64))
        m = torch.full((b, n_heads, len(rows)), float("-inf"))
        s_l = torch.zeros_like(m)
        o = torch.zeros((b, n_heads, len(rows), q.shape[-1]))
        for key0 in range(0, min(l, r0 + 64), bn):
            keys = torch.arange(key0, min(l, key0 + bn))
            s = torch.einsum("nhqd,nhkd->nhqk", q2[:, :, rows], k[:, :, keys])
            s = s.masked_fill(keys[None, :] + offset > rows[:, None], float("-inf"))
            mx = torch.maximum(m, s.amax(-1))
            base = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            s_l = s_l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum("nhqk,nhkd->nhqd", _bf16(p), v[:, :, keys])
            m = mx
        out[:, :, rows] = o / torch.where(s_l == 0, torch.ones_like(s_l), s_l)[..., None]
        lse[:, :, rows] = torch.where(s_l == 0, torch.full_like(s_l, float("-inf")),
                                      m * ac._LN2 + torch.log(torch.clamp(s_l, min=1e-38)))
    return ac._pack(out).to(torch.bfloat16), lse


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [1, 63, 129, 200])
@pytest.mark.parametrize("d", DIMS)
def test_forward_walk_holds_the_plain_version(d, l, mask_center):
    """The kernel's tile walk (running max, per-tile fresh P V) at its key
    tile, B 2 and 2 heads, within BF16_TOL of the plain version's largest
    |out|; lse within 1e-6 relative, -inf on the same rows."""
    rng = np.random.default_rng(l + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, l, 2 * d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    out, lse = _forward_walk(q, k, v, mask_center, 2, FWD_COLS)
    want, want_lse = ac.flash_forward_plain(q, k, v, mask_center, 2)
    err = float((out.float() - want.float()).abs().max())
    assert err <= BF16_TOL * max(float(want.float().abs().max()), 1e-30)
    finite = torch.isfinite(want_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    if finite.any():
        assert float((lse[finite] - want_lse[finite]).abs().max()) <= \
            1e-6 * float(want_lse[finite].abs().max())
    if mask_center:
        assert bool((out[:, 0] == 0).all())
