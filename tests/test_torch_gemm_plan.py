"""The bf16 wgmma GEMM's launch plan and work walk, on the CPU (arithmetic
only): shared memory and registers within the card's limits, TMA boxes the
hardware takes, the persistent grid's walk over every (part, m-tile,
n-tile) of each of the fused MLP's products exactly once with every k-step
of each part, and the bf16 backward's row cut (``mlp_cuda.bf16_backward_plan``),
beside the f32 cut, which keeps its values; the tile-store epilogue of the
attention block's products: its staging beside the ring, its TMA store
boxes, its swizzled writes (every element once, where the 128-byte
swizzle puts it, no bank conflict), and the fused projection's walk over
the n-tiles of q and then of [k | v], each (m-tile, n-tile) of each output
once.

The plan is restated here from ``csrc/gemm_wgmma_bf16.cuh``; the kernel
lines it restates are listed in ``KERNEL_LINES``, and
``test_restated_lines_are_the_kernels`` fails once one of them changes. On
the card, ``tests/test_torch_kernels.py`` holds ``SMEM`` to the kernel's
own ``wgemm_smem`` entry (``csrc/wgemm_check.cu``), and SMEM_TILE alike.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_generative_tpu_torch.ops import ln_cuda, mlp_cuda

SOURCE = Path(mlp_cuda.__file__).resolve().parents[1] / "csrc" / "gemm_wgmma_bf16.cuh"
SMEM_LIMIT = 232448   # shared memory a CTA may take on an H100
REGISTERS = 65536     # 32-bit registers of an SM
SMS = 132             # SMs of an H100: one persistent CTA each

BM, BN = 128, 128     # kBM, kBN
K_STEP = 64           # kBK
FOLD = 2              # kFold: k-steps a part accumulator sums (128 values)
STAGES = 6            # kStages
CONSUMERS = 2         # kConsumers: warpgroups of 64 rows
PRODUCER_REGS, CONSUMER_REGS = 24, 240
PASS_COLS = 32        # kPassCols
STAGE_LD = PASS_COLS + 8
TILE_BYTES = BM * K_STEP * 2          # a stage's A tile, and its B tile
BLOCK_BYTES = K_STEP * 128            # a 64-column block of an MN-major tile
EPILOGUE_BYTES = CONSUMERS * 64 * STAGE_LD * 4 + CONSUMERS * 4 * PASS_COLS * 4
SMEM = 1024 + STAGES * 2 * TILE_BYTES + EPILOGUE_BYTES + 8 * 2 * STAGES
OUT_BLOCK = 64 * 128                  # kOutBlock: a 64 x 64 bf16 block, 128-byte rows
OUT_BYTES = BM * BN * 2               # kOutBytes: the bf16 tile
SMEM_TILE = 1024 + STAGES * 2 * TILE_BYTES + OUT_BYTES + 8 * 2 * STAGES
KERNEL_LINES = (
    "constexpr int kBM = 128, kBN = 128;  // a CTA's tile of out",
    "constexpr int kBK = 64;              // the k-step, in values",
    "constexpr int kFold = 2;             // k-steps a part accumulator sums",
    "constexpr int kStages = 6;           // depth of the TMA ring",
    "constexpr int kConsumers = 2;        // consumer warpgroups of 64 rows",
    "constexpr int kProducerRegs = 24, kConsumerRegs = 240;",
    "constexpr int kTileBytes = kBM * kBK * 2;",
    "constexpr int kPassCols = 32;",
    "constexpr int kStageLd = kPassCols + 8;",
    "constexpr int kEpilogueBytes = kConsumers * 64 * kStageLd * 4 + kConsumers * 4 * kPassCols * 4;",
    "constexpr int kSmem = 1024 + kStages * kStage + kEpilogueBytes + 8 * 2 * kStages;",
    "constexpr int kOutBlock = 64 * 128;",
    "constexpr int kOutBytes = kBM * kBN * 2;",
    "constexpr int kSmemTile = 1024 + kStages * kStage + kOutBytes + 8 * 2 * kStages;",
    "  x.which = kTwo && j >= n_tiles0 ? 1 : 0;",
    "  x.n0 = (j - x.which * n_tiles0) * kBN;",
    "  x.n_k = kend > x.kbeg ? (kend - x.kbeg + kBK - 1) / kBK : 0;",
    "            *reinterpret_cast<uint32_t*>(st + (j / 8) * kOutBlock + r * 128 +",
    "                                         ((j % 8) ^ g) * 16 + 4 * t) = bf16::pack(lo, hi);",
    "          const CUtensorMap* map = pass == 1 || x.which ? tout1 : tout0;",
    "              wg::store_2d(map, st + h * kOutBlock, x.n0 + 64 * h, m);",
    "        if (issuer) wg::store_wait<0, true>();",
    "        !wg::encode_bf16_2d(&maps.out[i], out[i], n[i], M, n[i], 64))",
    "  tile_kernel<Act><<<grid, kThreads, kSmemTile, stream>>>(maps, M, tiles[0] + tiles[1], tiles[0],",
    "  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {",
    "  return *err == cudaSuccess ? static_cast<int>(work < sms ? work : sms) : 0;",
    "  run<kAT, kBT>(&ta, &tb, &tb, nullptr, nullptr, M, N, n_tiles, n_tiles, K, k_split, parts, epi);",
)
# The TMA boxes (inner values, rows) of each operand layout and how many a
# stage loads: A K-contiguous (kAT false), A M-contiguous, B K-contiguous
# (kBT true), B N-contiguous.
BOXES = {"A [m][k]": ((K_STEP, BM), 1), "A [k][m]": ((64, K_STEP), 2),
         "B [n][k]": ((K_STEP, BN), 1), "B [k][n]": ((64, K_STEP), 2)}
ROWS = [1, 1031, 4097, 50176]
WIDTHS = [128, 512, 1024]
# backward_plan (the f32 route's cut) as it was when the bf16 route got
# its own: (R, C) -> (part_rows, slices, granule) at F = 4C.
F32_PLAN = {
    (1, 128): (64, 1, 33), (1, 512): (64, 1, 2), (1, 640): (64, 1, 1), (1, 1024): (64, 1, 1),
    (1031, 128): (1088, 1, 33), (1031, 512): (1088, 1, 2), (1031, 640): (1088, 1, 1),
    (1031, 1024): (1088, 1, 1), (4097, 128): (1088, 4, 33), (4097, 512): (1088, 4, 2),
    (4097, 640): (1088, 4, 1), (4097, 1024): (2112, 2, 1), (8185, 128): (1216, 7, 33),
    (8185, 512): (1216, 7, 2), (8185, 640): (1664, 5, 1), (8185, 1024): (4096, 2, 1),
    (50176, 128): (1024, 49, 33), (50176, 512): (6272, 8, 2), (50176, 640): (10048, 5, 1),
    (50176, 1024): (25088, 2, 1)}


def test_restated_lines_are_the_kernels():
    source = SOURCE.read_text()
    missing = [line for line in KERNEL_LINES if line not in source]
    assert not missing, f"{SOURCE.name} no longer has: {missing}"


def test_shared_memory_and_registers_fit():
    """The ring, the epilogue's staging and the barriers fit in a CTA's
    shared memory; every stage and 64-column block starts on a 1024-byte
    boundary (the 128-byte swizzle's period); the producer's and the
    consumers' registers fit in the SM's, with the consumers' sums and part
    (64 x 128 each) a thread; the ring holds the fold's stages and at least
    two more."""
    assert SMEM <= SMEM_LIMIT
    assert TILE_BYTES % 1024 == 0 and BLOCK_BYTES % 1024 == 0
    assert 128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= REGISTERS
    assert PRODUCER_REGS % 8 == 0 and CONSUMER_REGS % 8 == 0 and CONSUMER_REGS <= 255
    assert 2 * 64 < CONSUMER_REGS
    assert STAGES >= FOLD + 2


def test_tile_store_staging_fits_beside_the_ring():
    """The tile-store epilogue's bf16 tile takes the functor epilogue's
    place: the ring, the tile and the barriers fit in a CTA's shared
    memory with the ring's full depth; the tile is each consumer's two
    64 x 64 blocks, each starting on a 1024-byte boundary (the 128-byte
    swizzle's period) right after the ring."""
    assert SMEM_TILE <= SMEM_LIMIT
    assert OUT_BYTES == 2 * CONSUMERS * OUT_BLOCK and OUT_BLOCK % 1024 == 0
    assert (STAGES * 2 * TILE_BYTES) % 1024 == 0
    assert SMEM_LIMIT - SMEM_TILE < OUT_BLOCK  # no room for a second tile


def test_tma_store_box_is_what_the_hardware_takes():
    """A store box is 64 columns by 64 rows of bf16: at most 256 a side,
    its inner side's bytes the 128-byte swizzle's span, its bytes one
    staging block; a consumer's two boxes cover its 64 rows of the tile's
    128 columns."""
    inner, rows = 64, 64
    assert inner <= 256 and rows <= 256 and inner * 2 == 128
    assert inner * rows * 2 == OUT_BLOCK
    assert 2 * inner == BN and rows == BM // CONSUMERS


def _staging_address(wq, lane, j, h):
    """(block, byte) of the pair that lane (g, t) of consumer warp wq
    writes for acc[4 j + 2 h], acc[4 j + 2 h + 1]: row 16 wq + g + 8 h,
    columns 8 j + 2 t, + 1; as the kernel computes it."""
    g, t = lane // 4, lane % 4
    r = 16 * wq + g + 8 * h
    return j // 8, r * 128 + ((j % 8) ^ g) * 16 + 4 * t


def test_swizzled_staging_writes_every_element_once_where_tma_reads_it():
    """Each (row, column) of a consumer's 64 x 128 tile is written once, at
    the byte where a TMA store of a 128-byte swizzled 64 x 64 box reads
    element (row, column % 64) of block column // 64: 16-byte chunk
    (column % 64) / 8 of row r moved to chunk ((column % 64) / 8) ^ (r %
    8)."""
    seen = {}
    for wq in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for j in range(BN // 8):
                for h in range(2):
                    r, col = 16 * wq + g + 8 * h, 8 * j + 2 * t
                    where = _staging_address(wq, lane, j, h)
                    assert where not in seen, where
                    seen[where] = (r, col)
                    c = col % 64
                    assert where == (col // 64, r * 128 + ((c // 8) ^ (r % 8)) * 16 + (c % 8) * 2)
    assert len(seen) == 64 * BN // 2


def test_swizzled_staging_writes_have_no_bank_conflict():
    """Each 4-byte store a warp issues (fixed j and h) touches 32
    different banks."""
    for wq in range(4):
        for j in range(BN // 8):
            for h in range(2):
                banks = {_staging_address(wq, lane, j, h)[1] // 4 % 32 for lane in range(32)}
                assert len(banks) == 32


def _walk_outputs(m, widths):
    """{(output, m0, n0)} of the tile-store launch's work items over one or
    two outputs of the given widths (``work_of<true>`` with n_tiles0 = the
    first output's n-tiles, ``bias_products``), each CTA taking items
    blockIdx.x, + gridDim.x, ...; raises if an item is taken twice."""
    tiles = [-(-n // BN) for n in widths]
    n_tiles, n_tiles0 = sum(tiles), tiles[0]
    n_work = -(-m // BM) * n_tiles
    grid = min(n_work, SMS)
    seen = set()
    for cta in range(grid):
        for w in range(cta, n_work, grid):
            r = w % n_work
            j = r % n_tiles
            which = 0 if j < n_tiles0 else 1
            key = (which, r // n_tiles * BM, (j - which * n_tiles0) * BN)
            assert key not in seen, f"{key} taken twice"
            seen.add(key)
    return seen


@pytest.mark.parametrize("c,heads", [(64, 2), (512, 8), (512, 4), (1024, 8)])
@pytest.mark.parametrize("r", [400, 1031, 50176])
def test_fused_projection_walk_covers_q_and_kv_once(r, c, heads):
    """The block's q (E = C) and [k | v] (E + O = 2C) in one launch: every
    (m-tile, n-tile) of each output once; the y product (one output, C'
    = C) likewise; a tile's second 64-column box is stored only inside
    the output's width (C = 64: q's one box)."""
    for widths in ((c, 2 * c), (c,)):
        seen = _walk_outputs(r, widths)
        want = {(i, m0, n0) for i, n in enumerate(widths) for m0 in range(0, r, BM)
                for n0 in range(0, n, BN)}
        assert seen == want
        boxes = {(i, n0 + 64 * h) for i, _, n0 in seen for h in range(2)
                 if n0 + 64 * h < widths[i]}
        assert boxes == {(i, c0) for i, n in enumerate(widths) for c0 in range(0, n, 64)}


@pytest.mark.parametrize("layout", sorted(BOXES))
def test_tma_boxes_are_what_the_hardware_takes(layout):
    """At most 256 a side; the inner side's bytes equal the 128-byte
    swizzle; a stage's boxes fill its tile exactly (the bytes its full
    barrier expects)."""
    (inner, rows), count = BOXES[layout]
    assert inner <= 256 and rows <= 256
    assert inner * 2 == 128
    assert count * inner * rows * 2 == TILE_BYTES


def _walk(m, n, k, parts, k_split):
    """{(part, m0, n0): (kbeg, k-steps)} of the persistent grid's work items,
    each CTA taking items blockIdx.x, + gridDim.x, ... (``work_of``);
    raises if an item is taken twice."""
    n_tiles = -(-n // BN)
    per_part = -(-m // BM) * n_tiles
    n_work = parts * per_part
    grid = min(n_work, SMS)
    seen = {}
    for cta in range(grid):
        for w in range(cta, n_work, grid):
            part, r = divmod(w, per_part)
            m0, n0 = r // n_tiles * BM, r % n_tiles * BN
            kbeg = part * k_split
            kend = min(k, kbeg + k_split)
            n_k = -(-(kend - kbeg) // K_STEP) if kend > kbeg else 0
            key = (part, m0, n0)
            assert key not in seen, f"{key} taken twice"
            seen[key] = (kbeg, n_k)
    return seen


def _products(r, c):
    """(name, M, N, K, parts, k_split) of every product of the bf16 MLP at
    (R, C), F = 4C: the forward's two, the backward's four on the saved-y
    route, and the pipelined route's granules of dy and dW."""
    f = 4 * c
    whole = lambda k: -(-k // K_STEP) * K_STEP  # noqa: E731  mlp::product's k_split
    part_rows, slices, granule = mlp_cuda.bf16_backward_plan(r, c, f)
    out = [("y", r, f, c, 1, whole(c)), ("out", r, c, f, 1, whole(f)),
           ("dy", r, f, c, 1, whole(c)), ("dln", r, c, f, 1, whole(f)),
           ("dW2", f, c, r, slices, part_rows), ("dW1", c, f, r, slices, part_rows)]
    for p0 in range(0, slices, granule):
        np_ = min(granule, slices - p0)
        n_rows = min(np_ * part_rows, r - p0 * part_rows)
        out += [(f"dy granule {p0}", n_rows, f, c, 1, whole(c)),
                (f"dW granule {p0}", f, c, n_rows, np_, part_rows)]
    return out


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("r", ROWS)
def test_persistent_walk_covers_every_item_once(r, c):
    """Each product's walk takes every (part, m-tile, n-tile) exactly once,
    and each part's k-steps cover its range of K, the parts together all of
    K, with no k-step past a part's end but the last part's (where TMA
    reads zeros past K)."""
    for name, m, n, k, parts, k_split in _products(r, c):
        seen = _walk(m, n, k, parts, k_split)
        tiles = {(p, m0, n0) for p in range(parts) for m0 in range(0, m, BM)
                 for n0 in range(0, n, BN)}
        assert set(seen) == tiles, name
        covered = 0
        for p in range(parts):
            kbeg, n_k = seen[(p, 0, 0)]
            assert kbeg == covered, name
            span = min(k, kbeg + k_split) - kbeg
            assert 0 < span and (n_k - 1) * K_STEP < span <= n_k * K_STEP, name
            assert p == parts - 1 or span == n_k * K_STEP, name
            covered += span
        assert covered == k, name


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("r", ROWS + [8185])
def test_bf16_slices_are_whole_tiles_k_steps_and_ctas(r, c):
    """A bf16 slice is a multiple of the dy product's 128-row tile, of the
    k-step and of the LayerNorm backward's rows a CTA; the slices cover R;
    so every pipelined granule starts on a tile and on a 64-row block of
    db1's partials."""
    part_rows, slices, granule = mlp_cuda.bf16_backward_plan(r, c, 4 * c)
    assert part_rows % BM == 0 and part_rows % K_STEP == 0
    assert part_rows % ln_cuda.ROWS_PER_CTA == 0
    assert part_rows % mlp_cuda.BF16_ROWS_PER_CHUNK == 0
    assert (slices - 1) * part_rows < r <= slices * part_rows
    assert granule >= 1 and (slices == 1 or part_rows >= 1024)
    assert mlp_cuda.BF16_GEMM_TILE == (BM, BN)


def test_bf16_plan_at_the_main_path():
    """At R = 50,176: C 512 gives 8 slices of 6,272 rows, 64 tiles each
    (512 work items, 3.9 an SM), in granules of 2 (128 items, one each for
    128 of the 132 SMs); C 1024 2 slices of 25,088 rows, granules of 1."""
    assert mlp_cuda.bf16_backward_plan(50176, 512, 2048) == (6272, 8, 2)
    assert mlp_cuda._dw_tiles(512, 2048, mlp_cuda.BF16_GEMM_TILE) == 64
    assert mlp_cuda.bf16_backward_plan(50176, 1024, 4096) == (25088, 2, 1)


@pytest.mark.parametrize("r,c", sorted(F32_PLAN))
def test_f32_plan_keeps_its_values(r, c):
    """The f32 route's cut is not the bf16 one's: its values, and so the
    f32 gradients' bits, are those it had before."""
    assert mlp_cuda.backward_plan(r, c, 4 * c) == F32_PLAN[(r, c)]


@pytest.mark.parametrize("r", [1, 1031, 4097])
def test_db1_partials_in_the_kernels_order_hold_f32_accuracy(r):
    """db1 as the bf16 backward sums it: each 64-row block's column sums in
    the dy product's epilogue order (lane l of warp w holds rows 16 w + 2 i
    + l / 16, summed for i = 0 ... 7; then the two half-warps; then the four
    warps in order), then the blocks added in order (rows::sum_slices), in
    f32 within 1e-6 of float64's sum at the largest |column sum| (and of
    its magnitude: dy is N(0.3, 1))."""
    rng = np.random.default_rng(r)
    f = 24
    dy = torch.from_numpy((rng.standard_normal((r, f)) + 0.3).astype(np.float32))
    blocks = []
    for b0 in range(0, r, 64):
        rows = torch.zeros((64, f))
        rows[:min(64, r - b0)] = dy[b0:b0 + 64]
        lanes = rows.reshape(4, 8, 2, f)      # (warp, i, half-warp, column)
        thread = torch.zeros((4, 2, f))
        for i in range(8):
            thread = thread + lanes[:, i]
        w = thread[:, 0] + thread[:, 1]       # lane l and lane l ^ 16
        blocks.append(((w[0] + w[1]) + w[2]) + w[3])
    total = torch.zeros(f)
    for part in blocks:
        total = total + part
    ref = dy.double().sum(0)
    scale = max(float(ref.abs().max()), float(dy.double().abs().sum(0).max()) / r ** 0.5)
    assert float((total.double() - ref).abs().max()) <= 1e-6 * scale
