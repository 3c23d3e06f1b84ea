"""How the fused MLP backward cuts its R rows (``mlp_cuda.backward_plan``),
at the shapes the port runs, and that its three routes pass the kernels the
same cut. Pure Python on ``meta`` tensors: no kernel is built or run; the C
entry points are stood in for by recorders of their integer arguments.
"""

import contextlib
import ctypes

import pytest
import torch

from pytorch_generative_tpu_torch.ops import _build, ln_cuda, mlp_cuda

# (R, C): ImageGPT's rows at batch 64 (50,176) and chip_smoke.py's checks
# (8,192, and the ragged 8,185), at the widths the port runs (F = 4C).
SHAPES = [(r, c) for r in (50176, 8192, 8185) for c in (512, 640, 1024)]
K_STEP = 32                             # csrc/gemm_tf32x3.cuh's kBK
PARTIAL_FLOATS = 4 * 2 * 132 * 64 * 128  # _TARGET_CTAS x the CTA tile


@pytest.mark.parametrize("r,c", SHAPES)
def test_slices_are_whole_ctas_and_k_steps(r, c):
    part_rows, slices, granule = mlp_cuda.backward_plan(r, c, 4 * c)
    assert part_rows % ln_cuda.ROWS_PER_CTA == 0 and part_rows % K_STEP == 0
    assert (slices - 1) * part_rows < r <= slices * part_rows
    assert 1 <= granule and part_rows >= 1024


@pytest.mark.parametrize("r,c", SHAPES)
def test_partial_buffers_stay_small(r, c):
    """Each dW partial buffer holds slices x C x F floats: at most
    max(C F, _TARGET_CTAS x 64 x 128), 33 MiB at these widths."""
    f = 4 * c
    _, slices, _ = mlp_cuda.backward_plan(r, c, f)
    assert slices * c * f <= max(c * f, PARTIAL_FLOATS)
    assert slices * c * f * 4 <= 33 * 2 ** 20


def test_slices_fill_the_card_at_the_main_path():
    """At R = 50,176, C = 512: 8 slices of 6,272 rows, each 128 CTAs of the
    dW products, in one grid of 1,024 CTAs (saved y, recompute) or
    granules of 2 slices, 256 CTAs, one wave of 264 (pipelined)."""
    assert mlp_cuda.backward_plan(50176, 512, 2048) == (6272, 8, 2)
    assert mlp_cuda._dw_tiles(512, 2048) == 128
    assert mlp_cuda.backward_plan(50176, 1024, 4096) == (25088, 2, 1)


class _Entry:
    """A stand-in C entry point: records the arguments of a call that its
    declared types (``_build.declare``) make C ints."""

    argtypes = None

    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def __call__(self, *args):
        self.calls[self.name] = [a for a, t in zip(args, self.argtypes) if t is ctypes.c_int]
        return 0


@pytest.fixture
def recorded(monkeypatch):
    """{entry name: its int arguments}, filled by the wrappers' calls."""
    calls = {}

    class _Lib:
        def __getattr__(self, name):
            return _Entry(calls, name)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setitem(mlp_cuda._back_streams, torch.device("meta"), _Stream())
    for counter in ("bwd_launches", "recompute_launches", "pipe_launches",
                    "bf16_bwd_launches", "bf16_recompute_launches", "bf16_pipe_launches"):
        monkeypatch.setattr(mlp_cuda, counter, getattr(mlp_cuda, counter))  # restored after
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", [(50176, 512), (8185, 512), (50176, 1024)])
def test_every_route_passes_the_kernels_the_same_cut(recorded, r, c, dtype):
    """The saved-y, recompute and pipelined wrappers hand their C entries
    the same R, C, F, rows a slice, rows a CTA and rows a chunk; the
    pipelined one also its granule. bf16 rows take the bf16 plan and the
    dy product's 64-row blocks as chunks."""
    f = 4 * c
    meta = dict(device="meta", dtype=dtype)
    x, do = (torch.empty((r, c), **meta) for _ in range(2))
    y = torch.empty((r, f), **meta)
    gamma, beta = torch.empty((c,), **meta), torch.empty((c,), **meta)
    w1, b1 = torch.empty((c, f), **meta), torch.empty((f,), **meta)
    w2 = torch.empty((f, c), **meta)
    mlp_cuda._mlp_backward_cuda(x, do, y, gamma, beta, w1, b1, w2, 1e-5)
    mlp_cuda._mlp_backward_recompute_cuda(x, do, gamma, beta, w1, b1, w2, 1e-5)
    mlp_cuda._mlp_backward_pipe_cuda(x, do, y, gamma, beta, w1, b1, w2, 1e-5)
    bf16 = dtype == torch.bfloat16
    plan = mlp_cuda.bf16_backward_plan if bf16 else mlp_cuda.backward_plan
    part_rows, _, granule = plan(r, c, f)
    chunk = mlp_cuda.BF16_ROWS_PER_CHUNK if bf16 else mlp_cuda.ROWS_PER_CHUNK
    cut = [r, c, f, part_rows, ln_cuda.ROWS_PER_CTA, chunk]
    kind = "bf16" if bf16 else "f32"
    assert recorded[f"mlp_bwd_{kind}"] == cut
    assert recorded[f"mlp_bwd_recompute_{kind}"] == cut
    assert recorded[f"mlp_bwd_pipe_{kind}"] == cut + [granule]
