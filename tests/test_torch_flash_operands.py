"""The flash wrappers' operand checks for the tensor-core instances: the
d_k == d_v kernels copy 16 bytes at a time, so each operand must start on a
16-byte boundary and have batch and row strides that are multiples of 4
floats; the (4, 32) and (4, 8) CUDA-core kernels take any start and stride.
The checks run on ``meta`` tensors (a slice's ``data_ptr`` carries its byte
offset), so nothing is allocated and no kernel is needed.
"""

import pytest
import torch

from pytorch_generative_tpu_torch.ops import attention_cuda

B, L, HEADS = 2, 200, 2
TENSOR_CORE_DIMS = sorted(d for d, e in attention_cuda.HEAD_DIM_PAIRS if d == e)
CUDA_CORE_PAIRS = [p for p in attention_cuda.HEAD_DIM_PAIRS if p[0] != p[1]]
OPERANDS = ("q", "k", "v", "out", "dout")


def _packed(d_k, d_v, pad=0):
    """q, k and v as the models make them (k and v feature slices of one kv
    tensor), out and dout (B, L, H*d_v); ``pad`` extra floats at the end of
    every row of each tensor."""
    q = torch.empty((B, L, HEADS * d_k + pad), device="meta")[..., :HEADS * d_k]
    kv = torch.empty((B, L, HEADS * (d_k + d_v) + pad), device="meta")
    k, v = kv[..., :HEADS * d_k], kv[..., HEADS * d_k:HEADS * (d_k + d_v)]
    out, dout = (torch.empty((B, L, HEADS * d_v + pad), device="meta")[..., :HEADS * d_v]
                 for _ in range(2))
    return dict(q=q, k=k, v=v, out=out, dout=dout)


def _shifted(t):
    """``t``'s shape and strides, starting one float (4 bytes) later."""
    base = torch.empty((t.shape[0] * t.stride(0) + 1,), device="meta")
    return base.as_strided(t.shape, t.stride(), 1)


@pytest.mark.parametrize("d", TENSOR_CORE_DIMS)
def test_tensor_core_instances_take_packed_slices(d):
    assert attention_cuda._check_operands(HEADS, **_packed(d, d)) == (d, d)


@pytest.mark.parametrize("fault", ["start", "row_stride"])
@pytest.mark.parametrize("d", TENSOR_CORE_DIMS)
def test_tensor_core_instances_reject_misaligned_operands(d, fault):
    if fault == "start":
        operands = _packed(d, d)
        operands["v"] = _shifted(operands["v"])
        match = "offset 4 bytes"
    else:  # one float of padding a row: a row stride of H*d + 1
        operands = _packed(d, d, pad=1)
        match = rf"strides \({L * (HEADS * d + 1)}, {HEADS * d + 1}, 1\)"
    with pytest.raises(ValueError, match=f"16-byte aligned start.*{match}"):
        attention_cuda._check_operands(HEADS, **operands)


@pytest.mark.parametrize("name", OPERANDS)
def test_every_operand_is_checked_for_alignment(name):
    operands = _packed(64, 64)
    operands[name] = _shifted(operands[name])
    with pytest.raises(ValueError, match=f"^{name}: the d_k == d_v kernels"):
        attention_cuda._check_operands(HEADS, **operands)


@pytest.mark.parametrize("d_k,d_v", CUDA_CORE_PAIRS)
def test_cuda_core_instances_take_unaligned_operands(d_k, d_v):
    operands = {name: _shifted(t) for name, t in _packed(d_k, d_v, pad=1).items()}
    assert attention_cuda._check_operands(HEADS, **operands) == (d_k, d_v)
