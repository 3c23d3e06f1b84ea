"""The operand checks of the wrappers whose kernels read operands 16 bytes at
a time: the LayerNorm forward and backward (``float4`` loads of x, dy,
gamma and beta), the fused MLP and the fused attention block (16-byte
``cp.async`` of every GEMM operand; every operand is held to the rule), the
whole-loop sampler (16-byte ``cp.async`` of its four product weights) and
the PixelSNAIL whole-loop sampler (16-byte ``cp.async`` of the nine weights
it streams).

A contiguous tensor may start 4 bytes past a 16-byte boundary, e.g. a view
of a flat parameter buffer at an odd offset; ``contiguous()`` returns it
unchanged. Each wrapper refuses such an operand, operand by operand, with a
``ValueError`` before any work, and takes an aligned one; none copies it
to an aligned buffer. The checks run on ``meta`` tensors (a view's
``data_ptr`` carries its byte offset), so nothing is allocated and no
kernel is built.
"""

import math

import pytest
import torch

from pytorch_generative_tpu_torch.ops import (
    attn_block_cuda,
    decode_cuda,
    ln_cuda,
    mlp_cuda,
    snail_decode_cuda,
)

R, C, F = 8, 64, 256            # rows, channels, MLP width
B, L, HEADS = 2, 8, 2           # the block's batch, length and heads (d = 32)
SAMPLER = dict(h=4, w=4, n_blocks=2, c=32, heads=2, m=128, n=3)
SNAIL = dict(h=4, w=4, n_blocks=2, n_rb=2, c=16, d_k=4, d_v=8, n=3)


def _aligned(shape):
    return torch.empty(shape, device="meta")


def _shifted(shape):
    """A contiguous tensor of ``shape`` starting one float (4 bytes) past a
    16-byte boundary."""
    return torch.empty(math.prod(shape) + 1, device="meta")[1:].view(shape)


def _ln_operands(backward):
    shapes = {"x": (R, C), "gamma": (C,)}
    shapes.update({"dy": (R, C)} if backward else {"beta": (C,)})
    return shapes


def _check_ln(backward, ops):
    kernel = ln_cuda.BWD_KERNEL if backward else ln_cuda.KERNEL
    return ln_cuda._check(kernel, ops.pop("x"), **ops)


def _mlp_operands(backward):
    shapes = {"x": (R, C), "w1": (C, F), "gamma": (C,), "beta": (C,), "b1": (F,), "w2": (F, C)}
    shapes.update({"do": (R, C), "y": (R, F)} if backward else {"b2": (C,)})
    return shapes


def _check_mlp(backward, ops):
    kernel = mlp_cuda.BWD_KERNEL if backward else mlp_cuda.KERNEL
    return mlp_cuda._check(kernel, ops.pop("x"), ops.pop("w1"), **ops)


def _block_operands(project_only):
    e = C
    shapes = {"x": (B, L, C), "wq": (C, e), "bq": (e,), "wkv": (C, 2 * e), "bkv": (2 * e,)}
    if not project_only:
        shapes.update(wo=(e, C), bo=(C,))
    return shapes


def _check_block(project_only, ops):
    if project_only:
        return attn_block_cuda._check(attn_block_cuda.PROJECT_KERNEL, **ops)
    return attn_block_cuda._check(attn_block_cuda.KERNEL, **ops, n_heads=HEADS)


def _sampler_operands():
    s = SAMPLER
    c, nb, m = s["c"], s["n_blocks"], s["m"]
    weights = {"in_w4": (4, c), "in_b": (c,), "head_w": (c,), "head_b": (1,),
               "ln1_w": (nb, c), "ln1_b": (nb, c), "qkv_w": (nb, c, 3 * c),
               "qkv_b": (nb, 3 * c), "out_w": (nb, c, c), "out_b": (nb, c),
               "ln2_w": (nb, c), "ln2_b": (nb, c), "mlp1_w": (nb, c, m), "mlp1_b": (nb, m),
               "mlp2_w": (nb, m, c), "mlp2_b": (nb, c), "lnf_w": (c,), "lnf_b": (c,)}
    lp = (s["h"] + 2) * (s["w"] + 2)
    return dict(weights, canvas0=(lp, s["n"]), pos_pad=(lp, 1),
                uniforms=(s["h"] * s["w"], s["n"], 1))


def _check_sampler(ops):
    s = SAMPLER
    weights = {k: ops.pop(k) for k in decode_cuda.WEIGHT_ORDER}
    return decode_cuda.check_sample_loop(ops["canvas0"], ops["pos_pad"], ops["uniforms"],
                                         weights, s["heads"], s["h"], s["w"])


def _snail_operands():
    s = SNAIL
    nb, nr, c, d_k, d_v = s["n_blocks"], s["n_rb"], s["c"], s["d_k"], s["d_v"]
    weights = {
        "in_w4": (4, c), "in_b": (c,),
        "rb1_w": (nb, nr, 4 * c, c), "rb1_b": (nb, nr, c),
        "rb2_w": (nb, nr, 4 * c, 2 * c), "rb2_b": (nb, nr, 2 * c),
        "q_w": (nb, c + 2, d_k), "q_b": (nb, d_k),
        "kv_w": (nb, c + 3, d_k + d_v), "kv_b": (nb, d_k + d_v),
        "op_w": (nb, d_v, d_v), "op_b": (nb, d_v),
        "ro_w": (nb, c, c), "ro_b": (nb, c), "ao_w": (nb, d_v, c), "ao_b": (nb, c),
        "o_w": (nb, c, c), "o_b": (nb, c),
        "h1_w": (c, c // 2), "h1_b": (c // 2,), "h2_w": (c // 2, 1), "h2_b": (1,)}
    return dict(weights, canvas0=((s["h"] + 2) * (s["w"] + 2), s["n"]),
                uniforms=(s["h"] * s["w"], s["n"], 1))


def _check_snail(ops):
    s = SNAIL
    weights = {k: ops.pop(k) for k in snail_decode_cuda.WEIGHT_ORDER}
    return snail_decode_cuda.check_snail_loop(ops["canvas0"], ops["uniforms"], weights,
                                              s["h"], s["w"])


# (wrapper, operand shapes, check, the operands its kernel reads 16 bytes
# at a time)
WRAPPERS = {
    "ln_forward": (_ln_operands(False), lambda ops: _check_ln(False, ops), None),
    "ln_backward": (_ln_operands(True), lambda ops: _check_ln(True, ops), None),
    "mlp_forward": (_mlp_operands(False), lambda ops: _check_mlp(False, ops), None),
    "mlp_backward": (_mlp_operands(True), lambda ops: _check_mlp(True, ops), None),
    "attn_block": (_block_operands(False), lambda ops: _check_block(False, ops), None),
    "attn_block_project": (_block_operands(True), lambda ops: _check_block(True, ops), None),
    "sample_loop": (_sampler_operands(), _check_sampler, decode_cuda.SAMPLE_LOOP_ALIGNED),
    "snail_loop": (_snail_operands(), _check_snail, snail_decode_cuda.SNAIL_LOOP_ALIGNED),
}
CASES = [pytest.param(w, name, id=f"{w}-{name}")
         for w, (shapes, _, aligned) in WRAPPERS.items()
         for name in (aligned or shapes)]
UNALIGNED_OK = [pytest.param(name, id=name) for name in _sampler_operands()
                if name not in decode_cuda.SAMPLE_LOOP_ALIGNED]
SNAIL_UNALIGNED_OK = [pytest.param(name, id=name) for name in _snail_operands()
                      if name not in snail_decode_cuda.SNAIL_LOOP_ALIGNED]


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_aligned_operands_are_taken(wrapper):
    shapes, check, _ = WRAPPERS[wrapper]
    check({name: _aligned(shape) for name, shape in shapes.items()})


@pytest.mark.parametrize("wrapper,operand", CASES)
def test_an_operand_four_bytes_past_a_boundary_is_refused(wrapper, operand):
    shapes, check, _ = WRAPPERS[wrapper]
    ops = {name: _aligned(shape) for name, shape in shapes.items()}
    ops[operand] = _shifted(shapes[operand])
    assert ops[operand].is_contiguous() and ops[operand].contiguous() is ops[operand]
    with pytest.raises(ValueError, match=f"^{operand}: the .* kernel reads 16 bytes at a "
                                         "time and needs a 16-byte aligned start, got "
                                         "offset 4 bytes"):
        check(ops)


@pytest.mark.parametrize("operand", UNALIGNED_OK)
def test_sampler_takes_what_it_reads_by_words_at_any_offset(operand):
    """Biases, LayerNorm parameters, the canvas, positions and uniforms are
    read 4 bytes at a time: an offset start is fine."""
    shapes = _sampler_operands()
    ops = {name: _aligned(shape) for name, shape in shapes.items()}
    ops[operand] = _shifted(shapes[operand])
    _check_sampler(ops)


@pytest.mark.parametrize("operand", SNAIL_UNALIGNED_OK)
def test_snail_sampler_takes_what_it_reads_by_words_at_any_offset(operand):
    """The PixelSNAIL sampler reads its biases, h2_w, the canvas and the
    uniforms 4 bytes at a time: an offset start is fine."""
    shapes = _snail_operands()
    ops = {name: _aligned(shape) for name, shape in shapes.items()}
    ops[operand] = _shifted(shapes[operand])
    _check_snail(ops)
