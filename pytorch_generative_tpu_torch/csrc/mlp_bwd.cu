// Backward of the fused LayerNorm -> W1 -> exact GELU -> W2 -> residual
// block over (R, C) float32 rows, from x, dO and the forward's saved
// pre-activation y (R, F):
//   g = gelu(y), dW2 = g^T dO, db2 = sum dO,
//   dy = (dO W2^T) * gelu'(y), dW1 = LN(x)^T dy, db1 = sum dy,
//   dln = dy W1^T, then the LayerNorm backward of dln: dgamma, dbeta and
//   dx = LN-backward(dln) + dO (the residual path).
//
// mlp_bwd_f32 replaces pytorch_generative_tpu/ops/mlp_pallas.py::
// _bwd_kernel_savey / _bwd_kernel with a saved y (launched by _fused_bwd,
// the custom_vjp backward of ln_mlp_residual with _SAVE_PREACT). Same
// outputs, the weight, bias and LayerNorm-parameter gradients summed over
// all R rows in f32. Two more entries give the same outputs by other routes
// of the JAX package:
//   mlp_bwd_recompute_f32 replaces _bwd_kernel without a saved y (the
//   _SAVE_PREACT = False route, mlp_pallas.py:112): it first recomputes y by
//   the forward's own launches (row statistics, then LN(x) W1 + b1 as
//   mlp_fwd.cu runs them) into an (R, F) buffer that lives only inside the
//   call, so y is the forward's bit for bit and the outputs are those of
//   mlp_bwd_f32 from the forward's saved y; it costs one more (R x C x F)
//   product, 2 R C F FLOPs;
//   mlp_bwd_pipe_f32 replaces _bwd_kernel_pipelined (PGT_MLP_BWD=pipe,
//   mlp_pallas.py:187), the backward skewed in two stages. The TPU kernel
//   skews them one grid step apart inside one kernel so that its matrix
//   unit and vector unit overlap. Here the skew is across two streams: the
//   R rows are cut into the parts of the weight-gradient products below,
//   the front stage of part t + 1 (dy and its dW2 partial) runs on the
//   caller's stream while the back stage of part t (its dW1 partial, dln
//   and the LayerNorm backward with dx) runs on a second stream, ordered by
//   an event; db1 is summed over all rows at the end. Every part starts on
//   a boundary of the LayerNorm backward's per-CTA partial sums, and the
//   partials are added in part order as in mlp_bwd_f32, so its outputs are
//   mlp_bwd_f32's bit for bit.
//
// Why the design differs from the TPU's: the TPU kernel walks row blocks in
// order and adds every weight gradient into VMEM tiles that its sequential
// grid revisits. CUDA blocks run in no order, and this kernel uses no
// atomics, so that the gradients are the same run to run. It runs as
// launches on one stream:
//   1. per-row (mean, rstd) of x (rows.cuh);
//   2. dy = (dO W2^T) * gelu'(y): a product over C per row, with gelu'(y)
//      in the epilogue; dy (R, F) goes to device memory;
//   3. dW2 = gelu(y)^T dO and 4. dW1 = LN(x)^T dy: products over the R rows,
//      cut into parts of R whose partial products are written apart and
//      then added in order (sum_slices); GELU and the LayerNorm (from the
//      stats of 1) are applied to y and x as they are loaded;
//   5. dln = dy W1^T (R, C);
//   6. the LayerNorm backward over whole rows of dln (warp per row, it
//      needs each row's two means), + dO, with per-CTA partial sums of
//      dln * xhat, dln and dO added in order for dgamma, dbeta and db2;
//   7. db1 = sum dy: per-chunk column sums added in order.
//
// What bounds it on an H100: four (R x C x F) products, 8 R C F FLOPs
// (421 GFLOP at R = 50,176, C = 512, F = 2048), against 0.74 GB of operands:
// f32 FMA work on the CUDA cores (67 TFLOP/s), ~6.3 ms at best. The
// products are sgemm.cuh's SIMT tiles. The R rows of dW1 and dW2 are cut
// into parts of part_rows rows, a multiple of step 6's rows per CTA, so
// that every route cuts its sums alike.

#include "mlp.cuh"

// Inputs, contiguous float32: x, dout (R, C), y (R, F), gamma, beta (C,),
// w1 (C, F), w2 (F, C). Outputs: dx (R, C), dw1 (C, F), db1 (F,),
// dw2 (F, C), and sums (3, C) = (dgamma, dbeta, db2). Scratch: stats (R, 2),
// dy (R, F), dln (R, C), wpart (ceil(R / part_rows), C * F), rpart (ceil(R /
// rows_per_cta), 3, C), cpart (ceil(R / rows_per_chunk), F). C and F
// multiples of 4, C at most rows::kMaxChannels (4096); part_rows a multiple
// of rows_per_cta and of 8.
extern "C" int mlp_bwd_f32(const float* x, const float* dout, const float* y,
                           const float* gamma, const float* beta, const float* w1,
                           const float* w2, float* dx, float* dw1, float* db1,
                           float* dw2, float* sums, float* stats, float* dy,
                           float* dln, float* wpart, float* rpart, float* cpart,
                           int R, int C, int F, int part_rows, int rows_per_cta,
                           int rows_per_chunk, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = reinterpret_cast<float2*>(stats);
  const mlp::Backward bw{x,    dout, y,    gamma, beta,  w1,    w2,        dx,
                         dw1,  db1,  dw2,  sums,  st,    dy,    dln,       wpart,
                         wpart, rpart, cpart, R,  C,     F,     part_rows, rows_per_cta,
                         rows_per_chunk, eps};
  if (!bw.valid()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = rows::row_stats(x, st, R, C, eps, s);
  if (err != cudaSuccess) return err;
  return bw.run(s);
}

// As mlp_bwd_f32 without a saved y: b1 (F,) joins the inputs and y (R, F)
// is scratch, recomputed as the forward computes it.
extern "C" int mlp_bwd_recompute_f32(
    const float* x, const float* dout, const float* gamma, const float* beta,
    const float* w1, const float* b1, const float* w2, float* dx, float* dw1,
    float* db1, float* dw2, float* sums, float* stats, float* y, float* dy, float* dln,
    float* wpart, float* rpart, float* cpart, int R, int C, int F, int part_rows,
    int rows_per_cta, int rows_per_chunk, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = reinterpret_cast<float2*>(stats);
  const mlp::Backward bw{x,    dout, y,    gamma, beta,  w1,    w2,        dx,
                         dw1,  db1,  dw2,  sums,  st,    dy,    dln,       wpart,
                         wpart, rpart, cpart, R,  C,     F,     part_rows, rows_per_cta,
                         rows_per_chunk, eps};
  if (!bw.valid()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mlp::preact(x, gamma, beta, w1, b1, y, st, R, C, F, eps, s);
  if (err != cudaSuccess) return err;
  return bw.run(s);
}

// As mlp_bwd_f32, with the dW2 and dW1 partials in two buffers wpart2 and
// wpart1 (each ceil(R / part_rows) x C * F), run on `stream` and
// `back_stream` as the header says; `stream` waits for all of it before
// the partials are added.
extern "C" int mlp_bwd_pipe_f32(const float* x, const float* dout, const float* y,
                                const float* gamma, const float* beta, const float* w1,
                                const float* w2, float* dx, float* dw1, float* db1,
                                float* dw2, float* sums, float* stats, float* dy,
                                float* dln, float* wpart2, float* wpart1, float* rpart,
                                float* cpart, int R, int C, int F, int part_rows,
                                int rows_per_cta, int rows_per_chunk, float eps,
                                void* stream, void* back_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStream_t s1 = static_cast<cudaStream_t>(back_stream);
  float2* st = reinterpret_cast<float2*>(stats);
  const mlp::Backward bw{x,     dout,   y,     gamma, beta,  w1,    w2,        dx,
                         dw1,   db1,    dw2,   sums,  st,    dy,    dln,       wpart2,
                         wpart1, rpart, cpart, R,     C,     F,     part_rows, rows_per_cta,
                         rows_per_chunk, eps};
  if (!bw.valid() || s == s1) return static_cast<int>(cudaErrorInvalidValue);
  cudaEvent_t front_done, back_done;
  cudaError_t err = cudaEventCreateWithFlags(&front_done, cudaEventDisableTiming);
  if (err != cudaSuccess) return err;
  err = cudaEventCreateWithFlags(&back_done, cudaEventDisableTiming);
  if (err != cudaSuccess) {
    cudaEventDestroy(front_done);
    return err;
  }
  err = rows::row_stats(x, st, R, C, eps, s);
  for (int t = 0; t < bw.parts() && err == cudaSuccess; ++t) {
    const int r0 = t * part_rows, n = std::min(part_rows, R - r0);
    err = bw.dy_rows(r0, n, s);
    if (err == cudaSuccess) err = bw.dw2_parts(t, 1, s);
    // The back stage of part t waits for its front stage (and for all the
    // caller's stream held before it); the front stage of part t + 1 goes
    // on at once on the caller's stream.
    if (err == cudaSuccess) err = cudaEventRecord(front_done, s);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(s1, front_done, 0);
    if (err == cudaSuccess) err = bw.dw1_parts(t, 1, s1);
    if (err == cudaSuccess) err = bw.dx_rows(r0, n, s1);
  }
  // Whatever was issued on the second stream finishes before the caller's
  // stream goes on, also after an error.
  cudaError_t join = cudaEventRecord(back_done, s1);
  if (join == cudaSuccess) join = cudaStreamWaitEvent(s, back_done, 0);
  if (err == cudaSuccess) err = join;
  if (err == cudaSuccess) err = bw.sum_dw2(s);
  if (err == cudaSuccess) err = bw.sum_dw1(s);
  if (err == cudaSuccess) err = bw.sum_ln(s);
  if (err == cudaSuccess) err = bw.db1_sum(s);
  cudaEventDestroy(front_done);
  cudaEventDestroy(back_done);
  return err;
}
