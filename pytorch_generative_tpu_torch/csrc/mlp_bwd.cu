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
//   the forward's own launches (LN(x), then LN(x) W1 + b1 as mlp_fwd.cu
//   runs them) into an (R, F) buffer that lives only inside the
//   call, so y is the forward's bit for bit and the outputs are those of
//   mlp_bwd_f32 from the forward's saved y; it costs one more (R x C x F)
//   product, 2 R C F FLOPs;
//   mlp_bwd_pipe_f32 replaces _bwd_kernel_pipelined (PGT_MLP_BWD=pipe,
//   mlp_pallas.py:187), the backward skewed in two stages. The TPU kernel
//   skews them one grid step apart inside one kernel so that its matrix
//   unit and vector unit overlap. Here the skew is across two streams, a
//   granule of consecutive slices of the R rows (the slices of the
//   weight-gradient products below) at a time: the front stage of granule
//   t + 1 (dy, g and its dW2 partials) runs on the caller's stream while the
//   back stage of granule t (its dW1 partials, dln and the LayerNorm
//   backward with dx) runs on a second stream, ordered by an event; db1 is
//   summed over all rows at the end. A granule's dW products are one grid
//   with a part for each of its slices, enough CTAs to fill the card. Every
//   slice starts on a boundary of the LayerNorm backward's per-CTA partial
//   sums, its partial is summed as in mlp_bwd_f32's one grid over all
//   slices, and the partials are added in slice order as there, so its
//   outputs are mlp_bwd_f32's bit for bit.
//
// Why the design differs from the TPU's: the TPU kernel walks row blocks in
// order and adds every weight gradient into VMEM tiles that its sequential
// grid revisits. CUDA blocks run in no order, and this kernel uses no
// atomics, so that the gradients are the same run to run. It runs as
// launches on one stream:
//   1. xn = LN(x) (rows.cuh);
//   2. dy = (dO W2^T) * gelu'(y): a product over C per row, with gelu'(y)
//      in the epilogue, which also writes g = gelu(y); dy and g (R, F) go
//      to device memory;
//   3. dW2 = g^T dO and 4. dW1 = xn^T dy: products over the R rows, cut
//      into slices whose partial products are written apart and then added
//      in order (sum_slices);
//   5. dln = dy W1^T (R, C);
//   6. the LayerNorm backward over whole rows of dln (warp per row, it
//      needs each row's two means), + dO, with per-CTA partial sums of
//      dln * xhat, dln and dO added in order for dgamma, dbeta and db2;
//   7. db1 = sum dy: per-chunk column sums added in order.
//
// What bounds it on an H100: four (R x C x F) products, 8 R C F FLOPs
// (421 GFLOP at R = 50,176, C = 512, F = 2048), against 0.74 GB of operands:
// operations. Every product runs on the tensor cores by 3xTF32
// (gemm_tf32x3.cuh, 495 / 3 = 165 TFLOP/s: ~2.6 ms at best; f32 on the CUDA
// cores would stop at 67 TFLOP/s, ~6.3 ms), with W2 and W1 read
// K-contiguous by dy and dln, g and xn M-contiguous by dW2 and dW1. The R
// rows of dW1 and dW2 are cut into slices of part_rows rows, a multiple of
// step 6's rows per CTA and of the GEMM's k-step, each slice a part of
// the products' grid (ops/mlp_cuda.py says how many), so that every route
// cuts its sums alike.
//
// The bf16 entries (mlp_bwd_bf16, mlp_bwd_recompute_bf16, mlp_bwd_pipe_bf16)
// run the same stages on bf16 rows, weights and scratch (mlp.cuh says
// where they round), every product on gemm_wgmma_bf16.cuh (wgmma fed by
// TMA, 989 TFLOP/s: ~0.43 ms at best at R = 50,176, C = 512), and every
// gradient sum in f32. Step 7 has no pass of its own there: the dy
// product's epilogue sums the f32 dy over each 64-row block, and those
// partials are added in order. The three give the same bits: the
// recompute route rounds its y to bf16 as the forward stores it, and the
// pipelined route's granules start on a 128-row tile of the dy product.

#include "mlp.cuh"

namespace {

// The saved-y route: xn = LN(x), then the stages of mlp::Backward::run.
template <class T>
cudaError_t backward(const mlp::Backward<T>& bw, cudaStream_t s) {
  if (!bw.valid()) return cudaErrorInvalidValue;
  cudaError_t err = rows::layer_norm(bw.x, bw.gamma, bw.beta, const_cast<T*>(bw.xn), bw.R,
                                     bw.C, bw.eps, s);
  if (err != cudaSuccess) return err;
  return bw.run(s);
}

// The recompute route: y (scratch) is recomputed by the forward's own
// launches, then the stages of mlp::Backward::run.
template <class T>
cudaError_t backward_recompute(const mlp::Backward<T>& bw, const T* b1, cudaStream_t s) {
  if (!bw.valid()) return cudaErrorInvalidValue;
  cudaError_t err = mlp::preact(bw.x, bw.gamma, bw.beta, bw.w1, b1, const_cast<T*>(bw.xn),
                                const_cast<T*>(bw.y), static_cast<T*>(nullptr), bw.R, bw.C,
                                bw.F, bw.eps, s);
  if (err != cudaSuccess) return err;
  return bw.run(s);
}

// The pipelined route on `s` and `s1`, a granule of `granule` slices at a
// time, as the header says; `s` waits for all of it before the partials
// are added.
template <class T>
cudaError_t backward_pipe(const mlp::Backward<T>& bw, int granule, cudaStream_t s,
                          cudaStream_t s1) {
  if (!bw.valid() || granule <= 0 || s == s1) return cudaErrorInvalidValue;
  cudaEvent_t front_done, back_done;
  cudaError_t err = cudaEventCreateWithFlags(&front_done, cudaEventDisableTiming);
  if (err != cudaSuccess) return err;
  err = cudaEventCreateWithFlags(&back_done, cudaEventDisableTiming);
  if (err != cudaSuccess) {
    cudaEventDestroy(front_done);
    return err;
  }
  err = rows::layer_norm(bw.x, bw.gamma, bw.beta, const_cast<T*>(bw.xn), bw.R, bw.C, bw.eps,
                         s);
  for (int p0 = 0; p0 < bw.parts() && err == cudaSuccess; p0 += granule) {
    const int np = std::min(granule, bw.parts() - p0);
    const int r0 = p0 * bw.part_rows, n = std::min(np * bw.part_rows, bw.R - r0);
    err = bw.dy_rows(r0, n, s);
    if (err == cudaSuccess) err = bw.dw2_parts(p0, np, s);
    // The back stage of this granule waits for its front stage (and for
    // all the caller's stream held before it); the front stage of the
    // next goes on at once on the caller's stream.
    if (err == cudaSuccess) err = cudaEventRecord(front_done, s);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(s1, front_done, 0);
    if (err == cudaSuccess) err = bw.dw1_parts(p0, np, s1);
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

}  // namespace

// Inputs, contiguous float32: x, dout (R, C), y (R, F), gamma, beta (C,),
// w1 (C, F), w2 (F, C). Outputs: dx (R, C), dw1 (C, F), db1 (F,),
// dw2 (F, C), and sums (3, C) = (dgamma, dbeta, db2). Scratch: xn (R, C),
// g and dy (R, F), dln (R, C), wpart (ceil(R / part_rows), C * F), rpart (ceil(R /
// rows_per_cta), 3, C), cpart (ceil(R / rows_per_chunk), F). C and F
// multiples of 4, C at most rows::kMaxChannels (4096); part_rows a multiple
// of rows_per_cta and of 32 (gemm3::kBK).
extern "C" int mlp_bwd_f32(const float* x, const float* dout, const float* y,
                           const float* gamma, const float* beta, const float* w1,
                           const float* w2, float* dx, float* dw1, float* db1,
                           float* dw2, float* sums, float* xn, float* g, float* dy,
                           float* dln, float* wpart, float* rpart, float* cpart,
                           int R, int C, int F, int part_rows, int rows_per_cta,
                           int rows_per_chunk, float eps, void* stream) {
  const mlp::Backward<float> bw{x,   dout,  y,     gamma, beta,  w1,    w2,    dx,
                                dw1, db1,   dw2,   sums,  xn,    g,     dy,    dln,
                                wpart, wpart, rpart, cpart, R,   C,     F,
                                part_rows, rows_per_cta, rows_per_chunk, eps};
  return static_cast<int>(backward(bw, static_cast<cudaStream_t>(stream)));
}

// As mlp_bwd_f32 without a saved y: b1 (F,) joins the inputs and y (R, F)
// is scratch, recomputed as the forward computes it (and its gelu left to
// step 2).
extern "C" int mlp_bwd_recompute_f32(
    const float* x, const float* dout, const float* gamma, const float* beta,
    const float* w1, const float* b1, const float* w2, float* dx, float* dw1,
    float* db1, float* dw2, float* sums, float* xn, float* g, float* y, float* dy,
    float* dln, float* wpart, float* rpart, float* cpart, int R, int C, int F,
    int part_rows, int rows_per_cta, int rows_per_chunk, float eps, void* stream) {
  const mlp::Backward<float> bw{x,   dout,  y,     gamma, beta,  w1,    w2,    dx,
                                dw1, db1,   dw2,   sums,  xn,    g,     dy,    dln,
                                wpart, wpart, rpart, cpart, R,   C,     F,
                                part_rows, rows_per_cta, rows_per_chunk, eps};
  return static_cast<int>(backward_recompute(bw, b1, static_cast<cudaStream_t>(stream)));
}

// As mlp_bwd_f32, with the dW2 and dW1 partials in two buffers wpart2 and
// wpart1 (each ceil(R / part_rows) x C * F), run on `stream` and
// `back_stream` a granule of `granule` slices at a time as the header says;
// `stream` waits for all of it before the partials are added.
extern "C" int mlp_bwd_pipe_f32(const float* x, const float* dout, const float* y,
                                const float* gamma, const float* beta, const float* w1,
                                const float* w2, float* dx, float* dw1, float* db1,
                                float* dw2, float* sums, float* xn, float* g, float* dy,
                                float* dln, float* wpart2, float* wpart1, float* rpart,
                                float* cpart, int R, int C, int F, int part_rows,
                                int rows_per_cta, int rows_per_chunk, int granule, float eps,
                                void* stream, void* back_stream) {
  const mlp::Backward<float> bw{x,   dout,   y,      gamma, beta,  w1,    w2,    dx,
                                dw1, db1,    dw2,    sums,  xn,    g,     dy,    dln,
                                wpart2, wpart1, rpart, cpart, R,  C,     F,
                                part_rows, rows_per_cta, rows_per_chunk, eps};
  return static_cast<int>(backward_pipe(bw, granule, static_cast<cudaStream_t>(stream),
                                        static_cast<cudaStream_t>(back_stream)));
}

// The bf16 entries: as the f32 ones with x, dout, y, gamma, beta, w1, b1,
// w2, dx and the scratch xn, g, dy bf16; dw1, db1, dw2, sums, dln and the
// partials stay f32. C and F multiples of 8; rows_per_chunk 64 (the dy
// product's row blocks, whose column sums cpart holds) and part_rows a
// multiple of 128 (the GEMM's tile).
using BP = const bf16::T*;
using BW = bf16::T*;

extern "C" int mlp_bwd_bf16(const void* x, const void* dout, const void* y,
                            const void* gamma, const void* beta, const void* w1,
                            const void* w2, void* dx, float* dw1, float* db1, float* dw2,
                            float* sums, void* xn, void* g, void* dy, float* dln, float* wpart, float* rpart, float* cpart, int R, int C, int F,
                            int part_rows, int rows_per_cta, int rows_per_chunk, float eps,
                            void* stream) {
  const mlp::Backward<bf16::T> bw{
      BP(x),   BP(dout), BP(y),   BP(gamma), BP(beta),  BP(w1), BP(w2), BW(dx),
      dw1,     db1,      dw2,     sums,      BP(xn),    BW(g),  BW(dy), dln,
      wpart,   wpart,    rpart,   cpart,     R,         C,      F,
      part_rows, rows_per_cta, rows_per_chunk, eps};
  return static_cast<int>(backward(bw, static_cast<cudaStream_t>(stream)));
}

extern "C" int mlp_bwd_recompute_bf16(
    const void* x, const void* dout, const void* gamma, const void* beta, const void* w1,
    const void* b1, const void* w2, void* dx, float* dw1, float* db1, float* dw2,
    float* sums, void* xn, void* g, void* y, void* dy, float* dln, float* wpart,
    float* rpart, float* cpart, int R, int C, int F, int part_rows, int rows_per_cta,
    int rows_per_chunk, float eps, void* stream) {
  const mlp::Backward<bf16::T> bw{
      BP(x),   BP(dout), BP(y),   BP(gamma), BP(beta),  BP(w1), BP(w2), BW(dx),
      dw1,     db1,      dw2,     sums,      BP(xn),    BW(g),  BW(dy), dln,
      wpart,   wpart,    rpart,   cpart,     R,         C,      F,
      part_rows, rows_per_cta, rows_per_chunk, eps};
  return static_cast<int>(backward_recompute(bw, BP(b1), static_cast<cudaStream_t>(stream)));
}

extern "C" int mlp_bwd_pipe_bf16(const void* x, const void* dout, const void* y,
                                 const void* gamma, const void* beta, const void* w1,
                                 const void* w2, void* dx, float* dw1, float* db1, float* dw2,
                                 float* sums, void* xn, void* g, void* dy, float* dln,
                                 float* wpart2, float* wpart1, float* rpart,
                                 float* cpart, int R, int C, int F, int part_rows,
                                 int rows_per_cta, int rows_per_chunk, int granule, float eps,
                                 void* stream, void* back_stream) {
  const mlp::Backward<bf16::T> bw{
      BP(x),   BP(dout), BP(y),   BP(gamma), BP(beta),  BP(w1), BP(w2), BW(dx),
      dw1,     db1,      dw2,     sums,      BP(xn),    BW(g),  BW(dy), dln,
      wpart2,  wpart1,   rpart,   cpart,     R,         C,      F,
      part_rows, rows_per_cta, rows_per_chunk, eps};
  return static_cast<int>(backward_pipe(bw, granule, static_cast<cudaStream_t>(stream),
                                        static_cast<cudaStream_t>(back_stream)));
}
