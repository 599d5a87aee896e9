// Fused low-rank Adam update with back-projection for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_update/kernel.py
// ::lowrank_adam_update_batched (pallas_call at l.137).  Per slice b:
//
//   M' = b1 M + (1-b1) R,   V' = b2 V + (1-b2) R*R
//   N  = (M'/bc1) / (sqrt(V'/bc2) + eps)
//   W' = (1 - lr_wd) W - lr_alpha * P @ N
//
// W (B, d, n) f32 or bf16 (W' keeps its dtype), P (B, d, r) f32, R/M/V
// (B, r, n) f32.  step, lr_alpha and lr_wd are plain launch arguments
// (bc1 = 1 - b1^t and bc2 = 1 - b2^t come from the wrapper), so a moving
// learning rate never rebuilds anything.
//
// Design.  The TPU kernel computes N once per (slice, n-block) at d-block 0
// in VMEM scratch and reuses it for the later d-blocks, which only works
// because TPU grid steps run in order.  Hopper blocks run in no order, so
// the work is two launches in one call, as paged_decode.cu pairs its split
// kernel with a combine kernel:
//
//   1. adam_moments_kernel, elementwise over (B, r, n): writes M' and V'
//      (each exactly once) and N into an f32 scratch the wrapper allocates;
//   2. the back-projection of lowrank_apply.cuh (shared with the MSGD,
//      Adam-mini and 8-bit Adam updates): the tiled product P @ N, whose
//      epilogue reads W and writes W' = keep * W - lr_alpha * (P @ N).
//
// N costs one extra (B, r, n) f32 write and re-reads that stay mostly in
// the 50 MB L2 (one n-tile column of N serves all d-tiles of its slice).
//
// Bound on the H100.  2 * B * d * r * n operations for the product, on
// W (read + write) and five (B, r, n) f32 buffers: ~100 operations per
// byte at r = 512, above the f32 line (~20), so operations bound it.
#include "lowrank_apply.cuh"

namespace repro {
namespace {

__global__ void adam_moments_kernel(const float* __restrict__ r,
                                    const float* __restrict__ m,
                                    const float* __restrict__ v,
                                    float* __restrict__ m_out,
                                    float* __restrict__ v_out,
                                    float* __restrict__ n_out,
                                    long long total, float b1, float c1,
                                    float b2, float c2, float eps, float bc1,
                                    float bc2) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const float rg = r[idx];
    const float mn = b1 * m[idx] + c1 * rg;
    const float vn = b2 * v[idx] + c2 * rg * rg;
    m_out[idx] = mn;
    v_out[idx] = vn;
    n_out[idx] = (mn / bc1) / (sqrtf(vn / bc2) + eps);
  }
}

}  // namespace
}  // namespace repro

// w, w_out (B, d, n) f32/bf16; p (B, d, r) f32; r_g, m, v, m_out, v_out and
// the scratch n_scr (B, r, n) f32; contiguous, one device.  c1 = 1 - b1,
// c2 = 1 - b2, keep = 1 - lr_wd.  Returns the cudaError_t of the launches.
// The split schedule (lowrank_apply.cuh): w null runs the moments pass
// alone.
extern "C" int repro_lowrank_adam_update_batched(
    const void* w, const void* p, const void* r_g, const void* m,
    const void* v, void* w_out, void* m_out, void* v_out, void* n_scr,
    int dtype, int B, int d, int n, int rank, float b1, float c1, float b2,
    float c2, float eps, float bc1, float bc2, float lr_alpha, float keep,
    void* stream) {
  if (repro::bad_update_shape(dtype, B, d, n, rank))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ns = static_cast<float*>(n_scr);
  const long long total = (long long)B * rank * n;
  const int threads = 256;
  repro::adam_moments_kernel<<<repro::elementwise_blocks(total, threads),
                               threads, 0, s>>>(
      static_cast<const float*>(r_g), static_cast<const float*>(m),
      static_cast<const float*>(v), static_cast<float*>(m_out),
      static_cast<float*>(v_out), ns, total, b1, c1, b2, c2, eps, bc1, bc2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || w == nullptr) return static_cast<int>(err);
  return static_cast<int>(repro::launch_backproject(
      dtype, w, static_cast<const float*>(p), ns, w_out, B, d, n, rank,
      lr_alpha, keep, s));
}

// The split schedule's second half for every update (lowrank_apply.cuh):
// W' = keep * W - lr_alpha * P @ N on every row of a block, from the N
// (B, r, n) f32 gathered after the update's moments pass ran on this
// process's rows.  w, w_out (B, d, n) f32/bf16; p (B, d, r) f32;
// contiguous, one device.  Returns the cudaError_t of the launch.
extern "C" int repro_lowrank_backproject(const void* w, const void* p,
                                         const void* n_dir, void* w_out,
                                         int dtype, int B, int d, int n,
                                         int rank, float lr_alpha, float keep,
                                         void* stream) {
  if (repro::bad_update_shape(dtype, B, d, n, rank))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(repro::launch_backproject(
      dtype, w, static_cast<const float*>(p),
      static_cast<const float*>(n_dir), w_out, B, d, n, rank, lr_alpha, keep,
      static_cast<cudaStream_t>(stream)));
}
