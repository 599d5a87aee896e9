// Fused low-rank momentum-SGD update with back-projection for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_update/kernel.py
// ::lowrank_msgd_update_batched (pallas_call at l.264).  Per slice b:
//
//   M' = (1-b1) M + b1 R      (inner.msgd's convention: b1 weighs the NEW
//                              gradient, the paper's Theorem 3.4)
//   W' = (1 - lr_wd) W - lr_alpha * P @ M'
//
// W (B, d, n) f32 or bf16 (W' keeps its dtype), P (B, d, r) f32, R/M
// (B, r, n) f32.
//
// Design.  As lowrank_adam.cu, two launches in one call, because Hopper
// blocks run in no order (the TPU kernel updates M at d-block 0 and reuses
// it from VMEM on the later d-blocks): an elementwise pass writes M' once,
// then the back-projection of lowrank_apply.cuh reads M' directly as its B
// operand.  MSGD's direction is M' itself, so no scratch is needed.  The
// pass rounds each product and the sum (__fmul_rn, __fadd_rn) so that nvcc
// does not contract them into an FMA: M' is then the plain version's, bit
// for bit.
//
// Bound on the H100.  2 * B * d * r * n operations for the product on the
// f32 CUDA cores, on W (read + write) and three (B, r, n) f32 buffers:
// operations bound it (10.77 ms for the mlp bucket, B 12, 4096 x 14336,
// r 512, at 67 TFLOP/s).
#include "lowrank_apply.cuh"

namespace repro {
namespace {

__global__ void msgd_moments_kernel(const float* __restrict__ r,
                                    const float* __restrict__ m,
                                    float* __restrict__ m_out,
                                    long long total, float c1, float b1) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x)
    m_out[idx] = __fadd_rn(__fmul_rn(c1, m[idx]), __fmul_rn(b1, r[idx]));
}

}  // namespace
}  // namespace repro

// w, w_out (B, d, n) f32/bf16; p (B, d, r) f32; r_g, m, m_out (B, r, n)
// f32; contiguous, one device.  c1 = 1 - b1, keep = 1 - lr_wd.  Returns the
// cudaError_t of the launches.  The split schedule (lowrank_apply.cuh):
// w null runs the moments pass alone (N is M').
extern "C" int repro_lowrank_msgd_update_batched(
    const void* w, const void* p, const void* r_g, const void* m, void* w_out,
    void* m_out, int dtype, int B, int d, int n, int rank, float b1, float c1,
    float lr_alpha, float keep, void* stream) {
  if (repro::bad_update_shape(dtype, B, d, n, rank))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(m_out);
  const long long total = (long long)B * rank * n;
  const int threads = 256;
  repro::msgd_moments_kernel<<<repro::elementwise_blocks(total, threads),
                               threads, 0, s>>>(
      static_cast<const float*>(r_g), static_cast<const float*>(m), mo, total,
      c1, b1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || w == nullptr) return static_cast<int>(err);
  return static_cast<int>(repro::launch_backproject(
      dtype, w, static_cast<const float*>(p), mo, w_out, B, d, n, rank,
      lr_alpha, keep, s));
}
