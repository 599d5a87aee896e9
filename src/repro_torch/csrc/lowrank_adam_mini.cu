// Fused low-rank Adam-mini update with back-projection for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_update/kernel.py
// ::lowrank_adam_mini_update_batched (pallas_call at l.393).  Per slice b:
//
//   M' = b1 M + (1-b1) R
//   N  = (M'/bc1) / den,   den = sqrt(v'/bc2) + eps
//   W' = (1 - lr_wd) W - lr_alpha * P @ N
//
// v' is Adam-mini's one second moment per PER-LEAF row: (B, r) for a
// side='left' bucket (a mean over n), (B, n) for a side='right' one (a mean
// over r, the per-leaf last axis).  As in JAX, which computes it with jnp
// outside its Pallas body (kernel.py:378), the wrapper computes v' and den
// with plain PyTorch reductions (ref.py::adam_mini_stats_ref): the side-left
// mean crosses every n-tile, and the statistic is (B, r) or (B, n) f32,
// r/d of a weight's size.  den reaches this kernel as (B, r) or (B, n),
// broadcast along the n columns or the r rows by its strides.
//
// W (B, d, n) f32 or bf16 (W' keeps its dtype), P (B, d, r) f32, R/M
// (B, r, n) f32.
//
// Design.  Two launches, as lowrank_adam.cu (Hopper blocks run in no
// order): an elementwise pass writes M' once and N into an f32 scratch,
// with each product and sum rounded on its own (__fmul_rn, __fadd_rn: no
// FMA contraction) so that M' and N are the plain version's bit for bit;
// then the back-projection of lowrank_apply.cuh.
//
// Bound on the H100.  2 * B * d * r * n operations for the product on the
// f32 CUDA cores: operations bound it (7.18 ms for the mlp-left bucket,
// B 8, 4096 x 14336, r 512, at 67 TFLOP/s).
#include "lowrank_apply.cuh"

namespace repro {
namespace {

__global__ void adam_mini_moments_kernel(
    const float* __restrict__ r, const float* __restrict__ m,
    const float* __restrict__ den, float* __restrict__ m_out,
    float* __restrict__ n_out, long long total, int rank, int n,
    long long den_b, long long den_i, long long den_j, float b1, float c1,
    float bc1) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long j = idx % n;
    const long long row = idx / n;
    const long long i = row % rank;
    const long long b = row / rank;
    const float mn = __fadd_rn(__fmul_rn(b1, m[idx]), __fmul_rn(c1, r[idx]));
    m_out[idx] = mn;
    n_out[idx] = __fdiv_rn(__fdiv_rn(mn, bc1), den[b * den_b + i * den_i + j * den_j]);
  }
}

}  // namespace
}  // namespace repro

// w, w_out (B, d, n) f32/bf16; p (B, d, r) f32; r_g, m, m_out and the
// scratch n_scr (B, r, n) f32; den (B, r) for side 0 ('left'), (B, n) for
// side 1 ('right'), f32; contiguous, one device.  c1 = 1 - b1, bc1 = 1 -
// b1^t, keep = 1 - lr_wd.  Returns the cudaError_t of the launches.  The
// split schedule (lowrank_apply.cuh): w null runs the moments pass alone.
extern "C" int repro_lowrank_adam_mini_update_batched(
    const void* w, const void* p, const void* r_g, const void* m,
    const void* den, void* w_out, void* m_out, void* n_scr, int dtype, int B,
    int d, int n, int rank, int side, float b1, float c1, float bc1,
    float lr_alpha, float keep, void* stream) {
  if (repro::bad_update_shape(dtype, B, d, n, rank) || (side != 0 && side != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ns = static_cast<float*>(n_scr);
  const long long total = (long long)B * rank * n;
  // den element of (b, i, j): den[b, i] on side 'left', den[b, j] on 'right'
  const long long den_b = side == 0 ? rank : n;
  const long long den_i = side == 0 ? 1 : 0;
  const long long den_j = side == 0 ? 0 : 1;
  const int threads = 256;
  repro::adam_mini_moments_kernel<<<repro::elementwise_blocks(total, threads),
                                    threads, 0, s>>>(
      static_cast<const float*>(r_g), static_cast<const float*>(m),
      static_cast<const float*>(den), static_cast<float*>(m_out), ns, total,
      rank, n, den_b, den_i, den_j, b1, c1, bc1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || w == nullptr) return static_cast<int>(err);
  return static_cast<int>(repro::launch_backproject(
      dtype, w, static_cast<const float*>(p), ns, w_out, B, d, n, rank,
      lr_alpha, keep, s));
}
