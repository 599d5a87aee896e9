// Randomized-SVD power-iteration step for Hopper: Y[b] = G[b] (G[b]^T Q[b]).
//
// Replaces the TPU kernel src/repro/kernels/power_iter/kernel.py
// ::power_iter_batched (pallas_call at l.116): G (B, m, n) f32 or bf16,
// Q (B, m, k') f32, Y (B, m, k') f32 with f32 accumulation -- one subspace
// iteration of the bucketed SARA refresh (core/svd.py::
// randomized_svd_stacked), one call per bucket and iteration.
//
// Design.  The TPU kernel keeps Z = G^T Q (n, k') in VMEM across a
// two-phase sequential grid.  At the training shapes Z does not fit on
// chip here: n * k' * 4 = 14336 * 2056 * 4 B = 118 MB per slice, against
// 227 KB of shared memory per block and a 50 MB L2.  So Z round-trips
// device memory between two launches of the tiled product of
// batched_gemm.cuh, in one call:
//
//   1. Z = G^T Q  (G read k-major: its m rows are the contraction);
//   2. Y = G Z    (G read row by row: its n columns are the contraction),
//
// with Z in an f32 scratch (B, n, k') the wrapper allocates.  The TPU
// dispatch sends any Z above 6 MB to the plain version
// (src/repro/kernels/power_iter/ops.py:26, 45-47): that is the TPU's VMEM
// budget, not a property of the function, and at full width it would send
// every llama3-8b slice to the plain version.  The port's dispatch
// launches this kernel for every shape it accepts (any B, m, n, k' >= 1).
//
// Bound on the H100.  4 * B * m * n * k' operations on B * (m * n + 2 m k')
// inputs and outputs: thousands of operations per byte at k' = 2056, so
// operations bound it (f32 CUDA cores, 67 TFLOP/s).
#include "batched_gemm.cuh"

namespace repro {
namespace {

template <typename TG>
cudaError_t launch(const void* g, const float* q, float* z, float* y, int B,
                   int m, int n, int kp, cudaStream_t stream) {
  const TG* gg = static_cast<const TG*>(g);
  const long long gs = (long long)m * n;
  // Z = G^T Q: A = G stored (m, n), k-major with M = n, K = m.
  const long long zs = (long long)n * kp, ys = (long long)m * kp;
  cudaError_t err = launch_gemm<true>(
      gg, q, n, kp, m, n, kp, gs, ys, B,
      StoreF32{z, kp, zs, rows_16b_aligned(z, kp, zs, 4)}, stream);
  if (err != cudaSuccess) return err;
  // Y = G Z: A = G stored (m, n), m-major with M = m, K = n.
  return launch_gemm<false>(gg, static_cast<const float*>(z), m, kp, n, n, kp,
                            gs, zs, B,
                            StoreF32{y, kp, ys, rows_16b_aligned(y, kp, ys, 4)},
                            stream);
}

}  // namespace
}  // namespace repro

// g (B, m, n) f32/bf16; q, y (B, m, k') f32; z_scr (B, n, k') f32;
// contiguous, one device.  Returns the cudaError_t of the launches.
extern "C" int repro_power_iter_batched(const void* g, const void* q,
                                        void* z_scr, void* y, int dtype,
                                        int B, int m, int n, int kp,
                                        void* stream) {
  if (B < 1 || m < 1 || n < 1 || kp < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qq = static_cast<const float*>(q);
  float* zz = static_cast<float*>(z_scr);
  float* yy = static_cast<float*>(y);
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::launch<float>(g, qq, zz, yy, B, m, n, kp, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(
        repro::launch<__nv_bfloat16>(g, qq, zz, yy, B, m, n, kp, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
