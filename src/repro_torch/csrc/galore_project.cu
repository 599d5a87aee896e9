// Batched GaLore/SARA gradient projection for Hopper: R[b] = P[b]^T G[b].
//
// Replaces the TPU kernel src/repro/kernels/galore_project/kernel.py
// ::galore_project_batched (pallas_call at l.170): G (B, d, n) f32 or bf16,
// P (B, d, r) f32, R (B, r, n) f32 with f32 accumulation -- the bucketed
// engine's hot-step projection (core/buckets.py::bucketed_update), one
// launch per bucket.
//
// Design.  The TPU kernel carries an (r, bn) accumulator in VMEM across a
// sequential d grid axis.  Here one block owns a 128 x 128 tile of R (a
// slice b, an r-tile and an n-tile) and loops over d itself
// (batched_gemm.cuh): P is read k-major (its d rows are the contraction),
// G row by row, both staged 8 rows of d at a time in shared memory.  No
// order between blocks is needed, so the d loop is the only sequential
// part.
//
// Bound on the H100.  2 * B * r * d * n operations on B * d * (n + r)
// inputs: at the training shapes (r = 512) about 256 operations per f32
// byte read, above the f32 CUDA cores' line (67 TFLOP/s over 3.35 TB/s is
// ~20), so the bound is operations.  chip_smoke.py records the time beside
// it and beside one torch.bmm of the same product.
#include "batched_gemm.cuh"

namespace repro {
namespace {

template <typename TG>
cudaError_t launch(const void* g, const float* p, float* r, int B, int d,
                   int n, int rank, cudaStream_t stream) {
  // A = P stored (d, r): k-major with M = r, K = d.  B = G stored (d, n).
  batched_gemm_kernel<true, float, TG, StoreF32>
      <<<gemm_grid(rank, n, B), kGemmThreads, 0, stream>>>(
          p, static_cast<const TG*>(g), rank, n, d, rank, n,
          (long long)d * rank, (long long)d * n,
          StoreF32{r, n, (long long)rank * n});
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// g (B, d, n) f32/bf16, p (B, d, r) f32, r_out (B, r, n) f32; contiguous,
// one device.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_galore_project_batched(const void* g, const void* p,
                                            void* r_out, int dtype, int B,
                                            int d, int n, int rank,
                                            void* stream) {
  if (B < 1 || d < 1 || n < 1 || rank < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  float* rr = static_cast<float*>(r_out);
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::launch<float>(g, pp, rr, B, d, n, rank, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(
        repro::launch<__nv_bfloat16>(g, pp, rr, B, d, n, rank, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
