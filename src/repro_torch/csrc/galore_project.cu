// GaLore/SARA gradient projection for Hopper, two entry points.
//
// 1. repro_galore_project_batched: R[b] = P[b]^T G[b].  Replaces the TPU
//    kernel src/repro/kernels/galore_project/kernel.py
//    ::galore_project_batched (pallas_call at l.170): G (B, d, n) f32 or
//    bf16, P (B, d, r) f32, R (B, r, n) f32 with f32 accumulation -- the
//    bucketed engine's hot-step projection (core/buckets.py::
//    bucketed_update), one launch per bucket.
// 2. repro_galore_project: the 2-D projection fused with Adam's moments.
//    Replaces ::galore_project (pallas_call at l.92, def at l.73): G (d, n)
//    f32 or bf16, P (d, r) f32, M and V (r, n) f32 or bf16, and
//
//      R = P^T G,   M' = b1 M + (1-b1) R,   V' = b2 V + (1-b2) R*R,
//
//    all three (r, n) f32.  No path of the JAX package calls it; the port
//    keeps it beside its plain version (ref.py::galore_project_ref).
//
// Design.  The TPU kernels carry an (r, bn) accumulator in VMEM across a
// sequential d grid axis, and the 2-D one updates the moments at the last
// d-block.  Here one block owns a 128 x 128 tile of R (a slice b, an
// r-tile and an n-tile) and loops over d itself (batched_gemm.cuh): P is
// read k-major (its d rows are the contraction), G row by row, both
// through the engine's ring of cp.async stages.  No order between blocks
// is needed, so R never leaves registers before the epilogue, which for
// the 2-D kernel reads M and V and writes R, M' and V' once each
// (ProjectMoments).  The moments round every product and sum on their own
// (__fmul_rn, __fadd_rn: no FMA contraction), as the plain version does,
// so M' and V' equal the plain version's given the same R.
//
// Bound on the H100.  2 * B * r * d * n operations on B * d * (n + r)
// inputs: at the training shapes (r = 512) about 256 operations per f32
// byte read, above the f32 CUDA cores' line (67 TFLOP/s over 3.35 TB/s is
// ~20), so the bound is operations (the 2-D kernel at d 2048, n 8192,
// r 512: 17.2 GFLOP, 0.256 ms, against 155 MB, 0.046 ms).  chip_smoke.py
// records the times beside it and beside one torch.bmm (torch.mm) of the
// same product.
#include "batched_gemm.cuh"

namespace repro {
namespace {

template <typename TG>
cudaError_t launch(const void* g, const float* p, float* r, int B, int d,
                   int n, int rank, cudaStream_t stream) {
  // A = P stored (d, r): k-major with M = r, K = d.  B = G stored (d, n).
  const long long rs = (long long)rank * n;
  return launch_gemm<true>(p, static_cast<const TG*>(g), rank, n, d, rank, n,
                           (long long)d * rank, (long long)d * n, B,
                           StoreF32{r, n, rs, rows_16b_aligned(r, n, rs, 4)},
                           stream);
}

// The 2-D kernel's epilogue: R, M' and V' (f32) from R and M, V (TM).
template <typename TM>
struct ProjectMoments {
  const TM* m;
  const TM* v;
  float* r_out;
  float* m_out;
  float* v_out;
  long long ld;
  float b1, c1, b2, c2;  // c1 = 1 - b1, c2 = 1 - b2
  bool vec;  // every (r, n) operand's rows start on 16 bytes
  __device__ __forceinline__ void operator()(int, int i, int j,
                                             const float* acc, int cnt) const {
    const long long o = (long long)i * ld + j;
    float mv[4], vv[4], mn[4], vn[4];
    global4(m + o, vec, cnt, mv);
    global4(v + o, vec, cnt, vv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mn[e] = __fadd_rn(__fmul_rn(b1, mv[e]), __fmul_rn(c1, acc[e]));
      vn[e] = __fadd_rn(__fmul_rn(b2, vv[e]),
                        __fmul_rn(__fmul_rn(c2, acc[e]), acc[e]));
    }
    store4(r_out + o, vec, cnt, acc);
    store4(m_out + o, vec, cnt, mn);
    store4(v_out + o, vec, cnt, vn);
  }
};

template <typename TG, typename TM>
cudaError_t launch_moments(const void* g, const float* p, const void* m,
                           const void* v, float* r, float* m_out, float* v_out,
                           int d, int n, int rank, float b1, float c1,
                           float b2, float c2, cudaStream_t stream) {
  const long long rs = (long long)rank * n;
  const bool vec = rows_16b_aligned(m, n, rs, sizeof(TM)) &&
                   rows_16b_aligned(v, n, rs, sizeof(TM)) &&
                   rows_16b_aligned(r, n, rs, 4) &&
                   rows_16b_aligned(m_out, n, rs, 4) &&
                   rows_16b_aligned(v_out, n, rs, 4);
  return launch_gemm<true>(
      p, static_cast<const TG*>(g), rank, n, d, rank, n, (long long)d * rank,
      (long long)d * n, 1,
      ProjectMoments<TM>{static_cast<const TM*>(m), static_cast<const TM*>(v),
                         r, m_out, v_out, n, b1, c1, b2, c2, vec},
      stream);
}

template <typename TG>
cudaError_t dispatch_moments(int mdtype, const void* g, const float* p,
                             const void* m, const void* v, float* r,
                             float* m_out, float* v_out, int d, int n,
                             int rank, float b1, float c1, float b2, float c2,
                             cudaStream_t stream) {
  if (mdtype == kFloat32)
    return launch_moments<TG, float>(g, p, m, v, r, m_out, v_out, d, n, rank,
                                     b1, c1, b2, c2, stream);
  if (mdtype == kBFloat16)
    return launch_moments<TG, __nv_bfloat16>(g, p, m, v, r, m_out, v_out, d,
                                             n, rank, b1, c1, b2, c2, stream);
  return cudaErrorInvalidValue;
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

// g (d, n) f32/bf16 (code ``dtype``), p (d, r) f32, m and v (r, n) of one
// dtype (code ``mdtype``), r_out, m_out, v_out (r, n) f32; contiguous, one
// device.  c1 = 1 - b1, c2 = 1 - b2.  Returns the cudaError_t of the launch.
extern "C" int repro_galore_project(const void* g, const void* p,
                                    const void* m, const void* v, void* r_out,
                                    void* m_out, void* v_out, int dtype,
                                    int mdtype, int d, int n, int rank,
                                    float b1, float c1, float b2, float c2,
                                    void* stream) {
  if (d < 1 || n < 1 || rank < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  float* rr = static_cast<float*>(r_out);
  float* mo = static_cast<float*>(m_out);
  float* vo = static_cast<float*>(v_out);
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::dispatch_moments<float>(
        mdtype, g, pp, m, v, rr, mo, vo, d, n, rank, b1, c1, b2, c2, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(repro::dispatch_moments<__nv_bfloat16>(
        mdtype, g, pp, m, v, rr, mo, vo, d, n, rank, b1, c1, b2, c2, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
