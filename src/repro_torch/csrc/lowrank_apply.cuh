// The back-projection shared by the fused low-rank updates
// (lowrank_adam.cu, lowrank_msgd.cu, lowrank_adam_mini.cu,
// lowrank_adam8bit.cu).  Each update first runs its own moments pass, which
// writes the subspace direction N (B, r, n) f32 (MSGD's is M' itself); this
// header's launch then runs the tiled product of batched_gemm.cuh with
// A = P (B, d, r) and B = N, whose epilogue writes
//
//   W' = keep * W - lr_alpha * (P @ N),   keep = 1 - lr * weight_decay,
//
// per element in W's dtype: the full-space direction P @ N never reaches
// device memory, and W is read and written once.
//
// The split schedule (ZeRO state on the FSDP step, core/buckets.py): each
// update's C entry runs its moments pass alone when W is null, on this
// process's rows of the state; repro_lowrank_backproject (lowrank_adam.cu)
// then runs this product alone on every row of its block of W, from the N
// gathered in between.
#pragma once

#include "batched_gemm.cuh"

namespace repro {

template <typename TW>
struct WeightApply {
  const TW* w;
  TW* w_out;
  long long ld, stride;
  float keep, lr_alpha;
  bool vec;  // rows of W and W' start on 16 bytes (rows_16b_aligned)
  __device__ __forceinline__ void operator()(int b, int i, int j,
                                             const float* acc, int cnt) const {
    const long long o = (long long)b * stride + (long long)i * ld + j;
    float x[4];
    global4(w + o, vec, cnt, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = keep * x[e] - lr_alpha * acc[e];
    store4(w_out + o, vec, cnt, x);
  }
};

template <typename TW>
cudaError_t launch_backproject_t(const void* w, const float* p,
                                 const float* n_dir, void* w_out, int B,
                                 int d, int n, int rank, float lr_alpha,
                                 float keep, cudaStream_t stream) {
  // A = P stored (d, r): m-major with M = d, K = r.  B = N stored (r, n).
  const long long ws = (long long)d * n;
  const bool vec = rows_16b_aligned(w, n, ws, sizeof(TW)) &&
                   rows_16b_aligned(w_out, n, ws, sizeof(TW));
  return launch_gemm<false>(
      p, n_dir, d, n, rank, rank, n, (long long)d * rank, (long long)rank * n,
      B,
      WeightApply<TW>{static_cast<const TW*>(w), static_cast<TW*>(w_out), n,
                      ws, keep, lr_alpha, vec},
      stream);
}

// W' for W of dtype code ``dtype`` (kFloat32 or kBFloat16).
inline cudaError_t launch_backproject(int dtype, const void* w, const float* p,
                                      const float* n_dir, void* w_out, int B,
                                      int d, int n, int rank, float lr_alpha,
                                      float keep, cudaStream_t stream) {
  if (dtype == kFloat32)
    return launch_backproject_t<float>(w, p, n_dir, w_out, B, d, n, rank,
                                       lr_alpha, keep, stream);
  if (dtype == kBFloat16)
    return launch_backproject_t<__nv_bfloat16>(w, p, n_dir, w_out, B, d, n,
                                               rank, lr_alpha, keep, stream);
  return cudaErrorInvalidValue;
}

// Blocks of ``threads`` for a grid-stride elementwise pass over ``total``
// elements: enough to fill the card, never more than the work.
inline int elementwise_blocks(long long total, int threads) {
  const long long want = (total + threads - 1) / threads;
  return static_cast<int>(want < 132 * 32 ? want : 132 * 32);
}

// The shape checks every update's C entry point makes.
inline bool bad_update_shape(int dtype, int B, int d, int n, int rank) {
  return B < 1 || d < 1 || n < 1 || rank < 1 || B > 65535 ||
         (dtype != kFloat32 && dtype != kBFloat16);
}

}  // namespace repro
