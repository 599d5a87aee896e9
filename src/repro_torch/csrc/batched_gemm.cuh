// Batched, tiled f32 matrix product shared by the optimizer kernels
// (galore_project.cu, lowrank_adam.cu, power_iter.cu).
//
//   C[b] (M x N) = A[b] (M x K) @ B[b] (K x N), f32 accumulation,
//
// and every C element goes to an epilogue functor ``epi(b, i, j, acc)``, so
// each kernel decides what a finished element becomes (a plain f32 store,
// or W' = keep * W - lr_alpha * acc in W's dtype).  A is read either as
// stored K x M ("k-major": element (i, k) at A[k * lda + i], as P in
// R = P^T G and G in Z = G^T Q) or as stored M x K (element (i, k) at
// A[i * lda + k]).  B is always stored K x N.  Operands are f32 or bf16;
// products and sums are f32 on the CUDA cores (FMA), no tensor cores.
//
// Design.  One block of 256 threads owns a 128 x 128 tile of C and walks K
// in steps of 8: the block stages an 8 x 128 slab of each operand in shared
// memory (k-major in both, zero past the ragged edges of M, N and K), then
// each thread accumulates an 8 x 8 sub-tile in registers from float4
// reads of the slabs.  blockIdx.z is the batch slice.  Every operand byte
// is read from device memory once per tile that needs it; the slabs are
// small (8.4 KB), so several blocks share an SM.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kGemmBM = 128;  // tile rows (M)
constexpr int kGemmBN = 128;  // tile columns (N)
constexpr int kGemmBK = 8;    // K step
constexpr int kGemmThreads = 256;
constexpr int kGemmPadA = 4;  // keeps the transposed A stores off one bank

inline dim3 gemm_grid(int M, int N, int batch) {
  return dim3((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM, batch);
}

template <bool A_KMAJOR, typename TA, typename TB, typename Epi>
__global__ void __launch_bounds__(kGemmThreads)
batched_gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B, int M,
                    int N, int K, long long lda, long long ldb,
                    long long strideA, long long strideB, Epi epi) {
  __shared__ __align__(16) float As[kGemmBK][kGemmBM + kGemmPadA];
  __shared__ __align__(16) float Bs[kGemmBK][kGemmBN];
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kGemmBM;
  const int col0 = blockIdx.x * kGemmBN;
  const TA* Ab = A + (long long)b * strideA;
  const TB* Bb = B + (long long)b * strideB;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 8 columns each
  const int ty = tid / 16;  // 8 rows each

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
    // A slab: 8 x 128 elements, 4 per thread, neighbouring threads on
    // neighbouring addresses in either storage order.
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kGemmThreads;
      int kk, ii;
      if (A_KMAJOR) {
        kk = idx / kGemmBM;
        ii = idx % kGemmBM;
      } else {
        ii = idx / kGemmBK;
        kk = idx % kGemmBK;
      }
      const int gi = row0 + ii, gk = k0 + kk;
      float val = 0.f;
      if (gi < M && gk < K)
        val = to_float(A_KMAJOR ? Ab[(long long)gk * lda + gi]
                                : Ab[(long long)gi * lda + gk]);
      As[kk][ii] = val;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kGemmThreads;
      const int kk = idx / kGemmBN, jj = idx % kGemmBN;
      const int gj = col0 + jj, gk = k0 + kk;
      Bs[kk][jj] =
          (gj < N && gk < K) ? to_float(Bb[(long long)gk * ldb + gj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      float a[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + ty * 8 + i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = col0 + tx * 8 + j;
      if (gj < N) epi(b, gi, gj, acc[i][j]);
    }
  }
}

// The plain epilogue: C stored row-major f32, (batch, M, N) with row
// length ``ld`` and slice stride ``stride``.
struct StoreF32 {
  float* out;
  long long ld, stride;
  __device__ __forceinline__ void operator()(int b, int i, int j,
                                             float acc) const {
    out[(long long)b * stride + (long long)i * ld + j] = acc;
  }
};

}  // namespace repro
