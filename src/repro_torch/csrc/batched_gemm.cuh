// Batched, tiled f32 matrix product shared by the optimizer kernels
// (galore_project.cu, lowrank_apply.cuh, power_iter.cu).
//
//   C[b] (M x N) = A[b] (M x K) @ B[b] (K x N), f32 accumulation,
//
// and every run of four adjacent C elements of a row goes to an epilogue
// functor ``epi(b, i, j, v, cnt)`` (v holds C[b][i][j .. j+3], of which the
// first ``cnt`` lie inside N), so each kernel decides what a finished
// element becomes (a plain f32 store, W' = keep * W - lr_alpha * acc in W's
// dtype, or R with Adam's moments).  A is read either as stored K x M
// ("k-major": element (i, k) at A[k * lda + i], as P in R = P^T G and G in
// Z = G^T Q) or as stored M x K ("m-major": element (i, k) at
// A[i * lda + k], as P in the back-projection P @ N and G in Y = G Z).  B
// is always stored K x N.  Operands are f32 or bf16; products and sums are
// f32 on the CUDA cores (FMA): no tensor cores, no TF32.
//
// Design.  One block of 256 threads owns a 128 x 128 tile of C and walks K
// in steps of 16 through a ring of 4 shared-memory stages filled by
// cp.async: while the block computes on one stage, the copies of the next
// three are in flight.  Each copy moves 16 bytes (4 f32 or 8 bf16; a bf16
// operand stays bf16 in shared memory and is widened when its fragments
// are read), zero-filling past the ragged edges of M, N and K.  An operand
// whose rows do not start on 16 bytes takes element-wise loads instead.
// Each operand keeps its storage order in shared memory: a k-major A and B
// as [k][128], an m-major A as [128][k + pad]; so an m-major fragment is
// read along k (2 at a time) instead of being transposed on the store.
// Each thread accumulates an 8 x 8 sub-tile in registers, split as 2 x 2
// groups of 4 x 4 (rows ty*4 and 64 + ty*4, columns tx*4 and 64 + tx*4):
// a warp's 16 neighbouring threads own 16 neighbouring 4-column groups, so
// the fragment reads from shared memory are conflict-free and every
// epilogue access of a row is one coalesced 16-byte (f32) or 8-byte (bf16)
// access per thread.  blockIdx.z is the batch slice.
//
// Sums still run over the same K, in f32, one element's sum in one
// thread's register; only the order of blocks and stages is new.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kGemmBM = 128;  // tile rows (M)
constexpr int kGemmBN = 128;  // tile columns (N)
constexpr int kGemmBK = 16;   // K step
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 256;

inline dim3 gemm_grid(int M, int N, int batch) {
  return dim3((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM, batch);
}

// Elements of T in one 16-byte copy.
template <typename T>
__host__ __device__ constexpr int chunk_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// Shared-memory row stride of each operand's stage, in elements.  The
// m-major A row is padded by one 16-byte chunk, so the copies stay aligned
// and neighbouring rows fall on other banks.
template <bool A_KMAJOR, typename TA>
__host__ __device__ constexpr int gemm_lda_s() {
  return A_KMAJOR ? kGemmBM : kGemmBK + chunk_elems<TA>();
}

template <bool A_KMAJOR, typename TA>
__host__ __device__ constexpr int gemm_a_stage() {  // elements
  return A_KMAJOR ? kGemmBK * kGemmBM : kGemmBM * gemm_lda_s<A_KMAJOR, TA>();
}

template <bool A_KMAJOR, typename TA, typename TB>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return (size_t)kGemmStages *
         (gemm_a_stage<A_KMAJOR, TA>() * sizeof(TA) +
          (size_t)kGemmBK * kGemmBN * sizeof(TB));
}

// Four (two) consecutive elements from shared memory, widened to f32.
__device__ __forceinline__ void smem4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void smem4(const __nv_bfloat16* p, float* o) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]), hi = __bfloat1622float2(q[1]);
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}
__device__ __forceinline__ void smem2(const float* p, float* o) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void smem2(const __nv_bfloat16* p, float* o) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = v.x; o[1] = v.y;
}

// Four consecutive elements of device memory, read-only path, widened to
// f32 (the first ``cnt`` only, unless ``vec``: 4 aligned ones in one load).
__device__ __forceinline__ void global4(const float* p, bool vec, int cnt,
                                        float* o) {
  if (vec && cnt == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    return;
  }
  for (int e = 0; e < cnt; ++e) o[e] = __ldg(p + e);
}
__device__ __forceinline__ void global4(const __nv_bfloat16* p, bool vec,
                                        int cnt, float* o) {
  if (vec && cnt == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    __nv_bfloat162 lo, hi;
    *reinterpret_cast<unsigned*>(&lo) = u.x;
    *reinterpret_cast<unsigned*>(&hi) = u.y;
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
    return;
  }
  for (int e = 0; e < cnt; ++e) o[e] = __bfloat162float(p[e]);
}

// Four consecutive elements to device memory, rounded to T (the first
// ``cnt`` only, unless ``vec``).
__device__ __forceinline__ void store4(float* p, bool vec, int cnt,
                                       const float* v) {
  if (vec && cnt == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int e = 0; e < cnt; ++e) p[e] = v[e];
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, bool vec, int cnt,
                                       const float* v) {
  if (vec && cnt == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(
        *reinterpret_cast<const unsigned*>(&lo),
        *reinterpret_cast<const unsigned*>(&hi));
    return;
  }
  for (int e = 0; e < cnt; ++e) p[e] = __float2bfloat16(v[e]);
}

// Copy a ROWS x COLS tile of a row-major operand (row stride ``ld``),
// starting at (r0, c0), into shared memory with row stride SLD; elements
// at rows >= rmax or columns >= cmax become 0.  ``vec``: rows start on 16
// bytes, so the tile moves in 16-byte cp.async copies (zero-filled past
// the edges); otherwise element by element through registers.
template <typename T, int ROWS, int COLS, int SLD>
__device__ __forceinline__ void gemm_load_tile(T* s, const T* g, long long ld,
                                               int r0, int c0, int rmax,
                                               int cmax, bool vec) {
  constexpr int E = chunk_elems<T>();
  if (vec) {
    constexpr int CPR = COLS / E;  // chunks per row
    constexpr int PASSES = (ROWS * CPR + kGemmThreads - 1) / kGemmThreads;
#pragma unroll
    for (int it = 0; it < PASSES; ++it) {
      const int c = threadIdx.x + it * kGemmThreads;
      if (c >= ROWS * CPR) break;
      const int row = c / CPR, col = (c % CPR) * E;
      const int gr = r0 + row, gc = c0 + col;
      int n = 0;
      if (gr < rmax && gc < cmax) n = min(E, cmax - gc);
      cp_async16(s + row * SLD + col, n ? g + (long long)gr * ld + gc : g,
                 n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kGemmThreads) {
      const int row = e / COLS, col = e % COLS;
      const int gr = r0 + row, gc = c0 + col;
      s[row * SLD + col] = (gr < rmax && gc < cmax)
                               ? g[(long long)gr * ld + gc]
                               : from_float<T>(0.f);
    }
  }
}

template <bool A_KMAJOR, typename TA, typename TB, typename Epi>
__global__ void __launch_bounds__(kGemmThreads, 2)
batched_gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B, int M,
                    int N, int K, long long lda, long long ldb,
                    long long strideA, long long strideB, int vec_a, int vec_b,
                    Epi epi) {
  constexpr int LDA_S = gemm_lda_s<A_KMAJOR, TA>();
  constexpr int A_STAGE = gemm_a_stage<A_KMAJOR, TA>();
  constexpr int B_STAGE = kGemmBK * kGemmBN;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  TA* As = reinterpret_cast<TA*>(gemm_smem);
  TB* Bs = reinterpret_cast<TB*>(gemm_smem + kGemmStages * A_STAGE * sizeof(TA));

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kGemmBM;
  const int col0 = blockIdx.x * kGemmBN;
  const TA* Ab = A + (long long)b * strideA;
  const TB* Bb = B + (long long)b * strideB;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column groups tx*4 and 64 + tx*4
  const int ty = tid / 16;  // row groups ty*4 and 64 + ty*4

  auto load_stage = [&](int slot, int k0) {
    if constexpr (A_KMAJOR)
      gemm_load_tile<TA, kGemmBK, kGemmBM, LDA_S>(As + slot * A_STAGE, Ab, lda,
                                                  k0, row0, K, M, vec_a);
    else
      gemm_load_tile<TA, kGemmBM, kGemmBK, LDA_S>(As + slot * A_STAGE, Ab, lda,
                                                  row0, k0, M, K, vec_a);
    gemm_load_tile<TB, kGemmBK, kGemmBN, kGemmBN>(Bs + slot * B_STAGE, Bb, ldb,
                                                  k0, col0, K, N, vec_b);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int k_tiles = (K + kGemmBK - 1) / kGemmBK;
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s * kGemmBK);
    cp_async_commit();  // one group per stage, empty or not
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kGemmStages - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread; and stage kt-1 is consumed
    const int next = kt + kGemmStages - 1;
    if (next < k_tiles) load_stage(next % kGemmStages, next * kGemmBK);
    cp_async_commit();

    const TA* as = As + (kt % kGemmStages) * A_STAGE;
    const TB* bs = Bs + (kt % kGemmStages) * B_STAGE;
    if constexpr (A_KMAJOR) {
#pragma unroll
      for (int kk = 0; kk < kGemmBK; ++kk) {
        float a[8], bv[8];
        smem4(as + kk * LDA_S + ty * 4, a);
        smem4(as + kk * LDA_S + 64 + ty * 4, a + 4);
        smem4(bs + kk * kGemmBN + tx * 4, bv);
        smem4(bs + kk * kGemmBN + 64 + tx * 4, bv + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kGemmBK; kk += 2) {
        float a[8][2], bv[2][8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
          smem2(as + r * LDA_S + kk, a[i]);
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          smem4(bs + (kk + s) * kGemmBN + tx * 4, bv[s]);
          smem4(bs + (kk + s) * kGemmBN + 64 + tx * 4, bv[s] + 4);
        }
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(a[i][s], bv[s][j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block (empty groups only)

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (gi >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = col0 + h * 64 + tx * 4;
      const float v[4] = {acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                          acc[i][h * 4 + 3]};
      if (gj < N) epi(b, gi, gj, v, min(4, N - gj));
    }
  }
}

// Launch C = A @ B over ``batch`` slices with epilogue ``epi`` (see the
// header): opts the kernel into its shared memory and picks 16-byte or
// element-wise loads per operand from its alignment.
template <bool A_KMAJOR, typename TA, typename TB, typename Epi>
cudaError_t launch_gemm(const TA* A, const TB* B, int M, int N, int K,
                        long long lda, long long ldb, long long strideA,
                        long long strideB, int batch, const Epi& epi,
                        cudaStream_t stream) {
  constexpr size_t smem = gemm_smem_bytes<A_KMAJOR, TA, TB>();
  auto kernel = batched_gemm_kernel<A_KMAJOR, TA, TB, Epi>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec_a = rows_16b_aligned(A, lda, strideA, sizeof(TA));
  const int vec_b = rows_16b_aligned(B, ldb, strideB, sizeof(TB));
  kernel<<<gemm_grid(M, N, batch), kGemmThreads, smem, stream>>>(
      A, B, M, N, K, lda, ldb, strideA, strideB, vec_a, vec_b, epi);
  return cudaGetLastError();
}

// The plain epilogue: C stored row-major f32, (batch, M, N) with row
// length ``ld`` and slice stride ``stride``; ``vec`` when its rows start on
// 16 bytes (rows_16b_aligned).
struct StoreF32 {
  float* out;
  long long ld, stride;
  bool vec;
  __device__ __forceinline__ void operator()(int b, int i, int j,
                                             const float* v, int cnt) const {
    store4(out + (long long)b * stride + (long long)i * ld + j, vec, cnt, v);
  }
};

}  // namespace repro
