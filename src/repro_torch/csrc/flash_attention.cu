// Causal / sliding-window GQA flash-attention forward for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// ::flash_attention_fwd (pallas_call at l.143).  Same function: exact
// softmax attention with an f32 online softmax, positions arange(Sq) +
// q_offset for queries and arange(Sk) for keys, kv_head = head / G.
//
// Design.  The TPU grid walks the KV axis in order and carries (m, l, acc)
// across grid steps in VMEM scratch.  Hopper blocks run in no order, so one
// block owns (batch, head, 32-query tile) and loops over 32-key tiles
// itself, holding (m, l, acc) in registers.  Each of the 4 warps owns 8
// query rows; within a key tile, lane j scores key j against the warp's
// rows (Q broadcast from shared memory, K row j from a padded shared tile
// so the 32 lanes hit 32 banks), then the warp reduces max and sum with
// shuffles and accumulates P.V with lane-owned output columns.  Tiles that
// are wholly masked for the block (past the causal diagonal, before the
// window) are never loaded, as kernel.py:67-71 skips them.  Ragged Sq / Sk
// are masked at the edge with the normal tile sizes: no single-block
// fallback as at kernel.py:134-135.
//
// Bound on the H100.  Causal prefill does ~2 * S^2 * D * H operations on
// ~4 * S * H * D * 2 bytes (bf16, with GQA fewer): at S = 1024 and above
// the operations bound it, at a few hundred tokens the bytes do.  This
// first version runs on the f32 CUDA cores (no wgmma, no TMA), far from
// either bound; chip_smoke.py records the time beside the bound.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane

template <typename T, int DMAX>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KVH, int D, int causal, int window, int q_offset,
                 float scale) {
  constexpr int NV = DMAX / 32;  // output columns per lane
  constexpr int R = kRowsPerWarp;
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kBQ][DMAX]
  float* k_s = q_s + kBQ * DMAX;        // [kBK][DMAX + 1]
  float* v_s = k_s + kBK * (DMAX + 1);  // [kBK][DMAX]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kBQ, Sq - q0);

  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    q_s[r * DMAX + d] =
        r < nq ? to_float(q[((size_t)(b * Sq + q0 + r) * H + h) * D + d]) : 0.f;
  }

  // Key range any row of this block can see; tiles outside it are skipped.
  const int qlo = q0 + q_offset;
  const int qhi = q0 + nq - 1 + q_offset;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, qhi + 1);
  if (window > 0) k_begin = max(0, qlo - window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  float m_run[R], l_run[R], acc[R][NV];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kNeg;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[r][i] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is fully consumed (and Q is loaded)
    for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
      const int j = idx / D, d = idx % D;
      float kf = 0.f, vf = 0.f;
      if (k0 + j < Sk) {
        const size_t g = ((size_t)(b * Sk + k0 + j) * KVH + kvh) * D + d;
        kf = to_float(k[g]);
        vf = to_float(v[g]);
      }
      k_s[j * (DMAX + 1) + d] = kf;
      v_s[j * DMAX + d] = vf;
    }
    __syncthreads();

    const int kpos = k0 + lane;
    const bool in_range = kpos < Sk;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * (DMAX + 1);
    const float* qrows = q_s + warp * R * DMAX;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += qrows[r * DMAX + d] * kd;
    }

    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + warp * R + r + q_offset;
      bool allow = in_range;
      if (causal) allow = allow && kpos <= qpos;
      if (window > 0) allow = allow && kpos > qpos - window;
      const float sr = allow ? s[r] * scale : kNeg;
      const float m_new = fmaxf(m_run[r], warp_max(sr));
      // A masked key inside the sequence keeps the TPU kernel's semantics
      // (exp(NEG - m)); a key past Sk does not exist and weighs nothing.
      const float pr = in_range ? expf(sr - m_new) : 0.f;
      const float corr = expf(m_run[r] - m_new);
      l_run[r] = corr * l_run[r] + warp_sum(pr);
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[r][i] *= corr;
      p[r] = pr;
    }

    for (int j = 0; j < kBK; ++j) {
      float vj[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < D ? v_s[j * DMAX + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[r][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = warp * R + r;
    if (qi >= nq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    T* orow = o + ((size_t)(b * Sq + q0 + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = from_float<T>(acc[r][i] / l);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KVH, int D, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBQ * DMAX + kBK * (DMAX + 1) + kBK * DMAX) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, DMAX><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KVH, D, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KVH, int D, int causal,
                     int window, int q_offset, float scale,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window,
                         q_offset, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window,
                          q_offset, scale, stream);
  return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window,
                        q_offset, scale, stream);
}

}  // namespace
}  // namespace repro

// q (B, Sq, H, D), k/v (B, Sk, KVH, D), o (B, Sq, H, D), all contiguous and
// of one dtype.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int dtype,
                                         int B, int Sq, int Sk, int H,
                                         int KVH, int D, int causal,
                                         int window, int q_offset,
                                         float scale, void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::dispatch<float>(
        q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window, q_offset, scale, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(repro::dispatch<__nv_bfloat16>(
        q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window, q_offset, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
