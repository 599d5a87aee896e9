// Causal / sliding-window GQA flash-attention forward for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// ::flash_attention_fwd (pallas_call at l.143).  Same function: exact
// softmax attention with an f32 online softmax, positions arange(Sq) +
// q_offset for queries and arange(Sk) for keys, kv_head = head / G.
//
// The TPU grid walks the KV axis in order and carries (m, l, acc) across
// grid steps in VMEM scratch.  Hopper blocks run in no order, so one block
// owns (batch, head, query tile) and loops over key tiles itself, holding
// (m, l, acc) in registers.  Two hand-written designs; the C entry point
// picks one by dtype, head dim and alignment and reports which ran:
//
// 1. Tensor cores (bf16, D % 16 == 0, D <= 256, rows on 16 bytes): the
//    FlashAttention-2 layout.  A block of 4 warps owns 64 query rows, 16
//    per warp, and walks 32-key tiles (52 KB of shared memory at D = 128,
//    so three blocks share an SM).  K and V tiles come through cp.async
//    16-byte copies into a double buffer in shared memory (rows padded by
//    16 bytes so ldmatrix hits distinct banks), the next tile in flight
//    while the block computes on this one.  S = Q K^T and O += P V are
//    bf16 mma.sync.m16n8k16 with f32 accumulation, fragments from ldmatrix
//    (V through its transposing form).  The online softmax stays f32 in
//    registers, in base 2 (log2(e) folded into the scale): each query row
//    lives in one quad of lanes, so its max is two shuffles.  P is rounded
//    to bf16 for P V, and l is summed from the unrounded f32 p, as the TPU
//    kernel does (kernel.py:95-97).  O is staged through the warp's own
//    rows of the Q tile so the stores are 16-byte and coalesced.  Query
//    tiles run latest first, so the longest causal rows start early.
// 2. CUDA cores (f32, and bf16 with another head dim): one block of 4
//    warps owns 32 query rows, 8 per warp, and walks 32-key tiles; lane j
//    scores key j against the warp's rows (Q broadcast from shared memory,
//    K row j from a padded shared tile so the 32 lanes hit 32 banks), then
//    the warp reduces max and sum with shuffles and accumulates P.V with
//    lane-owned output columns.  The f32 path runs here because the device
//    policy allows no TF32 (device.py).
//
// Both: tiles that are wholly masked for the block (past the causal
// diagonal, before the window) are never loaded, as kernel.py:67-71 skips
// them; a masked key inside Sk weighs exp(NEG - m) and a key past Sk
// weighs nothing; ragged Sq / Sk are masked at the edge with the normal
// tile sizes (no single-block fallback as at kernel.py:134-135); l is
// clamped at 1e-30.
//
// Bound on the H100.  Causal prefill does 4 * D * H * (visible pairs)
// operations on ~4 * S * H * D * 2 bytes (bf16, with GQA fewer): at
// S = 1024 and above the operations bound it (989 TFLOP/s in bf16 on the
// tensor cores), at a few hundred tokens the bytes do.  chip_smoke.py
// records the time beside the bound and beside scaled_dot_product_attention.
#include "common.cuh"
#include "tensor_core.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// Design 1: bf16 tensor cores
// ---------------------------------------------------------------------------

// The designs, as the C entry point reports them.
enum FlashDesign : int { kCudaCores = 0, kTensorCores = 1 };

constexpr int kTcWarps = 4;
constexpr int kTcBQ = 16 * kTcWarps;  // query rows per block: 16 per warp
constexpr int kTcBK = 32;             // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// DMAX: the shared-memory and register extent of the head dim; EXACT: D is
// DMAX (the loops then need no bound).  Fragment layouts are those of
// mma.m16n8k16: lane = 4 g + t holds rows g and g + 8, columns 2t, 2t + 1
// of each 8-column block of S and O.
template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(kTcWarps * 32)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                    int KVH, int D, int causal, int window, int q_offset,
                    float scale_log2) {
  constexpr int LD = DMAX + 8;  // shared row stride: 16 bytes of padding
  constexpr int NT = kTcWarps * 32;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* k_s = q_s + kTcBQ * LD;      // [2][kTcBK][LD]
  __nv_bfloat16* v_s = k_s + 2 * kTcBK * LD;  // [2][kTcBK][LD]

  const int dk = EXACT ? DMAX : D;
  const int cpr = dk / 8;  // 16-byte chunks per row
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = min(kTcBQ, Sq - q0);
  const long long q_ld = (long long)H * D, kv_ld = (long long)KVH * D;
  const __nv_bfloat16* qb = q + ((long long)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Sk * KVH + kvh) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Sk * KVH + kvh) * D;

  for (int c = threadIdx.x; c < kTcBQ * cpr; c += NT) {
    const int r = c / cpr, col = (c % cpr) * 8;
    const bool ok = r < nq;
    cp_async16(q_s + r * LD + col, ok ? qb + (q0 + r) * q_ld + col : q,
               ok ? 16 : 0);
  }
  auto load_kv = [&](int slot, int k0) {
    __nv_bfloat16* ks = k_s + slot * kTcBK * LD;
    __nv_bfloat16* vs = v_s + slot * kTcBK * LD;
    for (int c = threadIdx.x; c < kTcBK * cpr; c += NT) {
      const int r = c / cpr, col = (c % cpr) * 8;
      const bool ok = k0 + r < Sk;
      const long long off = (k0 + r) * kv_ld + col;
      cp_async16(ks + r * LD + col, ok ? kb + off : k, ok ? 16 : 0);
      cp_async16(vs + r * LD + col, ok ? vb + off : v, ok ? 16 : 0);
    }
  };

  // Key range any row of this block can see; tiles outside it are skipped.
  const int qlo = q0 + q_offset;
  const int qhi = q0 + nq - 1 + q_offset;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, qhi + 1);
  if (window > 0) k_begin = max(0, qlo - window + 1);
  const int t_begin = k_begin / kTcBK;
  const int t_end = k_end > 0 ? (k_end + kTcBK - 1) / kTcBK : 0;
  if (t_begin < t_end) load_kv(0, t_begin * kTcBK);
  cp_async_commit();  // Q and the first K/V tile

  const int g = lane / 4, t4 = lane % 4;
  const int qpos[2] = {q0 + warp * 16 + g + q_offset,
                       q0 + warp * 16 + g + 8 + q_offset};
  float o_acc[DMAX / 8][4];
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[i][e] = 0.f;
  float m_run[2] = {kNeg, kNeg};  // base-2 logits
  float l_run[2] = {0.f, 0.f};    // this lane's share of each row's sum

  // ldmatrix row addresses: Q (A operand), K (B, keys as columns), V (B
  // through the transposing load, keys as the contraction).
  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
  const int a_col = (lane / 16) * 8;
  const int k_row = (lane % 8) + (lane / 16) * 8;
  const int k_col = ((lane / 8) % 2) * 8;
  const int v_row = (lane % 8) + ((lane / 8) % 2) * 8;
  const int v_col = (lane / 16) * 8;

  for (int t = t_begin; t < t_end; ++t) {
    const int slot = (t - t_begin) & 1;
    if (t + 1 < t_end) load_kv(slot ^ 1, (t + 1) * kTcBK);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed for this thread
    __syncthreads();     // ... and for every thread
    const __nv_bfloat16* ks = k_s + slot * kTcBK * LD;
    const __nv_bfloat16* vs = v_s + slot * kTcBK * LD;

    float s[kTcBK / 8][4];
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (!EXACT && kk * 16 >= dk) break;
      unsigned a[4];
      ldmatrix_x4(a, q_s + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int j2 = 0; j2 < kTcBK / 16; ++j2) {
        unsigned bb[4];
        ldmatrix_x4(bb, ks + (j2 * 16 + k_row) * LD + kk * 16 + k_col);
        mma_bf16(s[2 * j2], a, bb[0], bb[1]);
        mma_bf16(s[2 * j2 + 1], a, bb[2], bb[3]);
      }
    }

    const int k0 = t * kTcBK;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
        const int qp = qpos[e >> 1];
        bool allow = kpos < Sk;
        if (causal) allow = allow && kpos <= qp;
        if (window > 0) allow = allow && kpos > qp - window;
        s[j][e] = allow ? s[j][e] * scale_log2 : kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
        // A masked key inside the sequence keeps the TPU kernel's
        // semantics (exp(NEG - m)); a key past Sk weighs nothing.
        const float p = kpos < Sk ? exp2f(s[j][e] - m_run[e >> 1]) : 0.f;
        s[j][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = corr[r] * l_run[r] + ls[r];
#pragma unroll
    for (int i = 0; i < DMAX / 8; ++i) {
      o_acc[i][0] *= corr[0];
      o_acc[i][1] *= corr[0];
      o_acc[i][2] *= corr[1];
      o_acc[i][3] *= corr[1];
    }

    // O += P V: P's f32 accumulators become bf16 A fragments in place.
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DMAX / 16; ++dp) {
        if (!EXACT && dp * 16 >= dk) break;
        unsigned bb[4];
        ldmatrix_x4_trans(bb, vs + (kk * 16 + v_row) * LD + dp * 16 + v_col);
        mma_bf16(o_acc[2 * dp], a, bb[0], bb[1]);
        mma_bf16(o_acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this slot is consumed before it is refilled
  }
  cp_async_wait<0>();  // Q's copy too, where no tile was visible

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  // Stage O in this warp's own 16 rows of the Q tile (only this warp ever
  // read them), then store whole 16-byte chunks of the rows inside Sq.
  __nv_bfloat16* o_s = q_s + warp * 16 * LD;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) {
    if (!EXACT && i * 8 >= dk) break;
    const int col = i * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(o_s + g * LD + col) =
        __floats2bfloat162_rn(o_acc[i][0] * inv[0], o_acc[i][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(o_s + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o_acc[i][2] * inv[1], o_acc[i][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + ((long long)b * Sq * H + h) * D;
  for (int c = lane; c < 16 * cpr; c += 32) {
    const int r = c / cpr, col = (c % cpr) * 8;
    const int qi = warp * 16 + r;
    if (qi < nq)
      *reinterpret_cast<uint4*>(ob + (q0 + qi) * q_ld + col) =
          *reinterpret_cast<const uint4*>(o_s + r * LD + col);
  }
}

template <int DMAX, bool EXACT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int H, int KVH, int D, int causal,
                      int window, int q_offset, float scale,
                      cudaStream_t stream) {
  const size_t smem =
      (size_t)(kTcBQ + 4 * kTcBK) * (DMAX + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<DMAX, EXACT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTcBQ - 1) / kTcBQ, H, B);
  flash_fwd_tc_kernel<DMAX, EXACT><<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Sk, H, KVH, D, causal, window, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int KVH, int D,
                        int causal, int window, int q_offset, float scale,
                        cudaStream_t stream) {
#define REPRO_FLASH_TC(DMAX, EXACT)                                        \
  return launch_tc<DMAX, EXACT>(q, k, v, o, B, Sq, Sk, H, KVH, D, causal, \
                                window, q_offset, scale, stream)
  if (D == 64) REPRO_FLASH_TC(64, true);
  if (D == 128) REPRO_FLASH_TC(128, true);
  if (D <= 32) REPRO_FLASH_TC(32, false);
  if (D <= 64) REPRO_FLASH_TC(64, false);
  if (D <= 128) REPRO_FLASH_TC(128, false);
  REPRO_FLASH_TC(256, false);
#undef REPRO_FLASH_TC
}

// ---------------------------------------------------------------------------
// Design 2: f32 CUDA cores
// ---------------------------------------------------------------------------

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
cudaError_t launch_cc(const void* q, const void* k, const void* v, void* o,
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
cudaError_t dispatch_cc(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KVH, int D, int causal,
                     int window, int q_offset, float scale,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch_cc<T, 64>(q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window,
                         q_offset, scale, stream);
  if (D <= 128)
    return launch_cc<T, 128>(q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window,
                          q_offset, scale, stream);
  return launch_cc<T, 256>(q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window,
                        q_offset, scale, stream);
}

}  // namespace
}  // namespace repro

// q (B, Sq, H, D), k/v (B, Sk, KVH, D), o (B, Sq, H, D), all contiguous and
// of one dtype.  Writes the design that ran to *design (FlashDesign) and
// returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int dtype,
                                         int B, int Sq, int Sk, int H,
                                         int KVH, int D, int causal,
                                         int window, int q_offset,
                                         float scale, void* stream,
                                         int* design) {
  if (D < 8 || D > 256 || D % 8 != 0 || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Every row of D elements starts on 16 bytes (rows are H * D or KVH * D
  // apart, multiples of D).
  const int bytes = dtype == repro::kBFloat16 ? 2 : 4;
  const bool aligned = repro::rows_16b_aligned(q, D, D, bytes) &&
                       repro::rows_16b_aligned(k, D, D, bytes) &&
                       repro::rows_16b_aligned(v, D, D, bytes) &&
                       repro::rows_16b_aligned(o, D, D, bytes);
  if (dtype == repro::kBFloat16 && D % 16 == 0 && aligned) {
    *design = repro::kTensorCores;
    return static_cast<int>(repro::dispatch_tc(
        q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window, q_offset, scale, s));
  }
  *design = repro::kCudaCores;
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::dispatch_cc<float>(
        q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window, q_offset, scale, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(repro::dispatch_cc<__nv_bfloat16>(
        q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window, q_offset, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
