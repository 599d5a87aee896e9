// Fused low-rank 8-bit Adam update with back-projection for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_update/kernel.py
// ::lowrank_adam8bit_update_batched (pallas_call at l.616, with _dq_slab
// l.438 and _q_slab l.462).  Per slice b:
//
//   M, V = dequantize(codes, scales)
//   M' = b1 M + (1-b1) R,   V' = b2 V + (1-b2) R*R
//   N  = (M'/bc1) / (sqrt(V'/bc2) + eps)
//   codes', scales' = quantize(M', V')
//   W' = (1 - lr_wd) W - lr_alpha * P @ N
//
// Quantization (kernels/lowrank_update/quantize.py): 256-element chunks of
// each PER-LEAF row, the last one possibly short, one f32 absmax scale per
// chunk (1.0 for an all-zero chunk).  M is signed, code = rint(x / s * 127)
// clipped to +-127, plus 127, decoded (c - 127) / 127 * s; V is unsigned,
// code = rint(sqrt(clip(x / s, 0, 1)) * 255), decoded (c/255)^2 * s.
// rintf rounds half to even, as jnp.round and torch.round do.
//
// Codes are element-aligned with the canonical (B, r, n) stack.  The chunks
// follow the per-leaf rows, which the canonical orientation transposes on
// side 'right':
//
//   side 'left'  chunks run along n of a canonical row; scales (B, r, nb),
//                nb = ceil(n / 256).  One warp per chunk, 8 elements a
//                lane, a warp-shuffle absmax.
//   side 'right' chunks run along r of a canonical column; scales
//                (B, n, nb_r), nb_r = ceil(r / 256).  A block of 32 x 8
//                threads owns 32 columns of one chunk: each row of the
//                tile is read coalesced along n, each thread keeps 32 rows
//                of its column in registers, and the absmax reduces along r
//                through shared memory.
//
// Every shape launches: a short final chunk (n % 256 != 0 on 'left',
// r % 256 != 0 on 'right') is masked.  JAX sends those shapes to its jnp
// version instead (ops.py::adam8bit_kernel_supported).
//
// A block of a row cut over processes (tensor parallelism or FSDP on the
// free dim of a 'left' bucket, quantize.py): ``qoff`` is its first
// column's place in its global chunk, so local chunk c covers local columns
// [256 c - qoff, 256 (c + 1) - qoff) and a row holds ceil((qoff + n) / 256)
// scales.  A chunk that straddles a block edge needs the whole chunk's
// absmax: a first launch with ``am_out``/``av_out`` writes each chunk
// piece's absmax of the new moments and nothing else, the caller takes the
// largest over the processes, and the main launch quantizes with the given
// absmax (``given_m``/``given_v``) instead of its own.  The pass is
// recomputed bit for bit, so the moments it quantizes are the first
// launch's.
//
// Design.  Two launches, as lowrank_adam.cu (Hopper blocks run in no
// order): the chunk pass above, which writes codes and scales once and N
// into an f32 scratch, then the back-projection of lowrank_apply.cuh.  The
// pass rounds every product, quotient and sum on its own (__fmul_rn,
// __fdiv_rn, __fadd_rn, __fsqrt_rn: no FMA contraction), so the moments,
// and with them the codes, are the plain version's bit for bit.
//
// Bound on the H100.  2 * B * d * r * n operations for the product on the
// f32 CUDA cores; the state is 2 bytes per element of (B, r, n) plus
// scales: operations bound it (7.18 ms for the mlp-left bucket, B 8,
// 4096 x 14336, r 512, at 67 TFLOP/s).
#include <cstdint>

#include "lowrank_apply.cuh"

namespace repro {
namespace {

constexpr int kQBlock = 256;

struct AdamParams {
  float b1, c1, b2, c2, eps, bc1, bc2;
};

__device__ __forceinline__ float dq_signed(uint8_t c, float s) {
  return __fmul_rn(__fdiv_rn(static_cast<float>(c) - 127.f, 127.f), s);
}

__device__ __forceinline__ float dq_unsigned(uint8_t c, float s) {
  const float rel = __fdiv_rn(static_cast<float>(c), 255.f);
  return __fmul_rn(__fmul_rn(rel, rel), s);
}

__device__ __forceinline__ uint8_t q_signed(float x, float s) {
  const float q = rintf(__fmul_rn(__fdiv_rn(x, s), 127.f));
  return static_cast<uint8_t>(fminf(fmaxf(q, -127.f), 127.f) + 127.f);
}

__device__ __forceinline__ uint8_t q_unsigned(float x, float s) {
  const float rel = __fsqrt_rn(fminf(fmaxf(__fdiv_rn(x, s), 0.f), 1.f));
  return static_cast<uint8_t>(fminf(fmaxf(rintf(__fmul_rn(rel, 255.f)), 0.f), 255.f));
}

// One element: dequantized moments in, updated moments out, N returned.
__device__ __forceinline__ float adam_element(float g, float& m, float& v,
                                              const AdamParams& a) {
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.c1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.c2, g), g));
  return __fdiv_rn(__fdiv_rn(m, a.bc1),
                   __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.bc2)), a.eps));
}

__device__ __forceinline__ float chunk_scale(float absmax) {
  return absmax > 0.f ? absmax : 1.f;
}

// side 'left': warp w of the grid takes chunks w, w + warps, ...; chunk
// index = row * nb + c over rows = B * r canonical rows, which is also the
// chunk's index in the (B, r, nb) scales.
__global__ void adam8bit_left_kernel(
    const float* __restrict__ r, const uint8_t* __restrict__ mc,
    const float* __restrict__ ms, const uint8_t* __restrict__ vc,
    const float* __restrict__ vs, uint8_t* __restrict__ mc_out,
    float* __restrict__ ms_out, uint8_t* __restrict__ vc_out,
    float* __restrict__ vs_out, float* __restrict__ n_out, long long rows,
    int n, int nb, int qoff, const float* __restrict__ given_m,
    const float* __restrict__ given_v, float* __restrict__ am_out,
    float* __restrict__ av_out, AdamParams a) {
  constexpr int kPerLane = kQBlock / 32;
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long chunks = rows * nb;
  const bool absmax_only = am_out != nullptr;
  for (long long chunk = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       chunk < chunks; chunk += warps) {
    const long long row = chunk / nb;
    const int c = static_cast<int>(chunk % nb);
    // local column of the chunk's first element (negative for a block that
    // starts inside its first chunk)
    const int col0 = c * kQBlock - qoff;
    const long long base = row * n + col0;
    const float sm = ms[chunk], sv = vs[chunk];
    float mv[kPerLane], vv[kPerLane];
    float am = 0.f, av = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int k = lane + 32 * t;
      mv[t] = vv[t] = 0.f;
      if (col0 + k >= 0 && col0 + k < n) {
        const long long o = base + k;
        mv[t] = dq_signed(mc[o], sm);
        vv[t] = dq_unsigned(vc[o], sv);
        const float nd = adam_element(r[o], mv[t], vv[t], a);
        if (!absmax_only) n_out[o] = nd;
        am = fmaxf(am, fabsf(mv[t]));
        av = fmaxf(av, fabsf(vv[t]));
      }
    }
    const float wm = warp_max(am), wv = warp_max(av);
    if (absmax_only) {
      if (lane == 0) {
        am_out[chunk] = wm;
        av_out[chunk] = wv;
      }
      continue;
    }
    const float sm2 = chunk_scale(given_m != nullptr ? given_m[chunk] : wm);
    const float sv2 = chunk_scale(given_v != nullptr ? given_v[chunk] : wv);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int k = lane + 32 * t;
      if (col0 + k >= 0 && col0 + k < n) {
        mc_out[base + k] = q_signed(mv[t], sm2);
        vc_out[base + k] = q_unsigned(vv[t], sv2);
      }
    }
    if (lane == 0) {
      ms_out[chunk] = sm2;
      vs_out[chunk] = sv2;
    }
  }
}

constexpr int kRightCols = 32;  // columns of a block's tile (threadIdx.x)
constexpr int kRightRows = 8;   // threadIdx.y; each thread strides the chunk by 8
constexpr int kPerThread = kQBlock / kRightRows;

// side 'right': block (x, y, z) = (32-column tile, chunk along r, slice).
__global__ void __launch_bounds__(kRightCols * kRightRows)
adam8bit_right_kernel(
    const float* __restrict__ r, const uint8_t* __restrict__ mc,
    const float* __restrict__ ms, const uint8_t* __restrict__ vc,
    const float* __restrict__ vs, uint8_t* __restrict__ mc_out,
    float* __restrict__ ms_out, uint8_t* __restrict__ vc_out,
    float* __restrict__ vs_out, float* __restrict__ n_out, int rank, int n,
    int nb, AdamParams a) {
  __shared__ float red_m[kRightRows][kRightCols];
  __shared__ float red_v[kRightRows][kRightCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kRightCols + tx;
  const int c = blockIdx.y;
  const long long b = blockIdx.z;
  const int i0 = c * kQBlock;
  const int len = min(kQBlock, rank - i0);
  const bool col_ok = j < n;
  const long long sidx = (b * n + j) * nb + c;  // scale of (b, column j, chunk c)
  const long long slice = b * rank * n;
  const float sm = col_ok ? ms[sidx] : 0.f;
  const float sv = col_ok ? vs[sidx] : 0.f;
  float mv[kPerThread], vv[kPerThread];
  float am = 0.f, av = 0.f;
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    const int k = ty + kRightRows * t;
    mv[t] = vv[t] = 0.f;
    if (col_ok && k < len) {
      const long long o = slice + (long long)(i0 + k) * n + j;
      mv[t] = dq_signed(mc[o], sm);
      vv[t] = dq_unsigned(vc[o], sv);
      n_out[o] = adam_element(r[o], mv[t], vv[t], a);
      am = fmaxf(am, fabsf(mv[t]));
      av = fmaxf(av, fabsf(vv[t]));
    }
  }
  red_m[ty][tx] = am;
  red_v[ty][tx] = av;
  __syncthreads();
  float cm = 0.f, cv = 0.f;
#pragma unroll
  for (int y = 0; y < kRightRows; ++y) {
    cm = fmaxf(cm, red_m[y][tx]);
    cv = fmaxf(cv, red_v[y][tx]);
  }
  const float sm2 = chunk_scale(cm), sv2 = chunk_scale(cv);
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    const int k = ty + kRightRows * t;
    if (col_ok && k < len) {
      const long long o = slice + (long long)(i0 + k) * n + j;
      mc_out[o] = q_signed(mv[t], sm2);
      vc_out[o] = q_unsigned(vv[t], sv2);
    }
  }
  if (col_ok && ty == 0) {
    ms_out[sidx] = sm2;
    vs_out[sidx] = sv2;
  }
}

}  // namespace
}  // namespace repro

// w, w_out (B, d, n) f32/bf16; p (B, d, r) f32; r_g and the scratch n_scr
// (B, r, n) f32; m_codes, v_codes and their outputs (B, r, n) uint8;
// m_scale, v_scale and their outputs (B, r, ceil((qoff + n)/256)) f32 for
// side 0 ('left'), (B, n, ceil(r/256)) for side 1 ('right'); contiguous,
// one device.  c1 = 1 - b1, c2 = 1 - b2, bc1 = 1 - b1^t, bc2 = 1 - b2^t,
// keep = 1 - lr_wd.  qoff, given_m/given_v and am_out/av_out (shaped like
// the scales; null when unused) are side 0's cut rows (header); am_out set
// runs the absmax launch alone.  The split schedule (lowrank_apply.cuh): w
// null runs the chunk pass alone.  Returns the cudaError_t of the launches.
extern "C" int repro_lowrank_adam8bit_update_batched(
    const void* w, const void* p, const void* r_g, const void* m_codes,
    const void* m_scale, const void* v_codes, const void* v_scale,
    void* w_out, void* m_codes_out, void* m_scale_out, void* v_codes_out,
    void* v_scale_out, void* n_scr, const void* given_m, const void* given_v,
    void* am_out, void* av_out, int dtype, int B, int d, int n, int rank,
    int side, int qoff, float b1, float c1, float b2, float c2, float eps,
    float bc1, float bc2, float lr_alpha, float keep, void* stream) {
  const bool cut = qoff != 0 || given_m != nullptr || given_v != nullptr ||
                   am_out != nullptr || av_out != nullptr;
  if (repro::bad_update_shape(dtype, B, d, n, rank) || (side != 0 && side != 1) ||
      (side == 1 && cut) || qoff < 0 || qoff >= repro::kQBlock ||
      ((am_out == nullptr) != (av_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::AdamParams a{b1, c1, b2, c2, eps, bc1, bc2};
  const float* rr = static_cast<const float*>(r_g);
  const uint8_t* mc = static_cast<const uint8_t*>(m_codes);
  const uint8_t* vc = static_cast<const uint8_t*>(v_codes);
  const float* ms = static_cast<const float*>(m_scale);
  const float* vs = static_cast<const float*>(v_scale);
  uint8_t* mco = static_cast<uint8_t*>(m_codes_out);
  uint8_t* vco = static_cast<uint8_t*>(v_codes_out);
  float* mso = static_cast<float*>(m_scale_out);
  float* vso = static_cast<float*>(v_scale_out);
  float* ns = static_cast<float*>(n_scr);
  if (side == 0) {
    const int nb = (qoff + n + repro::kQBlock - 1) / repro::kQBlock;
    const long long rows = (long long)B * rank;
    const int threads = 256;  // 8 warps, one chunk each at a time
    repro::adam8bit_left_kernel<<<repro::elementwise_blocks(rows * nb * 32, threads),
                                  threads, 0, s>>>(
        rr, mc, ms, vc, vs, mco, mso, vco, vso, ns, rows, n, nb, qoff,
        static_cast<const float*>(given_m), static_cast<const float*>(given_v),
        static_cast<float*>(am_out), static_cast<float*>(av_out), a);
  } else {
    const int nb = (rank + repro::kQBlock - 1) / repro::kQBlock;
    const dim3 grid((n + repro::kRightCols - 1) / repro::kRightCols, nb, B);
    const dim3 block(repro::kRightCols, repro::kRightRows);
    repro::adam8bit_right_kernel<<<grid, block, 0, s>>>(
        rr, mc, ms, vc, vs, mco, mso, vco, vso, ns, rank, n, nb, a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || w == nullptr || am_out != nullptr)
    return static_cast<int>(err);
  return static_cast<int>(repro::launch_backproject(
      dtype, w, static_cast<const float*>(p), ns, w_out, B, d, n, rank,
      lr_alpha, keep, s));
}
