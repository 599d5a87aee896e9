// Paged decode attention (q_len = 1) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_decode/kernel.py
// ::paged_decode_attention_kernel (pallas_call at l.164).  Same function:
// one query per slot attends to the slot's tokens in the shared page pool,
// token t in page page_table[b, t / ps] at offset t % ps, masked to
// t < seq_len (plus t > seq_len - 1 - window), with -1 table entries never
// read and seq_len == 0 giving zeros.
//
// Design.  The TPU kernel walks a slot's pages in order on one core.  Here
// a slot's tokens are split into chunks of kChunk positions, and one block
// per (KV head, slot, chunk) runs an online softmax over its chunk with one
// warp per query head of the GQA group, so each K/V row is read from device
// memory once for the G heads that share it.  A second, small kernel merges
// the chunks' (max, sum, P.V) partials per (slot, head).  A block reads
// page_table[b, t / ps] itself, once per token row (the TPU kernel's scalar
// prefetch, kernel.py:135-154), and stages 32 K/V rows in shared memory;
// the gathered (B, MP*ps, KVH, D) copy that ref.py builds never exists.  Any
// page size >= 1 works, since tiles follow tokens and not pages.  Chunks
// past seq_len (or before the window) exit at once.  Masked probabilities
// are zeroed (kernel.py:90), so an empty slot yields 0 / 1e-30 = 0, not NaN.
//
// Bound on the H100.  Decode reads every live K/V byte once for ~4 * G
// operations per 2-byte element: far below the bytes-to-operations line,
// so the bound is bytes.  chip_smoke.py records the time beside it.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kTile = 32;   // tokens per step: one per lane
constexpr int kChunk = 64;  // tokens per block

template <typename T, int DMAX>
__global__ void __launch_bounds__(1024)  // up to 32 heads per KV head
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                          const T* __restrict__ pv,
                          const int* __restrict__ table,
                          const int* __restrict__ lens,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int H, int KVH, int D,
                          int ps, int MP, int window, float scale) {
  constexpr int NV = DMAX / 32;
  extern __shared__ float smem[];
  const int G = H / KVH;
  float* q_s = smem;                      // [G][DMAX]
  float* k_s = q_s + G * DMAX;            // [kTile][DMAX + 1]
  float* v_s = k_s + kTile * (DMAX + 1);  // [kTile][DMAX]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int chunk = blockIdx.z;
  const int n_split = gridDim.z;
  const int warp = threadIdx.x / 32;  // query head within the group
  const int lane = threadIdx.x % 32;
  const int h = kvh * G + warp;
  const int seq_len = lens[b];
  const int* row = table + (size_t)b * MP;

  // Tokens [c0, c1) of this chunk that the query may see.
  const int t_first = window > 0 ? max(0, seq_len - window) : 0;
  const int c0 = max(t_first, chunk * kChunk);
  const int c1 = min(seq_len, (chunk + 1) * kChunk);

  float m = kNeg, l = 0.f, acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  if (c0 < c1) {
    for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
      const int g = idx / D, d = idx % D;
      q_s[g * DMAX + d] = to_float(q[((size_t)b * H + kvh * G + g) * D + d]);
    }
  }
  for (int t0 = c0; t0 < c1; t0 += kTile) {
    __syncthreads();  // the previous tile is fully consumed (and q is loaded)
    for (int j = warp; j < kTile; j += G) {  // one warp per token row
      const int t = t0 + j;
      const int page = (t < c1 && t / ps < MP) ? row[t / ps] : -1;
      const size_t base = (((size_t)max(page, 0) * ps + t % ps) * KVH + kvh) * D;
      for (int d = lane; d < D; d += 32) {
        k_s[j * (DMAX + 1) + d] = page >= 0 ? to_float(pk[base + d]) : 0.f;
        v_s[j * DMAX + d] = page >= 0 ? to_float(pv[base + d]) : 0.f;
      }
    }
    __syncthreads();

    const int t = t0 + lane;
    const bool allow = t < c1 && t / ps < MP && row[t / ps] >= 0;
    const float* krow = k_s + lane * (DMAX + 1);
    const float* qrow = q_s + warp * DMAX;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s += qrow[d] * krow[d];
    s = allow ? s * scale : kNeg;
    const float m_new = fmaxf(m, warp_max(s));
    const float p = allow ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = corr * l + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] *= corr;
    for (int j = 0; j < kTile; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += pj * v_s[j * DMAX + d];
      }
    }
  }

  const size_t part = ((size_t)b * H + h) * n_split + chunk;
  if (lane == 0) {
    part_ml[2 * part] = m;
    part_ml[2 * part + 1] = l;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = lane + 32 * i;
    if (d < D) part_acc[part * D + d] = acc[i];
  }
}

// One block per (slot, head), one thread per output column: merge the
// chunks' partials, out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i.
template <typename T>
__global__ void paged_decode_combine_kernel(const float* __restrict__ part_acc,
                                            const float* __restrict__ part_ml,
                                            T* __restrict__ out, int D,
                                            int n_split) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + 2 * bh * n_split;
  float mx = kNeg;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ml[2 * s] - mx);
    den += w * ml[2 * s + 1];
    num += w * part_acc[(bh * n_split + s) * D + d];
  }
  out[bh * D + d] = from_float<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* table, const int* lens, void* out,
                   float* part_acc, float* part_ml, int B, int H, int KVH,
                   int D, int ps, int MP, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / KVH;
  const int n_split = (MP * ps + kChunk - 1) / kChunk;
  const size_t smem =
      (size_t)(G * DMAX + kTile * (DMAX + 1) + kTile * DMAX) * sizeof(float);
  cudaError_t err = allow_smem(paged_decode_split_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KVH, B, n_split);
  paged_decode_split_kernel<T, DMAX><<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), table, lens, part_acc, part_ml, H, KVH, D,
      ps, MP, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T><<<B * H, D, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), D, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* pk, const void* pv,
                     const int* table, const int* lens, void* out,
                     float* part_acc, float* part_ml, int B, int H, int KVH,
                     int D, int ps, int MP, int window, float scale,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, pk, pv, table, lens, out, part_acc, part_ml, B, H,
                         KVH, D, ps, MP, window, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, pk, pv, table, lens, out, part_acc, part_ml, B,
                          H, KVH, D, ps, MP, window, scale, stream);
  return launch<T, 256>(q, pk, pv, table, lens, out, part_acc, part_ml, B, H,
                        KVH, D, ps, MP, window, scale, stream);
}

}  // namespace
}  // namespace repro

// Tokens per split block: the wrapper sizes the f32 scratch
// (B, H, n_split, D) and (B, H, n_split, 2) with n_split =
// ceil(MP * ps / repro_paged_decode_chunk()).
extern "C" int repro_paged_decode_chunk() { return repro::kChunk; }

// q (B, 1, H, D); pages_k/v (P, ps, KVH, D); page_table (B, MP) int32;
// seq_lens (B,) int32; out (B, 1, H, D); scratch as above.  All contiguous
// on one device.  Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_paged_decode_attention(
    const void* q, const void* pages_k, const void* pages_v,
    const void* page_table, const void* seq_lens, void* out, void* part_acc,
    void* part_ml, int dtype, int B, int H, int KVH, int D, int ps, int MP,
    int window, float scale, void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || ps < 1 || KVH < 1 || H % KVH != 0 ||
      H / KVH > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::dispatch<float>(
        q, pages_k, pages_v, table, lens, out, acc, ml, B, H, KVH, D, ps, MP,
        window, scale, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(repro::dispatch<__nv_bfloat16>(
        q, pages_k, pages_v, table, lens, out, acc, ml, B, H, KVH, D, ps, MP,
        window, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
