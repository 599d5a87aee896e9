// Paged decode attention (q_len = 1) for Hopper: one cluster launch, two designs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_decode/kernel.py
// ::paged_decode_attention_kernel (pallas_call at l.164).  Same function:
// one query per slot attends to the slot's tokens in the shared page pool,
// token t in page page_table[b, t / ps] at offset t % ps, masked to
// t < seq_len (plus t > seq_len - 1 - window), with -1 table entries never
// read (skipped, as ref.py does) and seq_len == 0 giving exact zeros.
//
// Bound on the H100: bytes.  A token's K and V rows (2 * D elements) feed
// 4 * G * D operations, G operations per byte in bf16: far under the ~20 of
// the CUDA cores and the ~295 of the tensor cores.  So the design is about
// bytes in flight, launches and the latency of each step, not arithmetic.
//
// Common to both designs:
//  * One launch of (CS, KVH, B) blocks in clusters of (CS, 1, 1): the CS
//    blocks of a cluster share one (slot, KV head).  Each reads the slot's
//    length itself and takes an even share, in whole tiles, of the visible
//    range [max(0, len - window), min(len, MP * ps)), so the longest slot
//    sets the critical path and nothing is spent on capacity past seq_len.
//    The wrapper picks CS in {1, 2, 4, 8} from the card's cluster occupancy
//    (repro_paged_decode_max_clusters): the largest whose B * KVH clusters
//    all run at once.
//  * A block stages the page-table entries of its share in shared memory
//    (the TPU kernel's scalar prefetch, kernel.py:135-154) and streams K and
//    V rows straight from the pool into shared memory with 16-byte cp.async
//    copies in the pool's own dtype, ahead of the tile it scores.  A page of
//    one KV head is ps rows strided by KVH * D, so the copies go row by row,
//    neighbouring threads on neighbouring 16-byte pieces of a row.  Staged
//    rows are padded by 16 bytes, so reads down a column of rows meet no
//    bank twice.  Masked probabilities are zeroed (kernel.py:90).
//  * Each block leaves its partial (m, l, acc) in its own shared memory.
//    After cluster.sync() each rank merges a 1/CS share of the outputs,
//    reading every rank's partials through distributed shared memory, and
//    writes out = acc / max(l, 1e-30) (an empty slot gives exact zeros); a
//    second cluster.sync() keeps every block alive until all reads are done.
//    No combine kernel and no scratch in device memory.
//
// Design 1, CUDA cores (f32; bf16 where design 2 does not apply): 256
// threads, 32-token tiles in a block-wide ring of up to 4 stages; scores
// with lane = token (two warps per head, each half of D), an f32 online
// softmax per head, P.V with a thread per 8 columns of a head.
// Design 2, tensor cores (bf16, D % 16 == 0, G <= 16): the G heads are the
// 16 rows of mma.m16n8k16.  Each of 4 warps walks its own 16-token tiles
// with its own double-buffered ring and online softmax, so the loop has no
// block barrier, and S = Q K^T and O += P V take two mma each per 8 columns.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace repro {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQWarps = 4;     // warps per half of D in the scores
constexpr int kTile = 32;      // token rows per tile: one per lane
constexpr int kTbl = 1024;     // page-table entries staged at a time
constexpr int kMaxG = 32;      // query heads per KV head
constexpr int kMaxCluster = 8; // portable cluster size
constexpr int kRingBudget = 104 * 1024;

// The designs, as the wrapper picks them.
enum Design : int { kCudaCores = 0, kTensorCores = 1 };

// The ring's depth: as many 32-row K+V stages (up to 4) as fit the budget.
template <typename T, int DMAX>
__host__ __device__ constexpr int stages() {
  constexpr int pair = 2 * kTile * (DMAX * (int)sizeof(T) + 16);
  return kRingBudget / pair < 2 ? 2 : (kRingBudget / pair > 4 ? 4 : kRingBudget / pair);
}

// The P.V mapping: thread i owns column chunk i % nc (8 columns) and row
// i / nc of ``rows``; with G >= rows a row is heads r, r + rows, ..., else
// head r % G and token slice r / G of ts.
struct PvMap {
  int nc, rows, ts;
};

__host__ __device__ inline PvMap pv_map(int G, int D) {
  PvMap m;
  m.nc = D / 8;
  m.rows = kThreads / m.nc;
  m.ts = G >= m.rows ? 1 : m.rows / G;
  return m;
}

template <typename T>
struct Params {
  const T* q;
  const T* pk;
  const T* pv;
  const int* table;
  const int* lens;
  T* out;
  int H, KVH, D, ps, MP, window;
  float scale;
  // t / ps == (t * ps_magic) >> ps_shift for 0 <= t < 2^31: no division
  // and no branch in the loops
  unsigned long long ps_magic;
  int ps_shift;
  int aligned;  // both pools start on 16 bytes: cp.async, else element copies
};

struct Layout {
  size_t ring, q, s, p, corr, ml, tbl, total;
};

template <typename T, int DMAX>
__host__ __device__ inline Layout layout(int G, int D) {
  const PvMap pm = pv_map(G, D);
  const size_t ring = (size_t)stages<T, DMAX>() * 2 * kTile * (D * sizeof(T) + 16);
  const size_t part = (size_t)pm.ts * G * D * sizeof(float);  // reuses the ring
  Layout l;
  l.ring = 0;
  l.q = ring > part ? ring : part;
  l.s = l.q + (size_t)G * D * sizeof(float);
  l.p = l.s + (size_t)2 * G * kTile * sizeof(float);
  l.corr = l.p + (size_t)G * kTile * sizeof(float);
  l.ml = l.corr + kMaxG * sizeof(float);
  l.tbl = l.ml + 2 * kMaxG * sizeof(float);
  l.total = l.tbl + kTbl * sizeof(int);
  return l;
}

// Eight consecutive elements from shared memory as f32 (16 or 32 bytes).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// The cluster's merge: rank c merges outputs [c * per, (c + 1) * per) of the
// G * D / 4 float4s from every rank's block partial (``part`` [G][D] and
// ``ml_s``: m at [g], l at [kMaxG + g], natural-log units), reading the
// other ranks' shared memory:
// out = sum_r e^(m_r - M) acc_r / max(sum_r e^(m_r - M) l_r, 1e-30).
template <typename T>
__device__ __forceinline__ void cluster_merge(cg::cluster_group& cluster, float* part,
                                              float* ml_s, int G, int D, T* out,
                                              int nthreads) {
  cluster.sync();  // every rank's partials are complete and visible
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int n4 = G * D / 4, per = (n4 + cs - 1) / cs;
  const int end4 = min(n4, (rank + 1) * per);
  for (int i4 = rank * per + (int)threadIdx.x; i4 < end4; i4 += nthreads) {
    const int g = i4 * 4 / D;
    float mr[kMaxCluster], lr[kMaxCluster];
    float4 ar[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < cs) {
        const float* ml_r = cluster.map_shared_rank(ml_s, r);
        const float* part_r = cluster.map_shared_rank(part, r);
        mr[r] = ml_r[g];
        lr[r] = ml_r[kMaxG + g];
        ar[r] = *reinterpret_cast<const float4*>(part_r + 4 * i4);
      }
    }
    float mx = kNeg;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs) mx = fmaxf(mx, mr[r]);
    float den = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f, n3 = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < cs) {
        const float w = expf(mr[r] - mx);
        den += w * lr[r];
        n0 += w * ar[r].x, n1 += w * ar[r].y, n2 += w * ar[r].z, n3 += w * ar[r].w;
      }
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    T* o = out + 4 * i4;
    o[0] = from_float<T>(n0 * inv);
    o[1] = from_float<T>(n1 * inv);
    o[2] = from_float<T>(n2 * inv);
    o[3] = from_float<T>(n3 * inv);
  }
  cluster.sync();  // no block exits while another may still read its partials
}

// This block's share [r0, r1) of slot b's visible range
// [max(0, len - window), min(len, MP * ps)): an even split over the cluster
// in whole tiles of ``tile`` tokens.
__device__ __forceinline__ int2 block_share(int len, long long cap, int window, int rank,
                                            int cs, int tile) {
  const int vis0 = window > 0 ? max(0, len - window) : 0;
  const int vis1 = (int)min((long long)len, cap);
  const int n_all = vis1 > vis0 ? (vis1 - vis0 + tile - 1) / tile : 0;
  const int r0 = vis0 + (rank * n_all / cs) * tile;
  const int r1 = min(vis1, vis0 + ((rank + 1) * n_all / cs) * tile);
  return make_int2(r0, r1);
}

// ---------------------------------------------------------------------------
// Design 1: CUDA cores
// ---------------------------------------------------------------------------

// GM: the instance's most query heads per KV head (4, 8 or 32), so that the
// per-head loops below unroll to what G needs and no further.
template <typename T, int DMAX, int GM>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_cluster_kernel(const Params<T> a) {
  constexpr int NS = stages<T, DMAX>();
  constexpr int HPW = GM / kQWarps;                                    // heads per warp, scores
  constexpr int HPT = (GM * (DMAX / 8) + kThreads - 1) / kThreads;   // per thread, P.V
  constexpr int EPC = 16 / sizeof(T);                                  // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int D = a.D, KVH = a.KVH, ps = a.ps;
  const auto page_of = [&](int t) { return (int)(((unsigned long long)t * a.ps_magic) >> a.ps_shift); };
  const int G = a.H / KVH;
  const Layout lay = layout<T, DMAX>(G, D);
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);  // [half][G][kTile]
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* corr_s = reinterpret_cast<float*>(smem + lay.corr);
  float* ml_s = reinterpret_cast<float*>(smem + lay.ml);
  int* tbl_s = reinterpret_cast<int*>(smem + lay.tbl);

  const int rank = blockIdx.x, cs = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wq = warp % kQWarps, half = warp / kQWarps;  // scores: heads wq + 4 h, half of D
  const int rs = D + EPC;                 // staged row stride, elements
  const int stage_elems = 2 * kTile * rs; // K rows, then V rows
  const int cpr = D / EPC;                // 16-byte pieces per row (<= 64)
  const int cp_rows = kThreads / cpr;     // rows copied per pass
  const int cp_piece = tid % cpr;
  const int cp_row = tid / cpr < cp_rows ? tid / cpr : kTile;  // else idle
  const int* row = a.table + (size_t)b * a.MP;
  const size_t page_stride = (size_t)ps * KVH * D, row_stride = (size_t)KVH * D;
  const T* pk_h = a.pk + (size_t)kvh * D + cp_piece * EPC;  // this head's piece of row 0
  const T* pv_h = a.pv + (size_t)kvh * D + cp_piece * EPC;

  const int2 share = block_share(a.lens[b], (long long)a.MP * ps, a.window, rank, cs, kTile);
  const int r0 = share.x, r1 = share.y;
  // tokens per table staging: whole tiles whose pages fit kTbl entries
  const int sc_tok = (int)min((long long)(kTbl - 2) * ps / kTile * kTile, 1LL << 30);

  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_float(a.q[((size_t)b * a.H + (size_t)kvh * G) * D + i]);

  // P.V ownership (see pv_map)
  const PvMap pm = pv_map(G, D);
  const int pv_c = tid % pm.nc, pv_r = tid / pm.nc;
  const int pv_g0 = G >= pm.rows ? pv_r : pv_r % G;
  const int pv_s = G >= pm.rows ? 0 : pv_r / G;
  const bool pv_on = pv_r < pm.rows && pv_s < pm.ts;

  float m[HPW], l[HPW], acc[HPT][8];
#pragma unroll
  for (int h = 0; h < HPW; ++h) m[h] = kNeg, l[h] = 0.f;
#pragma unroll
  for (int h = 0; h < HPT; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;

  for (int sc0 = r0; sc0 < r1; sc0 += sc_tok) {
    const int sc1 = min(r1, sc0 + sc_tok);
    const int pg0 = sc0 / ps;
    const int n_pg = (sc1 - 1) / ps - pg0 + 1;
    __syncthreads();  // the previous staging is no longer read (and q is in)
    for (int i = tid; i < n_pg; i += kThreads) tbl_s[i] = row[pg0 + i];
    __syncthreads();
    const int n_tiles = (sc1 - sc0 + kTile - 1) / kTile;

    // Tile j of this staging into ring stage j % NS: thread (piece, row)
    // copies 16 bytes of a K row and of its V row; -1 pages and rows past
    // sc1 are zero-filled without a read.
    auto load_tile = [&](int j) {
      T* st = ring + (j % NS) * stage_elems + cp_piece * EPC;
      const int t0 = sc0 + j * kTile;
      if (a.aligned) {
#pragma unroll 4
        for (int rr = cp_row; rr < kTile; rr += cp_rows) {
          const int t = t0 + rr, pidx = page_of(t);
          const int page = t < sc1 ? tbl_s[pidx - pg0] : -1;
          const size_t off =
              page >= 0 ? page * page_stride + (size_t)(t - pidx * ps) * row_stride : 0;
          cp_async16(st + rr * rs, pk_h + off, page >= 0 ? 16 : 0);
          cp_async16(st + (kTile + rr) * rs, pv_h + off, page >= 0 ? 16 : 0);
        }
      } else {
        for (int rr = cp_row; rr < kTile; rr += cp_rows) {
          const int t = t0 + rr, pidx = page_of(t);
          const int page = t < sc1 ? tbl_s[pidx - pg0] : -1;
          const size_t off =
              page >= 0 ? page * page_stride + (size_t)(t - pidx * ps) * row_stride : 0;
#pragma unroll
          for (int e = 0; e < EPC; ++e) {
            st[rr * rs + e] = page >= 0 ? pk_h[off + e] : from_float<T>(0.f);
            st[(kTile + rr) * rs + e] = page >= 0 ? pv_h[off + e] : from_float<T>(0.f);
          }
        }
      }
    };

#pragma unroll
    for (int j = 0; j < NS - 1; ++j) {
      if (j < n_tiles) load_tile(j);
      cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // tile i landed for all; tile i - 1 fully consumed
      if (i + NS - 1 < n_tiles) load_tile(i + NS - 1);
      cp_async_commit();

      const T* ks = ring + (i % NS) * stage_elems;
      const T* vs = ks + kTile * rs;
      const int t0 = sc0 + i * kTile;
      const int n_tok = min(kTile, sc1 - t0);

      // Scores: lane = token; warp (wq, half) sums heads wq + 4 h over its half
      // of D's 8-element chunks.  A head past G scores head G - 1 and is
      // dropped, so the loop has no branch and its loads run ahead.
      if (wq < G) {
        const int n_ch = D / 8, mid = (n_ch + 1) / 2;
        const int j0 = half ? mid * 8 : 0, j1 = half ? D : mid * 8;
        float sc[HPW];
        const float* qh[HPW];
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          sc[h] = 0.f;
          qh[h] = q_s + min(wq + h * kQWarps, G - 1) * D;
        }
        const T* krow = ks + lane * rs;
#pragma unroll 4
        for (int j = j0; j < j1; j += 8) {
          float kf[8];
          load8(krow + j, kf);
#pragma unroll
          for (int h = 0; h < HPW; ++h) {
            const float4 qa = *reinterpret_cast<const float4*>(qh[h] + j);
            const float4 qb = *reinterpret_cast<const float4*>(qh[h] + j + 4);
            sc[h] += ((qa.x * kf[0] + qa.y * kf[1]) + (qa.z * kf[2] + qa.w * kf[3])) +
                     ((qb.x * kf[4] + qb.y * kf[5]) + (qb.z * kf[6] + qb.w * kf[7]));
          }
        }
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          const int g = wq + h * kQWarps;
          if (g < G) s_s[(half * G + g) * kTile + lane] = sc[h];
        }
      }
      __syncthreads();

      // The online softmax, per head, by the first half's warps.
      if (half == 0 && wq < G) {
        const int t = t0 + lane;
        const bool allow = lane < n_tok && tbl_s[page_of(t) - pg0] >= 0;
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          const int g = wq + h * kQWarps;
          if (g < G) {
            const float dot = s_s[g * kTile + lane] + s_s[(G + g) * kTile + lane];
            const float s = allow ? dot * a.scale : kNeg;
            const float m_new = fmaxf(m[h], warp_max(s));
            const float p = allow ? expf(s - m_new) : 0.f;
            const float corr = expf(m[h] - m_new);
            l[h] = corr * l[h] + warp_sum(p);
            m[h] = m_new;
            p_s[g * kTile + lane] = p;
            if (lane == 0) corr_s[g] = corr;
          }
        }
      }
      __syncthreads();

      // acc = corr * acc + P.V over this tile's tokens (a head past G
      // repeats head G - 1 and is never written out)
      if (pv_on) {
        const float* ph[HPT];
#pragma unroll
        for (int h = 0; h < HPT; ++h) {
          const int g = min(pv_g0 + h * pm.rows, G - 1);
          ph[h] = p_s + g * kTile;
          const float c = corr_s[g];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[h][e] *= c;
        }
        const T* vcol = vs + pv_c * 8;
#pragma unroll 4
        for (int tt = pv_s; tt < n_tok; tt += pm.ts) {
          float vf[8];
          load8(vcol + tt * rs, vf);
#pragma unroll
          for (int h = 0; h < HPT; ++h) {
            const float p = ph[h][tt];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[h][e] += p * vf[e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy landed and every tile consumed: the ring is free

  // This block's partials: acc per token slice into the ring, (m, l) per head.
  float* part = reinterpret_cast<float*>(smem + lay.ring);  // [ts][G][D]
  if (pv_on) {
#pragma unroll
    for (int h = 0; h < HPT; ++h) {
      const int g = pv_g0 + h * pm.rows;
      if (g < G) {
        float4* dst = reinterpret_cast<float4*>(part + ((size_t)pv_s * G + g) * D + pv_c * 8);
        dst[0] = make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
        dst[1] = make_float4(acc[h][4], acc[h][5], acc[h][6], acc[h][7]);
      }
    }
  }
  if (lane == 0 && half == 0) {
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      const int g = wq + h * kQWarps;
      if (g < G) ml_s[g] = m[h], ml_s[kMaxG + g] = l[h];
    }
  }
  if (pm.ts > 1) {
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      float s = part[i];
      for (int k = 1; k < pm.ts; ++k) s += part[(size_t)k * G * D + i];
      part[i] = s;
    }
  }
  cluster_merge(cluster, part, ml_s, G, D, a.out + ((size_t)b * a.H + (size_t)kvh * G) * D,
                kThreads);
}

// ---------------------------------------------------------------------------
// Design 2: tensor cores (bf16, D % 16 == 0, G <= 16)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcTile = 16;  // tokens per warp step: one mma n-pair, one PV k-step
constexpr float kLog2e = 1.4426950408889634f;

// Stages of each warp's own ring: double buffering.  Two blocks then fit
// an SM up to D = 128 (deeper rings kept one, which cost more than the
// extra tile in flight bought).
constexpr int kTcStages = 2;

struct TcLayout {
  size_t ring, q, mask, mw, lw, ml, tbl, total;
};

template <int DMAX>
__host__ __device__ inline TcLayout tc_layout(int D) {
  const int ld = D + 8;
  TcLayout l;
  const size_t ring = (size_t)kTcWarps * kTcStages * 2 * kTcTile * ld * 2;
  const size_t part = (size_t)kTcWarps * 16 * D * sizeof(float);  // reuses the ring
  l.ring = 0;
  l.q = ring > part ? ring : part;
  l.mask = l.q + (size_t)16 * ld * 2;
  l.mw = l.mask + (size_t)kTcWarps * kTcStages * sizeof(unsigned);
  l.lw = l.mw + (size_t)kTcWarps * 16 * sizeof(float);
  l.ml = l.lw + (size_t)kTcWarps * 16 * sizeof(float);
  l.tbl = l.ml + 2 * kMaxG * sizeof(float);
  l.total = l.tbl + kTbl * sizeof(int);
  return l;
}

// The G heads of one KV head are the 16 rows of mma.m16n8k16 (rows past G
// are zero queries, computed and dropped).  Each warp walks its own 16-token
// tiles of the block's share (tiles warp, warp + 4, ...) through its own
// ring of cp.async stages, with its own online softmax, so the loop has no
// block barrier; S = Q K^T and O += P V run on the tensor cores as in
// flash_attention.cu (P's f32 accumulators become bf16 A fragments, l sums
// the f32 p).  The four warps' partials merge in shared memory, then the
// cluster's through distributed shared memory.
// EXACT: D is DMAX, so every loop and stride below is a constant.
template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(kTcThreads, 1)
paged_decode_tc_kernel(const Params<__nv_bfloat16> a) {
  using bf16 = __nv_bfloat16;
  constexpr int NS = kTcStages;
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int D = EXACT ? DMAX : a.D, KVH = a.KVH, ps = a.ps;
  const int G = a.H / KVH;
  const int LD = D + 8;  // staged row stride: 16 bytes of padding
  const TcLayout lay = tc_layout<DMAX>(D);
  bf16* ring = reinterpret_cast<bf16*>(smem + lay.ring);
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  unsigned* mask_s = reinterpret_cast<unsigned*>(smem + lay.mask);
  float* mw_s = reinterpret_cast<float*>(smem + lay.mw);
  float* lw_s = reinterpret_cast<float*>(smem + lay.lw);
  float* ml_s = reinterpret_cast<float*>(smem + lay.ml);
  int* tbl_s = reinterpret_cast<int*>(smem + lay.tbl);

  const int rank = blockIdx.x, cs = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int stage_elems = 2 * kTcTile * LD;  // K rows, then V rows
  const int cpr = D / 8;                     // 16-byte pieces per row
  const int cpr_magic = (65536 + cpr - 1) / cpr;  // idx / cpr == idx * magic >> 16, idx < 512
  const int* row = a.table + (size_t)b * a.MP;
  const size_t row_stride = (size_t)KVH * D;
  const bf16* pk_h = a.pk + (size_t)kvh * D;
  const bf16* pv_h = a.pv + (size_t)kvh * D;
  const auto page_of = [&](int t) {
    return (int)(((unsigned long long)t * a.ps_magic) >> a.ps_shift);
  };
  const int2 share = block_share(a.lens[b], (long long)a.MP * ps, a.window, rank, cs, kTcTile);
  const int r0 = share.x, r1 = share.y;
  // tokens per table staging: whole tiles whose pages fit kTbl entries, or
  // the whole share where the slot's table row fits
  const int sc_tok = a.MP <= kTbl ? (1 << 30)
                                  : (int)min((long long)(kTbl - 2) * ps / kTcTile * kTcTile,
                                             1LL << 30);

  // Q as 16 rows (heads), rows past G zero-filled; and, where the slot's
  // whole table row fits the staging, the row, without waiting for the
  // slot's length.  Both land before the first __syncthreads below.
  for (int i = tid; i < 16 * cpr; i += kTcThreads) {
    const int r = i / cpr, c = (i % cpr) * 8;
    const bf16* src = a.q + ((size_t)b * a.H + kvh * G + min(r, G - 1)) * D + c;
    cp_async16(q_s + r * LD + c, src, r < G ? 16 : 0);
  }
  cp_async_commit();
  const bool whole_row = a.MP <= kTbl;
  if (whole_row)
    for (int i = tid; i < a.MP; i += kTcThreads) tbl_s[i] = row[i];

  const int fg = lane / 4, t4 = lane % 4;  // fragment rows fg, fg + 8; columns 2 t4, 2 t4 + 1
  const int a_row = (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const int k_row = (lane % 8) + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;
  const int v_row = (lane % 8) + ((lane / 8) % 2) * 8, v_col = (lane / 16) * 8;
  const float scale_log2 = a.scale * kLog2e;
  float o_acc[DMAX / 8][4];
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[i][e] = 0.f;
  float m_run[2] = {kNeg, kNeg};  // base-2 logits
  float l_run[2] = {0.f, 0.f};    // this lane's share of each row's sum
  unsigned qf[DMAX / 16][4];      // Q's A fragments

  cp_async_wait<0>();
  for (int sc0 = r0; sc0 < r1; sc0 += sc_tok) {
    const int sc1 = min(r1, sc0 + sc_tok);
    const int pg0 = whole_row ? 0 : sc0 / ps;
    if (!whole_row) {
      const int n_pg = (sc1 - 1) / ps - pg0 + 1;
      __syncthreads();  // every warp is done with the previous staging
      for (int i = tid; i < n_pg; i += kTcThreads) tbl_s[i] = row[pg0 + i];
    }
    __syncthreads();  // the staging (and Q) are in for every warp
    if (sc0 == r0) {  // Q's A fragments, once
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk)
        if (kk * 16 < D) ldmatrix_x4(qf[kk], q_s + a_row * LD + kk * 16 + a_col);
    }
    const int n_tiles = (sc1 - sc0 + kTcTile - 1) / kTcTile;
    const int my_n = n_tiles > warp ? (n_tiles - warp + kTcWarps - 1) / kTcWarps : 0;

    // This warp's i-th tile into its stage i % NS.  Lane r < 16 finds row
    // r's pool row (page * ps + offset, or -1 for a -1 page or a row past
    // sc1); then each copy instruction covers whole rows, neighbouring lanes
    // on neighbouring 16-byte pieces.  The ballot of the rows that exist
    // masks the scores.  (Copying each row whole with the bulk copy engine
    // and an mbarrier per stage measured slower.)
    auto load_tile = [&](int i) {
      const int slot = warp * NS + i % NS;
      bf16* st = ring + slot * stage_elems;
      const int t = sc0 + (warp + i * kTcWarps) * kTcTile + lane;
      int prow = -1;
      if (lane < kTcTile && t < sc1) {
        const int pidx = page_of(t);
        const int page = tbl_s[pidx - pg0];
        if (page >= 0) prow = page * ps + (t - pidx * ps);
      }
      const unsigned ok = __ballot_sync(0xffffffffu, prow >= 0);
#pragma unroll
      for (int k = 0; k < DMAX / 16; ++k) {
        const int idx = lane + 32 * k;  // piece idx % cpr of row idx / cpr
        if (idx >= kTcTile * cpr) break;
        const int r = (idx * cpr_magic) >> 16, piece = idx - r * cpr;
        const int pr = __shfl_sync(0xffffffffu, prow, r);
        const size_t off = (size_t)max(pr, 0) * row_stride + piece * 8;
        bf16* dst = st + r * LD + piece * 8;
        cp_async16(dst, pk_h + off, pr >= 0 ? 16 : 0);
        cp_async16(dst + kTcTile * LD, pv_h + off, pr >= 0 ? 16 : 0);
      }
      if (lane == 0) mask_s[slot] = ok;  // bit r: token r of the tile
    };

#pragma unroll
    for (int k = 0; k < NS - 1; ++k) {
      if (k < my_n) load_tile(k);
      cp_async_commit();
    }
    for (int i = 0; i < my_n; ++i) {
      const int slot = warp * NS + i % NS;
      cp_async_wait<NS - 2>();
      __syncwarp();  // tile i landed for every lane; tile i - 1 is consumed
      const unsigned ok = mask_s[slot];
      if (i + NS - 1 < my_n) load_tile(i + NS - 1);
      cp_async_commit();
      const bf16* ks = ring + slot * stage_elems;
      const bf16* vs = ks + kTcTile * LD;

      // S = Q K^T; even and odd k-steps in two accumulator sets, so the
      // products do not wait on each other
      float s[2][4], s2[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f, s2[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk * 16 >= D) break;
        unsigned bb[4];
        ldmatrix_x4(bb, ks + k_row * LD + kk * 16 + k_col);
        mma_bf16(kk % 2 ? s2[0] : s[0], qf[kk], bb[0], bb[1]);
        mma_bf16(kk % 2 ? s2[1] : s[1], qf[kk], bb[2], bb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];

      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = j * 8 + 2 * t4 + (e & 1);
          const bool allow = (ok >> tok) & 1u;
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
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = j * 8 + 2 * t4 + (e & 1);
          const float p = (ok >> tok) & 1u ? exp2f(s[j][e] - m_run[e >> 1]) : 0.f;
          s[j][e] = p;
          ls[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = corr[r] * l_run[r] + ls[r];
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int i2 = 0; i2 < DMAX / 8; ++i2) {
          o_acc[i2][0] *= corr[0];
          o_acc[i2][1] *= corr[0];
          o_acc[i2][2] *= corr[1];
          o_acc[i2][3] *= corr[1];
        }
      }
      // O += P V: P's f32 accumulators become the bf16 A fragment in place.
      const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < DMAX / 16; ++dp) {
        if (dp * 16 >= D) break;
        unsigned bb[4];
        ldmatrix_x4_trans(bb, vs + v_row * LD + dp * 16 + v_col);
        mma_bf16(o_acc[2 * dp], pa, bb[0], bb[1]);
        mma_bf16(o_acc[2 * dp + 1], pa, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy landed and every tile consumed: the ring is free

  // Each warp's partial: acc rows (heads) into the ring, (m, l) per row in
  // natural-log units; then the block's merge over its warps, in place into
  // warp 0's rows, which the cluster's merge reads.
  float* wp = reinterpret_cast<float*>(smem + lay.ring);  // [warp][16][D]
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) {
    if (i * 8 >= D) break;
    const int col = i * 8 + 2 * t4;
    if (fg < G)
      *reinterpret_cast<float2*>(wp + ((size_t)warp * 16 + fg) * D + col) =
          make_float2(o_acc[i][0], o_acc[i][1]);
    if (fg + 8 < G)
      *reinterpret_cast<float2*>(wp + ((size_t)warp * 16 + fg + 8) * D + col) =
          make_float2(o_acc[i][2], o_acc[i][3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t4 == 0) {
      mw_s[warp * 16 + fg + 8 * r] = m_run[r] / kLog2e;
      lw_s[warp * 16 + fg + 8 * r] = l;
    }
  }
  __syncthreads();
  for (int i4 = tid; i4 < G * D / 4; i4 += kTcThreads) {
    const int g = i4 * 4 / D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) mx = fmaxf(mx, mw_s[w * 16 + g]);
    float den = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) {
      const float c = expf(mw_s[w * 16 + g] - mx);
      const float4 v = *reinterpret_cast<const float4*>(wp + (size_t)w * 16 * D + 4 * i4);
      den += c * lw_s[w * 16 + g];
      acc.x += c * v.x, acc.y += c * v.y, acc.z += c * v.z, acc.w += c * v.w;
    }
    *reinterpret_cast<float4*>(wp + 4 * i4) = acc;
    if (i4 * 4 % D == 0) ml_s[g] = mx, ml_s[kMaxG + g] = den;
  }
  cluster_merge(cluster, wp, ml_s, G, D, a.out + ((size_t)b * a.H + (size_t)kvh * G) * D,
                kTcThreads);
}

// One launch of (cs, KVH, B) blocks in clusters of (cs, 1, 1); or, with
// ``max_active``, how many such clusters the card runs at once.
template <typename T>
cudaError_t launch_clusters(void (*kernel)(Params<T>), const Params<T>& a, int B, int cs,
                            int threads, size_t smem, cudaStream_t stream, int* max_active) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, a.KVH, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_active) return cudaOccupancyMaxActiveClusters(max_active, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_cuda_cores(const Params<T>& a, int B, int cs, cudaStream_t stream,
                              int* max_active) {
  const int G = a.H / a.KVH;
  const size_t smem = layout<T, DMAX>(G, a.D).total;
  if (G <= 4)
    return launch_clusters<T>(paged_decode_cluster_kernel<T, DMAX, 4>, a, B, cs, kThreads,
                              smem, stream, max_active);
  if (G <= 8)
    return launch_clusters<T>(paged_decode_cluster_kernel<T, DMAX, 8>, a, B, cs, kThreads,
                              smem, stream, max_active);
  return launch_clusters<T>(paged_decode_cluster_kernel<T, DMAX, kMaxG>, a, B, cs, kThreads,
                            smem, stream, max_active);
}

template <int DMAX>
cudaError_t launch_tensor_cores(const Params<__nv_bfloat16>& a, int B, int cs,
                                cudaStream_t stream, int* max_active) {
  const size_t smem = tc_layout<DMAX>(a.D).total;
  if (a.D == DMAX)
    return launch_clusters<__nv_bfloat16>(paged_decode_tc_kernel<DMAX, true>, a, B, cs,
                                          kTcThreads, smem, stream, max_active);
  return launch_clusters<__nv_bfloat16>(paged_decode_tc_kernel<DMAX, false>, a, B, cs,
                                        kTcThreads, smem, stream, max_active);
}

template <typename T>
cudaError_t dispatch(const Params<T>& a, int B, int cs, int design, cudaStream_t stream,
                     int* max_active) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (design == kTensorCores) {
      if (a.D <= 64) return launch_tensor_cores<64>(a, B, cs, stream, max_active);
      if (a.D <= 128) return launch_tensor_cores<128>(a, B, cs, stream, max_active);
      return launch_tensor_cores<256>(a, B, cs, stream, max_active);
    }
  }
  if (a.D <= 64) return launch_cuda_cores<T, 64>(a, B, cs, stream, max_active);
  if (a.D <= 128) return launch_cuda_cores<T, 128>(a, B, cs, stream, max_active);
  return launch_cuda_cores<T, 256>(a, B, cs, stream, max_active);
}

template <typename T>
cudaError_t run(const void* q, const void* pk, const void* pv, const int* table,
                const int* lens, void* out, int B, int H, int KVH, int D, int ps,
                int MP, int window, float scale, int cs, int design, cudaStream_t stream,
                int* max_active = nullptr) {
  Params<T> a;
  a.q = static_cast<const T*>(q);
  a.pk = static_cast<const T*>(pk);
  a.pv = static_cast<const T*>(pv);
  a.table = table;
  a.lens = lens;
  a.out = static_cast<T*>(out);
  a.H = H, a.KVH = KVH, a.D = D, a.ps = ps, a.MP = MP, a.window = window;
  a.scale = scale;
  a.aligned = reinterpret_cast<unsigned long long>(pk) % 16 == 0 &&
              reinterpret_cast<unsigned long long>(pv) % 16 == 0;
  int l = 0;  // ceil(log2(ps)): the magic number has 33 bits at most
  while ((1LL << l) < ps) ++l;
  a.ps_shift = 32 + l;
  a.ps_magic = ((1ULL << (32 + l)) + ps - 1) / ps;
  return dispatch<T>(a, B, cs, design, stream, max_active);
}

}  // namespace
}  // namespace repro

// q (B, 1, H, D); pages_k/v (P, ps, KVH, D); page_table (B, MP) int32;
// seq_lens (B,) int32; out (B, 1, H, D).  All contiguous on one device.
// ``cluster`` blocks (1, 2, 4 or 8) share each (slot, KV head).  ``design``
// 1 takes the tensor cores, which need bf16, D % 16 == 0, G <= 16, q and
// both pools on 16 bytes and P * ps < 2^31 (the wrapper checks the last);
// 0 the CUDA cores (any supported shape).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int repro_paged_decode_attention(
    const void* q, const void* pages_k, const void* pages_v,
    const void* page_table, const void* seq_lens, void* out, int dtype, int B,
    int H, int KVH, int D, int ps, int MP, int window, int cluster, int design,
    float scale, void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || ps < 1 || KVH < 1 || H % KVH != 0 ||
      H / KVH > repro::kMaxG || B < 1 || MP < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<unsigned long long>(q) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(pages_k) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(pages_v) % 16 == 0;
  if (design == repro::kTensorCores &&
      (dtype != repro::kBFloat16 || D % 16 != 0 || H / KVH > 16 || !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  if (design != repro::kTensorCores && design != repro::kCudaCores)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::run<float>(q, pages_k, pages_v, table, lens, out, B, H,
                                              KVH, D, ps, MP, window, scale, cluster,
                                              design, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(repro::run<__nv_bfloat16>(q, pages_k, pages_v, table, lens,
                                                      out, B, H, KVH, D, ps, MP, window,
                                                      scale, cluster, design, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of ``cluster`` blocks of the kernel that the same
// arguments would launch the card runs at once (into *out).  Returns the
// cudaError_t of the query.
extern "C" int repro_paged_decode_max_clusters(int dtype, int H, int KVH, int D, int cluster,
                                               int design, int* out) {
  if (D < 8 || D > 256 || D % 8 != 0 || KVH < 1 || H % KVH != 0 || H / KVH > repro::kMaxG ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (design == repro::kTensorCores &&
       (dtype != repro::kBFloat16 || D % 16 != 0 || H / KVH > 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return static_cast<int>(repro::run<float>(nullptr, nullptr, nullptr, nullptr, nullptr,
                                              nullptr, 1, H, KVH, D, 1, 1, 0, 1.f, cluster,
                                              design, nullptr, out));
  return static_cast<int>(repro::run<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr,
                                                    nullptr, 1, H, KVH, D, 1, 1, 0, 1.f,
                                                    cluster, design, nullptr, out));
}
