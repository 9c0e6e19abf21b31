// K2: lockstep affine-gap profile-vs-profile Gotoh for a batch of MSA
// merges, forward pass.
//
// Replaces the Pallas kernel delly_tpu/ops/gotoh_pallas.py::_build
// (body :64-160), with the boundary rules of :73-88,110-121.
//
// Contract (what K2-tb and the comparisons with gotoh_forward_plain
// read): best[g] = S[mlen][nlen], and the direction bits of DP rows
// 1..mlen and columns 1..nlen, row r at tile row r - 1 and column c at
// tile column c - 1; bits 1/2/4/8 = S==H, S==V, H opened, V opened.
// Rows above mlen and columns past nlen are unspecified: no cell inside
// reads them (H flows rightwards, V down its own column, the diagonal
// from the upper left).
//
// Layout. A block of NW warps runs one merge. A lane holds CPT
// consecutive columns and keeps their S and V rows, target profile and
// vertical gap costs in registers; the merge's query profile is staged
// in shared memory. One layout per K bucket, the fastest of a measured
// sweep that does not spill (PERF.md): K = 128 and 256 one warp of 4 and
// 8 columns per lane (no barrier, no exchange), K = 512 four warps of 4,
// K = 1,024 and 2,048 four and eight warps of 8, K = 4,096 eight warps
// of 16.
//
// Per DP row r:
// - V = max(S + vo, V + ve) and t = max(S[r-1][c-1] + score, V), with
//   Hopper's DPX __viaddmax_s32;
// - the horizontal chain as a max-plus recurrence R[0] = S[r][0],
//   R[c] = max(R[c-1] + E, t[c]), H[c] = R[c-1] + O: each lane folds its
//   columns, a 5-step shuffle scan over the lanes (slope CPT * E) gives
//   each lane its incoming R; then S = max(t, H);
// - the bits: S==H, S==V, H opened (t[c-1] > R[c-2] + E), V opened, one
//   byte per cell, CPT bytes per lane in one vector store;
// - meanwhile, the next row's profile scores trunc(num / max(d1 * d2,
//   1)), num = sum_a c1[a] * wc2[a][c]: independent work beside the
//   scan's shuffles. The division is an f32 estimate and one integer
//   correction (profile_score).
// With NW > 1 warps, one barrier per row: each warp publishes its fold
// (its first column still without its diagonal, which the warp to its
// left computed a row earlier) and its first score; after the barrier
// every warp completes the warps' folds with the published last S of
// the row above and scans them. The H-opened bit of a warp's first
// column comes from the warp to its left after the next row's barrier,
// and that one byte is stored then.
//
// Bound on the H100: operations (chip_smoke.py counts 42 integer
// operations per cell in the recurrence, against one byte written per
// cell, and the integer SASS instructions per cell and per lane and row
// of the warp layout's row loop). A row's own work (the shuffle scan,
// the profile row, the vector store) is shared by a lane's CPT columns;
// the scan's latency is what the many merges of a batch, one warp or
// block each, hide.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "gotoh_common.cuh"

namespace {

constexpr int kNinf = -1000000;        // -INF of ops/gotoh.py
constexpr int kScanId = INT_MIN / 2;   // identity of the max-plus scan
constexpr unsigned kFull = 0xFFFFFFFFu;

// N ints from p (16-byte aligned)
template <int N>
__device__ __forceinline__ void load_ints(const int32_t* p, int* v) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p) + i);
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

// N / 4 words to dst (aligned to N bytes)
template <int N>
__device__ __forceinline__ void store_words(uint8_t* dst, const uint32_t* w) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
}

// a block's exchange between the NW warps of one merge, by row parity
template <int NW>
struct Xchg {
  int fold[2][NW];   // each warp's fold, its first column without diagonal
  int sc[2][NW];     // the score of each warp's first column
  int last[2][NW];   // S of each warp's last column
  int hop[2][NW];    // H opened at the first column of the next warp
};

template <int CPT, int NW>
struct Lane {
  static constexpr int WC = 32 * CPT;  // columns per warp
  int w5[5][CPT], dd[CPT], vo[CPT], ve[CPT], S[CPT], V[CPT], sc[CPT];
  int lane, wid, go, ge, vfree;
  uint32_t pend;                       // NW > 1: the byte owed a row late

  // sc = the profile scores of the lane's columns against one query row
  // p (counts of A,C,G,T,N and the depth)
  __device__ __forceinline__ void scores(const int2* p) {
    const int2 q0 = p[0], q1 = p[1], q2 = p[2];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int num = q0.x * w5[0][k] + q0.y * w5[1][k] + q1.x * w5[2][k] +
                      q1.y * w5[3][k] + q2.x * w5[4][k];
      sc[k] = profile_score(num, max(q2.y * dd[k], 1));
    }
  }

  // DP row r with horizontal gap costs O (open) and E (extend), its
  // scores in sc; pnext: the next row's profile; brow: this row's bits
  // at the lane's first column
  __device__ __forceinline__ void row(int r, int O, int E, const int2* pnext,
                                      Xchg<NW>& x, uint8_t* brow) {
    const int s_r0 = vfree ? 0 : go + r * ge;                    // S[r][0]
    const int s_r0_prev = (vfree || r == 1) ? 0 : go + (r - 1) * ge;
    // S[r-1][c0-1]; a later warp's first lane gets it after the barrier
    int up = __shfl_up_sync(kFull, S[CPT - 1], 1);
    if (lane == 0) up = wid == 0 ? s_r0_prev : kScanId;
    int t[CPT];
    uint32_t w[CPT / 4];               // the bits, a byte per column
    int fold = lane == 0 && wid == 0 ? s_r0 : kScanId;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int vv = V[k] + ve[k];
      const int vn = __viaddmax_s32(S[k], vo[k], vv);   // V
      const uint32_t vb = vn != vv ? 8u << (8 * (k % 4)) : 0u;  // V opened
      w[k / 4] = k % 4 == 0 ? vb : w[k / 4] | vb;
      t[k] = __viaddmax_s32(k > 0 ? S[k - 1] : up, sc[k], vn);
      V[k] = vn;
      fold = __viaddmax_s32(fold, E, t[k]);
    }
    const int sc0 = sc[0];
    // inclusive max-plus scan of the lanes' folds, slope CPT * E per lane
    const int CE = CPT * E;
    int incl = fold;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = __viaddmax_s32(v, o * CE, incl);
    }
    int R = __shfl_up_sync(kFull, incl, 1);    // R[c0 - 1]
    if (lane == 0) R = wid == 0 ? s_r0 : kScanId;
    // the next row's scores: independent work beside the scan's latency
    scores(pnext);
    if constexpr (NW > 1) {
      const int par = r & 1;
      if (lane == 31) x.fold[par][wid] = incl;
      if (lane == 0) x.sc[par][wid] = sc0;
      __syncthreads();
      if (lane == 0 && wid > 0 && r > 1)   // the byte of the row above
        brow[-WC * NW] = (uint8_t)(pend | (x.hop[par ^ 1][wid - 1] << 2));
      // lane j < NW: warp j's fold completed with the diagonal of its
      // first column, then scanned over the warps (slope WC * E)
      int T = kScanId, Ld = kScanId;
      if (lane < NW) {
        T = x.fold[par][lane];
        if (lane > 0) {
          Ld = x.last[par ^ 1][lane - 1] + x.sc[par][lane];
          T = max(T, Ld + (WC - 1) * E);
        }
      }
#pragma unroll
      for (int o = 1; o < NW; o <<= 1) {
        const int v = __shfl_up_sync(kFull, T, o);
        if (lane >= o) T = __viaddmax_s32(v, o * WC * E, T);
      }
      const int P = __shfl_sync(kFull, T, (wid + 31) & 31);  // R[cw]
      const int ld = __shfl_sync(kFull, Ld, wid);
      if (wid > 0) {
        if (lane == 0) t[0] = max(t[0], ld);
        R = lane == 0 ? P
                      : max(R, max(P + lane * CE, ld + (lane * CPT - 1) * E));
      }
    }
    bool hopen = false;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int h = R + O;
      const int re = R + E;
      R = max(re, t[k]);
      const int s = max(h, t[k]);
      w[k / 4] |= ((s == h ? 1u : 0u) | (s == V[k] ? 2u : 0u) |
                   (hopen ? 4u : 0u)) << (8 * (k % 4));
      hopen = t[k] > re;               // H opened at the next column
      S[k] = s;
    }
    // H opened at the lane's first column: the lane to the left's last
    // flag; always at column 1; a row late for a later warp's first lane
    int hx = __shfl_up_sync(kFull, hopen ? 1 : 0, 1);
    if (lane == 0) hx = wid == 0 ? 1 : 0;
    w[0] |= (uint32_t)hx << 2;
    store_words<CPT>(brow, w);
    if constexpr (NW > 1) {
      if (lane == 31) {
        x.last[r & 1][wid] = S[CPT - 1];
        x.hop[r & 1][wid] = hopen ? 1 : 0;
      }
      pend = w[0] & 0xFF;
    }
  }
};

template <int CPT, int NW>
__global__ void __launch_bounds__(32 * NW)
gotoh_kernel(const int32_t* __restrict__ prof,
             const int32_t* __restrict__ wc2, const int32_t* __restrict__ d2,
             const int32_t* __restrict__ mlen,
             const int32_t* __restrict__ nlen, int hfree, int vfree, int go,
             int ge, int32_t* __restrict__ best,
             uint8_t* __restrict__ bits) {
  static_assert(CPT % 4 == 0, "columns per lane: a multiple of 4");
  constexpr int K = 32 * CPT * NW;
  __shared__ Xchg<NW> xs;
  extern __shared__ int2 sprof[];      // [3 * mlen]: the query profile
  // a block per merge: g, m and n are uniform over the block, so the
  // shuffles in the row loop need no reconvergence
  const int g = blockIdx.x;
  Lane<CPT, NW> L;
  L.lane = threadIdx.x & 31;
  L.wid = threadIdx.x >> 5;
  L.go = go;
  L.ge = ge;
  L.vfree = vfree;
  L.pend = 0;
  const int m = mlen[g];
  const int n = nlen[g];
  const int c0 = (int)threadIdx.x * CPT + 1;   // the lane's first column
  const int32_t* wg = wc2 + (size_t)g * 5 * K + (c0 - 1);
#pragma unroll
  for (int a = 0; a < 5; ++a) load_ints<CPT>(wg + a * K, L.w5[a]);
  load_ints<CPT>(d2 + (size_t)g * K + (c0 - 1), L.dd);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = c0 + k;
    const bool vf = vfree && c == n;   // vertical gaps free at col nlen
    L.vo[k] = vf ? 0 : go + ge;
    L.ve[k] = vf ? 0 : ge;
    L.S[k] = hfree ? 0 : go + c * ge;  // DP row 0
    L.V[k] = kNinf;
  }
  // the merge's query profile, rows 1..mlen, into shared memory
  const int2* pg = reinterpret_cast<const int2*>(prof + (size_t)g * K * 6);
  for (int i = threadIdx.x; i < 3 * m; i += 32 * NW) sprof[i] = __ldg(pg + i);
  if constexpr (NW > 1) {
    if (L.lane == 31) xs.last[0][L.wid] = L.S[CPT - 1];
    __syncthreads();
  } else {
    __syncwarp();
  }
  L.scores(sprof);                      // DP row 1's scores
  uint8_t* brow = bits + (size_t)g * K * K + (c0 - 1);
  for (int r = 1; r <= m; ++r) {
    const bool rowfree = hfree && r == m;   // horizontal gaps free at mlen
    L.row(r, rowfree ? 0 : go + ge, rowfree ? 0 : ge,
          sprof + 3 * min(r, m - 1), xs, brow);
    brow += K;
  }
  if constexpr (NW > 1) {
    __syncthreads();
    if (L.lane == 0 && L.wid > 0)
      brow[-K] = (uint8_t)(L.pend | (xs.hop[m & 1][L.wid - 1] << 2));
  }
  if (n >= c0 && n < c0 + CPT) {
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      if (c0 + k == n) best[g] = L.S[k];
  }
}

template <int CPT, int NW>
void launch(const int32_t* prof, const int32_t* wc2, const int32_t* d2,
            const int32_t* mlen, const int32_t* nlen, int G, int hfree,
            int vfree, int go, int ge, int32_t* best, uint8_t* bits,
            cudaStream_t stream) {
  constexpr int K = 32 * CPT * NW;
  constexpr int smem = K * 6 * sizeof(int32_t);   // mlen <= K rows
  if constexpr (smem > 32 * 1024)
    cudaFuncSetAttribute(gotoh_kernel<CPT, NW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gotoh_kernel<CPT, NW><<<G, 32 * NW, smem, stream>>>(
      prof, wc2, d2, mlen, nlen, hfree, vfree, go, ge, best, bits);
}

}  // namespace

// prof: (G, K, 6) int32 query profile per DP row (counts of A,C,G,T,N
// and the depth); wc2: (G, 5, K) int32 score-weighted target profile;
// d2: (G, K) int32 target depth; mlen/nlen: (G,) int32 with
// 1 <= mlen, nlen <= K. K is a power of two in 128..4096.
// Outputs best (G,) int32 and bits (G, K, K) uint8 as the contract above
// says. Returns cudaError_t.
extern "C" int gotoh_launch(const void* prof, const void* wc2, const void* d2,
                            const void* mlen, const void* nlen, int G, int K,
                            int hfree, int vfree, int go, int ge, void* best,
                            void* bits, void* stream) {
  if (G <= 0) return 0;
  auto pp = static_cast<const int32_t*>(prof);
  auto wp = static_cast<const int32_t*>(wc2);
  auto dp = static_cast<const int32_t*>(d2);
  auto mp = static_cast<const int32_t*>(mlen);
  auto np_ = static_cast<const int32_t*>(nlen);
  auto bp = static_cast<int32_t*>(best);
  auto tp = static_cast<uint8_t*>(bits);
  auto st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 128: launch<4, 1>(pp, wp, dp, mp, np_, G, hfree, vfree, go, ge, bp, tp, st); break;
    case 256: launch<8, 1>(pp, wp, dp, mp, np_, G, hfree, vfree, go, ge, bp, tp, st); break;
    case 512: launch<4, 4>(pp, wp, dp, mp, np_, G, hfree, vfree, go, ge, bp, tp, st); break;
    case 1024: launch<8, 4>(pp, wp, dp, mp, np_, G, hfree, vfree, go, ge, bp, tp, st); break;
    case 2048: launch<8, 8>(pp, wp, dp, mp, np_, G, hfree, vfree, go, ge, bp, tp, st); break;
    case 4096: launch<16, 8>(pp, wp, dp, mp, np_, G, hfree, vfree, go, ge, bp, tp, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
