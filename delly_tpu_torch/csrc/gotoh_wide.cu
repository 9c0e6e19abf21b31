// K4: affine-gap profile-vs-profile Gotoh for MSA merges wider than K2's
// 4,096 columns (up to 16,384), forward pass.
//
// Replaces the XLA scan delly_tpu/ops/gotoh_device.py::_build (:35-98),
// X2, over the widths that K2 (gotoh.cu) does not serve. The recurrence,
// the boundary rules and the exact score are K2's.
//
// Contract (what K4-tb and the comparisons with gotoh_forward_plain
// read): a tile of M x N bytes per merge; best[g] = S[mlen][nlen], and
// the direction bits of DP rows 1..mlen and columns 1..nlen, row r at
// tile row r - 1 and column c at tile column c - 1; bits 1/2/4/8 = S==H,
// S==V, H opened, V opened. Rows above mlen and columns past nlen are
// unspecified. The host sizes M and N to the launch's merges (N a
// multiple of 16), not to a square bucket.
//
// Layout. One block per merge, of ceil(N / 16) threads rounded up to a
// warp (at most 1,024): thread t holds columns 16t + 1 .. 16t + 16 and
// keeps their S and V rows in registers (64 registers a thread at 1,024
// threads; ptxas spills a few bytes; 32 columns a thread at 512 threads,
// which spills nothing, ran slower at long-split's merges). K2 keeps the
// target profile in registers too; here it fits neither the registers
// nor, as int32 (24 bytes a column, 393 KB at 16,384), the 227 KB of
// shared memory, so each row reads it again from global memory, where it
// stays in L2 (the merges of a launch hold a few MB of it). The query
// profile's row is one 24-byte load that every thread makes at the same
// address.
//
// Per DP row r, two block barriers:
// - pass 1, per column: the profile score trunc(num / max(d1 * d2, 1))
//   (profile_score, gotoh_common.cuh), V = max(S + vo, V + ve),
//   t = max(S[r-1][c-1] + score, V), and the thread's fold of the
//   horizontal max-plus chain R[c] = max(R[c-1] + E, t[c]); t takes S's
//   registers until pass 2. The diagonal of a warp's first column is the
//   last S of the warp to its left in the row above, from shared memory;
// - a shuffle scan of the folds over the warp's lanes (slope 16 E per
//   lane), each warp's total into shared memory, barrier 1; each warp
//   scans the totals of the warps before it (slope 512 E per warp) and so
//   gets the R coming into each lane;
// - pass 2: H = R[c-1] + O, S = max(t, H), the bits (H opened: t[c-1] >
//   R[c-2] + E, from the lane to the left for a lane's first column), 16
//   bytes a thread in one store. A warp's last lane publishes its S and
//   its H-opened flag; barrier 2; a warp's first lane then completes its
//   first column's H-opened bit from the warp to its left and stores.
//
// -INF is -1,000,000, as in ops/gotoh.py. Under the MSA's DnaScore
// (match 5, mismatch -4, go -10, ge -1) no reachable score of a merge of
// 16,384 x 16,384 comes near it: every S is at least the all-gap path,
// 2 go + (m + n) ge >= -32,788, and every V after row 0 at least S + go +
// ge; on the free rows and columns the costs are 0.
//
// Bound on the H100: operations (K2's 42 integer operations per cell,
// one byte written per cell). One block per merge keeps one SM per merge:
// a launch of fewer merges than SMs leaves the others idle, and each row
// pays two barriers and a 32-warp scan.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "gotoh_common.cuh"

namespace {

constexpr int kCPT = 16;                // columns per thread
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxN = kCPT * kMaxThreads;   // the widest tile, 16,384
constexpr int kNinf = -1000000;        // -INF of ops/gotoh.py
constexpr int kScanId = INT_MIN / 2;   // identity of the max-plus scan
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int lane_of(const int4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(kMaxThreads)
gotoh_wide_kernel(const int32_t* __restrict__ prof,
                  const int32_t* __restrict__ wc2,
                  const int32_t* __restrict__ d2,
                  const int32_t* __restrict__ mlen,
                  const int32_t* __restrict__ nlen, int M, int N, int hfree,
                  int vfree, int go, int ge, int32_t* __restrict__ best,
                  uint8_t* __restrict__ bits) {
  __shared__ int fold_w[kMaxWarps];    // each warp's fold of the row
  __shared__ int last_w[kMaxWarps];    // S of each warp's last column
  __shared__ int hop_w[kMaxWarps];     // H opened after each warp's last
  // a block per merge: g, m and n are uniform over the block
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int m = min(mlen[g], M), n = min(nlen[g], N);
  const int c0 = tid * kCPT + 1;       // the thread's first column
  const bool own = c0 <= N;            // its 16 columns lie in the tile
  const int32_t* wg = wc2 + (size_t)g * 5 * N + (c0 - 1);
  const int32_t* dg = d2 + (size_t)g * N + (c0 - 1);
  const int2* pg = reinterpret_cast<const int2*>(prof + (size_t)g * M * 6);
  uint8_t* brow = bits + (size_t)g * M * N + (c0 - 1);
  int S[kCPT], V[kCPT];
#pragma unroll
  for (int k = 0; k < kCPT; ++k) {
    S[k] = hfree ? 0 : go + (c0 + k) * ge;   // DP row 0
    V[k] = kNinf;
  }
  if (lane == 31) last_w[wid] = S[kCPT - 1];
  __syncthreads();
  for (int r = 1; r <= m; ++r) {
    const bool rowfree = hfree && r == m;  // horizontal gaps free at mlen
    const int O = rowfree ? 0 : go + ge, E = rowfree ? 0 : ge;
    const int s_r0 = vfree ? 0 : go + r * ge;                    // S[r][0]
    const int s_r0_prev = (vfree || r == 1) ? 0 : go + (r - 1) * ge;
    // the query profile's row r: counts of A,C,G,T,N and the depth
    const int2 q0 = __ldg(pg + 3 * (r - 1)), q1 = __ldg(pg + 3 * (r - 1) + 1),
               q2 = __ldg(pg + 3 * (r - 1) + 2);
    const int q[5] = {q0.x, q0.y, q1.x, q1.y, q2.x};
    int diag = __shfl_up_sync(kFull, S[kCPT - 1], 1);    // S[r-1][c0-1]
    if (lane == 0) diag = wid == 0 ? s_r0_prev : last_w[wid - 1];
    int fold = tid == 0 ? s_r0 : kScanId;
    uint32_t w[kCPT / 4];              // the bits, a byte per column
#pragma unroll
    for (int j = 0; j < kCPT / 4; ++j) {
      // the scores of 4 columns: num = sum_a c1[a] * wc2[a][c]
      int num[4] = {0, 0, 0, 0};
      int4 dd = make_int4(0, 0, 0, 0);
      if (own) {
#pragma unroll
        for (int a = 0; a < 5; ++a) {
          const int4 x = __ldg(reinterpret_cast<const int4*>(wg + a * N) + j);
#pragma unroll
          for (int i = 0; i < 4; ++i) num[i] += q[a] * lane_of(x, i);
        }
        dd = __ldg(reinterpret_cast<const int4*>(dg) + j);
      }
      w[j] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * j + i;
        const int sc = profile_score(num[i], max(q2.y * lane_of(dd, i), 1));
        const bool vf = vfree && c0 + k == n;   // vertical gaps free at nlen
        const int vv = V[k] + (vf ? 0 : ge);
        const int vn = max(S[k] + (vf ? 0 : go + ge), vv);
        w[j] |= (vn != vv ? 8u : 0u) << (8 * i);               // V opened
        const int t = max(diag + sc, vn);
        diag = S[k];
        S[k] = t;                      // t in S's place until pass 2
        V[k] = vn;
        fold = max(fold + E, t);
      }
    }
    // inclusive max-plus scan of the lanes' folds, slope 16 E per lane
    const int CE = kCPT * E;
    int incl = fold;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = __viaddmax_s32(v, o * CE, incl);
    }
    if (lane == 31) fold_w[wid] = incl;
    __syncthreads();
    int R = __shfl_up_sync(kFull, incl, 1);        // R[c0 - 1]
    if (lane == 0) R = wid == 0 ? s_r0 : kScanId;
    if (wid > 0) {
      // the totals of the warps before this one, scanned (slope 512 E)
      int T = lane < wid ? fold_w[lane] : kScanId;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, T, o);
        if (lane >= o) T = __viaddmax_s32(v, o * 32 * CE, T);
      }
      const int P = __shfl_sync(kFull, T, wid - 1);   // R before the warp
      R = max(R, P + lane * CE);
    }
    bool hopen = false;                // H opened at the next column
#pragma unroll
    for (int k = 0; k < kCPT; ++k) {
      const int h = R + O;
      const int re = R + E;
      const int t = S[k];
      R = max(re, t);
      const int s = max(h, t);
      w[k / 4] |= ((s == h ? 1u : 0u) | (s == V[k] ? 2u : 0u) |
                   (hopen ? 4u : 0u)) << (8 * (k % 4));
      hopen = t > re;
      S[k] = s;
    }
    // H opened at the thread's first column: the lane to the left's last
    // flag; always at column 1; from the warp to the left after barrier 2
    int hx = __shfl_up_sync(kFull, hopen ? 1 : 0, 1);
    if (lane == 31) {
      last_w[wid] = S[kCPT - 1];
      hop_w[wid] = hopen ? 1 : 0;
    }
    const bool late = lane == 0 && wid > 0;
    if (lane == 0 && wid == 0) hx = 1;
    if (own && !late) {
      w[0] |= (uint32_t)hx << 2;
      *reinterpret_cast<uint4*>(brow) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
    if (own && late) {
      w[0] |= (uint32_t)hop_w[wid - 1] << 2;
      *reinterpret_cast<uint4*>(brow) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    brow += N;
  }
  if (n >= c0 && n < c0 + kCPT) {
#pragma unroll
    for (int k = 0; k < kCPT; ++k)
      if (c0 + k == n) best[g] = S[k];
  }
}

}  // namespace

// prof: (G, M, 6) int32 query profile per DP row (counts of A,C,G,T,N and
// the depth); wc2: (G, 5, N) int32 score-weighted target profile; d2:
// (G, N) int32 target depth; mlen/nlen: (G,) int32 with 1 <= mlen <= M and
// 1 <= nlen <= N. M <= 16,384; N a multiple of 16, at most 16,384; all
// pointers 16-byte aligned. Outputs best (G,) int32 and bits (G, M, N)
// uint8 as the contract above says. Returns cudaError_t.
extern "C" int gotoh_wide_launch(const void* prof, const void* wc2,
                                 const void* d2, const void* mlen,
                                 const void* nlen, int G, int M, int N,
                                 int hfree, int vfree, int go, int ge,
                                 void* best, void* bits, void* stream) {
  if (G <= 0) return 0;
  if (M < 1 || M > kMaxN || N < 16 || N > kMaxN || N % 16)
    return (int)cudaErrorInvalidValue;
  const int threads = (N / kCPT + 31) / 32 * 32;
  gotoh_wide_kernel<<<G, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(prof), static_cast<const int32_t*>(wc2),
      static_cast<const int32_t*>(d2), static_cast<const int32_t*>(mlen),
      static_cast<const int32_t*>(nlen), M, N, hfree, vfree, go, ge,
      static_cast<int32_t*>(best), static_cast<uint8_t*>(bits));
  return (int)cudaGetLastError();
}
