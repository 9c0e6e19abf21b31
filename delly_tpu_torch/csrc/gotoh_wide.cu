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
// Layout: column strips. The host (ops/gotoh_wide_cuda.py
// strip_geometry) cuts a merge's N columns into Q = P x C chunks of Wc
// columns (Wc a multiple of 16, at most kMaxChunk) and runs each merge on
// P blocks: chunk q on block q mod P, a block's chunks in order. With
// fewer merges than SMs, P is about SMs / G, so the G x P blocks fill the
// card; from G = SMs on, P = 1 and a block walks its merge's chunks one
// after another. A thread holds CPT consecutive columns of the chunk and
// keeps their S and V rows in registers; the chunk's slice of the target
// profile (wc2 and d2, 24 bytes a column) is loaded once into shared
// memory, lane-major so that each thread's 16-byte loads fall on
// distinct banks, and no DP row reads it from L2 again. The query
// profile's row (24 bytes, the same address for every thread) is loaded
// a row ahead.
//
// Inside a block the warps form a wavefront, with no block barrier in
// the row loop: warp w works on its 32 CPT columns of row r once warp
// w - 1 has handed it row r's carry, and may run up to kSlots rows
// ahead of warp w + 1. Per DP row r, a warp:
// - asks for the carry of row r (below) before the row's work;
// - pass 1, per column: V = max(S + vo, V + ve), t = max(S[r-1][c-1] +
//   score, V), and the lane's fold of the horizontal max-plus chain R[c] =
//   max(R[c-1] + E, t[c]); a shuffle scan of the folds over the lanes;
//   the next row's profile scores trunc(num / max(d1 * d2, 1))
//   (profile_score, gotoh_common.cuh) beside the scan's latency;
// - takes the carry (waiting for it only here), which completes each
//   lane's incoming R;
// - pass 2: H = R[c-1] + O, S = max(t, H), the bits, CPT bytes a lane in
//   one store; the lane of the warp's last column writes the carry of
//   row r for the warp to its right.
//
// The carry: one record per DP row and boundary, S and R at the last
// column before the boundary and whether H opens at the next column. The
// warp to the right takes R as the R coming into its first column and the
// flag as that column's H-opened bit; S is its first column's diagonal in
// row r + 1. Chunk 0's first warp takes S[r][0] and R[0] = S[r][0]
// instead, and always opens H at column 1.
//
// The hand-off is point to point, never a barrier over a merge's warps or
// blocks. Between the warps of a block: a ring of kSlots records in
// shared memory per boundary; the consumer writes the last row it read,
// and the producer reads that before it reuses a slot. Between chunks:
// route (a), records in global memory, one slot per DP row (D = M), so
// no slot is written twice and the producer never waits (the rings of a
// launch take at most ~34 MB; they are zeroed before the launch). A
// record is two 8-byte words {S, r} and {R, 2r + flag}, each written and
// read whole (st/ld.volatile.v2.u64): a word whose tag is r carries row
// r's value, so no fence orders data against a flag. A warp spins only
// on a warp to its left or on a chunk of a lower index, which its block
// runs before any later chunk of its own; with P > 1 the launch is
// cooperative (cudaLaunchCooperativeKernel), which puts every block of
// the grid on the card at once or refuses the launch, so no block spins
// on a block that was never scheduled. A thread-block cluster (route
// (b)) would cap P at 8 (16 non-portable), against the 9-16 strips of a
// launch of 1-14 merges.
//
// -INF is -1,000,000, as in ops/gotoh.py. Under the MSA's DnaScore
// (match 5, mismatch -4, go -10, ge -1) no reachable score of a merge of
// 16,384 x 16,384 comes near it: every S is at least the all-gap path,
// 2 go + (m + n) ge >= -32,788, and every V after row 0 at least S + go +
// ge; on the free rows and columns the costs are 0.
//
// Bound on the H100: operations (K2's 42 integer operations per cell,
// one byte written per cell). A warp's row is a chain of latencies (the
// shuffle scan, the carry) beside its cells' work, so an SM needs many
// warps in flight: the host keeps strips at least STRIP_FLOOR columns
// wide. The wavefront's fill is one warp row per warp of the merge plus
// a global hand-off per strip. ptxas: 63 registers a thread at 4 columns
// a lane, no spill.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "gotoh_common.cuh"

namespace {

constexpr int kMaxN = 16384;           // the widest tile
constexpr int kMaxChunk = 4096;        // columns of a block's chunk
constexpr int kSlots = 32;             // rows a ring between warps holds
constexpr int kCPT = 4;                // columns per thread
constexpr int kNinf = -1000000;        // -INF of ops/gotoh.py
constexpr int kScanId = INT_MIN / 2;   // identity of the max-plus scan
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int lane_of(const int4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// One carry record: two 8-byte words {S, tag r} and {R, tag 2r + flag},
// each written and read whole (a vector access of two 64-bit elements is
// two single-copy-atomic 8-byte accesses), at a generic address (shared
// or global memory).
__device__ __forceinline__ void put_record(uint64_t* p, int s, int r, int R,
                                           int flag) {
  const uint64_t a = (uint64_t)(uint32_t)r << 32 | (uint32_t)s;
  const uint64_t b = (uint64_t)(uint32_t)(2 * r + flag) << 32 | (uint32_t)R;
  asm volatile("st.volatile.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b)
               : "memory");
}

__device__ __forceinline__ void get_record(const uint64_t* p, uint64_t& a,
                                           uint64_t& b) {
  asm volatile("ld.volatile.v2.u64 {%0, %1}, [%2];"
               : "=l"(a), "=l"(b)
               : "l"(p)
               : "memory");
}

// whether the words hold row r's record
__device__ __forceinline__ bool is_row(uint64_t a, uint64_t b, int r) {
  return (uint32_t)(a >> 32) == (uint32_t)r &&
         (uint32_t)(b >> 33) == (uint32_t)r;
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  int v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_volatile(int* p, int v) {
  asm volatile("st.volatile.shared.u32 [%0], %1;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}

// the rings between the warps of a block: ring[w] carries warp w's
// records to warp w + 1, which writes in done[w] the last row it read
struct Rings {
  uint64_t ring[32][kSlots][2];
  int done[32];
};

template <int CPT>
__global__ void __launch_bounds__(kMaxChunk / CPT)
gotoh_wide_kernel(const int32_t* __restrict__ prof,
                  const int32_t* __restrict__ wc2,
                  const int32_t* __restrict__ d2,
                  const int32_t* __restrict__ mlen,
                  const int32_t* __restrict__ nlen, int M, int N, int P,
                  int Q, int Wc, int hfree, int vfree, int go, int ge,
                  int32_t* __restrict__ best, uint8_t* __restrict__ bits,
                  uint64_t* __restrict__ recs) {
  static_assert(CPT == 4 || CPT == 8, "columns per thread: 4 or 8");
  constexpr int J = CPT / 4;           // int4 groups per thread
  constexpr int WC = 32 * CPT;         // columns per warp
  __shared__ Rings rg;
  extern __shared__ int4 sp[];         // [6][J][T]: wc2 rows a = 0..4, d2
  const int g = blockIdx.x / P, j0 = blockIdx.x % P;
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int m = min(mlen[g], M), n = min(nlen[g], N);
  const int last_t = Wc / CPT - 1;     // the thread of the chunk's last column
  const int wlast = last_t >> 5;       // its warp
  const int2* pg = reinterpret_cast<const int2*>(prof + (size_t)g * M * 6);
  for (int q = j0; q < Q; q += P) {
    const int cs = q * Wc;             // columns before the chunk
    if (cs >= n) return;               // this chunk and later ones past nlen
    __syncthreads();                   // the last chunk's readers are done
    // the chunk's target profile, lane-major: thread t's group jj of
    // column cs + t * CPT + 4 jj at sp[(a * J + jj) * T + t]
    for (int k = tid; k < J * T; k += T) {
      const int t = k / J, jj = k % J;
      const int c = cs + t * CPT + 4 * jj;   // 0-based first column
      const bool in = t * CPT < Wc && c < N;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const int32_t* p = a < 5 ? wc2 + ((size_t)g * 5 + a) * N + c
                                 : d2 + (size_t)g * N + c;
        sp[(a * J + jj) * T + t] =
            in ? __ldg(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
      }
    }
    for (int k = tid; k < 32 * kSlots * 2; k += T)
      (&rg.ring[0][0][0])[k] = 0;      // no tag 0 is a row
    if (tid < 32) rg.done[tid] = 0;
    __syncthreads();
    const int c0 = cs + tid * CPT + 1;   // the thread's first DP column
    const bool own = tid <= last_t && c0 <= N;   // columns of the chunk
    const int cw = cs + wid * WC;      // columns before the warp
    int S[CPT], V[CPT], vo[CPT], ve[CPT], sc[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const bool vf = vfree && c0 + k == n;   // vertical gaps free at nlen
      vo[k] = vf ? 0 : go + ge;
      ve[k] = vf ? 0 : ge;
      S[k] = hfree ? 0 : go + (c0 + k) * ge;  // DP row 0
      V[k] = kNinf;
    }
    // where the warp's carry comes from and goes to: the warp to the left
    // (shared memory), the chunk to the left (global memory), or, for
    // chunk 0's first warp, column 0
    const uint64_t* src = nullptr;
    if (wid > 0)
      src = &rg.ring[wid - 1][0][0];
    else if (q > 0)
      src = recs + ((size_t)g * (Q - 1) + q - 1) * M * 2;
    const int src_mask = wid > 0 ? kSlots - 1 : INT_MAX;   // slots of src
    uint64_t* dst = nullptr;
    if (wid < wlast)
      dst = &rg.ring[wid][0][0];
    else if (q + 1 < Q && cs + Wc < n)   // a chunk to the right reads it
      dst = recs + ((size_t)g * (Q - 1) + q) * M * 2;
    const int dst_mask = wid < wlast ? kSlots - 1 : INT_MAX;
    const int plane = wid < wlast ? 31 : last_t & 31;   // the warp's last
    int seen = 0;                      // rows the warp to the right has read
    // lane 0: the diagonal of the warp's first column, S[r-1][cw]
    int diag_in = (cw == 0 || hfree) ? 0 : go + cw * ge;
    // the scores of a row (counts of A,C,G,T,N and the depth)
    auto scores = [&](int2 q0, int2 q1, int2 q2) {
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        int4 w5[5];
#pragma unroll
        for (int a = 0; a < 5; ++a) w5[a] = sp[(a * J + jj) * T + tid];
        const int4 dd = sp[(5 * J + jj) * T + tid];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int num = q0.x * lane_of(w5[0], i) + q0.y * lane_of(w5[1], i) +
                          q1.x * lane_of(w5[2], i) + q1.y * lane_of(w5[3], i) +
                          q2.x * lane_of(w5[4], i);
          sc[4 * jj + i] = profile_score(num, max(q2.y * lane_of(dd, i), 1));
        }
      }
    };
    scores(__ldg(pg), __ldg(pg + 1), __ldg(pg + 2));   // DP row 1
    uint8_t* brow = bits + (size_t)g * M * N + (c0 - 1);
    for (int r = 1; r <= m; ++r, brow += N) {
      // the carry of row r, asked for before the row's work
      uint64_t ra = 0, rb = 0;
      const uint64_t* rp = src ? src + 2 * ((r - 1) & src_mask) : nullptr;
      if (rp) get_record(rp, ra, rb);
      const bool rowfree = hfree && r == m;   // horizontal gaps free at mlen
      const int O = rowfree ? 0 : go + ge, E = rowfree ? 0 : ge;
      // the next row's query profile, loaded while this row runs
      const int2* pn = pg + 3 * min(r, m - 1);
      const int2 q0 = __ldg(pn), q1 = __ldg(pn + 1), q2 = __ldg(pn + 2);
      int up = __shfl_up_sync(kFull, S[CPT - 1], 1);   // S[r-1][c0-1]
      if (lane == 0) up = diag_in;
      int t[CPT];
      uint32_t w[J];                   // the bits, a byte per column
      int fold = kScanId;
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
      // a warp barrier between pass 1 and the scan: without it the row
      // loop ran 2.6x slower on the H100 (ptxas's schedule; PERF.md, PR 14)
      __syncwarp();
      // inclusive max-plus scan of the lanes' folds, slope CPT * E per lane
      const int CE = CPT * E;
      int incl = fold;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl = __viaddmax_s32(v, o * CE, incl);
      }
      int R = __shfl_up_sync(kFull, incl, 1);    // R[c0 - 1] in the warp
      scores(q0, q1, q2);              // the next row's, beside the scan
      // the carry: S[r][cw] (the next row's diagonal), R[cw] and whether H
      // opens at column cw + 1
      int s_in, r_in, hop_in;
      if (rp) {
        while (!__all_sync(kFull, is_row(ra, rb, r))) get_record(rp, ra, rb);
        if (wid > 0 && lane == 0) st_volatile(&rg.done[wid - 1], r);
        s_in = (int)(uint32_t)ra;
        r_in = (int)(uint32_t)rb;
        hop_in = (int)(rb >> 32) & 1;
      } else {                         // column 0: S[r][0], R[0] = S[r][0]
        s_in = r_in = vfree ? 0 : go + r * ge;
        hop_in = 1;
      }
      R = lane == 0 ? r_in : max(R, r_in + lane * CE);
      bool hopen = false;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int h = R + O;
        const int re = R + E;
        R = max(re, t[k]);
        const int s = max(h, t[k]);
        w[k / 4] |= ((s == h ? 1u : 0u) | (s == V[k] ? 2u : 0u) |
                     (hopen ? 4u : 0u)) << (8 * (k % 4));
        hopen = t[k] > re;             // H opened at the next column
        S[k] = s;
      }
      // H opened at the thread's first column: the lane to the left's last
      // flag, the carry's for the warp's first
      int hx = __shfl_up_sync(kFull, hopen ? 1 : 0, 1);
      if (lane == 0) hx = hop_in;
      w[0] |= (uint32_t)hx << 2;
      if (own) {
        if constexpr (CPT == 4)
          *reinterpret_cast<uint32_t*>(brow) = w[0];
        else
          *reinterpret_cast<uint2*>(brow) = make_uint2(w[0], w[1]);
      }
      if (dst && lane == plane) {
        if (wid < wlast)               // the slot's last row has been read
          while (seen < r - kSlots) seen = ld_volatile(&rg.done[wid]);
        put_record(dst + 2 * ((r - 1) & dst_mask), S[CPT - 1], r, R, hopen);
      }
      diag_in = s_in;
      if (r == m && own && n >= c0 && n < c0 + CPT) {
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          if (c0 + k == n) best[g] = S[k];
      }
    }
  }
}

// the kernel's threads, dynamic shared memory and launch for chunks of Wc
// columns
int launch(const int32_t* prof, const int32_t* wc2, const int32_t* d2,
           const int32_t* mlen, const int32_t* nlen, int G, int M, int N,
           int P, int Q, int Wc, int hfree, int vfree, int go, int ge,
           int32_t* best, uint8_t* bits, uint64_t* recs,
           cudaStream_t stream) {
  const int threads = (Wc / kCPT + 31) / 32 * 32;
  const size_t smem = (size_t)6 * threads * kCPT * sizeof(int32_t);
  auto kern = gotoh_wide_kernel<kCPT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (Q > 1) {
    e = cudaMemsetAsync(recs, 0, (size_t)G * (Q - 1) * M * 16, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (P == 1) {        // a block's chunks carry only to themselves
    gotoh_wide_kernel<kCPT><<<G, threads, smem, stream>>>(
        prof, wc2, d2, mlen, nlen, M, N, P, Q, Wc, hfree, vfree, go, ge, best,
        bits, recs);
    return (int)cudaGetLastError();
  }
  void* args[] = {&prof, &wc2, &d2, &mlen, &nlen, &M, &N, &P, &Q, &Wc,
                  &hfree, &vfree, &go, &ge, &best, &bits, &recs};
  return (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(G * P),
                                          dim3(threads), args, smem, stream);
}

#ifdef K4_COUNT_SLOPE
// 8 columns a thread, only for chip_smoke.py's SASS count (the slope of
// the row loop per column)
template __global__ void gotoh_wide_kernel<8>(
    const int32_t*, const int32_t*, const int32_t*, const int32_t*,
    const int32_t*, int, int, int, int, int, int, int, int, int, int32_t*,
    uint8_t*, uint64_t*);
#endif

}  // namespace

// prof: (G, M, 6) int32 query profile per DP row (counts of A,C,G,T,N and
// the depth); wc2: (G, 5, N) int32 score-weighted target profile; d2:
// (G, N) int32 target depth; mlen/nlen: (G,) int32 with 1 <= mlen <= M and
// 1 <= nlen <= N. M <= 16,384; N a multiple of 16, at most 16,384; all
// pointers 16-byte aligned. The geometry (strip_geometry): P blocks per
// merge, Q = P x C chunks of Wc columns (a multiple of 16, at most 4,096,
// Q x Wc >= N); recs: G x (Q - 1) x M records of 16 bytes, the carry
// rings between chunks, zeroed here (unused when Q = 1). Outputs best
// (G,) int32 and bits (G, M, N) uint8 as the contract above says. Returns
// cudaError_t; a cooperative launch that the card cannot hold at once is
// refused, not run.
extern "C" int gotoh_wide_launch(const void* prof, const void* wc2,
                                 const void* d2, const void* mlen,
                                 const void* nlen, int G, int M, int N,
                                 int P, int Q, int Wc, int hfree, int vfree,
                                 int go, int ge, void* best, void* bits,
                                 void* recs, void* stream) {
  if (G <= 0) return 0;
  if (M < 1 || M > kMaxN || N < 16 || N > kMaxN || N % 16 || P < 1 ||
      Q < P || Q % P || Wc < 16 || Wc % 16 || Wc > kMaxChunk ||
      (long long)Q * Wc < N)
    return (int)cudaErrorInvalidValue;
  return launch(static_cast<const int32_t*>(prof),
                static_cast<const int32_t*>(wc2),
                static_cast<const int32_t*>(d2),
                static_cast<const int32_t*>(mlen),
                static_cast<const int32_t*>(nlen), G, M, N, P, Q, Wc, hfree,
                vfree, go, ge, static_cast<int32_t*>(best),
                static_cast<uint8_t*>(bits), static_cast<uint64_t*>(recs),
                static_cast<cudaStream_t>(stream));
}
