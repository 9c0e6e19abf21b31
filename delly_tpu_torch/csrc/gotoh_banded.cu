// K3: corridor (banded) affine-gap Gotoh for a batch of long sequence x
// sequence merges, forward pass.
//
// Replaces the Pallas kernel delly_tpu/ops/gotoh_banded.py::_build (body
// :204-310, call :314), with the recurrence and boundaries of the host
// oracle gotoh_banded_host (:52-135). DP row r covers the columns
// [off(r), off(r) + B) with off(r) = floor128(max(0, r * n / m - B / 2)),
// so consecutive rows shift by d = off(r) - off(r - 1) in {0, 128}.
//
// One block per job loops over its rows 1..m; its T = B / 4 threads cover
// the B band slots, CPT = 4 consecutive slots each (the fastest of the
// (slots, threads) sweep recorded in PERF.md). Per row:
// - r * n / m is kept as a quotient and remainder that step with r (no
//   division); off(r) follows from the quotient with a mask.
// - The previous S and V rows sit in double-buffered shared memory with
//   -INF guard slots on both sides (kPad left, 128 right), so slot k reads
//   its up cell at k + d and its diagonal at k + d - 1 with no bounds
//   test, CPT slots per vector load.
// - A warp whose slots all hold columns 1..n-1 (every warp but the one or
//   two at the band's ends) runs the recurrence with no boundary selects,
//   its score bytes from one vector load of s2; the others take the
//   boundary path (column 0, column n, columns past n). The branch is
//   uniform over the warp.
// - Hopper's DPX instructions: __vibmax_s32 gives V (and the V-opened bit)
//   and the diagonal candidate t (and half of the S==V bit),
//   __viaddmax_s32 the scan input and H.
// - The horizontal chain is a block-wide exclusive max-plus scan of
//   t_seed[c] - c * E: a 5-step warp shuffle scan, one barrier, then one
//   load of the warp totals and a shuffle scan over them (-INF in slot 0,
//   the oracle's zin[0]).
// - A second barrier publishes the new S/V rows and each warp's last H;
//   then the four direction bits (S==H, S==V, H opened, V opened), one
//   byte per (row, slot), are stored CPT at a time. best[g] = S[m][n].
// - With `spread`, a block asks for more than half an SM's shared memory,
//   so the blocks of a round's launches (fewer jobs than SMs) do not
//   share SMs.
//
// Bound on the H100: operations (the recurrence has 39 integer operations
// per cell against one byte written per cell; chip_smoke.py counts the
// interior path's SASS per cell, from a build with K3_COUNT_INTERIOR
// defined, where every warp takes that path). The two barriers per row
// leave latency that only other jobs' blocks can hide; the caller runs a
// round's bands on separate streams so their launches share the card.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kNinf = -1000000;        // -INF of ops/gotoh.py
constexpr int kScanId = INT_MIN / 2;   // identity of the prefix max
constexpr int kQuant = 128;            // corridor offset quantum
constexpr int kPad = 4;                // -INF guard slots left of slot 0
constexpr unsigned kFull = 0xFFFFFFFFu;

// max(a, b), and *ge = (a >= b)
__device__ __forceinline__ int max_ge(int a, int b, bool* ge) {
  return __vibmax_s32(a, b, ge);
}

// CPT ints from p (16-byte aligned)
template <int CPT>
__device__ __forceinline__ void load_ints(const int* p, int* v) {
#pragma unroll
  for (int i = 0; i < CPT / 4; ++i) {
    const int4 x = reinterpret_cast<const int4*>(p)[i];
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

template <int CPT>
__device__ __forceinline__ void store_ints(int* p, const int* v) {
#pragma unroll
  for (int i = 0; i < CPT / 4; ++i)
    reinterpret_cast<int4*>(p)[i] =
        make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// CPT bytes from p (aligned to 4), one per slot
template <int CPT>
__device__ __forceinline__ void load_bytes(const uint8_t* p, int* c) {
#pragma unroll
  for (int i = 0; i < CPT / 4; ++i) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(p)[i];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[4 * i + k] = (w >> (8 * k)) & 0xFF;
  }
}

// one byte per slot to dst (aligned to 4)
template <int CPT>
__device__ __forceinline__ void store_bits(uint8_t* dst, const int* b) {
#pragma unroll
  for (int i = 0; i < CPT / 4; ++i) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) w |= (uint32_t)b[4 * i + k] << (8 * k);
    reinterpret_cast<uint32_t*>(dst)[i] = w;
  }
}

template <int CPT, int T>
__global__ void __launch_bounds__(T)
banded_kernel(const uint8_t* __restrict__ s1, const uint8_t* __restrict__ s2,
              const int32_t* __restrict__ mlen,
              const int32_t* __restrict__ nlen, int M, int hfree, int vfree,
              int match, int mismatch, int go, int ge,
              int32_t* __restrict__ best, uint8_t* __restrict__ bits) {
  static_assert(CPT % 4 == 0, "slots per thread: a multiple of 4");
  constexpr int B = CPT * T;
  constexpr int NW = T / 32;
  constexpr int WS = 32 * CPT;          // slots per warp
  constexpr int RW = kPad + B + kQuant; // one padded S or V row
  extern __shared__ int4 smem4[];
  int* rowS = reinterpret_cast<int*>(smem4);   // [2][RW]
  int* rowV = rowS + 2 * RW;                    // [2][RW]
  uint8_t* sh1 = reinterpret_cast<uint8_t*>(rowV + 2 * RW);   // [M]
  uint8_t* sh2 = sh1 + M;              // [M + 16]: sh2[c] = s2[c - 1]
  __shared__ int s_warp[NW];           // warp totals of the scan
  __shared__ int s_hlast[NW];          // last H of each warp's slots

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int m = mlen[g];
  const int n = nlen[g];
  const uint8_t* s1g = s1 + (size_t)g * M;
  const uint8_t* s2g = s2 + (size_t)g * M;
  uint8_t* bg = bits + (size_t)g * M * B;
  for (int j = tid; j < m; j += T) sh1[j] = s1g[j];
  for (int j = tid; j < n; j += T) sh2[j + 1] = s2g[j];
  for (int j = tid; j < 2 * RW; j += T) {
    rowS[j] = kNinf;
    rowV[j] = kNinf;
  }
  const int k0 = tid * CPT;            // this thread's first slot
  const int wlo = wid * WS;            // this warp's first slot
  __syncthreads();

  // DP row 0 (off(0) == 0): S = 0 or go + col * ge up to col n
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = k0 + k;
    int s0 = c <= n ? (hfree ? 0 : go + c * ge) : kNinf;
    if (c == 0) s0 = 0;
    rowS[kPad + c] = s0;
  }
  __syncthreads();

  int cur = 0;
  int q = 0, rem = 0;                  // r * n == q * m + rem, 0 <= rem < m
  int off = 0;
  for (int r = 1; r <= m; ++r) {
    rem += n;                          // n <= m: one carry at most
    if (rem >= m) {
      rem -= m;
      ++q;
    }
    const int raw = q - B / 2;
    const int off_r = raw > 0 ? (raw & ~(kQuant - 1)) : 0;
    const int d = off_r - off;         // 0 or 128
    off = off_r;
    const int* Sp = rowS + cur * RW + kPad + d + k0;
    const int* Vp = rowV + cur * RW + kPad + d + k0;
    const bool rowfree = hfree && r == m;   // horizontal gaps free at m
    const int O = rowfree ? 0 : go + ge;
    const int E = rowfree ? 0 : ge;
    const int s_col0 = vfree ? 0 : go + r * ge;   // S[r][0]
    const int a = sh1[r - 1];
    const int col0 = off + k0;         // this thread's first column
    // every slot of the warp on columns 1..n-1: no boundary applies
#ifdef K3_COUNT_INTERIOR   // chip_smoke.py's SASS count of that path only
    const bool interior = true;
#else
    const bool interior = off + wlo >= 1 && off + wlo + WS <= n;
#endif

    int su[CPT + 1], vu[CPT];          // su[k]: diagonal of slot k, su[k+1] up
    su[0] = Sp[-1];
    load_ints<CPT>(Sp, su + 1);
    load_ints<CPT>(Vp, vu);
    int t[CPT], Vb[CPT], pb[CPT];      // pb: S==V if t >= H (2), V opened (8)
    int loc = kScanId;
    if (interior) {
      int ch[CPT];
      load_bytes<CPT>(sh2 + col0, ch);
      int ncE = -col0 * E;             // -col * E
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        bool vext, vdom;
        Vb[k] = max_ge(vu[k] + ge, su[k + 1] + (go + ge), &vext);
        const int sc = ch[k] == a ? match : mismatch;
        t[k] = max_ge(Vb[k], su[k] + sc, &vdom);
        pb[k] = (vdom ? 2 : 0) | (vext ? 0 : 8);
        loc = __viaddmax_s32(t[k], ncE, loc);
        ncE -= E;
      }
    } else {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int col = col0 + k;
        const bool atn = vfree && col == n;  // vertical gaps free at col n
        const int vo = atn ? 0 : go + ge;
        const int ve = atn ? 0 : ge;
        bool vext, vdom;
        Vb[k] = max_ge(vu[k] + ve, su[k + 1] + vo, &vext);
        const int j = col < 1 ? 1 : (col > n ? n : col);
        const int sc = sh2[j] == a ? match : mismatch;
        t[k] = max_ge(Vb[k], su[k] + sc, &vdom);
        pb[k] = (vdom ? 2 : 0) | (vext ? 0 : 8);
        const int ts = col == 0 ? s_col0 : t[k];
        loc = max(loc, ts - col * E);
      }
    }
    // block-wide exclusive prefix max of t_seed[c] - c * E over the slots
    // (__shfl_up_sync leaves lanes below the offset their own value)
    int incl = loc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      incl = max(incl, __shfl_up_sync(kFull, incl, o));
    int run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = kScanId;
    if (lane == 31) s_warp[wid] = incl;
    __syncthreads();
    if constexpr (NW > 1) {
      int wt = lane < NW ? s_warp[lane] : kScanId;
#pragma unroll
      for (int o = 1; o < NW; o <<= 1)
        wt = max(wt, __shfl_up_sync(kFull, wt, o));
      const int before = __shfl_sync(kFull, wt, (wid + 31) & 31);
      if (wid > 0) run = max(run, before);
    }

    int H[CPT], sn[CPT], vn[CPT];
    if (interior) {
      int hc = (col0 - 1) * E + O;     // (col - 1) * E + O
      int ncE = -col0 * E;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        // slot 0's scan input is -INF (the oracle's zin[0])
        H[k] = __viaddmax_s32(max(run, kNinf), hc, kNinf);
        run = __viaddmax_s32(t[k], ncE, run);
        hc += E;
        ncE -= E;
        sn[k] = max(t[k], H[k]);
        vn[k] = Vb[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int col = col0 + k;
        H[k] = __viaddmax_s32(max(run, kNinf), (col - 1) * E + O, kNinf);
        const int ts = col == 0 ? s_col0 : t[k];
        run = max(run, ts - col * E);
        int sv = col == 0 ? s_col0 : max(t[k], H[k]);
        sv = col <= n ? sv : kNinf;
        sn[k] = sv;
        vn[k] = col == 0 ? s_col0 : Vb[k];
        if (r == m && col == n) best[g] = sv;
      }
    }
    store_ints<CPT>(rowS + (cur ^ 1) * RW + kPad + k0, sn);
    store_ints<CPT>(rowV + (cur ^ 1) * RW + kPad + k0, vn);
    if (lane == 31) s_hlast[wid] = H[CPT - 1];
    __syncthreads();

    int hp = __shfl_up_sync(kFull, H[CPT - 1], 1);
    if (lane == 0) hp = wid == 0 ? kNinf : s_hlast[wid - 1];
    int bb[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int hprev = k > 0 ? H[k - 1] : hp;
      // S = max(t, H): S==H iff H >= t; S==V iff V >= diag and t >= H
      bb[k] = (H[k] >= t[k] ? 1 : 0) | (pb[k] & (t[k] >= H[k] ? 10 : 8)) |
              (H[k] != hprev + E ? 4 : 0);
    }
    store_bits<CPT>(bg + (size_t)(r - 1) * B + k0, bb);
    cur ^= 1;
  }
}

// dynamic shared memory above half an SM's: one such block per SM
constexpr size_t kOnePerSm = 116 * 1024;

template <int CPT, int T>
int launch(const uint8_t* s1, const uint8_t* s2, const int32_t* mlen,
           const int32_t* nlen, int G, int M, int hfree, int vfree, int match,
           int mismatch, int go, int ge, int32_t* best, uint8_t* bits,
           int spread, cudaStream_t stream) {
  size_t smem =
      (size_t)4 * (kPad + CPT * T + kQuant) * sizeof(int) + (size_t)2 * M + 16;
  if (spread && smem < kOnePerSm) smem = kOnePerSm;
  cudaError_t err = cudaFuncSetAttribute(
      banded_kernel<CPT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_kernel<CPT, T><<<G, T, smem, stream>>>(s1, s2, mlen, nlen, M, hfree,
                                                vfree, match, mismatch, go, ge,
                                                best, bits);
  return (int)cudaGetLastError();
}

}  // namespace

// s1, s2: (G, M) uint8 sequences, zero-padded; mlen/nlen: (G,) int32 with
// 1 <= nlen <= mlen <= M. M is a power of two in 256..32768 and B (the
// band) one of 512, 1024, 2048, 4096, run by B / 4 threads per block.
// Outputs best (G,) int32 and bits (G, M, B) uint8, DP row r at index
// r - 1; rows above mlen are not written. With `spread`, each block asks
// for enough shared memory that no other K3 block shares its SM (for
// launches that together hold fewer jobs than the card has SMs). Returns
// cudaError_t.
extern "C" int gotoh_banded_launch(const void* s1, const void* s2,
                                   const void* mlen, const void* nlen, int G,
                                   int M, int B, int hfree, int vfree,
                                   int match, int mismatch, int go, int ge,
                                   void* best, void* bits, int spread,
                                   void* stream) {
  if (G <= 0) return 0;
  if (M < 256 || M > 32768 || (M & (M - 1))) return (int)cudaErrorInvalidValue;
  auto a = static_cast<const uint8_t*>(s1);
  auto b = static_cast<const uint8_t*>(s2);
  auto ml = static_cast<const int32_t*>(mlen);
  auto nl = static_cast<const int32_t*>(nlen);
  auto bp = static_cast<int32_t*>(best);
  auto tp = static_cast<uint8_t*>(bits);
  auto st = static_cast<cudaStream_t>(stream);
#define K3_CASE(BAND)                                                        \
  case BAND:                                                                 \
    return launch<4, (BAND) / 4>(a, b, ml, nl, G, M, hfree, vfree, match,    \
                                 mismatch, go, ge, bp, tp, spread, st);
  switch (B) { K3_CASE(512) K3_CASE(1024) K3_CASE(2048) K3_CASE(4096) }
#undef K3_CASE
  return (int)cudaErrorInvalidValue;
}

#ifdef K3_COUNT_INTERIOR
// a second slot count at 256 threads, for the SASS slope per slot
extern "C" const void* const k3_count_wide =
    reinterpret_cast<const void*>(&banded_kernel<8, 256>);
#endif
