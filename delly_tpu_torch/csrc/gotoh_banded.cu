// K3: corridor (banded) affine-gap Gotoh for a batch of long sequence x
// sequence merges, forward pass.
//
// Replaces the Pallas kernel delly_tpu/ops/gotoh_banded.py::_build (body
// :204-310, call :314), with the recurrence and boundaries of the host
// oracle gotoh_banded_host (:52-135). DP row r covers the columns
// [off(r), off(r) + B) with off(r) = floor128(max(0, r * n / m - B / 2)),
// so consecutive rows shift by d = off(r) - off(r - 1) in {0, 128}.
//
// One block per job loops over its rows 1..m; its T threads cover the B
// band slots, CPT consecutive slots each. The previous S and V rows sit
// in double-buffered shared memory, so the shift d is an offset in the
// read (slot k reads slot k + d of the previous row, the diagonal
// k + d - 1; shifted-out slots read -INF). Both sequences are staged in
// shared memory; a cell compares s1[r - 1] with s2[clip(col - 1, 0,
// n - 1)] itself. Per row a thread computes V, the diagonal candidate t
// and, after a block-wide exclusive max-plus scan of t_seed[c] - c * E
// (warp shuffles, then the warp totals; -INF in slot 0), the horizontal
// chain H, then S and the four direction bits (S==H, S==V, H opened,
// V opened), one byte per (row, slot). best[g] = S[m][n].
//
// Bound on the H100: operations (the recurrence has 39 integer operations
// per cell against one byte written per cell). The row loop spends more
// instructions than that: per thread and row, an integer division for
// off(r), the scan and the loop over the warp totals, and the per-slot
// bounds checks (chip_smoke.py counts them in the SASS). Two block
// barriers per row add latency that only other jobs' blocks can hide, so
// a batch smaller than the SM count leaves the card mostly idle.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kNinf = -1000000;        // -INF of ops/gotoh.py
constexpr int kScanId = INT_MIN / 2;   // identity of the prefix max
constexpr int kQuant = 128;            // corridor offset quantum

__device__ __forceinline__ int corridor_off(int r, int n, int m, int B) {
  // r * n <= 32768 * 32768 fits in int32
  int raw = r * n / m - B / 2;
  raw = raw > 0 ? raw : 0;
  return raw - raw % kQuant;
}

template <int CPT>
__device__ __forceinline__ void store_bits(uint8_t* dst, const int* b);

template <>
__device__ __forceinline__ void store_bits<1>(uint8_t* dst, const int* b) {
  dst[0] = (uint8_t)b[0];
}

template <>
__device__ __forceinline__ void store_bits<2>(uint8_t* dst, const int* b) {
  *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(b[0] | (b[1] << 8));
}

template <>
__device__ __forceinline__ void store_bits<4>(uint8_t* dst, const int* b) {
  *reinterpret_cast<uint32_t*>(dst) =
      (uint32_t)(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24));
}

template <int CPT, int T>
__global__ void __launch_bounds__(T)
banded_kernel(const uint8_t* __restrict__ s1, const uint8_t* __restrict__ s2,
              const int32_t* __restrict__ mlen,
              const int32_t* __restrict__ nlen, int M, int hfree, int vfree,
              int match, int mismatch, int go, int ge,
              int32_t* __restrict__ best, uint8_t* __restrict__ bits) {
  constexpr int B = CPT * T;
  constexpr int NW = T / 32;
  extern __shared__ int smem[];
  int* rowS = smem;                    // [2][B]
  int* rowV = smem + 2 * B;            // [2][B]
  uint8_t* sh1 = reinterpret_cast<uint8_t*>(smem + 4 * B);   // [M]
  uint8_t* sh2 = sh1 + M;                                    // [M]
  __shared__ int s_warp[NW];           // warp totals of the scan
  __shared__ int s_h[T];               // last H of each thread's slots

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
  for (int j = tid; j < n; j += T) sh2[j] = s2g[j];
  const int k0 = tid * CPT;            // this thread's first slot

  // DP row 0 (off(0) == 0): S = 0 or go + col * ge up to col n
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = k0 + k;
    int s0 = c <= n ? (hfree ? 0 : go + c * ge) : kNinf;
    if (c == 0) s0 = 0;
    rowS[c] = s0;
    rowV[c] = kNinf;
  }
  __syncthreads();

  int cur = 0;
  int off_prev = 0;
  for (int r = 1; r <= m; ++r) {
    const int off = corridor_off(r, n, m, B);
    const int d = off - off_prev;      // 0 or 128
    off_prev = off;
    const int* Sp = rowS + cur * B;
    const int* Vp = rowV + cur * B;
    const bool rowfree = hfree && r == m;   // horizontal gaps free at m
    const int O = rowfree ? 0 : go + ge;
    const int E = rowfree ? 0 : ge;
    const int s_col0 = vfree ? 0 : go + r * ge;   // S[r][0]
    const int a = sh1[r - 1];

    int t[CPT], Vb[CPT], Vue[CPT];
    int loc = kScanId;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int col = off + k0 + k;
      const int iu = k0 + k + d;
      const int s_up = iu < B ? Sp[iu] : kNinf;
      const int v_up = iu < B ? Vp[iu] : kNinf;
      const int s_dg = (iu >= 1 && iu <= B) ? Sp[iu - 1] : kNinf;
      const bool atn = vfree && col == n;  // vertical gaps free at col n
      const int vo = atn ? 0 : go + ge;
      const int ve = atn ? 0 : ge;
      Vue[k] = v_up + ve;
      Vb[k] = max(s_up + vo, Vue[k]);
      int j = col - 1;
      j = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
      const int sc = a == sh2[j] ? match : mismatch;
      t[k] = max(s_dg + sc, Vb[k]);
      const int ts = col == 0 ? s_col0 : t[k];
      loc = max(loc, ts - col * E);
    }
    // block-wide exclusive prefix max of t_seed[c] - c * E over the slots
    int incl = loc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int run = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
    if (lane == 0) run = kScanId;
    if (lane == 31) s_warp[wid] = incl;
    __syncthreads();
    for (int w2 = 0; w2 < wid; ++w2) run = max(run, s_warp[w2]);

    int H[CPT];
    int* Sn = rowS + (cur ^ 1) * B;
    int* Vn = rowV + (cur ^ 1) * B;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int col = off + k0 + k;
      // slot 0's scan input is -INF (the oracle's zin[0])
      H[k] = max(max(run, kNinf) + (col - 1) * E + O, kNinf);
      const int ts = col == 0 ? s_col0 : t[k];
      run = max(run, ts - col * E);
      t[k] = max(t[k], H[k]);          // t now holds S before boundaries
      int sv = col == 0 ? s_col0 : t[k];
      const int vv = col == 0 ? s_col0 : Vb[k];
      sv = col <= n ? sv : kNinf;
      Sn[k0 + k] = sv;
      Vn[k0 + k] = vv;
      if (r == m && col == n) best[g] = sv;
    }
    s_h[tid] = H[CPT - 1];
    __syncthreads();

    int bb[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int hp = k > 0 ? H[k - 1] : (tid == 0 ? kNinf : s_h[tid - 1]);
      bb[k] = (t[k] == H[k] ? 1 : 0) | (t[k] == Vb[k] ? 2 : 0) |
              (H[k] != hp + E ? 4 : 0) | (Vb[k] != Vue[k] ? 8 : 0);
    }
    store_bits<CPT>(bg + (size_t)(r - 1) * B + k0, bb);
    cur ^= 1;
  }
}

template <int CPT, int T>
int launch(const uint8_t* s1, const uint8_t* s2, const int32_t* mlen,
           const int32_t* nlen, int G, int M, int hfree, int vfree, int match,
           int mismatch, int go, int ge, int32_t* best, uint8_t* bits,
           cudaStream_t stream) {
  const size_t smem = (size_t)4 * CPT * T * sizeof(int) + (size_t)2 * M;
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
// band) one of 512, 1024, 2048, 4096. Outputs best (G,) int32 and bits
// (G, M, B) uint8, DP row r at index r - 1; rows above mlen are not
// written. Returns cudaError_t.
extern "C" int gotoh_banded_launch(const void* s1, const void* s2,
                                   const void* mlen, const void* nlen, int G,
                                   int M, int B, int hfree, int vfree,
                                   int match, int mismatch, int go, int ge,
                                   void* best, void* bits, void* stream) {
  if (G <= 0) return 0;
  if (M < 256 || M > 32768 || (M & (M - 1))) return (int)cudaErrorInvalidValue;
  auto a = static_cast<const uint8_t*>(s1);
  auto b = static_cast<const uint8_t*>(s2);
  auto ml = static_cast<const int32_t*>(mlen);
  auto nl = static_cast<const int32_t*>(nlen);
  auto bp = static_cast<int32_t*>(best);
  auto tp = static_cast<uint8_t*>(bits);
  auto st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 512: return launch<1, 512>(a, b, ml, nl, G, M, hfree, vfree, match, mismatch, go, ge, bp, tp, st);
    case 1024: return launch<2, 512>(a, b, ml, nl, G, M, hfree, vfree, match, mismatch, go, ge, bp, tp, st);
    case 2048: return launch<4, 512>(a, b, ml, nl, G, M, hfree, vfree, match, mismatch, go, ge, bp, tp, st);
    case 4096: return launch<4, 1024>(a, b, ml, nl, G, M, hfree, vfree, match, mismatch, go, ge, bp, tp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
