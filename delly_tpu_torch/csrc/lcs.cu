// X1: batched LCS lengths, bit-parallel (the MSA's similarity matrix).
//
// Replaces delly_tpu/ops/msa.py::_lcs_device_fn (:39-66), XLA code that
// scans the rows of a with an in-row prefix max (jax.lax.scan over
// jax.lax.associative_scan), and its plain PyTorch version
// ops/msa.py::lcs_plain. For each pair i it returns the length of the
// longest common subsequence of a[i, :alens[i]] and b[i, :blens[i]],
// exactly.
//
// The recurrence is the bit-parallel one of the host's lcs_many
// (native/hostio.cpp): V holds one bit per position of b, all set at the
// start; for each character c of a, U = V & Match[c] and
// V = (V + U) | (V - U); the LCS length is the number of zero bits of V
// within b's first n positions. U is a subset of V's bits, so V - U never
// borrows and equals V & ~U: only the carry of the add crosses words.
//
// Layouts (kLayouts; ops/lcs_cuda.py schedule picks one per pair from
// b's length): a group of G lanes owns a pair, lane l holding words
// K l ... K l + K - 1 of V in registers; G = 1 is one thread per pair
// (b of up to 256 bases, K = 1 ... 4 words), G = 2 ... 32 lanes run
// longer b. The words run the rows as a wavefront in which every word
// is a cell: at step s word k of lane l takes row s - (K l + k), with
// the carry that the word below carried out of that row at the step
// before (from lane l-1's top word by one shuffle). No carry then
// crosses two words within a step, so a step's words are independent;
// a pair takes m + G K - 1 steps. A word's row (a pointer to its
// letter's masks) moves up a word a step; lane l reads the bytes of a
// for its word 0 itself, three rows ahead. b longer than 32 x 8 words (16,384
// bases) runs in the last layout in strips of that many words, one
// after the other in the same warp: a strip hands the carry-out of its
// top word in each row to the next strip as one bit per row, through a
// buffer the wrapper allocates and the kernel writes before it reads.
//
// One warp per block. A launch holds segments of pairs, each segment one
// layout; the wrapper sorts the pairs so that a warp's pairs share a
// layout and have close lengths, and passes the permutation (`order`)
// unless the caller already sorted them. Each warp builds the match
// masks of its lanes' words from b's first n bytes (so padding never
// matches) in shared memory, `[letter][word][lane]`, conflict-free, or,
// where (nalpha + 1) x K x 32 x 8 bytes exceed kSmemMasks, in a per-warp
// region of a global buffer (L2-resident) that it zeroes itself; letters
// are coded by the host's byte -> letter table, letter nalpha (no row,
// or a letter b lacks) has no match, so such a row leaves V as it is. A
// word's masks for its next row are loaded a step ahead.
//
// Bound on the H100: integer operations, about seven 32-bit ones per
// 64-bit word and row of a (chip_smoke.py LCS_OPS_PER_WORD, beside its
// count of the step loop's SASS); the bytes of the pairs, read once,
// weigh far less. A pair's rows are serial, so a batch of few long pairs
// is held to a chain floor: its longest pair's steps times one dependent
// step (a 64-bit add with the carry in and out, and a shuffle).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// (G lanes per pair, K words per lane), in the order of
// ops/lcs_cuda.py LAYOUTS; the last one runs strips
constexpr int kLayouts = 11;
constexpr int kG[kLayouts] = {1, 1, 1, 1, 2, 4, 8, 16, 32, 32, 32};
constexpr int kK[kLayouts] = {1, 2, 3, 4, 4, 4, 4, 4, 4, 6, 8};
constexpr int kStripWords = 32 * 8;
constexpr int kSmemMasks = 64 * 1024;   // mask bytes a warp keeps in shared

// the block's letter codes of bytes, clamped to nalpha (no match)
__shared__ uint8_t s_lut[256];

struct Seg {
  int layout;
  int first;   // first slot of the segment in the sorted order
  int count;   // pairs
  int warp0;   // first warp (block)
};

struct Args {
  const uint8_t* a;      // (B, M) bytes of the strings walked row by row
  const int32_t* alens;
  const uint8_t* b;      // (B, N) bytes of the strings coded into V
  const int32_t* blens;
  const uint8_t* lut;    // 256 byte -> letter code (>= nalpha: b lacks it)
  const int32_t* order;  // slot -> pair, or null (slot i is pair i)
  uint64_t* gmasks;      // per-warp mask tables, or null (shared memory)
  uint32_t* carry;       // strips: 2 x ceil(M / 32) words per warp, or null
  int32_t* out;
  int M, N, nalpha, kmax, nsegs;
  Seg seg[kLayouts];
};

// The add's carry chain in the carry flag: set it, add words with it in
// and out, read it (the flag lives from one asm statement to the next,
// and the compiler emits no other instruction that writes it).
__device__ __forceinline__ void set_carry(uint32_t c) {
  uint32_t t;
  asm volatile("add.cc.u32 %0, %1, 0xFFFFFFFF;" : "=r"(t) : "r"(c));
}
__device__ __forceinline__ uint64_t addc64(uint64_t a, uint64_t b) {
  uint32_t lo, hi;
  asm volatile(
      "addc.cc.u32 %0, %2, %4;\n\t"
      "addc.cc.u32 %1, %3, %5;"
      : "=r"(lo), "=r"(hi)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)));
  return ((uint64_t)hi << 32) | lo;
}
__device__ __forceinline__ uint32_t get_carry() {
  uint32_t c;
  asm volatile("addc.u32 %0, %1, %1;" : "=r"(c) : "r"(0u));
  return c;
}

// A shared-memory address, and a byte's letter code read at one: the
// table's 32-bit address is taken once, not formed again at each read.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ int lut_code(uint32_t lut, int byte) {
  uint32_t c;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(c) : "r"(lut + byte));
  return (int)c;
}

// The rows of a over this lane's K words v of one strip, as a wavefront
// of `steps` steps in which every word is a cell: at step s word k of
// lane l takes row j = s - (K l + k), with the carry-in that word k-1
// (of lane l-1 for k = 0, by a shuffle) carried out of that row at the
// step before, so no carry crosses two words within a step. mk: the
// lane's masks, letter c and word k at mk[(c * K + k) * 32], letter
// nalpha all zero. CARRY (strips): word 0 of lane 0 takes row j's
// carry-in from bit j of cin_bits, the top word of lane G-1 writes its
// carry-out to bit j of cout_bits (either may be null).
template <int G, int K, bool CARRY>
__device__ __forceinline__ void rows(const uint8_t* ap,
                                     int m, int l, int steps, int nalpha,
                                     const uint64_t* mk, uint64_t (&v)[K],
                                     const uint32_t* cin_bits,
                                     uint32_t* cout_bits) {
  // the code of row j, from its byte: rows outside [0, m) have none (the
  // byte is read at a row clamped into the string, so that the load and
  // the lookup need no select on their results)
  const int last = max(m - 1, 0);
  auto byte_at = [&](int j) -> int { return ap[min(max(j, 0), last)]; };
  const uint32_t lut = smem_addr(s_lut);
  auto code_at = [&](int j, int code) -> int {
    return j >= 0 && j < m ? code : nalpha;
  };
  const int lag = K * l;   // word 0's row lags the step by K l
  uint32_t cword = 0, cword_next = 0, cacc = 0;
  if (CARRY && cin_bits && l == 0 && m > 0) {
    cword = cin_bits[0];
    cword_next = m > 32 ? cin_bits[1] : 0u;
  }
  // each word's row: its letter's masks (row[k], word k at row[k][k *
  // 32]), the masks themselves (cur) and those of its next row (nxt),
  // loaded during the step; carry into each word
  const uint64_t* row[K];
  uint64_t ma[K], mb[K];
  uint32_t carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = -lag - k;
    row[k] = mk + code_at(j, lut_code(lut, byte_at(j))) * K * 32;
    ma[k] = row[k][k * 32];
    carry[k] = 0u;
  }
  if (CARRY && cin_bits && l == 0 && m > 0) carry[0] = cword & 1u;
  // word 0's codes at steps s + 1 and s + 2 and bytes at s + 3 and s + 4,
  // kept by the parity of the step so that no register is copied while
  // its load is in flight
  int ca = lut_code(lut, byte_at(1 - lag));
  int cb = lut_code(lut, byte_at(2 - lag));
  int ba = byte_at(3 - lag), bb = byte_at(4 - lag);
  auto step = [&](int s, const uint64_t (&cur)[K], uint64_t (&nxt)[K],
                  int& cnext, int& bnext) {
    // word 0's next row; word k's is word k-1's row
    const uint64_t* next0 = mk + code_at(s + 1 - lag, cnext) * K * 32;
#pragma unroll
    for (int k = 0; k < K; ++k) nxt[k] = (k ? row[k - 1] : next0)[k * 32];
    // V = (V + U + carry) | (V & ~U), U = V & Match[c], word by word; no
    // row, or a letter b lacks, has U = 0 and carry 0: V stays
    uint32_t cy[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      set_carry(carry[k]);
      v[k] = addc64(v[k], v[k] & cur[k]) | (v[k] & ~cur[k]);
      cy[k] = get_carry();
    }
    // carries move a word up and a step on; the top word's to the next
    // lane, and into lane 0 the strip below's (or none)
#pragma unroll
    for (int k = K - 1; k > 0; --k) carry[k] = cy[k - 1];
    uint32_t c0 = 0;
    if constexpr (G > 1) c0 = __shfl_up_sync(0xFFFFFFFFu, cy[K - 1], 1, G);
    if (l == 0) c0 = 0;
    if constexpr (CARRY) {
      const int jt = s - lag - (K - 1);   // the top word's row
      if (cout_bits && l == G - 1 && jt >= 0 && jt < m) {
        cacc |= cy[K - 1] << (jt & 31);
        if ((jt & 31) == 31 || jt == m - 1) {
          cout_bits[jt >> 5] = cacc;
          cacc = 0;
        }
      }
      const int j = s + 1;   // lane 0's word 0's next row
      if (cin_bits && l == 0 && j < m) {
        if ((j & 31) == 0) {
          cword = cword_next;
          cword_next = j + 32 < m ? cin_bits[(j >> 5) + 1] : 0u;
        }
        c0 = (cword >> (j & 31)) & 1u;
      }
    }
    carry[0] = c0;
#pragma unroll
    for (int k = K - 1; k > 0; --k) row[k] = row[k - 1];
    row[0] = next0;
    cnext = lut_code(lut, bnext);   // step s + 3's, unless out of a
    bnext = byte_at(s + 5 - lag);
  };
  int s = 0;
#pragma unroll 1
  for (; s + 1 < steps; s += 2) {   // two steps, the buffers swapped
    step(s, ma, mb, ca, ba);
    step(s + 1, mb, ma, cb, bb);
  }
  if (s < steps) step(s, ma, mb, ca, ba);
}

// One pair per group of G lanes (32 / G pairs per warp), K words a lane.
template <int G, int K>
__device__ __forceinline__ void run(const Args& x, uint64_t* tab,
                                    const Seg& sg, int wseg) {
  constexpr int P = 32 / G;
  const int lane = threadIdx.x, gp = lane / G, l = lane % G;
  const int slot = wseg * P + gp;
  const bool live = slot < sg.count;
  const int pair = !live ? 0
                   : x.order ? x.order[sg.first + slot] : sg.first + slot;
  const int m = live ? min(max(x.alens[pair], 0), x.M) : 0;
  const int n = live ? min(max(x.blens[pair], 0), x.N) : 0;
  const int nalpha = x.nalpha;
  // strips: the last layout only, whose warp holds one pair
  const int strips =
      G == 32 ? max(1, ((n + 63) / 64 + kStripWords - 1) / kStripWords) : 1;
  int steps = m > 0 ? m + G * K - 1 : 0;
  if constexpr (G > 1) steps = __reduce_max_sync(0xFFFFFFFFu, steps);
  const uint8_t* ap = x.a + (size_t)pair * x.M;
  const uint8_t* bp = x.b + (size_t)pair * x.N;
  uint64_t* mk = tab + lane;   // letter c, word k at mk[(c * K + k) * 32]
  const int cwords = (x.M + 31) / 32;
  uint32_t* cbuf = x.carry ? x.carry + (size_t)blockIdx.x * 2 * cwords
                           : nullptr;
  int zeros = 0;
  for (int t = 0; t < strips; ++t) {
    const int w0 = (t * G + l) * K;   // this lane's first word of V
    for (int i = 0; i < (nalpha + 1) * K; ++i) mk[i * 32] = 0ull;
    const int p1 = min((w0 + K) * 64, n);
    for (int p = w0 * 64; p < p1; ++p) {
      const int c = s_lut[bp[p]];
      if (c < nalpha) mk[(c * K + (p >> 6) - w0) * 32] |= 1ull << (p & 63);
    }
    uint64_t v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = ~0ull;
    if (strips == 1) {
      rows<G, K, false>(ap, m, l, steps, nalpha, mk, v, nullptr,
                        nullptr);
    } else if constexpr (G == 32) {
      // the strip below's carries in, this strip's out, a bit per row
      rows<G, K, true>(ap, m, l, steps, nalpha, mk, v,
                       t > 0 ? cbuf + ((t - 1) & 1) * cwords : nullptr,
                       t + 1 < strips ? cbuf + (t & 1) * cwords : nullptr);
    }
    // zero bits of V within b's first n positions
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int bits = min(max(n - (w0 + k) * 64, 0), 64);
      if (bits)
        zeros += __popcll(~v[k] & (bits == 64 ? ~0ull : (1ull << bits) - 1));
    }
    __syncwarp();   // this strip's carries out before the next reads them
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      zeros += __shfl_down_sync(0xFFFFFFFFu, zeros, o, G);
  }
  if (live && l == 0) x.out[pair] = zeros;
}

__global__ void __launch_bounds__(32) lcs_kernel(const Args x) {
  extern __shared__ uint64_t smem[];
  for (int i = threadIdx.x; i < 256; i += 32)
    s_lut[i] = (uint8_t)min((int)x.lut[i], x.nalpha);
  __syncwarp();
  int i = 0;
  while (i + 1 < x.nsegs && (int)blockIdx.x >= x.seg[i + 1].warp0) ++i;
  const Seg sg = x.seg[i];
  const int wseg = blockIdx.x - sg.warp0;
  // the masks' table, inlined twice so that the shared one is addressed
  // as shared memory
  auto layout = [&](uint64_t* tab) {
    switch (sg.layout) {
      case 0: run<1, 1>(x, tab, sg, wseg); break;
      case 1: run<1, 2>(x, tab, sg, wseg); break;
      case 2: run<1, 3>(x, tab, sg, wseg); break;
      case 3: run<1, 4>(x, tab, sg, wseg); break;
      case 4: run<2, 4>(x, tab, sg, wseg); break;
      case 5: run<4, 4>(x, tab, sg, wseg); break;
      case 6: run<8, 4>(x, tab, sg, wseg); break;
      case 7: run<16, 4>(x, tab, sg, wseg); break;
      case 8: run<32, 4>(x, tab, sg, wseg); break;
      case 9: run<32, 6>(x, tab, sg, wseg); break;
      case 10: run<32, 8>(x, tab, sg, wseg); break;
    }
  };
  if (x.gmasks)
    layout(x.gmasks + (size_t)blockIdx.x * (x.nalpha + 1) * x.kmax * 32);
  else
    layout(smem);
}

}  // namespace

// a: (B, M) uint8; b: (B, N) uint8, both row-major; lut: 256 byte ->
// letter code, b's letters coded 0..nalpha-1 (0 <= nalpha <= 256), any
// other byte >= nalpha. segs: nsegs x (layout, first slot, pairs) on the
// host, the slots 0 ... B-1 in order (ops/lcs_cuda.py schedule); order:
// (B,) int32 slot -> pair, or null. gmasks: null to keep the masks in
// shared memory ((nalpha + 1) x kmax x 256 bytes, at most kSmemMasks),
// else warps x (nalpha + 1) x kmax x 32 uint64, kmax the largest K of the
// segments.
// carry: warps x 2 x ceil(M / 32) uint32 when a segment of the last
// layout is launched with N > 16,384, else null. Nothing needs zeroing.
// Returns cudaError_t.
extern "C" int lcs_launch(const void* a, int M, const void* alens,
                          const void* b, int N, const void* blens,
                          const void* lut, int nalpha, int B,
                          const void* order, const int* segs, int nsegs,
                          void* gmasks, void* carry, void* out,
                          void* stream) {
  if (B <= 0) return 0;
  if (M < 1 || N < 1 || nalpha < 0 || nalpha > 256 || nsegs < 1 ||
      nsegs > kLayouts || segs == nullptr)
    return (int)cudaErrorInvalidValue;
  Args x;
  x.a = static_cast<const uint8_t*>(a);
  x.alens = static_cast<const int32_t*>(alens);
  x.b = static_cast<const uint8_t*>(b);
  x.blens = static_cast<const int32_t*>(blens);
  x.lut = static_cast<const uint8_t*>(lut);
  x.order = static_cast<const int32_t*>(order);
  x.gmasks = static_cast<uint64_t*>(gmasks);
  x.carry = static_cast<uint32_t*>(carry);
  x.out = static_cast<int32_t*>(out);
  x.M = M;
  x.N = N;
  x.nalpha = nalpha;
  x.nsegs = nsegs;
  int warps = 0, slots = 0, kmax = 1;
  bool strips = false;
  for (int i = 0; i < nsegs; ++i) {
    const int lay = segs[3 * i], first = segs[3 * i + 1],
              count = segs[3 * i + 2];
    if (lay < 0 || lay >= kLayouts || first != slots || count < 1)
      return (int)cudaErrorInvalidValue;
    x.seg[i] = Seg{lay, first, count, warps};
    warps += (count + 32 / kG[lay] - 1) / (32 / kG[lay]);
    slots += count;
    kmax = kK[lay] > kmax ? kK[lay] : kmax;
    strips = strips || (lay == kLayouts - 1 && N > kStripWords * 64);
  }
  x.kmax = kmax;
  const long long smem =
      gmasks ? 0 : (long long)(nalpha + 1) * kmax * 32 * 8;
  if (slots != B || smem > kSmemMasks || (strips && carry == nullptr))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lcs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  auto st = static_cast<cudaStream_t>(stream);
  lcs_kernel<<<warps, 32, (size_t)smem, st>>>(x);
  return (int)cudaGetLastError();
}
