// K1: batched Myers bit-parallel edit distance (NW / SHW / HW).
//
// Replaces the Pallas kernel delly_tpu/ops/myers_pallas.py::_make_pallas
// (body :262-333, recurrence :291-318) and the on-device Peq packing of
// its pipeline (:67-127). The recurrence, the modes, the per-pair lengths
// and the qlen = 0 rule are those of the plain version, ops/myers.py.
//
// A query of W 32-row words (W = words_bucket(M), a power of two) is
// coded through the batch's byte -> letter table into Peq bit planes, one
// per letter (nalpha of them; a code >= nalpha reads an empty plane), kept
// in shared memory. Targets stay row-major (B, N): each block stages its
// pairs' target rows in chunks of 64 columns with 4-byte cp.async copies
// into rows padded to 17 words, so one warp's reads of a column fall in
// distinct banks, and the next chunk is in flight while the current one
// computes. Two layouts, chosen on the host (ops/myers_cuda.py
// launch_geometry, which also sizes the shared memory):
//
// - thread: one thread per pair (queries of up to 64 rows, W <= 2; the
//   genotyping probes). The block first stages its query rows in shared
//   memory with 16-byte coalesced loads; each thread builds its planes,
//   laid out [letter][word][thread], from there. It reads 4 target
//   columns per 32-bit load.
// - lanes: a group of Gl = min(W, 32) lanes per pair (W >= 4; queries of
//   65 to 8,192 rows), lane l holding words l*WL ... l*WL + WL - 1, WL =
//   W/Gl: up to 8 words a lane at W = 256, where one pair's 17 Peq planes
//   take 17,408 bytes of shared memory (a block of one warp, one pair).
//   The words run the diagonal wavefront of the plain version: at step s
//   word w = l*WL + k updates column s - w, taking its carry-in from word
//   w-1's carry-out of the step before, in a register within a lane and
//   by a shuffle of the lane's top word between lanes. A lane's words
//   are thus independent within a step and their chains run side by
//   side; a pair takes tlen + W - 1 steps. Each step loads the next
//   step's planes (word 0's from the letter fetched the step before,
//   word k's at word k-1's letter) and the letter after that, so no load
//   waits on the carry. The targets are staged into a ring of 8 chunks a
//   pair, coded to letters as each chunk arrives, a chunk ahead of the
//   steps that read it; columns before 0 read the empty letter. Each lane
//   reads its own words' 32 query bytes (a whole sector) and builds its
//   own planes; the lane holding bit qlen-1 keeps the score (its word's
//   bit picked by a mask each step) and the result.
//
// Queries of more than 8,192 rows run as strips of 8,192 rows, one launch
// of the W = 256 lanes kernel each, from the bottom strip (rows 0 ...
// 8,191) up. A strip writes the horizontal carry-out of its top word for
// every column, one signed byte per (pair, column), and the next strip
// takes it as its carry-in at row 0 in place of the mode's constant; the
// carries are staged beside the target bytes (only the W = 256 kernel
// holds the code for them). The strip holding row qlen keeps the score
// and writes the result; a pair skips the strips above its query. Column
// by column this is the recurrence of one tall query, so the distances
// are those of the plain version at any width.
//
// Bound on the H100: operations, about 24 per Myers word and column
// (chip_smoke.py counts them); the bytes of the pairs, read once, weigh
// about a sixth of that at the genotyping shape. The design keeps the
// operands in shared memory and registers so the column loop waits on
// no global load, and spreads long queries over lanes so their words'
// chains run side by side. With fewer pairs than SMs (one warp an SM, as
// in msaEdlib's calls of 105 pairs) a lanes step is bound by its latency
// instead: one word's carry chain and a shuffle, ~85 cycles a step on
// the H100 against ~410 when a step waited on its loads and on its
// words one after another.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxAlpha = 16;   // letter codes >= nalpha have an empty plane
constexpr int kBig = 1 << 20;
constexpr int kChunk = 64;      // target columns per staged chunk
constexpr int kRowWords = 17;   // a staged row: 64 columns and 4 bytes pad

struct Args {
  const uint8_t* q;      // (B, M) query bytes
  const int32_t* qlens;
  const uint8_t* t;      // (B, N) target bytes, row-major
  const int32_t* tlens;
  const uint8_t* lut;    // 256 byte -> letter code
  const int8_t* cin;     // (B, N) carries into row r0, or null (r0 = 0)
  int8_t* cout;          // (B, N) carries out of the strip, or null (top)
  int32_t* out;
  int B, M, N, mode, nalpha;
  int r0;                // first query row of this strip
  int qvec;              // q 16-byte aligned and M % 32 == 0
  int tvec;              // t and cin 4-byte aligned and N % 4 == 0
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Columns [j0, j0 + 64) of the (B, N) byte rows `src` of pairs b0 ...
// b0 + np - 1 (the targets, or a strip's carries) into `buf` (row p at
// p * kRowWords words); columns past N are left unwritten, and never read.
__device__ __forceinline__ void stage_rows(const Args& a, const void* src,
                                           uint32_t* buf, int b0, int np,
                                           int j0) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  if (a.tvec) {
    const int per = min(kChunk, a.N - j0) >> 2;
    for (int e = threadIdx.x; e < np * 16; e += blockDim.x) {
      const int p = e >> 4, u = e & 15;
      if (u < per)
        cp_async4(buf + p * kRowWords + u,
                  s + (size_t)(b0 + p) * a.N + j0 + 4 * u);
    }
  } else {
    uint8_t* bb = reinterpret_cast<uint8_t*>(buf);
    for (int e = threadIdx.x; e < np * kChunk; e += blockDim.x) {
      const int p = e >> 6, u = e & 63;
      if (j0 + u < a.N)
        bb[p * 4 * kRowWords + u] = s[(size_t)(b0 + p) * a.N + j0 + u];
    }
  }
}

// One Myers column over words first ... first + NW - 1 of one pair, the
// carry-in `hin` (+-1 or 0) in and the carry-out returned; `delta` takes
// the score's step at bit hb of word hw when it is among them. Words
// above hw are updated too: a word's carry goes only upward, so they never
// reach the score, and updating them costs less than testing for them.
template <int NW>
__device__ __forceinline__ int column(const uint32_t (&eq)[NW],
                                      uint32_t (&pv)[NW], uint32_t (&mv)[NW],
                                      int hin, int first, int hw,
                                      uint32_t hb, int& delta) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t p = pv[k], mm = mv[k];
    const uint32_t hneg = hin < 0 ? 1u : 0u;
    const uint32_t hpos = hin > 0 ? 1u : 0u;
    const uint32_t xv = eq[k] | mm;
    const uint32_t eq2 = eq[k] | hneg;
    const uint32_t xh = (((eq2 & p) + p) ^ p) | eq2;
    uint32_t ph = mm | ~(xh | p);
    uint32_t mh = p & xh;
    const int hout = (int)(ph >> 31) - (int)(mh >> 31);
    if (first + k == hw)
      delta = (int)((ph >> hb) & 1u) - (int)((mh >> hb) & 1u);
    ph = (ph << 1) | hpos;
    mh = (mh << 1) | hneg;
    pv[k] = mh | ~(xv | ph);
    mv[k] = ph & xv;
    hin = hout;
  }
  return hin;
}

__device__ __forceinline__ void track(int mode, int j, int tlen, int score,
                                      int& res) {
  if (mode == 0) {
    if (j + 1 == tlen) res = score;
  } else {
    res = score < res ? score : res;
  }
}

// ---------------------------------------------------------------------------
// thread layout: one thread per pair, W <= 2
// ---------------------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(128) myers_thread_kernel(Args a) {
  extern __shared__ uint32_t dyn[];
  __shared__ uint8_t s_lut[256];
  __shared__ int s_tmax;
  const int P = blockDim.x, tid = threadIdx.x;
  const int b0 = blockIdx.x * P;
  const int np = min(P, a.B - b0);
  uint32_t* peq = dyn;                                // [nalpha+1][W][P]
  uint32_t* ring = dyn + (a.nalpha + 1) * W * P;      // [2][P][kRowWords]
  for (int i = tid; i < 256; i += P) s_lut[i] = a.lut[i];
  if (tid == 0) s_tmax = 0;
  // the block's query rows, row p at ring + p * qs words (qs odd)
  const int qs = ((a.M + 3) >> 2) | 1;
  if (a.qvec) {
    const uint4* src = reinterpret_cast<const uint4*>(a.q + (size_t)b0 * a.M);
    for (int e = tid; e < np * a.M / 16; e += P) {
      const uint4 v = src[e];
      const int off = e * 16, p = off / a.M, w = p * qs + (off - p * a.M) / 4;
      ring[w] = v.x;
      ring[w + 1] = v.y;
      ring[w + 2] = v.z;
      ring[w + 3] = v.w;
    }
  } else {
    uint8_t* rb = reinterpret_cast<uint8_t*>(ring);
    for (int e = tid; e < np * a.M; e += P) {
      const int p = e / a.M;
      rb[p * 4 * qs + e - p * a.M] = a.q[(size_t)b0 * a.M + e];
    }
  }
  __syncthreads();
  const bool live = tid < np;
  const int b = b0 + tid;
  const int qlen = live ? a.qlens[b] : 0;
  const int tlen = live ? a.tlens[b] : 0;
  const int tl = max(0, min(tlen, a.N));   // columns this pair reads
  if (tl) atomicMax(&s_tmax, tl);
  for (int pl = 0; pl <= a.nalpha; ++pl)
#pragma unroll
    for (int w = 0; w < W; ++w) peq[(pl * W + w) * P + tid] = 0u;
  {
    const uint32_t* qrow = ring + tid * qs;
    const int qn = min(qlen, a.M);
#pragma unroll 1
    for (int i4 = 0; i4 < qn; i4 += 4) {
      const uint32_t x = qrow[i4 >> 2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i4 + e;
        const int c = s_lut[(x >> (8 * e)) & 255u];
        if (i < qn && c < a.nalpha)
          peq[(c * W + (i >> 5)) * P + tid] |= 1u << (i & 31);
      }
    }
  }
  __syncthreads();   // planes built, query rows read: the ring takes targets

  const int hw = (qlen - 1) >> 5;
  const uint32_t hb = (uint32_t)((qlen - 1) & 31);
  uint32_t pv[W], mv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pv[w] = 0xFFFFFFFFu;
    mv[w] = 0u;
  }
  int score = qlen;
  int res = a.mode == 0 ? (tlen == 0 ? qlen : kBig) : qlen;
  const int hin0 = a.mode == 2 ? 0 : 1;
  const int nchunks = (s_tmax + kChunk - 1) / kChunk;
  if (nchunks) stage_rows(a, a.t, ring, b0, np, 0);
  cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks)
      stage_rows(a, a.t, ring + ((k + 1) & 1) * P * kRowWords, b0, np,
                 (k + 1) * kChunk);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const uint32_t* row = ring + (k & 1) * P * kRowWords + tid * kRowWords;
    const int jn = min(kChunk, tl - k * kChunk);
    auto step = [&](int c, int j) {
      c = min(c, a.nalpha);
      uint32_t eq[W];
#pragma unroll
      for (int w = 0; w < W; ++w) eq[w] = peq[(c * W + w) * P + tid];
      int delta = 0;
      column<W>(eq, pv, mv, hin0, 0, hw, hb, delta);
      score += delta;
      track(a.mode, j, tlen, score, res);
    };
    int c4 = 0;
#pragma unroll 1
    for (; c4 + 4 <= jn; c4 += 4) {   // 4 columns per 32-bit load
      const uint32_t x = row[c4 >> 2];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        step(s_lut[(x >> (8 * e)) & 255u], k * kChunk + c4 + e);
    }
#pragma unroll 1
    for (; c4 < jn; ++c4)
      step(s_lut[reinterpret_cast<const uint8_t*>(row)[c4]], k * kChunk + c4);
    __syncthreads();   // done with this buffer before it is refilled
  }
  if (live) a.out[b] = qlen <= 0 ? (a.mode == 0 ? tlen : 0) : res;
}

// ---------------------------------------------------------------------------
// lanes layout: Gl = min(W, 32) lanes per pair, W / Gl words per lane
// ---------------------------------------------------------------------------

constexpr int kRing = 8;                        // staged chunks a pair
constexpr int kRingBytes = kRing * kChunk;      // columns j % 512
// a pair's ring and, past its end, a copy of its first 8 bytes (so 8
// steps read on from any position without wrapping), padded to an odd
// number of words: the pairs' rings in distinct banks
constexpr int kRingWords = kRingBytes / 4 + 3;

// Columns [j0, j0 + 64) of the (B, N) byte rows `src` of pairs b0 ...
// b0 + np - 1 into their rings in `buf` (pair p's at p * kRingWords
// words, column j at byte j % kRingBytes); columns past N are left
// unwritten.
__device__ __forceinline__ void stage_ring(const Args& a, const void* src,
                                           uint32_t* buf, int b0, int np,
                                           int j0) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const int off = j0 & (kRingBytes - 1);
  if (a.tvec) {
    const int per = min(kChunk, a.N - j0) >> 2;
    for (int e = threadIdx.x; e < np * 16; e += blockDim.x) {
      const int p = e >> 4, u = e & 15;
      if (u < per)
        cp_async4(buf + p * kRingWords + (off >> 2) + u,
                  s + (size_t)(b0 + p) * a.N + j0 + 4 * u);
    }
  } else {
    uint8_t* bb = reinterpret_cast<uint8_t*>(buf);
    for (int e = threadIdx.x; e < np * kChunk; e += blockDim.x) {
      const int p = e >> 6, u = e & 63;
      if (j0 + u < a.N)
        bb[p * 4 * kRingWords + off + u] = s[(size_t)(b0 + p) * a.N + j0 + u];
    }
  }
}

// One Myers word for one column, in the lanes layout's form: the carry
// in from the word below as that word's ph (bit 31: +1) and hn (its mh's
// bit 31: -1); ph and mh before their shift are kept as the carry up.
__device__ __forceinline__ void lane_word(uint32_t eq, uint32_t& pv,
                                          uint32_t& mv, uint32_t cp,
                                          uint32_t hn, uint32_t& ph,
                                          uint32_t& mh) {
  const uint32_t xv = eq | mv;
  const uint32_t eq2 = eq | hn;
  const uint32_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
  const uint32_t h = mv | ~(xh | pv);
  const uint32_t m = pv & xh;
  const uint32_t hs = __funnelshift_l(cp, h, 1);   // (h << 1) | hp
  const uint32_t ms = (m << 1) | hn;
  pv = ms | ~(xv | hs);
  mv = hs & xv;
  ph = h;
  mh = m;
}

// a carry of -1, 0 or +1 as the (ph, hn) bits of a word below
__device__ __forceinline__ uint32_t carry_bits(int h) {
  return h > 0 ? 0x80000000u : h < 0 ? 1u : 0u;
}

template <int W>
__global__ void __launch_bounds__(128) myers_lanes_kernel(Args a) {
  constexpr int GL = W < 32 ? W : 32;
  constexpr int WL = W / GL;
  constexpr bool kStrips = W == 256;   // only W = 256 runs in strips
  extern __shared__ uint32_t dyn[];
  __shared__ uint8_t s_lut[256];
  __shared__ int s_tmax;
  const int P = blockDim.x / GL, tid = threadIdx.x;
  const int p = tid / GL, l = tid % GL;
  const int b0 = blockIdx.x * P;
  const int np = min(P, a.B - b0);
  const int nalpha = a.nalpha;
  // plane c, word (l, k) of pair p: conflict-free across a warp's lanes
  uint32_t* peq = dyn + p * W + l;                   // [nalpha+1][P][W]
  const int pstride = P * W;
  uint32_t* ring = dyn + (nalpha + 1) * P * W;       // [P][kRingWords]
  uint32_t* cring = ring + P * kRingWords;           // carries, if cin
  for (int i = tid; i < 256; i += blockDim.x) s_lut[i] = a.lut[i];
  // the rings start as the empty letter, which columns below 0 read
  for (int i = tid; i < P * kRingWords; i += blockDim.x)
    ring[i] = 0x01010101u * (uint32_t)nalpha;
  if (tid == 0) s_tmax = 0;
  __syncthreads();
  const bool live = p < np;
  const int b = b0 + p;
  const int qlen = live ? a.qlens[b] : 0;
  const int tlen = live ? a.tlens[b] : 0;
  // the strip's rows of the query; a strip above the query has no work
  const int qrel = qlen - a.r0;
  const bool holds = qlen <= 0 ? a.r0 == 0 : qrel >= 1 && qrel <= 32 * W;
  const int tl = qrel > 0 || a.r0 == 0 ? max(0, min(tlen, a.N)) : 0;
  if (l == 0 && tl) atomicMax(&s_tmax, tl);
  // this lane's words of every plane, from its own 32 query bytes a word
  for (int pl = 0; pl <= nalpha; ++pl)
#pragma unroll
    for (int k = 0; k < WL; ++k) peq[pl * pstride + k * GL] = 0u;
  const int qn = max(0, min(min(qlen, a.M) - a.r0, 32 * W));
  const uint8_t* qrow = a.q + (size_t)b * a.M + a.r0;
#pragma unroll 1
  for (int k = 0; k < WL; ++k) {
    const int base = 32 * (l * WL + k);
    if (base >= qn) break;
    uint32_t* dst = peq + k * GL;
    if (a.qvec) {
      const uint4* src = reinterpret_cast<const uint4*>(qrow + base);
      const uint4 v0 = src[0], v1 = src[1];
      const uint32_t x[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = s_lut[(x[i >> 2] >> (8 * (i & 3))) & 255u];
        if (base + i < qn && c < nalpha) dst[c * pstride] |= 1u << i;
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < 32 && base + i < qn; ++i) {
        const int c = s_lut[qrow[base + i]];
        if (c < nalpha) dst[c * pstride] |= 1u << i;
      }
    }
  }
  __syncthreads();

  const int hw = (qrel - 1) >> 5;
  const uint32_t hb = (uint32_t)((qrel - 1) & 31);
  // the lane holding word hw; none in a strip below the score's row
  const int owner = !holds ? -1 : qlen > 0 ? hw / WL : 0;
  const int send = tl + hw;   // word hw is at column s - hw: steps before send
  uint32_t pick[WL];          // the score's bit in word hw, none elsewhere
  uint32_t pv[WL], mv[WL], ph[WL], mh[WL], eq[WL];
  const uint32_t* ad[WL];     // the plane each word reads this step
#pragma unroll
  for (int k = 0; k < WL; ++k) {
    pick[k] = qlen > 0 && l == owner && l * WL + k == hw ? 1u << hb : 0u;
    pv[k] = 0xFFFFFFFFu;
    mv[k] = ph[k] = mh[k] = eq[k] = 0u;
    ad[k] = peq + nalpha * pstride;   // the empty plane: before column 0
  }
  int score = qlen;
  int res = qlen;
  const uint32_t vin0 = a.mode == 2 ? 0u : 0x80000000u;   // row 0's +1
  const int tmax = s_tmax;
  // steps in groups of 8; those past tmax + W - 2 change no result
  const int nsteps = tmax ? (tmax + W + 6) & ~7 : 0;
  const int nchunks = (nsteps + kChunk - 1) / kChunk;
  const int tchunks = (tmax + kChunk - 1) / kChunk;
  uint32_t* const trow = ring + p * kRingWords;
  const uint8_t* const tb = reinterpret_cast<const uint8_t*>(trow);
  const int8_t* const cb =
      reinterpret_cast<const int8_t*>(cring + p * kRingWords);
  const int lag = l * WL;   // word k of this lane is at column s - lag - k
  auto stage = [&](int kc) {
    if (kc < tchunks) {
      stage_ring(a, a.t, ring, b0, np, kc * kChunk);
      if (kStrips && a.cin) stage_ring(a, a.cin, cring, b0, np, kc * kChunk);
    }
    cp_async_commit();
  };
  // chunk kc's target bytes to letter codes, by the lanes of their pair:
  // codes >= nalpha read the empty plane, as nalpha
  auto code = [&](int kc) {
    if (kc < tchunks) {
      uint32_t* w = trow + ((kc * kChunk) & (kRingBytes - 1)) / 4;
      for (int u = l; u < kChunk / 4; u += GL) {
        const uint32_t x = w[u];
        uint32_t y = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y |= (uint32_t)min((int)s_lut[(x >> (8 * e)) & 255u], nalpha)
               << (8 * e);
        w[u] = y;
        if (w == trow && u < 2) trow[kRingBytes / 4 + u] = y;   // the copy
      }
    }
    __syncwarp();
  };
  stage(0);
  stage(1);
  cp_async_wait1();
  __syncthreads();
  code(0);
  // step 0: word 0 at column -lag, the words above it before column 0
  ad[0] = peq + tb[-lag & (kRingBytes - 1)] * pstride;
  eq[0] = ad[0][0];
  int cn = tb[(1 - lag) & (kRingBytes - 1)];   // word 0's letter, step 1
  uint32_t vin = l ? 0u : kStrips && a.cin ? carry_bits(cb[0]) : vin0;

  for (int kc = 0; kc < nchunks; ++kc) {
    // steps of chunk kc read columns of chunks kc - W / 64 ... kc + 1,
    // coded here; chunk kc + 2 arrives meanwhile in an eighth buffer
    stage(kc + 2);
    cp_async_wait1();
    __syncthreads();
    code(kc + 1);
    const int s1 = min(nsteps, (kc + 1) * kChunk);
    // Step s: word k of lane l updates column s - lag - k, taking its
    // carry from word k - 1's column of step s - 1 (a register) or, for
    // word 0, from lane l - 1's top word of step s - 1 (a shuffle): the
    // words' chains run side by side, and only the top word's carry
    // crosses lanes. Each step loads the next step's planes and the
    // letter of the step after, so no load waits on the carry.
    for (int s8 = kc * kChunk; s8 < s1; s8 += 8) {
      const uint8_t* const tj = tb + ((s8 + 2 - lag) & (kRingBytes - 1));
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = s8 + u;
        uint32_t eqn[WL];
        const uint32_t* adn[WL];
        adn[0] = peq + cn * pstride;
#pragma unroll
        for (int k = 1; k < WL; ++k) adn[k] = ad[k - 1];
#pragma unroll
        for (int k = 0; k < WL; ++k) eqn[k] = adn[k][k * GL];
        cn = tj[u];
        const uint32_t v0 = kStrips && a.cin
                                ? carry_bits(cb[(s + 1) & (kRingBytes - 1)])
                                : vin0;
        uint32_t cp[WL], hn[WL];   // carries in: word k - 1's, step s - 1
        cp[0] = vin;
        hn[0] = vin & 1u;
#pragma unroll
        for (int k = 1; k < WL; ++k) {
          cp[k] = ph[k - 1];
          hn[k] = mh[k - 1] >> 31;
        }
#pragma unroll
        for (int k = 0; k < WL; ++k)
          lane_word(eq[k], pv[k], mv[k], cp[k], hn[k], ph[k], mh[k]);
        const uint32_t vout = (ph[WL - 1] & 0x80000000u) | (mh[WL - 1] >> 31);
        const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, vout, 1, GL);
        vin = l ? up : v0;
        if (kStrips && a.cout && l == GL - 1) {   // the strip above's carry
          const int j = s - (W - 1);
          if (j >= 0 && j < tl)
            a.cout[(size_t)b * a.N + j] =
                (int8_t)((int)(ph[WL - 1] >> 31) - (int)(mh[WL - 1] >> 31));
        }
        uint32_t sp = 0, sm = 0;
#pragma unroll
        for (int k = 0; k < WL; ++k) {
          sp |= ph[k] & pick[k];
          sm |= mh[k] & pick[k];
        }
        if (s < send) score += (int)(sp >> hb) - (int)(sm >> hb);
        res = min(res, score);
#pragma unroll
        for (int k = 0; k < WL; ++k) {
          ad[k] = adn[k];
          eq[k] = eqn[k];
        }
      }
    }
  }
  if (a.mode == 0)   // the score at column tlen - 1, where there is one
    res = tlen == 0 ? qlen : tlen >= 1 && tlen <= a.N ? score : kBig;
  if (live && l == owner)
    a.out[b] = qlen <= 0 ? (a.mode == 0 ? tlen : 0) : res;
}

template <typename Kernel>
int launch(Kernel kernel, const Args& a, int pairs, int threads, int smem,
           cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(a.B + pairs - 1) / pairs, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, M) uint8 query bytes; t: (B, N) uint8 target bytes, row-major;
// lut: 256 byte -> letter code, the batch's letters coded 0..nalpha-1.
// W: words per strip, a power of two in 1..256 with 32 * W >= M - r0.
// lanes, threads and smem as ops/myers_cuda.py launch_geometry gives
// them: lanes 1 (thread layout) for W <= 2, min(W, 32) (lanes layout)
// above. Queries of more than 8,192 rows: one call per strip of rows
// [r0, r0 + 32 W), W = 256, r0 = 0 first; cin, the (B, N) int8 carries
// of the strip below (null for r0 = 0); cout, this strip's (null for the
// top strip). Returns cudaError_t.
extern "C" int myers_launch(const void* q, int M, const void* qlens,
                            const void* t, int N, const void* tlens,
                            const void* lut, int nalpha, int B, int mode,
                            int W, int lanes, int threads, int smem, int r0,
                            const void* cin, void* cout, void* out,
                            void* stream) {
  if (B <= 0) return 0;
  Args a;
  a.q = static_cast<const uint8_t*>(q);
  a.qlens = static_cast<const int32_t*>(qlens);
  a.t = static_cast<const uint8_t*>(t);
  a.tlens = static_cast<const int32_t*>(tlens);
  a.lut = static_cast<const uint8_t*>(lut);
  a.cin = static_cast<const int8_t*>(cin);
  a.cout = static_cast<int8_t*>(cout);
  a.out = static_cast<int32_t*>(out);
  a.B = B;
  a.M = M;
  a.N = N;
  a.mode = mode;
  a.nalpha = nalpha;
  a.r0 = r0;
  a.qvec = ((uintptr_t)q % 16 == 0) && (M % 32 == 0);
  a.tvec = ((uintptr_t)t % 4 == 0) && ((uintptr_t)cin % 4 == 0) &&
           (N % 4 == 0);
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 0 || nalpha < 0 || nalpha > kMaxAlpha || mode < 0 ||
      mode > 2 || threads < 32 || threads > 128 || threads % 32)
    return (int)cudaErrorInvalidValue;
  // strips: W = 256 only, r0 a multiple of the strip, carries in above
  // the bottom strip and out below the top one
  if (r0 < 0 || r0 >= M || r0 % (32 * W) || (r0 > 0 && W != 256) ||
      (cin != nullptr) != (r0 > 0) || (cout != nullptr) != (M - r0 > 32 * W))
    return (int)cudaErrorInvalidValue;
  const int rows = 4 * kRowWords;   // bytes of a staged target row
  if (W <= 2) {                     // thread layout
    const int qs = ((M + 3) / 4) | 1;
    const int need = 4 * (nalpha + 1) * W * threads + 2 * threads * rows;
    if (lanes != 1 || smem < need || 4 * qs > 2 * rows)
      return (int)cudaErrorInvalidValue;
    const int n = threads;
    if (W == 1) return launch(myers_thread_kernel<1>, a, n, n, smem, st);
    return launch(myers_thread_kernel<2>, a, n, n, smem, st);
  }
  if (lanes != (W < 32 ? W : 32) || threads % lanes)
    return (int)cudaErrorInvalidValue;
  const int n = threads, pairs = threads / lanes;
  if (smem <
      4 * (nalpha + 1) * W * pairs + (cin ? 8 : 4) * pairs * kRingWords)
    return (int)cudaErrorInvalidValue;
  switch (W) {
    case 4: return launch(myers_lanes_kernel<4>, a, pairs, n, smem, st);
    case 8: return launch(myers_lanes_kernel<8>, a, pairs, n, smem, st);
    case 16: return launch(myers_lanes_kernel<16>, a, pairs, n, smem, st);
    case 32: return launch(myers_lanes_kernel<32>, a, pairs, n, smem, st);
    case 64: return launch(myers_lanes_kernel<64>, a, pairs, n, smem, st);
    case 128: return launch(myers_lanes_kernel<128>, a, pairs, n, smem, st);
    case 256: return launch(myers_lanes_kernel<256>, a, pairs, n, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}
