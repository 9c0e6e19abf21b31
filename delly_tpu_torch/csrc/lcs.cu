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
// Layout: one thread per pair, walking b's words from the lowest up in
// every row of a (its first m only), as lcs_many does. V and the match
// masks live in global scratch buffers that the wrapper allocates (the
// masks zeroed), word j of a pair at [j][pair] and mask word j of letter
// c at [c][j][pair], so that a warp's loads of one word are consecutive.
// Letters are coded by the host's byte -> letter table (as K1's), the
// masks built from b's first n bytes only, so padding never matches; a
// row whose letter b lacks leaves V as it is and is skipped.
//
// Bound on the H100: integer operations, about seven 32-bit ones per
// 64-bit word and row of a (chip_smoke.py LCS_OPS_PER_WORD, beside its
// count of this loop's SASS); the bytes of the pairs, read once, weigh
// far less. A pair's words run one after another, so a batch of few
// long pairs keeps few threads busy: a lane group per pair is the way
// to the bound, left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLutBytes = 256;
constexpr int kThreads = 128;

struct Args {
  const uint8_t* a;      // (B, M) bytes of the strings walked row by row
  const int32_t* alens;
  const uint8_t* b;      // (B, N) bytes of the strings coded into V
  const int32_t* blens;
  const uint8_t* lut;    // 256 byte -> letter code (>= nalpha: b lacks it)
  uint64_t* v;           // (W, B) scratch: V
  uint64_t* masks;       // (nalpha, W, B) scratch, zeroed: match masks
  int32_t* out;
  int B, M, N, nalpha;
};

__global__ void lcs_kernel(Args x) {
  __shared__ uint8_t lut[kLutBytes];
  for (int i = threadIdx.x; i < kLutBytes; i += blockDim.x) lut[i] = x.lut[i];
  __syncthreads();

  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= x.B) return;
  const int m = x.alens[p], n = x.blens[p];
  if (m <= 0 || n <= 0) {
    x.out[p] = 0;
    return;
  }
  const int64_t B = x.B;
  const int64_t plane = (int64_t)((x.N + 63) >> 6) * B;   // one letter's
  const int w = (n + 63) >> 6;
  uint64_t* __restrict__ v = x.v + p;
  uint64_t* __restrict__ masks = x.masks + p;

  const uint8_t* bp = x.b + p * x.N;
  for (int r = 0; r < n; ++r) {
    const int c = lut[bp[r]];
    if (c < x.nalpha) masks[c * plane + (r >> 6) * B] |= 1ull << (r & 63);
  }
  for (int j = 0; j < w; ++j) v[j * B] = ~0ull;

  const uint8_t* ap = x.a + p * x.M;
  for (int r = 0; r < m; ++r) {
    const int c = lut[ap[r]];
    if (c >= x.nalpha) continue;   // a letter b lacks: U = 0, V stays
    const uint64_t* __restrict__ mc = masks + c * plane;
    uint64_t carry = 0;
    for (int j = 0; j < w; ++j) {
      const uint64_t vj = v[j * B];
      const uint64_t u = vj & mc[j * B];
      const uint64_t s = vj + u;
      const uint64_t s2 = s + carry;
      carry = (uint64_t)(s < vj) | (uint64_t)(s2 < s);
      v[j * B] = s2 | (vj & ~u);
    }
  }

  // zero bits of V within b's first n positions
  int z = 0;
  for (int j = 0; j < w; ++j) {
    uint64_t word = ~v[j * B];
    if (j == w - 1 && (n & 63)) word &= (1ull << (n & 63)) - 1;
    z += __popcll(word);
  }
  x.out[p] = z;
}

}  // namespace

// a: (B, M) uint8; b: (B, N) uint8, both row-major; lut: 256 byte ->
// letter code, b's letters coded 0..nalpha-1 (0 <= nalpha <= 256), any
// other byte >= nalpha. v: a (ceil(N / 64), B) uint64 scratch buffer;
// masks: a (nalpha, ceil(N / 64), B) uint64 one, zeroed (null when
// nalpha = 0). Returns cudaError_t.
extern "C" int lcs_launch(const void* a, int M, const void* alens,
                          const void* b, int N, const void* blens,
                          const void* lut, int nalpha, int B, void* v,
                          void* masks, void* out, void* stream) {
  if (B <= 0) return 0;
  if (M < 1 || N < 1 || nalpha < 0 || nalpha > 256 || v == nullptr ||
      (masks == nullptr && nalpha > 0))
    return (int)cudaErrorInvalidValue;
  Args x;
  x.a = static_cast<const uint8_t*>(a);
  x.alens = static_cast<const int32_t*>(alens);
  x.b = static_cast<const uint8_t*>(b);
  x.blens = static_cast<const int32_t*>(blens);
  x.lut = static_cast<const uint8_t*>(lut);
  x.v = static_cast<uint64_t*>(v);
  x.masks = static_cast<uint64_t*>(masks);
  x.out = static_cast<int32_t*>(out);
  x.B = B;
  x.M = M;
  x.N = N;
  x.nalpha = nalpha;
  const int grid = (B + kThreads - 1) / kThreads;
  lcs_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x);
  return (int)cudaGetLastError();
}
