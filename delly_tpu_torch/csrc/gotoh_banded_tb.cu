// K3-tb: traceback walk over the band tiles that K3 wrote.
//
// Replaces the XLA traceback delly_tpu/ops/gotoh_banded.py::_build_tb
// (:342-412) and follows the JAX package's host walk _walk_bits
// (:138-174), the preference order of the reference's gotoh.h:134-174:
// from S, a horizontal move if S==H, else a vertical move if S==V, else
// the diagonal; from H (V), move left (up) and return to S when the gap
// was opened at this cell; row 0 and column 0 walk straight to the
// origin. A cell outside the band [off(row), off(row) + B), or on row 0,
// reads as 0 (_build_tb instead clips the slot into the band).
//
// One thread per job walks its own m x B byte tile from (m, n),
// recomputing off(row) at every step, and writes the trace codes
// (0 = diagonal, 1 = H, 2 = V) in walk order, that is reversed, with
// their count. Only those codes return to the host.
//
// Bound on the H100: memory latency. Each step is one dependent byte
// load from the tile (at most m + n steps per job), so a walk costs a
// chain of loads; the batch's jobs run in parallel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuant = 128;

__device__ __forceinline__ int corridor_off(int r, int n, int m, int B) {
  int raw = r * n / m - B / 2;
  raw = raw > 0 ? raw : 0;
  return raw - raw % kQuant;
}

__global__ void banded_tb_kernel(const uint8_t* __restrict__ bits,
                                 const int32_t* __restrict__ mlen,
                                 const int32_t* __restrict__ nlen, int G,
                                 int M, int B, uint8_t* __restrict__ codes,
                                 int32_t* __restrict__ lens) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const uint8_t* tile = bits + (size_t)g * M * B;
  uint8_t* out = codes + (size_t)g * 2 * M;
  const int L = 2 * M;          // a valid walk emits m + n <= 2M codes
  const int cap = 4 * M + 8;    // and takes at most twice as many steps
  const int m = mlen[g], n = nlen[g];
  int row = m, col = n, last = 0, i = 0;
  for (int it = 0; (row > 0 || col > 0) && it < cap && i < L; ++it) {
    int b = 0;
    if (row > 0) {
      const int slot = col - corridor_off(row, n, m, B);
      if (slot >= 0 && slot < B) b = tile[(size_t)(row - 1) * B + slot];
    }
    if (last == 0) {
      if (row == 0 && col > 0) {
        last = 1;
      } else if (col == 0 && row > 0) {
        last = 2;
      } else if (b & 1) {
        last = 1;
      } else if (b & 2) {
        last = 2;
      } else {
        --row;
        --col;
        out[i++] = 0;
      }
    } else if (last == 1) {
      const bool opened = row == 0 ? col == 1 : (b & 4) != 0;
      if (opened) last = 0;
      --col;
      out[i++] = 1;
    } else {
      const bool opened = col == 0 ? row == 1 : (b & 8) != 0;
      if (opened) last = 0;
      --row;
      out[i++] = 2;
    }
  }
  lens[g] = i;
}

}  // namespace

// bits: (G, M, B) uint8 from gotoh_banded_launch; mlen/nlen: (G,) int32.
// Outputs codes (G, 2M) uint8 in walk order and lens (G,) int32.
// Returns cudaError_t.
extern "C" int gotoh_banded_tb_launch(const void* bits, const void* mlen,
                                      const void* nlen, int G, int M, int B,
                                      void* codes, void* lens, void* stream) {
  if (G <= 0) return 0;
  const int threads = 32;
  banded_tb_kernel<<<(G + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int32_t*>(mlen),
      static_cast<const int32_t*>(nlen), G, M, B,
      static_cast<uint8_t*>(codes), static_cast<int32_t*>(lens));
  return (int)cudaGetLastError();
}
