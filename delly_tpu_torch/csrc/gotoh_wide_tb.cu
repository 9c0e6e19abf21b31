// K4-tb: traceback walk over the direction tiles that K4 wrote.
//
// Replaces the host walk delly_tpu/ops/gotoh_device.py::_traceback
// (:101-139), which follows the preference order of the reference's
// gotoh.h:134-174, as K2-tb (gotoh_tb.cu) does: from S, a horizontal move
// if S==H, else a vertical move if S==V, else the diagonal; from H (V),
// move left (up) and return to S when the gap was opened at this cell.
// Row 0 and column 0 walk straight to the origin. The codes (0 =
// diagonal, 1 = H, 2 = V) go out in walk order, that is reversed, with
// their count; the tile never leaves the card.
//
// One warp per merge. K2-tb brings whole rows of its tile into shared
// memory; a row of K4's tile holds up to 16,384 bytes, so a window of two
// would hold two rows. The walk only moves up or left, so K4-tb reads a
// window of `rows` x `cols` bytes whose bottom right holds the walk's
// cell (the walk enters it at the bottom, or at the right, and leaves it
// at the top or the left): the warp loads it from global memory in
// 16-byte loads, a row's bytes side by side, and its first lane walks
// inside it through shared memory, a step per dependent byte load with
// K2-tb's step table (gotoh_common.cuh), until the walk leaves it; then
// the warp loads the next. The host sizes the window (ops/gotoh_wide_cuda
// tb_geometry). Each code goes straight to global memory.
//
// Bound on the H100: latency. A walk is a chain of at most mlen + nlen
// dependent shared-memory loads, and a window's loads (one round trip to
// L2 or device memory) every time it leaves one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gotoh_common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxN = 16384;
constexpr int kMaxWindow = 32 * 1024;   // bytes of the window, at most

__global__ void __launch_bounds__(32)
gotoh_wide_tb_kernel(const uint8_t* __restrict__ bits,
                     const int32_t* __restrict__ mlen,
                     const int32_t* __restrict__ nlen, int M, int N,
                     int rows, int cols, uint8_t* __restrict__ codes,
                     int32_t* __restrict__ lens) {
  extern __shared__ __align__(16) uint8_t win[];   // rows x cols bytes
  const int g = blockIdx.x, lane = threadIdx.x;
  const uint8_t* tile = bits + (size_t)g * M * N;
  uint8_t* out = codes + (size_t)g * (M + N);
  const int m = min(max(mlen[g], 0), M), n = min(max(nlen[g], 0), N);
  const int v16 = cols / 16;           // 16-byte loads per window row
  constexpr uint64_t kS = step_table(0), kH = step_table(1),
                     kV = step_table(2);
  int row = m, col = n, last = 0, i = 0;
  // A valid walk (mlen <= M, nlen <= N) emits at most mlen + nlen <= M + N
  // codes, the row of `codes` that the host gives it.
  while (row > 0 && col > 0) {
    // the window: tile rows r0 .. row - 1 and tile columns c0 .. c0 +
    // cols - 1, c0 a multiple of 16 with col - 1 in the window's last 16
    // (so c0 + cols <= N, as cols <= N)
    const int r0 = max(row - rows, 0);
    const int c0 = max(((col - 1) & ~15) + 16 - cols, 0);
    for (int k = lane; k < (row - r0) * v16; k += 32) {
      const int rr = k / v16, cc = k - rr * v16;
      reinterpret_cast<uint4*>(win + rr * cols)[cc] = __ldg(
          reinterpret_cast<const uint4*>(tile + (size_t)(r0 + rr) * N + c0) +
          cc);
    }
    __syncwarp();
    if (lane == 0) {
      // inside the window: a step looks up its move and next state for
      // its byte and moves p left (-1) and up (-cols)
      int p = (row - 1 - r0) * cols + (col - 1 - c0);
      do {
        const int b = win[p];
        const uint64_t tab = last == 0 ? kS : (last == 1 ? kH : kV);
        const int e = (int)(tab >> (4 * (b & 15))) & 15;
        const int dc = e & 1, dr = (e >> 1) & 1;
        last = e >> 2;
        out[i++] = dr ? (dc ? 0 : 2) : 1;
        col -= dc;
        row -= dr;
        p -= dc + dr * cols;
      } while (row > r0 && col > c0);
    }
    row = __shfl_sync(kFull, row, 0);
    col = __shfl_sync(kFull, col, 0);
    last = __shfl_sync(kFull, last, 0);
    i = __shfl_sync(kFull, i, 0);
    __syncwarp();                      // the window is read before the next
  }
  if (lane) return;
  // the rest, on row 0 or column 0, where no cell's bits are read
  while (row > 0 || col > 0) {
    if (last == 0) {
      last = row == 0 ? 1 : 2;
    } else if (last == 1) {
      if (row == 0 && col == 1) last = 0;
      --col;
      out[i++] = 1;
    } else {
      if (col == 0 && row == 1) last = 0;
      --row;
      out[i++] = 2;
    }
  }
  lens[g] = i;
}

}  // namespace

// bits: (G, M, N) uint8 from gotoh_wide_launch, 16-byte aligned, N a
// multiple of 16 and M, N <= 16,384; mlen/nlen: (G,) int32 with 0 <= mlen
// <= M and 0 <= nlen <= N. rows x cols: the window, as ops/gotoh_wide_cuda.py
// tb_geometry gives it (cols a multiple of 16 and at most N, rows x cols
// at most 32 KB). Outputs codes (G, M + N) uint8 in walk order and lens
// (G,) int32. Returns cudaError_t.
extern "C" int gotoh_wide_tb_launch(const void* bits, const void* mlen,
                                    const void* nlen, int G, int M, int N,
                                    int rows, int cols, void* codes,
                                    void* lens, void* stream) {
  if (G <= 0) return 0;
  if (M < 1 || M > kMaxN || N < 16 || N > kMaxN || N % 16 || cols < 16 ||
      cols % 16 || cols > N || rows < 1 || rows * cols > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  gotoh_wide_tb_kernel<<<G, 32, rows * cols,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int32_t*>(mlen),
      static_cast<const int32_t*>(nlen), M, N, rows, cols,
      static_cast<uint8_t*>(codes), static_cast<int32_t*>(lens));
  return (int)cudaGetLastError();
}
