// K2-tb: traceback walk over the direction tiles that K2 wrote.
//
// Replaces the XLA traceback delly_tpu/ops/gotoh_pallas.py::_build_tb
// (:209-279), which follows the preference order of the reference's
// gotoh.h:134-174: from S, a horizontal move if S==H, else a vertical
// move if S==V, else the diagonal; from H (V), move left (up) and return
// to S when the gap was opened at this cell. Row 0 and column 0 walk
// straight to the origin. The thread writes the trace codes (0 =
// diagonal, 1 = H, 2 = V) in walk order, that is reversed, with their
// count. Only those codes return to the host; the tile never leaves the
// card.
//
// One block of one thread per merge, so a launch's walks spread over
// every SM. A walk only moves up or left, so it consumes rows 0 .. mlen-1
// of its K x K byte tile in decreasing row order (rows at or past mlen
// are never written by K2 and never copied). Those rows are brought into
// shared memory as windows of whole rows, each by one bulk asynchronous
// copy (cp.async.bulk, completing on an mbarrier: bulk_copy.cuh), and
// the walk reads its cells from shared memory while the windows below it
// arrive. The host sizes the windows (ops/gotoh_cuda.py tb_geometry): at
// K = 128 the whole tile is one window of 16 KB, so about 13 walks share
// an SM (the launch asks for the largest shared-memory carveout) and the
// main path's merges run in one wave; above, two windows of 32 KB are in
// flight. Inside the matrix a step reads its byte, looks up its move and
// next state in a 64-bit table per state (a switch into a gap shares the
// step of the gap's first move) and moves a pointer left (-1) and up
// (-K), with one rarely taken branch; on row 0 and column 0 the walk
// takes the plain version's steps one by one. The codes collect in shared
// memory and leave in 16-byte stores.
//
// Bound on the H100: latency. Each step depends on the byte the last one
// read, so a walk is a chain of at most mlen + nlen dependent
// shared-memory loads, behind the stream of windows it reads (mlen x K
// bytes per merge).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "gotoh_common.cuh"

namespace {

constexpr int kMaxStages = 2;   // windows in flight per walk, at most
constexpr int kMaxDevices = 64; // devices whose attribute is tracked

__global__ void __launch_bounds__(32)
gotoh_tb_kernel(const uint8_t* __restrict__ bits,
                const int32_t* __restrict__ mlen,
                const int32_t* __restrict__ nlen, int K, int rsh, int ssh,
                uint8_t* __restrict__ codes, int32_t* __restrict__ lens) {
  // [1 << ssh][K << rsh] windows, then the 2K codes of the walk
  extern __shared__ __align__(128) uint8_t win[];
  __shared__ uint64_t bar[kMaxStages];
  const int g = blockIdx.x;
  const uint8_t* tile = bits + (size_t)g * K * K;
  const int m = min(max(mlen[g], 0), K), n = min(max(nlen[g], 0), K);
  const int stages = 1 << ssh, smask = stages - 1;
  const int wrows = 1 << rsh;   // rows per window; window w: rows w << rsh on
  const int wbytes = K << rsh;
  uint8_t* cs = win + stages * wbytes;
  const int nwin = (m + wrows - 1) >> rsh;
  for (int s = 0; s < stages; ++s) bulk::bar_init(&bar[s]);
  bulk::bar_init_fence();

  auto fetch = [&](int w) {
    const int r0 = w << rsh;
    bulk::load(win + (w & smask) * wbytes, tile + (size_t)r0 * K,
               (uint32_t)(min(wrows, m - r0) * K), &bar[w & smask]);
  };
  // windows nwin-1 .. fetched are in flight or arrived; cw is the lowest
  // window waited for (nwin before the first)
  int fetched = nwin;
  for (int w = nwin - 1; w >= 0 && w >= nwin - stages; --w) {
    fetch(w);
    fetched = w;
  }
  int cw = nwin;
  // waits for window w (the walk never returns to a higher one); a window
  // left behind hands its buffer to the next one down
  auto enter = [&](int w) {
    while (cw > w) {
      if (cw < nwin && cw - stages >= 0) {
        fetch(cw - stages);
        fetched = cw - stages;
      }
      --cw;
      bulk::wait(&bar[cw & smask], ((nwin - 1 - cw) >> ssh) & 1);
    }
  };
  // offset in `win` of cell (row, col), row and col > 0. The block's one
  // thread has threadIdx.x 0: adding it keeps the walk in the thread's
  // registers, where ptxas would otherwise run a one-thread block on the
  // uniform datapath (measured 10-20% slower per step).
  auto at = [&](int row, int col) {
    const int w = (row - 1) >> rsh;
    enter(w);
    return (w & smask) * wbytes + (row - 1 - (w << rsh)) * K + col - 1 +
           (int)threadIdx.x;
  };

  // A valid walk (mlen, nlen <= K) emits at most mlen + nlen <= 2K codes
  // in at most twice as many steps, so the plain version's caps (2K codes,
  // 4K + 8 steps) never bind and the kernel keeps none.
  int row = m, col = n, last = 0, i = 0;
  // Inside the matrix: a step looks up the move and the next state for
  // its byte, and moves p left (-1) and up (-K); one rarely taken branch
  // leaves the window or the matrix.
  if (row > 0 && col > 0) {
    constexpr uint64_t kS = step_table(0), kH = step_table(1),
                       kV = step_table(2);
    int p = at(row, col);
    int base = ((row - 1) >> rsh & smask) * wbytes;   // the window's row 0
    for (;;) {
      const int b = win[p];
      const uint64_t tab = last == 0 ? kS : (last == 1 ? kH : kV);
      const int e = (int)(tab >> (4 * (b & 15))) & 15;
      const int dc = e & 1, dr = (e >> 1) & 1;
      last = e >> 2;
      cs[i++] = dr ? (dc ? 0 : 2) : 1;
      col -= dc;
      row -= dr;
      p -= dc + dr * K;
      if (p < base || col == 0) {
        if (col == 0 || row == 0) break;
        p = at(row, col);         // the window below
        base = ((row - 1) >> rsh & smask) * wbytes;
      }
    }
  }
  // the rest, on row 0 or column 0
  while (row > 0 || col > 0) {
    const int b = (row > 0 && col > 0) ? win[at(row, col)] : 0;
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
        cs[i++] = 0;
      }
    } else if (last == 1) {
      const bool opened = row == 0 ? col == 1 : (b & 4) != 0;
      if (opened) last = 0;
      --col;
      cs[i++] = 1;
    } else {
      const bool opened = col == 0 ? row == 1 : (b & 8) != 0;
      if (opened) last = 0;
      --row;
      cs[i++] = 2;
    }
  }
  // the codes out in 16-byte stores (the row of 2K bytes holds them)
  uint4* out = reinterpret_cast<uint4*>(codes + (size_t)g * 2 * K);
  const uint4* src = reinterpret_cast<const uint4*>(cs);
  for (int k = 0; k < (i + 15) >> 4; ++k) out[k] = src[k];
  lens[g] = i;
  // no copy may still be writing when the block exits
  while (cw > fetched) {
    --cw;
    bulk::wait(&bar[cw & smask], ((nwin - 1 - cw) >> ssh) & 1);
  }
}

}  // namespace

// bits: (G, K, K) uint8 from gotoh_launch and codes, 16-byte aligned;
// mlen/nlen: (G,) int32 with 0 <= mlen, nlen <= K. rows: rows per window and
// stages: windows in flight, as ops/gotoh_cuda.py tb_geometry gives them.
// Outputs codes (G, 2K) uint8 in walk order and lens (G,) int32. Returns
// cudaError_t.
extern "C" int gotoh_tb_launch(const void* bits, const void* mlen,
                               const void* nlen, int G, int K, int rows,
                               int stages, void* codes, void* lens,
                               void* stream) {
  if (G <= 0) return 0;
  const bool pow2 = K > 0 && rows > 0 && !(K & (K - 1)) && !(rows & (rows - 1));
  if (!pow2 || K < 128 || K > 4096 || rows > K || stages < 1 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const int smem = stages * rows * K + 2 * K;   // windows, codes
  // the kernel's shared memory limit, once raised on each device: a
  // function's attributes belong to the context of the current device
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        gotoh_tb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // all of the SM's shared memory, so that as many walks as fit share it
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          gotoh_tb_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  gotoh_tb_kernel<<<G, 1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int32_t*>(mlen),
      static_cast<const int32_t*>(nlen), K, 31 - __builtin_clz(rows),
      stages - 1, static_cast<uint8_t*>(codes), static_cast<int32_t*>(lens));
  return (int)cudaGetLastError();
}
