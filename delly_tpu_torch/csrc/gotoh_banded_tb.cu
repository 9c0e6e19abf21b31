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
// One block per job, so a launch's walks run on as many SMs as it has
// jobs. A walk only moves up or left, so it consumes its m x B byte tile
// in decreasing row order. The tile is cut into windows of R = 32 KB / B
// whole rows (R x B contiguous bytes); two windows are in flight at once
// (more, or smaller, measured no faster: PERF.md), each brought
// into shared memory by one bulk asynchronous copy
// (cp.async.bulk, completing on an mbarrier), and the walk reads its cells
// from shared memory while the windows below it arrive. off(row) is kept
// as a quotient and remainder of row * n / m that step down with the row
// (no division). Inside the matrix a step emits one code with few
// branches (a switch into a gap shares the step of the gap's first move);
// on row 0 and column 0 the walk takes _walk_bits' steps one by one. The
// thread writes the trace codes (0 = diagonal, 1 = H,
// 2 = V) in walk order, that is reversed, with their count. Only those
// codes return to the host.
//
// Bound on the H100: latency. Each step depends on the byte the last one
// read, so a walk is a chain of shared-memory loads (at most m + n steps),
// behind the stream of windows it reads (m x B bytes per job).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kQuant = 128;
constexpr int kStages = 2;            // windows in flight per walk
constexpr int kStageBytes = 32768;    // bytes of one window

__global__ void __launch_bounds__(1)
banded_tb_kernel(const uint8_t* __restrict__ bits,
                 const int32_t* __restrict__ mlen,
                 const int32_t* __restrict__ nlen, int M, int B,
                 uint8_t* __restrict__ codes, int32_t* __restrict__ lens) {
  extern __shared__ __align__(128) uint8_t win[];   // [kStages][kStageBytes]
  __shared__ uint64_t bar[kStages];
  const int g = blockIdx.x;
  const uint8_t* tile = bits + (size_t)g * M * B;
  uint8_t* out = codes + (size_t)g * 2 * M;
  const int L = 2 * M;          // a valid walk emits m + n <= 2M codes
  const int cap = 4 * M + 8;    // and takes at most twice as many steps
  const int m = mlen[g], n = nlen[g];
  const int rsh = 31 - __clz(kStageBytes / B);   // log2 of rows per window
  const int nwin = (m + (1 << rsh) - 1) >> rsh;  // window w: rows w << rsh on
  for (int s = 0; s < kStages; ++s) bulk::bar_init(&bar[s]);
  bulk::bar_init_fence();

  auto fetch = [&](int w) {
    const int r0 = w << rsh;
    const int rows = min(1 << rsh, m - r0);
    bulk::load(win + ((unsigned)w % kStages) * kStageBytes,
               tile + (size_t)r0 * B, (uint32_t)(rows * B),
               &bar[(unsigned)w % kStages]);
  };
  auto wait = [&](int w) {
    bulk::wait(&bar[(unsigned)w % kStages], ((nwin - 1 - w) / kStages) & 1);
  };
  // windows nwin-1 .. fetched are in flight or arrived; cw is the lowest
  // window waited for (nwin before the first)
  int fetched = nwin;
  for (int w = nwin - 1; w >= 0 && w >= nwin - kStages; --w) {
    fetch(w);
    fetched = w;
  }
  int cw = nwin;

  int row = m, col = n, last = 0, i = 0, it = 0;
  int q = n, rem = 0;           // row * n == q * m + rem, 0 <= rem < m
  // the byte of cell (row, col), row > 0; 0 outside the band
  auto read = [&]() -> int {
    const int raw = q - B / 2;
    const int slot = col - (raw > 0 ? (raw & ~(kQuant - 1)) : 0);
    if (slot < 0 || slot >= B) return 0;
    const int tr = row - 1;
    const int w = tr >> rsh;
    while (cw > w) {
      // the window cw is done with: its buffer takes window cw - kStages
      if (cw < nwin && cw - kStages >= 0) {
        fetch(cw - kStages);
        fetched = cw - kStages;
      }
      wait(--cw);
    }
    return win[((unsigned)w % kStages) * kStageBytes +
               (tr - (w << rsh)) * B + slot];
  };
  auto step_up = [&]() {
    --row;
    rem -= n;
    if (rem < 0) {
      rem += m;
      --q;
    }
  };
  // Inside the matrix (row > 0, col > 0) every step emits one code, with
  // few branches: a switch from S into a gap and the gap's first move
  // read the same cell and share one step here (two steps of the walk
  // below, counted as two against `cap`).
  while (row > 0 && col > 0 && it + 2 <= cap) {
    const int b = read();
    const bool from_s = last == 0;
    const bool h = last == 1 || (from_s && (b & 1));
    const bool v = !h && (last == 2 || (from_s && (b & 2)));
    last = h ? ((b & 4) ? 0 : 1) : (v ? ((b & 8) ? 0 : 2) : 0);
    out[i++] = h ? 1 : (v ? 2 : 0);
    it += from_s && (h || v) ? 2 : 1;
    if (!v) --col;
    if (!h) step_up();
  }
  // the rest, on row 0 or column 0 (and any walk that left the matrix)
  for (; (row > 0 || col > 0) && it < cap && i < L; ++it) {
    const int b = row > 0 ? read() : 0;
    bool up = false;
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
        up = true;
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
      up = true;
      out[i++] = 2;
    }
    if (up) step_up();
  }
  lens[g] = i;
  // no copy may still be writing when the block exits
  while (cw > fetched) wait(--cw);
}

}  // namespace

// bits: (G, M, B) uint8 from gotoh_banded_launch, 16-byte aligned;
// mlen/nlen: (G,) int32. Outputs codes (G, 2M) uint8 in walk order and
// lens (G,) int32. Returns cudaError_t.
extern "C" int gotoh_banded_tb_launch(const void* bits, const void* mlen,
                                      const void* nlen, int G, int M, int B,
                                      void* codes, void* lens, void* stream) {
  if (G <= 0) return 0;
  if (B < 512 || B > 4096 || (B & (B - 1))) return (int)cudaErrorInvalidValue;
  const int smem = kStages * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      banded_tb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  banded_tb_kernel<<<G, 1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int32_t*>(mlen),
      static_cast<const int32_t*>(nlen), M, B, static_cast<uint8_t*>(codes),
      static_cast<int32_t*>(lens));
  return (int)cudaGetLastError();
}
