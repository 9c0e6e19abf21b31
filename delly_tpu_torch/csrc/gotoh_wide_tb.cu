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
// One warp per merge. A merge's direction bits are read as 128 x 128-byte
// tiles on a fixed grid of its (M, N) slice of the (G, M, N) array, each
// brought into shared memory by one load of the Tensor Memory Accelerator
// (a tensor map over the array, built by the host per launch), completing
// on its own mbarrier. The walk only moves up or left, so the tiles it
// can enter next are known: when it enters tile (tr, tc), the warp keeps
// in flight those of (tr - a, tc - b), a, b in 0..2, near its diagonal
// (|a - b| <= 1), and in a horizontal (vertical) gap also the next two to
// its left (above): 128-256 steps of walk ahead of a load's latency. The
// ring is 3 x 3 buffers, buffer (r mod 3, c mod 3) holding tile (r, c),
// so the tiles of the window never share a buffer and a buffer is taken
// over only from a tile the walk has passed; lane k keeps buffer k's
// tile, whether a copy into it is in flight and its barrier's parity, and
// issues its own tile's load, so a tile entry is one pass of the warp.
// The walk then waits only for its own tile, which was in flight since an
// entry before unless the walk left the predicted tiles; the lanes look at
// their copies' barriers without waiting, so a tile that has landed is
// entered with no wait at all. Inside a tile the 32 lanes walk in step:
// from (lr, lc) the next min(lr, lc) + 1 steps cannot leave it and run
// with no test, four to a loop, in batches of at most 127 steps whose
// drop in the offset tells the columns and rows they took. A step reads
// its byte at its offset in shared memory (the same address for every
// lane) and looks up its move back (the column step plus 128 times the
// row step) and its code in K2-tb's step table laid out as bytes
// (step_word), by an index of the byte's two low bits from S and of the
// state from H or V: a load, a logic op, a byte permute and a
// subtraction on the chain from one step to the next; the next state
// comes beside it from the table's bits rotated by the byte
// (gotoh_common.cuh step_bits). The codes collect in a shared buffer of
// their own and leave in 16-byte stores into rows of `cstride` bytes.
//
// Bound on the H100: latency. A walk is a chain of at most mlen + nlen
// dependent shared-memory loads, each with the table step behind it; the
// tiles (16 KB each, about three or four per 128 rows of a diagonal walk)
// arrive ahead of it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "gotoh_common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxN = 16384;
constexpr int kShift = 7, kTile = 1 << kShift;   // tiles of 128 x 128 bytes
constexpr int kTileBytes = kTile * kTile;
constexpr int kSide = 3;                         // the ring: 3 x 3 tiles
constexpr int kRing = kSide * kSide;
constexpr int kMaxDevices = 64;   // devices whose attribute is tracked

// A step's move and code by its table index: (byte & 3) from S (the bits
// that choose S's move: S==H, S==V), 4 from H, 5 from V. The move is what
// a cell's offset in the tile's rows goes back by: the column step plus
// kTile times the row step. Entries 0-5 of two words for prmt; 6 and 7
// are zeros, which the index's upper nibbles (6) select.
__host__ __device__ constexpr uint32_t step_entry(int idx, bool code) {
  const int e = (int)(step_table(idx < 4 ? 0 : idx - 3) >> (4 * (idx & 3))) &
                15;
  const int dc = e & 1, dr = (e >> 1) & 1;
  return code ? (dr ? (dc ? 0 : 2) : 1) : dc + dr * kTile;
}

__host__ __device__ constexpr uint32_t step_word(int first, bool code) {
  uint32_t w = 0;
  for (int k = 0; k < 4; ++k)
    if (first + k < 6) w |= step_entry(first + k, code) << (8 * k);
  return w;
}

// The state's index mask and offset, and its next state's bits by the
// cell's byte (gotoh_common.cuh step_bits, rotated by the byte).
struct Step {
  uint32_t mask, off, h, v;
};

__device__ __forceinline__ Step step_of(bool h, bool v) {
  constexpr Step kS = {3, 0x6660, step_bits(0, 2), step_bits(0, 3)};
  constexpr Step kH = {0, 0x6664, step_bits(1, 2), step_bits(1, 3)};
  constexpr Step kV = {0, 0x6665, step_bits(2, 2), step_bits(2, 3)};
  return h ? kH : (v ? kV : kS);
}

// The byte permute and (a & b) | c, each one instruction: __byte_perm
// masks its selector first and the compiler splits the logic, an
// instruction more each on the walk's chain of dependent steps.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__global__ void __launch_bounds__(32)
gotoh_wide_tb_kernel(const __grid_constant__ CUtensorMap map,
                     const int32_t* __restrict__ mlen,
                     const int32_t* __restrict__ nlen, int M, int N,
                     int cstride, uint8_t* __restrict__ codes,
                     int32_t* __restrict__ lens) {
  // the ring's kRing tiles, then its barriers; the walk's codes apart, so
  // that their stores need not wait for the walk's loads
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(16) uint8_t cs[2 * kMaxN];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kRing * kTileBytes);
  const int g = blockIdx.x, lane = threadIdx.x;
  const int m = min(max(mlen[g], 0), M), n = min(max(nlen[g], 0), N);
  // lane k < kRing keeps buffer k = (kr, kc): its tile (r << 8 | c, -1
  // before the first), whether a copy into it is in flight, the parity of
  // its barrier's next phase, and whether that phase had completed when
  // the lane last looked
  const int kr = lane / kSide, kc = lane % kSide;
  int tag = -1;
  bool busy = false, done = false;
  uint32_t par = 0;
  if (lane < kRing) bulk::bar_init(&bar[lane]);
  bulk::bar_init_fence();
  __syncwarp();

  // A valid walk (mlen <= M, nlen <= N) emits at most mlen + nlen <= M + N
  // <= 2 kMaxN codes.
  int row = m, col = n, i = 0;
  bool h = false, v = false;   // the state: S, H (h) or V (v)
  if (row > 0 && col > 0) {
    for (;;) {
      if (busy && done) {      // landed since the lane last looked
        busy = false;
        par ^= 1;
      }
      // entering tile (tr, tc): lane k's tile of the window is the one of
      // rows tr - 2 .. tr and columns tc - 2 .. tc in buffer k
      const int tr = (row - 1) >> kShift, tc = (col - 1) >> kShift;
      const int a = (tr - kr + kSide) % kSide, b = (tc - kc + kSide) % kSide;
      const int r = tr - a, c = tc - b;
      const bool want = lane < kRing && r >= 0 && c >= 0 &&
                        (abs(a - b) <= 1 || (a == 0 && h) || (b == 0 && v));
      if (want && tag != (r << 8 | c)) {
        // the tile it held lies behind the walk; its copy lands first
        if (busy) {
          bulk::wait(&bar[lane], par);
          par ^= 1;
        }
        tag = r << 8 | c;
        busy = true;
        bulk::load_box3d(smem + lane * kTileBytes, &map, c << kShift,
                         r << kShift, g, kTileBytes, &bar[lane]);
      }
      // the walk's tile: (a, b) = (0, 0), always wanted
      const int q = tr % kSide * kSide + tc % kSide;
      if (__shfl_sync(kFull, busy, q)) {
        bulk::wait(&bar[q], __shfl_sync(kFull, par, q));
        if (lane == q) {
          busy = false;
          par ^= 1;
        }
      }
      // the copies still in flight, looked at without waiting: the answer
      // is read at the next tile, so the walk does not wait for it
      done = busy && bulk::test(&bar[lane], par);
      // inside the tile, at (lr, lc): the next min(lr, lc) + 1 steps read
      // cells of the tile, so they run with no test. A step looks up its
      // move and code by its index (and_or, prmt) and moves p, the cell's
      // offset in shared memory, back by the move.
      const int base = q * kTileBytes, r0 = tr << kShift, c0 = tc << kShift;
      int lr = row - 1 - r0, lc = col - 1 - c0;
      int p = base + (lr << kShift) + lc;
      // the tables in registers (the lane's zero stops the compiler from
      // moving them in from uniform registers at every step)
      const uint32_t z = (uint32_t)lane >> 5;
      const uint32_t move_lo = step_word(0, false) | z,
                     move_hi = step_word(4, false) | z,
                     code_lo = step_word(0, true) | z,
                     code_hi = step_word(4, true) | z;
      Step t = step_of(h, v);
      auto step = [&](int j) {
        const uint32_t byte = smem[p];
        const uint32_t idx = and_or(byte, t.mask, t.off);
        const uint32_t move = prmt(move_lo, move_hi, idx);
        p -= (int)move;
        cs[i + j] = prmt(code_lo, code_hi, idx);
        t = step_of(__funnelshift_r(t.h, t.h, byte) & 1,
                    __funnelshift_r(t.v, t.v, byte) & 1);
      };
      // at most kTile - 1 steps a batch, so that its drop in p, the
      // columns plus kTile times the rows it took, tells both
      while (lr >= 0 && lc >= 0) {
        int k = min(min(lr, lc), kTile - 2) + 1;
        const int p0 = p;
        for (; k >= 4; k -= 4, i += 4) {
          step(0);
          step(1);
          step(2);
          step(3);
        }
        for (; k > 0; --k, ++i) step(0);
        lc -= (p0 - p) & (kTile - 1);
        lr -= (p0 - p) >> kShift;
      }
      h = t.off == step_of(true, false).off;
      v = t.off == step_of(false, true).off;
      row = r0 + lr + 1;
      col = c0 + lc + 1;
      if (row == 0 || col == 0) break;
    }
  }
  // the rest, on row 0 or column 0, where no cell's bits are read; as the
  // plain walk, at most M + N codes (bits that K4 did not write could
  // leave a gap open at column 0 or row 0, where a walk would not end)
  while ((row > 0 || col > 0) && i < M + N) {
    if (!h && !v) {
      h = row == 0;
      v = !h;
    } else if (h) {
      if (row == 0 && col == 1) h = false;
      --col;
      cs[i++] = 1;
    } else {
      if (col == 0 && row == 1) v = false;
      --row;
      cs[i++] = 2;
    }
  }
  __syncwarp();
  // the codes out in 16-byte stores (the row of cstride bytes holds them)
  uint4* out = reinterpret_cast<uint4*>(codes + (size_t)g * cstride);
  const uint4* src = reinterpret_cast<const uint4*>(cs);
  for (int k = lane; k < (i + 15) >> 4; k += 32) out[k] = src[k];
  if (lane == 0) lens[g] = i;
  // no copy may still be writing when the block exits
  if (busy) bulk::wait(&bar[lane], par);
}

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry point
// query, so that the library links the runtime alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// bits: (G, M, N) uint8 from gotoh_wide_launch, 16-byte aligned, N a
// multiple of 16 and M, N <= 16,384; mlen/nlen: (G,) int32 with 0 <= mlen
// <= M and 0 <= nlen <= N. tile and side: the tiles' side in bytes and the
// ring's side in tiles, as ops/gotoh_wide_cuda.py tb_geometry gives them
// (the kernel's 128 and 3). Outputs codes (G, cstride) uint8 in walk
// order (cstride a multiple of 16, at least M + N) and lens (G,) int32.
// Returns cudaError_t.
extern "C" int gotoh_wide_tb_launch(const void* bits, const void* mlen,
                                    const void* nlen, int G, int M, int N,
                                    int tile, int side, void* codes,
                                    int cstride, void* lens, void* stream) {
  if (G <= 0) return 0;
  if (M < 1 || M > kMaxN || N < 16 || N > kMaxN || N % 16 || tile != kTile ||
      side != kSide || cstride < M + N || cstride % 16 ||
      (uintptr_t)bits % 16 || (uintptr_t)codes % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // the (G, M, N) bytes as a tensor of N x M x G, boxes of one tile
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)M, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)N, (cuuint64_t)M * N};
  const cuuint32_t box[3] = {kTile, kTile, 1}, unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(bits),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int smem = kRing * (kTileBytes + 8);   // beside 2 kMaxN static
  // the kernel's shared memory limit, once raised on each device: a
  // function's attributes belong to the context of the current device
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        gotoh_wide_tb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    // all of the SM's shared memory, so that as many walks as fit share it
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          gotoh_wide_tb_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  gotoh_wide_tb_kernel<<<G, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const int32_t*>(mlen),
      static_cast<const int32_t*>(nlen), M, N, cstride,
      static_cast<uint8_t*>(codes), static_cast<int32_t*>(lens));
  return (int)cudaGetLastError();
}
