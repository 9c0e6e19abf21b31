// Device functions shared by the profile Gotoh kernels: the exact
// profile score of K2 (gotoh.cu) and K4 (gotoh_wide.cu), and the walk's
// step table of K2-tb (gotoh_tb.cu) and K4-tb (gotoh_wide_tb.cu, which
// also takes its next states bit by bit through step_bits).
// ops/_build.py hashes this header into the name of every kernel library,
// so a change here rebuilds them.

#pragma once

#include <stdint.h>

namespace {

// trunc(num / den) for den >= 1. The f32 quotient of |num| and den, with
// the approximate reciprocal (1 ulp) and the product rounded toward
// zero, is the exact quotient or one below it while |num| + den < 2^23;
// one step of the remainder corrects it.
__device__ __forceinline__ int profile_score(int num, int den) {
  const int a = abs(num);
  float rcp;                           // den >= 1: no denormal to handle
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rcp) : "f"(__int2float_rn(den)));
  int nq = __float2int_rz(-__fmul_rz(__int2float_rn(a), rcp));   // -q
  if (a + nq * den >= den) --nq;       // the remainder a - q * den
  return num < 0 ? nq : -nq;
}

// One interior step from state `last` (0 = S, 1 = H, 2 = V) on a cell's
// direction bits b (S==H, S==V, H opened, V opened), as 16 entries of 4
// bits indexed by b: bit 0 the column steps left, bit 1 the row steps
// up, bits 2-3 the next state. From S: H if S==H, else V if S==V, else
// the diagonal, entering a gap and taking its first move in one step;
// in a gap, its move, back to S where the gap was opened.
__host__ __device__ constexpr uint64_t step_table(int last) {
  uint64_t t = 0;
  for (int b = 0; b < 16; ++b) {
    const bool h = last == 1 || (last == 0 && (b & 1));
    const bool v = !h && (last == 2 || (last == 0 && (b & 2)));
    const int next = h ? ((b & 4) ? 0 : 1) : (v ? ((b & 8) ? 0 : 2) : 0);
    t |= (uint64_t)((!v) | (!h) << 1 | next << 2) << (4 * b);
  }
  return t;
}

// Bit k of step_table(last)'s entries (2 and 3: the next state is H, V)
// as a 32-bit word for a walk that rotates it right by a cell's byte b:
// entry b's bit sits at bits b and b + 16, so that rotated right by b
// (mod 32, a funnel shift) it lands on bit 0 for any byte, entry b & 15
// as the table's lookup takes it.
__host__ __device__ constexpr uint32_t step_bits(int last, int k) {
  uint32_t w = 0;
  const uint64_t t = step_table(last);
  for (int b = 0; b < 16; ++b)
    if ((t >> (4 * b + k)) & 1) w |= 1u << b | 1u << (b + 16);
  return w;
}

}  // namespace
