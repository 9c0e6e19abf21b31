"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and builds the
   kernels K1 (csrc/myers.cu), K2 (csrc/gotoh.cu), K2-tb
   (csrc/gotoh_tb.cu), K3 (csrc/gotoh_banded.cu), K3-tb
   (csrc/gotoh_banded_tb.cu), X1 (csrc/lcs.cu, the MSA's batched
   LCS), K4 (csrc/gotoh_wide.cu, profile merges wider than 4,096
   columns) and K4-tb (csrc/gotoh_wide_tb.cu) with nvcc for sm_90a, one
   process per
   source, all started together, printing the build seconds and the
   -Xptxas -v register/spill lines; beside them K3 once more with
   K3_COUNT_INTERIOR and K4 with K4_COUNT_SLOPE into cubins, and the
   probes of PROBE_SRC below.
   Counts, in cuobjdump -sass, the integer instructions per Myers word
   of K1's column loop (thread per pair) and step loop (lane groups), of
   K2's and K4's row loops per cell, of K3's interior
   row loop per cell and per thread and row, beside the operations per
   unit that each bound counts, of X1's lane groups' step loop per
   64-bit word (slope over 4 to 8 words a lane) and per step, beside the
   operations its bound counts, and of K4-tb's step loops per step,
   failing if one holds a uniform-datapath instruction. Times the
   probes: ns per dependent
   shared-memory byte load (one K3-tb walk step's floor), ns per
   dependent X1 wavefront step (a 64-bit add with the carry in and out
   and a shuffle: X1's chain floor per step), and ns per
   block barrier and per cluster barrier of 2-16 blocks with a carry
   through (distributed) shared memory (what splitting a K3 job over a
   cluster would add per DP row).
2. Holds K1 and K2/K2-tb against their plain PyTorch versions on the
   same inputs, made from numpy.random.default_rng(seed), at the shapes
   of the sr and lr main paths and beyond (K1 at queries of 64 to 8,192
   rows: 1,200 pairs of 8,192 x 2,048 and 256 of 8,192 x 8,400 at the
   widest launch, and queries of 12,300 and 16,384 rows in strips of
   8,192; K2 at every K bucket in all four end-gap configs). Tolerance:
   exact equality (integer and byte outputs). Times kernel and plain version
   with CUDA events at the main shapes, K1 at every case and K2 and
   K2-tb at each bucket, and K1 and K2-tb beside that replayed from
   a CUDA graph (the kernels alone: at ~0.01-0.06 ms the wrapper's host
   overhead shows in the events); K2-tb's chain floor is the main
   shape's longest walk x the chase probe's step. Holds X1 against
   lcs_plain on the card (exact) on deepgeno-like ~150 b pairs, a
   long-split-like batch of 48 ~12 kb pairs beside 48 short ones, empty
   strings, lengths at 64-bit word edges, N letters, b of 16,385 to
   40,000 bases (strips), 200 letters (masks in global memory) and b at
   every layout's edge, each with the host's lengths (the launch
   grouped by layout, lcs_cuda.schedule) and without, each timed through
   the wrapper with its chain floor (the longest pair's steps x the X1
   step probe).
3. Generates the svmix, deepgeno and long-split datasets with the port's
   copy of the generators and runs `sr` on each, and `sr -v` on
   deepgeno, through the CLI entry point on the card, with the launch
   counters set to 0 just before each run and read just after. Checks
   svmix against its truth (36/36 recall, precision 1.0), long-split
   against its truth (24/24 DELs, precision 1.0, every merge on K3/K3-tb),
   every kernel's launches and no host routes, and that each lcs_pairs
   call launched X1 once; every X1 call of these runs is held against
   lcs_plain on the card and timed (long-split's batch gives the
   kernels line's X1 numbers, and the seeded 96-pair mix's time is
   printed over it). Then the wide merges: `sr` on the card on long
   split reads with 4 reads per DEL, on one 1 Mb contig with 2 DELs and
   at LONG_SPLIT's full size (24 DELs, generated by a third worker
   process from the start), where the MSA merges profiles wider than
   K2's 4,096 columns on K4/K4-tb: truth 2/2 and 24/24, 0 host routes,
   K4 and K4-tb launched, at 24 DELs more K4 launches than
   gotoh_wide_batch calls (tiles cut under TILE_BUDGET), every launch
   recorded; prints the seconds of split-read assembly in the wide
   batches, the corridor batches and the LCS.
4. Generates the lr datasets with the port's copy of the generators (in
   a worker process, started after the probes, beside phases 2 and 3)
   and runs `lr` on the card on each: the five families of
   make_lr_sv_dataset (checked at +-5 bp), the noisy ONT-like genome
   (8 x 1.5 Mb, ~13x of 4 kb reads with 5% substitutions and 5% 1 bp
   indels; 16/16 at +-60 bp), deep long-read genotyping at bench.py's
   size (2 x 2 Mb, 600 DELs, 60x; 600/600 at +-60 bp), then `lr -v` on
   its sites (600 sites genotyped 0/1 or 1/1), and discovery and `-v`
   on a smaller deep-lr dataset that the CPU runs repeat. Every lr run
   must launch K1 and send no batch to the torch row-scan; each prints
   its stage seconds and the seconds inside K1's batch wrapper, in the
   reads' consensus, in its realignment and in the host needle. Every K1
   launch of the two bench-size runs is recorded and held equal to the
   plain version on the card, and the largest is timed. The row-scan,
   which served queries wider than 4,096 rows before K1 did, is timed
   once on one recorded 8,192-row consensus batch.
5. Generates the cohort datasets (in a second worker process, started
   with the first) and runs the cohort commands on the card, each step
   between a reset and a read of the launch counters: the germline
   workflow over make_population_cohort's 50 samples of 2 x 300 kb
   (bench_e2e.py's cohort engine: 50 x `sr`, `merge`, one joint `sr -v`
   over the 50 BAMs, `filter -f germline`; site recall and precision and
   genotype agreement against the population truth), the somatic
   workflow over a tumor/control pair on 8 x 1.5 Mb (joint `sr`, `filter
   -f somatic`: every somatic DEL kept, no germline DEL), `asm` on
   bench_e2e.py's 1.5 Mb assembly pair (DEL and INS within 50 bp), `-y
   diploid` on tests/test_asm.py's 2 Mb haplotypes (DEL 1/1, INS phased)
   and the split-alignment DUP, INV and BND, whose K1 launches are held
   equal to the plain version on the card, and `cnv` on bench_e2e.py's
   8 x 1.5 Mb (`-c`, `-u` and the statistics file; every read-depth hole
   called) with its cohort step (a second sample, `merge -e -y 0 -q 2`,
   `cnv -v`). K1 must launch in the joint `sr -v` and in the families run; no
   step may take a host route or a row-scan batch.
6. CRAM input, the mesh, the host axis and the device trace. A third
   and fourth worker process, started after phase 3, write svmix as a
   CRAM 3.1 and a CRAM 3.0 with the port's write_cram; `sr` runs on the
   card on each, whole-file and streaming, and its calls and launch
   counts must equal the svmix BAM run's (with the seconds spent
   decoding CRAM beside the BAM run's scan). `sr` on deepgeno and `cnv
   -c -u` run under DELLY_TPU_MESH=1 (and at N = the visible cards when
   there are more than one): every output, the coverage, segmentation
   and statistics files included, must equal the run without a mesh,
   and every card must have run chunks (dispatch.device_snapshot);
   beside them it counts the seeded float64 values whose log2, and
   whose quotient by 0.9 (a Python divisor, and a tensor one), the card
   rounds otherwise than numpy (the window math's reasons to take its
   log2 on the host and to divide by purity as a tensor). A
   2-process gloo world on the one card
   (delly_tpu_torch/testing/hostaxis_worker.py) runs `sr` on svmix and
   `lr` on lr_sv; its VCFs must equal the one-process runs. Last, the
   runs of TRACED run again under DELLY_TPU_PROFILE_TRACE (a
   torch.profiler trace of the card's activity), each in a fresh process
   (delly_tpu_torch/testing/trace_check.py): each prints its busy
   share, the union of its kernel and copy intervals over its wall, and
   its traced wall beside the untraced one; its trace must hold one
   kernel record for every launch of the port's kernels it counted
   (X1's among them).
7. Starts the same sr and lr commands (not the bench-size deep-lr ones,
   nor the 24-DEL wide run) with DELLY_TPU_TORCH_DEVICE=cpu (together,
   one torch thread each, with their stage profiles), and each workflow
   of phase 5 in one
   process that runs its steps one after the other (each step reading
   the card's outputs of the steps before), in the
   background, and meanwhile holds K3/K3-tb against their plain versions
   in all four end-gap configs at every band (512...4096) with M = 256,
   at every band with M = 16,384 (n = 1 included) and at m = 32,768;
   swapped and n = 1 jobs through gotoh_banded_batch against the host
   corridor, and one gotoh_banded_batch call that mixes every band. Then
   holds the long-split run's own K3/K3-tb launches against the plain
   versions and times the run's corridor jobs as a whole (its launches
   at once, on their own streams), and each launch alone: the kernels
   line's K3 and K3-tb numbers, with K3-tb's chain floor (the longest
   walk's steps x the chase probe's step). Then every K4/K4-tb launch
   of the wide runs again from its recorded inputs (equal to what the
   run got), each timed through the wrappers, with K4's strips printed
   (merges G, strips P of W columns, G x P blocks; at 24 DELs every
   launch at least 6 strips a merge and no more blocks than SMs), and
   the merges of both
   runs at once through the plain versions on the card (exact): the
   kernels line's K4 and K4-tb numbers from the 24-DEL run, with the
   bounds per merge on one SM and on the card, K4-tb's chain floor and
   its ns a step of each launch's longest walk beside the chase probe's.
   The plain versions' times of
   this phase are taken with the CPU runs going. Last, checks that every
   card output equals its CPU run's apart from ##fileDate (BCF decoded,
   gzip files decompressed).
8. Prints the kernels line (K1's entry with its lr and asm launches,
   pairs by shape and largest launch; X1's at long-split's batch, with
   deepgeno's beside it; K4's and K4-tb's at the 24-DEL wide run's
   launches), then as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
   N the visible cards (torch.cuda.device_count()).

Operations bounds use the card's 32-bit integer rate: 64 INT32 lanes per
SM x the SM count x the SM clock (nvidia-smi clocks.max.sm); every
kernel here does 32-bit integer work. They count the operations of the
recurrence each kernel computes, not the instructions the kernel spends
on it.

Any failed phase exits non-zero before the result lines. Without a GPU,
or without the rest of the repository beside it, the script fails.
Details go to chiprun_out/chip_smoke.json; datasets are made under
build/smoke/ and removed at the end.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_LANES_PER_SM = 64        # Hopper: half the SM's 128 FP32 lanes
INT32_OPS_PER_S = None         # set by main(): lanes x SMs x SM clock
# Integer operations of one Myers word update, counted in the recurrence
# of delly_tpu/ops/myers_pallas.py:294-318: Peq lookup 1, hin sign tests
# 2, xv 1, eq2 1, xh (and, add, xor, or) 4, ph (or, not, or) 3, mh 1,
# hout (2 shifts, sub) 3, ph and mh shift-ins (shift, or) 4, pv (or, not,
# or) 3, mv 1. Once per target column, in the top word only: the score
# delta (2 shifts, 2 ands, sub) 5, score add 1, mode min or final select 2.
MYERS_OPS_PER_WORD = 24
MYERS_OPS_PER_COLUMN = 8
# Integer operations of one K2 cell, counted in the recurrence of
# delly_tpu/ops/gotoh_pallas.py:103-158 with the row's constants and the
# per-column end-gap choice hoisted: column 1, score (5 products, 4 sums,
# depth product and max, abs, division, sign test, negation, select) 16,
# V 3, diagonal 2, scan input 2, prefix max 1, H 3, S 1, H_prev + E 1,
# direction bits (4 compares, 3 shifts, 3 ors) 10, best at column n
# (compare, select) 2.
GOTOH_OPS_PER_CELL = 42
# Integer operations of one K3 (row, slot) cell, counted in the recurrence
# of gotoh_banded_host (delly_tpu/ops/gotoh_banded.py:80-128) with the
# row's constants hoisted: column 1, in-band test 1, vertical end-gap
# choice 3, V 3, score (clip 3, compare, select) 5, diagonal 2, column-0
# seed 2, scan input 2, prefix max 1, H 3, H clamp 1, S 1, H_prev + E 1,
# direction bits (4 compares, 3 shifts, 3 ors) 10, column-0 and
# out-of-band selects 3. phase_build counts what the kernels execute.
BANDED_OPS_PER_CELL = 39
BANDED_TB_OPS_PER_STEP = 16    # K3-tb step: offset, byte load, branch
# 32-bit integer operations of one X1 word step (a row of a against one
# 64-bit word of b), counted in the recurrence of lcs_many
# (delly_tpu_torch/native/hostio.cpp:3045-3056), whose V - U equals
# V & ~U because U holds only bits of V (no borrow chain): mask lookup 1,
# U = V & M 2 (one per 32-bit half), V + U with the carry in and out 2
# (an add and an add with carry over the halves), V = S | (V & ~U) 2 (one
# three-input logic operation per half). Rows of a whose letter b lacks
# change nothing and count no step.
LCS_OPS_PER_WORD = 7
PROBE_STEPS = 200_000

PROBE_SRC = r'''
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

// one thread follows a chain of dependent byte loads through shared
// memory (a full cycle over 256 bytes): one K3-tb walk step's floor
__global__ void chase_kernel(int steps, int* out) {
  __shared__ uint8_t buf[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    buf[i] = (uint8_t)((i * 73 + 41) & 255);
  __syncthreads();
  if (threadIdx.x) return;
  int idx = 0;
  for (int i = 0; i < steps; ++i) idx = buf[idx];
  out[0] = idx;
}

// one block barrier per step; before it, warp 0 writes a carry into the
// block's shared memory (double-buffered)
__global__ void block_kernel(int steps, int* out) {
  __shared__ int carry[2][32];
  int v = threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    if (threadIdx.x < 32) carry[i & 1][threadIdx.x] = v + 1;
    __syncthreads();
    v += carry[i & 1][threadIdx.x & 31];
  }
  if (v == 0x7fffffff) out[0] = v;
}

// the same with one cluster barrier per step, the carry written into the
// next block's shared memory
__global__ void cluster_kernel(int steps, int* out) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int carry[2][32];
  int v = threadIdx.x;
  const unsigned peer_rank = (cl.block_rank() + 1) % cl.num_blocks();
  for (int i = 0; i < steps; ++i) {
    int* peer = cl.map_shared_rank(&carry[i & 1][0], peer_rank);
    if (threadIdx.x < 32) peer[threadIdx.x] = v;
    cl.sync();
    v += carry[i & 1][threadIdx.x & 31];
  }
  if (v == 0x7fffffff) out[0] = v;
}

// one warp, one dependent X1 wavefront step per iteration: a 64-bit add
// with the carry in and out through the carry flag (as csrc/lcs.cu adds),
// then a shuffle of the carry to the next lane: X1's chain floor per step
__global__ void lcs_step_kernel(int steps, int* out) {
  uint64_t v = 0x9E3779B97F4A7C15ull * (threadIdx.x + 1), u = v >> 3;
  uint32_t cin = threadIdx.x & 1u;
  for (int i = 0; i < steps; ++i) {
    uint32_t t, lo, hi, cy;
    asm volatile("add.cc.u32 %0, %1, 0xFFFFFFFF;" : "=r"(t) : "r"(cin));
    asm volatile("addc.cc.u32 %0, %2, %4;\n\taddc.cc.u32 %1, %3, %5;"
                 : "=r"(lo), "=r"(hi)
                 : "r"((uint32_t)v), "r"((uint32_t)(v >> 32)),
                   "r"((uint32_t)u), "r"((uint32_t)(u >> 32)));
    asm volatile("addc.u32 %0, %1, %1;" : "=r"(cy) : "r"(0u));
    v = (((uint64_t)hi << 32) | lo) | (v & ~u);
    u = v & (u ^ (u << 1));
    cin = __shfl_up_sync(0xFFFFFFFFu, cy, 1);
  }
  if (v == 42u) out[0] = (int)cin;
}

// cluster -1: lcs_step_kernel; 0: chase_kernel; 1: block_kernel;
// 2..16: cluster_kernel with that many blocks of `threads`
extern "C" int probe(int cluster, int threads, int steps, void* out,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (cluster == -1) {
    lcs_step_kernel<<<1, 32, 0, st>>>(steps, o);
    return (int)cudaGetLastError();
  }
  if (cluster == 0) {
    chase_kernel<<<1, 32, 0, st>>>(steps, o);
    return (int)cudaGetLastError();
  }
  if (cluster == 1) {
    block_kernel<<<1, threads, 0, st>>>(steps, o);
    return (int)cudaGetLastError();
  }
  if (cluster > 8) {
    cudaError_t e = cudaFuncSetAttribute(
        cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, cluster_kernel, steps, o);
}
'''


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def need(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Per-call time of the kernels fn launches, replayed from one CUDA
    graph of `reps` calls, so without the host's launch overhead, which
    CUDA events around wrapper calls include (it is comparable to K1's
    and K2-tb's times at the main shapes)."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def timed(fn):
    """One call of fn, timed with CUDA events: (result, ms)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, ops: float) -> dict:
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": int(nbytes), "bytes_ms": b_ms, "ops": int(ops),
            "ops_ms": o_ms}


# ---------------------------------------------------------------------------
# Phase 1: card and build
# ---------------------------------------------------------------------------

def phase_build(details: dict) -> tuple:
    """Builds every kernel and, beside them, K3 with K3_COUNT_INTERIOR
    and K4 with K4_COUNT_SLOPE into cubins for their SASS counts and
    PROBE_SRC into a library. Returns (K3's cubin's path, the probe
    library's path)."""
    from delly_tpu_torch import native
    from delly_tpu_torch.ops import _build

    host = {}
    t0 = time.time()

    def build_host():
        host["lib"] = native.get_lib()
        host["s"] = time.time() - t0

    t = threading.Thread(target=build_host)
    t.start()                       # the host library builds meanwhile
    cubin = os.path.join(_build.BUILD_DIR, "k3_count_interior.cubin")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    count = subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-cubin", "-DK3_COUNT_INTERIOR", "-o", cubin,
         os.path.join(_build.CSRC, "gotoh_banded.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    k4_cubin = os.path.join(_build.BUILD_DIR, "k4_count_slope.cubin")
    k4_count = subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-cubin", "-DK4_COUNT_SLOPE", "-o", k4_cubin,
         os.path.join(_build.CSRC, "gotoh_wide.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    probe_src = os.path.join(_build.BUILD_DIR, "probes.cu")
    with open(probe_src, "w") as fh:
        fh.write(PROBE_SRC)
    probe_lib = probe_src[:-3] + ".so"
    probe = subprocess.Popen(
        [_build._nvcc(), *_build.FLAGS, "-o", probe_lib, probe_src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    secs = _build.build()
    log, _ = count.communicate()
    k4_log, _ = k4_count.communicate()
    probe_log, _ = probe.communicate()
    wall = time.time() - t0
    t.join()
    need(count.returncode == 0, f"K3 count build failed: {log[-1500:]}")
    need(k4_count.returncode == 0,
         f"K4 count build failed: {k4_log[-1500:]}")
    need(probe.returncode == 0, f"probe build failed: {probe_log[-1500:]}")
    need(host.get("lib") is not None, "native host library did not build")
    print(f"build: {wall:.1f}s wall for {len(secs) + 3} nvcc processes "
          f"({', '.join(f'{k} {v:.1f}s' for k, v in secs.items())}); "
          f"host library ready after {host['s']:.1f}s")
    ptxas = {}
    for name in _build.SOURCES:
        for ln in _build.build_log.get(name, "").splitlines():
            if any(w in ln for w in ("registers", "spill", "Compiling entry",
                                     "Function properties")):
                print(f"  ptxas[{name}]: {ln.strip()}")
                ptxas.setdefault(name, []).append(ln.strip())
    details["ptxas"] = ptxas
    details["build_s"] = {"wall": wall, "host_library": host["s"], **secs}
    return cubin, probe_lib


def phase_probes(dev, lib_path: str, details: dict) -> tuple:
    """Times PROBE_SRC's kernels, PROBE_STEPS steps each, with CUDA
    events: ns per dependent shared-memory byte load, ns per dependent
    X1 step, and ns per block barrier and per cluster barrier (2, 4, 8,
    16 blocks) at 256 and 512 threads. Returns the first two."""
    import ctypes

    import torch

    from delly_tpu_torch.ops import _build

    fn = ctypes.CDLL(lib_path).probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int32, device=dev)

    def ns(cluster, threads):
        ms = cuda_ms(lambda: _build.check(fn(
            cluster, threads, PROBE_STEPS, out.data_ptr(),
            _build.stream_ptr(dev)), "probe"), reps=3)
        return ms * 1e6 / PROBE_STEPS

    step = ns(0, 32)
    lcs_step = ns(-1, 32)
    bar = {f"{c}x{t}": ns(c, t) for t in (256, 512) for c in (1, 2, 4, 8, 16)}
    print(f"probes: {step:.3f} ns per dependent shared-memory byte load; "
          f"{lcs_step:.3f} ns per dependent X1 step (64-bit add with carry, "
          f"shuffle); ns per barrier with a carry, blocks x threads (1 = "
          f"block barrier, more = a cluster): " + ", ".join(
              f"{k} {v:.1f}" for k, v in bar.items()))
    details["probes"] = {"steps": PROBE_STEPS, "smem_step_ns": step,
                         "lcs_step_ns": lcs_step, "barrier_ns": bar}
    return step, lcs_step


# SASS opcodes that are no integer work: memory, shuffles, barriers,
# control flow, special registers, conversions; uniform-datapath (U*)
# opcodes run once per warp and are left out too
NON_ALU = ("LD", "ST", "ATOM", "RED", "SHFL", "BAR", "BRA", "BSSY", "BSYNC",
           "BREAK", "WARPSYNC", "NOP", "EXIT", "S2", "CS2R", "MEMBAR",
           "DEPBAR", "I2F", "F2I", "MUFU", "U", "CALL", "RET")
SASS_INS = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);")


def sass_functions(path: str, kernel: str) -> list:
    """[(mangled name, instructions)] of each instantiation of `kernel`
    in `cuobjdump -sass` of the library or cubin at `path`; an
    instruction is (address, opcode, operands, opcode with modifiers)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        if re.search(rf"{len(kernel)}{kernel}[IE]", name):
            out.append((name, [(int(a, 16), op.split(".")[0], rest, op)
                               for a, op, rest in SASS_INS.findall(fn)]))
    return out


def _back_target(a: int, op: str, rest: str):
    """The target of a backward branch at address a, else None."""
    tgt = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
    return int(tgt.group(1), 16) if tgt and int(tgt.group(1), 16) < a else None


def backward_loops(ins: list) -> list:
    """Every loop of one function's instructions: the run from a
    backward branch's target to the branch."""
    at = {a: i for i, (a, _op, _rest, _full) in enumerate(ins)}
    loops = []
    for i, (a, op, rest, _full) in enumerate(ins):
        tgt = _back_target(a, op, rest)
        if tgt is not None:
            loops.append(ins[at[tgt]:i + 1])
    return loops


def x1_step_loops(path: str) -> dict:
    """{K: integer instructions} of X1's lane-group step loops (two
    wavefront steps an iteration, csrc/lcs.cu rows) with the masks in
    shared memory and no strip carries: the innermost loops that hold a
    shuffle, 2 K 64-bit shared loads and no global store; K from the
    loads, the fewest instructions where layouts share a K."""
    steps = {}
    for _name, ins in sass_functions(path, "lcs_kernel"):
        for seg in backward_loops(ins):
            ops = [o for _a, o, _r, _f in seg]
            loads = sum(f == "LDS.64" for _a, _o, _r, f in seg)
            nested = any(_back_target(a, o, r) is not None
                         for a, o, r, _f in seg[:-1])
            if (nested or "SHFL" not in ops
                    or "STG" in ops or not loads or loads % 2):
                continue
            alu = sum(not o.startswith(NON_ALU) for o in ops)
            k = loads // 2
            steps[k] = min(alu, steps.get(k, alu))
    return steps


def tb_step_loops(path: str) -> list:
    """K4-tb's step loops (csrc/gotoh_wide_tb.cu): the innermost loops
    that read a tile's bytes (LDS.U8), each with its steps (those
    loads), instructions, integer instructions and instructions on the
    uniform datapath (U* opcodes), which a walk's steps must not take:
    a one-lane walk there ran 10-20% slower a step (K2-tb)."""
    out = []
    for _name, ins in sass_functions(path, "gotoh_wide_tb_kernel"):
        for seg in backward_loops(ins):
            nested = any(_back_target(a, o, r) is not None
                         for a, o, r, _f in seg[:-1])
            steps = sum(f == "LDS.U8" for _a, _o, _r, f in seg)
            if nested or not steps:
                continue
            ops = [o for _a, o, _r, _f in seg]
            out.append({"steps": steps, "instructions": len(seg),
                        "integer": sum(not o.startswith(NON_ALU)
                                       for o in ops),
                        "uniform": sum(bool(re.match(r"U[A-Z]", o))
                                       for o in ops)})
    return out


def sass_loops(path: str, kernel: str, must: str | None = None,
               avoid: tuple = (), count: str | None = None) -> dict:
    """{template arguments (() for a kernel that is no template):
    (instructions, integer instructions)} of the main loop of each
    instantiation of `kernel` in `cuobjdump -sass` of
    the library or cubin at `path`: the largest loop (a backward branch
    and its target) that holds the opcode `must` (if given) and none of
    `avoid`; with `count` (an opcode with its modifiers, such as LDS.U8)
    a third number, how many of those the loop holds. A static count:
    every instruction of the loop body counts once."""
    loops = {}
    for name, ins in sass_functions(path, kernel):
        targs = tuple(int(x) for x in re.findall(r"Li(\d+)E", name))
        body = []
        for seg in backward_loops(ins):
            ops = {o for _a, o, _r, _f in seg}
            if (len(seg) > len(body) and (must is None or must in ops)
                    and not ops.intersection(avoid)):
                body = seg
        need(body, f"SASS: no main loop in {kernel}<{targs}>")
        loops[targs] = (len(body), sum(not o.startswith(NON_ALU)
                                       for _a, o, _rest, _f in body))
        if count:
            loops[targs] += (sum(f == count for _a, _o, _r, f in body),)
    need(loops, f"SASS: no instantiation of {kernel} in {path}")
    return loops


def slope(loops: dict, lo: tuple, hi: tuple, per) -> float:
    """Integer instructions one more unit of `per` (slots, words) adds to
    the loop, from two instantiations."""
    return (loops[hi][1] - loops[lo][1]) / (per(hi) - per(lo))


def kernel_sass(details, k3_count: str) -> dict:
    """Prints what the kernels execute per unit of their recurrence, from
    `cuobjdump -sass` of the libraries just built, beside the operations
    their bounds count: K1 per Myers word (the thread-per-pair column
    loop, slope over W = 1 to 2, counted per column by the loop's byte
    loads, one letter lookup each; and the lane groups' step loop, slope
    over W = 64 to 128, 2 to 4 words a lane, counted per step by its
    shuffles, one a step),
    K2 per cell and per lane and row (row loop, slope over
    columns per lane between the warp-per-merge instantiations), K4 the
    same over its warp row loop at 4 and 8 columns a lane (the cubin
    built with K4_COUNT_SLOPE),
    K3 per cell and per thread and row (the interior path alone, from the
    build `k3_count` with K3_COUNT_INTERIOR; slope over 4 and 8 slots per
    thread at 256 threads), X1 per 64-bit word and row of a and per
    step (its lane groups' step loops, x1_step_loops), and K4-tb's step
    loops (tb_step_loops), which must hold no uniform-datapath
    instruction. Returns K3's interior row loops by (slots, threads):
    integer instructions."""
    from delly_tpu_torch.ops import _build

    k1 = sass_loops(_build._lib_path("myers"), "myers_thread_kernel",
                    avoid=("BAR", "STS", "LDGSTS"), count="LDS.U8")
    k1l = sass_loops(_build._lib_path("myers"), "myers_lanes_kernel",
                     must="SHFL", avoid=("BAR",), count="SHFL.UP")
    per_col = {k: v[1] / v[2] for k, v in k1.items() if v[2]}
    per_step = {k: v[1] / v[2] for k, v in k1l.items() if v[2]}
    need((1,) in per_col and (2,) in per_col and (64,) in per_step
         and (128,) in per_step, "SASS: K1 loops without byte loads or "
         "shuffles")
    k1_word = per_col[(2,)] - per_col[(1,)]
    k1l_word = (per_step[(128,)] - per_step[(64,)]) / 2
    k2 = sass_loops(_build._lib_path("gotoh"), "gotoh_kernel")
    k2w = sorted(k for k in k2 if k[1] == 1)    # one warp per merge
    k2_cell = slope(k2, k2w[0], k2w[-1], lambda t: t[0])
    k2_row = k2[k2w[0]][1] - k2w[0][0] * k2_cell
    k3 = sass_loops(_build._lib_path("gotoh_banded"), "banded_kernel", "BAR")
    k3i = sass_loops(k3_count, "banded_kernel", "BAR")
    k3_cell = slope(k3i, (4, 256), (8, 256), lambda t: t[0])
    k3_row = k3i[(4, 256)][1] - 4 * k3_cell
    # K4's warp row loop at 4 columns a lane (the launch's layout) and 8
    # (instantiated only in the K4_COUNT_SLOPE cubin, for the slope)
    k4 = sass_loops(os.path.join(_build.BUILD_DIR, "k4_count_slope.cubin"),
                    "gotoh_wide_kernel", must="SHFL",
                    avoid=("BAR", "ENDCOLLECTIVE"))
    need((4,) in k4 and (8,) in k4, f"SASS: K4's row loops at 4 and 8 "
         f"columns a lane not found ({k4})")
    k4_cell = slope(k4, (4,), (8,), lambda t: t[0])
    k4_row = k4[(4,)][1] - 4 * k4_cell
    # K4-tb's step loops: off the uniform datapath
    tbl = tb_step_loops(_build._lib_path("gotoh_wide_tb"))
    need(tbl and all(lp["uniform"] == 0 for lp in tbl),
         f"SASS: K4-tb's step loops {tbl}: none, or on the uniform datapath")
    # X1's lane groups: two steps an iteration, K words a lane
    x1 = x1_step_loops(_build._lib_path("lcs"))
    need(4 in x1 and 8 in x1, f"SASS: X1's step loops at K = 4 and 8 "
         f"not found ({x1})")
    x1_word = (x1[8] - x1[4]) / (2 * 4)
    x1_step = x1[4] / 2 - 4 * x1_word
    print(f"K1 SASS: {k1_word:g} integer instructions per Myers word in "
          f"the thread-per-pair column loop (W=1 to 2), {k1l_word:g} in the "
          f"lane groups' step loop (W=64 to 128); the bound counts "
          f"{MYERS_OPS_PER_WORD}. Integer instructions per column, thread "
          f"per pair: " + ", ".join(f"W={k[0]} {v:.2f}" for k, v in
                                    sorted(per_col.items()))
          + "; per step, lane groups: " + ", ".join(
              f"W={k[0]} {v:.2f}" for k, v in sorted(per_step.items())))
    print(f"K2 SASS: {k2_cell:g} integer instructions per cell and "
          f"{k2_row:g} per lane and row (row loop of the warp-per-merge "
          f"layout, {k2w[0][0]} to {k2w[-1][0]} columns per lane); the bound "
          f"counts {GOTOH_OPS_PER_CELL}. Row loops, (columns per lane, warps "
          f"per merge): " + ", ".join(f"{k} {a}" for k, (_n, a)
                                      in sorted(k2.items())))
    print(f"K4 SASS: {k4_cell:g} integer instructions per cell and "
          f"{k4_row:g} per lane and row (the warp's row loop, slope over 4 "
          f"to 8 columns a lane); at the launch's 4 columns a lane "
          f"{k4[(4,)][1] / 4:g} per cell with the row's share; the bound "
          f"counts {GOTOH_OPS_PER_CELL}. Row loops: " + ", ".join(
              f"{k[0]} columns {a}" for k, (_n, a) in sorted(k4.items())))
    print("K4-tb SASS step loops (steps: instructions, integer, uniform "
          "datapath): " + ", ".join(
              f"{lp['steps']}: {lp['instructions']}, {lp['integer']}, "
              f"{lp['uniform']}" for lp in tbl) + "; integer a step "
          + ", ".join(f"{lp['integer'] / lp['steps']:g}" for lp in tbl))
    print("K3 SASS interior row loop per thread: " + ", ".join(
        f"{c} slots x {t} threads {a} integer" for (c, t), (_n, a)
        in sorted(k3i.items())) + f"; {k3_cell:g} integer instructions per "
        f"cell and {k3_row:g} per thread and row at 256 threads; the bound "
        f"counts {BANDED_OPS_PER_CELL} per cell. Both paths in the row loop:"
        + ", ".join(f" {c}x{t} {a}" for (c, t), (_n, a) in sorted(k3.items())))
    print(f"X1 SASS: {x1_word:g} integer instructions per 64-bit word and "
          f"row of a and {x1_step:g} per step beside them (lane groups' step "
          f"loop, two steps an iteration, slope over 4 to 8 words a lane: "
          + ", ".join(f"K={k} {v}" for k, v in sorted(x1.items()))
          + f"); the bound counts {LCS_OPS_PER_WORD}")
    details["sass"] = {
        "k1_column_loop": {str(k): v for k, v in k1.items()},
        "k1_step_loop": {str(k): v for k, v in k1l.items()},
        "k1_integer_per_column": {str(k): v for k, v in per_col.items()},
        "k1_lanes_integer_per_step": {str(k): v
                                      for k, v in per_step.items()},
        "k1_integer_per_word": k1_word,
        "k1_lanes_integer_per_word": k1l_word,
        "k2_row_loop": {str(k): v for k, v in k2.items()},
        "k2_integer_per_cell": k2_cell, "k2_integer_per_lane_row": k2_row,
        "k4_row_loop": {str(k): v for k, v in k4.items()},
        "k4_integer_per_cell": k4_cell, "k4_integer_per_lane_row": k4_row,
        "k4_integer_per_cell_at_4": k4[(4,)][1] / 4,
        "k4tb_step_loops": tbl,
        "k3_row_loop_both_paths": {f"{c}x{t}": v
                                   for (c, t), v in k3.items()},
        "k3_row_loop_interior": {f"{c}x{t}": v for (c, t), v in k3i.items()},
        "k3_integer_per_cell": k3_cell, "k3_integer_per_thread_row": k3_row,
        "x1_step_loops": {str(k): v for k, v in x1.items()},
        "x1_integer_per_word": x1_word, "x1_integer_per_step": x1_step}
    return {k: a for k, (_n, a) in k3i.items()}


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _myers_batch(rng, b, m, n, nalpha, mode):
    letters = np.frombuffer(b"ACGTN", dtype=np.uint8)[:nalpha]
    q = letters[rng.integers(0, nalpha, size=(b, m))]
    t = letters[rng.integers(0, nalpha, size=(b, n))]
    ql = rng.integers(max(1, m * 5 // 8), m + 1, size=b).astype(np.int32)
    tl = rng.integers(n * 3 // 4, n + 1, size=b).astype(np.int32)
    # targets carry a mutated copy of the query, as reads carry probes
    for i in range(0, b, 2):
        k = int(min(ql[i], tl[i]))
        off = int(rng.integers(0, tl[i] - k + 1))
        seg = q[i, :k].copy()
        hit = rng.random(k) < 0.05
        seg[hit] = letters[rng.integers(0, nalpha, size=int(hit.sum()))]
        t[i, off:off + k] = seg
    return q, ql, t, tl, mode


def check_myers(dev, rng, details) -> dict:
    """K1 against the plain version at the genotyping shape, at queries
    of 512 to 8,192 rows (the lane groups' layout) and above (strips of
    8,192 rows, one launch each), each case timed through the wrapper;
    the main shape's numbers for the kernels line."""
    import torch

    from delly_tpu_torch.ops.myers import (alphabet_lut, alphabet_size,
                                           myers_plain)
    from delly_tpu_torch.ops.myers_cuda import launch_geometry, myers, \
        words_bucket

    cases = [("main: genotyping HW", 86_484, 64, 128, 4, 2),
             ("NW", 4096, 64, 128, 4, 0), ("SHW", 4096, 64, 128, 4, 1),
             ("5 letters HW", 4096, 64, 128, 5, 2),
             ("m=512 NW", 512, 512, 640, 4, 0),
             ("m=1024 NW", 256, 1024, 1100, 4, 0),
             ("m=2048 SHW", 128, 2048, 2100, 4, 1),
             ("m=4096 NW", 64, 4096, 4200, 4, 0),
             ("m=8192 NW, lr consensus", 1200, 8192, 2048, 4, 0),
             ("m=8192 NW, long targets", 256, 8192, 8400, 4, 0),
             ("m=16384 NW, 2 strips", 256, 16384, 2048, 4, 0),
             ("m=12300 HW, 2 strips", 128, 12300, 4096, 5, 2)]
    out = {}
    max_err = 0
    times = {}
    for label, b, m, n, nalpha, mode in cases:
        q, ql, t, tl, mode = _myers_batch(rng, b, m, n, nalpha, mode)
        lut = alphabet_lut(q, t)
        na = alphabet_size(lut)
        args = [torch.from_numpy(x).to(dev) for x in (q, ql, t, tl, lut)]
        got = myers(*args, mode, na)
        want = myers_plain(*args, mode)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        need(torch.equal(got, want), f"K1 != plain on {label} (max {err})")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: myers(*args, mode, na), reps=20)
        dev_ms = device_ms(lambda: myers(*args, mode, na))
        geo = launch_geometry(words_bucket(m), na)
        strips = -(-m // (32 * geo["words"]))
        bnd = myers_bound(q, ql, t, tl)
        print(f"K1 {label}: {b} pairs {m}x{n}: equal; {ms:.5f} ms through "
              f"the wrapper, {dev_ms:.5f} ms replayed ({geo['layout']}, "
              f"{geo['lanes']} lanes a pair, {strips} launch(es)); bound "
              f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']})")
        times[label] = {"pairs": b, "m": m, "n": n, "ms": ms,
                        "device_ms": dev_ms, "layout": geo["layout"],
                        "lanes": geo["lanes"], "strips": strips,
                        "bound_ms": bnd["bound_ms"],
                        "bound_by": bnd["bound_by"]}
        if label.startswith("main"):
            plain = cuda_ms(lambda: myers_plain(*args, mode), reps=2)
            out = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                   "shapes": f"{b} pairs, "
                   f"{m}x{n} uint8, HW", **bnd}
    out["max_abs_err"] = max_err
    out["case_ms"] = {k: v["ms"] for k, v in times.items()}
    out["case_device_ms"] = {k: v["device_ms"] for k, v in times.items()}
    out["case_bound_ms"] = {k: v["bound_ms"] for k, v in times.items()}
    details["k1_cases"] = times
    return out


def myers_bound(q, ql, t, tl) -> dict:
    """K1's bound for one batch (numpy inputs): the operations of each
    pair's words and columns, and the bytes of the inputs read once and
    the distances written once."""
    words = (ql.astype(np.int64) + 31) // 32
    cols = tl.astype(np.int64)
    ops = float((words * cols).sum() * MYERS_OPS_PER_WORD
                + cols.sum() * MYERS_OPS_PER_COLUMN)
    # q and t bytes, the int32 qlens, tlens and distances, the letter table
    return bound(q.nbytes + t.nbytes + 12 * len(q) + 256, ops)


def _seq(prng, k):
    return "".join(prng.choice("ACGT") for _ in range(k))


def _mutate(prng, s):
    """4% deletions, 4% substitutions, 2% insertions."""
    out = []
    for ch in s:
        r = prng.random()
        if r < 0.04:
            continue
        out.append(prng.choice("ACGT") if r < 0.08 else ch)
        if prng.random() < 0.02:
            out.append(prng.choice("ACGT"))
    return "".join(out)


def _gotoh_jobs(rng, n_jobs, lo, hi, multi_frac):
    from delly_tpu_torch.ops.gotoh import gotoh, to_align

    prng = random.Random(int(rng.integers(0, 2 ** 31)))
    jobs = []
    for _ in range(n_jobs):
        base = _seq(prng, prng.randint(lo, hi))
        a1 = to_align(_mutate(prng, base))
        if prng.random() < multi_frac:
            a1 = gotoh(a1, _mutate(prng, base), ac=(True, True))[1]
        jobs.append((a1, to_align(_mutate(prng, base))))
    return jobs


def check_gotoh(dev, rng, details, step_ns):
    """K2/K2-tb against the plain versions at the main path's shape and
    at every K bucket in all four end-gap configs; times the main shape
    (the kernels line) and each bucket. K2-tb's chain floor: the main
    shape's longest walk x `step_ns`, the chase probe's step."""
    import torch

    from delly_tpu_torch.ops.gotoh import DnaScore
    from delly_tpu_torch.ops.gotoh_cuda import (
        _bucket_k, gotoh_forward, gotoh_forward_plain, gotoh_traceback,
        gotoh_traceback_plain, pack_bucket,
    )

    sc = DnaScore()
    acs = [(True, True), (False, False), (True, False), (False, True)]
    # (label, K, merges, lengths lo...hi, share of multi-row profiles,
    # end-gap configs)
    cases = [("main: MSA merges", 128, 1635, 70, 118, 0.5, acs[:1])]
    cases += [("bucket", K, n, lo, hi, multi, acs)
              for K, n, lo, hi, multi in (
                  (128, 64, 70, 118, 0.5), (256, 48, 140, 230, 0.3),
                  (512, 24, 300, 470, 0.3), (1024, 8, 560, 940, 0.3),
                  (2048, 4, 1100, 1900, 0.3), (4096, 2, 2100, 4000, 0.0))]
    k2, tb, buckets = {}, {}, {}
    err2 = errtb = 0
    for label, K, n_jobs, lo, hi, multi, ac_list in cases:
        jobs = _gotoh_jobs(rng, n_jobs, lo, hi, multi)
        need(_bucket_k(max(max(a.shape[1], b.shape[1]) for a, b in jobs))
             == K, f"K2 {label}: jobs outside bucket {K}")
        packed = [torch.from_numpy(x).to(dev)
                  for x in pack_bucket(jobs, K, sc)]
        ml, nl = packed[3], packed[4]
        rows = torch.arange(K, device=dev)
        cell = ((rows[None, :, None] < ml[:, None, None])
                & (rows[None, None, :] < nl[:, None, None]))
        for ac in ac_list:
            fargs = (*packed, ac[0], ac[1], sc.go, sc.ge)
            best, bits = gotoh_forward(*fargs)
            pbest, pbits = gotoh_forward_plain(*fargs)
            codes, lens = gotoh_traceback(bits, ml, nl)
            pcodes, plens = gotoh_traceback_plain(pbits, ml, nl)
            torch.cuda.synchronize()
            e_best = int((best.long() - pbest.long()).abs().max())
            e_bits = int(torch.where(cell, bits.int() - pbits.int(), 0)
                         .abs().max())
            need(e_best == 0 and e_bits == 0,
                 f"K2 != plain on {label} K={K} ac={ac} (best {e_best}, "
                 f"bits {e_bits})")
            slot = torch.arange(2 * K, device=dev)[None, :] < lens[:, None]
            e_tb = int(torch.where(slot, codes.int() - pcodes.int(), 0)
                       .abs().max())
            need(torch.equal(lens, plens) and e_tb == 0,
                 f"K2-tb != plain on {label} K={K} ac={ac}")
            err2 = max(err2, e_best, e_bits)
            errtb = max(errtb, e_tb)
        print(f"K2/K2-tb {label}: {n_jobs} merges, K={K}, "
              f"{len(ac_list)} end-gap configs: equal")
        fargs = (*packed, ac_list[0][0], ac_list[0][1], sc.go, sc.ge)
        ms = cuda_ms(lambda: gotoh_forward(*fargs), reps=20)
        _best, bits = gotoh_forward(*fargs)
        tb_ms = cuda_ms(lambda: gotoh_traceback(bits, ml, nl), reps=20)
        tb_dev = device_ms(lambda: gotoh_traceback(bits, ml, nl))
        lens = gotoh_traceback(bits, ml, nl)[1]
        mn = (ml.long() * nl.long()).sum().item()
        if label.startswith("main"):
            steps = int(lens.long().sum())
            k2 = {"ms": ms,
                  "plain_ms": cuda_ms(lambda: gotoh_forward_plain(*fargs),
                                      reps=2, warmup=0),
                  "shapes": f"{n_jobs} merges, K={K}, ac={ac_list[0]}, "
                            f"{sum(a.shape[0] > 1 for a, _ in jobs)} "
                            f"multi-row profiles",
                  **bound(sum(x.numel() * 4 for x in packed) + 4 * n_jobs
                          + mn, mn * GOTOH_OPS_PER_CELL)}
            longest = int(lens.max())
            floor_ms = longest * step_ns * 1e-6
            tb = {"ms": tb_ms, "device_ms": tb_dev,
                  "plain_ms": cuda_ms(
                      lambda: gotoh_traceback_plain(bits, ml, nl), reps=2,
                      warmup=0),
                  "shapes": f"{n_jobs} tiles {K}x{K} uint8, {steps} walk "
                            f"steps",
                  "longest_walk_steps": longest, "smem_step_ns": step_ns,
                  "chain_floor_ms": floor_ms,
                  **bound(2 * steps + 12 * n_jobs, 8 * steps)}
            print(f"K2-tb main: {tb_ms:.5f} ms through the wrapper, "
                  f"{tb_dev:.5f} ms replayed, for {n_jobs} walks, longest "
                  f"{longest} steps, chain floor {floor_ms:.5f} ms")
        else:
            buckets[K] = {"merges": n_jobs, "cells": mn, "ms": ms,
                          "ns_per_cell": ms * 1e6 / mn, "tb_ms": tb_ms,
                          "tb_device_ms": tb_dev,
                          "tb_longest_walk": int(lens.max())}
            print(f"K2 K={K}: {ms:.4f} ms for {n_jobs} merges, {mn} cells "
                  f"({ms * 1e6 / mn:.4f} ns per cell), ac={ac_list[0]}; "
                  f"K2-tb {tb_ms:.5f} ms, {tb_dev:.5f} ms replayed, longest "
                  f"walk {int(lens.max())} steps")
    k2["max_abs_err"] = err2
    tb["max_abs_err"] = errtb
    details["k2_cases"] = [f"{c[0]} K={c[1]}" for c in cases]
    details["k2_buckets"] = buckets
    return k2, tb


def banded_vs_plain(dev, fargs, label) -> dict:
    """K3 and K3-tb against their plain versions on one launch's inputs
    fargs = (s1, s2, mlen, nlen, B, hfree, vfree, match, mismatch, go,
    ge), all on the card: exact equality of best, the bits of rows
    1..m, lens and the codes. Returns the plain versions' times, the
    work counts of the bounds and the largest differences (0)."""
    import torch

    from delly_tpu_torch.ops.gotoh_banded_cuda import (
        banded_forward, banded_forward_plain, banded_traceback,
        banded_traceback_plain,
    )

    s1, _s2, ml, nl, B = fargs[:5]
    best, bits = banded_forward(*fargs)
    codes, lens = banded_traceback(bits, ml, nl)
    (pbest, pbits), p_ms = timed(lambda: banded_forward_plain(*fargs))
    (pcodes, plens), ptb_ms = timed(
        lambda: banded_traceback_plain(pbits, ml, nl))
    e_best = int((best.long() - pbest.long()).abs().max())
    e_bits = e_tb = 0
    for g, (m, k) in enumerate(zip(ml.tolist(), lens.tolist())):
        e_bits = max(e_bits, int((bits[g, :m].int() - pbits[g, :m].int())
                                 .abs().max()))
        e_tb = max(e_tb, int((codes[g, :k].int() - pcodes[g, :k].int())
                             .abs().max()) if k else 0)
    need(e_best == 0 and e_bits == 0,
         f"K3 != plain on {label} (best {e_best}, bits {e_bits})")
    need(torch.equal(lens, plens) and e_tb == 0, f"K3-tb != plain on {label}")
    rows = int(ml.long().sum())
    return {"plain_ms": p_ms, "tb_plain_ms": ptb_ms, "err": e_best,
            "tb_err": e_tb, "rows": rows, "cells": rows * B,
            "in_bytes": rows + int(nl.long().sum()) + 8 * len(ml),
            "steps": int(lens.long().sum()), "jobs": len(ml),
            "longest_walk": int(lens.max()),
            "M": s1.shape[1], "B": B}


def _banded_jobs(prng, n_jobs, lo, hi, n_one):
    """Single-row pairs of a random sequence and a mutated copy, the
    longer first (the kernels take n <= m); with n_one, one more job
    whose second sequence is one base."""
    from delly_tpu_torch.ops.gotoh import to_align

    jobs = []
    for _ in range(n_jobs):
        base = _seq(prng, prng.randint(lo, hi))
        a, b = to_align(base), to_align(_mutate(prng, base))
        jobs.append((a, b) if a.shape[1] >= b.shape[1] else (b, a))
    if n_one:
        jobs.append((jobs[0][0], jobs[0][0][:, 5:6].copy()))
    return jobs


def check_banded(dev, rng, details) -> int:
    """K3/K3-tb against the plain versions at every band in all four
    end-gap configs (M = 256), at every band with M = 16,384, and at
    m = 32,768; swapped and n = 1 jobs, and one call mixing every band,
    through gotoh_banded_batch against the host corridor. Returns the
    largest difference (0)."""
    import torch

    from delly_tpu_torch.ops.gotoh import DnaScore, to_align
    from delly_tpu_torch.ops.gotoh_banded import gotoh_banded_host
    from delly_tpu_torch.ops.gotoh_banded_cuda import (
        BANDS, _bucket_m, gotoh_banded_batch, pack_jobs,
    )

    prng = random.Random(int(rng.integers(0, 2 ** 31)))
    sc = DnaScore()
    acs = [(True, True), (False, False), (True, False), (False, True)]
    cases = [(f"M=256 B={B} ac={ac}", 8, 150, 256, B, ac)
             for B in BANDS for ac in acs]
    cases += [(f"M=16384 B={B} ac={acs[i]}", 3, 8300, 9500, B, acs[i])
              for i, B in enumerate(BANDS)]
    err = 0
    t0 = time.time()
    for label, n_jobs, lo, hi, B, ac in cases:
        jobs = _banded_jobs(prng, n_jobs, lo, hi, n_one=True)
        M = _bucket_m(max(a.shape[1] for a, _ in jobs))
        packed = [torch.from_numpy(x).to(dev) for x in pack_jobs(jobs, M)]
        r = banded_vs_plain(dev, (*packed, B, ac[0], ac[1], sc.match,
                                  sc.mismatch, sc.go, sc.ge), label)
        err = max(err, r["err"], r["tb_err"])
        print(f"K3/K3-tb {label}: {len(jobs)} jobs (n=1 included): equal")
    base = _seq(prng, 32768)
    jobs = [(to_align(base), to_align(_mutate(prng, base)[:32768]))]
    packed = [torch.from_numpy(x).to(dev) for x in pack_jobs(jobs, 32768)]
    r = banded_vs_plain(dev, (*packed, 4096, True, True, sc.match,
                              sc.mismatch, sc.go, sc.ge), "m=32768")
    err = max(err, r["err"], r["tb_err"])
    print(f"K3/K3-tb m=32768 B=4096: equal (plain {r['plain_ms']:.0f} ms, "
          f"walk {r['tb_plain_ms']:.0f} ms)")
    # the batch entry point on the card: transposed jobs and n = 1
    base = _seq(prng, 3000)
    other = _mutate(prng, base)
    pairs = [(base, other), (other, base), (base, "A"), ("C", base)]
    got = gotoh_banded_batch(pairs, ac=(True, False), sc=sc, band=1024)
    for (x, y), (score, merged) in zip(pairs, got):
        a1, a2 = to_align(x), to_align(y)
        if a2.shape[1] > a1.shape[1]:
            ws, wm = gotoh_banded_host(a2, a1, ac=(False, True), sc=sc,
                                       band=1024)
            wm = np.concatenate([wm[1:], wm[:1]], axis=0)
        else:
            ws, wm = gotoh_banded_host(a1, a2, ac=(True, False), sc=sc,
                                       band=1024)
        need(score == ws and np.array_equal(merged, wm),
             "gotoh_banded_batch on the card != host corridor")
    print("K3/K3-tb gotoh_banded_batch, swapped and n=1 jobs: equal to the "
          "host corridor")
    # one call, a band per job: every band's launches on their own streams
    bands = list(BANDS) + [1024]
    pairs = [(x, _mutate(prng, x)) for x in (_seq(prng, 2500) for _ in bands)]
    pairs[-1] = pairs[-1][::-1]
    got = gotoh_banded_batch(pairs, ac=(True, True), sc=sc, band=bands)
    for (x, y), band, (score, merged) in zip(pairs, bands, got):
        a1, a2 = to_align(x), to_align(y)
        if a2.shape[1] > a1.shape[1]:
            ws, wm = gotoh_banded_host(a2, a1, ac=(True, True), sc=sc,
                                       band=band)
            wm = np.concatenate([wm[1:], wm[:1]], axis=0)
        else:
            ws, wm = gotoh_banded_host(a1, a2, ac=(True, True), sc=sc,
                                       band=band)
        need(score == ws and np.array_equal(merged, wm),
             f"gotoh_banded_batch with mixed bands != host corridor ({band})")
    print("K3/K3-tb gotoh_banded_batch, one call of mixed bands: equal to the "
          "host corridor")
    details["k3_cases"] = [c[0] for c in cases] + [
        "m=32768 B=4096", "batch: swapped, n=1", "batch: mixed bands"]
    details["k3_check_s"] = time.time() - t0
    return err


def measure_banded(dev, launches, err, sass_loops, step_ns) -> tuple:
    """The main path's K3/K3-tb numbers from the long-split run's own
    launches (their inputs, recorded during the run): each held against
    the plain versions; then the run's corridor jobs timed as a whole,
    all launches at once on their own streams as gotoh_banded_batch runs
    them (run_concurrently, with the keyword arguments each launch had),
    and each launch alone. Bounds and plain
    times are sums over the launches. Beside the bound, the time the
    integer instructions of K3's interior row loops (`sass_loops`, from
    kernel_sass) would take at the card's int32 rate, and K3-tb's chain
    floor: the longest walk's steps x one dependent shared-memory load
    (`step_ns`, the chase probe's time in this run)."""
    from delly_tpu_torch.ops.gotoh_banded_cuda import (
        banded_forward, banded_traceback, run_concurrently,
    )

    sass_ops = 0
    tot = {"plain_ms": 0.0, "tb_plain_ms": 0.0, "rows": 0, "cells": 0,
           "in_bytes": 0, "steps": 0, "jobs": 0}
    shapes, alone, tb_alone, longest = [], [], [], 0
    for i, (fargs, kw, out) in enumerate(launches):
        r = banded_vs_plain(dev, fargs, f"long-split launch {i}")
        err = max(err, r["err"], r["tb_err"])
        for k in tot:
            tot[k] += r[k]
        longest = max(longest, r["longest_walk"])
        threads = r["B"] // 4           # K3 runs 4 slots per thread
        sass_ops += r["rows"] * threads * sass_loops[(4, threads)]
        alone.append(cuda_ms(lambda: banded_forward(*fargs, **kw), reps=5))
        tb_alone.append(cuda_ms(lambda: banded_traceback(
            out[1], fargs[2], fargs[3]), reps=5))
        shapes.append(f"{r['jobs']}x(M={r['M']}, B={r['B']})")
    print(f"K3/K3-tb long-split launches ({', '.join(shapes)}): equal")
    fwd = [lambda f=f, kw=kw: banded_forward(*f, **kw)
           for f, kw, _out in launches]
    tb = [lambda f=f, o=o: banded_traceback(o[1], f[2], f[3])
          for f, _kw, o in launches]
    ms = cuda_ms(lambda: run_concurrently(dev, fwd), reps=5)
    tb_ms = cuda_ms(lambda: run_concurrently(dev, tb), reps=5)
    desc = (f"{tot['jobs']} jobs in {len(launches)} launches at once: "
            f"{', '.join(shapes)}; {tot['rows']} DP rows")
    G = tot["jobs"]
    sass_ms = sass_ops / INT32_OPS_PER_S * 1e3
    floor_ms = longest * step_ns * 1e-6
    print(f"K3 long-split jobs: {ms:.4f} ms at once, launches alone "
          f"{[round(x, 4) for x in alone]} ms; {sass_ops} integer "
          f"instructions in their interior row loops, {sass_ms:.4f} ms at "
          f"the int32 rate")
    print(f"K3-tb long-split jobs: {tb_ms:.4f} ms at once, launches alone "
          f"{[round(x, 4) for x in tb_alone]} ms; longest walk {longest} "
          f"steps, chain floor {floor_ms:.4f} ms")
    k3 = {"ms": ms, "plain_ms": tot["plain_ms"], "max_abs_err": err,
          "shapes": desc, "launch_ms_alone": alone,
          "row_loop_integer_instructions": sass_ops,
          "row_loop_ms_at_int32_rate": sass_ms,
          **bound(tot["in_bytes"] + tot["cells"] + 4 * G,
                  tot["cells"] * BANDED_OPS_PER_CELL)}
    tb = {"ms": tb_ms, "plain_ms": tot["tb_plain_ms"], "max_abs_err": err,
          "shapes": f"{desc}; {tot['steps']} walk steps",
          "launch_ms_alone": tb_alone, "longest_walk_steps": longest,
          "smem_step_ns": step_ns, "chain_floor_ms": floor_ms,
          **bound(2 * tot["steps"] + 12 * G,
                  tot["steps"] * BANDED_TB_OPS_PER_STEP)}
    return k3, tb


def _lcs_batch(rng, lengths, letters=b"ACGT"):
    """A padded (a, alens, b, blens) batch of (m, n) lengths: every
    other b a mutated copy of its a (5% substitutions), as split reads
    of one SV are, the rest unrelated; padding bytes 0."""
    alpha = np.frombuffer(letters, dtype=np.uint8)
    nb = len(lengths)
    a = np.zeros((nb, max(1, max(m for m, _ in lengths))), dtype=np.uint8)
    b = np.zeros((nb, max(1, max(n for _, n in lengths))), dtype=np.uint8)
    for i, (m, n) in enumerate(lengths):
        base = alpha[rng.integers(0, len(alpha), max(m, n))]
        a[i, :m] = base[:m]
        y = (base[:n].copy() if i % 2 == 0
             else alpha[rng.integers(0, len(alpha), n)])
        hit = rng.random(n) < 0.05
        y[hit] = alpha[rng.integers(0, len(alpha), int(hit.sum()))]
        b[i, :n] = y
    return (a, np.array([m for m, _ in lengths], dtype=np.int32), b,
            np.array([n for _, n in lengths], dtype=np.int32))


def lcs_bound(a, al, b, bl) -> dict:
    """X1's bound for one batch (numpy inputs): LCS_OPS_PER_WORD integer
    operations for every word step the pairs need, sum over the pairs of
    (rows of a whose letter occurs in b) x ceil(n_i / 64), and the bytes
    of the inputs read once and the lengths written once."""
    nb = len(a)
    in_b = np.zeros((nb, 256), dtype=bool)
    held = np.arange(b.shape[1])[None, :] < bl[:, None]
    in_b[np.nonzero(held)[0], b[held]] = True
    rows = (in_b[np.arange(nb)[:, None], a]
            & (np.arange(a.shape[1])[None, :] < al[:, None])).sum(1)
    steps = int((rows * ((bl.astype(np.int64) + 63) // 64)).sum())
    # a and b bytes, the int32 alens, blens and lengths, the letter table
    out = bound(a.nbytes + b.nbytes + 12 * nb + 256,
                LCS_OPS_PER_WORD * steps)
    out["word_steps"] = steps
    return out


def lcs_steps(al, bl) -> int:
    """The longest chain of wavefront steps a batch's pairs take in X1
    (ops/lcs_cuda.py LAYOUTS): m + G K - 1 steps a strip, G the pair's
    lanes and K their words, a strip per STRIP_WORDS words of b in the
    last layout."""
    from delly_tpu_torch.ops import lcs_cuda

    if not len(al):
        return 0
    lay = lcs_cuda.layout_of(bl)
    gk = np.array([np.prod(lcs_cuda.LAYOUTS[x]) for x in lay])
    strips = np.maximum(1, -(-((bl.astype(np.int64) + 63) // 64)
                             // lcs_cuda.STRIP_WORDS))
    strips[lay != len(lcs_cuda.LAYOUTS) - 1] = 1
    return int(((al > 0) * (al.astype(np.int64) + gk - 1) * strips).max())


def lcs_case(dev, args, nalpha, label, plain=False, recorded=None,
             host=None, step_ns=None) -> dict:
    """X1 on one batch of card tensors (a, alens, b, blens, lut) against
    lcs_plain on the card (exact; and the lengths a run `recorded` for
    these inputs), with the host's lengths `host` (a run's own call's,
    or the tensors' copied here) and without them, timed with them
    through the wrapper (CUDA events, 20 calls after a warm-up), with
    its bound, its chain floor (lcs_steps x `step_ns`, the X1 step
    probe) and, if `plain`, the plain version's time."""
    import torch

    from delly_tpu_torch.ops.lcs_cuda import lcs
    from delly_tpu_torch.ops.msa import lcs_plain

    a, al, b, bl = (x.cpu().numpy() for x in args[:4])
    host = (al, bl) if host is None else host
    want = lcs_plain(*args[:4])
    got = lcs(*args, nalpha, host_lengths=host)
    bare = lcs(*args, nalpha)
    torch.cuda.synchronize()
    err = int((got.long() - want).abs().max()) if len(got) else 0
    need(torch.equal(got.long(), want), f"X1 != plain on {label} "
         f"(max {err})")
    need(torch.equal(bare.long(), want), f"X1 without the host's lengths "
         f"!= plain on {label}")
    need(recorded is None or torch.equal(recorded.long(), want),
         f"{label}: the run's X1 lengths != plain")
    ms = cuda_ms(lambda: lcs(*args, nalpha, host_lengths=host), reps=20)
    steps = lcs_steps(al, bl)
    out = {"pairs": len(a), "m": a.shape[1], "n": b.shape[1],
           "nalpha": nalpha, "ms": ms, "max_abs_err": err,
           "longest_steps": steps, "ns_per_step": ms * 1e6 / max(steps, 1),
           **lcs_bound(a, al, b, bl)}
    if step_ns is not None:
        out["chain_floor_ms"] = steps * step_ns * 1e-6
    if plain:
        out["plain_ms"] = timed(lambda: lcs_plain(*args[:4]))[1]
    print(f"X1 {label}: {len(a)} pairs {a.shape[1]}x{b.shape[1]}, "
          f"{nalpha} letters: equal (with and without the host's lengths); "
          f"{ms:.4f} ms through the wrapper, {steps} steps in the longest "
          f"chain ({out['ns_per_step']:.1f} ns a step); bound "
          f"{out['bound_ms']:.5f} ms ({out['bound_by']}, "
          f"{out['word_steps']} word steps)"
          + (f"; chain floor {out['chain_floor_ms']:.4f} ms"
             if step_ns is not None else "")
          + (f"; plain {out['plain_ms']:.1f} ms" if plain else ""))
    return out


def check_lcs(dev, details, step_ns) -> dict:
    """X1 against lcs_plain on the card at the sr runs' shapes: deepgeno's
    split reads (~150 b), long-split's ~12 kb split reads beside short
    ones in one padded batch (96 pairs); and at the edges: empty
    strings, lengths 63/64/65/127/128/129, N letters, b of 16,385 to
    40,000 bases (strips), 200 letters (masks in global memory) and b at
    each layout's edge. Exact equality; each case timed."""
    import torch

    from delly_tpu_torch.ops.lcs_cuda import LAYOUTS, letter_lut

    rng = np.random.default_rng(SEED + 1)
    edges = (0, 1, 63, 64, 65, 127, 128, 129)
    cases = [
        ("deepgeno ~150 b", [(140 + i % 21, 150 - i % 17)
                             for i in range(4000)], b"ACGT"),
        ("long-split mix", [(11_800 + 13 * i, 12_300 - 11 * i)
                            for i in range(48)]
         + [(150 - i % 9, 140 + i % 13) for i in range(48)], b"ACGTN"),
        ("edges", [(m, n) for m in edges for n in edges], b"ACGT"),
        ("N letters", [(150, 150)] * 200, b"ACGTN"),
        ("b of 16-40 kb", [(400, 20_000), (400, 16_385), (300, 40_000),
                           (200, 100)] * 4, b"ACGT"),
        ("200 letters", [(300, 12_000)] * 6 + [(200, 190)] * 4,
         bytes(range(20, 220))),
        ("layout edges", [(100 + 3 * i, 64 * g * k + d) for i, (g, k) in
                          enumerate(LAYOUTS) for d in (-1, 0, 1)], b"ACGT")]
    out = {}
    for label, lengths, letters in cases:
        a, al, b, bl = _lcs_batch(rng, lengths, letters)
        lut, nalpha = letter_lut(b, bl)
        args = [torch.from_numpy(x).to(dev) for x in (a, al, b, bl, lut)]
        out[label] = lcs_case(dev, args, nalpha, label, step_ns=step_ns,
                              plain=label.startswith(("deepgeno", "long")))
    details["x1_cases"] = out
    return out


def check_recorded_lcs(dev, records, details, step_ns) -> dict:
    """Holds every X1 call recorded in the sr runs ({run: recorder
    list}) equal to lcs_plain on the card, with the call's own host
    lengths and without, and times each through the wrapper, long-split's
    and deepgeno's beside the plain version."""
    out = {}
    for label, record in records.items():
        for args, kw, got in record:
            out.setdefault(label, []).append(lcs_case(
                dev, list(args[:5]), args[5], f"{label}, recorded",
                plain=label in ("sr long-split", "sr deepgeno"),
                recorded=got, host=kw.get("host_lengths"), step_ns=step_ns))
    details["x1_recorded"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 3: the sr slice end to end
# ---------------------------------------------------------------------------

def recorder(record: list):
    """Stand-in maker that appends each call's (arguments, keyword
    arguments, result) to `record`."""
    def make(fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            record.append((args, kwargs, out))
            return out
        return recorded
    return make


def timer(acc: dict):
    """Stand-in maker that adds each call's seconds and count to `acc`."""
    def make(fn):
        def timed_call(*args, **kwargs):
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                acc["s"] += time.time() - t0
                acc["calls"] += 1
        return timed_call
    return make


def msa_timers() -> tuple:
    """(acc, wraps) that time, in one run, the host full DP (merges the
    kernels do not serve), the corridor batches (K3/K3-tb with the host
    packing around them), the wide batches (K4/K4-tb with theirs) and
    the batched LCS of the MSA."""
    from delly_tpu_torch.ops import gotoh_cuda, gotoh_wide_cuda, msa

    acc = {k: {"s": 0.0, "calls": 0}
           for k in ("host_full_dp", "corridor_batches", "wide_batches",
                     "lcs_pairs")}
    wraps = [(gotoh_cuda, "gotoh_host", timer(acc["host_full_dp"])),
             (gotoh_wide_cuda, "gotoh_wide_batch",
              timer(acc["wide_batches"])),
             (msa, "gotoh", timer(acc["host_full_dp"])),
             (msa, "_banded_or_full", timer(acc["corridor_batches"])),
             (msa, "lcs_pairs", timer(acc["lcs_pairs"]))]
    return acc, wraps


def print_msa_split(label, stages, acc, details) -> None:
    asm = stages["Split-read assembly"]
    print(f"{label}: split-read assembly {asm:.3f}s; " + ", ".join(
        f"{k} {v['s']:.3f}s in {v['calls']} calls" for k, v in acc.items())
        + f"; host full DP {acc['host_full_dp']['s'] / asm:.1%} of it")
    details["runs"][label]["assembly_split"] = acc


def run_card(argv, details, label, wraps=(), quiet=False):
    """One CLI run on the card between a reset and a read of the launch
    counters, timed by stage. `wraps` holds (module, name, make) triples:
    module.name is replaced by make(module.name) for the run and put
    back after it. `quiet` keeps the run's lines off the output (the
    caller prints a sum over many runs)."""
    from delly_tpu_torch.cli import main
    from delly_tpu_torch.parallel import dispatch
    from delly_tpu_torch.utils import log

    saved = [(mod, name, getattr(mod, name)) for mod, name, _make in wraps]
    for (mod, name, make), (_m, _n, fn) in zip(wraps, saved):
        setattr(mod, name, make(fn))
    marks = []
    log.hook = lambda msg: marks.append((time.time(), msg))
    dispatch.reset()
    t0 = time.time()
    try:
        rc = main(argv)
    finally:
        log.hook = None
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    import torch
    torch.cuda.synchronize()
    t1 = time.time()
    counts = dispatch.snapshot()
    hits = dispatch.device_snapshot()
    need(rc == 0, f"{label}: exited {rc}")
    stages = {}
    pts = [(t0, "startup")] + marks + [(t1, None)]
    for (ts, msg), (te, _nx) in zip(pts, pts[1:]):
        if msg is not None:
            key = msg.split(",")[0][:40]
            stages[key] = stages.get(key, 0.0) + (te - ts)
    if not quiet:
        print(f"{label}: wall {t1 - t0:.3f}s, launches {counts}")
        for k, v in stages.items():
            print(f"  {k}: {v:.3f}s")
    details.setdefault("runs", {})[label] = {
        "wall_s": t1 - t0, "stages": stages, "launches": counts,
        "device_hits": hits}
    return counts, stages


def output_lines(path) -> list:
    """An output's lines for comparison: BCF decoded to VCF text, a gzip
    file decompressed (its header holds its write time), the ##fileDate
    line dropped."""
    import gzip

    from delly_tpu_torch.io.bcf import bcf_to_vcf_text

    with open(path, "rb") as fh:
        data = fh.read()
    if path.endswith(".bcf"):
        text = bcf_to_vcf_text(data)
    elif data[:2] == b"\x1f\x8b":
        text = gzip.decompress(data).decode()
    else:
        text = data.decode()
    return [ln for ln in text.splitlines() if not ln.startswith("##fileDate")]


def records(path) -> list:
    """A VCF's or BCF's record lines, split into columns."""
    return [ln.split("\t") for ln in output_lines(path)
            if ln and not ln.startswith("#")]


def vcf_calls(path) -> list:
    """(SVTYPE, chrom, pos, ALT, GT) of each record."""
    return [([f for f in r[7].split(";") if f.startswith("SVTYPE=")][0][7:],
             r[0], int(r[1]), r[4], r[9].split(":")[0]) for r in records(path)]


def svmix_score(vcf, truth):
    calls = [c[:3] for c in vcf_calls(vcf)]
    win = {"DEL": 100, "DUP": 150, "INS": 100, "INV": 400, "BND": 150}

    def match(t, svt, cc, cp):
        if t[0] == "BND":
            return svt == "BND" and (
                (cc == t[1] and abs(cp - int(t[2])) < win["BND"])
                or (cc == t[3] and abs(cp - int(t[4])) < win["BND"]))
        return svt == t[0] and cc == t[1] and abs(cp - int(t[2])) < win[t[0]]

    tp = sum(any(match(t, *c) for c in calls) for t in truth)
    good = sum(any(match(t, *c) for t in truth) for c in calls)
    return tp, len(truth), good, len(calls)


def phase_e2e(work, details):
    from delly_tpu_torch.ops import gotoh_banded_cuda, lcs_cuda
    from delly_tpu_torch.testing.synth import (
        LONG_SPLIT, make_deep_geno_dataset, make_long_split_dataset,
        make_multi_sv_dataset,
    )

    t0 = time.time()
    sv_bam, sv_fa, sv_truth = make_multi_sv_dataset(
        work, n_contigs=8, contig_len=1_500_000, pairs_per_contig=40_000)
    dg_bam, dg_fa, _dg_truth = make_deep_geno_dataset(
        work, n_contigs=4, contig_len=1_500_000, dels_per_contig=150,
        coverage=45)
    ls_bam, ls_fa, ls_truth = make_long_split_dataset(work, **LONG_SPLIT)
    print(f"datasets: svmix, deepgeno and long-split generated in "
          f"{time.time() - t0:.1f}s")
    details["gen_s"] = time.time() - t0

    p = lambda name: os.path.join(work, name)  # noqa: E731
    cmds = {
        "sr svmix": ["sr", "-g", sv_fa, "-o", p("svmix.{}.vcf"), sv_bam],
        "sr deepgeno": ["sr", "-g", dg_fa, "-o", p("deepgeno.{}.vcf"),
                        dg_bam],
        "sr -v deepgeno": ["sr", "-v", p("deepgeno.cuda.vcf"), "-g", dg_fa,
                           "-o", p("regeno.{}.vcf"), dg_bam],
        "sr long-split": ["sr", "-g", ls_fa, "-o", p("longsplit.{}.vcf"),
                          ls_bam],
    }
    # the kernels each run's path must have launched
    path = {"sr svmix": ("myers", "gotoh", "gotoh_tb", "lcs"),
            "sr deepgeno": ("myers", "gotoh", "gotoh_tb", "lcs"),
            "sr -v deepgeno": ("myers",),
            "sr long-split": ("myers", "gotoh_banded", "gotoh_banded_tb",
                              "lcs")}
    launches = {}
    k3_launches = []
    lcs_records = {}
    for label, argv in cmds.items():
        argv = [a.replace("{}", "cuda") if a.endswith(".{}.vcf") else a
                for a in argv]
        acc, wraps = msa_timers()
        rec = lcs_records.setdefault(label, [])
        wraps.append((lcs_cuda, "lcs", recorder(rec)))
        if label == "sr long-split":
            wraps.append((gotoh_banded_cuda, "banded_forward",
                          recorder(k3_launches)))
        launches[label], stages = run_card(argv, details, label, wraps)
        if "Split-read assembly" in stages:
            print_msa_split(label, stages, acc, details)
        lcs_once(label, launches[label], acc, rec)
        need(launches[label]["host_routes"] == 0,
             f"{label}: {launches[label]['host_routes']} host routes")
        for name in path[label]:
            need(launches[label][name] > 0, f"{label}: {name} never launched")

    tp, nt, good, nc = svmix_score(p("svmix.cuda.vcf"), sv_truth)
    print(f"svmix: recall {tp}/{nt}, precision {good}/{nc}")
    details["svmix"] = {"tp": tp, "truth": nt, "good": good, "calls": nc}
    need(tp == nt == 36 and good == nc, "svmix truth check")
    tp, nt, good, nc = svmix_score(p("longsplit.cuda.vcf"), ls_truth)
    print(f"long-split: recall {tp}/{nt}, precision {good}/{nc}")
    details["long_split"] = {"tp": tp, "truth": nt, "good": good,
                             "calls": nc, "k3_jobs": sum(
                                 len(a[0]) for a, _kw, _o in k3_launches)}
    need(tp == nt == 24 and good == nc, "long-split truth check")
    return launches, k3_launches, cmds, {k: v for k, v in
                                         lcs_records.items() if v}


def lcs_once(label, counts, acc, record) -> None:
    """Each lcs_pairs call of a run launched X1 once: the run's launches
    equal its X1 calls (wrapped by a recorder) and its lcs_pairs calls
    (timed by msa_timers)."""
    calls = acc["lcs_pairs"]["calls"]
    need(counts["lcs"] == len(record) == calls,
         f"{label}: {counts['lcs']} X1 launches, {len(record)} X1 calls, "
         f"{calls} lcs_pairs calls")


def start_host(args, err_path, **env) -> tuple:
    """Starts `python args` from the repository on the host
    (DELLY_TPU_TORCH_DEVICE=cpu, one torch thread, and `env`), its
    stderr into err_path: (process, t0, end times)."""
    err = open(err_path, "w")
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, *args], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=err, env=dict(os.environ, DELLY_TPU_TORCH_DEVICE="cpu",
                             OMP_NUM_THREADS="1", **env))
    err.close()
    ends = {}
    threading.Thread(target=lambda: ends.setdefault(
        "t", (proc.wait(), time.time())[1]), daemon=True).start()
    return proc, t0, ends


def wait_host(label, proc, err_path, t0, ends) -> float:
    """Waits for a process of start_host and fails unless it exited 0;
    returns its wall seconds."""
    rc = proc.wait()
    while "t" not in ends:
        time.sleep(0.01)
    with open(err_path) as fh:
        err = fh.read()
    need(rc == 0, f"{label} on cpu exited {rc}: {err[-1500:]}")
    return ends["t"] - t0


def start_cpu_runs(cmds: dict, p) -> list:
    """Starts the CPU runs (with their stage profiles): [(label, process,
    profile, stderr file, t0, end times)]. They write their VCFs beside
    the card's."""
    runs = []
    for label, argv in cmds.items():
        argv = [a.replace("{}", "cpu") if a.endswith(".{}.vcf") else a
                for a in argv]
        stem = label.replace(" ", "_")
        prof, err_path = p(f"profile.{stem}.json"), p(f"stderr.{stem}.txt")
        proc, t0, ends = start_host(["-m", "delly_tpu_torch.cli", *argv],
                                    err_path, DELLY_TPU_PROFILE=prof)
        runs.append((label, proc, prof, err_path, t0, ends))
    return runs


def finish_cpu_runs(runs: list, cmds: dict, details) -> None:
    """Waits for the CPU runs, prints their stage profiles and checks that
    every card VCF equals its CPU run's apart from ##fileDate."""
    for label, proc, prof, err_path, t0, ends in runs:
        wall = wait_host(label, proc, err_path, t0, ends)
        with open(prof) as fh:
            stages = json.load(fh)
        print(f"{label} on cpu: process wall {wall:.3f}s, "
              f"run {stages['wall_s']}s")
        for k, v in stages["stages"].items():
            print(f"  {k}: {v:.3f}s")
        details.setdefault("cpu_runs", {})[label] = {"process_wall_s": wall,
                                                     **stages}
    for argv in cmds.values():
        out = argv[argv.index("-o") + 1]
        a, b = (output_lines(out.replace("{}", dv)) for dv in ("cuda", "cpu"))
        stem = os.path.basename(out).split(".")[0]
        need(a == b, f"{stem}: card and cpu VCFs differ")
        print(f"{stem}: card VCF == cpu VCF ({len(a)} lines)")


# long split reads with 4 reads per DEL: the MSA merges profiles wider than
# K2's 4,096 columns, which run on K4/K4-tb; at 2 DELs (the card's VCF
# held to a CPU run) and at LONG_SPLIT's full size (made by a worker)
WIDE_2DEL = dict(n_contigs=1, contig_len=1_000_000, dels_per_contig=2,
                 reads_per_del=4, read_len=12_000, jitter=200,
                 pairs_per_contig=20_000, name="hostdp")
WIDE_DATASETS = {"long-split 4 reads": ("make_long_split_dataset", dict(
    n_contigs=4, contig_len=1_000_000, dels_per_contig=6, reads_per_del=4,
    read_len=12_000, jitter=200, pairs_per_contig=20_000,
    name="longsplit4"))}      # synth.LONG_SPLIT but for reads_per_del


def wide_recorder(record: list) -> list:
    """Wraps for run_card that record each K4 launch's inputs and best
    and the codes and lengths of the K4-tb launch after it (not the
    tiles, which a later check makes again from the inputs)."""
    from delly_tpu_torch.ops import gotoh_wide_cuda

    def fwd(fn):
        def recorded(*args):
            best, bits = fn(*args)
            record.append({"args": args, "best": best})
            return best, bits
        return recorded

    def tb(fn):
        def recorded(bits, ml, nl):
            codes, lens = fn(bits, ml, nl)
            record[-1].update(codes=codes, lens=lens)
            return codes, lens
        return recorded

    return [(gotoh_wide_cuda, "gotoh_wide_forward", fwd),
            (gotoh_wide_cuda, "gotoh_wide_traceback", tb)]


def phase_wide(work, details, wide_fut) -> tuple:
    """`sr` on the card on long split reads with 4 reads per DEL, first
    on one 1 Mb contig with 2 DELs, then at LONG_SPLIT's full size (24
    DELs, from a worker): the MSA merges profiles wider than K2's 4,096
    columns, which K4/K4-tb serve. Checks the truth (2/2, 24/24), 0 host
    routes and no host full DP, K4 and K4-tb launched once per launch
    of each other, and, at 24 DELs, more K4 launches than gotoh_wide_batch
    calls (a round's tiles cut under TILE_BUDGET); prints the seconds of
    split-read assembly in the wide batches (K4/K4-tb with the host
    packing around them), the corridor batches and the MSA's batched
    LCS. Records every K4/K4-tb launch for check_wide. Returns
    ({label: launches}, the 2-DEL run's command for the CPU runs,
    {label: records})."""
    from delly_tpu_torch.ops import lcs_cuda
    from delly_tpu_torch.testing.synth import (
        LONG_SPLIT, make_long_split_dataset,
    )

    need(WIDE_DATASETS["long-split 4 reads"][1] == dict(
        LONG_SPLIT, reads_per_del=4, name="longsplit4"),
        "the 24-DEL dataset is not LONG_SPLIT with 4 reads per DEL")
    bam, fa, truth = make_long_split_dataset(work, **WIDE_2DEL)
    made = wide_fut.result()
    print(f"datasets: long-split with 4 reads per DEL generated in "
          f"{made['seconds']:.1f}s by a worker")
    bam24, fa24, truth24 = made["long-split 4 reads"]
    p = lambda name: os.path.join(work, name)  # noqa: E731
    runs = {"sr long-split, 4 reads per DEL":
            (["sr", "-g", fa, "-o", p("hostdp.{}.vcf"), bam], truth, 2),
            "sr long-split, 4 reads per DEL, 24 DELs":
            (["sr", "-g", fa24, "-o", p("longsplit4.{}.vcf"), bam24],
             truth24, 24)}
    launches, records = {}, {}
    for label, (argv, want, n_del) in runs.items():
        acc, wraps = msa_timers()
        rec = []
        wraps.append((lcs_cuda, "lcs", recorder(rec)))
        wraps += wide_recorder(records.setdefault(label, []))
        argv = [a.replace("{}", "cuda") for a in argv]
        counts, stages = run_card(argv, details, label, wraps)
        launches[label] = counts
        lcs_once(label, counts, acc, rec)
        tp, nt, good, nc = svmix_score(argv[argv.index("-o") + 1], want)
        print(f"{label}: recall {tp}/{nt}, precision {good}/{nc}")
        need(tp == nt == n_del and good == nc, f"{label}: truth check")
        need(counts["host_routes"] == 0
             and acc["host_full_dp"]["calls"] == 0,
             f"{label}: {counts['host_routes']} host routes, "
             f"{acc['host_full_dp']['calls']} host full-DP calls")
        need(counts["gotoh_wide"] > 0
             and counts["gotoh_wide_tb"] == counts["gotoh_wide"]
             == len(records[label]),
             f"{label}: K4 {counts['gotoh_wide']}, K4-tb "
             f"{counts['gotoh_wide_tb']} launches")
        if n_del == 24:
            need(counts["gotoh_wide"] > acc["wide_batches"]["calls"],
                 f"{label}: {counts['gotoh_wide']} K4 launches in "
                 f"{acc['wide_batches']['calls']} gotoh_wide_batch calls")
        print_msa_split(label, stages, acc, details)
    return launches, {"sr long-split, 4 reads per DEL":
                      runs["sr long-split, 4 reads per DEL"][0]}, records


def check_wide(dev, records, details, step_ns) -> tuple:
    """Every K4/K4-tb launch of phase_wide's runs, from its recorded
    inputs: K4 again gives the run's best, and K4-tb on its tiles the
    run's codes and lengths. Each launch timed through the wrappers (CUDA
    events). Then the merges of every launch of both runs, their inputs
    padded to the largest tile and put side by side, go through the plain
    versions on the card at once (a row or a step of the plain versions
    costs about the same for one merge as for many), and every merge's
    best, bits of rows < mlen and columns < nlen, lens and codes must
    equal the kernels'. The kernels line takes the 24-DEL run's launches,
    summed, with their bounds (K2's 42 operations per cell, a byte
    written per cell) and K4-tb's chain floor (the longest walk x
    `step_ns`, the chase probe's step) and its ns a step (each launch's
    time over its longest walk) beside it; per merge, ms per launch over
    its merges beside one SM's and the whole card's operations bound for
    the run's mean merge; K4's strips (P, W) and blocks (G x P) per
    launch from strip_geometry, as the wrapper takes them."""
    import torch
    import torch.nn.functional as F

    from delly_tpu_torch.ops.gotoh_cuda import (
        gotoh_forward_plain, gotoh_traceback_plain,
    )
    from delly_tpu_torch.ops.gotoh_wide_cuda import (
        gotoh_wide_forward, gotoh_wide_traceback, strip_geometry,
    )

    recs = [(label, r) for label, rs in records.items() for r in rs]
    outs, alone, tb_alone, geo = [], [], [], []
    sms = details["int32_ops_per_s"]["sms"]
    for i, (label, r) in enumerate(recs):
        args = r["args"]
        ml, nl = args[3], args[4]
        G, N = args[0].shape[0], args[1].shape[2]
        P, W, C = strip_geometry(G, N, sms)
        geo.append((P, W, G * P))
        print(f"K4 launch {i} ({label}): G {G} merges of {args[0].shape[1]} "
              f"x {N}, P {P} strips of W {W} columns ({C} chunk(s) each), "
              f"{G * P} blocks on {sms} SMs")
        if label.endswith("24 DELs"):
            need(P >= 6 and G * P <= sms,
                 f"{label} launch {i}: {P} strips a merge, {G * P} blocks")
        best, bits = gotoh_wide_forward(*args)
        codes, lens = gotoh_wide_traceback(bits, ml, nl)
        same = torch.equal(best, r["best"]) and torch.equal(lens, r["lens"])
        for g, k in enumerate(lens.tolist()):
            same = same and torch.equal(codes[g, :k], r["codes"][g, :k])
        need(same, f"{label} launch {i}: K4/K4-tb again differ from the run")
        alone.append(cuda_ms(lambda: gotoh_wide_forward(*args), reps=3))
        tb_alone.append(cuda_ms(lambda: gotoh_wide_traceback(bits, ml, nl),
                                reps=3))
        outs.append((best, bits, codes, lens))
    M = max(r["args"][0].shape[1] for _l, r in recs)
    N = max(r["args"][1].shape[2] for _l, r in recs)

    def padded(k, x):       # prof (G, M, 6), wc2 (G, 5, N), d2 (G, N)
        if k == 0:
            return F.pad(x, (0, 0, 0, M - x.shape[1]))
        return F.pad(x, (0, N - x.shape[-1])) if k < 3 else x

    cat = [torch.cat([padded(k, r["args"][k]) for _l, r in recs])
           for k in range(5)]
    hv = recs[0][1]["args"][5:]
    need(all(r["args"][5:] == hv for _l, r in recs),
         "the wide runs' launches differ in end gaps or gap costs")
    (pbest, pbits), p_ms = timed(lambda: gotoh_forward_plain(*cat, *hv))
    (pcodes, plens), ptb_ms = timed(
        lambda: gotoh_traceback_plain(pbits, cat[3], cat[4]))
    g0, e_best, e_bits, e_tb = 0, 0, 0, 0
    for best, bits, codes, lens in outs:
        G = len(best)
        e_best = max(e_best, int((best.long() - pbest[g0:g0 + G].long())
                                 .abs().max()))
        need(torch.equal(lens, plens[g0:g0 + G]), "K4-tb != plain (lengths)")
        for g in range(G):
            m, n, k = (int(cat[3][g0 + g]), int(cat[4][g0 + g]),
                       int(lens[g]))
            e_bits = max(e_bits, int((bits[g, :m, :n].int()
                                      - pbits[g0 + g, :m, :n].int())
                                     .abs().max()))
            e_tb = max(e_tb, int((codes[g, :k].int()
                                  - pcodes[g0 + g, :k].int()).abs().max()))
        g0 += G
    need(e_best == 0 and e_bits == 0,
         f"K4 != plain (best {e_best}, bits {e_bits})")
    need(e_tb == 0, "K4-tb != plain (codes)")
    err = max(e_best, e_bits, e_tb)
    del outs, pbits
    print(f"K4/K4-tb: the wide runs' {len(recs)} launches, {g0} merges, "
          f"equal to the plain versions ({p_ms:.1f} / {ptb_ms:.1f} ms for "
          f"all at once)")
    per_run, sm_rate = {}, INT32_OPS_PER_S / details["int32_ops_per_s"]["sms"]
    for label in records:
        idx = [i for i, (lb, _r) in enumerate(recs) if lb == label]
        args = [recs[i][1]["args"] for i in idx]
        ml = torch.cat([a[3] for a in args]).long()
        nl = torch.cat([a[4] for a in args]).long()
        lens = torch.cat([recs[i][1]["lens"] for i in idx]).long()
        merges, cells = len(ml), int((ml * nl).sum())
        steps, longest = int(lens.sum()), int(lens.max())
        in_bytes = sum(x.numel() * 4 for a in args for x in a[:5])
        floor_ms = longest * step_ns * 1e-6
        shapes = [f"{len(a[3])}x({a[0].shape[1]}x{a[1].shape[2]})"
                  for a in args]
        run_ms = [alone[i] for i in idx]
        tb_ms = [tb_alone[i] for i in idx]
        # K4-tb's ns a step: each launch's time over its longest walk
        walks = [int(recs[i][1]["lens"].max()) for i in idx]
        step_ns_tb = [t * 1e6 / w for t, w in zip(tb_ms, walks)]
        strips = {"strips": [geo[i][0] for i in idx],
                  "strip_width": [geo[i][1] for i in idx],
                  "blocks": [geo[i][2] for i in idx]}
        per_merge = {
            "ms_per_merge": sum(run_ms) / merges,
            "one_sm_bound_ms": cells / merges * GOTOH_OPS_PER_CELL / sm_rate
            * 1e3,
            "card_bound_ms": cells / merges * GOTOH_OPS_PER_CELL
            / INT32_OPS_PER_S * 1e3}
        print(f"K4/K4-tb {label}: {len(idx)} launches ({', '.join(shapes)})"
              f", {merges} merges, {cells} cells; K4 "
              f"{[round(x, 3) for x in run_ms]} ms, the mean merge's cells "
              f"{per_merge['one_sm_bound_ms']:.3f} ms on one SM and "
              f"{per_merge['card_bound_ms']:.4f} ms on the card at the "
              f"operations bound; K4-tb {[round(x, 4) for x in tb_ms]} ms, "
              f"{[round(x, 2) for x in step_ns_tb]} ns a step of each "
              f"launch's longest walk ({walks} steps) beside the chase "
              f"probe's {step_ns:.2f} ns, longest walk {longest} steps, chain "
              f"floor {floor_ms:.4f} ms")
        desc = (f"{merges} merges in {len(idx)} launches "
                f"({', '.join(shapes)}), {label}")
        per_run[label] = (
            {"ms": sum(run_ms), "plain_ms": p_ms,
             "plain_merges": g0, "shapes": desc, "launch_ms_alone": run_ms,
             "cells": cells, **per_merge, **strips,
             **bound(in_bytes + cells + 4 * merges,
                     cells * GOTOH_OPS_PER_CELL)},
            # K4-tb's step counted as K2-tb's (the same step table)
            {"ms": sum(tb_ms), "plain_ms": ptb_ms, "plain_merges": g0,
             "shapes": f"{desc}; {steps} walk steps",
             "launch_ms_alone": tb_ms, "longest_walk_steps": longest,
             "longest_walk_per_launch": walks,
             "ns_per_step": step_ns_tb, "smem_step_ns": step_ns,
             "chain_floor_ms": floor_ms,
             **bound(2 * steps + 12 * merges, 8 * steps)})
    details["k4_runs"] = per_run
    k4, k4tb = per_run["sr long-split, 4 reads per DEL, 24 DELs"]
    k4["max_abs_err"] = k4tb["max_abs_err"] = err
    return k4, k4tb


# ---------------------------------------------------------------------------
# Phase 4: the lr slice end to end
# ---------------------------------------------------------------------------

# deep long-read genotyping at bench.py:226-229's size, and the smaller
# deep-lr dataset whose card VCFs are held to CPU runs
DEEP_LR = dict(n_contigs=2, contig_len=2_000_000, dels_per_contig=300,
               coverage=60)
DEEP_LR_CPU = dict(n_contigs=1, contig_len=500_000, dels_per_contig=40,
                   coverage=45, name="deeplrs")
# the lr datasets: (generator of delly_tpu_torch.testing.synth, arguments)
LR_DATASETS = {
    "lr_sv": ("make_lr_sv_dataset", {}),
    "noisy": ("make_lr_genome_dataset", dict(
        n_contigs=8, contig_len=1_500_000, reads_per_contig=5_000,
        error_rate=0.05, indel_error_rate=0.05, name="noisy")),
    "deep-lr": ("make_deep_lr_dataset", DEEP_LR),
    "deep-lr small": ("make_deep_lr_dataset", DEEP_LR_CPU),
}


def make_datasets(work, table) -> dict:
    """The datasets of `table` (LR_DATASETS, COHORT_DATASETS) under
    `work`, by name, as their generators return them, and the seconds
    they took."""
    from delly_tpu_torch.testing import synth

    t0 = time.time()
    out = {k: getattr(synth, gen)(work, **kw)
           for k, (gen, kw) in table.items()}
    out["seconds"] = time.time() - t0
    return out


def start_datasets(work):
    """Generates the lr datasets, phase 5's datasets and the 24-DEL
    long-split dataset with 4 reads per DEL in three worker processes
    (about 45 s of host work each), which run beside the kernel checks
    and the sr runs. Returns (pool, {"lr": future, "cohort": future,
    "wide": future}); the pool is spawned, not forked, since this
    process holds the card."""
    pool = ProcessPoolExecutor(3, mp_context=get_context("spawn"))
    return pool, {"lr": pool.submit(make_datasets, work, LR_DATASETS),
                  "cohort": pool.submit(make_datasets, work,
                                        COHORT_DATASETS),
                  "wide": pool.submit(make_datasets, work, WIDE_DATASETS)}


def lr_sv_check(calls) -> bool:
    """The five families of make_lr_sv_dataset, each at +-5 bp, as
    tests/test_lr.py:278-305 checks them."""
    if {c[0] for c in calls} != {"DEL", "INS", "DUP", "INV", "BND"}:
        return False
    for typ, chrom, pos in [("DEL", "ctgA", 20000), ("INS", "ctgA", 45000),
                            ("DUP", "ctgA", 70000), ("INV", "ctgA", 100000)]:
        if not any(s == typ and cc == chrom and abs(cp - pos) <= 5
                   for s, cc, cp, _a, _g in calls):
            return False
    bnd = [c for c in calls if c[0] == "BND"][0]
    return bnd[1] == "ctgB" and abs(bnd[2] - 30000) <= 5 \
        and "ctgA:125000" in bnd[3]


def lr_score(calls, truth, win=60) -> tuple:
    """(truth called, truth, calls that match a truth, calls): a call
    matches (chrom, kind, pos, length) of the truth at |pos| < win."""
    def match(t, c):
        return c[0] == t[1] and c[1] == t[0] and abs(c[2] - t[2]) < win
    tp = sum(any(match(t, c) for c in calls) for t in truth)
    good = sum(any(match(t, c) for t in truth) for c in calls)
    return tp, len(truth), good, len(calls)


def lr_timers():
    """(acc, wraps) that time, in one lr run, K1's batch wrapper (host
    copies, launch and the copy back), and the parts of split-read
    assembly: the consensus of each SV's reads (msaEdlib, or msaWfa for
    insertions) and its realignment to the reference (align_consensus,
    which holds the host needle of cons_ref_alignment and K1 calls)."""
    from delly_tpu_torch.models import assemble, refine
    from delly_tpu_torch.ops import myers_cuda

    acc = {k: {"s": 0.0, "calls": 0}
           for k in ("k1_wrapper", "consensus", "align_consensus",
                     "host_needle")}
    wraps = [(myers_cuda, "batched_edit_distance_myers",
              timer(acc["k1_wrapper"])),
             (assemble, "msa_edlib", timer(acc["consensus"])),
             (assemble, "msa_wfa", timer(acc["consensus"])),
             (assemble, "align_consensus", timer(acc["align_consensus"])),
             (refine, "cons_ref_alignment", timer(acc["host_needle"]))]
    return acc, wraps


def check_recorded_k1(dev, record, label) -> dict:
    """Holds every K1 launch recorded in a run equal to myers_plain on
    the card: launches of one (M, N, mode, letter table) are joined, at
    most 65,536 pairs at a time, since the plain version is the same
    function of each pair. Then times the launch with the most work
    through the wrapper and replayed from a CUDA graph. Returns the
    launches, their pairs by (M, N), and the largest's numbers."""
    import torch

    from delly_tpu_torch.ops.myers import myers_plain
    from delly_tpu_torch.ops.myers_cuda import myers

    groups, shapes = {}, {}
    for args, _kw, out in record:
        q, ql, t, tl, lut, mode = args[:6]
        key = (q.shape[1], t.shape[1], mode, bytes(lut.cpu().numpy()))
        groups.setdefault(key, []).append((q, ql, t, tl, out))
        shp = f"{q.shape[1]}x{t.shape[1]}"
        shapes[shp] = shapes.get(shp, 0) + q.shape[0]
    pairs = 0
    for (_m, _n, mode, lut), items in groups.items():
        lut_t = torch.frombuffer(bytearray(lut), dtype=torch.uint8).to(dev)
        k = 0
        while k < len(items):
            chunk, n = [], 0
            while k < len(items) and (not chunk or n + len(items[k][0])
                                      <= 65_536):
                chunk.append(items[k])
                n += len(items[k][0])
                k += 1
            cat = [torch.cat([c[i] for c in chunk]) for i in range(5)]
            want = myers_plain(*cat[:4], lut_t, mode)
            need(torch.equal(cat[4], want),
                 f"{label}: a recorded K1 launch != plain")
            pairs += n
    work = [int((((a[1].long() + 31) // 32) * a[3].long()).sum())
            for a, _kw, _o in record]
    args = record[int(np.argmax(work))][0]
    q, ql, t, tl = (x.cpu().numpy() for x in args[:4])
    ms = cuda_ms(lambda: myers(*args), reps=5)
    dev_ms = device_ms(lambda: myers(*args), reps=5)
    _o, plain_ms = timed(lambda: myers_plain(*args[:6]))
    largest = {"shape": f"{len(q)} pairs, {q.shape[1]}x{t.shape[1]} uint8, "
                        f"mode {args[5]}",
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               **myers_bound(q, ql, t, tl)}
    print(f"{label}: {len(record)} K1 launches, {pairs} pairs, each equal to "
          f"the plain version; pairs by query x target width {shapes}; the "
          f"largest, {largest['shape']}: {ms:.4f} ms through the wrapper, "
          f"{dev_ms:.4f} ms replayed, plain {plain_ms:.1f} ms, bound "
          f"{largest['bound_ms']:.4f} ms ({largest['bound_by']})")
    return {"launches": len(record), "pairs": pairs, "pairs_by_shape": shapes,
            "largest": largest}


def rowscan_seconds(dev, calls) -> dict:
    """The torch row-scan, which served queries wider than 4,096 rows
    before K1 did, timed once on the card on the inputs of the first
    recorded `batched_edit_distance` call with such queries (an
    _all_pairs_nw batch of 8,192-row queries), beside K1's route on the
    same inputs; both equal."""
    from delly_tpu_torch.ops import edist
    from delly_tpu_torch.ops.myers_cuda import batched_edit_distance_myers

    calls = [c for c in calls if c[0][0].shape[1] > 4096]
    need(calls, "lr lr_sv: no batch of queries wider than 4,096 rows")
    (q, ql, t, tl, mode), _kw, _out = calls[0]
    t0 = time.time()
    got_rs = edist.batched_edit_distance_rowscan(q, ql, t, tl, mode)
    rs_s = time.time() - t0
    t0 = time.time()
    got_k1 = batched_edit_distance_myers(q, ql, t, tl, mode)
    k1_s = time.time() - t0
    need(np.array_equal(got_rs, got_k1), "row-scan != K1 on 8,192-row pairs")
    shape = f"{len(q)} pairs, {q.shape[1]}x{t.shape[1]}, mode {mode}"
    print(f"row-scan on one 8,192-row consensus batch ({shape}): {rs_s:.3f} s "
          f"on the card; K1's wrapper {k1_s:.4f} s; equal")
    return {"shape": shape, "rowscan_s": rs_s, "k1_wrapper_s": k1_s}


def phase_lr(dev, work, details, gen) -> tuple:
    """`lr` on the card: the five families of make_lr_sv_dataset, the
    noisy ONT-like genome, deep long-read genotyping at bench.py's size
    (discovery, then `lr -v` on its sites) and the smaller deep-lr
    dataset that the CPU runs repeat. Checks the truth of each, K1's
    launches and no row-scan batch in every run, holds every K1 launch
    of the two bench-size runs equal to the plain version and times the
    largest, and times the row-scan on one 8,192-row consensus batch.
    Returns (launches by run, the CPU runs' commands, K1's lr numbers).
    `gen` is the lr future of start_datasets."""
    from delly_tpu_torch.ops import edist, myers_cuda

    t0 = time.time()
    made = gen.result()
    sv_bam, sv_fa, _sv_truth = made["lr_sv"]
    nz_bam, nz_fa, nz_truth = made["noisy"]
    dl_bam, dl_fa, dl_truth = made["deep-lr"]
    ds_bam, ds_fa, ds_truth = made["deep-lr small"]
    details["lr_gen_s"] = made["seconds"]
    print(f"datasets: lr_sv, noisy, deep-lr and deep-lr (small) generated in "
          f"{made['seconds']:.1f}s beside the earlier phases; waited "
          f"{time.time() - t0:.1f}s for them")
    p = lambda name: os.path.join(work, name)  # noqa: E731
    cmds = {
        "lr lr_sv": ["lr", "-g", sv_fa, "-o", p("lrsv.{}.vcf"), sv_bam],
        "lr noisy": ["lr", "-g", nz_fa, "-o", p("noisy.{}.vcf"), nz_bam],
        "lr deep-lr": ["lr", "-g", dl_fa, "-o", p("deeplr.{}.vcf"), dl_bam],
        "lr -v deep-lr": ["lr", "-v", p("deeplr.cuda.vcf"), "-g", dl_fa, "-o",
                          p("deeplr_regeno.{}.vcf"), dl_bam],
        "lr deep-lr small": ["lr", "-g", ds_fa, "-o", p("deeplrs.{}.vcf"),
                             ds_bam],
        "lr -v deep-lr small": ["lr", "-v", p("deeplrs.cuda.vcf"), "-g",
                                ds_fa, "-o", p("deeplrs_regeno.{}.vcf"),
                                ds_bam],
    }
    launches, split, k1_runs = {}, {}, {}
    wide = []
    for label, argv in cmds.items():
        argv = [a.replace("{}", "cuda") if a.endswith(".{}.vcf") else a
                for a in argv]
        acc, wraps = lr_timers()
        record = []
        if label in ("lr deep-lr", "lr -v deep-lr"):
            wraps.append((myers_cuda, "myers", recorder(record)))
        if label == "lr lr_sv":
            wraps.append((edist, "batched_edit_distance", recorder(wide)))
        launches[label], _stages = run_card(argv, details, label, wraps)
        split[label] = acc
        print(f"{label}: " + ", ".join(f"{k} {v['s']:.3f}s in {v['calls']} "
                                      f"calls" for k, v in acc.items()))
        need(launches[label]["myers"] > 0, f"{label}: myers never launched")
        need(launches[label]["rowscan"] == 0,
             f"{label}: {launches[label]['rowscan']} row-scan batches")
        if record:
            k1_runs[label] = check_recorded_k1(dev, record, label)
            del record[:]
    details["lr_split_s"] = split
    details["lr_k1_recorded"] = k1_runs
    details["lr_rowscan"] = rowscan_seconds(dev, wide)

    need(lr_sv_check(vcf_calls(p("lrsv.cuda.vcf"))), "lr_sv truth check")
    print("lr_sv: DEL, INS, DUP, INV and BND called at +-5 bp")
    checks = {}
    for name, vcf, truth in (("noisy", "noisy.cuda.vcf", nz_truth),
                             ("deep-lr", "deeplr.cuda.vcf", dl_truth),
                             ("deep-lr small", "deeplrs.cuda.vcf", ds_truth)):
        tp, nt, good, nc = lr_score(vcf_calls(p(vcf)), truth)
        print(f"lr {name}: recall {tp}/{nt} at +-60 bp, {good} of {nc} calls "
              f"match a truth")
        checks[name] = {"tp": tp, "truth": nt, "good": good, "calls": nc}
        need(tp == nt and good == nc, f"lr {name} truth check")
    need(checks["noisy"]["truth"] == 16 and checks["deep-lr"]["truth"] == 600,
         "lr truth sizes")
    geno = vcf_calls(p("deeplr_regeno.cuda.vcf"))
    alt = sum(c[4] in ("0/1", "1/1") for c in geno)
    print(f"lr -v deep-lr: {alt} of {len(geno)} sites genotyped with an ALT "
          f"allele")
    checks["deep-lr -v"] = {"alt_genotyped": alt, "sites": len(geno)}
    need(alt == len(geno) == 600, "lr -v deep-lr: sites not ALT-genotyped")
    details["lr_truth"] = checks
    cpu_cmds = {k: v for k, v in cmds.items()
                if k not in ("lr deep-lr", "lr -v deep-lr")}
    big = max(k1_runs.values(), key=lambda r: r["largest"]["ops"])["largest"]
    k1_lr = {"lr_launches": {k: v["myers"] for k, v in launches.items()},
             "lr_pairs_by_shape": {k: v["pairs_by_shape"]
                                   for k, v in k1_runs.items()},
             "lr_largest_launch": big,
             "lr_rowscan_s_8192_rows": details["lr_rowscan"]["rowscan_s"]}
    return launches, cpu_cmds, k1_lr


# ---------------------------------------------------------------------------
# Phase 5: the cohort commands (merge, filter, asm, cnv)
# ---------------------------------------------------------------------------

# At the sizes bench_e2e.py gives its engines: the cohort engine
# (make_population_cohort's defaults: 50 samples of 2 x 300 kb, 30 het
# DELs, 18,000 pairs per contig and sample), svmix's genome for the
# tumor/control pair at the generator's own coverage, the assembly
# engine's 1.5 Mb (tests/test_asm.py's 2 Mb for the diploid pair) and the
# cnv engine's 8 x 1.5 Mb.
COHORT_DATASETS = {
    "cohort": ("make_population_cohort", {}),
    "somatic": ("make_somatic_pair_dataset", dict(
        n_contigs=8, contig_len=1_500_000, pairs_per_contig=21_000)),
    "asm": ("make_asm_indel_dataset", dict(contig_len=1_500_000)),
    "asm diploid": ("make_asm_diploid_dataset", dict(name="asmd")),
    "asm families": ("make_asm_split_dataset", dict(name="asmf")),
    "cnv": ("make_multi_contig_del_dataset", dict(
        n_contigs=8, contig_len=1_500_000, pairs_per_contig=40_000,
        name="cnvd")),
}


def cohort_workflows(made, p) -> dict:
    """The workflows of phase 5, by name: [(step label, argv), ...].
    "{}" in a path marks an output (cuda on the card, cpu on the host);
    each step reads the card's outputs of the steps before it."""
    bams, fa, _ = made["cohort"]
    tumor, control, sfa, _g, _s = made["somatic"]
    abam, afa, _ = made["asm"]
    (h1, h2), dfa, _ = made["asm diploid"]
    fams, ffa, _ = made["asm families"]
    cbam, cfa, _ = made["cnv"]
    cbam2 = p("cnvd2.bam")
    disc = [p(f"coh_s{i:03d}.{{}}.bcf") for i in range(len(bams))]
    card = [d.replace("{}", "cuda") for d in disc]
    return {
        "cohort": [("sr", ["sr", "-g", fa, "-o", d, b])
                   for d, b in zip(disc, bams)] + [
            ("merge", ["merge", "-o", p("coh_sites.{}.bcf"), *card]),
            ("sr -v", ["sr", "-v", p("coh_sites.cuda.bcf"), "-g", fa, "-o",
                       p("coh_geno.{}.bcf"), *bams]),
            ("filter -f germline", ["filter", "-f", "germline", "-o",
                                    p("coh_germ.{}.bcf"),
                                    p("coh_geno.cuda.bcf")])],
        "somatic": [
            ("sr", ["sr", "-g", sfa, "-o", p("som_joint.{}.bcf"), tumor,
                    control]),
            ("filter -f somatic", ["filter", "-f", "somatic", "-s",
                                   p("som_samples.tsv"), "-o",
                                   p("som_kept.{}.bcf"),
                                   p("som_joint.cuda.bcf")])],
        "asm": [
            ("squashed", ["asm", "-g", afa, "-o", p("asm.{}.vcf"), abam]),
            ("diploid", ["asm", "-y", "diploid", "-g", dfa, "-o",
                         p("asmd.{}.vcf"), h1, h2]),
            ("families", ["asm", "-g", ffa, "-o", p("asmf.{}.vcf"),
                          *fams])],
        "cnv": [
            ("cnv -c -u", ["cnv", "-g", cfa, "-c", p("cnv_cov.{}.gz"), "-u",
                           p("cnv_seg.{}.gz"), "--statsfile",
                           p("cnv_stats.{}.gz"), "-o", p("cnv1.{}.bcf"),
                           cbam]),
            ("cnv second sample", ["cnv", "-g", cfa, "-o", p("cnv2.{}.bcf"),
                                   cbam2]),
            # -q 2: a loss seen in both samples is a site. merge's
            # default (10 samples, or UNIQ >= 0.75) drops every hole of
            # this genome: with no read inside, most hole calls carry
            # UNIQ=-1
            ("merge -e -y 0 -q 2", ["merge", "-e", "-y", "0", "-q", "2",
                                    "-o", p("cnv_sites.{}.bcf"),
                                    p("cnv1.cuda.bcf"),
                                    p("cnv2.cuda.bcf")]),
            ("cnv -v", ["cnv", "-g", cfa, "-v", p("cnv_sites.cuda.bcf"),
                        "-o", p("cnv_geno.{}.bcf"), cbam])],
    }


def cohort_score(sites, germ, truth, n_samples) -> dict:
    """Site recall and precision of the germline-filtered DELs against the
    population truth, and genotype agreement at the called truth sites,
    as bench_e2e.py run_cohort_bench computes them (a call matches a
    truth site within 100 bp of its start); beside them the truth sites
    in the merged site list (those with a carrier), and the truth sites
    that the germline filter should keep: those with a carrier and a
    non-carrier (a DEL's read-depth ratio needs 0/0 samples) that pass
    its excess-heterozygosity gate. Every carrier of the cohort is
    heterozygous, so a site carried by nearly every sample fails that
    gate (models/filter.py: refined, FIC < 0 and an HWE p-value below
    -w); it is computed here from the carriers alone, with the filter's
    own site_stats on clean genotype likelihoods."""
    from delly_tpu_torch.models.filter import FilterConfig, site_stats

    cfg = FilterConfig()

    def calls_of(path):
        return [(r[0], int(r[1]), [f.split(":")[0] for f in r[9:]])
                for r in records(path) if "SVTYPE=DEL" in r[7]]

    def hit(calls, chrom, bp1):
        return [gts for c, pos, gts in calls if c == chrom
                and abs(pos - bp1) < 100]

    merged, calls = calls_of(sites), calls_of(germ)
    tp = gt_ok = gt_all = in_sites = carried = 0
    kept, called = set(), set()
    for k, (chrom, bp1, _bp2, _af, carriers) in enumerate(truth):
        in_sites += bool(hit(merged, chrom, bp1))
        carried += bool(carriers)
        gl = [[1e-9, 1.0, 1e-9] if s in carriers else [1.0, 1e-9, 1e-12]
              for s in range(n_samples)]
        _a, _m, fic, _r, pval = site_stats(gl, cfg.epsilon, cfg.maxiter)
        if 0 < len(carriers) < n_samples and not (fic < 0
                                                   and pval < cfg.hwe):
            kept.add(k)
        found = hit(calls, chrom, bp1)
        if not found:
            continue
        tp += 1
        called.add(k)
        for s, gt in enumerate(found[0]):
            gt_all += 1
            gt_ok += (gt in ("0/1", "1/1")) == (s in carriers)
    good = sum(any(c == tc and abs(pos - a) < 100
                   for tc, a, _b, _af, _car in truth) for c, pos, _g in calls)
    return {"tp": tp, "truth": len(truth), "good": good, "calls": len(calls),
            "gt_ok": gt_ok, "gt_all": gt_all, "in_sites": in_sites,
            "carried": carried, "kept": len(kept),
            "called_is_kept": called == kept}


def run_workflow_card(wf, steps, details, wraps_for=None) -> dict:
    """The steps of one workflow on the card, each between a reset and a
    read of the launch counters. Prints, for each step label, its runs'
    seconds and summed launches, and returns them by label."""
    out = {}
    for i, (label, argv) in enumerate(steps):
        argv = [a.replace("{}", "cuda") for a in argv]
        wraps = wraps_for(label) if wraps_for else ()
        counts, _stages = run_card(argv, details, f"{wf} {label} {i}", wraps,
                                   quiet=True)
        agg = out.setdefault(label, {"runs": 0, "s": 0.0, "launches": {}})
        agg["runs"] += 1
        agg["s"] += details["runs"][f"{wf} {label} {i}"]["wall_s"]
        for k, v in counts.items():
            agg["launches"][k] = agg["launches"].get(k, 0) + v
    for label, agg in out.items():
        runs = f"{agg['runs']} x " if agg["runs"] > 1 else ""
        print(f"{wf}: {runs}{label}: {agg['s']:.3f}s on the card, launches "
              f"{agg['launches']}")
        need(agg["launches"]["host_routes"] == 0
             and agg["launches"]["rowscan"] == 0,
             f"{wf} {label}: host routes or row-scan batches")
    details.setdefault("cohort_steps", {})[wf] = out
    return out


def phase_cohort(dev, work, details, gen) -> tuple:
    """The cohort commands on the card: the germline workflow over a
    50-sample cohort (per-sample `sr`, `merge`, one joint `sr -v` over
    every BAM, `filter -f germline`), the somatic workflow over a
    tumor/control pair (joint `sr`, `filter -f somatic`), `asm` (squashed,
    diploid, and the split-alignment families, whose K1 launches are held
    to the plain version), and `cnv` with its cohort step (`cnv -c -u`,
    a second sample, `merge -e -y 0 -q 2`, `cnv -v`). Checks each against
    its truth, K1's launches in the joint `sr -v` and in the families run, and
    no host route or row-scan batch anywhere. Returns (launches by step,
    the workflows for the CPU runs, K1's asm numbers). `gen` is the
    cohort future of start_datasets."""
    from delly_tpu_torch import native
    from delly_tpu_torch.ops import myers_cuda

    t0 = time.time()
    made = gen.result()
    details["cohort_gen_s"] = made["seconds"]
    print(f"datasets: cohort ({len(made['cohort'][0])} samples), somatic "
          f"pair, asm and cnv generated in {made['seconds']:.1f}s beside the "
          f"earlier phases; waited {time.time() - t0:.1f}s for them")
    p = lambda name: os.path.join(work, name)  # noqa: E731
    shutil.copy(made["cnv"][0], p("cnvd2.bam"))
    shutil.copy(made["cnv"][0] + ".bai", p("cnvd2.bam.bai"))
    with open(p("som_samples.tsv"), "w") as fh:
        fh.write("tumor\ttumor\ncontrol\tcontrol\n")
    # coral.py and models/cnv.py take the native host helpers when the
    # library loads (phase 1 requires it), else their Python fallbacks
    route = "native" if native.get_lib() is not None else "python"
    print(f"cnv host helpers: the {route} route (cov_rows, rd_windows, "
          f"cnv_segment_core, cnv_gt_core)")
    details["cnv_host_route"] = route
    flows = cohort_workflows(made, p)
    record = []

    def asm_wraps(label):
        return ([(myers_cuda, "myers", recorder(record))]
                if label == "families" else ())

    steps = {wf: run_workflow_card(wf, flows[wf], details,
                                   asm_wraps if wf == "asm" else None)
             for wf in flows}
    need(steps["cohort"]["sr -v"]["launches"]["myers"] > 0,
         "cohort sr -v: myers never launched")
    need(steps["asm"]["families"]["launches"]["myers"] > 0 and record,
         "asm families: myers never launched")
    k1_asm = check_recorded_k1(dev, record, "asm families")

    # truth
    checks = {}
    bams, _fa, truth = made["cohort"]
    sc = cohort_score(p("coh_sites.cuda.bcf"), p("coh_germ.cuda.bcf"), truth,
                      len(bams))
    print(f"cohort: germline sites recall {sc['tp']}/{sc['truth']}, "
          f"precision {sc['good']}/{sc['calls']}, genotypes "
          f"{sc['gt_ok']}/{sc['gt_all']} agree with the carriers; merged "
          f"sites hold {sc['in_sites']} of the {sc['carried']} truth sites "
          f"with a carrier; {sc['kept']} have a non-carrier and pass the "
          f"excess-heterozygosity gate on their carriers alone, and the "
          f"called ones are those: {sc['called_is_kept']}")
    checks["cohort"] = sc
    need(sc["in_sites"] == sc["carried"] and sc["called_is_kept"]
         and sc["good"] == sc["calls"] and sc["gt_ok"] == sc["gt_all"],
         "cohort truth check")
    kept = {(r[0], int(r[1])) for r in records(p("som_kept.cuda.bcf"))}
    joint = records(p("som_joint.cuda.bcf"))
    _t, _c, _fa, germ, soma = made["somatic"]
    som_ok = all(any(c == cn and abs(pos - a) < 60 for c, pos in kept)
                 for cn, a, _b in soma)
    germ_out = not any(any(c == cn and abs(pos - a) < 60 for c, pos in kept)
                       for cn, a, _b in germ)
    print(f"somatic: {len(joint)} joint calls, {len(kept)} kept; every "
          f"somatic DEL kept: {som_ok}; every germline DEL dropped: "
          f"{germ_out}")
    checks["somatic"] = {"joint": len(joint), "kept": len(kept)}
    need(len(joint) == len(germ) + len(soma) and som_ok and germ_out,
         "somatic truth check")
    calls = vcf_calls(p("asm.cuda.vcf"))
    hits = sum(any(c[0] == svt and abs(c[2] - pos) < 50 for c in calls)
               for svt, pos in made["asm"][2])
    dip = {c[0]: c for c in vcf_calls(p("asmd.cuda.vcf"))}
    (_d, dpos, _x), (_i, ipos, _y) = made["asm diploid"][2]
    dip_ok = (set(dip) == {"DEL", "INS"} and abs(dip["DEL"][2] - dpos) < 50
              and dip["DEL"][4] == "1/1" and abs(dip["INS"][2] - ipos) < 50
              and dip["INS"][4] in ("1|0", "0|1"))
    fam = vcf_calls(p("asmf.cuda.vcf"))
    # a BND may be written at either of its two ends
    fam_ok = all(any(c[0] == svt and c[1] == e and abs(c[2] - x) < 100
                     for c in fam for e, x in zip(ends[::2], ends[1::2]))
                 for svt, *ends in made["asm families"][2])
    print(f"asm: squashed {hits}/2 within 50 bp ({len(calls)} calls); "
          f"diploid genotypes { {k: c[4] for k, c in dip.items()} }; families "
          f"{sorted({c[0] for c in fam})} called at their breakpoints: "
          f"{fam_ok}")
    checks["asm"] = {"squashed_hits": hits, "diploid_ok": dip_ok,
                     "families_ok": fam_ok}
    need(hits == len(calls) == 2 and dip_ok and fam_ok, "asm truth check")
    cnv = records(p("cnv1.cuda.bcf"))
    n_contigs = COHORT_DATASETS["cnv"][1]["n_contigs"]
    clen = COHORT_DATASETS["cnv"][1]["contig_len"]
    lo, hi = clen * 4 // 5, clen * 4 // 5 + min(60_000, clen // 10)
    holes = sum(any(r[0] == f"chr{c + 1}" and int(r[1]) < hi
                    and int(r[7].split("END=")[1].split(";")[0]) > lo
                    for r in cnv)
                for c in range(n_contigs))
    sites = records(p("cnv_sites.cuda.bcf"))
    geno = records(p("cnv_geno.cuda.bcf"))
    rdcn = sum(dict(zip(r[8].split(":"), r[9].split(":"))).get("RDCN", "")
               not in ("", ".") for r in geno)
    print(f"cnv: {len(cnv)} calls, read-depth holes called {holes}/"
          f"{n_contigs} (bench_e2e.py's check); merge -e {len(sites)} "
          f"sites, cnv -v {rdcn}/{len(geno)} with a copy number")
    checks["cnv"] = {"calls": len(cnv), "holes": holes, "sites": len(sites),
                     "genotyped": rdcn}
    need(holes == n_contigs == len(sites) and rdcn == len(geno) == len(sites),
         "cnv truth check")
    details["cohort_truth"] = checks
    launches = {f"{wf} {label}": agg["launches"]
                for wf, by in steps.items() for label, agg in by.items()}
    k1 = {"asm_launches": k1_asm["launches"],
          "asm_pairs_by_shape": k1_asm["pairs_by_shape"],
          "asm_largest_launch": k1_asm["largest"]}
    return launches, flows, k1


# ---------------------------------------------------------------------------
# Phase 6: CRAM input, the mesh, the host axis and the device trace
# ---------------------------------------------------------------------------

# svmix written as CRAM with the port's write_cram, by version
CRAM_WRITES = {"3.1": dict(version=(3, 1)), "3.0": {}}
# the runs traced again under DELLY_TPU_PROFILE_TRACE: every card run of
# phases 3-6 under about 10 s, and long-split and the small deep-lr
TRACED = ("sr svmix", "sr deepgeno", "sr -v deepgeno", "sr long-split",
          "lr lr_sv", "lr noisy", "lr deep-lr small",
          "lr -v deep-lr small", "cohort sr -v", "somatic sr",
          "asm squashed", "asm families", "cnv cnv -c -u",
          "sr svmix CRAM 3.1 whole")


def write_cram_file(bam, fa, out, kw) -> float:
    """Writes `bam` as a CRAM with the port's write_cram; returns the
    seconds it took. Runs in a worker process of start_cram_writes."""
    from delly_tpu_torch.io.bam import BamFile
    from delly_tpu_torch.io.cram import write_cram

    t0 = time.time()
    write_cram(BamFile(bam), fa, out, **kw)
    return time.time() - t0


def start_cram_writes(work, cmds):
    """Writes svmix as a CRAM of each version of CRAM_WRITES, one spawned
    worker process each, beside phases 4 and 5. Returns (pool,
    {version: future})."""
    argv = cmds["sr svmix"]
    fa, bam = argv[argv.index("-g") + 1], argv[-1]
    pool = ProcessPoolExecutor(len(CRAM_WRITES),
                               mp_context=get_context("spawn"))
    return pool, {v: pool.submit(write_cram_file, bam, fa, os.path.join(
        work, f"svmix{v.replace('.', '')}.cram"), kw)
        for v, kw in CRAM_WRITES.items()}


def phase_cram(work, details, cmds, cram_futs) -> dict:
    """`sr` on the card on svmix's CRAMs, each whole-file and streaming:
    the calls and the launch counts must equal the card's svmix BAM run.
    Prints the seconds spent decoding CRAM beside the BAM run's scan."""
    from delly_tpu_torch.io import bam as bam_io
    from delly_tpu_torch.io import cram as cram_io

    t0 = time.time()
    secs = {v: f.result() for v, f in cram_futs.items()}
    print("CRAM: svmix written by the port's write_cram as " + ", ".join(
        f"{v} in {s:.1f}s" for v, s in secs.items()) + f" beside phases "
        f"4-5; waited {time.time() - t0:.1f}s for them")
    details["cram_write_s"] = secs
    p = lambda name: os.path.join(work, name)  # noqa: E731
    base = cmds["sr svmix"]
    bam_run = details["runs"]["sr svmix"]
    want = records(p("svmix.cuda.vcf"))
    scan = {k: v for k, v in bam_run["stages"].items()
            if k in ("startup", "Paired-end and split-read scanning")}
    print(f"sr svmix BAM (phase 3): wall {bam_run['wall_s']:.3f}s, " +
          ", ".join(f"{k} {v:.3f}s" for k, v in scan.items()))
    launches, out = {}, {}
    for v in CRAM_WRITES:
        path = p(f"svmix{v.replace('.', '')}.cram")
        for mode, thr in (("whole", 1 << 62), ("stream", 0)):
            label = f"sr svmix CRAM {v} {mode}"
            acc = {"s": 0.0, "calls": 0}
            wraps = [(bam_io, "STREAM_THRESHOLD", lambda _old, t=thr: t),
                     (cram_io, "cram_to_bam_bytes", timer(acc)),
                     (cram_io.CramStream, "_decode_container", timer(acc))]
            argv = base[:-1] + [path]
            vcf = p(f"svmix_cram{v.replace('.', '')}_{mode}.vcf")
            argv[argv.index("-o") + 1] = vcf
            launches[label], stages = run_card(argv, details, label, wraps,
                                               quiet=True)
            same = records(vcf) == want
            counts_same = launches[label] == bam_run["launches"]
            run = details["runs"][label]
            print(f"{label}: wall {run['wall_s']:.3f}s, CRAM decode "
                  f"{acc['s']:.3f}s in {acc['calls']} calls; calls == BAM "
                  f"run's: {same}; launches == BAM run's: {counts_same}")
            out[label] = {"wall_s": run["wall_s"], "decode_s": acc["s"],
                          "decode_calls": acc["calls"],
                          "cram_bytes": os.path.getsize(path)}
            need(acc["calls"] > 0, f"{label}: no CRAM decode timed")
            need(same, f"{label}: calls differ from the BAM run's")
            need(counts_same, f"{label}: launches {launches[label]} differ "
                 f"from the BAM run's {bam_run['launches']}")
    out["bam_bytes"] = os.path.getsize(base[-1])
    details["cram"] = out
    return launches


def phase_mesh(work, details, cmds, flows) -> dict:
    """`sr` on deepgeno and `cnv -c -u` on the cnv genome under
    DELLY_TPU_MESH=1, and at N = the visible cards when there are more
    than one: every output (the coverage, segmentation and statistics
    files included) must equal the runs without a mesh, and every card
    of the mesh must have run chunks."""
    import torch

    p = lambda name: os.path.join(work, name)  # noqa: E731
    ndev = torch.cuda.device_count()
    print(f"mesh: {ndev} visible card(s)")
    details["mesh_visible"] = ndev
    runs = {"sr deepgeno": (cmds["sr deepgeno"], "sr deepgeno"),
            "cnv -c -u": (dict(flows["cnv"])["cnv -c -u"], "cnv cnv -c -u 0")}
    # the window math's one transcendental, on the card and in numpy:
    # values that round otherwise, and those whose %g (the coverage
    # file's format) changes
    rng = np.random.default_rng(SEED)
    x = np.concatenate([rng.gamma(20.0, 8.0, 2_000_000) + 1.0,
                        np.arange(1.0, 200_000.0),
                        (np.floor(rng.gamma(20.0, 8.0, 1_000_000)) + 1.0)
                        / (rng.gamma(20.0, 8.0, 1_000_000) + 1.0)])
    card = torch.log2(torch.from_numpy(x).cuda()).cpu().numpy()
    host = np.log2(x)
    diff = np.flatnonzero(card != host)
    shown = sum(f"{a:g}" != f"{b:g}" for a, b in zip(card[diff], host[diff]))
    print(f"float64 log2: the card rounds {len(diff)} of {len(x)} values "
          f"otherwise than numpy; {shown} of them print otherwise with %g")
    details["log2_rounding"] = {"values": len(x), "differ": len(diff),
                                "differ_g": shown}
    # the copy number's division by purity, a Python number: on the card
    # torch multiplies by its reciprocal, which rounds otherwise, so
    # parallel/depth_step.py divides by a 0-dim tensor on the card
    xc = torch.from_numpy(x).cuda()
    by_number = int(((xc / 0.9).cpu().numpy() != x / 0.9).sum())
    by_tensor = int(((xc / torch.tensor(0.9, dtype=torch.float64,
                                        device="cuda")).cpu().numpy()
                     != x / 0.9).sum())
    print(f"float64 x / 0.9: the card rounds {by_number} of {len(x)} values "
          f"otherwise than numpy with a Python divisor, {by_tensor} with a "
          f"tensor divisor")
    details["division_rounding"] = {"values": len(x), "by_number": by_number,
                                    "by_tensor": by_tensor}
    need(by_tensor == 0, "float64 division by a tensor on the card differs "
         "from numpy")
    launches = {}
    for n in [1] + ([ndev] if ndev > 1 else []):
        for name, (argv, ref) in runs.items():
            label = f"{name} mesh {n}"
            outs = [a for a in argv if "{}" in a]
            argv = [a.replace("{}", f"mesh{n}") for a in argv]
            os.environ["DELLY_TPU_MESH"] = str(n)
            try:
                launches[label], stages = run_card(argv, details, label,
                                                   quiet=True)
            finally:
                del os.environ["DELLY_TPU_MESH"]
            run = details["runs"][label]
            hits = run["device_hits"]
            same = all(output_lines(o.replace("{}", f"mesh{n}"))
                       == output_lines(o.replace("{}", "cuda")) for o in outs)
            print(f"{label}: wall {run['wall_s']:.3f}s (no mesh "
                  f"{details['runs'][ref]['wall_s']:.3f}s), chunks by card "
                  f"{hits}; {len(outs)} outputs == no mesh: {same}")
            need(same, f"{label}: outputs differ from the run without a mesh")
            need(sorted(hits) == list(range(n))
                 and all(sum(h.values()) > 0 for h in hits.values()),
                 f"{label}: a card of the mesh ran no chunk: {hits}")
            if name == "cnv -c -u":
                need(any(k.startswith("Mesh read-depth windows")
                         for k in stages), f"{label}: no mesh windows")
                need(all(h.get("cnv_depth", 0) > 0 for h in hits.values()),
                     f"{label}: window math not on every card")
            if n == 1:
                need(launches[label] == details["runs"][ref]["launches"],
                     f"{label}: launches differ from the run without a mesh")
    return launches


def phase_hostaxis(work, details, cmds) -> None:
    """A 2-process gloo world on the one card
    (delly_tpu_torch/testing/hostaxis_worker.py): `sr` on svmix and `lr`
    on lr_sv. Process 0's VCFs must equal the card's one-process runs."""
    import socket

    p = lambda name: os.path.join(work, name)  # noqa: E731
    sr, lr = cmds["sr svmix"], cmds["lr lr_sv"]
    steps = [sr[:sr.index("-o") + 1] + ["{out}/svmix.vcf"] + sr[-1:],
             lr[:lr.index("-o") + 1] + ["{out}/lrsv.vcf"] + lr[-1:]]
    outdir = p("world2")
    os.makedirs(outdir)
    with open(p("world2.json"), "w") as fh:
        json.dump(steps, fh)
    # the port stays reserved (bound with SO_REUSEADDR, not listening)
    # until the world ends, so that no other socket is given it before
    # process 0's TCPStore, which also sets SO_REUSEADDR, listens on it
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    t0 = time.time()
    procs = []
    try:
        for pid in range(2):
            with open(p(f"world2.{pid}.err"), "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "delly_tpu_torch.testing.hostaxis_worker", str(pid),
                     "2", str(port), outdir, p("world2.json")], cwd=REPO,
                    stdout=subprocess.DEVNULL, stderr=err))
        rcs = [q.wait(timeout=600) for q in procs]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
        sock.close()
    wall = time.time() - t0
    for pid, rc in enumerate(rcs):
        with open(p(f"world2.{pid}.err")) as fh:
            need(rc == 0, f"host axis process {pid} exited {rc}: "
                 f"{fh.read()[-1500:]}")
    seen = []
    for pid in range(2):
        with open(os.path.join(outdir, f"p{pid}.pkl"), "rb") as fh:
            seen.append(pickle.load(fh))
    same = {name: output_lines(os.path.join(outdir, name))
            == output_lines(p(ref)) for name, ref in (
                ("svmix.vcf", "svmix.cuda.vcf"),
                ("lrsv.vcf", "lrsv.cuda.vcf"))}
    print(f"host axis: 2 processes on one card, sr svmix and lr lr_sv in "
          f"{wall:.1f}s (processes included); worlds "
          f"{[(o['index'], o['count']) for o in seen]}, exit codes "
          f"{[o['rcs'] for o in seen]}; VCFs == one process: {same}")
    details["hostaxis"] = {
        "wall_s": wall, "same": same,
        "seen": [{k: o[k] for k in ("index", "count", "rcs")} for o in seen]}
    need(all(o["count"] == 2 and o["rcs"] == [0, 0] for o in seen),
         "host axis: the world did not form or a step failed")
    need(all(same.values()), "host axis: VCFs differ from one process")


def phase_trace(work, details, cmds, flows) -> dict:
    """Each run of TRACED again, under DELLY_TPU_PROFILE and
    DELLY_TPU_PROFILE_TRACE (a torch.profiler trace of the card's
    activity, utils/profiling.py), each in a fresh process
    (testing/trace_check.py: the profiler's records drift from its first
    start in a process on, and a long-lived process loses them), started
    about trace_check.WARMUP_S before the run before it is expected to
    end (its untraced wall). Prints its busy share and its traced wall
    beside the untraced run's; its trace must hold one record of every
    launch of the port's kernels that the run counted."""
    from delly_tpu_torch.testing import trace_check as tc

    p = lambda name: os.path.join(work, name)  # noqa: E731
    # label -> (argv, the label of its untraced run)
    runs = {label: (argv, label) for label, argv in cmds.items()}
    for wf, steps in flows.items():
        for i, (label, argv) in enumerate(steps):
            runs.setdefault(f"{wf} {label}", (argv, f"{wf} {label} {i}"))
    cram = cmds["sr svmix"][:-1] + [p("svmix31.cram")]
    cram[cram.index("-o") + 1] = p("svmix_cram.{}.vcf")
    runs["sr svmix CRAM 3.1 whole"] = (cram, "sr svmix CRAM 3.1 whole")

    def start(k):
        argv = [a.replace("{}", "trace") for a in runs[TRACED[k]][0]]
        return tc.start(argv, p(f"trace{k}"))

    out = {}
    cur, nxt = None, start(0)
    try:
        for k, label in enumerate(TRACED):
            cur, nxt = nxt, None
            tc.go(cur)
            if k + 1 < len(TRACED):
                expect = details["runs"][runs[label][1]]["wall_s"]
                tc.wait(cur, expect - tc.WARMUP_S)
                nxt = start(k + 1)
            res = tc.finish(cur)
            counts, wall = res["launches"], res["wall_s"]
            b = tc.busy_share(res["trace"], wall)
            b.update(traced_wall_s=wall,
                     untraced_wall_s=details["runs"][runs[label][1]]["wall_s"],
                     traced_s=res["traced_s"], call_s=res["call_s"],
                     trace_mb=os.path.getsize(res["trace"]) / 2**20,
                     launches=counts)
            shutil.rmtree(os.path.dirname(res["trace"]))
            print(f"{label}: busy {b['busy_s']:.4f}s of {wall:.3f}s traced "
                  f"wall = {b['share']:.2%} ({b['device_events']} kernels and "
                  f"copies; the port's kernels {b['port_kernels']}); untraced "
                  f"wall {b['untraced_wall_s']:.3f}s; with the profiler's "
                  f"start and export {b['traced_s']:.3f}s, from go to the "
                  f"process's exit {b['call_s']:.3f}s; most busy: " +
                  "; ".join(f"{n[:48]} {t:.4f}s" for n, t in b["top"][:3]))
            need(b["port_kernels"] == tc.launched(counts),
                 f"{label} traced: the port's kernels in the trace "
                 f"{b['port_kernels']} differ from its launches "
                 f"{tc.launched(counts)}")
            out[label] = b
    finally:
        for run in (cur, nxt):
            if run is not None:
                tc.stop(run)
    details["busy_share"] = out
    return out


def run_workflow(path) -> None:
    """Runs one workflow's steps ({"steps": [[label, argv], ...], "out":
    path}) through the CLI in this process, one after the other, and
    writes each step's seconds to "out". The CPU runs of phase 5 call
    this in a process of their own."""
    from delly_tpu_torch.cli import main

    with open(path) as fh:
        job = json.load(fh)
    secs = []
    for label, argv in job["steps"]:
        t0 = time.time()
        rc = main(argv)
        secs.append([label, time.time() - t0])
        if rc:
            sys.exit(rc)
    with open(job["out"], "w") as fh:
        json.dump(secs, fh)


def start_cpu_workflows(flows: dict, p) -> list:
    """Starts each workflow on the host, one process per workflow that
    runs its steps one after the other: [(name, process, seconds file,
    stderr file, t0, end times)]."""
    runs = []
    for wf, steps in flows.items():
        job, secs = p(f"workflow.{wf}.json"), p(f"workflow.{wf}.s.json")
        with open(job, "w") as fh:
            json.dump({"out": secs, "steps": [
                [label, [a.replace("{}", "cpu") for a in argv]]
                for label, argv in steps]}, fh)
        err_path = p(f"stderr.workflow.{wf}.txt")
        proc, t0, ends = start_host(
            ["-c", "import sys, chip_smoke; "
                   "chip_smoke.run_workflow(sys.argv[1])", job], err_path)
        runs.append((wf, proc, secs, err_path, t0, ends))
    return runs


def finish_cpu_workflows(runs: list, flows: dict, details) -> None:
    """Waits for the CPU workflows, prints their seconds per step label,
    and checks that every card output equals its CPU run's, compared as
    the tests compare them (output_lines)."""
    for wf, proc, secs_path, err_path, t0, ends in runs:
        wall = wait_host(wf, proc, err_path, t0, ends)
        with open(secs_path) as fh:
            secs = json.load(fh)
        by = {}
        for label, sec in secs:
            by[label] = by.get(label, 0.0) + sec
        print(f"{wf} on cpu: process wall {wall:.3f}s; " + ", ".join(
            f"{label} {sec:.3f}s" for label, sec in by.items()))
        details.setdefault("cpu_workflows", {})[wf] = {
            "process_wall_s": wall, "steps_s": by}
    for wf, steps in flows.items():
        n = 0
        for _label, argv in steps:
            for out in (a for a in argv if "{}" in a):
                a, b = (output_lines(out.replace("{}", dv))
                        for dv in ("cuda", "cpu"))
                need(a == b, f"{os.path.basename(out)}: card and cpu outputs "
                             f"differ")
                n += 1
        print(f"{wf}: {n} card outputs == cpu outputs")


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, REPO)
    import delly_tpu_torch  # noqa: F401  (fails outside the repository)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    print(card_line)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
          f"{torch.cuda.device_count()} visible")
    global INT32_OPS_PER_S
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    mhz = float(clk.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    INT32_OPS_PER_S = INT32_LANES_PER_SM * sms * mhz * 1e6
    print(f"int32 peak: {INT32_LANES_PER_SM} lanes x {sms} SMs x {mhz:.0f} "
          f"MHz (clocks.max.sm) = {INT32_OPS_PER_S:.4g} operations/s")
    details = {"card": card_line, "kind": kind, "int32_ops_per_s": {
        "lanes_per_sm": INT32_LANES_PER_SM, "sms": sms, "sm_mhz": mhz,
        "rate": INT32_OPS_PER_S}}
    dev = torch.device("cuda", 0)
    work = os.path.join(REPO, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.environ["DELLY_TPU_TORCH_DEVICE"] = "cuda"
    t0 = time.time()
    cpu_runs = []
    pool = cram_pool = None
    try:
        k3_count, probe_lib = phase_build(details)
        sass_loops = kernel_sass(details, k3_count)
        step_ns, lcs_step_ns = phase_probes(dev, probe_lib, details)
        pool, gen = start_datasets(work)
        rng = np.random.default_rng(SEED)
        k1 = check_myers(dev, rng, details)
        k2, tb = check_gotoh(dev, rng, details, step_ns)
        check_lcs(dev, details, lcs_step_ns)
        launches, k3_launches, cmds, lcs_records = phase_e2e(work, details)
        x1 = check_recorded_lcs(dev, lcs_records, details, lcs_step_ns)
        cram_pool, cram_futs = start_cram_writes(work, cmds)
        wide_launches, wide_cmd, wide_records = phase_wide(work, details,
                                                           gen["wide"])
        launches.update(wide_launches)
        lr_launches, lr_cmds, k1_lr = phase_lr(dev, work, details, gen["lr"])
        launches.update(lr_launches)
        cmds.update(lr_cmds)
        co_launches, flows, k1_asm = phase_cohort(dev, work, details,
                                                  gen["cohort"])
        launches.update(co_launches)
        launches.update(phase_cram(work, details, cmds, cram_futs))
        launches.update(phase_mesh(work, details, cmds, flows))
        phase_hostaxis(work, details, cmds)
        phase_trace(work, details, cmds, flows)
        # the same commands and workflows on the host (the plain
        # versions), all at once in the background while the K3/K3-tb
        # checks and timings run
        p = lambda name: os.path.join(work, name)  # noqa: E731
        cmds.update(wide_cmd)
        cpu_runs = start_cpu_runs(cmds, p)
        cpu_runs += start_cpu_workflows(flows, p)
        err3 = check_banded(dev, rng, details)
        k3, k3tb = measure_banded(dev, k3_launches, err3, sass_loops,
                                  step_ns)
        k4, k4tb = check_wide(dev, wide_records, details, step_ns)
        finish_cpu_runs(cpu_runs[:len(cmds)], cmds, details)
        finish_cpu_workflows(cpu_runs[len(cmds):], flows, details)
    finally:
        for worker_pool in (pool, cram_pool):
            if worker_pool is not None:
                worker_pool.shutdown(cancel_futures=True)
        for run in cpu_runs:
            if run[1].poll() is None:
                run[1].kill()
                run[1].wait()
        shutil.rmtree(work, ignore_errors=True)
    details["total_s"] = time.time() - t0

    def total(name):
        return sum(run[name] for run in launches.values())

    ls, dg = x1["sr long-split"][0], x1["sr deepgeno"][0]
    mix = details["x1_cases"]["long-split mix"]
    print(f"X1: the seeded 96-pair mix {mix['ms']:.4f} ms, "
          f"{mix['ms'] / ls['ms']:.3f} x long-split's {ls['pairs']}-pair "
          f"batch ({ls['ms']:.4f} ms; chain floor {ls['chain_floor_ms']:.4f}"
          f" ms, {ls['longest_steps']} steps)")
    x1_meas = {**ls, "shapes": f"{ls['pairs']} pairs, {ls['m']}x{ls['n']} "
               f"uint8, long-split's batch", "deepgeno_shapes":
               f"{dg['pairs']} pairs, {dg['m']}x{dg['n']} uint8",
               **{f"deepgeno_{k}": dg[k] for k in ("ms", "plain_ms",
                                                   "bound_ms", "bound_by",
                                                   "chain_floor_ms")},
               "lcs_step_ns": lcs_step_ns,
               "case_mix_over_long_split": mix["ms"] / ls["ms"],
               "case_ms": {k: v["ms"] for k, v in
                           details["x1_cases"].items()},
               "case_bound_ms": {k: v["bound_ms"] for k, v in
                                 details["x1_cases"].items()},
               "case_chain_floor_ms": {k: v["chain_floor_ms"] for k, v in
                                       details["x1_cases"].items()}}
    kernels = []
    for name, src, rep, meas in (
            ("myers", "delly_tpu_torch/csrc/myers.cu",
             "delly_tpu/ops/myers_pallas.py:247",
             {**k1, **k1_lr, **k1_asm}),
            ("gotoh", "delly_tpu_torch/csrc/gotoh.cu",
             "delly_tpu/ops/gotoh_pallas.py:52", k2),
            ("gotoh_tb", "delly_tpu_torch/csrc/gotoh_tb.cu",
             "delly_tpu/ops/gotoh_pallas.py:209", tb),
            ("gotoh_banded", "delly_tpu_torch/csrc/gotoh_banded.cu",
             "delly_tpu/ops/gotoh_banded.py:192", k3),
            ("gotoh_banded_tb", "delly_tpu_torch/csrc/gotoh_banded_tb.cu",
             "delly_tpu/ops/gotoh_banded.py:342", k3tb),
            ("lcs", "delly_tpu_torch/csrc/lcs.cu",
             "delly_tpu/ops/msa.py:39", x1_meas),
            ("gotoh_wide", "delly_tpu_torch/csrc/gotoh_wide.cu",
             "delly_tpu/ops/gotoh_device.py:35", k4),
            ("gotoh_wide_tb", "delly_tpu_torch/csrc/gotoh_wide_tb.cu",
             "delly_tpu/ops/gotoh_device.py:101", k4tb)):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": total(name),
            "launches_by_run": {k: v[name] for k, v in launches.items()},
            "max_abs_err": meas["max_abs_err"], "ms": meas["ms"],
            "plain_ms": meas["plain_ms"], "bound_ms": meas["bound_ms"],
            "bound_by": meas["bound_by"], "bound_bytes": meas["bytes"],
            "bytes_ms": meas["bytes_ms"], "bound_ops": meas["ops"],
            "ops_ms": meas["ops_ms"], "library_ms": None,
            "shapes": meas["shapes"],
            **{k: v for k, v in meas.items() if k.startswith(
                ("row_loop", "launch_ms", "longest", "smem_step",
                 "chain_floor", "case_", "device_ms", "lr_", "asm_",
                 "deepgeno_", "word_steps", "lcs_step", "ns_per_step",
                 "ms_per_merge", "one_sm_bound", "card_bound",
                 "plain_merges", "strip", "blocks"))}})
    details["kernels"] = kernels
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(details, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
