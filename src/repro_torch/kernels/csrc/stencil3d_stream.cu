// stencil3d_stream.cu: the 3D streaming stencil kernel for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel_3d_stream` in
// src/repro/kernels/engine.py (launched by `_run_3d`; the engine's only 3D
// variant). One call runs `bt` fused time steps of a 3D star or box spec of
// radius 1..4 on a float32 [D, H, W] grid:
//
//     fill, (apply taps, + source, fill) x bt
//
// where `fill` acts at the true y and x edges and outside the plane interval
// [lo, hi): zero for dirichlet0; for clamp the nearest in-grid cell of the
// plane and, in z, the nearest valid plane (z taps read plane
// clip(z, lo, hi - 1)). The optional source is the engine's pre-summed source
// grid, zero outside the grid and outside [lo, hi). Under clamp, the planes
// outside an interior [lo, hi) take plane lo or hi - 1 of the result.
//
// What bounds it on an H100: HBM bytes. One call must move
// BlockPlan.hbm_bytes_per_sweep = D*H*W*4*(2 + n_src) bytes (read the grid
// and the source once, write the grid once) and does about bt*(2*taps) flops
// per cell: for Hotspot3D at bt = 4 that is 56 flops per 12 bytes, against
// the card's ~20 flops per byte (67 TFLOP/s fp32 over 3.35 TB/s). On top of
// those bytes, each CTA reads the xy halo of its tile again: its window is
// (by + 2h)(bx + 2h) cells for by*bx owned ones (1.41x for Hotspot3D at
// by = 32, bx = 64, h = 4), most of it shared with neighbours through L2.
//
// What the design does about it:
//  * 2.5D blocking (the thesis's shift-register pipeline): one CTA owns a
//    by x bx tile of the (y, x) plane and walks z, k = 0 .. D + h - 1,
//    reading plane k of each input once. Stage s of bt keeps a ring of the
//    2r + 1 newest planes of the field after s steps in shared memory and
//    emits plane k - (s+1) r into stage s + 1's ring; the last stage writes
//    its by x bx block to HBM. Nothing goes back to HBM between fused steps.
//  * Rings are indexed modulo their length (plane z sits in slot z mod 2r+1;
//    the source rides in a ring of h + 1 planes), so nothing is shifted.
//  * The fill is folded into the compute: a cell outside the grid takes 0
//    (dirichlet0) or computes the taps at its clamped in-grid position
//    (clamp), the value the fill would copy. One barrier per stage, none
//    for fills.
//  * A thread takes kRows = 4 cells down a column at once: four
//    independent FMA chains per tap read from constant memory, which hides
//    shared-memory latency with only 16 warps per SM; a plane's global
//    loads are all issued before their shared-memory stores.
//  * Stage s computes only the region later stages still read (it shrinks
//    by r per stage), so the overcompute is BlockPlan.redundancy.
//  * Taps arrive in taps_3d order in __constant__ memory, grouped into runs
//    of one z offset, and are summed in that order with fmaf, so the float
//    sums associate as the plain version's do (up to fused multiply-add
//    rounding).
// Left for later: cp.async/TMA prefetch of plane k + 1 under the compute of
// plane k, and kernels specialised on the radius.
//
// The taps live in one __constant__ block per library: calls on different
// streams must not overlap.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (kernels/_build.py); bound with ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxTaps = 729;  // a radius-4 box
constexpr int kMaxRuns = 16;   // runs of one z offset (a star has <= 10)
constexpr int kThreads = 512;
// Cells a thread takes at once, down a column: independent FMA chains,
// and one read of each tap from constant memory for all of them.
constexpr int kRows = 4;
constexpr size_t kSmemLimit = 227 * 1024;  // per CTA on an H100

struct Taps {
  int n_runs;
  int run_dz[kMaxRuns];   // the z offset of each run
  int run_end[kMaxRuns];  // one past the run's last tap
  int off[kMaxTaps];      // dy * C + dx, in window elements
  float w[kMaxTaps];
};

__constant__ Taps c_taps;

struct Geom {
  int D, H, W, lo, hi;  // grid extent and the valid planes [lo, hi)
  int bx, by, bt, r, h;
  int R, C, P;          // window rows, columns and plane size R * C
  int zr;               // ring length 2r + 1
  int clamp, has_src;
};

__device__ __forceinline__ int pmod(int a, int n) {
  const int m = a % n;
  return m < 0 ? m + n : m;
}

// The taps at kRows cells of a stage ring, run by run; pl[run] is the
// offset of the run's plane from the ring.
__device__ __forceinline__ void tap_sums(const float* ring,
                                         const int (&cell)[kRows],
                                         const int (&pl)[kMaxRuns],
                                         int n_runs, float (&v)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) v[i] = 0.f;
  int t = 0;
#pragma unroll
  for (int run = 0; run < kMaxRuns; ++run) {
    if (run >= n_runs) break;
    const float* p = ring + pl[run];
    const int end = c_taps.run_end[run];
    if (t == 0) {
      const float w = c_taps.w[0];
      const int o = c_taps.off[0];
#pragma unroll
      for (int i = 0; i < kRows; ++i) v[i] = w * p[cell[i] + o];
      t = 1;
    }
    // Not unrolled: most runs hold one tap (a star's z taps), and the
    // unrolled loop's remainder cost more than it saved on the card.
#pragma unroll 1
    for (; t < end; ++t) {
      const float w = c_taps.w[t];
      const int o = c_taps.off[t];
#pragma unroll
      for (int i = 0; i < kRows; ++i) v[i] = fmaf(w, p[cell[i] + o], v[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
stencil3d_stream_kernel(const float* __restrict__ x,
                        const float* __restrict__ src,
                        float* __restrict__ out, const Geom g) {
  extern __shared__ float smem[];
  float* rings = smem;  // bt rings of zr planes
  float* sring = smem + (size_t)g.bt * g.zr * g.P;  // h + 1 source planes
  const int n_runs = c_taps.n_runs;
  const int n_smem = (g.bt * g.zr + (g.has_src ? g.h + 1 : 0)) * g.P;
  const int xbase = blockIdx.x * g.bx - g.h;
  const int ybase = blockIdx.y * g.by - g.h;
  const size_t plane_elems = (size_t)g.H * g.W;

  for (int i = threadIdx.x; i < n_smem; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  for (int k = 0; k < g.D + g.h; ++k) {
    // Plane k of the grid (filled) and of the source enter the rings. A
    // work item is kRows cells down one column; all its loads are issued
    // before its stores.
    const bool zin = k >= g.lo && k < g.hi;
    const size_t k_off = (size_t)(zin ? k : 0) * plane_elems;
    float* slot = rings + (size_t)(k % g.zr) * g.P;
    float* sslot = sring + (size_t)(k % (g.h + 1)) * g.P;
    const int load_items = (g.R + kRows - 1) / kRows * g.C;
    for (int item = threadIdx.x; item < load_items; item += kThreads) {
      const int gi = item / g.C, c = item - gi * g.C, j0 = gi * kRows;
      const int xx = xbase + c;
      const bool xin = xx >= 0 && xx < g.W;
      const int xc = min(max(xx, 0), g.W - 1);
      float v[kRows], sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int y = ybase + j0 + i;
        const bool in = xin && y >= 0 && y < g.H;
        const size_t at =
            k_off + (size_t)min(max(y, 0), g.H - 1) * g.W + xc;
        const bool ok = zin && j0 + i < g.R;
        v[i] = (ok && (in || g.clamp)) ? x[at] : 0.f;
        sv[i] = (ok && g.has_src && in) ? src[at] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (j0 + i < g.R) {
          slot[(j0 + i) * g.C + c] = v[i];
          if (g.has_src) sslot[(j0 + i) * g.C + c] = sv[i];
        }
      }
    }
    __syncthreads();

    for (int s = 0; s < g.bt; ++s) {
      const int z = k - (s + 1) * g.r;  // this stage's output plane
      const bool last = s == g.bt - 1;
      const bool zvalid = z >= g.lo && z < g.hi;
      // Under clamp no later stage reads a plane outside [lo, hi); under
      // dirichlet0 those planes are zero and the next stage reads them.
      const bool active =
          g.clamp ? zvalid : (!last || (z >= 0 && z < g.D));
      if (active) {
        const int m = (s + 1) * g.r;
        const int rows = g.R - 2 * m, cols = g.C - 2 * m;
        const float* ring = rings + (size_t)s * g.zr * g.P;
        int pl[kMaxRuns];
#pragma unroll
        for (int run = 0; run < kMaxRuns; ++run) {
          if (run >= n_runs) break;
          int zz = z + c_taps.run_dz[run];
          if (g.clamp) zz = min(max(zz, g.lo), g.hi - 1);
          pl[run] = pmod(zz, g.zr) * g.P;
        }
        float* dst =
            last ? nullptr
                 : rings + ((size_t)(s + 1) * g.zr + pmod(z, g.zr)) * g.P;
        const float* sp = sring + (size_t)pmod(z, g.h + 1) * g.P;
        // Under clamp the last stage also writes the planes outside an
        // interior [lo, hi): plane lo below it, plane hi - 1 above it.
        const int z_first = (g.clamp && z == g.lo) ? 0 : z;
        const int z_end = (g.clamp && z == g.hi - 1) ? g.D : z + 1;
        const int items = (rows + kRows - 1) / kRows * cols;
        for (int item = threadIdx.x; item < items; item += kThreads) {
          const int gi = item / cols, c = m + item - gi * cols;
          const int j0 = m + gi * kRows;
          const int xx = xbase + c;
          const bool xin = xx >= 0 && xx < g.W;
          const int cc = min(max(xx, 0), g.W - 1) - xbase;
          int cell[kRows];
          bool in[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            // Rows past the region repeat its last row; nothing stores
            // them.
            const int j = min(j0 + i, g.R - m - 1);
            const int y = ybase + j;
            in[i] = xin && y >= 0 && y < g.H;
            cell[i] = in[i] ? j * g.C + c
                            : (min(max(y, 0), g.H - 1) - ybase) * g.C + cc;
          }
          float v[kRows];
          if (zvalid) {
            tap_sums(ring, cell, pl, n_runs, v);
          } else {
#pragma unroll
            for (int i = 0; i < kRows; ++i) v[i] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (j0 + i >= g.R - m) continue;
            float r = v[i];
            if (zvalid && g.has_src) r += sp[cell[i]];
            if (!g.clamp && !in[i]) r = 0.f;
            if (!last) {
              dst[(j0 + i) * g.C + c] = r;
            } else if (in[i]) {
              const size_t at = (size_t)(ybase + j0 + i) * g.W + xx;
              for (int zo = z_first; zo < z_end; ++zo) {
                out[(size_t)zo * plane_elems + at] = r;
              }
            }
          }
        }
      }
      // The next stage reads this stage's plane; the next z step overwrites
      // the source slot the last stage read.
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// bt fused steps of the (dz, dy, dx, w) taps on x -> out, on `stream`.
// `src` may be NULL. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int stencil3d_stream(const float* x, const float* src, float* out, int D,
                     int H, int W, int lo, int hi, int bx, int by, int bt,
                     int r, int clamp, int n_taps, const int* dz,
                     const int* dy, const int* dx, const float* w,
                     void* stream) {
  if (n_taps < 0 || n_taps > kMaxTaps || D < 1 || H < 1 || W < 1 ||
      bx < 1 || by < 1 || bt < 1 || r < 1 || r > 4 || lo < 0 || lo >= hi ||
      hi > D) {
    return cudaErrorInvalidValue;
  }
  Geom g;
  g.D = D;
  g.H = H;
  g.W = W;
  g.lo = lo;
  g.hi = hi;
  g.bx = bx;
  g.by = by;
  g.bt = bt;
  g.r = r;
  g.h = bt * r;
  if (g.h > bx) return cudaErrorInvalidValue;
  g.R = by + 2 * g.h;
  g.C = bx + 2 * g.h;
  g.P = g.R * g.C;
  g.zr = 2 * r + 1;
  g.clamp = clamp != 0;
  g.has_src = src != nullptr;
  const size_t smem =
      sizeof(float) * (size_t)(bt * g.zr + (g.has_src ? g.h + 1 : 0)) * g.P;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  Taps taps = {};
  for (int t = 0; t < n_taps; ++t) {
    if (dz[t] < -r || dz[t] > r || dy[t] < -r || dy[t] > r || dx[t] < -r ||
        dx[t] > r) {
      return cudaErrorInvalidValue;
    }
    if (t == 0 || dz[t] != dz[t - 1]) {
      if (taps.n_runs == kMaxRuns) return cudaErrorInvalidValue;
      taps.run_dz[taps.n_runs++] = dz[t];
    }
    taps.run_end[taps.n_runs - 1] = t + 1;
    taps.off[t] = dy[t] * g.C + dx[t];
    taps.w[t] = w[t];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyToSymbolAsync(c_taps, &taps, sizeof(Taps), 0,
                                          cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(stencil3d_stream_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + bx - 1) / bx, (H + by - 1) / by);
  stencil3d_stream_kernel<<<grid, kThreads, smem, s>>>(x, src, out, g);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
