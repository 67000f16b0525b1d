// stencil2d_revolving.cu: the revolving 2D blocked stencil kernel for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel_2d_revolving` in
// src/repro/kernels/engine.py (launched by `_run_2d`, the engine's default
// 2D variant). One call runs `bt` fused time steps of a 2D star or box spec
// of radius 1..4 on a float32 [H, W] grid:
//
//     fill, (apply taps, + source, fill) x bt
//
// where `fill` re-imposes the boundary at true grid edges only (columns
// outside [0, W), rows outside the validity interval [lo, hi)): zero for
// dirichlet0, the nearest inside cell of the current step for clamp. The
// optional source is the engine's pre-summed source grid, zero outside.
//
// What bounds it on an H100: HBM bytes. One call must move
// BlockPlan.hbm_bytes_per_sweep = H*W*4*(1 + n_src + 1) bytes (read the
// grid and the source once, write the grid once) and does about
// bt*(2*taps) flops per cell; for the 5-point Hotspot star at bt = 8 that
// is ~7 flops per byte against the card's ~20 (67 TFLOP/s fp32 over
// 3.35 TB/s).
//
// What the design does about it:
//  * One CTA owns a band of `by` output rows and walks the `bx`-wide
//    x-tiles of its band in order: the TPU's sequential grid becomes a
//    loop inside the block. A ring of three tile slots of (by + 2h) rows
//    per streamed operand lives in dynamic shared memory; tile i+1 is
//    loaded before tile i is computed, so every input cell is read from
//    HBM once, plus the 2h rows a band shares with each neighbour.
//  * The bt fused steps run on a (by + 2h) x (bx + 2h) window assembled
//    from the ring and ping-ponged between two shared buffers with a
//    barrier between steps; nothing goes back to HBM between steps. Step
//    s fills and computes only the region later steps still read (it
//    shrinks by r per step), so the overcompute is BlockPlan.redundancy.
//  * Taps arrive as a (dy, dx, w) list in the plugin's order (center,
//    axis 0, axis 1; box taps in index order) and are summed in that
//    order, so the float sums associate as the plain version's do (up
//    to fused multiply-add rounding).
// Left for later: cp.async/TMA prefetch so the load of tile i+1 overlaps
// the compute of tile i, and more than one CTA per SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (kernels/_build.py); bound with ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace {

constexpr int kMaxTaps = 81;             // a radius-4 box
constexpr int kThreads = 512;
constexpr size_t kSmemLimit = 227 * 1024;  // per CTA on an H100

struct Taps {
  int n;
  int off[kMaxTaps];  // dy * C + dx, in window elements
  float w[kMaxTaps];
};

struct Geom {
  int H, W, lo, hi;  // grid extent and the valid rows [lo, hi)
  int bx, by, bt, r, h;
  int R, C, nt;      // window rows and columns, number of x-tiles
  int clamp, has_src;
};

// Value of the streamed operand at window row j, grid column x, from the
// ring holding tiles i-1, i, i+1 (zero outside the tiles of the grid).
__device__ __forceinline__ float ring_at(const float* ring, const Geom& g,
                                         int j, int x) {
  if (x < 0) return 0.f;
  const int t = x / g.bx;
  if (t >= g.nt) return 0.f;
  return ring[(t % 3) * g.R * g.bx + j * g.bx + (x - t * g.bx)];
}

// Load x-tile t of the band starting at row y0 into its ring slot; cells
// outside the valid rows or past column W read 0.
__device__ void load_tile(float* ring, const float* __restrict__ in,
                          const Geom& g, int y0, int t) {
  float* slot = ring + (t % 3) * g.R * g.bx;
  const int n = g.R * g.bx;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / g.bx, c = idx - j * g.bx;
    const int y = y0 - g.h + j, x = t * g.bx + c;
    float v = 0.f;
    if (y >= g.lo && y < g.hi && x < g.W) v = in[(size_t)y * g.W + x];
    slot[idx] = v;
  }
}

// Boundary fill of the window region [m, R-m) x [m, C-m). A clamp source
// cell is inside the grid, so the fill never writes a cell it reads.
__device__ void fill(float* win, const Geom& g, int y0, int x0, int m) {
  const int rows = g.R - 2 * m, cols = g.C - 2 * m;
  const int ybase = y0 - g.h, xbase = x0 - g.h;
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int j = m + idx / cols, k = m + idx % cols;
    const int y = ybase + j, x = xbase + k;
    if (y >= g.lo && y < g.hi && x >= 0 && x < g.W) continue;
    float v = 0.f;
    if (g.clamp) {
      const int jc = min(max(min(max(y, g.lo), g.hi - 1) - ybase, 0), g.R - 1);
      const int kc = min(max(min(max(x, 0), g.W - 1) - xbase, 0), g.C - 1);
      v = win[jc * g.C + kc];
    }
    win[j * g.C + k] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
stencil2d_revolving_kernel(const float* __restrict__ x,
                           const float* __restrict__ src,
                           float* __restrict__ out, const Geom g,
                           const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  const int ring_len = 3 * g.R * g.bx;
  float* ring_x = smem;
  float* ring_s = smem + ring_len;
  float* buf_a = smem + ring_len * (g.has_src ? 2 : 1);
  float* buf_b = buf_a + g.R * g.C;
  const int y0 = blockIdx.x * g.by;
  // Under clamp, a band with no row in [lo, hi) cannot see the row it
  // replicates; clamp_edge_rows_kernel writes its rows after this launch.
  if (g.clamp && (y0 + g.by <= g.lo || y0 >= g.hi)) return;

  load_tile(ring_x, x, g, y0, 0);
  if (g.has_src) load_tile(ring_s, src, g, y0, 0);
  for (int i = 0; i < g.nt; ++i) {
    if (i + 1 < g.nt) {
      load_tile(ring_x, x, g, y0, i + 1);
      if (g.has_src) load_tile(ring_s, src, g, y0, i + 1);
    }
    __syncthreads();
    const int x0 = i * g.bx, xbase = x0 - g.h;
    for (int idx = threadIdx.x; idx < g.R * g.C; idx += blockDim.x) {
      const int j = idx / g.C, k = idx - j * g.C;
      buf_a[idx] = ring_at(ring_x, g, j, xbase + k);
    }
    __syncthreads();
    float* cur = buf_a;
    float* nxt = buf_b;
    for (int s = 0; s < g.bt; ++s) {
      fill(cur, g, y0, x0, s * g.r);
      __syncthreads();
      const int m = (s + 1) * g.r;
      const int rows = g.R - 2 * m, cols = g.C - 2 * m;
      for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
        const int j = m + idx / cols, k = m + idx % cols;
        const float* c = cur + j * g.C + k;
        float acc = taps.n > 0 ? taps.w[0] * c[taps.off[0]] : 0.f;
        for (int t = 1; t < taps.n; ++t) {
          acc = fmaf(taps.w[t], c[taps.off[t]], acc);
        }
        if (g.has_src) acc += ring_at(ring_s, g, j, xbase + k);
        nxt[j * g.C + k] = acc;
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    fill(cur, g, y0, x0, g.h);
    __syncthreads();
    for (int idx = threadIdx.x; idx < g.by * g.bx; idx += blockDim.x) {
      const int jj = idx / g.bx, kk = idx - jj * g.bx;
      const int y = y0 + jj, xx = x0 + kk;
      if (y < g.H && xx < g.W) {
        out[(size_t)y * g.W + xx] = cur[(g.h + jj) * g.C + g.h + kk];
      }
    }
    // The next iteration overwrites the ring slot of tile i-1 and buf_a.
    __syncthreads();
  }
}

// The clamp fill of the bands wholly outside [lo, hi): rows [0, top) take
// row lo of the result, rows [bottom, H) take row hi - 1.
__global__ void clamp_edge_rows_kernel(float* __restrict__ out, int W,
                                       int top, int lo, int bottom, int hi,
                                       int H) {
  const size_t n_top = (size_t)top * W;
  const size_t n = n_top + (size_t)(H - bottom) * W;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const bool above = i < n_top;
    const size_t k = above ? i : i - n_top;
    const size_t y = above ? k / W : bottom + k / W;
    const size_t x = k % W;
    out[y * W + x] = out[(size_t)(above ? lo : hi - 1) * W + x];
  }
}

}  // namespace

extern "C" {

// bt fused steps of the (dy, dx, w) taps on x -> out, on `stream`.
// `src` may be NULL. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int stencil2d_revolving(const float* x, const float* src, float* out, int H,
                        int W, int lo, int hi, int bx, int by, int bt, int r,
                        int clamp, int n_taps, const int* dy, const int* dx,
                        const float* w, void* stream) {
  if (n_taps < 0 || n_taps > kMaxTaps || H < 1 || W < 1 || bx < 1 ||
      by < 1 || bt < 1 || r < 1 || r > 4 || lo < 0 || lo >= hi || hi > H) {
    return cudaErrorInvalidValue;
  }
  Geom g;
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
  g.nt = (W + bx - 1) / bx;
  g.clamp = clamp != 0;
  g.has_src = src != nullptr;
  const size_t smem =
      sizeof(float) * ((size_t)(g.has_src ? 2 : 1) * 3 * g.R * bx +
                       2 * (size_t)g.R * g.C);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  Taps taps;
  taps.n = n_taps;
  for (int t = 0; t < n_taps; ++t) {
    if (dy[t] < -r || dy[t] > r || dx[t] < -r || dx[t] > r) {
      return cudaErrorInvalidValue;
    }
    taps.off[t] = dy[t] * g.C + dx[t];
    taps.w[t] = w[t];
  }
  cudaError_t e = cudaFuncSetAttribute(
      stencil2d_revolving_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int bands = (H + by - 1) / by;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stencil2d_revolving_kernel<<<bands, kThreads, smem, s>>>(x, src, out, g,
                                                           taps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // Rows [0, top) and [bottom, H) are the bands wholly outside [lo, hi).
  const int top = (lo / by) * by;
  const int bottom = std::min(H, (hi + by - 1) / by * by);
  if (g.clamp && (top > 0 || bottom < H)) {
    const size_t n = (size_t)(top + H - bottom) * W;
    const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
    clamp_edge_rows_kernel<<<blocks, 256, 0, s>>>(out, W, top, lo, bottom,
                                                  hi, H);
  }
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
