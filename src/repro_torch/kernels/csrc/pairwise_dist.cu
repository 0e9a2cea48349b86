// Pairwise squared euclidean distances for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of repro/kernels/pairwise_dist.py
// (pairwise_sq_dists and pairwise_sq_dists_batched):
//   out[l, i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)
// for x (b, n, d) and y (b, m, d). One kernel with a leading lane axis
// serves both entry points (2-D is b = 1). Either operand may be shared by
// every lane (lane stride 0): K-Means passes one x (n, d) against per-lane
// centroids (b, k_pad, d), so the b copies of x that the reference
// broadcasts into existence are never made.
//
// What bounds it on an H100: K-Means' shapes are tall and thin (n ~ 1e6
// points, m = k_pad <= a few dozen centroids, d ~ 6 features). Each output
// costs 2d + 3 flops against 4 bytes written, ~4 flop/byte, far below the
// card's ~20 fp32 flop/byte, so the write of D^2 is the bound. The design
// reads every input once and keeps both the arithmetic and the write lean:
// a block owns kTileN x rows and kTileM y rows and stages both over d in
// shared memory (an x tile is one contiguous stretch of x when d <=
// kStepD); each thread accumulates a 4 x 4 register tile of x.y (8 shared
// loads feed 16 FMAs), the squared norms are summed once per row, and the
// clamped (rows, cols) tile is staged in shared memory and written out by
// consecutive threads on consecutive addresses. When m <= kTileM the tile
// is one contiguous stretch of out. Ragged n, m and d are masked in the
// loads and stores, not padded.
//
// Index arithmetic per output cell bounds such a kernel by instruction
// throughput, not by the write (one cell per thread ran at 1/6 of the HBM rate),
// so here the per-cell work is FMAs and one staged store: a 16-lane wave at
// n = 1e6, m = 24, d = 6 takes 1.24 ms against a 0.47 ms byte bound (NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py). fp32 FMA on CUDA cores; no wgmma
// or TMA, and no fused argmin (K-Means reads D^2 back).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTileN = 128;                              // x rows per block
constexpr int kTileM = 32;                               // y rows per block
constexpr int kStepD = 32;                               // features per shared step
constexpr int kThreads = 256;
constexpr int kColGroups = 8;                            // threads across the y tile
constexpr int kRowGroups = kThreads / kColGroups;        // 32 threads down the x tile
constexpr int kRowsPerThread = kTileN / kRowGroups;      // 4
constexpr int kColsPerThread = kTileM / kColGroups;      // 4

// grid (ceil(n / kTileN), ceil(m / kTileM), b), block kThreads. Thread
// (tx, ty) = (tid % 8, tid / 8) owns cells (ty + 32 i, tx + 8 j), i, j < 4,
// and the squared norm of x row tid (tid < kTileN) or y row tid - kTileN.
__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int n, int m, int d,
                long long x_lane, long long y_lane) {
  __shared__ float xs[kTileN][kStepD + 1];  // x tile; then the output staging tile
  __shared__ float ys[kTileM][kStepD + 1];
  __shared__ float xn[kTileN];
  __shared__ float yn[kTileM];
  const int tid = threadIdx.x;
  const int tx = tid % kColGroups, ty = tid / kColGroups;
  const int i0 = blockIdx.x * kTileN, j0 = blockIdx.y * kTileM;
  const long long lane = blockIdx.z;
  x += lane * x_lane + (long long)i0 * d;
  y += lane * y_lane + (long long)j0 * d;
  out += lane * (long long)n * m;
  const int rows = min(kTileN, n - i0), cols = min(kTileM, m - j0);

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;
  float norm = 0.f;

  for (int d0 = 0; d0 < d; d0 += kStepD) {
    const int step = min(kStepD, d - d0);
    for (int e = tid; e < rows * step; e += kThreads) {
      const int r = e / step, c = e - r * step;
      xs[r][c] = x[(long long)r * d + d0 + c];
    }
    for (int e = tid; e < cols * step; e += kThreads) {
      const int r = e / step, c = e - r * step;
      ys[r][c] = y[(long long)r * d + d0 + c];
    }
    __syncthreads();
    if (tid < rows) {
      for (int c = 0; c < step; ++c) norm = fmaf(xs[tid][c], xs[tid][c], norm);
    } else if (tid >= kTileN && tid - kTileN < cols) {
      const int r = tid - kTileN;
      for (int c = 0; c < step; ++c) norm = fmaf(ys[r][c], ys[r][c], norm);
    }
#pragma unroll 4
    for (int cc = 0; cc < step; ++cc) {
      float xv[kRowsPerThread], yv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) xv[i] = xs[ty + kRowGroups * i][cc];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) yv[j] = ys[tx + kColGroups * j][cc];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < kTileN) {
    xn[tid] = norm;
  } else if (tid < kTileN + kTileM) {
    yn[tid - kTileN] = norm;
  }
  __syncthreads();
  float* stage = &xs[0][0];  // (rows, cols) row-major; every x read is done
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + kRowGroups * i;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = tx + kColGroups * j;
      if (r < rows && c < cols) stage[r * cols + c] = fmaxf(xn[r] + yn[c] - 2.f * acc[i][j], 0.f);
    }
  }
  __syncthreads();
  const int cells = rows * cols;
  if (cols == m) {  // the tile is one contiguous stretch of out
    float* dst = out + (long long)i0 * m;
    for (int e = tid; e < cells; e += kThreads) dst[e] = stage[e];
  } else {
    for (int e = tid; e < cells; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      out[(long long)(i0 + r) * m + j0 + c] = stage[e];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. Device pointers of contiguous fp32
// tensors: x (b, n, d) with lane stride x_lane_stride elements (0: one x
// (n, d) shared by every lane), y (b, m, d) likewise (may alias x), out
// (b, n, m). Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pairwise_sq_dists(const float* x, const float* y, float* out, int b, int n,
                                 int m, int d, long long x_lane_stride, long long y_lane_stride,
                                 void* stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || d < 1 || x_lane_stride < 0 || y_lane_stride < 0)
    return (int)cudaErrorInvalidValue;
  const long long m_tiles = ((long long)m + kTileM - 1) / kTileM;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileN - 1) / kTileN, (unsigned)m_tiles, b);
  pairwise_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, y, out, n, m, d, x_lane_stride,
                                                              y_lane_stride);
  return (int)cudaGetLastError();
}
