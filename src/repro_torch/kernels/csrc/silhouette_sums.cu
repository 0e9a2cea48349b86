// Streaming silhouette distance sums for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of repro/kernels/silhouette_sums.py
// (silhouette_dist_sums and silhouette_dist_sums_batched):
//   out[l, i, c] = sum_j sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)) * onehot[l, j, c]
// One kernel with a leading lane axis serves both entry points (2-D is
// b = 1). Masked points carry all-zero one-hot rows and contract to nothing.
//
// What bounds it on an H100: at NMFk's shapes (64 pooled columns of
// dimension ~1000 per lane, a handful of lanes) the whole input is a few
// hundred KB and the work a few MFLOP, so one launch is bound by its own
// launch and latency, not by bytes or flops. The design keeps it to one
// launch per scoring pass and never writes the (n, m) distance matrix:
// a block owns a tile of x rows, loops over y tiles, builds each distance
// tile over d in registers, clamps it at 0 before sqrt (near-duplicate
// pooled columns make |x|^2 + |y|^2 - 2 x.y a cancellation), and
// contracts it into its (rows, k) accumulator in registers. Blocks run in
// any order and own disjoint outputs; ragged n, m, d and k are masked in
// the kernel, not padded.
//
// Simple first version: fp32 FMA on CUDA cores with shared-memory tiles.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxClusters = 128;                    // largest k the kernel takes
constexpr int kTileX = 32;                           // x rows per block
constexpr int kTileY = 32;                           // y rows per step
constexpr int kStepD = 32;                           // feature step per shared tile
constexpr int kRows = 8;                             // blockDim.y
constexpr int kThreads = kTileX * kRows;             // 256
constexpr int kRowsPerThread = kTileX / kRows;       // 4 x rows per thread
constexpr int kColsPerThread = kMaxClusters / kTileY;  // 4 clusters per thread

// grid (ceil(n / kTileX), b), block (32, kRows). In the distance phase thread
// (tx, ty) owns y row j0 + tx and x rows ty + kRows * r; in the contraction
// phase it owns clusters tx + 32 * q of the same x rows.
__global__ void __launch_bounds__(kThreads)
dist_sums_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ onehot, float* __restrict__ out,
                 int n, int m, int d, int k) {
  __shared__ float xs[kTileX][kStepD + 1];
  __shared__ float ys[kTileY][kStepD + 1];
  __shared__ float ds[kTileX][kTileY + 1];
  __shared__ float gs[kTileY][kMaxClusters];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileY + tx;
  const int i0 = blockIdx.x * kTileX;
  const size_t lane = blockIdx.y;
  x += lane * n * d;
  y += lane * m * d;
  onehot += lane * m * k;
  out += lane * n * k;

  float oacc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) oacc[r][c] = 0.f;

  for (int j0 = 0; j0 < m; j0 += kTileY) {
    float dot[kRowsPerThread], xn[kRowsPerThread], yn = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) dot[r] = xn[r] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kStepD) {
      for (int e = tid; e < kTileX * kStepD; e += kThreads) {
        const int rr = e / kStepD, cc = e % kStepD;
        const int gi = i0 + rr, gd = d0 + cc;
        xs[rr][cc] = (gi < n && gd < d) ? x[(size_t)gi * d + gd] : 0.f;
      }
      for (int e = tid; e < kTileY * kStepD; e += kThreads) {
        const int rr = e / kStepD, cc = e % kStepD;
        const int gj = j0 + rr, gd = d0 + cc;
        ys[rr][cc] = (gj < m && gd < d) ? y[(size_t)gj * d + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < kStepD; ++cc) {
        const float yv = ys[tx][cc];
        yn += yv * yv;
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float xv = xs[ty + kRows * r][cc];
          dot[r] += xv * yv;
          xn[r] += xv * xv;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      ds[ty + kRows * r][tx] = sqrtf(fmaxf(xn[r] + yn - 2.f * dot[r], 0.f));
    for (int e = tid; e < kTileY * k; e += kThreads) {
      const int rr = e / k, cc = e % k;
      const int gj = j0 + rr;
      gs[rr][cc] = (gj < m) ? onehot[(size_t)gj * k + cc] : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kTileY; ++jj) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float dv = ds[ty + kRows * r][jj];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const int cl = tx + kTileY * c;
          if (cl < k) oacc[r][c] += dv * gs[jj][cl];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = i0 + ty + kRows * r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int cl = tx + kTileY * c;
      if (cl < k) out[(size_t)i * k + cl] = oacc[r][c];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. Device pointers of contiguous fp32
// tensors: x (b, n, d), y (b, m, d) (may alias x), onehot (b, m, k), out
// (b, n, k). Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int silhouette_dist_sums(const float* x, const float* y, const float* onehot,
                                    float* out, int b, int n, int m, int d, int k,
                                    void* stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || d < 1 || k < 1 || k > kMaxClusters)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileX - 1) / kTileX, b), block(kTileY, kRows);
  dist_sums_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, y, onehot, out, n, m, d, k);
  return (int)cudaGetLastError();
}
