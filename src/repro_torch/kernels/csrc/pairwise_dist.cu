// Pairwise squared euclidean distances for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernels of repro/kernels/pairwise_dist.py
// (pairwise_sq_dists and pairwise_sq_dists_batched):
//   out[l, i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)
// for x (b, n, d) and y (b, m, d). One entry point with a leading lane axis
// serves both (2-D is b = 1). Either operand may be shared by every lane
// (lane stride 0): K-Means passes one x (n, d) against per-lane centroids
// (b, k_pad, d), so the b copies of x that the reference broadcasts into
// existence are never made.
//
// What bounds it on an H100: K-Means' shapes are tall and thin (n ~ 1e6
// points, m = k <= a few dozen centroids, d ~ 6 features). Each output
// costs 2d + 3 flops against 4 bytes written, ~4 flop/byte, far below the
// card's ~20 fp32 flop/byte, so the write of D^2 (4 n m bytes a lane) is
// the bound. There is nothing for tensor cores to do at d = 6: no wgmma,
// no TF32, fp32 FMAs on CUDA cores.
//
// Two paths, chosen per launch by shape:
//
// * Thin (m <= kThinMaxM, d <= kThinMaxD: every K-Means launch). Persistent
//   blocks, as many as fit on the card, walk 32-row tiles of x, one warp per
//   tile and one thread per x row:
//   - y and its squared norms for every lane the block serves sit in shared
//     memory, loaded once per block, rows padded with zeros to DB (8, 16 or
//     32) floats and read as float4 broadcasts;
//   - each thread keeps its x row in registers (zero padded to DB) with its
//     norm, and computes all m outputs of that row: no idle columns, no
//     index arithmetic per output, and the next tile's row is loaded while
//     this one computes. (Streaming each warp's x tile through a cp.async
//     ring in shared memory instead was faster with 16 lanes but slower
//     with one lane at m = 24 and at m = 2: no gain at the launches K-Means
//     makes, so the rows stay plain loads);
//   - when x is shared, the warp loops over the block's lanes with the row
//     still in registers, so a 16-lane wave reads x once, not 16 times;
//   - a warp's output tile for one lane (32 rows x m) is one contiguous
//     stretch of out. Each thread writes its row into the warp's own stage,
//     laid out as out is, 4 or 2 outputs at a time where m allows (16- or
//     8-byte shared stores, at most 2-way bank conflicts at m = 24), and the
//     warp copies the stage out with consecutive threads on consecutive 16
//     bytes (4 bytes where the destination is not 16-byte aligned: a lane
//     base when n m % 4 != 0), so every write is whole 128-byte lines. Warps
//     synchronise only with themselves (__syncwarp); the block only at the
//     start, for y.
//   A 1-D bulk (TMA) store of the stage (two stages a warp, a proxy fence
//   and a bulk-group wait before a stage is reused, 16-byte-aligned lane
//   bases and sizes only) timed no faster than this copy on an H100 at
//   K-Means' shapes, so the copy stays.
//
// * General (larger m or d): a block owns 128 x rows and 32 y rows, stages
//   both over d in steps of 32 features in shared memory, each thread
//   accumulates a 4 x 4 register tile of x.y, and the clamped tile is staged
//   and written row by row. Ragged rows and columns are zero-filled in the
//   loads and masked in the stores.
//
// Both paths add in the same order: dot products and norms by fmaf over
// the features in ascending order from +0 (a zero pad adds exactly +0), and
// the same epilogue, so a shape gives the same bits on either path and from
// call to call. No atomics, no scratch: every output is written by one
// thread of one block.
//
// The bf16 half (pairwise_sq_dists_bf16: bf16 x and y, fp32 out, as the TPU
// kernel casts its blocks to f32 and writes f32) is both paths instantiated
// for bf16 operands: each element is widened to fp32 as it is loaded (two
// bytes a load: a K-Means row of 6 bf16 is 12 bytes, not 8- or 16-byte
// aligned), y is staged in shared memory as fp32, and from there the
// arithmetic and the store are the fp32 code's. Widening is exact, so the
// bf16 half's output is the fp32 kernel's on the widened inputs, bit for
// bit. Its byte bound falls only by x's and y's halves: D^2 stays 4 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// One element as fp32: a float as it is, a bf16 widened (exactly).
__device__ __forceinline__ float widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// ---------------------------------------------------------------------------
// Thin path
// ---------------------------------------------------------------------------
constexpr int kThinMaxM = 64;                 // largest m of the thin path
constexpr int kThinMaxD = 32;                 // largest d of the thin path
constexpr int kThinThreads = 256;
constexpr int kThinWarps = kThinThreads / 32;
constexpr int kThinYBytes = 16 * 1024;        // shared memory for y and its norms, per block

// x row `row` into registers as fp32, zero padded to DB; all zeros past the end.
template <int DB, typename T>
__device__ __forceinline__ void load_row(float (&xr)[DB], const T* __restrict__ x, long long row,
                                         int n, int d) {
  const bool ok = row < n;
  const T* p = x + row * d;
#pragma unroll
  for (int c = 0; c < DB; ++c) xr[c] = (ok && c < d) ? widen(p + c) : 0.f;
}

template <int DB>
__device__ __forceinline__ float sq_norm(const float (&v)[DB]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DB; ++c) s = fmaf(v[c], v[c], s);
  return s;
}

// Dynamic shared memory of one block: y rows (DB floats each) and norms of
// `chunk` lanes, then one (32 x m) stage per warp.
constexpr size_t thin_smem_floats(int db, int chunk, int m) {
  return (size_t)chunk * m * db + (((size_t)chunk * m + 3) & ~(size_t)3) + (size_t)kThinWarps * 32 * m;
}

// One x row's m outputs against a lane's y rows `yl` (DB floats each) and
// norms `ynl`, into its stage row `srow`, V at a time: V = 4 (m % 4 == 0)
// or 2 (m even) makes the writes 16- or 8-byte stores, which keep the
// warp's writes at a row pitch of m free of most bank conflicts.
template <int DB, int V>
__device__ __forceinline__ void row_out(const float (&xr)[DB], float xn, const float* __restrict__ yl,
                                        const float* __restrict__ ynl, float* srow, int m) {
#pragma unroll 2
  for (int j0 = 0; j0 < m; j0 += V) {
    float v[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float4* yr = reinterpret_cast<const float4*>(yl + (j0 + u) * DB);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < DB / 4; ++q) {
        const float4 w = yr[q];
        acc = fmaf(xr[4 * q], w.x, acc);
        acc = fmaf(xr[4 * q + 1], w.y, acc);
        acc = fmaf(xr[4 * q + 2], w.z, acc);
        acc = fmaf(xr[4 * q + 3], w.w, acc);
      }
      v[u] = fmaxf(xn + ynl[j0 + u] - 2.f * acc, 0.f);
    }
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(srow + j0) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(srow + j0) = make_float2(v[0], v[1]);
    } else {
      srow[j0] = v[0];
    }
  }
}

// grid (blocks, ceil(b / chunk)), block kThinThreads. Block (bx, by) serves
// lanes [by * chunk, by * chunk + chunk) and walks 32-row tiles t = bx *
// kThinWarps + warp, stepping by gridDim.x * kThinWarps. T: float, or
// __nv_bfloat16 (widened as it is loaded).
template <int DB, typename T>
__global__ void __launch_bounds__(kThinThreads)
pairwise_thin(const T* __restrict__ x, const T* __restrict__ y, float* __restrict__ out, int b,
              int n, int m, int d, long long x_lane, long long y_lane, int chunk) {
  extern __shared__ float4 thin_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l0 = blockIdx.y * chunk;
  const int nl = min(chunk, b - l0);
  const int ny = nl * m;
  float* ys = reinterpret_cast<float*>(thin_smem);
  float* yn = ys + ny * DB;
  float* stage = yn + ((ny + 3) & ~3) + warp * 32 * m;  // 16-byte aligned: 32 m floats a warp

  const long long tiles = ((long long)n + 31) / 32;
  const long long step = (long long)gridDim.x * kThinWarps;
  const bool shared_x = x_lane == 0;
  float xr[DB], xnext[DB];
  long long t = (long long)blockIdx.x * kThinWarps + warp;
  if (shared_x && t < tiles) load_row(xnext, x, t * 32 + lane, n, d);  // in flight while y loads
  for (int r = tid; r < ny; r += kThinThreads) {
    const int l = r / m, j = r - l * m;
    const T* src = y + (l0 + l) * y_lane + (long long)j * d;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < DB; ++c) {
      const float v = c < d ? widen(src + c) : 0.f;
      ys[r * DB + c] = v;
      s = fmaf(v, v, s);
    }
    yn[r] = s;
  }
  __syncthreads();
  for (; t < tiles; t += step) {
    const long long r0 = t * 32;
    const int rows = (int)min(32LL, (long long)n - r0);
    float xn = 0.f;
    if (shared_x) {
#pragma unroll
      for (int c = 0; c < DB; ++c) xr[c] = xnext[c];
      if (t + step < tiles) load_row(xnext, x, (t + step) * 32 + lane, n, d);
      xn = sq_norm(xr);
    }
    for (int li = 0; li < nl; ++li) {
      const long long l = l0 + li;
      if (!shared_x) {
        load_row(xr, x + l * x_lane, r0 + lane, n, d);
        xn = sq_norm(xr);
      }
      if (lane < rows) {
        const float* yl = ys + li * m * DB;
        const float* ynl = yn + li * m;
        float* srow = stage + lane * m;
        if (m % 4 == 0) {
          row_out<DB, 4>(xr, xn, yl, ynl, srow, m);
        } else if (m % 2 == 0) {
          row_out<DB, 2>(xr, xn, yl, ynl, srow, m);
        } else {
          row_out<DB, 1>(xr, xn, yl, ynl, srow, m);
        }
      }
      __syncwarp();
      float* dst = out + l * n * m + r0 * m;
      const int count = rows * m;
      // The stage is laid out as out is: a straight copy, in 16-byte pieces
      // where the destination is 16-byte aligned (always when n m % 4 == 0).
      int e = lane;
      if ((reinterpret_cast<size_t>(dst) & 15) == 0) {
        const int quads = count >> 2;
        for (int q = lane; q < quads; q += 32)
          reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(stage)[q];
        e += 4 * quads;
      }
      for (; e < count; e += 32) dst[e] = stage[e];
      __syncwarp();  // the stage is rewritten for the next lane or tile
    }
  }
}

template <int DB, typename T>
int launch_thin(const T* x, const T* y, float* out, int b, int n, int m, int d, long long x_lane,
                long long y_lane, cudaStream_t stream) {
  // With x shared, a block serves as many lanes as its y budget holds, so x
  // is read once per chunk of lanes; with x per lane, one lane a block. One
  // lane has its x shared whatever its stride.
  if (b == 1) x_lane = 0;
  const int per_lane = m * (DB + 1) * (int)sizeof(float);
  const int chunk = x_lane == 0 ? max(1, min(b, kThinYBytes / per_lane)) : 1;
  const size_t smem = thin_smem_floats(DB, chunk, m) * sizeof(float);
  auto kernel = pairwise_thin<DB, T>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThinThreads, smem)) != cudaSuccess)
    return (int)err;
  const int chunks = (b + chunk - 1) / chunk;
  const long long tiles = ((long long)n + 31) / 32;
  const long long tile_blocks = (tiles + kThinWarps - 1) / kThinWarps;
  long long blocks = (long long)sms * max(per_sm, 1) / chunks;
  blocks = max(1LL, min(blocks, tile_blocks));
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  kernel<<<grid, kThinThreads, smem, stream>>>(x, y, out, b, n, m, d, x_lane, y_lane, chunk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// General path
// ---------------------------------------------------------------------------
constexpr int kTileN = 128;                              // x rows per block
constexpr int kTileM = 32;                               // y rows per block
constexpr int kStepD = 32;                               // features per shared step
constexpr int kThreads = 256;
constexpr int kColGroups = 8;                            // threads across the y tile
constexpr int kRowGroups = kThreads / kColGroups;        // 32 threads down the x tile
constexpr int kRowsPerThread = kTileN / kRowGroups;      // 4
constexpr int kColsPerThread = kTileM / kColGroups;      // 4
static_assert(kTileN * (kStepD + 1) >= kTileN * (kTileM + 1), "the x tile holds the output stage");

// grid (ceil(n / kTileN), ceil(m / kTileM), b), block kThreads. Thread
// (tx, ty) = (tid % 8, tid / 8) owns cells (ty + 32 i, tx + 8 j), i, j < 4,
// and the squared norm of x row tid (tid < kTileN) or y row tid - kTileN.
// T: float, or __nv_bfloat16 (widened as it is staged).
template <typename T>
__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const T* __restrict__ x, const T* __restrict__ y,
                float* __restrict__ out, int n, int m, int d,
                long long x_lane, long long y_lane) {
  __shared__ float xs[kTileN][kStepD + 1];  // x tile; then the output stage, row pitch kTileM + 1
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
    for (int e = tid; e < kTileN * kStepD; e += kThreads) {
      const int r = e / kStepD, c = e % kStepD;
      xs[r][c] = r < rows && c < step ? widen(x + (long long)r * d + d0 + c) : 0.f;
    }
    for (int e = tid; e < kTileM * kStepD; e += kThreads) {
      const int r = e / kStepD, c = e % kStepD;
      ys[r][c] = r < cols && c < step ? widen(y + (long long)r * d + d0 + c) : 0.f;
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
  float* stage = &xs[0][0];  // (kTileN, kTileM + 1); every x read is done
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + kRowGroups * i;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = tx + kColGroups * j;
      stage[r * (kTileM + 1) + c] = fmaxf(xn[r] + yn[c] - 2.f * acc[i][j], 0.f);
    }
  }
  __syncthreads();
  for (int e = tid; e < kTileN * kTileM; e += kThreads) {
    const int r = e / kTileM, c = e % kTileM;
    if (r < rows && c < cols) out[(long long)(i0 + r) * m + j0 + c] = stage[r * (kTileM + 1) + c];
  }
}

// Either path by shape, for operands of type T.
template <typename T>
int launch(const T* x, const T* y, float* out, int b, int n, int m, int d, long long x_lane_stride,
           long long y_lane_stride, cudaStream_t s) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || d < 1 || x_lane_stride < 0 || y_lane_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (m <= kThinMaxM && d <= kThinMaxD) {
    if (d <= 8) return launch_thin<8>(x, y, out, b, n, m, d, x_lane_stride, y_lane_stride, s);
    if (d <= 16) return launch_thin<16>(x, y, out, b, n, m, d, x_lane_stride, y_lane_stride, s);
    return launch_thin<32>(x, y, out, b, n, m, d, x_lane_stride, y_lane_stride, s);
  }
  const long long m_tiles = ((long long)m + kTileM - 1) / kTileM;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileN - 1) / kTileN, (unsigned)m_tiles, b);
  pairwise_kernel<T><<<grid, kThreads, 0, s>>>(x, y, out, n, m, d, x_lane_stride, y_lane_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Device pointers of contiguous fp32
// tensors: x (b, n, d) with lane stride x_lane_stride elements (0: one x
// (n, d) shared by every lane), y (b, m, d) likewise (may alias x), out
// (b, n, m). Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int pairwise_sq_dists(const float* x, const float* y, float* out, int b, int n,
                                 int m, int d, long long x_lane_stride, long long y_lane_stride,
                                 void* stream) {
  return launch<float>(x, y, out, b, n, m, d, x_lane_stride, y_lane_stride, (cudaStream_t)stream);
}

// The bf16 half: bf16 x and y (lane strides in elements, as above), fp32 out
// (b, n, m); the fp32 kernel's bits on the widened operands.
extern "C" int pairwise_sq_dists_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y, float* out, int b,
                                      int n, int m, int d, long long x_lane_stride, long long y_lane_stride,
                                      void* stream) {
  return launch<__nv_bfloat16>(x, y, out, b, n, m, d, x_lane_stride, y_lane_stride, (cudaStream_t)stream);
}
