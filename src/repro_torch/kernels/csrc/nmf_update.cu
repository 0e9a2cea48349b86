// Lee-Seung multiplicative-update kernels for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of repro/kernels/nmf_update.py:
//   h_update (_h_update_kernel):  H <- H * (W^T V) / (G H + 1e-9),  G = W^T W
//   w_update (_w_update_kernel):  W <- W * (V H^T) / (W Q + 1e-9),  Q = H H^T
// G and Q are k x k products made outside the kernel, as on the TPU.
//
// Both take a leading fit axis L (lanes x perturbations): every NMFk fit has
// its own perturbed V. A 2-D call is L = 1.
//
// What bounds it on an H100: reading V. Per fit and half-sweep the kernel
// does 2*n*m*k flops against 4*n*m bytes of V; at k = 16 that is 8 flops a
// byte, below the 20 flops a byte where fp32 CUDA-core math (67 TFLOP/s)
// would overtake HBM (3.35 TB/s). So each V element is read from device
// memory once, by coalesced loads, and used for all k of its products while
// it sits in a register; each thread keeps a register tile of accumulators
// (k x 4 columns, or 8 rows x k) so that a loaded value feeds many FMAs.
// The (k, m) / (n, k) numerator never reaches device memory: the
// divide-multiply epilogue runs on the block's reduced sums. Blocks run in
// any order and own disjoint outputs; the reduction axis is walked inside
// the block, with fixed-order (deterministic) reductions between its
// threads and no atomics. Ragged n, m and k are masked in the kernel, so no
// padded copy of V is made. Components masked to zero (W columns / H rows)
// stay exactly zero: 0 * acc / (0 + 1e-9) = 0.
//
// fp32 FMA on CUDA cores. wgmma, TMA and bf16 are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxRank = 128;  // largest k the kernels take
constexpr float kEps = 1e-9f;

// ---------------------------------------------------------------------------
// H-update. grid (ceil(m / (32 * COLS)), L), block (32, SLICES).
// Thread (tx, ty) owns columns j0 + tx + 32 c (c < COLS) for all KB >= k
// ranks and walks rows ty, ty + SLICES, ... of V and W: one coalesced V load
// per column feeds KB FMAs, and the W row is a broadcast load. The SLICES
// partial sums are then added in a fixed order through shared memory.
// ---------------------------------------------------------------------------
constexpr int kSlices = 8;
constexpr int kRowBatch = 4;  // rows of V loaded together per thread

template <int KB, int COLS>
__global__ void __launch_bounds__(32 * kSlices)
h_update_kernel(const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ h, const float* __restrict__ g,
                float* __restrict__ out, int n, int m, int k) {
  constexpr int kCols = 32 * COLS;  // columns per block
  __shared__ float red[KB][kCols];  // block sum of W^T V
  __shared__ float hs[KB][kCols];   // H tile for the epilogue
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int j0 = blockIdx.x * kCols;
  const size_t lane = blockIdx.y;
  v += lane * n * m;
  w += lane * n * k;
  h += lane * k * m;
  g += lane * k * k;
  out += lane * k * m;

  float acc[KB][COLS];
#pragma unroll
  for (int r = 0; r < KB; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

  // kRowBatch rows per step: their V loads are all in flight at once
  for (int i = ty; i < n; i += kRowBatch * kSlices) {
    float vv[kRowBatch][COLS];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int iu = i + u * kSlices;
      const float* vrow = v + (size_t)iu * m;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int j = j0 + tx + 32 * c;
        vv[u][c] = (iu < n && j < m) ? vrow[j] : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < KB; ++r) {
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        const int iu = i + u * kSlices;
        const float wr = (r < k && iu < n) ? __ldg(w + (size_t)iu * k + r) : 0.f;
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] += wr * vv[u][c];
      }
    }
  }

  // fixed-order sum of the slices: slice 0 stores, slices 1.. add in turn
  for (int s = 0; s < kSlices; ++s) {
    if (ty == s) {
#pragma unroll
      for (int r = 0; r < KB; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          float* cell = &red[r][tx + 32 * c];
          *cell = (s == 0) ? acc[r][c] : *cell + acc[r][c];
        }
    }
    __syncthreads();
  }

  for (int e = tid; e < KB * kCols; e += 32 * kSlices) {
    const int r = e / kCols, cl = e % kCols;
    const int j = j0 + cl;
    hs[r][cl] = (r < k && j < m) ? h[(size_t)r * m + j] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < KB * kCols; e += 32 * kSlices) {
    const int r = e / kCols, cl = e % kCols;
    const int j = j0 + cl;
    if (r >= k || j >= m) continue;
    float gh = 0.f;
    for (int q = 0; q < k; ++q) gh += g[r * k + q] * hs[q][cl];
    out[(size_t)r * m + j] = hs[r][cl] * red[r][cl] / (gh + kEps);
  }
}

// ---------------------------------------------------------------------------
// W-update. grid (ceil(n / ROWS), L), block (kWThreads).
// The block owns ROWS rows of V and W; its threads stride over the columns j
// of those rows (coalesced V and H loads), each keeping ROWS x KB partial
// sums of V H^T. A fixed-order shuffle tree and a shared-memory pass add the
// partial sums of all threads; the epilogue applies W * acc / (W Q + eps).
// ---------------------------------------------------------------------------
constexpr int kWThreads = 64;
constexpr int kWWarps = kWThreads / 32;

template <int KB, int ROWS>
__global__ void __launch_bounds__(kWThreads)
w_update_kernel(const float* __restrict__ v, const float* __restrict__ h,
                const float* __restrict__ w, const float* __restrict__ q,
                float* __restrict__ out, int n, int m, int k) {
  __shared__ float red[kWWarps][ROWS * KB];
  const int tid = threadIdx.x, warp = tid / 32, lane_id = tid % 32;
  const int i0 = blockIdx.x * ROWS;
  const size_t lane = blockIdx.y;
  v += lane * n * m;
  h += lane * k * m;
  w += lane * n * k;
  q += lane * k * k;
  out += lane * n * k;

  float acc[ROWS][KB];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < KB; ++c) acc[r][c] = 0.f;

  // two columns per step: their V and H loads are in flight together
  for (int j = tid; j < m; j += 2 * kWThreads) {
    const int j2 = j + kWThreads;
    float vv[2][ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool row = i0 + r < n;
      vv[0][r] = row ? v[(size_t)(i0 + r) * m + j] : 0.f;
      vv[1][r] = (row && j2 < m) ? v[(size_t)(i0 + r) * m + j2] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      const float h0 = c < k ? h[(size_t)c * m + j] : 0.f;
      const float h1 = (c < k && j2 < m) ? h[(size_t)c * m + j2] : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc[r][c] += vv[0][r] * h0;
        acc[r][c] += vv[1][r] * h1;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      float s = acc[r][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane_id == 0) red[warp][r * KB + c] = s;
    }
  __syncthreads();

  for (int e = tid; e < ROWS * k; e += kWThreads) {
    const int r = e / k, c = e % k;
    const int i = i0 + r;
    if (i >= n) continue;
    float num = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWWarps; ++wp) num += red[wp][r * KB + c];
    const float* wrow = w + (size_t)i * k;
    float wq = 0.f;
    for (int p = 0; p < k; ++p) wq += wrow[p] * q[p * k + c];
    out[(size_t)i * k + c] = wrow[c] * num / (wq + kEps);
  }
}

bool bad_shape(int lanes, int n, int m, int k) {
  return lanes < 1 || lanes > 65535 || n < 1 || m < 1 || k < 1 || k > kMaxRank;
}

template <int KB, int COLS>
void launch_h(const float* v, const float* w, const float* h, const float* g, float* out,
              int lanes, int n, int m, int k, cudaStream_t stream) {
  const dim3 grid((m + 32 * COLS - 1) / (32 * COLS), lanes), block(32, kSlices);
  h_update_kernel<KB, COLS><<<grid, block, 0, stream>>>(v, w, h, g, out, n, m, k);
}

template <int KB, int ROWS>
void launch_w(const float* v, const float* h, const float* w, const float* q, float* out,
              int lanes, int n, int m, int k, cudaStream_t stream) {
  const dim3 grid((n + ROWS - 1) / ROWS, lanes), block(kWThreads);
  w_update_kernel<KB, ROWS><<<grid, block, 0, stream>>>(v, h, w, q, out, n, m, k);
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers of contiguous
// fp32 tensors: v (L, n, m), w (L, n, k), h (L, k, m), g / q (L, k, k), out
// like h (H-update) or w (W-update). The register tile is picked from the
// smallest rank bucket KB >= k (16, 32, 64, 128). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int mu_update_h(const float* v, const float* w, const float* h, const float* g,
                           float* out, int lanes, int n, int m, int k, void* stream) {
  if (bad_shape(lanes, n, m, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16) launch_h<16, 4>(v, w, h, g, out, lanes, n, m, k, s);
  else if (k <= 32) launch_h<32, 2>(v, w, h, g, out, lanes, n, m, k, s);
  else if (k <= 64) launch_h<64, 1>(v, w, h, g, out, lanes, n, m, k, s);
  else launch_h<128, 1>(v, w, h, g, out, lanes, n, m, k, s);
  return (int)cudaGetLastError();
}

extern "C" int mu_update_w(const float* v, const float* h, const float* w, const float* q,
                           float* out, int lanes, int n, int m, int k, void* stream) {
  if (bad_shape(lanes, n, m, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16) launch_w<16, 8>(v, h, w, q, out, lanes, n, m, k, s);
  else if (k <= 32) launch_w<32, 4>(v, h, w, q, out, lanes, n, m, k, s);
  else if (k <= 64) launch_w<64, 2>(v, h, w, q, out, lanes, n, m, k, s);
  else launch_w<128, 1>(v, h, w, q, out, lanes, n, m, k, s);
  return (int)cudaGetLastError();
}
