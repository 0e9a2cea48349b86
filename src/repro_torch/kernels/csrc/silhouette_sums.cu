// Streaming silhouette distance sums for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of repro/kernels/silhouette_sums.py
// (silhouette_dist_sums and silhouette_dist_sums_batched):
//   out[l, i, c] = sum_j sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)) * onehot[l, j, c]
// One C entry point with a leading lane axis serves both wrappers (2-D is
// b = 1). The (n, m) distance matrix never reaches device memory, as on
// the TPU. Masked points carry all-zero one-hot rows and contract to
// nothing. The clamp at 0 comes before the sqrt: near-duplicate pooled
// columns make |x|^2 + |y|^2 - 2 x.y a cancellation. Any k is taken: the
// contraction walks the clusters in chunks. Ragged n, m, d and k are
// masked in the kernels, not padded.
//
// What bounds it on an H100: NMFk's pooled-column score is tiny. At the
// main path's shapes (x = y: p * k_pad <= 128 pooled W columns of
// dimension d = 1000, 1..16 lanes) the inputs are a few hundred KB and the
// work a few MFLOP, so the bound (bytes over 3.35 TB/s against operations
// over 67 TFLOP/s: 0.08 us at 52 points, 1 us at 8 lanes of 64, both by
// operations) is far below a launch, and every launch is bound by its own
// latency: the chain of dependent loads and barriers from the first read
// to the last write. The design shortens that chain by spreading it.
//
// Thin path (m <= kThinMaxM points, every NMFk launch). A unit is one
// lane's tile of 16 x rows, or 32 where 16 would need more blocks than the
// card has SMs. Its d reduction is spread over the blocks of a thread block
// cluster (up to 8, one d-slice each; 32 blocks at 52 points and d 1000,
// 128 at 8 lanes of 64 points):
//   1. each block stages its d-slice of all m y rows (and of the unit's x
//      rows unless x is y) in shared memory with cp.async (16 bytes a copy
//      where d and the slice are multiples of 16 bytes and the operands
//      aligned, else 8 or 4 as they allow; everything past n, m or d
//      arrives as zeros), and the first chunk of the one-hot with it, so
//      every load of the block is in flight at once;
//   2. it computes the partial dots x_i.y_j and the norms |y_j|^2 (and
//      |x_i|^2 unless x is y) of its slice, each norm once per slice, with
//      reads of 4 elements from shared memory and fmaf in ascending d;
//   3. block r of C owns the x rows r, r + C, ...: every block writes its
//      partials for those rows into block r's shared memory (distributed
//      shared memory, map_shared_rank), then the cluster barrier; block r
//      adds the C partials in rank order 0..C-1, clamps and takes sqrt;
//   4. it contracts its distance rows against the one-hot in chunks of
//      kChunk clusters and writes its rows of out.
// No float atomics: every sum has one fixed order, so two calls are bitwise
// equal. With x = y, the diagonal is exactly zero (the norms and the dot of
// a point with itself are the same fmaf chain).
//
// General path (more points than the thin path takes: K-Means silhouette
// waves, large n): a block owns 32 x rows, walks y in tiles of 32 rows and
// d in steps of 32 through shared memory, and contracts each distance tile
// into its registers; one 128-cluster chunk per grid.z index.
//
// The bf16 half (silhouette_dist_sums_bf16: bf16 x, y and one-hot, fp32
// out, as the TPU kernel's) is both paths instantiated for bf16 operands,
// routed as the fp32 entry routes them. The thin path stages bf16 rows (a
// pitch of 136 elements: the 8-byte reads of 8 rows at one column hit 16
// distinct banks) and widens each element to fp32 as it reads it from shared
// memory, the one-hot as it stages it (plain loads, issued behind the rows'
// copies); the general path widens as it stages. From there the arithmetic
// is the fp32 path's, operation for operation, so on the card the bf16
// kernel gives the fp32 kernel's bits on the widened operands. CUDA cores,
// not tensor cores: the bound is far below a launch (above), and tensor-core
// products would change the bits and buy nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>
#include <atomic>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// Thin path
// ---------------------------------------------------------------------------
constexpr int kThinMaxM = 128;        // most y points the thin path takes (ops.SILHOUETTE_THIN_POINTS)
constexpr int kThinThreads = 256;     // 8 warps
constexpr int kMaxClusterBlocks = 8;  // blocks a cluster (the portable cluster size)
constexpr int kSliceTarget = 128;     // d a block of the cluster aims at: C = ceil(d / 128), at most 8
constexpr int kStep = 128;            // d staged at once
constexpr int kChunk = 32;            // clusters contracted at once
// staged row pitch in elements of `elem` bytes: rows of 16-byte multiples,
// and the 4-element reads of 8 rows at one column free of bank conflicts
// (fp32: float4 at 528-byte rows; bf16: 8 bytes at 272-byte rows)
__host__ __device__ constexpr int thin_pitch(int elem) { return elem == 4 ? kStep + 4 : kStep + 8; }
// y rows a thin launch stages (zeros past m): 32, 64 or 128, so that a
// lane's column count is a compile-time constant
constexpr int thin_rows_staged(int m) { return m <= 32 ? 32 : m <= 64 ? 64 : kThinMaxM; }

// dynamic shared memory of a thin launch (R x rows a unit, clusters of C,
// operands of `elem` bytes), in floats: staged y and x, receive buffers,
// one-hot chunk
constexpr int thin_staged_floats(int rows, int m, int elem) {
  return (thin_rows_staged(m) + rows) * thin_pitch(elem) * elem / 4;
}
constexpr int thin_smem_floats(int rows, int m, int c, int elem) {
  const int owned = (rows + c - 1) / c;
  return thin_staged_floats(rows, m, elem) + c * owned * m + c * owned + c * m + m * kChunk;
}
constexpr int thin_smem_max(int rows, int elem) {
  int most = 0;
  for (int c = 1; c <= kMaxClusterBlocks; ++c)
    most = thin_smem_floats(rows, kThinMaxM, c, elem) > most ? thin_smem_floats(rows, kThinMaxM, c, elem) : most;
  return most;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16, 8 or 4 bytes; with full == false nothing is read and the
// destination is zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp8(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Halves of a cluster barrier. Every block arrives at entry and waits just
// before it writes into the others' shared memory, so it never writes into
// a block that has not started; by then the wait costs nothing.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }

// Built with -DSIL_TIMELINE (tools/time_sums.py --timeline), thread 0 of
// every thin block stamps its SM clock at the phase boundaries (entry,
// first stage landed, partials done, partials pushed and cluster barrier
// passed, distances done, sums written) and the global timer at entry and
// exit, for the first kTimelineBlocks blocks; silhouette_timeline copies
// them out.
#ifdef SIL_TIMELINE
constexpr int kTimelineBlocks = 4096;
constexpr int kStamps = 8;
__device__ unsigned long long g_timeline[kTimelineBlocks][kStamps];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) \
  if (threadIdx.x == 0) stamps[i] = clock64()
#else
#define STAMP(i) ((void)0)
#endif

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four staged elements from shared memory, as fp32: one float4, or 8 bytes
// of bf16 each widened (a bf16 is the high half of its fp32).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// One copy of G elements (cp.async of G * sizeof(T) bytes; a bf16 G 1: a
// plain store) from src, or zeros where !ok (src then only has to be a
// valid, aligned address).
template <int G, typename T>
__device__ __forceinline__ void copy_g(T* at, const T* src, bool ok) {
  constexpr int kBytes = G * (int)sizeof(T);
  if constexpr (kBytes == 16) cp16(at, src, ok);
  else if constexpr (kBytes == 8) cp8(at, src, ok);
  else if constexpr (kBytes == 4) cp4(at, src, ok);
  else *at = ok ? *src : T(0.f);
}

// Stage columns [0, len4) of `rows` rows (row stride ld elements) into dst
// with row pitch thin_pitch: element (r, c) is src[r * ld + c] for r <
// valid and c < len, else 0, G elements a copy, which needs ld, len and src
// multiples of G and src and `safe` aligned to the copy. kLanes threads a
// row (a row of one or two warps' copies is one contiguous read), rows r0,
// r0 + R, ...; where kLanes copies cover a whole kStep (G 4 and 8), each
// thread has one column and leaves when it lies past len4.
template <int G, typename T>
__device__ __forceinline__ void stage_rows_g(T* dst, const T* src, const T* safe, int rows, int valid, int ld,
                                             int len, int len4) {
  constexpr int kPitchT = thin_pitch(sizeof(T));
  constexpr int kLanes = kStep / G < 32 ? kStep / G : 32, kRowsAtOnce = kThinThreads / kLanes;
  const int sub = threadIdx.x % kLanes, r0 = threadIdx.x / kLanes;
  if constexpr (kLanes * G == kStep) {
    const int c = sub * G;
    if (c >= len4) return;
    for (int r = r0; r < rows; r += kRowsAtOnce) {
      const bool ok = r < valid;  // len is a multiple of G here
      copy_g<G>(dst + r * kPitchT + c, ok ? src + (size_t)r * ld + c : safe, ok);
    }
  } else {
    for (int r = r0; r < rows; r += kRowsAtOnce)
      for (int c = sub * G; c < len4; c += kLanes * G) {
        const bool ok = r < valid && c < len;
        copy_g<G>(dst + r * kPitchT + c, ok ? src + (size_t)r * ld + c : safe, ok);
      }
  }
}

// stage_rows_g at the launch's granule g: fp32 4 or 1; bf16 8, 4, 2 or 1
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, const T* safe, int rows, int valid, int ld,
                                           int len, int len4, int g) {
  if constexpr (sizeof(T) == 4) {
    if (g == 4) stage_rows_g<4>(dst, src, safe, rows, valid, ld, len, len4);
    else stage_rows_g<1>(dst, src, safe, rows, valid, ld, len, len4);
  } else {
    if (g == 8) stage_rows_g<8>(dst, src, safe, rows, valid, ld, len, len4);
    else if (g == 4) stage_rows_g<4>(dst, src, safe, rows, valid, ld, len, len4);
    else if (g == 2) stage_rows_g<2>(dst, src, safe, rows, valid, ld, len, len4);
    else stage_rows_g<1>(dst, src, safe, rows, valid, ld, len, len4);
  }
}

// Stage one-hot columns [c0, c0 + kc) of the m points as fp32 (m, kChunk):
// fp32 by cp.async, bf16 by plain loads widened as they are stored.
template <typename T>
__device__ __forceinline__ void stage_onehot(float* oh, const T* onehot, int m, int k, int c0, int kc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane >= kc) return;
  if constexpr (sizeof(T) == 4) {
    for (int j = warp; j < m; j += kThinThreads / 32) cp4(oh + j * kChunk + lane, onehot + (size_t)j * k + c0 + lane, true);
  } else {  // plain loads, four in flight at once
#pragma unroll 4
    for (int j = warp; j < m; j += kThinThreads / 32) oh[j * kChunk + lane] = widen(onehot[(size_t)j * k + c0 + lane]);
  }
}

// grid (C, ceil(n / kThinRows), b), cluster (C, 1, 1); block rank r takes
// d in [r * slice, min(d, (r + 1) * slice)) and owns the unit's rows r,
// r + C, ... kThinRows is 16, or 32 where 16 would put more blocks on the
// card than it has SMs (32 halves the y reads and raises the FMAs per
// shared-memory read; 16 halves the chain of a block where the card has
// room).
//
// Partial tile: warp w takes the 8-row block w % RB (RB = kThinRows / 8)
// and the column block w / RB (of 8 / RB); lane (lr, lc) = (lane / 8,
// lane % 8) takes rows lr and lr + 4 of its row block and the kCols
// columns lc, lc + 8, ... of its column block. A warp's float4 read of x
// then touches 4 rows and of y 8 rows: one wavefront each, broadcast to
// the lanes. kCols is a template constant (y is staged at 32, 64 or 128
// rows): with a runtime bound on the column loop the compiler branches
// around each column's loads and FMAs, which then run one after another.
// T: float, or __nv_bfloat16 (staged as it lies, widened as it is read);
// g: the staging granule (stage_rows).
template <typename T, int kThinRows, int kCols>
__global__ void __launch_bounds__(kThinThreads)
dist_sums_thin(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ onehot,
               float* __restrict__ out, int n, int m, int d, int k, int slice, int g, bool same) {
  constexpr int kRowBlocks = kThinRows / 8, kColBlocks = 8 / kRowBlocks;
  constexpr int mr = kCols * 8 * kColBlocks;  // y rows staged (zeros past m)
  constexpr int kPitch = thin_pitch(sizeof(T));
  constexpr bool kWide = sizeof(T) == 4;  // fp32: the one-hot by cp.async with the rows
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.y * kThinRows;
  const size_t lane = blockIdx.z;
  x += lane * n * d;
  y += lane * m * d;
  onehot += lane * m * k;
  out += lane * n * k;

  const int owned_max = (kThinRows + blocks - 1) / blocks;  // rows a rank owns, at most
  T* ys = reinterpret_cast<T*>(smem);             // (mr, kPitch)
  T* xs = ys + mr * kPitch;                        // (kThinRows, kPitch)
  float* rdot = smem + (mr + kThinRows) * kPitch * (int)sizeof(T) / 4;  // (C, owned_max, m) partial dots, pushed by rank
  float* rxn = rdot + blocks * owned_max * m;      // (C, owned_max) partial |x_i|^2, pushed by rank
  float* ryn = rxn + blocks * owned_max;           // (C, m) partial |y_j|^2, pushed by rank
  float* oh = ryn + blocks * m;                    // (m, kChunk) one-hot chunk
  float* dist = smem;                              // (rows owned, m) distances, once ys is dead

#ifdef SIL_TIMELINE
  unsigned long long stamps[kStamps - 2] = {}, start_ns = threadIdx.x == 0 ? global_ns() : 0;
#endif
  STAMP(0);
  cluster_arrive();
  if constexpr (kWide) stage_onehot(oh, onehot, m, k, 0, min(kChunk, k));

  const int rows = min(kThinRows, n - i0);
  const int d_begin = min(d, rank * slice), d_end = min(d, d_begin + slice);
  const int rb = warp % kRowBlocks, cb = warp / kRowBlocks, lr = lane_id >> 3, lc = lane_id & 7;
  const int row0 = rb * 8 + lr;                    // rows row0 and row0 + 4 of the unit
  const int col0 = cb * kCols * 8 + lc;            // columns col0 + 8 v, v < kCols
  // x = y (NMFk's case): the unit's x rows are rows i0 .. of the staged y
  // (i0 < m, and i0 and mr are multiples of kThinRows, so i0 + kThinRows <=
  // mr), so x is not staged again and its norms are the y norms.
  const T* xt = same ? ys + i0 * kPitch : xs;
  float acc[2][kCols] = {}, xn[2] = {}, yn[kCols] = {};
  for (int d0 = d_begin; d0 < d_end; d0 += kStep) {
    const int len = min(kStep, d_end - d0), len4 = (len + 3) & ~3;
    stage_rows(ys, y + d0, y, mr, m, d, len, len4, g);
    if (!same) stage_rows(xs, x + (size_t)i0 * d + d0, x, kThinRows, rows, d, len, len4, g);
    if constexpr (!kWide)  // bf16: the one-hot's plain loads behind the first rows' copies (no slice is empty)
      if (d0 == d_begin) stage_onehot(oh, onehot, m, k, 0, min(kChunk, k));
    cp_wait_all();
    __syncthreads();
    if (d0 == d_begin) STAMP(1);
#pragma unroll 4
    for (int e = 0; e < len4; e += 4) {
      float4 a[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        a[u] = load4(xt + (row0 + 4 * u) * kPitch + e);
        if (!same) xn[u] = dot4(a[u], a[u], xn[u]);  // with x = y, |x_i|^2 is |y_i|^2
      }
#pragma unroll
      for (int v = 0; v < kCols; ++v) {
        const float4 b = load4(ys + (col0 + 8 * v) * kPitch + e);
        if (rb == 0) yn[v] = dot4(b, b, yn[v]);  // the first row block's warps sum the y norms
#pragma unroll
        for (int u = 0; u < 2; ++u) acc[u][v] = dot4(a[u], b, acc[u][v]);
      }
    }
    __syncthreads();
  }
  STAMP(2);

  // Push the partials to the rank that owns each row (row r: rank r % C,
  // slot r / C), into this rank's part of its receive buffers; every rank
  // gets the y norms.
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = row0 + 4 * u, q = r % blocks, t = r / blocks;
    float* dst = cluster.map_shared_rank(rdot, q) + (rank * owned_max + t) * m;
#pragma unroll
    for (int v = 0; v < kCols; ++v) {
      const int j = col0 + 8 * v;
      if (j < m) dst[j] = acc[u][v];
    }
    if (!same && lc == 0) cluster.map_shared_rank(rxn, q)[rank * owned_max + t] = xn[u];
  }
  if (rb == 0 && lr == 0) {
    for (int q = 0; q < blocks; ++q) {
      float* dst = cluster.map_shared_rank(ryn, q) + rank * m;
#pragma unroll
      for (int v = 0; v < kCols; ++v) {
        const int j = col0 + 8 * v;
        if (j < m) dst[j] = yn[v];
      }
    }
  }
  cp_wait_all();   // the one-hot chunk, also where this block's slice is empty
  cluster.sync();  // every rank's partials (and a bf16 one-hot's plain stores) are in shared memory
  STAMP(3);

  // This rank's rows rank + C t: add the C partials in rank order.
  const int owned = (kThinRows - rank + blocks - 1) / blocks;
  const int j = tid & (kThinMaxM - 1);
  for (int t = tid / kThinMaxM; t < owned; t += kThinThreads / kThinMaxM) {
    if (j >= m) continue;
    const int r = rank + blocks * t;
    float dot = 0.f, xx = 0.f, yy = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxClusterBlocks; ++q) {
      if (q < blocks) {
        dot += rdot[(q * owned_max + t) * m + j];
        xx += same ? (i0 + r < m ? ryn[q * m + i0 + r] : 0.f) : rxn[q * owned_max + t];
        yy += ryn[q * m + j];
      }
    }
    dist[t * m + j] = sqrtf(fmaxf(xx + yy - 2.f * dot, 0.f));
  }
  __syncthreads();  // dist is complete
  STAMP(4);

  for (int c0 = 0; c0 < k; c0 += kChunk) {
    const int kc = min(kChunk, k - c0);
    if (c0 > 0) {
      __syncthreads();  // every thread is done with the previous chunk
      stage_onehot(oh, onehot, m, k, c0, kc);
      cp_wait_all();
      __syncthreads();
    }
    for (int e = tid; e < owned * kChunk; e += kThinThreads) {
      const int t = e / kChunk, c = e % kChunk;  // kChunk is a power of two: shifts
      const int i = i0 + rank + blocks * t;
      if (c >= kc || i >= n) continue;
      const float* dr = dist + t * m;
      float s = 0.f;
#pragma unroll 8
      for (int jj = 0; jj < m; ++jj) s = fmaf(dr[jj], oh[jj * kChunk + c], s);
      out[(size_t)i * k + c0 + c] = s;
    }
  }
  STAMP(5);
#ifdef SIL_TIMELINE
  const unsigned blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x == 0 && blk < kTimelineBlocks) {
    for (int i = 0; i < kStamps - 2; ++i) g_timeline[blk][i] = stamps[i];
    g_timeline[blk][kStamps - 2] = start_ns;
    g_timeline[blk][kStamps - 1] = global_ns();
  }
#endif
}

// ---------------------------------------------------------------------------
// General path
// ---------------------------------------------------------------------------
constexpr int kTileX = 32;                               // x rows per block
constexpr int kTileY = 32;                               // y rows per step
constexpr int kStepD = 32;                               // feature step per shared tile
constexpr int kRows = 8;                                 // blockDim.y
constexpr int kThreads = kTileX * kRows;                 // 256
constexpr int kRowsPerThread = kTileX / kRows;           // 4 x rows per thread
constexpr int kClusterChunk = 128;                       // clusters per block (grid.z walks the chunks)
constexpr int kColsPerThread = kClusterChunk / kTileY;   // 4 clusters per thread

// grid (ceil(n / kTileX), b, ceil(k / kClusterChunk)), block (32, kRows). In
// the distance phase thread (tx, ty) owns y row j0 + tx and x rows
// ty + kRows * r; in the contraction phase it owns clusters c0 + tx + 32 * q
// of the same x rows. T: float, or __nv_bfloat16 (widened as it is staged).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dist_sums_general(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ onehot,
                  float* __restrict__ out, int n, int m, int d, int k) {
  __shared__ float xs[kTileX][kStepD + 1];
  __shared__ float ys[kTileY][kStepD + 1];
  __shared__ float ds[kTileX][kTileY + 1];
  __shared__ float gs[kTileY][kClusterChunk];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.x * kTileX;
  const size_t lane = blockIdx.y;
  const int c0 = blockIdx.z * kClusterChunk, kc = min(kClusterChunk, k - c0);
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
      const int gd = d0 + tx;  // thread (tx, ty) loads column tx of rows ty, ty + kRows, ...
#pragma unroll
      for (int rr = ty; rr < kTileX; rr += kRows) {
        const int gi = i0 + rr, gj = j0 + rr;
        xs[rr][tx] = (gi < n && gd < d) ? widen(x[(size_t)gi * d + gd]) : 0.f;
        ys[rr][tx] = (gj < m && gd < d) ? widen(y[(size_t)gj * d + gd]) : 0.f;
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
    for (int rr = ty; rr < kTileY; rr += kRows) {
      const int gj = j0 + rr;
      for (int cc = tx; cc < kClusterChunk; cc += kTileY)
        gs[rr][cc] = (gj < m && cc < kc) ? widen(onehot[(size_t)gj * k + c0 + cc]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kTileY; ++jj) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float dv = ds[ty + kRows * r][jj];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) oacc[r][c] += dv * gs[jj][tx + kTileY * c];
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
      if (cl < kc) out[(size_t)i * k + c0 + cl] = oacc[r][c];
    }
  }
}

// SMs of the current device, asked once per device.
int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  int sms = cached[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1) sms = 132;
    cached[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

// The staging granule of a thin launch (stage_rows): the widest copy that
// d, the slice and both bases allow, 16 bytes down to 4 (bf16: then plain
// 2-byte stores).
template <typename T>
int thin_granule(const T* x, const T* y, int d, int slice) {
  const size_t bases = reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(y);
  if constexpr (sizeof(T) == 4) return d % 4 == 0 && bases % 16 == 0 ? 4 : 1;
  if (d % 8 == 0 && slice % 8 == 0 && bases % 16 == 0) return 8;
  if (d % 4 == 0 && bases % 8 == 0) return 4;  // the slice is a multiple of 4
  return d % 2 == 0 && bases % 4 == 0 ? 2 : 1;
}

template <typename T, int kThinRows, int kCols>
int launch_thin(const T* x, const T* y, const T* onehot, float* out, int b, int n, int m, int d,
                int k, int blocks, cudaStream_t stream) {
  static const cudaError_t attr =  // once per process (thread-safe static init)
      cudaFuncSetAttribute(dist_sums_thin<T, kThinRows, kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           4 * thin_smem_max(kThinRows, sizeof(T)));
  if (attr != cudaSuccess) return (int)attr;
  const int slice = (((d + blocks - 1) / blocks) + 3) & ~3;
  const int g = thin_granule(x, y, d, slice);
  const bool same = x == y && n == m;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, (n + kThinRows - 1) / kThinRows, b);
  cfg.blockDim = dim3(kThinThreads);
  cfg.dynamicSmemBytes = 4 * (size_t)thin_smem_floats(kThinRows, m, blocks, sizeof(T));
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = blocks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, dist_sums_thin<T, kThinRows, kCols>, x, y, onehot, out, n, m, d, k, slice, g, same);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// The thin launch for m <= kThinMaxM: 16 x rows a unit, or 32 where 16
// would need more blocks than the card has SMs; the lanes' column count
// from the y rows staged. Both dtypes alike, so a bf16 launch adds in the
// fp32 launch's order.
template <typename T>
int launch_thin_any(const T* x, const T* y, const T* onehot, float* out, int b, int n, int m, int d,
                    int k, cudaStream_t s) {
  const int blocks = std::min((d + kSliceTarget - 1) / kSliceTarget, kMaxClusterBlocks);  // the cluster
  const int staged = thin_rows_staged(m);
  if ((long long)blocks * ((n + 15) / 16) * b <= sm_count()) {  // 4 column blocks of staged / 4 columns
    if (staged == 32) return launch_thin<T, 16, 1>(x, y, onehot, out, b, n, m, d, k, blocks, s);
    if (staged == 64) return launch_thin<T, 16, 2>(x, y, onehot, out, b, n, m, d, k, blocks, s);
    return launch_thin<T, 16, 4>(x, y, onehot, out, b, n, m, d, k, blocks, s);
  }
  if (staged == 32) return launch_thin<T, 32, 2>(x, y, onehot, out, b, n, m, d, k, blocks, s);  // 2 column blocks
  if (staged == 64) return launch_thin<T, 32, 4>(x, y, onehot, out, b, n, m, d, k, blocks, s);
  return launch_thin<T, 32, 8>(x, y, onehot, out, b, n, m, d, k, blocks, s);
}

template <typename T>
int launch_general(const T* x, const T* y, const T* onehot, float* out, int b, int n, int m, int d, int k,
                   cudaStream_t s) {
  const long long chunks = ((long long)k + kClusterChunk - 1) / kClusterChunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileX - 1) / kTileX, b, (unsigned)chunks), block(kTileY, kRows);
  dist_sums_general<T><<<grid, block, 0, s>>>(x, y, onehot, out, n, m, d, k);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef SIL_TIMELINE
// The stamps of the last thin launch: `blocks` rows of kStamps (6 SM clocks,
// then the global timer in ns at entry and exit) into host memory.
extern "C" int silhouette_timeline(unsigned long long* host, int blocks) {
  if (blocks < 1 || blocks > kTimelineBlocks) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, g_timeline, sizeof(unsigned long long) * kStamps * blocks);
}
#endif

// C interface, loaded with ctypes. Device pointers of contiguous fp32
// tensors: x (b, n, d), y (b, m, d) (may alias x), onehot (b, m, k), out
// (b, n, k); any k >= 1. m <= kThinMaxM takes the thin path (cluster
// launch), larger m the general one. Launches on `stream`; returns a
// cudaError_t (0 on success).
extern "C" int silhouette_dist_sums(const float* x, const float* y, const float* onehot,
                                    float* out, int b, int n, int m, int d, int k,
                                    void* stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || d < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (m <= kThinMaxM && (n + 15) / 16 <= 65535) return launch_thin_any<float>(x, y, onehot, out, b, n, m, d, k, s);
  return launch_general<float>(x, y, onehot, out, b, n, m, d, k, s);
}

// The bf16 half: bf16 x (b, n, d), y (b, m, d) (may alias x) and onehot (b,
// m, k), fp32 out (b, n, k); any m and k, routed as silhouette_dist_sums
// routes them (thin path at m <= kThinMaxM). On the card its sums are the
// fp32 entry's bits on the widened operands.
extern "C" int silhouette_dist_sums_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                                         const __nv_bfloat16* onehot, float* out, int b, int n, int m, int d, int k,
                                         void* stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || d < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (m <= kThinMaxM && (n + 15) / 16 <= 65535)
    return launch_thin_any<__nv_bfloat16>(x, y, onehot, out, b, n, m, d, k, s);
  return launch_general<__nv_bfloat16>(x, y, onehot, out, b, n, m, d, k, s);
}
