// Lee-Seung multiplicative-update kernels for Hopper (sm_90a), fp32 on CUDA cores.
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
// would overtake HBM (3.35 TB/s). So the design is about keeping V in
// flight on every SM and ending all SMs together, not about tensor cores:
//
// - One persistent block per SM walks a list of work items (see "Work
//   items" below). Its copy warps fill a ring of up to six shared-memory
//   stages ahead of its eight math warps, with a "full" and an "empty"
//   mbarrier per slot and no block-wide barrier per stage, so V keeps
//   streaming while the math warps reduce and store a finished item. Where
//   the operands allow it (rows a multiple of 16 bytes, aligned), one thread
//   issues each stage as 3-D tensor-memory-accelerator boxes; otherwise the
//   copy threads stage it with cp.async, 16 or 4 bytes at a time. Built
//   with -DMU_NO_TMA, every stage takes the cp.async path (tools/time_mu.py
//   --no-tma times the two paths against each other).
// - Math threads read V and W (or H) from shared memory as float4 and keep
//   a register tile of accumulators, so one shared load feeds 16-32 FMAs.
// - A unit (one output tile of one lane) is reduced by one block, or, for
//   the units left over after whole rounds of the blocks, split across
//   blocks: each writes its partial sums to scratch and bumps the unit's
//   int32 arrival counter; the block that arrives last adds the S partials
//   in index order 0..S-1, applies the epilogue and sets the counter back
//   to zero, so the counters, zeroed once when the wrapper allocates them,
//   are zero before every launch. Data is never added with atomics, so the
//   output is bitwise equal from call to call. The wrapper plans the cut
//   (ops._mu_plan); at L=32, n=1000, m=1100, k=16 the H-update splits 24 of
//   its 288 units five ways (1.2 MB of partials written and read back,
//   mostly in L2, against V's 141 MB) and the W-update splits none; at L=4
//   every unit is split (2.0 and 1.0 MB against 17.6 MB).
// - Inside a block the reduction is split over row (H) or column (W)
//   slices of each stage; the slices' sums are added in a fixed order
//   through shared memory. The divide-multiply epilogue runs on the reduced
//   sums, so the (k, m) / (n, k) numerator never reaches device memory
//   except as the partials of a split unit.
//
// Ragged n, m and k are masked in the kernel (rows and columns out of range
// arrive as zeros), so no padded copy of V is made. Components masked to
// zero (W columns / H rows) stay exactly zero: 0 * acc / (x + 1e-9) = 0.
// fp32 FMA only: no TF32, no wgmma.
//
// The bf16 half forms out = X * num / (den + 1e-9) in fp32 from bf16 V, W,
// H and the bf16 G / Q product and rounds it once (__float2bfloat16_rn), as
// the TPU kernel's bf16 half does. The H-update up to rank 128
// (mu_update_h_bf16) is the tiled, planned design with bf16 stages and
// W^T V on the bf16 tensor cores (HUpdateBf16, at the end); above rank 128
// (mu_update_h_bf16_any), and the W-update at every rank
// (mu_update_w_bf16_any), it is the any-rank kernel below instantiated for
// bf16 operands, widened as loaded, both products by fmaf.

#include <cuda.h>  // CUtensorMap (the encoder is fetched from the driver at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kTiledMaxRank = 128;  // largest k the tiled kernels take; above it, mu_update_*_any
constexpr float kEps = 1e-9f;
constexpr int kMath = 256;              // 8 math warps
constexpr int kCopy = 128;              // 4 copy warps
constexpr int kThreads = kMath + kCopy;
constexpr int kMaxStages = 6;           // deepest ring
constexpr int kSmemFloats = 226 * 256;  // 226 KB of the 227 a block may hold; 1 KB aligns the ring

// Ring slots that fit beside the parking space for a block's sums.
constexpr int ring_stages(int stage_floats, int park_floats) {
  const int fit = (kSmemFloats - park_floats) / stage_floats;
  return fit < kMaxStages ? fit : kMaxStages;
}

// ---------------------------------------------------------------------------
// Asynchronous copies (cp.async) and shared-memory barriers (mbarrier). A
// copy whose source is out of range has source size 0: the 16 (or 4) bytes
// in shared memory are zero-filled and nothing is read.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Arrive on the barrier once every cp.async this thread has issued so far
// has landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Announce `bytes` of tensor copies on the barrier and arrive once.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory by the tensor memory accelerator; out-of-range elements arrive as
// zeros, and the barrier counts the box's bytes when they have landed.
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// A barrier of the math warps only: the copy warps never wait for them.
__device__ __forceinline__ void math_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kMath) : "memory"); }

// Copy thread `lane` (of kCopy) stages its share of a ROWS x COLS tile of a
// row-major matrix (row stride ld floats) into shared memory with row pitch
// PITCH: rows r < vr and columns c < vc from src, everything else zero.
// `vec`: 16-byte copies, which needs src, ld and vc to be multiples of 4
// floats (and `safe` 16-byte aligned); `safe` is an in-range address handed
// to the zero-filling copies.
template <int ROWS, int COLS, int PITCH>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, const float* safe, int ld,
                                           int vr, int vc, bool vec, int lane) {
  if (vec) {
    constexpr int kC4 = COLS / 4;
#pragma unroll 4
    for (int e = lane; e < ROWS * kC4; e += kCopy) {
      const int r = e / kC4, c = (e % kC4) * 4;
      const bool ok = r < vr && c < vc;
      cp_async16(dst + r * PITCH + c, ok ? src + (size_t)r * ld + c : safe, ok);
    }
  } else {
#pragma unroll 4
    for (int e = lane; e < ROWS * COLS; e += kCopy) {
      const int r = e / COLS, c = e % COLS;
      const bool ok = r < vr && c < vc;
      cp_async4(dst + r * PITCH + c, ok ? src + (size_t)r * ld + c : safe, ok);
    }
  }
}

// Arrival of one split block at its tile's counter, after all its math
// threads stored their partials. Thread 0 adds 1 with release-acquire
// semantics at device scope: the barrier before it orders the block's
// stores before the release, and the barrier after it orders the acquire
// before every read of the other blocks' partials (through L2: __ldcg).
// True in the block that arrived last, which resets the counter and owns
// the epilogue.
__device__ bool arrive_last(int* counter, int split) {
  __shared__ int last;
  math_sync();
  if (threadIdx.x == 0) {
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(before) : "l"(counter) : "memory");
    last = before == split - 1;
    if (last) *counter = 0;
  }
  math_sync();
  return last;
}

// num[i] = sum over s = 0 .. split-1, in that order, of p[s * stride + off[i]]:
// the loads of kGroup splits are in flight together.
template <int N>
__device__ __forceinline__ void sum_partials(float (&num)[N], const float* p, const int (&off)[N],
                                             const bool (&live)[N], int split, size_t stride) {
  constexpr int kGroup = N >= 32 ? 1 : 32 / N < 8 ? 32 / N : 8;
#pragma unroll
  for (int i = 0; i < N; ++i) num[i] = 0.f;
  for (int s0 = 0; s0 < split; s0 += kGroup) {
    float x[kGroup][N];
#pragma unroll
    for (int d = 0; d < kGroup; ++d)
#pragma unroll
      for (int i = 0; i < N; ++i)
        x[d][i] = (live[i] && s0 + d < split) ? __ldcg(p + (s0 + d) * stride + off[i]) : 0.f;
#pragma unroll
    for (int d = 0; d < kGroup; ++d)
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (s0 + d < split) num[i] = (s0 + d == 0) ? x[d][i] : num[i] + x[d][i];
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float s, const float4& x) {
  acc[0] = fmaf(s, x.x, acc[0]);
  acc[1] = fmaf(s, x.y, acc[1]);
  acc[2] = fmaf(s, x.z, acc[2]);
  acc[3] = fmaf(s, x.w, acc[3]);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ---------------------------------------------------------------------------
// Work items and the persistent walk.
// A unit is one output tile of one lane (tile fastest, so the blocks at work
// at one moment read whole rows of V together). The first `whole` units are
// items of their own: their reduction runs in one block, which stores the
// update itself. Each of the other units (the tail) is cut into `split`
// items of `chunk` rows or columns (whole stages), whose blocks meet at the
// unit's arrival counter; with split == 1 they too are whole. The grid is persistent: block b takes
// items b, b + G, b + 2G, ... (G = gridDim.x) and walks the stages of all of
// them as one stream. Its copy warps run up to a ring's depth ahead of the
// math warps (one "full" and one "empty" barrier per ring slot), also while
// they reduce and store a finished item.
// ---------------------------------------------------------------------------
struct Walk {
  int tiles, units, whole, split, chunk, len, step;

  __device__ __forceinline__ int items() const { return whole + (units - whole) * split; }
};

struct Cursor {
  int item, tile, s, t, stages;
  int s_begin;  // first row (H) or column (W) of the item's reduction
  int tail;     // a piece's unit among the tail units: its partials' and counter's index
  size_t lane;
  bool piece;  // one of `split` items of a tail unit

  __device__ __forceinline__ void at(int it, const Walk& wk) {
    item = it;
    t = 0;
    int unit, begin = 0, size = wk.len;
    if (it < wk.whole) {
      unit = it;
      s = tail = 0;
      piece = false;
    } else {
      const int j = it - wk.whole, tail = max(wk.units - wk.whole, 1);  // 0 only past the last item
      this->tail = j % tail;
      unit = wk.whole + this->tail;
      s = j / tail;
      begin = s * wk.chunk;
      size = min(wk.len, begin + wk.chunk) - begin;
      piece = wk.split > 1;
    }
    tile = unit % wk.tiles;
    lane = (size_t)(unit / wk.tiles);
    stages = (size + wk.step - 1) / wk.step;
    s_begin = begin;
  }
  // Next stage; true when it starts the next item (the last one is done).
  __device__ __forceinline__ bool next(const Walk& wk) {
    if (++t < stages) return false;
    at(item + gridDim.x, wk);
    return true;
  }
};

// The block's walk: the copy warps fill ring slots, the math warps consume
// them in the same order and finish each item after its last stage. `Op`
// supplies the shapes and issue / compute / finish. Without tensor maps a
// copy thread arrives once its cp.async copies have landed and, where the
// Op also stages with plain stores (kPlainStores), once more right after
// them (an arrive releases them; one that cp.async triggers need not).
template <class Op>
__device__ __forceinline__ void walk(Op& op, float* ring, uint64_t* full, uint64_t* empty) {
  Cursor c;
  c.at(blockIdx.x, op.wk);
  const int items = op.wk.items();
  if (threadIdx.x >= kMath) {  // the copy warps: one thread with tensor maps, else all of them
    const int lane = threadIdx.x - kMath;
    if (op.tma && lane != 0) return;
    for (int g = 0; c.item < items; ++g) {
      const int slot = g % Op::kStages;
      if (g >= Op::kStages) mbar_wait(&empty[slot], (g / Op::kStages - 1) & 1);
      if (op.tma) {
        mbar_expect(&full[slot], Op::kTmaBytes);
        op.issue_tma(c, ring + slot * Op::kStage, &full[slot]);
      } else {
        op.issue(c, ring + slot * Op::kStage, lane);
        if constexpr (Op::kPlainStores) mbar_arrive(&full[slot]);  // releases this thread's plain stores
        mbar_arrive_on_copies(&full[slot]);
      }
      c.next(op.wk);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  for (int g = 0; c.item < items; ++g) {
    const int slot = g % Op::kStages;
    mbar_wait(&full[slot], (g / Op::kStages) & 1);
    op.compute(ring + slot * Op::kStage);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot]);
    const Cursor it = c;  // the item this stage belongs to
    if (c.next(op.wk)) op.finish(it);
  }
}

template <class Op>
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, bool tma) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < Op::kStages; ++i) {
      // the tensor-map thread, or every copy thread (once more where it also stores)
      mbar_init(&full[i], tma ? 1 : kCopy * (Op::kPlainStores ? 2 : 1));
      mbar_init(&empty[i], kMath / 32);  // every math warp, when it is done with the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The ring starts on a 1 KB boundary (swizzled tensor boxes need it); the
// launch asks for 1 KB more than the layout.
__device__ __forceinline__ float* align_1k(float* p) {
  const unsigned pad = (1024u - (smem_u32(p) & 1023u)) & 1023u;
  return p + pad / 4;
}

// ---------------------------------------------------------------------------
// H-update. Units: tiles of kHCols columns of H, per lane; the reduction
// runs over n. A stage is kHRows rows of V (kHRows x 128) and the same rows
// of W (kHRows x KB). Math thread (tx, tr, sl) owns 16 ranks tr*16 .. +15 x
// 4 columns 4 tx .. +3 (64 accumulators) and the rows sl, sl + SL, ... of
// each stage: per row one float4 of V and four broadcast float4s of W feed
// 64 FMAs.
// ---------------------------------------------------------------------------
constexpr int kHCols = 128;  // columns per tile (ops.MU_H_COLS)
constexpr int kHRows = 32;   // rows of V per stage (ops.MU_H_STAGE)

template <int KB>
struct HUpdate {
  static constexpr int kTR = KB / 16;  // rank groups of 16
  static constexpr int kSL = 8 / kTR;  // row slices
  static constexpr int kVFloats = kHRows * kHCols;
  static constexpr int kStage = kVFloats + kHRows * KB;
  static constexpr int kPark = kMath * 64;  // every math thread's 64 sums
  static constexpr int kStages = ring_stages(kStage, kPark);
  static constexpr int kSmemBytes = 4 * (kStages * kStage + kPark) + 1024;
  static constexpr int kPer = KB * kHCols / kMath;  // elements a math thread finishes: tid + kMath * i
  static constexpr int kTmaBytes = 4 * kStage;       // a stage's two boxes
  static constexpr bool kPlainStores = false;

  const float *v, *w, *h, *g;
  float *out, *part;
  int* count;
  int lanes, n, m, k;
  Walk wk;
  bool vec_v, vec_w, tma;
  const CUtensorMap *map_v, *map_w;  // V as (m, n, L), box (128, 32); W as (k, n, L), box (KB, 32)
  float* park;  // (SL, KB, kHCols)
  float acc[16][4];

  __device__ __forceinline__ void issue_tma(const Cursor& c, float* st, uint64_t* bar) const {
    const int r0 = c.s_begin + c.t * kHRows;  // splits are whole stages: a box never crosses one
    tma_box(st, map_v, c.tile * kHCols, r0, (int)c.lane, bar);
    tma_box(st + kVFloats, map_w, 0, r0, (int)c.lane, bar);
  }

  __device__ __forceinline__ void issue(const Cursor& c, float* st, int lane) const {
    const int i_end = c.piece ? min(n, c.s_begin + wk.chunk) : n;
    const int r0 = c.s_begin + c.t * kHRows, vr = min(kHRows, i_end - r0);
    const int j0 = c.tile * kHCols;
    const float* vl = v + c.lane * n * m;
    const float* wl = w + c.lane * n * k;
    stage_tile<kHRows, kHCols, kHCols>(st, vl + (size_t)r0 * m + j0, vl, m, vr, min(kHCols, m - j0), vec_v, lane);
    stage_tile<kHRows, KB, KB>(st + kVFloats, wl + (size_t)r0 * k, wl, k, vr, k, vec_w, lane);
  }

  __device__ __forceinline__ void compute(const float* vs) {
    const int tid = threadIdx.x, tx = tid & 31, tr = (tid >> 5) % kTR, sl = tid / (32 * kTR);
    const float* ws = vs + kVFloats;
#pragma unroll
    for (int q = 0; q < kHRows / kSL; ++q) {
      const int rr = sl + q * kSL;
      const float4 x = *reinterpret_cast<const float4*>(vs + rr * kHCols + 4 * tx);
      const float4* wr = reinterpret_cast<const float4*>(ws + rr * KB + 16 * tr);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 y = wr[p];
        fma4(acc[4 * p + 0], y.x, x);
        fma4(acc[4 * p + 1], y.y, x);
        fma4(acc[4 * p + 2], y.z, x);
        fma4(acc[4 * p + 3], y.w, x);
      }
    }
  }

  // The item's last stage is done. The epilogue's operands (the H tile and
  // G) are requested first, so their latency hides behind the sums: each
  // math thread parks its 64 sums in its slice's (KB, kHCols) block and
  // zeroes them, and each element is added over the slices in the fixed
  // order 0 .. SL-1.
  __device__ __forceinline__ void finish(const Cursor& it) {
    const int tid = threadIdx.x, tx = tid & 31, tr = (tid >> 5) % kTR, sl = tid / (32 * kTR);
    const int j0 = it.tile * kHCols, cols = min(kHCols, m - j0);
    const float* hl = h + it.lane * k * m + j0;
    const float* gl = g + it.lane * k * k;
    int off[kPer];  // element tid + kMath * i: rank r, column cl -> r * m + cl
    bool live[kPer];
    float hv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kMath * i, r = e / kHCols, cl = e % kHCols;
      off[i] = r * m + cl;
      live[i] = r < k && cl < cols;
      hv[i] = live[i] ? __ldg(hl + off[i]) : 0.f;
    }
    constexpr bool kGInSmem = KB <= 64;  // G beside the H tile in the parking space
    constexpr int kGPer = (KB * KB + kMath - 1) / kMath;
    float gv[kGInSmem ? kGPer : 1];
    if constexpr (kGInSmem) {
#pragma unroll
      for (int i = 0; i < kGPer; ++i) {
        const int e = tid + kMath * i, r = e / KB, q = e % KB;
        gv[i] = (e < KB * KB && r < k && q < k) ? __ldg(gl + r * k + q) : 0.f;
      }
    }
    math_sync();  // the previous item's epilogue has read H and G out of the parking space
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      *reinterpret_cast<float4*>(park + (sl * KB + 16 * tr + r) * kHCols + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    math_sync();
    float num[kPer];  // W^T V of element tid + kMath * i, over this item
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kMath * i;
      float a = park[e];
#pragma unroll
      for (int q = 1; q < kSL; ++q) a += park[q * KB * kHCols + e];
      num[i] = a;
    }
    if (it.piece) {
      // partials (S, tail units, k, kHCols): store this split's; the last
      // block to arrive at the unit adds all S in index order and stores
      // the update. Element tid + kMath * i sits at that offset of its tile.
      const int tail = wk.units - wk.whole, tile_floats = k * kHCols;
      int poff[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) poff[i] = tid + kMath * i;
      float* mine = part + ((size_t)it.s * tail + it.tail) * tile_floats;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (live[i]) mine[poff[i]] = num[i];
      if (!arrive_last(count + it.tail, wk.split)) return;
      sum_partials(num, part + (size_t)it.tail * tile_floats, poff, live, wk.split, (size_t)tail * tile_floats);
    }
    float* hs = park;                 // (KB, kHCols) H tile
    float* gs = park + KB * kHCols;   // (KB, KB) G, when it fits
    math_sync();  // every math thread has read its sums out of the parking space
#pragma unroll
    for (int i = 0; i < kPer; ++i) hs[tid + kMath * i] = hv[i];
    if constexpr (kGInSmem) {
#pragma unroll
      for (int i = 0; i < kGPer; ++i)
        if (tid + kMath * i < KB * KB) gs[tid + kMath * i] = gv[i];
    }
    math_sync();
    float* ol = out + it.lane * k * m + j0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!live[i]) continue;
      const int e = tid + kMath * i, r = e / kHCols, cl = e % kHCols;
      float gh = 0.f;
#pragma unroll 16
      for (int q = 0; q < k; ++q)
        gh += (kGInSmem ? gs[r * KB + q] : __ldg(gl + r * k + q)) * hs[q * kHCols + cl];
      ol[off[i]] = hv[i] * num[i] / (gh + kEps);
    }
  }
};

// ---------------------------------------------------------------------------
// W-update. Units: tiles of BN = 1024 / KB rows of W, per lane; the
// reduction runs over m. A stage is kWCols columns of the tile's V rows
// (BN x kWCols) and of H (KB x kWCols). Math warp sl is a column slice
// (float4 columns sl, sl + 8 of each stage); within a warp, lane (rg, cg)
// owns rows rg + RG u (u < 8) x ranks cg + CG v (v < 4), 32 accumulators.
// Per float4 column 8 loads of V and 4 of H feed 128 FMAs, and the
// m-reduction stays in the thread's registers. H is read from L2 once per
// BN rows (16 times a lane at n = 1000, k <= 16).
// ---------------------------------------------------------------------------
constexpr int kWCols = 64;  // columns of V per stage (ops.MU_W_STAGE)

// Float offset of (row, col) in an R x 64 stage tile kept as two R x 32
// halves of 128-byte rows, 16-byte chunk j of row r stored at j ^ (r % 8)
// (the tensor memory accelerator's 128-byte swizzle): the float4 reads of 8
// consecutive rows at one column hit 8 distinct bank groups.
template <int R>
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 5) * (R * 32) + row * 32 + ((((col & 31) >> 2) ^ (row & 7)) << 2) + (col & 3);
}

template <int KB>
struct WUpdate {
  static constexpr int kCG = KB / 4;    // rank groups (4 ranks a thread)
  static constexpr int kRG = 32 / kCG;  // row groups (8 rows a thread)
  static constexpr int kBN = 8 * kRG;   // rows a tile (ops.mu_w_rows)
  static constexpr int kVFloats = kBN * kWCols;
  static constexpr int kStage = kVFloats + KB * kWCols;  // a multiple of 1 KB: swizzled boxes stay aligned
  static constexpr int kPark = 8 * kBN * KB;  // every math thread's 32 sums
  static constexpr int kStages = ring_stages(kStage, kPark);
  static constexpr int kSmemBytes = 4 * (kStages * kStage + kPark) + 1024;
  static constexpr int kPer = kBN * KB / kMath;  // 4 elements a math thread: tid + kMath * i
  static constexpr int kTmaBytes = 4 * kStage;    // a stage's four boxes
  static constexpr bool kPlainStores = false;

  const float *v, *h, *w, *q;
  float *out, *part;
  int* count;
  int lanes, n, m, k;
  Walk wk;
  bool vec, tma;
  const CUtensorMap *map_v, *map_h;  // V as (m, n, L), box (32, kBN); H as (m, k, L), box (32, KB); swizzled
  float* park;  // (8, kBN, KB)
  float acc[8][4];

  __device__ __forceinline__ void issue_tma(const Cursor& c, float* st, uint64_t* bar) const {
    const int j = c.s_begin + c.t * kWCols;  // splits are whole stages: a box never crosses one
    const int i0 = c.tile * kBN, l = (int)c.lane;
    tma_box(st, map_v, j, i0, l, bar);
    tma_box(st + kBN * 32, map_v, j + 32, i0, l, bar);
    tma_box(st + kVFloats, map_h, j, 0, l, bar);
    tma_box(st + kVFloats + KB * 32, map_h, j + 32, 0, l, bar);
  }

  // Without tensor maps: the copy threads stage an R x kWCols tile (row
  // stride m) in the same swizzled layout, 16 bytes a copy where `vec` (m a
  // multiple of 4 floats, operands aligned), else 4.
  template <int R>
  __device__ __forceinline__ void stage_swizzled(float* dst, const float* src, const float* safe, int vr, int vc,
                                                 int lane) const {
    if (vec) {
#pragma unroll 4
      for (int e = lane; e < R * kWCols / 4; e += kCopy) {
        const int r = e / (kWCols / 4), c = (e % (kWCols / 4)) * 4;
        const bool ok = r < vr && c < vc;
        cp_async16(dst + swz<R>(r, c), ok ? src + (size_t)r * m + c : safe, ok);
      }
    } else {
#pragma unroll 4
      for (int e = lane; e < R * kWCols; e += kCopy) {
        const int r = e / kWCols, c = e % kWCols;
        const bool ok = r < vr && c < vc;
        cp_async4(dst + swz<R>(r, c), ok ? src + (size_t)r * m + c : safe, ok);
      }
    }
  }

  __device__ __forceinline__ void issue(const Cursor& c, float* st, int lane) const {
    const int c_end = c.piece ? min(m, c.s_begin + wk.chunk) : m;
    const int j = c.s_begin + c.t * kWCols, vc = min(kWCols, c_end - j);
    const int i0 = c.tile * kBN;
    const float* vl = v + c.lane * n * m;
    const float* hl = h + c.lane * k * m;
    stage_swizzled<kBN>(st, vl + (size_t)i0 * m + j, vl, min(kBN, n - i0), vc, lane);
    stage_swizzled<KB>(st + kVFloats, hl + j, hl, k, vc, lane);
  }

  __device__ __forceinline__ void compute(const float* vs) {
    const int sl = threadIdx.x >> 5, lid = threadIdx.x & 31, cg = lid % kCG, rg = lid / kCG;
    const float* hs = vs + kVFloats;
#pragma unroll
    for (int p = 0; p < kWCols / 32; ++p) {
      const int c = 4 * (sl + 8 * p);
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = *reinterpret_cast<const float4*>(vs + swz<kBN>(rg + kRG * u, c));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 y = *reinterpret_cast<const float4*>(hs + swz<KB>(cg + kCG * r, c));
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[u][r] = dot4(x[u], y, acc[u][r]);
      }
    }
  }

  // The item's last stage is done. The epilogue's operands (the tile's W
  // rows and Q) are requested first; each math thread parks its 32 sums in
  // its warp's (kBN, KB) block and zeroes them, and each element is added
  // over the 8 column slices in the fixed order 0 .. 7.
  __device__ __forceinline__ void finish(const Cursor& it) {
    const int tid = threadIdx.x, sl = tid >> 5, lid = tid & 31, cg = lid % kCG, rg = lid / kCG;
    const int i0 = it.tile * kBN, rows = min(kBN, n - i0);
    const float* wl = w + (it.lane * n + i0) * k;
    const float* ql = q + it.lane * k * k;
    int off[kPer];  // element tid + kMath * i: row r, rank c -> r * k + c
    bool live[kPer];
    float wv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kMath * i, r = e / KB, c = e % KB;
      off[i] = r * k + c;
      live[i] = r < rows && c < k;
      wv[i] = live[i] ? __ldg(wl + off[i]) : 0.f;
    }
    constexpr bool kQInSmem = KB <= 64;  // Q beside the W rows in the parking space
    constexpr int kQPer = (KB * KB + kMath - 1) / kMath;
    float qv[kQInSmem ? kQPer : 1];
    if constexpr (kQInSmem) {
#pragma unroll
      for (int i = 0; i < kQPer; ++i) {
        const int e = tid + kMath * i, p = e / KB, c = e % KB;
        qv[i] = (e < KB * KB && p < k && c < k) ? __ldg(ql + p * k + c) : 0.f;
      }
    }
    math_sync();  // the previous item's epilogue has read W and Q out of the parking space
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        park[(sl * kBN + rg + kRG * u) * KB + cg + kCG * r] = acc[u][r];
        acc[u][r] = 0.f;
      }
    math_sync();
    float num[kPer];  // V H^T of element tid + kMath * i, over this item
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kMath * i;
      float a = park[e];
#pragma unroll
      for (int z = 1; z < 8; ++z) a += park[z * kBN * KB + e];
      num[i] = a;
    }
    if (it.piece) {
      // partials (S, tail units, kBN, k): store this split's; the last block
      // adds all S in order
      const int tail = wk.units - wk.whole, tile_floats = kBN * k;
      float* mine = part + ((size_t)it.s * tail + it.tail) * tile_floats;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (live[i]) mine[off[i]] = num[i];
      if (!arrive_last(count + it.tail, wk.split)) return;
      sum_partials(num, part + (size_t)it.tail * tile_floats, off, live, wk.split, (size_t)tail * tile_floats);
    }
    float* ws = park;             // (kBN, KB) W rows
    float* qs = park + kBN * KB;  // (KB, KB) Q, when it fits
    math_sync();  // every math thread has read its sums out of the parking space
#pragma unroll
    for (int i = 0; i < kPer; ++i) ws[tid + kMath * i] = wv[i];
    if constexpr (kQInSmem) {
#pragma unroll
      for (int i = 0; i < kQPer; ++i)
        if (tid + kMath * i < KB * KB) qs[tid + kMath * i] = qv[i];
    }
    math_sync();
    float* ol = out + (it.lane * n + i0) * k;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!live[i]) continue;
      const int e = tid + kMath * i, r = e / KB, c = e % KB;
      float wq = 0.f;
#pragma unroll 16
      for (int p = 0; p < k; ++p) wq += ws[r * KB + p] * (kQInSmem ? qs[p * KB + c] : __ldg(ql + p * k + c));
      ol[off[i]] = wv[i] * num[i] / (wq + kEps);
    }
  }
};

template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
h_update_kernel(const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ h, const float* __restrict__ g,
                float* __restrict__ out, float* __restrict__ part, int* __restrict__ count,
                int lanes, int n, int m, int k, int split, int chunk, int whole, bool vec_v, bool vec_w,
                bool tma, const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_w) {
  using Op = HUpdate<KB>;
  extern __shared__ __align__(16) float smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  float* ring = align_1k(smem_raw);
  init_barriers<Op>(bars, bars + kMaxStages, tma);
  const int tiles = (m + kHCols - 1) / kHCols;
  const Walk wk{tiles, tiles * lanes, whole, split, chunk, n, kHRows};
  Op op{v, w, h, g, out, part, count, lanes, n, m, k, wk, vec_v, vec_w, tma, &map_v, &map_w,
        ring + Op::kStages * Op::kStage, {}};
  walk(op, ring, bars, bars + kMaxStages);
}

template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
w_update_kernel(const float* __restrict__ v, const float* __restrict__ h,
                const float* __restrict__ w, const float* __restrict__ q,
                float* __restrict__ out, float* __restrict__ part, int* __restrict__ count,
                int lanes, int n, int m, int k, int split, int chunk, int whole, bool vec, bool tma,
                const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_h) {
  using Op = WUpdate<KB>;
  extern __shared__ __align__(16) float smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  float* ring = align_1k(smem_raw);
  init_barriers<Op>(bars, bars + kMaxStages, tma);
  const int tiles = (n + Op::kBN - 1) / Op::kBN;
  const Walk wk{tiles, tiles * lanes, whole, split, chunk, m, kWCols};
  Op op{v, h, w, q, out, part, count, lanes, n, m, k, wk, vec, tma, &map_v, &map_h, ring + Op::kStages * Op::kStage,
        {}};
  walk(op, ring, bars, bars + kMaxStages);
}

int k_bucket(int k) { return k <= 16 ? 16 : k <= 32 ? 32 : k <= 64 ? 64 : 128; }


bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

#ifdef MU_NO_TMA
constexpr bool kTma = false;  // a build that times the cp.async path alone
#else
constexpr bool kTma = true;
#endif

// The driver's tensor-map encoder, fetched through the runtime, so the
// library links against no driver stub.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A float32 (or, with bf16, bfloat16) (d0, d1, d2) tensor, d0 innermost
// and rows of 16-byte multiples, read in (b0, b1, 1) boxes; false if the
// encoder refuses it.
bool tensor_map(CUtensorMap* map, const void* base, int d0, int d1, int d2, int b0, int b1, bool swizzle, bool bf16) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * elem, (cuuint64_t)d0 * d1 * elem};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tensor_map, remembered: a map depends only on its arguments, and encoding
// one costs the host more than the launch. The threads executor reuses a
// few dozen (V per fit, and the allocator's few W and H addresses).
bool cached_map(CUtensorMap* map, const void* base, int d0, int d1, int d2, int b0, int b1, bool swizzle,
                bool bf16 = false) {
  struct Key {
    const void* base;
    int d0, d1, d2, b0, b1;
    bool swizzle, bf16;
  };
  constexpr int kSlots = 64;
  static std::mutex mu;
  static Key keys[kSlots];
  static CUtensorMap maps[kSlots];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Key& q = keys[i];
    if (q.base == base && q.d0 == d0 && q.d1 == d1 && q.d2 == d2 && q.b0 == b0 && q.b1 == b1 &&
        q.swizzle == swizzle && q.bf16 == bf16) {
      *map = maps[i];
      return true;
    }
  }
  if (!tensor_map(map, base, d0, d1, d2, b0, b1, swizzle, bf16)) return false;
  keys[next] = {base, d0, d1, d2, b0, b1, swizzle, bf16};
  maps[next] = *map;
  next = (next + 1) % kSlots;
  if (used < kSlots) ++used;
  return true;
}

// The walk must fit int item indices, and each tail unit's split must cover
// its reduction (length `len`) exactly with no empty part:
// (split - 1) * chunk < len <= split * chunk; a part is whole stages.
bool bad_call(int lanes, int n, int m, int k, int split, int chunk, int whole, int blocks, int len,
              int tiles, int step, const void* part, const void* count) {
  if (lanes < 1 || lanes > 65535 || n < 1 || m < 1 || k < 1 || k > kTiledMaxRank) return true;
  const long long units = (long long)tiles * lanes;
  if (split < 1 || chunk < 1 || chunk % step != 0 || blocks < 1 || whole < 0 || whole > units) return true;
  if (units * split + blocks >= (1LL << 31)) return true;
  if ((long long)(split - 1) * chunk >= len || (long long)split * chunk < len) return true;
  return whole < units && split > 1 && (part == nullptr || count == nullptr);
}

template <int KB>
int launch_h(const float* v, const float* w, const float* h, const float* g, float* out,
             float* part, int* count, int lanes, int n, int m, int k, int split, int chunk,
             int whole, int blocks, cudaStream_t stream) {
  constexpr int kSmem = HUpdate<KB>::kSmemBytes;
  static const cudaError_t attr =  // once per process (thread-safe static init)
      cudaFuncSetAttribute(h_update_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const bool vec_v = m % 4 == 0 && aligned16(v);
  const bool vec_w = k % 4 == 0 && aligned16(w);
  CUtensorMap map_v{}, map_w{};
  const bool tma = kTma && vec_v && vec_w && cached_map(&map_v, v, m, n, lanes, kHCols, kHRows, false) &&
                   cached_map(&map_w, w, k, n, lanes, KB, kHRows, false);
  h_update_kernel<KB><<<blocks, kThreads, kSmem, stream>>>(v, w, h, g, out, part, count, lanes, n, m, k, split,
                                                           chunk, whole, vec_v, vec_w, tma, map_v, map_w);
  return (int)cudaGetLastError();
}

template <int KB>
int launch_w(const float* v, const float* h, const float* w, const float* q, float* out,
             float* part, int* count, int lanes, int n, int m, int k, int split, int chunk,
             int whole, int blocks, cudaStream_t stream) {
  using Op = WUpdate<KB>;
  constexpr int kSmem = Op::kSmemBytes;
  static const cudaError_t attr =
      cudaFuncSetAttribute(w_update_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map_v{}, map_h{};
  const bool vec = m % 4 == 0 && aligned16(v) && aligned16(h);
  const bool tma = kTma && vec && cached_map(&map_v, v, m, n, lanes, 32, Op::kBN, true) &&
                   cached_map(&map_h, h, m, k, lanes, 32, KB, true);
  w_update_kernel<KB><<<blocks, kThreads, kSmem, stream>>>(v, h, w, q, out, part, count, lanes, n, m, k, split,
                                                           chunk, whole, vec, tma, map_v, map_h);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Any rank (k > kTiledMaxRank, where the register tiles above would spill):
// out = X * (A B) / (C D + 1e-9) for each lane's (R, S) output, every
// operand given by element strides, so one kernel serves both updates
// (H: X = H, A = W^T, B = V, C = G, D = H; W: X = W, A = V, B = H^T, C = W,
// D = Q). A block owns a 32 x 32 output tile; 16 x 16 threads own 2 x 2
// outputs each and walk both reductions in ascending order through
// 32-deep shared-memory tiles. Right rather than fast: strided operands are
// read as they lie. Each output is one thread's sum in a fixed order, so
// the result is bitwise equal from call to call; a masked rank (X zero)
// stays exactly zero. T is float, or __nv_bfloat16 for the bf16 half
// (operands widened on load, the output rounded once on store).
// ---------------------------------------------------------------------------
template <typename T>
struct Strided {
  const T* p;
  long long lane, row, col;  // element strides
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

constexpr int kAnyTile = 32;  // output rows and columns a block
constexpr int kAnyStep = 32;  // reduction depth a shared tile

// acc[i][j] += sum over p < len of A[r0 + ty + 16 i, p] B[p, c0 + tx + 16 j]
template <typename T>
__device__ __forceinline__ void any_product(float (&acc)[2][2], const Strided<T>& a, const Strided<T>& b, int rows,
                                            int cols, int len, int r0, int c0, float (*as)[kAnyStep + 1],
                                            float (*bs)[kAnyTile + 1]) {
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 16 + tx;
  for (int p0 = 0; p0 < len; p0 += kAnyStep) {
    for (int e = tid; e < kAnyTile * kAnyStep; e += 256) {
      const int hi = e >> 5, lo = e & 31;  // as[row hi][depth lo]; bs[depth hi][column lo]
      const int r = r0 + hi, pa = p0 + lo, pb = p0 + hi, c = c0 + lo;
      as[hi][lo] = (r < rows && pa < len) ? widen(a.p[r * a.row + pa * a.col]) : 0.f;
      bs[hi][lo] = (pb < len && c < cols) ? widen(b.p[pb * b.row + c * b.col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < kAnyStep; ++p) {
      const float a0 = as[ty][p], a1 = as[ty + 16][p];
      const float b0 = bs[p][tx], b1 = bs[p][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
}

// grid (ceil(S / 32), ceil(R / 32), L), block (16, 16); out (L, R, S) row-major.
template <typename T>
__global__ void __launch_bounds__(256)
any_rank_kernel(Strided<T> x, Strided<T> a, Strided<T> b, Strided<T> c, Strided<T> d, T* __restrict__ out,
                int rows, int cols, int len_ab, int len_cd) {
  __shared__ float as[kAnyTile][kAnyStep + 1];
  __shared__ float bs[kAnyStep][kAnyTile + 1];
  const long long lane = blockIdx.z;
  x.p += lane * x.lane;
  a.p += lane * a.lane;
  b.p += lane * b.lane;
  c.p += lane * c.lane;
  d.p += lane * d.lane;
  out += lane * rows * cols;
  const int r0 = blockIdx.y * kAnyTile, c0 = blockIdx.x * kAnyTile;
  float num[2][2] = {}, den[2][2] = {};
  any_product(num, a, b, rows, cols, len_ab, r0, c0, as, bs);
  any_product(den, c, d, rows, cols, len_cd, r0, c0, as, bs);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + threadIdx.y + 16 * i, col = c0 + threadIdx.x + 16 * j;
      if (r < rows && col < cols) {
        const float xv = widen(x.p[r * x.row + col * x.col]);
        out[(long long)r * cols + col] = narrow<T>(xv * num[i][j] / (den[i][j] + kEps));
      }
    }
}

template <typename T>
int launch_any(const Strided<T>& x, const Strided<T>& a, const Strided<T>& b, const Strided<T>& c,
               const Strided<T>& d, T* out, int lanes, int rows, int cols, int len_ab, int len_cd, void* stream) {
  if (lanes < 1 || lanes > 65535 || rows < 1 || cols < 1 || len_ab < 1 || len_cd < 1) return (int)cudaErrorInvalidValue;
  const long long row_tiles = ((long long)rows + kAnyTile - 1) / kAnyTile;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + kAnyTile - 1) / kAnyTile, (unsigned)row_tiles, lanes), block(16, 16);
  any_rank_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(x, a, b, c, d, out, rows, cols, len_ab, len_cd);
  return (int)cudaGetLastError();
}

// The H-update (X = H, A = W^T, B = V, C = G, D = H) and the W-update (X =
// W, A = V, B = H^T, C = W, D = Q) of one dtype through launch_any.
template <typename T>
int any_h(const T* v, const T* w, const T* h, const T* g, T* out, int lanes, int n, int m, int k, void* stream) {
  const long long nm = (long long)n * m, nk = (long long)n * k, km = (long long)k * m, kk = (long long)k * k;
  return launch_any<T>({h, km, m, 1}, {w, nk, 1, k}, {v, nm, m, 1}, {g, kk, k, 1}, {h, km, m, 1}, out, lanes, k, m,
                       n, k, stream);
}

template <typename T>
int any_w(const T* v, const T* h, const T* w, const T* q, T* out, int lanes, int n, int m, int k, void* stream) {
  const long long nm = (long long)n * m, nk = (long long)n * k, km = (long long)k * m, kk = (long long)k * k;
  return launch_any<T>({w, nk, k, 1}, {v, nm, m, 1}, {h, km, 1, m}, {w, nk, k, 1}, {q, kk, k, 1}, out, lanes, n, k,
                       m, k, stream);
}

// ---------------------------------------------------------------------------
// H-update at bf16 (V, W, H and G bf16; fp32 sums and epilogue; out rounded
// once to bf16): the tiled, planned design above with bf16 stages. Units,
// items, splits and the persistent walk are the fp32 H-update's. A stage is
// kHRowsBf16 rows: of V, two 64-column halves of 128-byte rows, 16-byte
// chunk j of row r at j ^ (r % 8) (the 128-byte swizzle a tensor box lands
// in, so the ldmatrix reads below hit 8 distinct bank groups), and of W,
// KB bf16 a row as it lies. Tensor boxes where V's and W's rows are 16-byte
// multiples; otherwise the copy threads stage V with cp.async (16, 8 or 4
// bytes as m and the base allow; 2-byte plain stores for odd m) and W with
// plain loads (k is often odd on the threads executor), arriving once for
// each kind.
//
// The products: at k 16 the H-update does 16 fp32 FLOPs a byte of bf16 V,
// just under the CUDA cores' 20 a byte, and widening every element adds
// instructions on top; these kernels are bound by the instructions they
// issue (the fp32 notes above). So W^T V runs on the bf16 tensor cores,
// mma.sync.m16n8k16 with A = W^T and B = V, both loaded from the stage by
// ldmatrix.trans (k16 steps run down the rows, which are V's and W's
// strided axis). mma.sync over wgmma: each of the 8 math warps owns 16 of
// the tile's 128 columns and every rank, so one warp's fragments cover its
// sums with no cross-warp reduction, and the ring and copy warps stay the
// fp32 design's. Per 16 rows a warp issues one ldmatrix of V, KB / 16 of W
// and KB / 8 products. Each stage sums into a fresh accumulator that the
// running fp32 sums take by IEEE adds (the tensor core truncates as it
// adds). The epilogue reads the H tile and G from global memory (L2): den
// = G H in ascending rank order by FMA, then H * num / (den + 1e-9).
// ---------------------------------------------------------------------------
constexpr int kHRowsBf16 = 64;  // rows of V per stage at bf16 (ops.MU_H_STAGE_BF16): 16 KB, as fp32's 32 rows

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b on a warp's m16 x n8 x k16 tile: bf16 operands, fp32
// accumulators. a: rows (g, g + 8) x k (2t, 2t + 1), then k + 8; b: k (2t,
// 2t + 1) and k + 8 of column g; d: rows (g, g + 8) x columns (2t, 2t + 1)
// (lane 4 g + t).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KB>
struct HUpdateBf16 {
  static constexpr int kMT = KB / 16;                  // m16 tiles of ranks
  static constexpr int kHalfBytes = kHRowsBf16 * 128;  // 64 columns of V
  static constexpr int kVBytes = 2 * kHalfBytes;
  static constexpr int kWBytes = kHRowsBf16 * KB * 2;
  static constexpr int kStage = (kVBytes + kWBytes) / 4;  // in floats (the ring's unit); a multiple of 1 KB
  static constexpr int kStages = ring_stages(kStage, 0);
  static constexpr int kSmemBytes = 4 * kStages * kStage + 1024;
  static constexpr int kTmaBytes = kVBytes + kWBytes;  // a stage's three boxes
  static constexpr bool kPlainStores = true;           // W, and V at odd m, without cp.async
  static constexpr int kPer = 8 * kMT;                 // sums a math thread holds

  const __nv_bfloat16 *v, *w, *h, *g;
  __nv_bfloat16* out;
  float* part;
  int* count;
  int lanes, n, m, k;
  Walk wk;
  int vg;     // without tensor maps, V's copy granule: 8, 4 or 2 elements by cp.async, 1 by plain stores
  bool wvec;  // W's rows by 16-byte loads
  bool tma;
  const CUtensorMap *map_v, *map_w;  // V as (m, n, L), box (64, kHRowsBf16), swizzled; W as (k, n, L), box (KB, kHRowsBf16)
  float sum[kMT][2][4];              // rank tile, n8 block of columns, fragment

  __device__ __forceinline__ void issue_tma(const Cursor& c, float* st, uint64_t* bar) const {
    const int r0 = c.s_begin + c.t * kHRowsBf16, j0 = c.tile * kHCols, l = (int)c.lane;
    unsigned char* b = reinterpret_cast<unsigned char*>(st);
    tma_box(st, map_v, j0, r0, l, bar);
    tma_box(reinterpret_cast<float*>(b + kHalfBytes), map_v, j0 + 64, r0, l, bar);
    tma_box(reinterpret_cast<float*>(b + kVBytes), map_w, 0, r0, l, bar);
  }

  // V's rows [0, vr) x columns [0, vc) from src (row stride m), G elements a
  // copy (cp.async; G 1: plain 2-byte stores), zeros elsewhere
  template <int G>
  __device__ __forceinline__ void stage_v(unsigned char* dst, const __nv_bfloat16* src, int vr, int vc,
                                          int lane) const {
    constexpr int kPerRow = kHCols / G;
#pragma unroll 4
    for (int e = lane; e < kHRowsBf16 * kPerRow; e += kCopy) {
      const int r = e / kPerRow, c = (e % kPerRow) * G;
      const bool ok = r < vr && c < vc;
      unsigned char* at = dst + (c >> 6) * kHalfBytes + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
      const __nv_bfloat16* from = ok ? src + (size_t)r * m + c : src;
      if constexpr (G == 8) {
        cp_async16(reinterpret_cast<float*>(at), reinterpret_cast<const float*>(from), ok);
      } else if constexpr (G == 4) {
        cp_async8(at, from, ok);
      } else if constexpr (G == 2) {
        cp_async4(reinterpret_cast<float*>(at), reinterpret_cast<const float*>(from), ok);
      } else {
        *reinterpret_cast<__nv_bfloat16*>(at) = ok ? *from : __float2bfloat16_rn(0.f);
      }
    }
  }

  __device__ __forceinline__ void issue(const Cursor& c, float* st, int lane) const {
    const int r0 = c.s_begin + c.t * kHRowsBf16, vr = min(kHRowsBf16, n - r0);  // splits are whole stages
    const int j0 = c.tile * kHCols, vc = min(kHCols, m - j0);
    const __nv_bfloat16* vl = v + c.lane * n * m + (size_t)r0 * m + j0;
    const __nv_bfloat16* wl = w + (c.lane * n + r0) * k;
    unsigned char* b = reinterpret_cast<unsigned char*>(st);
    __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(b + kVBytes);  // (kHRowsBf16, KB): ranks past k zero
    if (wvec) {
#pragma unroll 2
      for (int e = lane; e < kHRowsBf16 * KB / 8; e += kCopy) {
        const int r = e / (KB / 8), q = (e % (KB / 8)) * 8;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (r < vr && q < k) x = *reinterpret_cast<const uint4*>(wl + (size_t)r * k + q);
        *reinterpret_cast<uint4*>(ws + r * KB + q) = x;
      }
    } else {
#pragma unroll 4
      for (int e = lane; e < kHRowsBf16 * KB; e += kCopy) {
        const int r = e / KB, q = e % KB;
        ws[e] = r < vr && q < k ? wl[(size_t)r * k + q] : __float2bfloat16_rn(0.f);
      }
    }
    if (vg == 8) stage_v<8>(b, vl, vr, vc, lane);
    else if (vg == 4) stage_v<4>(b, vl, vr, vc, lane);
    else if (vg == 2) stage_v<2>(b, vl, vr, vc, lane);
    else stage_v<1>(b, vl, vr, vc, lane);
  }

  // Math warp w: columns 16 w .. 16 w + 15 of the tile (V's half w / 4),
  // every rank. ldmatrix.trans x4 of V: 8 x 8 blocks (rows 0-7, columns
  // 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) of the warp's 16 x 16, the
  // B fragments of its two n8 blocks; of W: (rows 0-7, ranks 0-7), (0-7,
  // 8-15), (8-15, 0-7), (8-15, 8-15) of a rank tile, the A fragment of W^T.
  __device__ __forceinline__ void compute(const float* st) {
    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
    const unsigned vs = smem_u32(st) + (warp >> 2) * kHalfBytes, ws = smem_u32(st) + kVBytes;
    float acc[kMT][2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kHRowsBf16 / 16; ++ks) {
      const int vrow = 16 * ks + (l & 7) + 8 * ((l >> 3) & 1), chunk = 2 * (warp & 3) + (l >> 4);
      uint32_t bv[4];
      ldsm_x4_t(bv, vs + vrow * 128 + ((chunk ^ (vrow & 7)) << 4));
      const int wrow = 16 * ks + (l & 7) + 8 * (l >> 4);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t aw[4];
        ldsm_x4_t(aw, ws + (wrow * KB + 16 * mt + 8 * ((l >> 3) & 1)) * 2);
        mma_bf16(acc[mt][0], aw, bv[0], bv[1]);
        mma_bf16(acc[mt][1], aw, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mt][nt][e] += acc[mt][nt][e];
  }

  // The item's last stage is done: the thread's sums are whole over the
  // item (no slices), element i at rank 16 mt + g + 8 (e / 2), tile column
  // 16 w + 8 nt + 2 t + e % 2.
  __device__ __forceinline__ void finish(const Cursor& it) {
    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31, gq = l >> 2, tq = l & 3;
    const int j0 = it.tile * kHCols;
    float num[kPer];
    int off[kPer];  // element (rank r, tile column cl) -> r * kHCols + cl: its place in a split's partials
    bool live[kPer];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (2 * mt + nt) * 4 + e;
          const int r = 16 * mt + gq + 8 * (e >> 1), cl = 16 * warp + 8 * nt + 2 * tq + (e & 1);
          off[i] = r * kHCols + cl;
          live[i] = r < k && j0 + cl < m;
          num[i] = sum[mt][nt][e];
          sum[mt][nt][e] = 0.f;
        }
    if (it.piece) {
      // partials (S, tail units, k, kHCols): store this split's; the last
      // block to arrive at the unit adds all S in index order
      const int tail = wk.units - wk.whole, tile_floats = k * kHCols;
      float* mine = part + ((size_t)it.s * tail + it.tail) * tile_floats;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (live[i]) mine[off[i]] = num[i];
      if (!arrive_last(count + it.tail, wk.split)) return;
      sum_partials(num, part + (size_t)it.tail * tile_floats, off, live, wk.split, (size_t)tail * tile_floats);
    }
    const __nv_bfloat16* hl = h + it.lane * k * m + j0;
    const __nv_bfloat16* gl = g + it.lane * k * k;
    float den[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) den[i] = 0.f;
    for (int q = 0; q < k; ++q) {
      float hq[2][2];  // H[q] at the thread's columns (nt, e % 2)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cl = 16 * warp + 8 * nt + 2 * tq + c;
          hq[nt][c] = j0 + cl < m ? widen(hl[(size_t)q * m + cl]) : 0.f;
        }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * mt + gq + 8 * half;
          const float gr = r < k ? widen(gl[r * k + q]) : 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float& x = den[(2 * mt + nt) * 4 + 2 * half + c];
              x = fmaf(gr, hq[nt][c], x);
            }
        }
    }
    __nv_bfloat16* ol = out + it.lane * k * m + j0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!live[i]) continue;
      const int r = off[i] / kHCols, cl = off[i] % kHCols;
      const float hv = widen(hl[(size_t)r * m + cl]);
      ol[(size_t)r * m + cl] = __float2bfloat16_rn(hv * num[i] / (den[i] + kEps));
    }
  }
};

template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
h_update_bf16_kernel(const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ g,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ part, int* __restrict__ count,
                     int lanes, int n, int m, int k, int split, int chunk, int whole, int vg, bool wvec, bool tma,
                     const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_w) {
  using Op = HUpdateBf16<KB>;
  extern __shared__ __align__(16) float smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  float* ring = align_1k(smem_raw);
  init_barriers<Op>(bars, bars + kMaxStages, tma);
  const int tiles = (m + kHCols - 1) / kHCols;
  const Walk wk{tiles, tiles * lanes, whole, split, chunk, n, kHRowsBf16};
  Op op{v, w, h, g, out, part, count, lanes, n, m, k, wk, vg, wvec, tma, &map_v, &map_w, {}};
  walk(op, ring, bars, bars + kMaxStages);
}

template <int KB>
int launch_h_bf16(const __nv_bfloat16* v, const __nv_bfloat16* w, const __nv_bfloat16* h, const __nv_bfloat16* g,
                  __nv_bfloat16* out, float* part, int* count, int lanes, int n, int m, int k, int split, int chunk,
                  int whole, int blocks, cudaStream_t stream) {
  using Op = HUpdateBf16<KB>;
  static const cudaError_t attr =  // once per process (thread-safe static init)
      cudaFuncSetAttribute(h_update_bf16_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, Op::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const uintptr_t va = reinterpret_cast<uintptr_t>(v);
  // m and the base decide V's copies: rows of 16-byte multiples, else 8, 4, 2
  const int vg = m % 8 == 0 && va % 16 == 0 ? 8 : m % 4 == 0 && va % 8 == 0 ? 4 : m % 2 == 0 && va % 4 == 0 ? 2 : 1;
  const bool wvec = k % 8 == 0 && aligned16(w);
  CUtensorMap map_v{}, map_w{};
  const bool tma = kTma && vg == 8 && wvec && cached_map(&map_v, v, m, n, lanes, 64, kHRowsBf16, true, true) &&
                   cached_map(&map_w, w, k, n, lanes, KB, kHRowsBf16, false, true);
  h_update_bf16_kernel<KB><<<blocks, kThreads, Op::kSmemBytes, stream>>>(
      v, w, h, g, out, part, count, lanes, n, m, k, split, chunk, whole, vg, wvec, tma, map_v, map_w);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers of contiguous
// fp32 tensors: v (L, n, m), w (L, n, k), h (L, k, m), g / q (L, k, k), out
// like h (H-update) or w (W-update). The kernel is picked from the smallest
// rank bucket KB >= k (16, 32, 64, 128). An output tile of one lane is a
// unit (ceil(m / 128) * L units for H, ceil(n / (1024 / KB)) * L for W); the
// first `whole` units are reduced in one block each, the others in `split`
// blocks of `chunk` rows (H: of n) or columns (W: of m) each, and `blocks`
// persistent blocks walk the items. With split units, `part` is float32
// scratch of (split, tail units, k, 128) (H) or (split, tail units,
// 1024 / KB, k) (W) and `count` int32 zeros, one per tail unit, which every
// launch leaves at zero (the last block of a unit resets its counter);
// otherwise both may be null. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int mu_update_h(const float* v, const float* w, const float* h, const float* g,
                           float* out, float* part, int* count, int lanes, int n, int m, int k,
                           int split, int chunk, int whole, int blocks, void* stream) {
  const int tiles = (m + kHCols - 1) / kHCols;
  if (bad_call(lanes, n, m, k, split, chunk, whole, blocks, n, tiles, kHRows, part, count))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16) return launch_h<16>(v, w, h, g, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
  if (k <= 32) return launch_h<32>(v, w, h, g, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
  if (k <= 64) return launch_h<64>(v, w, h, g, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
  return launch_h<128>(v, w, h, g, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
}

extern "C" int mu_update_w(const float* v, const float* h, const float* w, const float* q,
                           float* out, float* part, int* count, int lanes, int n, int m, int k,
                           int split, int chunk, int whole, int blocks, void* stream) {
  const int bn = 1024 / k_bucket(k);  // rows a W tile (WUpdate::kBN)
  if (bad_call(lanes, n, m, k, split, chunk, whole, blocks, m, (n + bn - 1) / bn, kWCols, part, count))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16) return launch_w<16>(v, h, w, q, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
  if (k <= 32) return launch_w<32>(v, h, w, q, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
  if (k <= 64) return launch_w<64>(v, h, w, q, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
  return launch_w<128>(v, h, w, q, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
}

// Any rank: the same updates for k > 128 (and any k >= 1), without a plan
// or scratch. Same operands as mu_update_h / mu_update_w.
extern "C" int mu_update_h_any(const float* v, const float* w, const float* h, const float* g,
                               float* out, int lanes, int n, int m, int k, void* stream) {
  return any_h<float>(v, w, h, g, out, lanes, n, m, k, stream);
}

extern "C" int mu_update_w_any(const float* v, const float* h, const float* w, const float* q,
                               float* out, int lanes, int n, int m, int k, void* stream) {
  return any_w<float>(v, h, w, q, out, lanes, n, m, k, stream);
}

// The bf16 H-update, tiled and planned: contiguous bf16 v (L, n, m), w (L,
// n, k), h (L, k, m), g (L, k, k) (the bf16 product W^T W), out like h;
// scratch, plan and stream as mu_update_h's, with splits of whole
// kHRowsBf16-row stages (ops.MU_H_STAGE_BF16). k <= 128.
extern "C" int mu_update_h_bf16(const __nv_bfloat16* v, const __nv_bfloat16* w, const __nv_bfloat16* h,
                                const __nv_bfloat16* g, __nv_bfloat16* out, float* part, int* count, int lanes,
                                int n, int m, int k, int split, int chunk, int whole, int blocks, void* stream) {
  const int tiles = (m + kHCols - 1) / kHCols;
  if (bad_call(lanes, n, m, k, split, chunk, whole, blocks, n, tiles, kHRowsBf16, part, count))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16) return launch_h_bf16<16>(v, w, h, g, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
  if (k <= 32) return launch_h_bf16<32>(v, w, h, g, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
  if (k <= 64) return launch_h_bf16<64>(v, w, h, g, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
  return launch_h_bf16<128>(v, w, h, g, out, part, count, lanes, n, m, k, split, chunk, whole, blocks, s);
}

// The bf16 half, any rank: contiguous bf16 v (L, n, m), w (L, n, k), h (L,
// k, m), g / q (L, k, k) (the bf16 products W^T W / H H^T), out like h or
// w. The H-update takes it above rank 128; the W-update at every rank.
extern "C" int mu_update_h_bf16_any(const __nv_bfloat16* v, const __nv_bfloat16* w, const __nv_bfloat16* h,
                                    const __nv_bfloat16* g, __nv_bfloat16* out, int lanes, int n, int m, int k,
                                    void* stream) {
  return any_h<__nv_bfloat16>(v, w, h, g, out, lanes, n, m, k, stream);
}

extern "C" int mu_update_w_bf16_any(const __nv_bfloat16* v, const __nv_bfloat16* h, const __nv_bfloat16* w,
                                    const __nv_bfloat16* q, __nv_bfloat16* out, int lanes, int n, int m, int k,
                                    void* stream) {
  return any_w<__nv_bfloat16>(v, h, w, q, out, lanes, n, m, k, stream);
}

// Dynamic shared memory (bytes) a launch of the H (update 0) or W (update 1)
// kernel requests at rank k and element size elem (4 fp32, 2 bf16), for
// reports beside ptxas' static counts; the bf16 W-update (any rank) asks
// for none.
extern "C" int mu_dynamic_smem(int update, int k, int elem) {
  const int kb = k_bucket(k);
  if (elem == 2)
    return update != 0 ? 0 : kb == 16 ? HUpdateBf16<16>::kSmemBytes : kb == 32 ? HUpdateBf16<32>::kSmemBytes
           : kb == 64 ? HUpdateBf16<64>::kSmemBytes : HUpdateBf16<128>::kSmemBytes;
  if (update == 0)
    return kb == 16 ? HUpdate<16>::kSmemBytes : kb == 32 ? HUpdate<32>::kSmemBytes
           : kb == 64 ? HUpdate<64>::kSmemBytes : HUpdate<128>::kSmemBytes;
  return kb == 16 ? WUpdate<16>::kSmemBytes : kb == 32 ? WUpdate<32>::kSmemBytes
         : kb == 64 ? WUpdate<64>::kSmemBytes : WUpdate<128>::kSmemBytes;
}
