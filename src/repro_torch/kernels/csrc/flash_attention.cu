// Causal / sliding-window GQA flash attention for Hopper (sm_90a): fp32 in
// and out, the products on the tensor cores in split TF32 (flash_attention);
// and bf16 in and out, fp32 scores, softmax and sums, the products on the
// bf16 tensor cores (flash_attention_bf16, at the end of this file: the
// same persistent, work-list, wgmma design, its K and V fed by the tensor
// memory accelerator).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:102
// (`flash_attention`, whose `_flash_kernel` carries the running fp32
// (m, l, acc) in VMEM scratch across a sequential kv grid axis). Here one
// warp owns a band of query rows of one (batch, query head) and walks every
// live kv tile itself, in ascending order: the result is deterministic, and
// (m, l, acc) live in registers for the whole walk. Output is written once.
//
//   out[b, h, i, :] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,h/g,j,:]) v[b,h/g,j,:]
//
// over the unmasked j: j < Lk; j <= p when causal; j > p - window with a
// window, where p = qoff + i is query row i's position (0 <= qoff, and
// qoff + Lq <= Lk when causal or windowed: one rank's block of a
// sequence-parallel prefill starts at its offset). Query head h reads kv head h / group (group = Hq / Hk, any
// integer: qwen2's is 7), so GQA needs no replicated K/V.
//
// Masking follows the reference: masked scores are the finite -1e30, not
// -inf. A live tile that is fully masked for one row gives that row exp(0)
// junk, and the next live tile's correction exp(-1e30 - m) = 0 wipes it
// (with -inf that step would be inf - inf = NaN). The final divide is by
// max(l, 1e-30). Ragged lengths are masked, never padded: query rows >= Lq
// are not stored, kv rows >= Lk score -1e30 and load as zeros.
//
// Operands are (B, H, L, D) with unit stride along D and any b/h/l strides,
// so the model passes views of its (B, L, H, D) projections without copies.
//
// What bounds it: at the serve path's prefill (B 4, Hq 14, L 1000, D 64,
// causal) the work is 7.2 GFLOP against 33 MB, bound by operations:
// 0.107 ms at 67 TFLOP/s of fp32 on CUDA cores. TF32 on the tensor cores
// is 7x faster, but one TF32 pass
// keeps 10 mantissa bits and misses the port's fp32 tolerance (3e-5) by
// about 30x. So every product is split TF32 ("3xTF32"): x = hi + lo with
// hi = tf32(x), lo = tf32(x - hi), rounded to nearest with ties away from
// zero (cvt.rna), and A.B = lo(A).hi(B) + hi(A).lo(B) + hi(A).hi(B), the
// small terms first. Bound: 3 x 7.2 GFLOP over 495 TFLOP/s = 0.043 ms.
// - wgmma.m64nNk8 TF32: S = Q K^T with Q's split fragments as register A
//   operands (from shared memory where they do not fit, D > 80) and K's
//   images as B; P V with P as register A operands and V^T's images as
//   B. TF32 wgmma takes only K-major shared-memory operands, so V is
//   staged transposed. Operand images are core-matrix layouts without
//   swizzle (8 x 16-byte rows, 128 B apart along k, 256 B apart along
//   rows), written whole by the split pass and copied as they are.
// - A split pass (split_kv_kernel) reads K and V once per call, with
//   their strides, and writes each BK-key tile's images: K (BK rows, k
//   = D) and V^T (DP rows, k = keys), each as a hi and a lo image. Ragged
//   keys and columns are zero. Splitting once per call instead of per
//   product matters: the kernel is bound by the instructions it issues
//   beside its products, not by bytes. Q is split once per work item.
// - P V takes P straight from the S accumulator: the accumulator holds
//   columns (2t, 2t + 1) where the A fragment wants k (t, t + 4), so
//   V^T's image orders each 8-key chunk 0, 2, 4, 6, 1, 3, 5, 7 instead of
//   shuffling P (P V sums over keys; only the order of the sum moves).
// - Each tile's P V sums into a fresh accumulator that O takes by an
//   IEEE FFMA: the tensor core adds into its accumulator with truncation,
//   and over thousands of keys one accumulator ends up 5-10x further
//   from float64 than the fp32 plain version.
// - One persistent block per SM walks a host-built list of (b, h, q
//   tile) items, longest walk first (ops.flash_work_list). A producer
//   warpgroup, which gives its registers to the consumers (setmaxnreg),
//   keeps a ring of two or three K/V tiles filled with bulk copies
//   (cp.async.bulk, completing on an mbarrier per slot); two consumer
//   warpgroups of 64 query rows run the products and the online softmax
//   (in log2 units: one FFMA and one ex2 a score), one's softmax beside
//   the other's products. A warpgroup skips the tiles its rows mask out
//   entirely. The main kernel is a programmatic dependent of the split
//   pass: it starts, and stages Q, while the last split blocks run.
// - Any D from 1 to 128, stride and alignment: Q rows are staged, and
//   output rows stored, as float4 / float2 where D, the strides and the
//   base allow, else element by element (D 17, offset views); the split
//   pass does the same for K and V. The images are always aligned.
#include <cuda.h>  // CUtensorMap (its encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kNegBig = -1e30f;

constexpr int kWGs = 2;                          // consumer warpgroups of 64 query rows
constexpr int kConsumers = 4 * kWGs;             // consumer warps
constexpr int kThreads = 32 * (kConsumers + 4);  // + a producer warpgroup
// Registers a thread holds after setmaxnreg: the producer warpgroup gives
// its registers to the consumers (4 x 32 x 40 + 8 x 32 x 232 <= 65536).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kWGRows = 64;                      // query rows of a consumer warpgroup: one wgmma m64
constexpr int kBQ = kWGs * kWGRows;              // query rows a block owns
constexpr int kMaxStages = 3;                    // K/V tiles in flight, where they fit
constexpr int kSplitThreads = 256;
constexpr int kSmem = 232448;                    // shared memory one block may hold

// Head dim padded to DP = 16 * NJ; BK keys per kv tile: 64 up to DP 64, 32
// up to 96, 16 above, so that Q's split images and at least two stages of
// K/V images fit in shared memory (DP 64: 64 KB of Q and two 64 KB stages;
// DP 80: 80 KB and three 40 KB stages).
template <int NJ>
struct Cfg {
    static constexpr int DP = 16 * NJ;
    static constexpr int KS = DP / 8;               // k steps of Q K^T; n8 blocks of P V
    static constexpr int BK = DP <= 64 ? 64 : DP <= 96 ? 32 : 16;
    static constexpr int NT = BK / 8;               // n8 blocks of Q K^T; k steps of P V
    static constexpr bool kQRegs = DP <= 80;        // Q's split fragments fit in registers
    static constexpr int kImageFloats = BK * DP;    // one operand image of a tile (hi or lo)
    static constexpr int kTileFloats = 2 * kImageFloats;  // K (or V^T) of a tile: hi image, lo image
    static constexpr int kQFloats = 2 * kWGRows * DP;     // a warpgroup's Q: hi image, lo image
    static constexpr size_t kStageBytes = sizeof(float) * 2 * kTileFloats;
    static constexpr size_t kQBytes = sizeof(float) * kWGs * kQFloats;
    static constexpr int kFit = static_cast<int>((kSmem - kQBytes - 2 * kMaxStages * sizeof(uint64_t)) / kStageBytes);
    static constexpr int STAGES = kFit < kMaxStages ? kFit : kMaxStages;  // ring slots
    static constexpr size_t kQOffset = STAGES * kStageBytes;
    static constexpr size_t kBarOffset = kQOffset + kQBytes;
    static constexpr size_t kBytes = kBarOffset + 2 * STAGES * sizeof(uint64_t);
    static_assert(STAGES >= 2 && kBytes <= kSmem, "Q and two stages fit in shared memory");
};

// Float offset of element (r, k) in the shared-memory image of an R-row,
// K-major wgmma operand without swizzle: k steps of 8 one after another
// (R * 8 floats each); inside one, 8-row groups (256 B) of two 8 x 4 core
// matrices (128 B, rows of 16 B), k 0-3 then k 4-7. Its descriptor: the k
// step's address, 128 B between core matrices along k (leading byte
// offset), 256 B between 8-row groups (stride byte offset).
template <int R>
__device__ __forceinline__ int image_at(int r, int k) {
    return (k >> 3) * (R * 8) + (r >> 3) * 64 + ((k >> 2) & 1) * 32 + (r & 7) * 4 + (k & 3);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t image_desc(const float* p) {
    return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) | (static_cast<uint64_t>(128 >> 4) << 16) |
           (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    while (!mbar_try_wait(bar, parity)) {
    }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile(
        "{\n"
        ".reg .b64 state;\n"
        "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
        "}\n" ::"r"(smem_u32(bar))
        : "memory");
}

// Announce `bytes` of bulk copies on the barrier and arrive once.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
    asm volatile(
        "{\n"
        ".reg .b64 state;\n"
        "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global into
// shared memory by the copy engine; the barrier counts them when landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// x = hi + lo for finite x, hi = cvt.rna.tf32.f32(x) (round to nearest,
// ties away from zero: add half of the 13 dropped bits' range to the
// magnitude, drop them) and lo = cvt.rna.tf32.f32(x - hi), which is exact
// in fp32. sm_90 has no cvt.rna.tf32 instruction: ptxas emulates it with a
// guard for NaN and inf, four instructions a call; here the guard goes
// (the operands are finite) and lo keeps its dropped bits, which the tensor
// core ignores, as ptxas itself does for a cvt that feeds a product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ float4 hi4(const float4& x, float4& lo) {
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
    return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
}

// d (+)= a b on a warpgroup's m64 x N x k8 tile, fp32 accumulators: d[4 j + e]
// of a thread holds row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 (warp w
// of the warpgroup, lane 4 g + t). scale_d 0 overwrites d. wgmma_ss takes A
// and B as shared-memory images (image_desc); wgmma_rs takes A from
// registers: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the warp's
// 16 rows, k step columns t and t + 4.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The registers of an asynchronous product: the compiler may neither read
// them before this point nor reuse them until it (after wgmma_wait).
template <int N>
__device__ __forceinline__ void hold(float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// Live kv tiles [lo, hi] of the query rows [q0, min(q0 + bq, lq)), row i at
// position qoff + i (ops.flash_kv_tiles).
__device__ __forceinline__ void kv_tiles(int q0, int bq, int bk, int lq, int lk, int causal, int window, int qoff,
                                         int& lo, int& hi) {
    const int p0 = qoff + q0;
    lo = (window > 0 && p0 - window + 1 > 0) ? (p0 - window + 1) / bk : 0;
    hi = (lk - 1) / bk;
    if (causal) hi = min(hi, (qoff + min(q0 + bq, lq) - 1) / bk);
}

// One block per (kv tile, kv head, batch): stage the raw BK x D tile of K
// and of V, then write the images: K as the B operand of S = Q K^T (BK
// rows, k = the D columns), V^T as the B operand of P V (DP rows, k = the
// BK keys, each 8-key chunk in the order 0, 2, 4, 6, 1, 3, 5, 7 that P's
// registers hold them in), each split into a hi and a lo image.
template <int NJ>
__global__ void __launch_bounds__(kSplitThreads)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ kimg,
                float* __restrict__ vimg, int hk, int lk, int d, int ktiles,
                long long ksb, long long ksh, long long ksl, long long vsb, long long vsh, long long vsl, int vec)
{
    using C = Cfg<NJ>;
    constexpr int DP = C::DP, BK = C::BK, R = DP + 4;  // R: rows read 8 apart hit other banks
    __shared__ __align__(16) float ks[BK * R];
    __shared__ __align__(16) float vs[BK * R];
    // the main kernel may launch now: it waits for this grid before reading the images
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const float* kb = k + b * ksb + h * ksh;
    const float* vb = v + b * vsb + h * vsh;
    const int k0 = t * BK;
    if (vec) {  // rows of whole float4s: D, the strides and the bases all multiples of 4 floats
        for (int i = threadIdx.x; i < BK * DP / 4; i += kSplitThreads) {
            const int r = i / (DP / 4), c = 4 * (i % (DP / 4));
            const bool in = k0 + r < lk && c < d;
            const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(ks + r * R + c) =
                in ? *reinterpret_cast<const float4*>(kb + (k0 + r) * ksl + c) : zero;
            *reinterpret_cast<float4*>(vs + r * R + c) =
                in ? *reinterpret_cast<const float4*>(vb + (k0 + r) * vsl + c) : zero;
        }
    } else {
        for (int i = threadIdx.x; i < BK * DP; i += kSplitThreads) {
            const int r = i / DP, c = i % DP;
            const bool in = k0 + r < lk && c < d;
            ks[r * R + c] = in ? kb[(k0 + r) * ksl + c] : 0.f;
            vs[r * R + c] = in ? vb[(k0 + r) * vsl + c] : 0.f;
        }
    }
    __syncthreads();
    const size_t tile = (static_cast<size_t>(b * hk + h) * ktiles + t) * C::kTileFloats;
    float4* ko = reinterpret_cast<float4*>(kimg + tile);
    float4* vo = reinterpret_cast<float4*>(vimg + tile);
    // float4 o of an image holds k 4 (o / 8 % 2) .. + 3 of row 8 (o / 16 % (R / 8)) + o % 8 in k step o / (2 R)
    for (int o = threadIdx.x; o < C::kImageFloats / 4; o += kSplitThreads) {
        const int rr = o & 7, half = (o >> 3) & 1;
        float4 lo;
        {  // K: rows are keys
            const int r = ((o >> 4) % (BK / 8)) * 8 + rr, kk = (o >> 4) / (BK / 8);
            ko[o] = hi4(*reinterpret_cast<const float4*>(ks + r * R + kk * 8 + 4 * half), lo);
            ko[o + C::kImageFloats / 4] = lo;
        }
        {  // V^T: rows are columns of V, k = keys 2 e + half (e = 0..3) of chunk c
            const int dc = ((o >> 4) % (DP / 8)) * 8 + rr, c = (o >> 4) / (DP / 8);
            const float* col = vs + (c * 8 + half) * R + dc;
            vo[o] = hi4(make_float4(col[0], col[2 * R], col[4 * R], col[6 * R]), lo);
            vo[o + C::kImageFloats / 4] = lo;
        }
    }
}

template <int W, bool MAX, int N>
__device__ __forceinline__ float tree(float (&x)[N]) {
    if constexpr (W == 0) {
        return x[0];
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) x[i] = MAX ? fmaxf(x[i], x[i + W]) : x[i] + x[i + W];
        return tree<W / 2, MAX>(x);
    }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ kimg, const float* __restrict__ vimg,
                float* __restrict__ out, const int* __restrict__ work,
                int hq, int hk, int lq, int lk, int d, int qtiles, int ktiles,
                long long qsb, long long qsh, long long qsl,
                long long osb, long long osh, long long osl,
                float scale, int causal, int window, int qoff, int qvec, int ovec)
{
    using C = Cfg<NJ>;
    constexpr int DP = C::DP, KS = C::KS, NT = C::NT, BK = C::BK, IMG = C::kImageFloats;
    constexpr int kTileBytes = C::kTileFloats * static_cast<int>(sizeof(float));
    extern __shared__ __align__(128) unsigned char smem[];
    float* ring = reinterpret_cast<float*>(smem);  // stage s: K hi, K lo, V^T hi, V^T lo images
    float* qsm = reinterpret_cast<float*>(smem + C::kQOffset);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
    uint64_t* empty = full + C::STAGES;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < C::STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int begin = work[blockIdx.x], end = work[blockIdx.x + 1];
    const int* items = work + gridDim.x + 1;
    const int group = hq / hk;

    if (warp >= kConsumers) {  // producer warpgroup: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (warp != kConsumers || lane != 0) return;
        asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split pass's images are written
        int s = 0, phase = 0;
        for (int it = begin; it < end; ++it) {
            const int item = items[it];
            const int qt = item % qtiles, bh = item / qtiles;
            const int h = bh % hq, b = bh / hq;
            int lo, hi;
            kv_tiles(qt * kBQ, kBQ, BK, lq, lk, causal, window, qoff, lo, hi);
            const size_t head = static_cast<size_t>(b * hk + h / group) * ktiles;
            for (int t = lo; t <= hi; ++t) {
                mbar_wait(&empty[s], phase ^ 1);
                mbar_expect(&full[s], 2 * kTileBytes);
                float* stage = ring + s * 2 * C::kTileFloats;
                bulk_load(stage, kimg + (head + t) * C::kTileFloats, kTileBytes, &full[s]);
                bulk_load(stage + C::kTileFloats, vimg + (head + t) * C::kTileFloats, kTileBytes, &full[s]);
                if (++s == C::STAGES) s = 0, phase ^= 1;
            }
        }
        return;
    }

    // consumers: warpgroup wg owns query rows [qg0, qg0 + 64) of each item,
    // its warp w rows [qw0, qw0 + 16)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, tid = threadIdx.x & 127;
    const int g = lane >> 2, tq = lane & 3;
    const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp(s scale) = 2^(s sl2)
    float* qhi = qsm + wg * C::kQFloats;
    float* qlo = qhi + C::kQFloats / 2;
    int s = 0, phase = 0;
    for (int it = begin; it < end; ++it) {
        const int item = items[it];
        const int qt = item % qtiles, bh = item / qtiles;
        const int h = bh % hq, b = bh / hq;
        const int q0 = qt * kBQ, qg0 = q0 + wg * kWGRows, qg_last = qg0 + kWGRows - 1;
        const int qw0 = qg0 + (warp & 3) * 16, qw_last = qw0 + 15;
        int lo, hi;
        kv_tiles(q0, kBQ, BK, lq, lk, causal, window, qoff, lo, hi);

        // this warpgroup's Q rows, split, as the A images of S = Q K^T
        const float* qb = q + b * qsb + h * qsh;
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the previous item's products are done
#pragma unroll 4
        for (int x = tid; x < kWGRows * (DP / 4); x += 128) {
            const int r = x / (DP / 4), c = 4 * (x % (DP / 4));
            float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
            if (qg0 + r < lq && c < d) {
                const float* row = qb + (qg0 + r) * qsl + c;
                if (qvec) {
                    val = *reinterpret_cast<const float4*>(row);
                } else {  // any D, stride and base: element by element
                    val.x = row[0];
                    if (c + 1 < d) val.y = row[1];
                    if (c + 2 < d) val.z = row[2];
                    if (c + 3 < d) val.w = row[3];
                }
            }
            float4 low;
            const int at = image_at<kWGRows>(r, c);
            *reinterpret_cast<float4*>(qhi + at) = hi4(val, low);
            *reinterpret_cast<float4*>(qlo + at) = low;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the tensor cores
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        // where they fit, this warp's fragments of Q as register A operands:
        // rows (g, g + 8) of its 16, columns (t, t + 4) of each k step
        uint32_t qfh[C::kQRegs ? KS : 1][4], qfl[C::kQRegs ? KS : 1][4];
        if constexpr (C::kQRegs) {
            const int r0 = (warp & 3) * 16 + g;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int at = image_at<kWGRows>(r0 + 8 * (e & 1), kk * 8 + tq + 4 * (e >> 1));
                    qfh[kk][e] = __float_as_uint(qhi[at]);
                    qfl[kk][e] = __float_as_uint(qlo[at]);
                }
        }

        float m_r[2] = {kNegBig, kNegBig}, l_r[2] = {0.f, 0.f}, acc[DP / 2];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

        for (int t = lo; t <= hi; ++t) {
            const int k0 = t * BK;
            mbar_wait(&full[s], phase);
            // skip the tile if no row of this warpgroup sees any of its keys
            const bool live = qg0 < lq && (!causal || k0 <= qoff + qg_last) &&
                              (window <= 0 || k0 + BK - 1 > qoff + qg0 - window);
            if (live) {
                const float* khi = ring + s * 2 * C::kTileFloats;
                const float* vhi = khi + C::kTileFloats;

                // S = Q K^T: lo.hi + hi.lo + hi.hi for each k step
                float sacc[BK / 2];
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < KS; ++kk) {
                    const uint64_t kh = image_desc(khi + kk * BK * 8), kl = image_desc(khi + IMG + kk * BK * 8);
                    if constexpr (C::kQRegs) {
                        wgmma_rs<BK>(sacc, qfl[kk], kh, kk > 0);
                        wgmma_rs<BK>(sacc, qfh[kk], kl, 1);
                        wgmma_rs<BK>(sacc, qfh[kk], kh, 1);
                    } else {
                        const uint64_t qh = image_desc(qhi + kk * kWGRows * 8), ql = image_desc(qlo + kk * kWGRows * 8);
                        wgmma_ss<BK>(sacc, ql, kh, kk > 0);
                        wgmma_ss<BK>(sacc, qh, kl, 1);
                        wgmma_ss<BK>(sacc, qh, kh, 1);
                    }
                }
                wgmma_wait();
                hold(sacc);

                // mask (tiles on an edge of this warp's rows only), online
                // softmax in log2 units; row g + 8 r sits in the 4 lanes of
                // group g (xor shuffles 1, 2). On a masked tile the scores are
                // scaled here and masked ones set to -1e30, so that 2^(x - m)
                // is exactly 1 for a row with no live key yet (wiped by the
                // next live tile) and 0 after one.
                const bool masked = k0 + BK > lk || (causal && k0 + BK - 1 > qoff + qw0) ||
                                    (window > 0 && k0 <= qoff + qw_last - window);
                const float mul = masked ? 1.f : sl2;  // what turns sacc into log2 units
                float corr_r[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float mx[2 * NT];
                    if (masked) {
                        const int qi = qoff + qw0 + g + 8 * r;  // the row's position
#pragma unroll
                        for (int j = 0; j < NT; ++j)
#pragma unroll
                            for (int c = 0; c < 2; ++c) {
                                const int kj = k0 + j * 8 + 2 * tq + c;
                                bool in = kj < lk;
                                if (causal) in = in && kj <= qi;
                                if (window > 0) in = in && kj > qi - window;
                                float& x = sacc[4 * j + 2 * r + c];
                                x = in ? x * sl2 : kNegBig;
                                mx[2 * j + c] = x;
                            }
                    } else {
#pragma unroll
                        for (int j = 0; j < NT; ++j)
#pragma unroll
                            for (int c = 0; c < 2; ++c) mx[2 * j + c] = sacc[4 * j + 2 * r + c];
                    }
                    float m = tree<NT, true>(mx) * mul;
                    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
                    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
                    const float m_new = fmaxf(m_r[r], m);
                    corr_r[r] = ex2(m_r[r] - m_new);
                    float ps[2 * NT];
#pragma unroll
                    for (int j = 0; j < NT; ++j)
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            float& x = sacc[4 * j + 2 * r + c];
                            x = ex2(fmaf(x, mul, -m_new));
                            ps[2 * j + c] = x;
                        }
                    l_r[r] = l_r[r] * corr_r[r] + tree<NT, false>(ps);  // this lane's share; summed at the end
                    m_r[r] = m_new;
                }

                // pv = P V, P split into hi parts (in sacc) and lo parts (in
                // pl): key chunk c of P is S's n8 block c, its columns (2t,
                // 2t + 1) taken as the A fragment's k (t, t + 4), which the V^T
                // image holds in that order. The tensor core adds into its
                // accumulator with truncation, so each tile sums into a fresh
                // one and O takes it by an IEEE FFMA with the correction: over
                // thousands of keys one accumulator ends up 5-10x further from
                // float64 than the fp32 plain version.
                float pv[DP / 2], pl[BK / 2];
#pragma unroll
                for (int i = 0; i < BK / 2; ++i) {
                    uint32_t ph, lo;
                    split(sacc[i], ph, lo);
                    sacc[i] = __uint_as_float(ph);
                    pl[i] = __uint_as_float(lo);
                }
                wgmma_fence();  // after the last write of the A registers
#pragma unroll
                for (int c = 0; c < NT; ++c) {
                    const uint32_t ah[4] = {__float_as_uint(sacc[4 * c]), __float_as_uint(sacc[4 * c + 2]),
                                            __float_as_uint(sacc[4 * c + 1]), __float_as_uint(sacc[4 * c + 3])};
                    const uint32_t al[4] = {__float_as_uint(pl[4 * c]), __float_as_uint(pl[4 * c + 2]),
                                            __float_as_uint(pl[4 * c + 1]), __float_as_uint(pl[4 * c + 3])};
                    const uint64_t vh = image_desc(vhi + c * DP * 8), vl = image_desc(vhi + IMG + c * DP * 8);
                    wgmma_rs<DP>(pv, al, vh, c > 0);
                    wgmma_rs<DP>(pv, ah, vl, 1);
                    wgmma_rs<DP>(pv, ah, vh, 1);
                }
                wgmma_wait();
                hold(pv);
                hold(sacc);
                hold(pl);
#pragma unroll
                for (int i = 0; i < DP / 2; ++i) acc[i] = fmaf(acc[i], corr_r[(i >> 1) & 1], pv[i]);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
            if (++s == C::STAGES) s = 0, phase ^= 1;
        }

        float* ob = out + b * osb + h * osh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float l = l_r[r];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            const float inv = 1.f / fmaxf(l, 1e-30f);
            const int qi = qw0 + g + 8 * r;
            if (qi >= lq) continue;
#pragma unroll
            for (int j = 0; j < KS; ++j) {
                const int col = j * 8 + 2 * tq;
                if (col >= d) continue;
                float* o = ob + qi * osl + col;
                const float x0 = acc[4 * j + 2 * r] * inv, x1 = acc[4 * j + 2 * r + 1] * inv;
                if (ovec) {
                    *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
                } else {
                    o[0] = x0;
                    if (col + 1 < d) o[1] = x1;
                }
            }
        }
    }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <int NJ>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* kimg, float* vimg,
                   const int* work, int blocks, int b, int hq, int hk, int lq, int lk, int d,
                   long long qsb, long long qsh, long long qsl,
                   long long ksb, long long ksh, long long ksl,
                   long long vsb, long long vsh, long long vsl,
                   long long osb, long long osh, long long osl,
                   float scale, int causal, int window, int qoff, cudaStream_t stream)
{
    using C = Cfg<NJ>;
    // once per instantiation (the port drives one card)
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kBytes));
    if (attr != cudaSuccess) return attr;
    const int ktiles = (lk + C::BK - 1) / C::BK;
    // vector loads and stores where rows are whole float4s (float2s for the
    // output): D, the strides and the base all multiples of them
    const int kvvec = d % 4 == 0 && aligned(k, 16) && aligned(v, 16) && (ksb | ksh | ksl | vsb | vsh | vsl) % 4 == 0;
    const int qvec = d % 4 == 0 && aligned(q, 16) && (qsb | qsh | qsl) % 4 == 0;
    const int ovec = d % 2 == 0 && aligned(out, 8) && (osb | osh | osl) % 2 == 0;
    split_kv_kernel<NJ><<<dim3(ktiles, hk, b), kSplitThreads, 0, stream>>>(
        k, v, kimg, vimg, hk, lk, d, ktiles, ksb, ksh, ksl, vsb, vsh, vsl, kvvec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // launched as a programmatic dependent of the split pass: its blocks may
    // start (and stage Q) while the last split blocks run
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = C::kBytes;
    cfg.stream = stream;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = pdl;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, flash_kernel<NJ>, q, static_cast<const float*>(kimg),
                             static_cast<const float*>(vimg), out, work, hq, hk, lq, lk, d, (lq + kBQ - 1) / kBQ,
                             ktiles, qsb, qsh, qsl, osb, osh, osl, scale, causal, window, qoff, qvec, ovec);
    return err != cudaSuccess ? err : cudaGetLastError();
}

bool bad_shape(int b, int hq, int hk, int lq, int lk, int d) {
    return b < 1 || hq < 1 || hk < 1 || hq % hk != 0 || lq < 1 || lk < 1 || d < 1 || d > 128;
}

}  // namespace

// q (B, Hq, Lq, D), k and v (B, Hk, Lk, D), out (B, Hq, Lq, D): fp32, unit
// stride along D, element strides for b, h, l; window <= 0: no window; qoff:
// the position of query row 0 (qoff + Lq <= Lk when causal or windowed). kimg
// and vimg: the split images' scratch (B * Hk * ceil(Lk / bk) * bk * DP * 2
// floats each, 16-byte aligned; flash_tiles gives DP and bk). work: the
// work list (int32: blocks + 1 offsets, then the items (b * Hq + h) *
// ceil(Lq / bq) + q tile; block i takes items [work[i], work[i + 1])), built
// for flash_tiles' bq and bk.
extern "C" int flash_attention(const float* q, const float* k, const float* v, float* out,
                               float* kimg, float* vimg, const int* work, int blocks,
                               int b, int hq, int hk, int lq, int lk, int d,
                               long long qsb, long long qsh, long long qsl,
                               long long ksb, long long ksh, long long ksl,
                               long long vsb, long long vsh, long long vsl,
                               long long osb, long long osh, long long osl,
                               float scale, int causal, int window, int qoff, cudaStream_t stream)
{
    if (bad_shape(b, hq, hk, lq, lk, d) || blocks < 1 || !aligned(kimg, 16) || !aligned(vimg, 16) || qoff < 0 ||
        ((causal || window > 0) && static_cast<long long>(qoff) + lq > lk))
        return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_CASE(NJ)                                                                           \
    case NJ:                                                                                           \
        return static_cast<int>(launch<NJ>(q, k, v, out, kimg, vimg, work, blocks, b, hq, hk, lq, lk, d, \
                                           qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl,   \
                                           scale, causal, window, qoff, stream));
    switch ((d + 15) / 16) {
        REPRO_FLASH_CASE(1)
        REPRO_FLASH_CASE(2)
        REPRO_FLASH_CASE(3)
        REPRO_FLASH_CASE(4)
        REPRO_FLASH_CASE(5)
        REPRO_FLASH_CASE(6)
        REPRO_FLASH_CASE(7)
        REPRO_FLASH_CASE(8)
    }
#undef REPRO_FLASH_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}


// -----------------------------------------------------------------------------
// bf16: the TPU kernel's bf16 half. q, k and v bf16 (one dtype), the scores,
// the online softmax and the sums in fp32, out bf16 in q's layout: the same
// function, masks (causal, window, q_offset), GQA and strides as above.
//
// What bounds it: at qwen2's prefill (B 4, Hq 14, L 1000, D 64, causal)
// 7.2 GFLOP against 16 MB of bf16, 7.3 us at 989 TFLOP/s of dense bf16,
// bound by operations. A bf16 x bf16 product is exact in fp32, so S = Q K^T
// is one bf16 pass where the fp32 kernel needs three. P is fp32, as in the
// reference; rounding it to bf16 for P V would add an error of up to 2^-9
// |v| a row, as large as the output's own bf16 rounding on a row of few
// keys. So P is split, P = hi + lo with hi = bf16(P) and lo = bf16(P - hi)
// (16 bits of P kept), and P V is two passes, the small part first: 1.5x
// the products of one pass.
//
// The fp32 kernel's structure, with bf16 operands and no split pass:
// - One persistent block per SM walks the host-built work list
//   (ops.flash_work_list, for this kernel's own bq and bk: flash_tiles with
//   bf16 set), longest walk first.
// - A producer warpgroup, which gives its registers to the consumers
//   (setmaxnreg), keeps a ring of K and V tiles filled. Where K's and V's
//   bases and b/h/l strides are 16-byte multiples, one thread loads each
//   tile as it lies with the tensor memory accelerator (cp.async.bulk.tensor
//   on a 4-D tensor map over the (B, H, L, D) view, 64-column boxes,
//   128-byte swizzle, completing on an mbarrier per slot); elsewhere (D 17,
//   views one element off a 16-byte boundary) the producer's 128 threads
//   stage the same tiles, in the same layout, with plain loads. One flag a
//   launch picks the route. Keys past Lk and columns past D arrive as zeros.
// - Two consumer warpgroups of 64 query rows each. S = Q K^T is
//   wgmma.m64nBKk16 with Q (staged once an item by the warpgroup) and K
//   from shared memory, both K-major. O += P V takes P's hi and lo parts
//   as register A operands straight from the S accumulator (for 16-bit
//   types its layout packs pairwise into the A fragment, so nothing is
//   shuffled) and V as it lies, MN-major, through wgmma's transpose bit
//   for 16-bit B operands: no transposed copy of V is made. The online
//   softmax runs in log2 units (one FFMA and one ex2 a score); one
//   warpgroup's softmax runs beside the other's products. A warpgroup
//   skips the tiles its rows mask out entirely.
// - The kernel is bound by the instructions the consumers issue beside
//   their products, not by the tensor cores: P's split rounds two scores
//   a cvt.rn.bf16x2.f32, and Q's rows are loaded with all of a thread's
//   loads in flight (they stand between one item's products and the next).
// - P V adds into the running O accumulator: the output's bf16 rounding
//   (2^-9) is far above what the tensor core's truncating adds lose over
//   thousands of keys (the h2o-danube case holds the float64 gate).
// - Every row walks its kv tiles in ascending order inside one block, with
//   no atomics: repeated calls give the same bits.
// Shapes per D: the head dim is staged as 64-column slabs of 128-byte rows
// (one slab up to D 64, two above), 128 keys a kv tile at one slab and 64 at
// two (the O accumulator of D 128 and the split P share the registers), up
// to four ring stages, and one m64n64k16 P V product a slab.
// -----------------------------------------------------------------------------
namespace {

constexpr int kB16MaxStages = 4;

template <int NJ>
struct CfgB16 {
    static constexpr int DP = 16 * NJ;                     // head dim padded to k16 steps (S = Q K^T)
    static constexpr int SLABS = (DP + 63) / 64;           // 64-column slabs of 128-byte rows
    static constexpr int BK = SLABS == 1 ? 128 : 64;       // keys of a kv tile
    static constexpr int NT = BK / 8;                      // n8 blocks of S
    static constexpr int PS = BK / 16;                     // k16 steps of P V
    static constexpr int PVN = 64;                         // columns of O one P V product covers
    static constexpr int NPV = SLABS * 64 / PVN;           // P V products a k16 step (each hi and lo)
    static constexpr int kSlabBytes = BK * 128;            // one slab of a K or V tile
    static constexpr int kTileBytes = SLABS * kSlabBytes;  // K (or V) of a tile
    static constexpr int kStageBytes = 2 * kTileBytes;     // K, then V
    static constexpr int kQSlabBytes = kWGRows * 128;
    static constexpr int kQBytes = kWGs * SLABS * kQSlabBytes;
    static constexpr int kFit = (kSmem - 1024 - kQBytes - 2 * kB16MaxStages * 8) / kStageBytes;
    static constexpr int STAGES = kFit < kB16MaxStages ? kFit : kB16MaxStages;
    static constexpr int kQOffset = STAGES * kStageBytes;
    static constexpr int kBarOffset = kQOffset + kQBytes;
    static constexpr int kBytes = kBarOffset + 2 * STAGES * 8 + 1024;  // + 1 KB: the ring starts 1 KB aligned
    static_assert(STAGES >= 2 && kBytes <= kSmem, "Q and two stages fit in shared memory");
};

// Byte offset of element (r, c) of a tile staged as 64-column slabs of
// SLAB bytes, 128-byte rows, 16-byte chunk j of row r at j ^ (r % 8): the
// layout a 128-byte-swizzled tensor box lands in, and the one wgmma reads
// with a 128-byte-swizzle descriptor (slabs 1 KB aligned).
template <int SLAB>
__device__ __forceinline__ int sw128(int r, int c) {
    return (c >> 6) * SLAB + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// A 128-byte-swizzle descriptor: 1 KB between 8-row groups (stride byte
// offset); `lbo` bytes between 64-column atoms of an MN-major operand
// (leading byte offset; a K-major one ignores it).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= a b on a warpgroup's m64 x N x k16 tile, bf16 operands, fp32
// accumulators laid out as wgmma_ss above (d[4 j + e]: row 16 w + g + 8 (e /
// 2), column 8 j + 2 t + e % 2). wgmma_ss_bf16: A and B K-major in shared
// memory. wgmma_rs_bf16_tb: A from registers (rows g, g + 8 of the warp's
// 16; k 2t, 2t + 1, then + 8, the lower index in the lower half), B
// MN-major (transposed), adding into d.
template <int N>
__device__ void wgmma_ss_bf16(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss_bf16<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_bf16<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void hold_u(uint32_t (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

__device__ __forceinline__ uint16_t bf16_bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }

// x0, x1 as bf16 pairs (x0 in the lower half): hi = bf16(x), lo = bf16(x -
// hi), each pair rounded by one cvt.rn.bf16x2.f32
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

union Row8 {  // 8 bf16 of a row: one 16-byte load or store
    uint4 u;
    uint16_t h[8];
};

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_box4(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
        "[%6];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
        : "memory");
}

// Rows [0, ROWS) x columns [0, 64 * SLABS) of a (rows, D) operand whose row
// r is src + r * ld, staged by `nthreads` threads (this one `tid`) in the
// sw128 layout: rows >= `rows` and columns >= d as zeros; 16-byte loads
// where `vec` (D, ld and src multiples of 8 elements), else element by
// element.
template <int ROWS, int SLABS>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const uint16_t* src, long long ld, int rows, int d,
                                           bool vec, int tid, int nthreads) {
    constexpr int kChunks = 8 * SLABS;  // 16-byte chunks of a row
#pragma unroll 4
    for (int i = tid; i < ROWS * kChunks; i += nthreads) {
        const int r = i / kChunks, c = 8 * (i % kChunks);
        Row8 x;
        x.u = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && c < d) {
            const uint16_t* p = src + r * ld + c;
            if (vec) {
                x.u = *reinterpret_cast<const uint4*>(p);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) x.h[e] = c + e < d ? p[e] : 0;
            }
        }
        *reinterpret_cast<uint4*>(dst + sw128<ROWS * 128>(r, c)) = x.u;
    }
}

// This warpgroup's 64 Q rows (row r at src + r * ld), staged as
// stage_rows<kWGRows, SLABS> stages them, with all of a thread's loads in
// flight before its stores: it is on the consumers' path at every item.
template <int SLABS>
__device__ __forceinline__ void stage_q(unsigned char* dst, const uint16_t* src, long long ld, int rows, int d,
                                        bool vec, int tid) {
    constexpr int kChunks = 8 * SLABS, kPer = kWGRows * kChunks / 128;
    Row8 x[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
        const int i = tid + 128 * u, r = i / kChunks, c = 8 * (i % kChunks);
        x[u].u = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && c < d) {
            const uint16_t* p = src + r * ld + c;
            if (vec) {
                x[u].u = *reinterpret_cast<const uint4*>(p);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) x[u].h[e] = c + e < d ? p[e] : 0;
            }
        }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
        const int i = tid + 128 * u;
        *reinterpret_cast<uint4*>(dst + sw128<kWGRows * 128>(i / kChunks, 8 * (i % kChunks))) = x[u].u;
    }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                  uint16_t* __restrict__ out, const int* __restrict__ work,
                  int hq, int hk, int lq, int lk, int d, int qtiles,
                  long long qsb, long long qsh, long long qsl,
                  long long ksb, long long ksh, long long ksl,
                  long long vsb, long long vsh, long long vsl,
                  long long osb, long long osh, long long osl,
                  float scale, int causal, int window, int qoff, int tma, int kvvec, int qvec, int ovec,
                  const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap)
{
    using C = CfgB16<NJ>;
    constexpr int BK = C::BK, NT = C::NT, SLABS = C::SLABS;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    unsigned char* ring = smem;  // stage s: K's slabs, then V's
    unsigned char* qsm = smem + C::kQOffset;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
    uint64_t* empty = full + C::STAGES;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < C::STAGES; ++s) {
            mbar_init(&full[s], tma ? 1 : 128);  // the tensor-map thread, or every producer thread
            mbar_init(&empty[s], kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int begin = work[blockIdx.x], end = work[blockIdx.x + 1];
    const int* items = work + gridDim.x + 1;
    const int group = hq / hk;

    if (warp >= kConsumers) {  // producer warpgroup
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        const int ptid = threadIdx.x - 32 * kConsumers;
        if (tma && ptid != 0) return;
        int s = 0, phase = 0;
        for (int it = begin; it < end; ++it) {
            const int item = items[it];
            const int qt = item % qtiles, bh = item / qtiles;
            const int h = bh % hq, b = bh / hq, kh = h / group;
            int lo, hi;
            kv_tiles(qt * kBQ, kBQ, BK, lq, lk, causal, window, qoff, lo, hi);
            for (int t = lo; t <= hi; ++t) {
                mbar_wait(&empty[s], phase ^ 1);
                unsigned char* kst = ring + s * C::kStageBytes;
                unsigned char* vst = kst + C::kTileBytes;
                if (tma) {
                    mbar_expect(&full[s], C::kStageBytes);
#pragma unroll
                    for (int sl = 0; sl < SLABS; ++sl) {
                        tma_box4(kst + sl * C::kSlabBytes, &kmap, 64 * sl, t * BK, kh, b, &full[s]);
                        tma_box4(vst + sl * C::kSlabBytes, &vmap, 64 * sl, t * BK, kh, b, &full[s]);
                    }
                } else {
                    const int k0 = t * BK;
                    stage_rows<BK, SLABS>(kst, k + b * ksb + kh * ksh + k0 * ksl, ksl, lk - k0, d, kvvec, ptid, 128);
                    stage_rows<BK, SLABS>(vst, v + b * vsb + kh * vsh + k0 * vsl, vsl, lk - k0, d, kvvec, ptid, 128);
                    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the tensor cores
                    mbar_arrive(&full[s]);
                }
                if (++s == C::STAGES) s = 0, phase ^= 1;
            }
        }
        return;
    }

    // consumers: warpgroup wg owns query rows [qg0, qg0 + 64) of each item,
    // its warp w rows [qw0, qw0 + 16)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, tid = threadIdx.x & 127;
    const int g = lane >> 2, tq = lane & 3;
    const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp(s scale) = 2^(s sl2)
    unsigned char* qwg = qsm + wg * SLABS * C::kQSlabBytes;
    int s = 0, phase = 0;
    for (int it = begin; it < end; ++it) {
        const int item = items[it];
        const int qt = item % qtiles, bh = item / qtiles;
        const int h = bh % hq, b = bh / hq;
        const int q0 = qt * kBQ, qg0 = q0 + wg * kWGRows, qg_last = qg0 + kWGRows - 1;
        const int qw0 = qg0 + (warp & 3) * 16, qw_last = qw0 + 15;
        int lo, hi;
        kv_tiles(q0, kBQ, BK, lq, lk, causal, window, qoff, lo, hi);

        // this warpgroup's Q rows, the A operand of S = Q K^T
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the previous item's products are done
        stage_q<SLABS>(qwg, q + b * qsb + h * qsh + qg0 * qsl, qsl, lq - qg0, d, qvec, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the tensor cores
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

        constexpr int NPV = C::NPV, PVN = C::PVN;
        float m_r[2] = {kNegBig, kNegBig}, l_r[2] = {0.f, 0.f}, acc[NPV][PVN / 2];
#pragma unroll
        for (int n = 0; n < NPV; ++n)
#pragma unroll
            for (int i = 0; i < PVN / 2; ++i) acc[n][i] = 0.f;

        for (int t = lo; t <= hi; ++t) {
            const int k0 = t * BK;
            mbar_wait(&full[s], phase);
            // skip the tile if no row of this warpgroup sees any of its keys
            const bool live = qg0 < lq && (!causal || k0 <= qoff + qg_last) &&
                              (window <= 0 || k0 + BK - 1 > qoff + qg0 - window);
            if (live) {
                const unsigned char* kst = ring + s * C::kStageBytes;
                const unsigned char* vst = kst + C::kTileBytes;

                // S = Q K^T: one bf16 pass, k16 steps of 32 bytes inside a slab
                float sacc[BK / 2];
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < NJ; ++kk) {
                    const int off = (kk & 3) * 32;
                    wgmma_ss_bf16<BK>(sacc, sw128_desc(qwg + (kk >> 2) * C::kQSlabBytes + off, 16),
                                      sw128_desc(kst + (kk >> 2) * C::kSlabBytes + off, 16), kk > 0);
                }
                wgmma_wait();
                hold(sacc);

                // mask (tiles on an edge of this warp's rows only), online
                // softmax in log2 units; row g + 8 r sits in the 4 lanes of
                // group g. A masked score is the finite -1e30, as in the
                // reference: a row with no live key yet gets 2^0 junk, which
                // the next live tile's correction 2^(-1e30 - m) = 0 wipes.
                const bool masked = k0 + BK > lk || (causal && k0 + BK - 1 > qoff + qw0) ||
                                    (window > 0 && k0 <= qoff + qw_last - window);
                const float mul = masked ? 1.f : sl2;  // what turns sacc into log2 units
                float corr_r[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float mx[2 * NT];
                    if (masked) {
                        const int qi = qoff + qw0 + g + 8 * r;  // the row's position
#pragma unroll
                        for (int j = 0; j < NT; ++j)
#pragma unroll
                            for (int c = 0; c < 2; ++c) {
                                const int kj = k0 + j * 8 + 2 * tq + c;
                                bool in = kj < lk;
                                if (causal) in = in && kj <= qi;
                                if (window > 0) in = in && kj > qi - window;
                                float& x = sacc[4 * j + 2 * r + c];
                                x = in ? x * sl2 : kNegBig;
                                mx[2 * j + c] = x;
                            }
                    } else {
#pragma unroll
                        for (int j = 0; j < NT; ++j)
#pragma unroll
                            for (int c = 0; c < 2; ++c) mx[2 * j + c] = sacc[4 * j + 2 * r + c];
                    }
                    float m = tree<NT, true>(mx) * mul;
                    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
                    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
                    const float m_new = fmaxf(m_r[r], m);
                    corr_r[r] = ex2(m_r[r] - m_new);
                    float ps[2 * NT];
#pragma unroll
                    for (int j = 0; j < NT; ++j)
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            float& x = sacc[4 * j + 2 * r + c];
                            x = ex2(fmaf(x, mul, -m_new));
                            ps[2 * j + c] = x;
                        }
                    l_r[r] = l_r[r] * corr_r[r] + tree<NT, false>(ps);  // this lane's share; summed at the end
                    m_r[r] = m_new;
                }

                // O = O corr + P V, P = hi + lo: keys 16 c .. 16 c + 15 of P
                // are S's n8 blocks 2 c and 2 c + 1, already in the A
                // fragment's order; product n gives O's columns PVN n ..
                uint32_t ph[C::PS][4], pl[C::PS][4];
#pragma unroll
                for (int c = 0; c < C::PS; ++c)
#pragma unroll
                    for (int e = 0; e < 4; ++e) split_bf16(sacc[8 * c + 2 * e], sacc[8 * c + 2 * e + 1], ph[c][e], pl[c][e]);
#pragma unroll
                for (int n = 0; n < NPV; ++n)
#pragma unroll
                    for (int i = 0; i < PVN / 2; ++i) acc[n][i] *= corr_r[(i >> 1) & 1];
                wgmma_fence();  // after the last write of the A and accumulator registers
#pragma unroll
                for (int c = 0; c < C::PS; ++c)
#pragma unroll
                    for (int n = 0; n < NPV; ++n) {
                        const uint64_t vd = sw128_desc(vst + n * (PVN / 64) * C::kSlabBytes + c * 16 * 128, C::kSlabBytes);
                        wgmma_rs_bf16_tb(acc[n], pl[c], vd);  // the small part first
                        wgmma_rs_bf16_tb(acc[n], ph[c], vd);
                    }
                wgmma_wait();
#pragma unroll
                for (int n = 0; n < NPV; ++n) hold(acc[n]);
#pragma unroll
                for (int c = 0; c < C::PS; ++c) {
                    hold_u(ph[c]);
                    hold_u(pl[c]);
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
            if (++s == C::STAGES) s = 0, phase ^= 1;
        }

        uint16_t* ob = out + b * osb + h * osh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float l = l_r[r];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            const float inv = 1.f / fmaxf(l, 1e-30f);
            const int qi = qw0 + g + 8 * r;
            if (qi >= lq) continue;
#pragma unroll
            for (int n = 0; n < NPV; ++n)
#pragma unroll
                for (int j = 0; j < PVN / 8; ++j) {
                    const int col = PVN * n + 8 * j + 2 * tq;
                    if (col >= d) continue;
                    uint16_t* o = ob + qi * osl + col;
                    const uint16_t x0 = bf16_bits(acc[n][4 * j + 2 * r] * inv), x1 = bf16_bits(acc[n][4 * j + 2 * r + 1] * inv);
                    if (ovec) {
                        *reinterpret_cast<uint32_t*>(o) = x0 | (static_cast<uint32_t>(x1) << 16);
                    } else {
                        o[0] = x0;
                        if (col + 1 < d) o[1] = x1;
                    }
                }
        }
    }
}

// cuTensorMapEncodeTiled, looked up through the runtime, so the library
// links against no libcuda stub.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t rc =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// A bf16 (B, H, L, D) view with element strides sb, sh, sl, read in boxes
// of 64 columns x bk rows, 128-byte swizzle; false if the encoder refuses
// it. A dimension of size 1 takes the stride that makes it dense (its
// stride is never stepped). Remembered: a map depends only on its
// arguments, and encoding one costs the host more than the launch.
bool kv_map(CUtensorMap* map, const void* base, int d, int l, int h, int b, long long sl, long long sh,
            long long sb, int bk) {
    struct Key {
        const void* base;
        int d, l, h, b, bk;
        long long sl, sh, sb;
    };
    constexpr int kSlots = 64;
    static std::mutex mu;
    static Key keys[kSlots];
    static CUtensorMap maps[kSlots];
    static int used = 0, next = 0;
    const Key key{base, d, l, h, b, bk, sl, sh, sb};
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
        const Key& x = keys[i];
        if (x.base == base && x.d == d && x.l == l && x.h == h && x.b == b && x.bk == bk && x.sl == sl &&
            x.sh == sh && x.sb == sb) {
            *map = maps[i];
            return true;
        }
    }
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return false;
    const long long s1 = l > 1 ? sl : d, s2 = h > 1 ? sh : s1 * l, s3 = b > 1 ? sb : s2 * h;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)l, (cuuint64_t)h, (cuuint64_t)b};
    const cuuint64_t strides[3] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2, (cuuint64_t)s3 * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)bk, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return false;
    keys[next] = key;
    maps[next] = *map;
    next = (next + 1) % kSlots;
    if (used < kSlots) ++used;
    return true;
}

// A stride of a dimension that is stepped (size > 1) must be a multiple of
// `elems`; one of size 1 never is.
bool strided(long long stride, int size, int elems) { return size == 1 || stride % elems == 0; }

template <int NJ>
cudaError_t launch_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v, uint16_t* out, const int* work,
                        int blocks, int b, int hq, int hk, int lq, int lk, int d,
                        long long qsb, long long qsh, long long qsl,
                        long long ksb, long long ksh, long long ksl,
                        long long vsb, long long vsh, long long vsl,
                        long long osb, long long osh, long long osl,
                        float scale, int causal, int window, int qoff, cudaStream_t stream)
{
    using C = CfgB16<NJ>;
    // once per instantiation (the port drives one card)
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bf16_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kBytes));
    if (attr != cudaSuccess) return attr;
    // tensor boxes where K's and V's bases and stepped strides are 16-byte
    // multiples (8 bf16); 16-byte loads of Q, K and V rows where D is too
    const bool kv16 = aligned(k, 16) && aligned(v, 16) && strided(ksl, lk, 8) && strided(ksh, hk, 8) &&
                      strided(ksb, b, 8) && strided(vsl, lk, 8) && strided(vsh, hk, 8) && strided(vsb, b, 8);
    const int kvvec = kv16 && d % 8 == 0;
    const int qvec = d % 8 == 0 && aligned(q, 16) && strided(qsl, lq, 8) && strided(qsh, hq, 8) && strided(qsb, b, 8);
    const int ovec = d % 2 == 0 && aligned(out, 4) && strided(osl, lq, 2) && strided(osh, hq, 2) && strided(osb, b, 2);
    CUtensorMap kmap{}, vmap{};
    const int tma = kv16 && kv_map(&kmap, k, d, lk, hk, b, ksl, ksh, ksb, C::BK) &&
                    kv_map(&vmap, v, d, lk, hk, b, vsl, vsh, vsb, C::BK);
    flash_bf16_kernel<NJ><<<blocks, kThreads, C::kBytes, stream>>>(
        q, k, v, out, work, hq, hk, lq, lk, d, (lq + kBQ - 1) / kBQ, qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl,
        osb, osh, osl, scale, causal, window, qoff, tma, kvvec, qvec, ovec, kmap, vmap);
    return cudaGetLastError();
}

}  // namespace

// q (B, Hq, Lq, D), k and v (B, Hk, Lk, D), out (B, Hq, Lq, D): bf16 (their
// bits as uint16), unit stride along D, element strides for b, h, l; window
// <= 0: no window; qoff: the position of query row 0 (qoff + Lq <= Lk when
// causal or windowed). work: the work list, as flash_attention's, built for
// flash_tiles(d, field, 1)'s bq and bk. No scratch.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, const int* work,
                                    int blocks, int b, int hq, int hk, int lq, int lk, int d,
                                    long long qsb, long long qsh, long long qsl,
                                    long long ksb, long long ksh, long long ksl,
                                    long long vsb, long long vsh, long long vsl,
                                    long long osb, long long osh, long long osl,
                                    float scale, int causal, int window, int qoff, cudaStream_t stream)
{
    if (bad_shape(b, hq, hk, lq, lk, d) || blocks < 1 || qoff < 0 ||
        ((causal || window > 0) && static_cast<long long>(qoff) + lq > lk))
        return static_cast<int>(cudaErrorInvalidValue);
    const uint16_t *q16 = static_cast<const uint16_t*>(q), *k16 = static_cast<const uint16_t*>(k),
                   *v16 = static_cast<const uint16_t*>(v);
    uint16_t* o16 = static_cast<uint16_t*>(out);
#define REPRO_FLASH_BF16_CASE(NJ)                                                                              \
    case NJ:                                                                                                   \
        return static_cast<int>(launch_bf16<NJ>(q16, k16, v16, o16, work, blocks, b, hq, hk, lq, lk, d, qsb, qsh, \
                                                qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl, scale, causal,  \
                                                window, qoff, stream));
    switch ((d + 15) / 16) {
        REPRO_FLASH_BF16_CASE(1)
        REPRO_FLASH_BF16_CASE(2)
        REPRO_FLASH_BF16_CASE(3)
        REPRO_FLASH_BF16_CASE(4)
        REPRO_FLASH_BF16_CASE(5)
        REPRO_FLASH_BF16_CASE(6)
        REPRO_FLASH_BF16_CASE(7)
        REPRO_FLASH_BF16_CASE(8)
    }
#undef REPRO_FLASH_BF16_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

// The tiles for head dim d of the fp32 kernel (bf16 0) or the bf16 one
// (bf16 1): field 0 the padded D, 1 the kv tile (bk), 2 the query rows a
// block owns (bq); -1 for d or field out of range.
extern "C" int flash_tiles(int d, int field, int bf16)
{
    if (d < 1 || d > 128 || field < 0 || field > 2) return -1;
#define REPRO_FLASH_TILES(NJ)                                                                               \
    case NJ:                                                                                                \
        return field == 0 ? Cfg<NJ>::DP : field == 2 ? kBQ : bf16 ? CfgB16<NJ>::BK : Cfg<NJ>::BK;
    switch ((d + 15) / 16) {
        REPRO_FLASH_TILES(1)
        REPRO_FLASH_TILES(2)
        REPRO_FLASH_TILES(3)
        REPRO_FLASH_TILES(4)
        REPRO_FLASH_TILES(5)
        REPRO_FLASH_TILES(6)
        REPRO_FLASH_TILES(7)
        REPRO_FLASH_TILES(8)
    }
#undef REPRO_FLASH_TILES
    return -1;
}
