// Causal / sliding-window GQA flash attention for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:102
// (`flash_attention`, whose `_flash_kernel` carries the running fp32
// (m, l, acc) in VMEM scratch across a sequential kv grid axis). Here blocks
// run in parallel and in no order, so one block owns a tile of kBQ query rows
// of one (batch, query head) and walks every live kv tile itself, in
// ascending order: the result is deterministic, and (m, l, acc) live in
// registers for the whole walk. Output is written once.
//
//   out[b, h, i, :] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,h/g,j,:]) v[b,h/g,j,:]
//
// over the unmasked j: j < Lk; j <= i when causal; j > i - window with a
// window. Query head h reads kv head h / group (group = Hq / Hk, any
// integer: qwen2's is 7), so GQA needs no replicated K/V.
//
// What bounds it: at the serve path's shape (B 4, Hq 14, L 1000, D 64,
// causal) the work is ~4 * B * Hq * D * L^2 / 2 = 7.2 GFLOP against 15 MB of
// q/k/v/out, so it is bound by operations: ~0.11 ms at the H100's 67 TFLOP/s
// of fp32 on CUDA cores (TF32 stays off: the port is held to fp32 parity).
// The design serves that bound with register tiling: 256 threads as a 16x16
// grid, each owning a 4x4 block of the (kBQ x kBK) score tile and a 4 x D/16
// block of the output. Both products read float4 runs from shared memory,
// eight loads per 64 FMAs for S = Q K^T. Rows and columns a thread owns are
// strided by 16 and the shared tiles padded, so the loads are free of bank
// conflicts. Tiles that the causal or window mask rules out entirely are
// never visited, so windowed attention costs O(L * W).
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
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // kv rows per tile
constexpr int kThreads = 256;           // 16 x 16 threads
constexpr int kPadP = kBK + 16;         // row length of the P tile
constexpr float kNegBig = -1e30f;

// Head dim padded to DP = 16 * NJ (each thread owns NJ output columns);
// the Q/K tiles' rows are DP + 4 floats long: a multiple of 4 (float4
// loads) with an odd number of 16-byte groups (no bank conflicts).
template <int NJ>
struct Tiles {
    static constexpr int DP = 16 * NJ;
    static constexpr int R = DP + 4;
    static constexpr int kQ = 0;                      // q  [kBQ][R]
    static constexpr int kK = kQ + kBQ * R;           // k  [kBK][R]
    static constexpr int kV = kK + kBK * R;           // v  [kBK][DP]
    static constexpr int kP = kV + kBK * DP;          // p  [kBQ][kPadP]
    static constexpr int kFloats = kP + kBQ * kPadP;
    static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int NJ>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ out, int group, int lq, int lk, int d,
             long long qsb, long long qsh, long long qsl,
             long long ksb, long long ksh, long long ksl,
             long long vsb, long long vsh, long long vsl,
             long long osb, long long osh, long long osl,
             float scale, int causal, int window)
{
    using T = Tiles<NJ>;
    constexpr int DP = T::DP, R = T::R;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* qs = smem + T::kQ;
    float* ks = smem + T::kK;
    float* vs = smem + T::kV;
    float* ps = smem + T::kP;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int qt = gridDim.x - 1 - blockIdx.x;  // causal: the longest walks start first
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = qt * kBQ;
    const int q_rows = min(kBQ, lq - q0);
    const float* qb = q + b * qsb + h * qsh;
    const float* kb = k + b * ksb + (h / group) * ksh;
    const float* vb = v + b * vsb + (h / group) * vsh;

    for (int i = tid; i < kBQ * DP; i += kThreads) {
        const int r = i / DP, c = i % DP;
        qs[r * R + c] = (r < q_rows && c < d) ? qb[(q0 + r) * qsl + c] : 0.f;
    }

    // live kv tiles: [t_lo, t_hi]
    const int q_last = q0 + q_rows - 1;
    int t_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / kBK;
    int t_hi = (lk - 1) / kBK;
    if (causal) t_hi = min(t_hi, q_last / kBK);

    float m_r[4], l_r[4], acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_r[i] = kNegBig;
        l_r[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }

    for (int t = t_lo; t <= t_hi; ++t) {
        const int k0 = t * kBK;
        __syncthreads();  // the previous tile's K, V and P are consumed
        for (int i = tid; i < kBK * DP; i += kThreads) {
            const int r = i / DP, c = i % DP;
            const bool in = k0 + r < lk && c < d;
            ks[r * R + c] = in ? kb[(k0 + r) * ksl + c] : 0.f;
            vs[r * DP + c] = in ? vb[(k0 + r) * vsl + c] : 0.f;
        }
        __syncthreads();

        // S = Q K^T: rows ty + 16 i, columns tx + 16 j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < DP; c += 4) {
            float4 a[4], bk[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * R + c);
#pragma unroll
            for (int j = 0; j < 4; ++j) bk[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * R + c);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
                    s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
                    s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
                    s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
                }
        }

        // scale, mask, online softmax; a row's 64 scores sit in the 16
        // threads of one half-warp (same ty), reduced with xor shuffles
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qi = q0 + ty + 16 * i;
            float mx = kNegBig;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kj = k0 + tx + 16 * j;
                bool live = kj < lk;
                if (causal) live = live && kj <= qi;
                if (window > 0) live = live && kj > qi - window;
                s[i][j] = live ? s[i][j] * scale : kNegBig;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_r[i], mx);
            const float corr = expf(m_r[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                sum += s[i][j];
                ps[(ty + 16 * i) * kPadP + tx + 16 * j] = s[i][j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l_r[i] = l_r[i] * corr + sum;
            m_r[i] = m_new;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
        }
        __syncthreads();

        // acc += P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll 2
        for (int c = 0; c < kBK; c += 4) {
            float4 p4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPadP + c);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float v0 = vs[(c + 0) * DP + tx + 16 * j];
                const float v1 = vs[(c + 1) * DP + tx + 16 * j];
                const float v2 = vs[(c + 2) * DP + tx + 16 * j];
                const float v3 = vs[(c + 3) * DP + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    float a = acc[i][j];
                    a = fmaf(p4[i].x, v0, a);
                    a = fmaf(p4[i].y, v1, a);
                    a = fmaf(p4[i].z, v2, a);
                    a = fmaf(p4[i].w, v3, a);
                    acc[i][j] = a;
                }
            }
        }
    }

    float* ob = out + b * osb + h * osh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= q_rows) continue;
        const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int c = tx + 16 * j;
            if (c < d) ob[(q0 + r) * osl + c] = acc[i][j] * inv;
        }
    }
}

template <int NJ>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int b, int hq, int hk, int lq, int lk, int d,
                   long long qsb, long long qsh, long long qsl,
                   long long ksb, long long ksh, long long ksl,
                   long long vsb, long long vsh, long long vsl,
                   long long osb, long long osh, long long osl,
                   float scale, int causal, int window, cudaStream_t stream)
{
    constexpr size_t bytes = Tiles<NJ>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(flash_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((lq + kBQ - 1) / kBQ, hq, b);
    flash_kernel<NJ><<<grid, kThreads, bytes, stream>>>(
        q, k, v, out, hq / hk, lq, lk, d, qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl,
        scale, causal, window);
    return cudaGetLastError();
}

}  // namespace

// q (B, Hq, Lq, D), k and v (B, Hk, Lk, D), out (B, Hq, Lq, D): fp32, unit
// stride along D, element strides for b, h, l. window <= 0: no window.
extern "C" int flash_attention(const float* q, const float* k, const float* v, float* out,
                               int b, int hq, int hk, int lq, int lk, int d,
                               long long qsb, long long qsh, long long qsl,
                               long long ksb, long long ksh, long long ksl,
                               long long vsb, long long vsh, long long vsl,
                               long long osb, long long osh, long long osl,
                               float scale, int causal, int window, cudaStream_t stream)
{
    if (b < 1 || hq < 1 || hk < 1 || hq % hk != 0 || lq < 1 || lk < 1 || d < 1 || d > 128)
        return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_CASE(NJ)                                                                       \
    case NJ:                                                                                       \
        return static_cast<int>(launch<NJ>(q, k, v, out, b, hq, hk, lq, lk, d, qsb, qsh, qsl, ksb, \
                                           ksh, ksl, vsb, vsh, vsl, osb, osh, osl, scale, causal,  \
                                           window, stream));
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
