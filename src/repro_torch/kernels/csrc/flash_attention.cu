// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:82
// flash_attention (body _flash_kernel). q is (B, S, H, hd), k and v are
// (B, S, Hkv, hd) with H = G.Hkv; query head h reads KV head h / G. The
// output o (B, S, H, hd) has q's dtype (float32 or bfloat16).
//
// What it computes, as the TPU kernel: s = q.k * hd^-0.5 in f32 under the
// causal mask kv_pos <= q_pos (and kv_pos < S); an online softmax with a
// running max m and denominator l in f32 and an f32 accumulator; masked
// probabilities are set to 0 again, so a fully masked stretch of keys adds
// nothing; for bf16 inputs p is rounded to bf16 before the PV product (the
// TPU kernel's p.astype(v.dtype)); o = acc / max(l, 1e-30).
//
// What bounds it on this card: operations. The causal work is
// 2.2.B.H.hd.S^2/2 flops against (q + k + v + o) bytes read or written
// once; at the llama3-8b layer shape (B 2, S 4096, H 32, Hkv 8, hd 128)
// that is 275 GFLOP against 168 MB (bf16), about 1,600 flops per byte.
// This first kernel runs on the CUDA cores in f32 (67 TFLOP/s), the only
// way to meet the f32 tolerance of 2e-5; mma/wgmma for bf16 is later work.
//
// What the design does about it:
//  - A thread block owns one output tile: the BQ query positions of one q
//    tile for all G query heads that read one KV head (G.BQ rows). Each
//    K/V tile (64 keys) is staged once in shared memory, as float, and
//    reused by those G.BQ rows, so K/V are never repeated per query head
//    (the TPU kernel stacks the G groups row-wise for the same reason).
//  - The KV loop of a q tile ends at its diagonal: keys past the tile's
//    last position are never loaded. (The TPU kernel runs the fully
//    masked blocks, about twice the flops.) The ragged S edge is masked
//    in the kernel; nothing is padded or copied.
//  - hd is split over TPR = max(1, hd / 32) adjacent lanes; a lane holds
//    its 4-float chunks j.TPR + sub of q and of the accumulator in
//    registers (interleaved, so the TPR lanes of a row read 16 B each of
//    one contiguous key row: no bank conflicts, and the rows of a warp
//    share it by broadcast). q.k is reduced over the TPR lanes by
//    shuffles in a fixed order.
//  - Keys are taken 16 at a time: one max, one rescale of l and the
//    accumulator per 16 keys.
//  - Tiles are launched heaviest (last) first, so the diagonal's
//    imbalance does not leave a tail.
// Every output is written once by the block that owns it, with no atomics,
// so results repeat bit for bit.
//
// The entry point returns cudaGetLastError() after its launch (or the
// error of cudaFuncSetAttribute, which dynamic shared memory above 48 KB
// needs: at hd 128 a K/V tile pair is 64 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;          // keys per staged K/V tile
constexpr int kCH = 16;          // keys per softmax step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}
// p as the PV product sees it: rounded to the inputs' dtype
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16(p));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int Hkv, int G, int GB, int BQ, int n_qt,
                 int n_bh, float scale) {
    constexpr int TPR = HD <= 32 ? 1 : HD / 32;   // lanes per row
    constexpr int DPT = HD / TPR;                 // dims per lane
    constexpr int NV = DPT / 4;                   // float4 chunks per lane
    extern __shared__ float4 smem4[];
    float4* sK = smem4;                           // (kBK, HD / 4)
    float4* sV = smem4 + kBK * HD / 4;

    const int bid = blockIdx.x;
    const int qt = n_qt - 1 - bid / n_bh;         // heaviest tiles first
    const int bh = bid % n_bh;
    const int n_gr = (G + GB - 1) / GB;
    const int gr = bh % n_gr;
    const int kvh = (bh / n_gr) % Hkv;
    const int b = bh / (n_gr * Hkv);
    const int t = threadIdx.x;
    const int row = t / TPR, sub = t % TPR;
    const int qi = row / GB, g = gr * GB + row % GB;
    const int q0 = qt * BQ;
    const int qpos = q0 + qi;
    const bool live = qi < BQ && g < G && qpos < S;
    const int h = kvh * G + g;

    float qr[DPT], acc[DPT];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int64_t base = ((int64_t(b) * S + qpos) * H + h) * HD
                             + 4 * (j * TPR + sub);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            qr[4 * j + e] = live ? to_float(q[base + e]) : 0.f;
            acc[4 * j + e] = 0.f;
        }
    }
    float m = kNegInf, l = 0.f;

    const int kv_end = min(S, q0 + BQ);           // keys past it are masked
    const int64_t kv_stride = int64_t(Hkv) * HD;
    const T* kb = k + (int64_t(b) * S * Hkv + kvh) * HD;
    const T* vb = v + (int64_t(b) * S * Hkv + kvh) * HD;
    float* sKf = reinterpret_cast<float*>(sK);
    float* sVf = reinterpret_cast<float*>(sV);

    for (int k0 = 0; k0 < kv_end; k0 += kBK) {
        const int nk = min(kBK, kv_end - k0);
        __syncthreads();                          // the last tile is used
        for (int i = t; i < kBK * HD; i += kThreads) {
            const int key = i / HD, d = i % HD;
            float kx = 0.f, vx = 0.f;             // zero past the tile's end
            if (key < nk) {
                const int64_t off = int64_t(k0 + key) * kv_stride + d;
                kx = to_float(kb[off]);
                vx = to_float(vb[off]);
            }
            sKf[i] = kx;
            sVf[i] = vx;
        }
        __syncthreads();
        for (int c0 = 0; c0 < nk; c0 += kCH) {
            float s[kCH];
            float mx = kNegInf;
#pragma unroll
            for (int c = 0; c < kCH; ++c) {
                const float4* kr = sK + (c0 + c) * (HD / 4);
                float dot = 0.f;
#pragma unroll
                for (int j = 0; j < NV; ++j) {
                    const float4 kk = kr[j * TPR + sub];
                    dot += qr[4 * j] * kk.x + qr[4 * j + 1] * kk.y
                           + qr[4 * j + 2] * kk.z + qr[4 * j + 3] * kk.w;
                }
#pragma unroll
                for (int off = 1; off < TPR; off <<= 1)
                    dot += __shfl_xor_sync(0xffffffffu, dot, off);
                const int kv = k0 + c0 + c;
                const bool ok = c0 + c < nk && kv <= qpos && kv < S;
                s[c] = ok ? dot * scale : kNegInf;
                mx = fmaxf(mx, s[c]);
            }
            const float m_new = fmaxf(m, mx);
            const float corr = expf(m - m_new);
            l *= corr;
#pragma unroll
            for (int d = 0; d < DPT; ++d) acc[d] *= corr;
#pragma unroll
            for (int c = 0; c < kCH; ++c) {
                const int kv = k0 + c0 + c;
                const bool ok = c0 + c < nk && kv <= qpos && kv < S;
                const float p = ok ? expf(s[c] - m_new) : 0.f;
                l += p;
                const float pb = round_p(p, T());
                const float4* vr = sV + (c0 + c) * (HD / 4);
#pragma unroll
                for (int j = 0; j < NV; ++j) {
                    const float4 vv = vr[j * TPR + sub];
                    acc[4 * j] += pb * vv.x;
                    acc[4 * j + 1] += pb * vv.y;
                    acc[4 * j + 2] += pb * vv.z;
                    acc[4 * j + 3] += pb * vv.w;
                }
            }
            m = m_new;
        }
    }
    if (!live) return;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int64_t base = ((int64_t(b) * S + qpos) * H + h) * HD
                             + 4 * (j * TPR + sub);
#pragma unroll
        for (int e = 0; e < 4; ++e)
            o[base + e] = from_float<T>(acc[4 * j + e] * inv);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, float scale, cudaStream_t stream) {
    constexpr int TPR = HD <= 32 ? 1 : HD / 32;
    const int G = H / Hkv;
    const int rows = kThreads / TPR;
    const int GB = G < rows ? G : rows;           // query heads per block
    const int BQ = rows / GB;                     // positions per block
    const int n_gr = (G + GB - 1) / GB;
    const int n_qt = (S + BQ - 1) / BQ;
    const int n_bh = B * Hkv * n_gr;
    const size_t smem = 2 * size_t(kBK) * HD * sizeof(float);
    auto kernel = flash_fwd_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    const int64_t blocks = int64_t(n_qt) * n_bh;
    kernel<<<unsigned(blocks), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, G, GB, BQ,
        n_qt, n_bh, scale);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int hd, float scale, cudaStream_t s) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 32: return launch<T, 32>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hkv, scale, s);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd); k, v: (B, S, Hkv, hd); all contiguous, of one dtype
// (bf16 when is_bf16, else float32); H a multiple of Hkv; hd in
// {16, 32, 64, 128}.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int S, int H, int Hkv, int hd,
                        int is_bf16, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd, scale,
                                       s);
    return dispatch<float>(q, k, v, o, B, S, H, Hkv, hd, scale, s);
}

}  // extern "C"
