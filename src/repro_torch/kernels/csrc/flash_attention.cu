// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:82
// flash_attention (body _flash_kernel). q is (B, S, H, hd), k and v are
// (B, S, Hkv, hd) with H = G.Hkv; query head h reads KV head h / G. The
// output o (B, S, H, hd) has q's dtype (float32, bfloat16 or float16).
//
// What it computes, as the TPU kernel: s = q.k * hd^-0.5 in f32 under the
// causal mask kv_pos <= q_pos (and kv_pos < S); an online softmax with a
// running max m and denominator l in f32 and an f32 accumulator; masked
// probabilities are set to 0 again, so a fully masked stretch of keys adds
// nothing; for bf16 (f16) inputs p is rounded to bf16 (f16) before the PV
// product (the TPU kernel's p.astype(v.dtype)); o = acc / max(l, 1e-30).
//
// What bounds it on this card: operations. The causal work is
// 2.2.B.H.hd.S^2/2 flops against (q + k + v + o) bytes read or written
// once; at the llama3-8b layer shape (B 2, S 4096, H 32, Hkv 8, hd 128)
// that is 275 GFLOP against 168 MB (bf16), about 1,600 flops per byte.
// Two kernels, one per kind of dtype:
//  - bf16 and f16: flash_mma_kernel<HD, T>, on the tensor cores (989
//    TFLOP/s either way); the two instances differ only in the mma's input
//    type and in how p and o are rounded. It takes hd in {16, 32, 64,
//    128}. flash_mma_wide_kernel<W, T> takes the padded 256, 384 and 512:
//    its warps split O's columns and the scores are computed once at the
//    full width (its section below). Heads past 512 take a 16-bit
//    column-chunk kernel (flash_mma_chunk_kernel) at any multiple of 128.
//  - f32: flash_f32_kernel<HD>, register-tiled FFMA on the CUDA cores (67
//    TFLOP/s), the only way to meet the reference's f32 tolerance of 2e-5
//    (TF32 would not); hd in {16, 32, 64, 128, 256, 384, 512}, the scores
//    computed once at the full width (its section below says what bounds
//    it: the shared-memory pipe). Past 512, up to 4096, a thread-block
//    cluster of at most 16 blocks (flash_f32_cluster_kernel<BW>, each
//    block owning BW = 128 of O's columns up to hd 2048 and 256 above)
//    splits O's columns and still computes the scores once; past 4096 an
//    f32 column-chunk kernel (flash_f32_wide_kernel), a choice by width
//    made before the launch.
//
// What both do about it:
//  - A thread block owns one output tile: the query positions of one q
//    tile for all G query heads that read one KV head, stacked row-wise
//    (row rho is head g = rho % G at position q0 + rho / G; the G heads of
//    a position are adjacent in memory). Each K/V tile (64 keys) is staged
//    once in shared memory and used by all of the block's rows, so K/V
//    are never repeated per query head (the TPU kernel stacks the G groups
//    row-wise for the same reason).
//  - The KV loop of a q tile ends at its diagonal: keys past the tile's
//    last position are never loaded. (The TPU kernel runs the fully
//    masked blocks, about twice the flops.) The ragged S edge is masked
//    in the kernel; nothing is padded or copied.
//  - Tiles are launched heaviest (last) first, so the diagonal's
//    imbalance does not leave a tail.
// Every output is written once by the block that owns it, with no atomics
// and reductions in a fixed order, so results repeat bit for bit.
//
// flash_mma_kernel, in detail (FlashAttention-2's scheme on mma.sync):
//  - 4 warps, 64 stacked rows a block, two blocks an SM; each warp owns 16
//    rows and keeps their f32 output accumulator and m, l in registers.
//    The block's q rows sit in shared memory (they arrive with the first
//    K/V tile) and each k-step reloads its A fragment by ldmatrix: held in
//    registers they cost 32 more a thread and spilled at hd 128.
//  - S = Q.K^T and O += P.V run as mma.sync m16n8k16 T x T -> f32.
//    K fragments come by ldmatrix, V's by ldmatrix.trans (V is stored
//    key-major, the PV product wants it dim-major).
//  - P never leaves registers: the S accumulator fragment of keys
//    16kk .. 16kk + 15 (two n-tiles of 8) is, pair by pair, the A fragment
//    of PV's k-step kk once rounded to T.
//  - A row's max and sum reduce over the 4 lanes that hold it (shuffles at
//    offsets 1 and 2, in that order); l is kept per lane and reduced once
//    at the end.
//  - K and V tiles arrive by cp.async into two stages of shared memory, so
//    tile t + 1 loads during tile t's products; keys past S are zero-filled
//    (src-size 0). Rows of 16-byte chunks are XOR-swizzled so that the 8
//    row addresses of each ldmatrix hit 8 distinct bank groups.
//  - Scores are scaled once by hd^-0.5 . log2(e) and exponentiated by
//    ex2.approx. The finite -1e30 of the TPU kernel marks masked scores,
//    and only tiles that reach past a warp's first position are masked; a
//    warp skips the tiles wholly past its last position.
//  - Rows past S, and stacked rows past G . BQ, are computed with q = 0
//    and never stored.
// (Probed at the llama3-8b layer shape and not kept, being slower: 8-warp
// blocks, q in registers, exp2f, three stages, 32-key tiles, two 16-row
// tiles a warp, the scale fused into the exponent.)
//
// The entry point returns cudaGetLastError() after its launch (or the
// error of cudaFuncSetAttribute, which dynamic shared memory above 48 KB
// needs: the f32 kernel 225 KB at hd 128 and 208.5 KB at 256, 384 and 512
// (F32Plan::smem); the bf16 kernel's two stages and q tile 80 KB at hd 128,
// of the 227 KB a block may take; the wide 16-bit kernel 178 KB at 256,
// 194 KB at 384 and 210 KB at 512 (WidePlan::smem); the f32 cluster
// kernel 208.5 KB a block at any width (ClusterPlan<BW>::smem); the
// column-chunk kernels 64 KB (f32) and 48 KB (16-bit) at any width).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBK = 64;          // keys per staged K/V tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16 and f16: the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // stacked query rows per block
constexpr int kStages = 2;

// Index of 16-byte chunk c of key row r in a tile of CPR chunks a row: the
// chunk is XOR-swizzled so that 8 consecutive rows at one chunk (what one
// ldmatrix matrix reads) fall in 8 distinct 16-byte bank groups.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
    if constexpr (CPR >= 8) return r * CPR + (c ^ (r & 7));
    else return r * CPR + (c ^ ((r / (8 / CPR)) % CPR));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d += a . b for one 16x8x16 tile of T (bf16 or f16) in f32: a the A
// fragment (rows gq and gq + 8, k 2tq, 2tq + 1 and + 8), b0 / b1 the B
// fragment (k 2tq.. and 2tq + 8.., column gq), d the C fragment (rows gq,
// gq + 8; columns 2tq, 2tq + 1).
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
    if constexpr (std::is_same_v<T, __half>)
        asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    else
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a T pair (round to nearest even), lo in the low half (the
// lower k / column index)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    if constexpr (std::is_same_v<T, __half>) {
        __half2 x = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&x);
    } else {
        __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&x);
    }
}

// 2^x by the MUFU unit (ex2.approx, subnormal results flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hkv,
                 int G, int GB, int BQ, int n_qt, int n_bh,
                 float scale_log2) {
    constexpr int CPR = HD / 8;          // 16-byte chunks per row
    constexpr int KC = HD / 16;          // k-steps of the QK product
    constexpr int NT = kBK / 8;          // score n-tiles of 8 keys
    constexpr int DT = HD / 8;           // output n-tiles of 8 dims
    constexpr int TILE = kBK * CPR;      // chunks per K (or V) tile
    static_assert(4 * NT <= 32, "one bit of `dead` per score of a lane");
    extern __shared__ uint4 smem[];      // [stage][K, V][TILE], then Q

    const int bid = blockIdx.x;
    const int qt = n_qt - 1 - bid / n_bh;         // heaviest tiles first
    const int bh = bid % n_bh;
    const int n_gr = (G + GB - 1) / GB;
    const int gr = bh % n_gr;
    const int kvh = (bh / n_gr) % Hkv;
    const int b = bh / (n_gr * Hkv);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gq = lane >> 2, tq = lane & 3;
    const int q0 = qt * BQ;
    const int kv_end = min(S, q0 + BQ);           // keys past it are masked
    const int n_tiles = (kv_end + kBK - 1) / kBK;

    // this lane's rows 16 warp + gq (r = 0) and + 8 (r = 1)
    int pos[2];
    bool live[2];
    int64_t word[2];                              // its o row, in T pairs
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int rho = 16 * warp + gq + 8 * r;
        const int qi = rho / GB, g = gr * GB + rho % GB;
        pos[r] = q0 + qi;
        live[r] = qi < BQ && g < G && pos[r] < S;
        word[r] = live[r]
            ? ((int64_t(b) * S + pos[r]) * H + kvh * G + g) * (HD / 2) : 0;
    }
    // the positions the warp's rows span; a warp wholly past the tile's
    // rows or past S computes nothing
    const int p_lo = q0 + 16 * warp / GB;
    const int p_hi = q0 + min(16 * warp + 15, GB * BQ - 1) / GB;
    const bool warp_live = 16 * warp < GB * BQ && p_lo < S;

    const uint32_t s_base =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const uint32_t sQ = s_base + kStages * 2 * TILE * 16;
    // the block's q rows, zero-filled where no row is live, arrive with
    // the first K/V tile
    for (int i = tid; i < kRows * CPR; i += kThreads) {
        const int rho = i / CPR, c = i % CPR;
        const int qi = rho / GB, g = gr * GB + rho % GB;
        const bool in = qi < BQ && g < G && q0 + qi < S;
        const int64_t off =
            in ? ((int64_t(b) * S + q0 + qi) * H + kvh * G + g) * HD + 8 * c
               : 0;
        cp_async16(sQ + swz<CPR>(rho, c) * 16, q + off, in ? 16 : 0);
    }
    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[d][x] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    const int64_t kv_stride = int64_t(Hkv) * HD;
    const T* kb = k + (int64_t(b) * S * Hkv + kvh) * HD;
    const T* vb = v + (int64_t(b) * S * Hkv + kvh) * HD;

    auto load = [&](int tile, int stage) {
        const int k0 = tile * kBK;
        const uint32_t sk = s_base + stage * 2 * TILE * 16;
        for (int i = tid; i < TILE; i += kThreads) {
            const int key = i / CPR, c = i % CPR;
            const bool in = k0 + key < S;
            const int64_t off = in ? (k0 + key) * kv_stride + 8 * c : 0;
            const uint32_t dst = sk + swz<CPR>(key, c) * 16;
            cp_async16(dst, kb + off, in ? 16 : 0);
            cp_async16(dst + TILE * 16, vb + off, in ? 16 : 0);
        }
    };

    load(0, 0);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) load(it + 1, (it + 1) % kStages);
        cp_async_commit();
        cp_async_wait<1>();                       // tile it has landed
        __syncthreads();
        const int k0 = it * kBK;
        if (warp_live && k0 <= p_hi) {
            const uint32_t sK = s_base + (it % kStages) * 2 * TILE * 16;
            const uint32_t sV = sK + TILE * 16;
            float s[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
            // S = Q K^T. The A fragment of k-step kc: lanes 0-15 address
            // rows 16 warp + 0..15 at dims 16 kc + 0..7, lanes 16-31 at
            // + 8..15. B: lanes 0-7 / 8-15 address keys 16 np + 0..7 at
            // dims 16 kc + 0..7 / + 8..15 (n-tile 2 np), lanes 16-31 keys
            // 16 np + 8..15 (n-tile 2 np + 1).
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
                uint32_t qa[4];
                ldsm_x4(sQ + swz<CPR>(16 * warp + (lane & 15),
                                      2 * kc + (lane >> 4)) * 16,
                        qa[0], qa[1], qa[2], qa[3]);
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
                    const int c = 2 * kc + ((lane >> 3) & 1);
                    uint32_t b0, b1, b2, b3;
                    ldsm_x4(sK + swz<CPR>(key, c) * 16, b0, b1, b2, b3);
                    mma16<T>(s[2 * np], qa, b0, b1);
                    mma16<T>(s[2 * np + 1], qa, b2, b3);
                }
            }
            // scale, mask (only a tile that reaches past the warp's first
            // position), and the rows' new max over the quad
            const bool masked = k0 + kBK - 1 > p_lo;
            uint32_t dead = 0;                    // bit 4 j + x: masked
            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int j = 0; j < NT; ++j) {
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    float y = s[j][x] * scale_log2;
                    if (masked) {
                        const int key = k0 + 8 * j + 2 * tq + (x & 1);
                        if (key > pos[x >> 1] || key >= S) {
                            y = kNegInf;
                            dead |= 1u << (4 * j + x);
                        }
                    }
                    s[j][x] = y;
                    mx[x >> 1] = fmaxf(mx[x >> 1], y);
                }
            }
            float corr[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                corr[r] = fast_exp2(m[r] - mx[r]);
                m[r] = mx[r];
                l[r] *= corr[r];
            }
#pragma unroll
            for (int d = 0; d < DT; ++d) {
                acc[d][0] *= corr[0];
                acc[d][1] *= corr[0];
                acc[d][2] *= corr[1];
                acc[d][3] *= corr[1];
            }
            // p in f32 for l, in T (the A fragment) for PV
#pragma unroll
            for (int j = 0; j < NT; ++j) {
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    const float p = (dead >> (4 * j + x)) & 1u
                        ? 0.f : fast_exp2(s[j][x] - m[x >> 1]);
                    l[x >> 1] += p;
                    s[j][x] = p;
                }
            }
            // O += P V: k-step kk is keys 16 kk .. + 15 = score n-tiles
            // 2 kk and 2 kk + 1; lanes 0-7 / 8-15 address keys 16 kk +
            // 0..7 / 8..15 at dims 16 dp + 0..7 (n-tile 2 dp), lanes
            // 16-31 at dims 16 dp + 8..15 (n-tile 2 dp + 1)
#pragma unroll
            for (int kk = 0; kk < NT / 2; ++kk) {
                const uint32_t a[4] = {
                    pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                    pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                    pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                    pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
                for (int dp = 0; dp < DT / 2; ++dp) {
                    const int key = 16 * kk + (lane & 7)
                                    + (((lane >> 3) & 1) << 3);
                    const int c = 2 * dp + (lane >> 4);
                    uint32_t b0, b1, b2, b3;
                    ldsm_x4_trans(sV + swz<CPR>(key, c) * 16, b0, b1, b2,
                                  b3);
                    mma16<T>(acc[2 * dp], a, b0, b1);
                    mma16<T>(acc[2 * dp + 1], a, b2, b3);
                }
            }
        }
        __syncthreads();                          // stage it is free again
    }

    uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        if (!live[r]) continue;
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int d = 0; d < DT; ++d)
            o32[word[r] + 4 * d + tq] = pack2<T>(acc[d][2 * r] / den,
                                                 acc[d][2 * r + 1] / den);
    }
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------
// flash_f32_kernel<HD> (hd 16 to 256, and the padded 384 and 512): f32 FFMA
// on the CUDA cores, no TF32 (the reference's f32 tolerance is 2e-5; TF32
// keeps about three decimal digits). What bounds it is the shared-memory
// pipe, not the FMA units: an SM reads 32 floats a clock from shared memory
// (whatever the width of the load) and does 128 FMAs, so a product must
// reuse every float it reads about four times to run at the FMA rate. So:
//  - Register micro-tiles. The scores of a 64-key tile (BM stacked rows x
//    64 keys) are outer products over d: a thread owns SR = BM / 16 rows
//    (SR ty + r) x 4 keys (tx + 16 j) and, per 4 dims, reads SR + 4
//    float4s for 16 SR FMAs (8 x 4: 2.7 FMAs a float at hd 128; 4 x 4: 2
//    at the other widths). P goes through shared memory (transposed, keys
//    x rows), and O += P.V is a second register-tiled product: a thread
//    owns OR rows x 4 NJ dims of every V slab's part of O and, per key,
//    reads OR + 4 NJ floats for 4 OR NJ FMAs (8 x 8: 4 a float at hd 128
//    and 256; 4 x 8: 2.7 at 384 and 512). A row's max and sum reduce over
//    the 16 lanes that hold it by shuffles at offsets 1, 2, 4, 8, in that
//    order; the sum is kept per lane and reduced once at the end. The V
//    slabs of a tile are walked unrolled, so that each one's part of O is
//    named at compile time and stays in registers.
//  - Scores once, at the full width. BM is chosen by width so that O fits
//    in registers: 128 rows at hd 128 (64 floats a thread), 64 rows else
//    (up to 128 floats a thread at hd 512). Q sits whole in shared memory,
//    row-major (its reads are broadcasts). K and V come in slabs of 64
//    keys x D dims (the whole width up to 256, 128 above: 64 KB at most),
//    the scores summed over the K slabs and each V slab adding to its own
//    part of O, so nothing is recomputed at any hd.
//  - Asynchronous staging. Q (once, with the first slab) and the slabs (a
//    tile's K slabs, then its V slabs) arrive by 16-byte cp.async through a
//    ring of R slabs (4, or as many as 227 KB leave: 2 at hd 256 and 512,
//    3 at 384), so R - 1 slabs load during a slab's products; keys past S
//    are zero-filled (src-size 0). Slab rows are XOR-swizzled in 16-byte
//    chunks (swz) so that the 8 keys a quarter-warp reads fall in 8 bank
//    groups; P^T likewise for its stores.
//  - Scores are scaled by hd^-0.5 . log2(e) and exponentiated by
//    ex2.approx, as in the 16-bit kernel; masked scores take the finite
//    -1e30 and masked p is set to 0 again; only tiles that reach past the
//    block's first position are masked.
// Shared memory: Q BM x hd, R slabs, P^T 64 x BM and 2 BM floats (the
// rows' rescale and sums): 225 KB at hd 128, 208.5 KB at 256, 384 and 512.
// (Measured and not kept: 128-key tiles above hd 256, scores 4 x 8 a
// thread, 2.7 % faster at hd 320 and 1.7 % slower at 512.)

constexpr int kF32Threads = 256;
constexpr int kSmemBytes = 232448;   // the most a block may take (227 KB)

// flash_f32_kernel<HD>'s tiles: BM stacked rows a block; K and V staged in
// NSL slabs of kBK keys x D dims each, through a ring of R slabs; the
// scores' micro-tile SR rows x 4 keys; the output's OR rows x NJ 16-byte
// chunks of each slab, TOC threads across a slab's CD chunks. CQ, CD, CP:
// 16-byte chunks in a row of Q, of a slab, of P^T.
// flash_f32_plan (the entry point at the end) reports them; the wrapper's
// f32_plan mirrors the rule for the CPU and is held equal to it on the card.
template <int HD>
struct F32Plan {
    static constexpr int BM = HD == 128 ? 128 : 64;
    static constexpr int D = HD <= 256 ? HD : 128;
    static constexpr int NSL = HD / D;
    static constexpr int CQ = HD / 4, CD = D / 4, CP = BM / 4;
    static constexpr int SR = BM / 16;
    static constexpr int OC = BM * D / kF32Threads;   // O floats a slab
    static constexpr int OR = OC >= 64 ? 8 : OC >= 16 ? 4 : OC / 4;
    static constexpr int TOC = kF32Threads * OR / BM;
    static constexpr int NJ = CD / TOC;
    static constexpr int FIXED = (BM * HD + kBK * BM + 2 * BM) * 4;
    static constexpr int SLAB = kBK * D * 4;
    static constexpr int FIT = (kSmemBytes - FIXED) / SLAB;
    static constexpr int R = FIT < 4 ? FIT : 4;
    static constexpr size_t smem = FIXED + size_t(R) * SLAB;
    static_assert(HD % D == 0 && SR % 4 == 0 && OR >= 1 && R >= 2,
                  "a width the f32 kernel has no tiles for");
};

// O (OR rows x NJ chunks of one slab) += P V over the slab's keys K0 ..
// K0 + NK - 1 (all kBK by default), in order: P^T rows OR oy .. from sP, V
// chunks ox + TOC j of each key from the slab
template <int CD, int CP, int TOC, int OR, int NJ, int K0 = 0, int NK = kBK>
__device__ __forceinline__ void f32_pv(float (&acc)[OR][4 * NJ],
                                       const float4* slab, const float4* sP,
                                       int ox, int oy) {
    const float* sPf = reinterpret_cast<const float*>(sP);
#pragma unroll 8
    for (int key = K0; key < K0 + NK; ++key) {
        float pr[OR];
        if constexpr (OR % 4 == 0) {
#pragma unroll
            for (int rc = 0; rc < OR / 4; ++rc) {
                const float4 p4 = sP[swz<CP>(key, OR * oy / 4 + rc)];
                pr[4 * rc] = p4.x;
                pr[4 * rc + 1] = p4.y;
                pr[4 * rc + 2] = p4.z;
                pr[4 * rc + 3] = p4.w;
            }
        } else {
#pragma unroll
            for (int r = 0; r < OR; ++r) {
                const int row = OR * oy + r;
                pr[r] = sPf[swz<CP>(key, row / 4) * 4 + row % 4];
            }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const float4 vf = slab[swz<CD>(key, ox + TOC * j)];
#pragma unroll
            for (int r = 0; r < OR; ++r) {
                acc[r][4 * j] = fmaf(pr[r], vf.x, acc[r][4 * j]);
                acc[r][4 * j + 1] = fmaf(pr[r], vf.y, acc[r][4 * j + 1]);
                acc[r][4 * j + 2] = fmaf(pr[r], vf.z, acc[r][4 * j + 2]);
                acc[r][4 * j + 3] = fmaf(pr[r], vf.w, acc[r][4 * j + 3]);
            }
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int S, int H, int Hkv, int G, int GB, int BQ, int n_qt,
                 int n_bh, float scale_log2) {
    using P = F32Plan<HD>;
    constexpr int BM = P::BM, D = P::D, NSL = P::NSL, CQ = P::CQ;
    constexpr int CD = P::CD, CP = P::CP, SR = P::SR, TOC = P::TOC;
    constexpr int OR = P::OR, NJ = P::NJ, R = P::R;
    constexpr int SLAB = kBK * CD;               // float4s a slab
    extern __shared__ float4 smem4[];
    float4* sQ = smem4;                          // (BM, CQ), row-major
    float4* sRing = sQ + BM * CQ;                // R slabs (kBK, CD), swizzled
    float4* sP = sRing + R * SLAB;               // P^T (kBK, CP), swizzled
    float* sCorr = reinterpret_cast<float*>(sP + kBK * CP);  // BM
    float* sL = sCorr + BM;                                  // BM

    const int bid = blockIdx.x;
    const int qt = n_qt - 1 - bid / n_bh;        // heaviest tiles first
    const int bh = bid % n_bh;
    const int n_gr = (G + GB - 1) / GB;
    const int gr = bh % n_gr;
    const int kvh = (bh / n_gr) % Hkv;
    const int b = bh / (n_gr * Hkv);
    const int t = threadIdx.x;
    const int tx = t % 16, ty = t / 16;          // scores: keys, rows
    const int ox = t % TOC, oy = t / TOC;        // output: chunks, rows
    const int q0 = qt * BQ;
    const int kv_end = min(S, q0 + BQ);          // keys past it are masked
    // step i takes slab i: tile i / (2 NSL); of it, for p = i % (2 NSL),
    // K's dims D p .. + D - 1 (p < NSL), else V's D (p - NSL) ..
    const int n_steps = (kv_end + kBK - 1) / kBK * 2 * NSL;

    const int64_t kv_stride = int64_t(Hkv) * HD;
    const float* kb = k + (int64_t(b) * S * Hkv + kvh) * HD;
    const float* vb = v + (int64_t(b) * S * Hkv + kvh) * HD;
    const uint32_t sQa =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
    const uint32_t sRa = sQa + BM * CQ * 16;

    // the block's q rows, zero-filled where no row is live, arrive with the
    // first slab
    for (int i = t; i < BM * CQ; i += kF32Threads) {
        const int rho = i / CQ, c = i % CQ;
        const int qi = rho / GB, g = gr * GB + rho % GB;
        const bool in = qi < BQ && g < G && q0 + qi < S;
        const int64_t off =
            in ? ((int64_t(b) * S + q0 + qi) * H + kvh * G + g) * HD + 4 * c
               : 0;
        cp_async16(sQa + i * 16, q + off, in ? 16 : 0);
    }
    auto load = [&](int i) {                     // slab i into slot i % R
        const int k0 = i / (2 * NSL) * kBK, p = i % (2 * NSL);
        const float* src = (p < NSL ? kb : vb) + (p % NSL) * D;
        const uint32_t dst = sRa + (i % R) * SLAB * 16;
        for (int e = t; e < SLAB; e += kF32Threads) {
            const int key = e / CD, c = e % CD;
            const bool in = k0 + key < S;
            const int64_t off = in ? (k0 + key) * kv_stride + 4 * c : 0;
            cp_async16(dst + swz<CD>(key, c) * 16, src + off, in ? 16 : 0);
        }
    };

    float s[SR][4], m[SR], l[SR];
    float acc[NSL][OR][4 * NJ];
#pragma unroll
    for (int r = 0; r < SR; ++r) {
        m[r] = kNegInf;
        l[r] = 0.f;
    }
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
        for (int r = 0; r < OR; ++r)
#pragma unroll
            for (int e = 0; e < 4 * NJ; ++e) acc[sl][r][e] = 0.f;

#pragma unroll
    for (int i = 0; i < R - 1; ++i) {
        if (i < n_steps) load(i);
        cp_async_commit();
    }
    // slab i's slot, once it has landed and slot i - 1 is free again
    auto next = [&](int i) -> const float4* {
        cp_async_wait<R - 2>();
        __syncthreads();
        if (i + R - 1 < n_steps) load(i + R - 1);
        cp_async_commit();
        return sRing + (i % R) * SLAB;
    };
    for (int i = 0; i < n_steps;) {
        const int k0 = i / (2 * NSL) * kBK;
        // S = Q K^T over the K slabs, d in order
#pragma unroll
        for (int r = 0; r < SR; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
        for (int p = 0; p < NSL; ++p, ++i) {
            const float4* slab = next(i);
            const float4* qrow = sQ + SR * ty * CQ + p * CD;
#pragma unroll 8
            for (int c = 0; c < CD; ++c) {
                float4 kf[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    kf[j] = slab[swz<CD>(tx + 16 * j, c)];
#pragma unroll
                for (int r = 0; r < SR; ++r) {
                    const float4 qf = qrow[r * CQ + c];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[r][j] = fmaf(qf.x, kf[j].x, s[r][j]);
                        s[r][j] = fmaf(qf.y, kf[j].y, s[r][j]);
                        s[r][j] = fmaf(qf.z, kf[j].z, s[r][j]);
                        s[r][j] = fmaf(qf.w, kf[j].w, s[r][j]);
                    }
                }
            }
        }
        // scale, mask (only a tile that reaches past the block's first
        // position), the rows' new max over their 16 lanes, p, and P^T and
        // the rescale to shared memory
        const bool masked = k0 + kBK - 1 > q0;
#pragma unroll
        for (int r = 0; r < SR; ++r) {
            const int rho = SR * ty + r;
            const int pos = q0 + rho / GB;
            uint32_t dead = 0;
            float mx = m[r];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int key = k0 + tx + 16 * j;
                if (masked && (key > pos || key >= S)) dead |= 1u << j;
                s[r][j] = (dead >> j) & 1u ? kNegInf : s[r][j] * scale_log2;
                mx = fmaxf(mx, s[r][j]);
            }
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float corr = fast_exp2(m[r] - mx);
            m[r] = mx;
            l[r] *= corr;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float pj = (dead >> j) & 1u
                    ? 0.f : fast_exp2(s[r][j] - mx);
                l[r] += pj;
                s[r][j] = pj;
            }
            if (tx == 0) sCorr[rho] = corr;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int rc = 0; rc < SR / 4; ++rc)
                sP[swz<CP>(tx + 16 * j, SR * ty / 4 + rc)] =
                    make_float4(s[4 * rc][j], s[4 * rc + 1][j],
                                s[4 * rc + 2][j], s[4 * rc + 3][j]);
        // O = O . corr + P V over the V slabs
#pragma unroll
        for (int sl = 0; sl < NSL; ++sl, ++i) {
            const float4* slab = next(i);
            if (sl == 0) {
#pragma unroll
                for (int r = 0; r < OR; ++r) {
                    const float cr = sCorr[OR * oy + r];
#pragma unroll
                    for (int x = 0; x < NSL; ++x)
#pragma unroll
                        for (int e = 0; e < 4 * NJ; ++e) acc[x][r][e] *= cr;
                }
            }
            f32_pv<CD, CP, TOC, OR, NJ>(acc[sl], slab, sP, ox, oy);
        }
    }

#pragma unroll
    for (int r = 0; r < SR; ++r) {
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
        if (tx == 0) sL[SR * ty + r] = l[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < OR; ++r) {
        const int rho = OR * oy + r;
        const int qi = rho / GB, g = gr * GB + rho % GB;
        if (qi >= BQ || g >= G || q0 + qi >= S) continue;
        const float den = fmaxf(sL[rho], 1e-30f);
        float4* orow = reinterpret_cast<float4*>(
            o + ((int64_t(b) * S + q0 + qi) * H + kvh * G + g) * HD);
#pragma unroll
        for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                orow[sl * CD + ox + TOC * j] = make_float4(
                    acc[sl][r][4 * j] / den, acc[sl][r][4 * j + 1] / den,
                    acc[sl][r][4 * j + 2] / den, acc[sl][r][4 * j + 3] / den);
    }
}

// ---------------------------------------------------------------------------
// bf16 and f16 above hd 128: the scores once, O split by column
// ---------------------------------------------------------------------------
// flash_mma_wide_kernel<W, T> takes the widths the wrapper pads hd 129-512
// to, W = 256, 384 and 512. A flash_mma_kernel instance at 256 spilled
// (255 registers, 432 B), for each of its warps holds 16 rows of O at the
// full width. Here the warps of a block split O's columns, so a thread
// holds W / 4 floats of it (128 at 512), while the scores are still
// computed once at the full width. What bounds it is operations, as above,
// on the tensor cores; what feeds them, ldmatrix from shared memory, is the
// pipe its design spares:
//  - 8 warps, 64 stacked rows a block (flash_mma_kernel's rows, heads and
//    tile order) in two row groups of 32, one block an SM, 128-key tiles.
//    Warp w is row group rg = w / 4 (rows 32 rg .. 32 rg + 31, two 16-row
//    m-tiles) and part pt = w % 4 of it. In S = Q.K^T the four warps of a
//    group split the keys (pt takes keys 32 pt .. 32 pt + 31 of the tile,
//    over the full width, one ascending k-step chain a score); in O +=
//    P.V they split the output's columns (pt takes D / 4 of every V slab
//    of D dims). So a warp multiplies 32 x 32 score tiles and 32-row strips
//    of O, and a 16-byte ldmatrix read feeds 2 16x8x16 products in the
//    scores and 2 (D 128) to 8 / 3 (D 256) in P.V, about half the reads a
//    product of warps that own 16 rows.
//  - Q sits whole in shared memory (32 KB at 256, 48 KB at 384, 64 KB at
//    512) and arrives once, with the first slab. K and V come in slabs of
//    128 keys x D dims (WidePlan: D 256 at 256 and 512, 128 at 384): a
//    tile's K slabs, then its V slabs, through one cp.async ring of R slabs
//    (2 at 256 and 512, 4 at 384), so R - 1 slabs load during a slab's
//    products; keys past S are zero-filled (src-size 0). Q, slabs and P are
//    XOR-swizzled in 16-byte chunks (swz) as above, and the loads' and
//    ldmatrix's addresses are per-lane offsets computed once.
//  - The softmax: a warp takes its keys' row max over the quad, the group
//    trade theirs through shared memory behind a named barrier of its 128
//    threads, and all four take the same max, correction and m. Each writes
//    its p, rounded to T, into a 64 x 128 P tile in shared memory and keeps
//    its keys' part of l (the four parts are added, part 0's first, at the
//    end). After a V slab's barrier a warp reads its 32 rows of P by
//    ldmatrix, two A fragments a 16-key step.
// Shared memory: Q, the ring, P and the groups' maxima and sums: 178 KB at
// 256, 194 KB at 384, 210 KB at 512 (WidePlan::smem). Heads past 512 take
// the column-chunk kernel after it. (Probed at the llama3-8b layer's heads and
// length and not kept, being slower: 16-row warps in pairs over 64-key
// tiles, with 128-dim or full-width slabs; 16 warps; two blocks of 32 rows
// an SM; 128-dim slabs at 512, 192-dim at 384 and 128-dim with a ring of 4
// at 256; a ring of 3 at 384; skipping the rescale where no row's max
// moved.)
constexpr int kWideRows = 64;        // stacked rows a block
constexpr int kGroupRows = 32;       // rows of a row group, two m-tiles
constexpr int kSplit = 4;            // warps a row group
constexpr int kWideWarps = kSplit * kWideRows / kGroupRows;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideBK = 128;         // keys of a tile
constexpr int kWideRing = 4;         // most slabs in the cp.async ring

// flash_mma_wide_kernel<W, T>'s tiles: K and V in NSL slabs of kWideBK keys
// x D dims a tile, through a ring of R slabs (as many as 227 KB leave, at
// most kWideRing); shared memory: Q (kWideRows x W), the ring, P
// (kWideRows x kWideBK), then the groups' maxima and sums in f32
template <int W>
struct WidePlan {
    static constexpr int D = W == 384 ? 128 : 256;
    static constexpr int NSL = W / D;
    static constexpr int CPQ = W / 8;           // 16-byte chunks: a row of Q,
    static constexpr int CPS = D / 8;           // of a slab,
    static constexpr int CPP = kWideBK / 8;     // of P
    static constexpr int SLAB = kWideBK * CPS;  // chunks of a slab
    static constexpr int FIXED =
        (kWideRows * CPQ + kWideRows * CPP) * 16
        + 2 * kSplit * kWideRows * int(sizeof(float));
    static constexpr int FIT = (kSmemBytes - FIXED) / (SLAB * 16);
    static constexpr int R = FIT < kWideRing ? FIT : kWideRing;
    static constexpr size_t smem = FIXED + size_t(R) * SLAB * 16;
    static_assert(W % D == 0 && D % (16 * kSplit) == 0 && R >= 2
                  && kSplit * 32 == kWideBK && kWideThreads % CPS == 0,
                  "whole slabs, a warp's keys and columns in n-tile pairs");
};
static_assert(WidePlan<256>::smem == 182272 &&
              WidePlan<384>::smem == 198656 &&
              WidePlan<512>::smem == 215040, "the wide plan's shared bytes");

// the named barrier of one row group's warps (id 1 + rg)
__device__ __forceinline__ void group_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(32 * kSplit)
                 : "memory");
}

template <int W, typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_mma_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int H, int Hkv, int RW, int G, int GB, int BQ,
                      int n_qt, int n_bh, float scale_log2) {
    using P = WidePlan<W>;
    constexpr int D = P::D, NSL = P::NSL, CPQ = P::CPQ, CPS = P::CPS;
    constexpr int CPP = P::CPP, SLAB = P::SLAB, R = P::R;
    constexpr int KS = D / 16;           // k-steps of a slab
    constexpr int CW = D / kSplit;       // a warp's columns of a V slab
    constexpr int NT = 4;                // its score n-tiles (32 keys)
    constexpr int DT = CW / 8;           // its output n-tiles of a slab
    constexpr int ROW = CPQ * 16;        // bytes of a row of Q
    extern __shared__ uint4 smem[];      // Q, ring, P, then sMax and sL

    const int bid = blockIdx.x;
    const int qt = n_qt - 1 - bid / n_bh;         // heaviest tiles first
    const int bh = bid % n_bh;
    const int n_gr = (G + GB - 1) / GB;
    const int gr = bh % n_gr;
    const int kvh = (bh / n_gr) % Hkv;
    const int b = bh / (n_gr * Hkv);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int rg = warp / kSplit, pt = warp % kSplit;  // row group, part
    const int gq = lane >> 2, tq = lane & 3;
    const int q0 = qt * BQ;
    const int kv_end = min(S, q0 + BQ);           // keys past it are masked
    // step i takes slab i: tile i / (2 NSL); of it, for p = i % (2 NSL),
    // K's dims D p .. (p < NSL), else V's D (p - NSL) ..
    const int n_steps = (kv_end + kWideBK - 1) / kWideBK * 2 * NSL;

    // this lane's rows 32 rg + 16 mt + gq + 8 h (row index r = 2 mt + h),
    // at positions q0 + (row0 + 8 r) / GB
    const int row0 = kGroupRows * rg + gq;
    // the positions the row group spans; a group wholly past the tile's
    // rows or past S computes nothing
    const int p_lo = q0 + kGroupRows * rg / GB;
    const int p_hi =
        q0 + min(kGroupRows * rg + kGroupRows - 1, GB * BQ - 1) / GB;
    const bool rg_live = kGroupRows * rg < GB * BQ && p_lo < S;

    const uint32_t sQ =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const uint32_t sRing = sQ + kWideRows * CPQ * 16;
    const uint32_t sP = sRing + R * SLAB * 16;
    uint32_t* sPw = reinterpret_cast<uint32_t*>(smem + kWideRows * CPQ
                                                + R * SLAB);
    float* sMax = reinterpret_cast<float*>(smem + kWideRows * CPQ + R * SLAB
                                           + kWideRows * CPP);  // [kSplit][kWideRows]
    float* sL = sMax + kSplit * kWideRows;                      // [kSplit][kWideRows]
    // The ldmatrix addresses. Each lane addresses a row (or key) x with
    // x % 8 = lane % 8 at some chunk c, which swz maps to c ^ (lane % 8), a
    // change of c's low 3 bits alone. So the chunks 8 u + 2 t + h (t < 4; h
    // the lane's half, lane / 16 for Q and P, lane / 8 % 2 for K) take four
    // byte offsets a lane, xa and xb, beside constants. V's chunks CW / 8
    // pt + 2 dp + lane / 16 take xa's too when CW / 8 is a multiple of 8
    // (VA), else offsets of their own, xv.
    constexpr bool VA = CW % 64 == 0;
    uint32_t xa[4], xb[4], xv[VA ? 1 : DT / 2];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        xa[t] = ((2 * t + (lane >> 4)) ^ (lane & 7)) * 16;
        xb[t] = ((2 * t + ((lane >> 3) & 1)) ^ (lane & 7)) * 16;
    }
    if constexpr (!VA) {
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp)
            xv[dp] =
                ((CW / 8 * pt + 2 * dp + (lane >> 4)) ^ (lane & 7)) * 16;
    }
    // Q and P (A): rows 32 rg + lane % 16 (+ 16 mt); K (B): keys 32 pt +
    // lane % 8 + 8 (lane / 16) (+ 16 np); V (B, trans): keys lane % 8 + 8
    // (lane / 8 % 2) (+ 16 kk)
    const int arow = kGroupRows * rg + (lane & 15);
    const uint32_t aQ = sQ + arow * ROW;
    const uint32_t aP = sP + arow * CPP * 16;
    const uint32_t oK = (32 * pt + (lane & 7) + ((lane >> 4) << 3)) * CPS
                        * 16;
    const uint32_t oV = ((lane & 7) + (((lane >> 3) & 1) << 3)) * CPS * 16
                        + (VA ? pt * (CW / 8) * 16 : 0);

    // The block's q rows, zero-filled where no row is live, arrive with
    // the first slab. Rows of q, k, v and o hold RW values in memory (a
    // multiple of 8, at most W): dims past RW are zero-filled here and
    // never stored.
    const int rc = RW / 8;                        // 16-byte chunks a row
    for (int i = tid; i < kWideRows * CPQ; i += kWideThreads) {
        const int rho = i / CPQ, c = i % CPQ;
        const int qi = rho / GB, g = gr * GB + rho % GB;
        const bool in = qi < BQ && g < G && q0 + qi < S && c < rc;
        const int64_t off =
            in ? ((int64_t(b) * S + q0 + qi) * H + kvh * G + g) * RW + 8 * c
               : 0;
        cp_async16(sQ + swz<CPQ>(rho, c) * 16, q + off, in ? 16 : 0);
    }
    // a slab's loads: thread tid takes chunk lc of keys lkey + LK j; LK is
    // a multiple of 8, so the swizzle is the same for every j
    constexpr int LK = kWideThreads / CPS;
    static_assert(LK % 8 == 0 && kWideBK % LK == 0, "whole load passes");
    const int lkey = tid / CPS, lc = tid % CPS;
    const int64_t kv_stride = int64_t(Hkv) * RW;
    const T* kb = k + (int64_t(b) * S * Hkv + kvh) * RW + lkey * kv_stride
                  + 8 * lc;
    const T* vb = v + (int64_t(b) * S * Hkv + kvh) * RW + lkey * kv_stride
                  + 8 * lc;
    const uint32_t ldst = sRing + swz<CPS>(lkey, lc) * 16;
    auto load = [&](int i) {                      // slab i into slot i % R
        const int k0 = i / (2 * NSL) * kWideBK, p = i % (2 * NSL);
        const T* src = (p < NSL ? kb : vb) + (p % NSL) * D + k0 * kv_stride;
        const uint32_t dst = ldst + (i % R) * SLAB * 16;
        const bool dim_in = (p % NSL) * CPS + lc < rc;
#pragma unroll
        for (int j = 0; j < kWideBK / LK; ++j) {
            const bool in = dim_in && k0 + lkey + LK * j < S;
            cp_async16(dst + j * LK * CPS * 16,
                       in ? src + j * LK * kv_stride : q, in ? 16 : 0);
        }
    };

    float acc[NSL][2][DT][4];
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int d = 0; d < DT; ++d)
#pragma unroll
                for (int x = 0; x < 4; ++x) acc[sl][mt][d][x] = 0.f;
    float m[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        m[r] = kNegInf;
        l[r] = 0.f;
    }

#pragma unroll
    for (int i = 0; i < R - 1; ++i) {
        if (i < n_steps) load(i);
        cp_async_commit();
    }
    // slab i's slot, once it has landed and slot i - 1 is free again
    auto next = [&](int i) -> uint32_t {
        cp_async_wait<R - 2>();
        __syncthreads();
        if (i + R - 1 < n_steps) load(i + R - 1);
        cp_async_commit();
        return sRing + (i % R) * SLAB * 16;
    };
    for (int i = 0; i < n_steps;) {
        const int k0 = i / (2 * NSL) * kWideBK;
        const bool go = rg_live && k0 <= p_hi;    // the same for the group
        // S = Q K^T over the K slabs at the full width, this warp's 32 rows
        // x 32 keys, k-step ks = KS p + kc: A at Q's chunk 2 ks + lane / 16
        // (m-tile mt: rows + 16 mt); B at keys 32 pt + 16 np + 0..7 / 8..15
        // (lane / 16: n-tile 2 np / + 1), the slab's chunk 2 kc + lane / 8
        // % 2
        float s[2][NT][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int x = 0; x < 4; ++x) s[mt][j][x] = 0.f;
#pragma unroll
        for (int p = 0; p < NSL; ++p, ++i) {
            const uint32_t slab = next(i);
            if (!go) continue;
#pragma unroll
            for (int kc = 0; kc < KS; ++kc) {
                const int ks = KS * p + kc;
                uint32_t qa[2][4];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    ldsm_x4(aQ + mt * 16 * ROW + (ks >> 2) * 128
                            + xa[ks & 3], qa[mt][0], qa[mt][1], qa[mt][2],
                            qa[mt][3]);
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    uint32_t b0, b1, b2, b3;
                    ldsm_x4(slab + oK + np * 16 * CPS * 16 + (kc >> 2) * 128
                            + xb[kc & 3], b0, b1, b2, b3);
#pragma unroll
                    for (int mt = 0; mt < 2; ++mt) {
                        mma16<T>(s[mt][2 * np], qa[mt], b0, b1);
                        mma16<T>(s[mt][2 * np + 1], qa[mt], b2, b3);
                    }
                }
            }
        }
        if (go) {
            // scale, mask (only a tile that reaches past the group's first
            // position), the rows' max over the quad, then over the group
            const bool masked = k0 + kWideBK - 1 > p_lo;
            uint32_t dead = 0;                    // bit 16 mt + 4 j + x
            float mx[4] = {m[0], m[1], m[2], m[3]};
            int pos[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                pos[r] = masked ? q0 + (row0 + 8 * r) / GB : 0;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        const int r = 2 * mt + (x >> 1);
                        float y = s[mt][j][x] * scale_log2;
                        if (masked) {
                            const int key = k0 + 32 * pt + 8 * j + 2 * tq
                                            + (x & 1);
                            if (key > pos[r] || key >= S) {
                                y = kNegInf;
                                dead |= 1u << (16 * mt + 4 * j + x);
                            }
                        }
                        s[mt][j][x] = y;
                        mx[r] = fmaxf(mx[r], y);
                    }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                if (tq == 0) sMax[pt * kWideRows + row0 + 8 * r] = mx[r];
            }
            group_sync(1 + rg);
            float corr[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
                for (int h = 0; h < kSplit; ++h)
                    mx[r] = fmaxf(mx[r], sMax[h * kWideRows + row0 + 8 * r]);
                corr[r] = fast_exp2(m[r] - mx[r]);
                m[r] = mx[r];
                l[r] *= corr[r];
            }
#pragma unroll
            for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int d = 0; d < DT; ++d) {
                        acc[sl][mt][d][0] *= corr[2 * mt];
                        acc[sl][mt][d][1] *= corr[2 * mt];
                        acc[sl][mt][d][2] *= corr[2 * mt + 1];
                        acc[sl][mt][d][3] *= corr[2 * mt + 1];
                    }
            // p in f32 for l; in T, into P's chunk 4 pt + j of its rows
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int j = 0; j < NT; ++j) {
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        const int r = 2 * mt + (x >> 1);
                        const float p = (dead >> (16 * mt + 4 * j + x)) & 1u
                            ? 0.f : fast_exp2(s[mt][j][x] - m[r]);
                        l[r] += p;
                        s[mt][j][x] = p;
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        sPw[swz<CPP>(row0 + 16 * mt + 8 * h, 4 * pt + j) * 4
                            + tq] = pack2<T>(s[mt][j][2 * h],
                                             s[mt][j][2 * h + 1]);
                }
        }
        // O += P V over the V slabs, this warp's columns of each: k-step kk
        // is keys 16 kk .. + 15, P's chunk 2 kk + lane / 16 (m-tile mt: rows
        // + 16 mt); V at keys 16 kk + 0..7 / 8..15 (lane / 8 % 2) and the
        // slab's chunk CW / 8 pt + 2 dp + lane / 16 (n-tile 2 dp / + 1)
#pragma unroll
        for (int sl = 0; sl < NSL; ++sl, ++i) {
            const uint32_t slab = next(i);        // P is whole after it
            if (!go) continue;
#pragma unroll
            for (int kk = 0; kk < kWideBK / 16; ++kk) {
                uint32_t pa[2][4];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    ldsm_x4(aP + mt * 16 * CPP * 16 + (kk >> 2) * 128
                            + xa[kk & 3], pa[mt][0], pa[mt][1], pa[mt][2],
                            pa[mt][3]);
#pragma unroll
                for (int dp = 0; dp < DT / 2; ++dp) {
                    uint32_t b0, b1, b2, b3, vx;
                    if constexpr (VA) vx = (dp >> 2) * 128 + xa[dp & 3];
                    else vx = xv[dp];
                    ldsm_x4_trans(slab + oV + kk * 16 * CPS * 16 + vx, b0,
                                  b1, b2, b3);
#pragma unroll
                    for (int mt = 0; mt < 2; ++mt) {
                        mma16<T>(acc[sl][mt][2 * dp], pa[mt], b0, b1);
                        mma16<T>(acc[sl][mt][2 * dp + 1], pa[mt], b2, b3);
                    }
                }
            }
        }
    }

    // l: over the quad's lanes, then the group's parts, part 0's first
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        if (tq == 0) sL[pt * kWideRows + row0 + 8 * r] = l[r];
    }
    __syncthreads();
    uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int rho = row0 + 8 * r, mt = r / 2, h = r % 2;
        const int qi = rho / GB, g = gr * GB + rho % GB;
        if (qi >= BQ || g >= G || q0 + qi >= S) continue;
        float lr = sL[rho];
#pragma unroll
        for (int x = 1; x < kSplit; ++x) lr += sL[x * kWideRows + rho];
        const float den = fmaxf(lr, 1e-30f);
        // its columns D sl + CW pt + 8 d + 2 tq below RW, in T pairs
        const int64_t word =
            ((int64_t(b) * S + q0 + qi) * H + kvh * G + g) * (RW / 2)
            + pt * (CW / 2) + tq;
#pragma unroll
        for (int sl = 0; sl < NSL; ++sl)
#pragma unroll
            for (int d = 0; d < DT; ++d)
                if (D * sl + CW * pt + 8 * d < RW)
                    o32[word + sl * (D / 2) + 4 * d] =
                        pack2<T>(acc[sl][mt][d][2 * h] / den,
                                 acc[sl][mt][d][2 * h + 1] / den);
    }
}

// ---------------------------------------------------------------------------
// Head widths past 512: the output's columns in chunks of kChunk
// ---------------------------------------------------------------------------
// No configuration of the port has a head past 512. The wrapper zero-pads
// hd there to a multiple of kChunk and passes the true width's scale. The
// column-chunk kernels (bf16 and f16 at any such width, f32 past 4096): a
// block owns one kChunk-wide chunk of the output's columns (grid dimension
// y) for the same stacked rows as above. It sums the full-width scores
// Q.K^T over hd in kChunk-wide k-chunks, each staged in shared memory (q's
// chunk beside k's), runs the same online softmax and accumulates P.V for
// its own chunk of V only. So the scores are recomputed once per chunk: hd
// / 128 times the QK flops. f32 from 640 to 4096 takes the cluster kernel
// at the end of this section, which computes them once, as
// flash_mma_wide_kernel (bf16, f16) and flash_f32_kernel (f32) do below
// 512.
constexpr int kChunk = 128;
constexpr int kCH = 16;          // keys per softmax step (f32 column chunks)

// 16-bit (bf16 or f16) on the tensor cores: flash_mma_kernel's tiles,
// fragments, masking and softmax at a width of kChunk, one stage (no
// cp.async double buffer: each k-chunk is waited for before its products).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_mma_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int Hkv, int HD, int G, int GB, int BQ,
                       int n_qt, int n_bh, float scale_log2) {
    constexpr int CPR = kChunk / 8;      // 16-byte chunks per row
    constexpr int KC = kChunk / 16;      // k-steps of one k-chunk
    constexpr int NT = kBK / 8;          // score n-tiles of 8 keys
    constexpr int DT = kChunk / 8;       // output n-tiles of 8 dims
    constexpr int TILE = kBK * CPR;      // chunks per staged tile
    static_assert(kRows == kBK, "q's and k's chunks share one walk");
    extern __shared__ uint4 smem[];      // K, V, then Q: TILE chunks each

    const int cc = blockIdx.y;           // output columns kChunk cc ..
    const int n_kc = HD / kChunk;
    const int bid = blockIdx.x;
    const int qt = n_qt - 1 - bid / n_bh;         // heaviest tiles first
    const int bh = bid % n_bh;
    const int n_gr = (G + GB - 1) / GB;
    const int gr = bh % n_gr;
    const int kvh = (bh / n_gr) % Hkv;
    const int b = bh / (n_gr * Hkv);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gq = lane >> 2, tq = lane & 3;
    const int q0 = qt * BQ;
    const int kv_end = min(S, q0 + BQ);
    const int n_tiles = (kv_end + kBK - 1) / kBK;

    int pos[2];
    bool live[2];
    int64_t word[2];                              // its o chunk, in T pairs
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int rho = 16 * warp + gq + 8 * r;
        const int qi = rho / GB, g = gr * GB + rho % GB;
        pos[r] = q0 + qi;
        live[r] = qi < BQ && g < G && pos[r] < S;
        word[r] = live[r]
            ? ((int64_t(b) * S + pos[r]) * H + kvh * G + g) * (HD / 2)
              + cc * (kChunk / 2) : 0;
    }
    const int p_lo = q0 + 16 * warp / GB;
    const int p_hi = q0 + min(16 * warp + 15, GB * BQ - 1) / GB;
    const bool warp_live = 16 * warp < GB * BQ && p_lo < S;

    const uint32_t sK =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const uint32_t sV = sK + TILE * 16;
    const uint32_t sQ = sV + TILE * 16;
    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[d][x] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    const int64_t kv_stride = int64_t(Hkv) * HD;
    const T* kb = k + (int64_t(b) * S * Hkv + kvh) * HD;
    const T* vb = v + (int64_t(b) * S * Hkv + kvh) * HD;

    for (int it = 0; it < n_tiles; ++it) {
        const int k0 = it * kBK;
        const bool go = warp_live && k0 <= p_hi;
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
        for (int kc = 0; kc < n_kc; ++kc) {
            __syncthreads();                      // the last chunk is used
            // row i / CPR of the K, Q (and, with the last k-chunk, V)
            // tiles; keys past S and rows past the block's are zero-filled
            for (int i = tid; i < TILE; i += kThreads) {
                const int row = i / CPR, c = i % CPR;
                const int d = kc * kChunk + 8 * c;
                const bool in = k0 + row < S;
                const int64_t off = in ? (k0 + row) * kv_stride : 0;
                const uint32_t at = swz<CPR>(row, c) * 16;
                cp_async16(sK + at, kb + off + d, in ? 16 : 0);
                if (kc == n_kc - 1)
                    cp_async16(sV + at, vb + off + cc * kChunk + 8 * c,
                               in ? 16 : 0);
                const int qi = row / GB, g = gr * GB + row % GB;
                const bool qin = qi < BQ && g < G && q0 + qi < S;
                const int64_t qoff =
                    qin ? ((int64_t(b) * S + q0 + qi) * H + kvh * G + g) * HD
                          + d : 0;
                cp_async16(sQ + at, q + qoff, qin ? 16 : 0);
            }
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
            if (go) {
#pragma unroll
                for (int ks = 0; ks < KC; ++ks) {
                    uint32_t qa[4];
                    ldsm_x4(sQ + swz<CPR>(16 * warp + (lane & 15),
                                          2 * ks + (lane >> 4)) * 16,
                            qa[0], qa[1], qa[2], qa[3]);
#pragma unroll
                    for (int np = 0; np < NT / 2; ++np) {
                        const int key = 16 * np + (lane & 7)
                                        + ((lane >> 4) << 3);
                        const int c = 2 * ks + ((lane >> 3) & 1);
                        uint32_t b0, b1, b2, b3;
                        ldsm_x4(sK + swz<CPR>(key, c) * 16, b0, b1, b2, b3);
                        mma16<T>(s[2 * np], qa, b0, b1);
                        mma16<T>(s[2 * np + 1], qa, b2, b3);
                    }
                }
            }
        }
        if (!go) continue;                        // warp-uniform
        const bool masked = k0 + kBK - 1 > p_lo;
        uint32_t dead = 0;                        // bit 4 j + x: masked
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                float y = s[j][x] * scale_log2;
                if (masked) {
                    const int key = k0 + 8 * j + 2 * tq + (x & 1);
                    if (key > pos[x >> 1] || key >= S) {
                        y = kNegInf;
                        dead |= 1u << (4 * j + x);
                    }
                }
                s[j][x] = y;
                mx[x >> 1] = fmaxf(mx[x >> 1], y);
            }
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            corr[r] = fast_exp2(m[r] - mx[r]);
            m[r] = mx[r];
            l[r] *= corr[r];
        }
#pragma unroll
        for (int d = 0; d < DT; ++d) {
            acc[d][0] *= corr[0];
            acc[d][1] *= corr[0];
            acc[d][2] *= corr[1];
            acc[d][3] *= corr[1];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const float p = (dead >> (4 * j + x)) & 1u
                    ? 0.f : fast_exp2(s[j][x] - m[x >> 1]);
                l[x >> 1] += p;
                s[j][x] = p;
            }
        }
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
            const uint32_t a[4] = {
                pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int dp = 0; dp < DT / 2; ++dp) {
                const int key = 16 * kk + (lane & 7)
                                + (((lane >> 3) & 1) << 3);
                const int c = 2 * dp + (lane >> 4);
                uint32_t b0, b1, b2, b3;
                ldsm_x4_trans(sV + swz<CPR>(key, c) * 16, b0, b1, b2, b3);
                mma16<T>(acc[2 * dp], a, b0, b1);
                mma16<T>(acc[2 * dp + 1], a, b2, b3);
            }
        }
    }

    uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        if (!live[r]) continue;
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int d = 0; d < DT; ++d)
            o32[word[r] + 4 * d + tq] = pack2<T>(acc[d][2 * r] / den,
                                                 acc[d][2 * r + 1] / den);
    }
}

// f32 on the CUDA cores, heads past 4096 only: 4 lanes a row, 64 rows a
// block, each lane 32 dims of the block's chunk of the accumulator (a
// lane's 4-float chunks j.4 + sub, so the 4 lanes of a row read 16 B each
// of one contiguous key row). A lane sums its share of the 64 keys' scores
// over every k-chunk (q's chunk from device memory, k's staged), then the
// 4 lanes' partials are reduced by shuffles in a fixed order and the
// softmax runs 16 keys at a time. One FMA per float read from shared
// memory and synchronous staging: 6 % of its bound at hd 512 (PERF.md).
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_wide_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int S, int H, int Hkv, int HD, int G, int GB, int BQ,
                      int n_qt, int n_bh, float scale) {
    constexpr int TPR = kChunk / 32;              // lanes per row
    constexpr int DPT = kChunk / TPR;             // dims per lane
    constexpr int NV = DPT / 4;                   // float4 chunks per lane
    extern __shared__ float4 smem4[];
    float4* sK = smem4;                           // (kBK, kChunk / 4)
    float4* sV = smem4 + kBK * kChunk / 4;

    const int cc = blockIdx.y;
    const int n_kc = HD / kChunk;
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
    const int64_t qrow = ((int64_t(b) * S + qpos) * H + h) * HD;

    float acc[DPT];
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
    float m = kNegInf, l = 0.f;

    const int kv_end = min(S, q0 + BQ);
    const int64_t kv_stride = int64_t(Hkv) * HD;
    const float* kb = k + (int64_t(b) * S * Hkv + kvh) * HD;
    const float* vb = v + (int64_t(b) * S * Hkv + kvh) * HD;
    float* sKf = reinterpret_cast<float*>(sK);
    float* sVf = reinterpret_cast<float*>(sV);

    for (int k0 = 0; k0 < kv_end; k0 += kBK) {
        const int nk = min(kBK, kv_end - k0);
        float s[kBK];                             // this lane's partials
#pragma unroll
        for (int c = 0; c < kBK; ++c) s[c] = 0.f;
        for (int kc = 0; kc < n_kc; ++kc) {
            float qr[DPT];
#pragma unroll
            for (int j = 0; j < NV; ++j) {
                const int64_t at = qrow + kc * kChunk + 4 * (j * TPR + sub);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    qr[4 * j + e] = live ? q[at + e] : 0.f;
            }
            __syncthreads();                      // the last chunk is used
            for (int i = t; i < kBK * kChunk; i += kF32Threads) {
                const int key = i / kChunk, d = i % kChunk;
                float kx = 0.f, vx = 0.f;         // zero past the tile's end
                if (key < nk) {
                    const int64_t off = int64_t(k0 + key) * kv_stride;
                    kx = kb[off + kc * kChunk + d];
                    if (kc == n_kc - 1) vx = vb[off + cc * kChunk + d];
                }
                sKf[i] = kx;
                if (kc == n_kc - 1) sVf[i] = vx;
            }
            __syncthreads();
#pragma unroll
            for (int c = 0; c < kBK; ++c) {
                const float4* kr = sK + c * (kChunk / 4);
                float dot = s[c];
#pragma unroll
                for (int j = 0; j < NV; ++j) {
                    const float4 kk = kr[j * TPR + sub];
                    dot += qr[4 * j] * kk.x + qr[4 * j + 1] * kk.y
                           + qr[4 * j + 2] * kk.z + qr[4 * j + 3] * kk.w;
                }
                s[c] = dot;
            }
        }
#pragma unroll
        for (int c0 = 0; c0 < kBK; c0 += kCH) {
            if (c0 >= nk) break;                  // block-uniform
            float sc[kCH];
            float mx = kNegInf;
#pragma unroll
            for (int c = 0; c < kCH; ++c) {
                float dot = s[c0 + c];
#pragma unroll
                for (int off = 1; off < TPR; off <<= 1)
                    dot += __shfl_xor_sync(0xffffffffu, dot, off);
                const int kv = k0 + c0 + c;
                const bool ok = c0 + c < nk && kv <= qpos && kv < S;
                sc[c] = ok ? dot * scale : kNegInf;
                mx = fmaxf(mx, sc[c]);
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
                const float p = ok ? expf(sc[c] - m_new) : 0.f;
                l += p;
                const float4* vr = sV + (c0 + c) * (kChunk / 4);
#pragma unroll
                for (int j = 0; j < NV; ++j) {
                    const float4 vv = vr[j * TPR + sub];
                    acc[4 * j] += p * vv.x;
                    acc[4 * j + 1] += p * vv.y;
                    acc[4 * j + 2] += p * vv.z;
                    acc[4 * j + 3] += p * vv.w;
                }
            }
            m = m_new;
        }
    }
    if (!live) return;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int64_t at = qrow + cc * kChunk + 4 * (j * TPR + sub);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[at + e] = acc[4 * j + e] * inv;
    }
}

// ---------------------------------------------------------------------------
// f32 past hd 512: a thread-block cluster computes the scores once
// ---------------------------------------------------------------------------
// flash_f32_cluster_kernel<BW> takes f32 at the widths 640 to 4096
// (multiples of kChunk). flash_f32_kernel cannot: at 64 rows a resident Q
// of hd 640 is 160 KB, which leaves room for one slab of its ring. Here a
// cluster of NC = ceil(hd / BW) blocks owns one output tile:
// flash_f32_kernel's 64 stacked rows, heads and heaviest-first order (tile
// c = blockIdx.x / NC). Block r of it (its rank in the cluster) owns O's
// columns BW r .. BW r + BW - 1 and holds the same BW dims of Q, M = BW /
// kChunk slices of 128. BW is 128 up to hd 2048 (NC = hd / 128, at most
// kF32MaxCluster) and 256 above it, up to hd 4096 (kF32MaxBlockCols): a
// cluster of 16 blocks cannot hold more columns of 128, so a block takes
// two, its Q slice 64 KB beside a ring of 3 slabs. Where hd / 128 is odd
// the last block's second 128 columns lie past hd: its Q, K and V there
// are zero-filled (they add nothing to the scores) and its O there is not
// stored. So:
//  - Scores. For each 64-key tile block r multiplies its slice of Q by its
//    BW dims of the tile's keys, one 128-dim slab after the other, with
//    flash_f32_kernel's 4 x 4 micro-tiles (2 FMAs a float read), and stores
//    the 64 x 64 partial in its own shared memory (thread t's 16 scores at
//    the float4s t + 256 x, so that a warp's stores and loads are
//    contiguous). The partials are added by a reduce-scatter and an
//    all-gather through distributed shared memory (mapa,
//    ld.shared::cluster), each behind a cluster barrier: block r adds slice
//    r of the tile (float4s SL r .. SL r + SL - 1, SL = 1024 / NC rounded
//    up) over the NC blocks' partials in rank order 0 .. NC - 1 into its
//    own sum buffer; then every thread loads its 16 scores from the blocks
//    that own them. So every block holds the same full-width scores, bit
//    for bit, and runs the same masked online softmax: Q.K^T is computed
//    once across the cluster, not NC times, and a block loads about 2 (NC -
//    1) / NC of a tile's partial from its peers, where each thread loading
//    its own 16 scores of every partial loads NC - 1 (on the H100 at hd 640
//    and the llama3-8b layer's heads and length: 64.1 ms that way, 62.8
//    this way, 56.0 with no exchange at all).
//  - Overlap. Both barriers are split: a block arrives once its partial
//    (its slice's sums) is stored and waits after the first (second) half
//    of the tile before's P.V, which covers the peers' skew and the
//    barriers' latency (the first design, one barrier, took 71.7 ms
//    unsplit against 64.1 split, same card and shapes). A half is the
//    first (last) 32 keys of the one V slab at BW 128, the first (second)
//    V slab at BW 256. Each buffer is written again only after a barrier
//    that every block reaches once it has read it: the partial after the
//    second, the sums after the next tile's first.
//  - O. P^T goes through shared memory and O += P.V runs over each of the
//    block's V slabs into its own 128 columns of O (f32_pv, 4 x 8 of O a
//    thread a slab, 2.7 FMAs a float). K and V slabs (64 keys x 128 dims)
//    arrive by cp.async through a ring of R slabs (4 at BW 128, 3 at 256)
//    in the order K 0, then K t + 1 and V t, then the last V, each as M
//    slabs in column order and R - 1 slabs ahead of its use; keys past S
//    are zero-filled. Scale, exponent and masking are flash_f32_kernel's
//    (hd^-0.5 . log2 e, ex2.approx, -1e30, masked p set to 0 again).
//  - Every block of a cluster reaches every barrier: the tiles are the
//    cluster's (its rows are shared). A last barrier keeps a block from
//    leaving while a peer may still read its sums.
// Clusters of more than 8 blocks are non-portable: the launch asks the
// card how many clusters of NC blocks it holds at once
// (cudaOccupancyMaxActiveClusters) and returns an error if none. Past hd
// 4096 the f32 column-chunk kernel above takes the width, a choice made
// before the launch. Shared memory: Q's slice, the ring, the partial and
// the slice's sums, P^T and the rows' rescale and sums: 208.5 KB a block
// at either BW (ClusterPlan<BW>::smem).
constexpr int kF32MaxCluster = 16;     // blocks a cluster at most
constexpr int kF32MaxBlockCols = 256;  // a block's columns at most: hd 4096

// flash_f32_cluster_kernel<BW>'s tiles, by flash_f32_kernel's rules at 64
// rows and a kChunk-wide slab: M slabs of D = kChunk dims a block's BW
// columns; SR rows x 4 keys of the scores, OR rows x NJ 16-byte chunks of
// O a thread a slab and TOC threads across a slab's CD chunks; CQ 16-byte
// chunks a row of the Q slice; PART floats a score tile (the partial, the
// sums); R ring slots (as many as 227 KB leave, at most 4).
// flash_f32_cluster_plan (an entry point at the end) reports them, and the
// wrapper's f32_cluster_plan mirrors them.
template <int BW>
struct ClusterPlan {
    static constexpr int BM = 64;
    static constexpr int D = kChunk;
    static constexpr int M = BW / D;
    static constexpr int CQ = BW / 4, CD = D / 4, CP = BM / 4;
    static constexpr int SR = BM / 16;
    static constexpr int OC = BM * D / kF32Threads;   // O floats a slab
    static constexpr int OR = OC >= 64 ? 8 : OC >= 16 ? 4 : OC / 4;
    static constexpr int TOC = kF32Threads * OR / BM;
    static constexpr int NJ = CD / TOC;
    static constexpr int PART = BM * kBK;
    static constexpr int FIXED = (BM * BW + 2 * PART + kBK * BM + 2 * BM) * 4;
    static constexpr int SLAB = kBK * D * 4;
    static constexpr int FIT = (kSmemBytes - FIXED) / SLAB;
    static constexpr int R = FIT < 4 ? FIT : 4;
    static constexpr size_t smem = FIXED + size_t(R) * SLAB;
    static_assert(4 * SR * kF32Threads == PART && SR % 4 == 0
                  && TOC * NJ == CD && BW % D == 0 && R >= 2,
                  "a thread's scores tile the partial; O's chunks a slab");
};
static_assert(ClusterPlan<128>::smem == 213504
              && ClusterPlan<256>::smem == 213504,
              "the cluster plans' shared bytes");
static_assert(ClusterPlan<128>::R == 4 && ClusterPlan<256>::R == 3,
              "the cluster plans' ring slots");

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the address in cluster block ``rank``'s shared memory of ``local``'s here
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local,
                                                 unsigned rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(local), "r"(rank));
    return remote;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
    float4 x;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "r"(addr));
    return x;
}

template <int BW>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_cluster_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int S, int H, int Hkv, int HD, int G, int GB,
                         int BQ, int n_qt, int n_bh, float scale_log2) {
    using P = ClusterPlan<BW>;
    constexpr int BM = P::BM, D = P::D, M = P::M, CQ = P::CQ, CD = P::CD;
    constexpr int CP = P::CP, SR = P::SR, TOC = P::TOC, OR = P::OR;
    constexpr int NJ = P::NJ, R = P::R;
    constexpr int SLAB = kBK * CD;               // float4s a slab
    constexpr int PART4 = P::PART / 4;           // float4s a partial
    extern __shared__ float4 smem4[];
    float4* sQ = smem4;                          // (BM, CQ), row-major
    float4* sRing = sQ + BM * CQ;                // R slabs (kBK, CD), swizzled
    float4* sPart = sRing + R * SLAB;            // the partial, by thread
    float4* sSum = sPart + PART4;                // the sums, by thread
    float4* sP = sSum + PART4;                   // P^T (kBK, CP), swizzled
    float* sCorr = reinterpret_cast<float*>(sP + kBK * CP);  // BM
    float* sL = sCorr + BM;                                  // BM

    const int NC = (HD + BW - 1) / BW;
    const int me = int(cluster_rank());
    const int col0 = me * BW;                    // this block's columns
    const int SL = (PART4 + NC - 1) / NC;        // float4s a sum slice
    const int bid = blockIdx.x / NC;             // the cluster's tile
    const int qt = n_qt - 1 - bid / n_bh;        // heaviest tiles first
    const int bh = bid % n_bh;
    const int n_gr = (G + GB - 1) / GB;
    const int gr = bh % n_gr;
    const int kvh = (bh / n_gr) % Hkv;
    const int b = bh / (n_gr * Hkv);
    const int t = threadIdx.x;
    const int tx = t % 16, ty = t / 16;          // scores: keys, rows
    const int ox = t % TOC, oy = t / TOC;        // output: chunks, rows
    const int q0 = qt * BQ;
    const int kv_end = min(S, q0 + BQ);          // keys past it are masked
    const int n_tiles = (kv_end + kBK - 1) / kBK;
    const int n_units = 2 * n_tiles;             // a K and a V unit a tile
    const int n_steps = M * n_units;             // M slabs a unit

    const int64_t kv_stride = int64_t(Hkv) * HD;
    const float* kb = k + (int64_t(b) * S * Hkv + kvh) * HD + col0;
    const float* vb = v + (int64_t(b) * S * Hkv + kvh) * HD + col0;
    const uint32_t sQa =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
    const uint32_t sRa = sQa + BM * CQ * 16;
    const uint32_t sPartA = sRa + R * SLAB * 16;
    const uint32_t sSumA = sPartA + PART4 * 16;

    // the block's BW dims of the q rows, zero-filled where no row is live
    // or the dims lie past hd, arrive with the first slab
    for (int i = t; i < BM * CQ; i += kF32Threads) {
        const int rho = i / CQ, c = i % CQ;
        const int qi = rho / GB, g = gr * GB + rho % GB;
        const bool in = qi < BQ && g < G && q0 + qi < S
                        && col0 + 4 * c < HD;
        const int64_t off =
            in ? ((int64_t(b) * S + q0 + qi) * H + kvh * G + g) * HD + col0
                 + 4 * c : 0;
        cp_async16(sQa + i * 16, q + off, in ? 16 : 0);
    }
    // step i takes slab i into slot i % R: slab p = i % M (dims D p ..)
    // of unit u = i / M, which is K of tile 0; then K of tile (u + 1) / 2
    // for odd u and V of tile u / 2 - 1 for even u; the last unit V of the
    // last tile
    auto load = [&](int i) {
        const int u = i / M, p = i % M;
        const bool is_v = u > 0 && (u % 2 == 0 || u == n_units - 1);
        const int tile = !is_v ? (u + 1) / 2
                         : u == n_units - 1 ? n_tiles - 1 : u / 2 - 1;
        const int k0 = tile * kBK;
        const bool cols = col0 + p * D < HD;
        const float* src = (is_v ? vb : kb) + p * D;
        const uint32_t dst = sRa + (i % R) * SLAB * 16;
        for (int e = t; e < SLAB; e += kF32Threads) {
            const int key = e / CD, c = e % CD;
            const bool in = cols && k0 + key < S;
            const int64_t off = in ? (k0 + key) * kv_stride + 4 * c : 0;
            cp_async16(dst + swz<CD>(key, c) * 16, src + off, in ? 16 : 0);
        }
    };

    float s[SR][4], m[SR], l[SR], acc[M][OR][4 * NJ];
#pragma unroll
    for (int r = 0; r < SR; ++r) {
        m[r] = kNegInf;
        l[r] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < M; ++x)
#pragma unroll
        for (int r = 0; r < OR; ++r)
#pragma unroll
            for (int e = 0; e < 4 * NJ; ++e) acc[x][r][e] = 0.f;

#pragma unroll
    for (int i = 0; i < R - 1; ++i) {
        if (i < n_steps) load(i);
        cp_async_commit();
    }
    // slab i's slot, once it has landed and slot i - 1 is free again
    auto next = [&](int i) -> const float4* {
        cp_async_wait<R - 2>();
        __syncthreads();
        if (i + R - 1 < n_steps) load(i + R - 1);
        cp_async_commit();
        return sRing + (i % R) * SLAB;
    };
    // O = O . corr, with the corr of the tile whose P V comes next
    auto rescale = [&]() {
#pragma unroll
        for (int r = 0; r < OR; ++r) {
            const float cr = sCorr[OR * oy + r];
#pragma unroll
            for (int x = 0; x < M; ++x)
#pragma unroll
                for (int e = 0; e < 4 * NJ; ++e) acc[x][r][e] *= cr;
        }
    };
    int i = 0;
    // half h (0 or 1) of the tile before's O += P V: its keys h 32 .. h 32
    // + 31 of the one V slab (BW 128), its V slabs h M / 2 .. (BW 256)
    const float4* vslab = nullptr;
    auto pv_half = [&](int h) {
        if constexpr (M == 1) {
            if (h == 0) {
                vslab = next(i++);
                rescale();
                f32_pv<CD, CP, TOC, OR, NJ, 0, kBK / 2>(acc[0], vslab, sP,
                                                        ox, oy);
            } else {
                f32_pv<CD, CP, TOC, OR, NJ, kBK / 2, kBK / 2>(acc[0], vslab,
                                                              sP, ox, oy);
            }
        } else {
#pragma unroll
            for (int x = 0; x < M; ++x) {
                if (x / (M / 2) != h) continue;
                const float4* slab = next(i++);
                if (x == 0) rescale();
                f32_pv<CD, CP, TOC, OR, NJ>(acc[x], slab, sP, ox, oy);
            }
        }
    };
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int k0 = tile * kBK;
        // this block's BW dims of S = Q K^T, d in order
#pragma unroll
        for (int r = 0; r < SR; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll
        for (int x = 0; x < M; ++x) {
            const float4* slab = next(i++);
            const float4* qrow = sQ + SR * ty * CQ + x * CD;
#pragma unroll 8
            for (int c = 0; c < CD; ++c) {
                float4 kf[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    kf[j] = slab[swz<CD>(tx + 16 * j, c)];
#pragma unroll
                for (int r = 0; r < SR; ++r) {
                    const float4 qf = qrow[r * CQ + c];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[r][j] = fmaf(qf.x, kf[j].x, s[r][j]);
                        s[r][j] = fmaf(qf.y, kf[j].y, s[r][j]);
                        s[r][j] = fmaf(qf.z, kf[j].z, s[r][j]);
                        s[r][j] = fmaf(qf.w, kf[j].w, s[r][j]);
                    }
                }
            }
        }
#pragma unroll
        for (int x = 0; x < SR; ++x)
            sPart[x * kF32Threads + t] =
                make_float4(s[x][0], s[x][1], s[x][2], s[x][3]);
        cluster_arrive();                        // this block's partial is in
        if (tile > 0) pv_half(0);                // the tile before's P V
        cluster_wait();                          // every block's partial is in
        // this block's slice of the full-width scores: the NC partials
        // added in rank order
        for (int e = me * SL + t; e < min(me * SL + SL, PART4);
             e += kF32Threads) {
            float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
            for (int rank = 0; rank < NC; ++rank) {
                const float4 p4 = ld_cluster4(cluster_addr(sPartA + e * 16,
                                                           rank));
                sum.x += p4.x;
                sum.y += p4.y;
                sum.z += p4.z;
                sum.w += p4.w;
            }
            sSum[e] = sum;
        }
        cluster_arrive();                        // this block's sums are in
        if (tile > 0) pv_half(1);                // the second half
        cluster_wait();                          // every block's sums are in
        // this thread's 16 scores, from the blocks that summed them
#pragma unroll
        for (int x = 0; x < SR; ++x) {
            const int e = x * kF32Threads + t;
            const float4 p4 = ld_cluster4(cluster_addr(sSumA + e * 16,
                                                       e / SL));
            s[x][0] = p4.x;
            s[x][1] = p4.y;
            s[x][2] = p4.z;
            s[x][3] = p4.w;
        }
        __syncthreads();                    // the tile before's P^T is read
        // scale, mask (only a tile that reaches past the block's first
        // position), the rows' new max over their 16 lanes, p, and P^T and
        // the rescale to shared memory
        const bool masked = k0 + kBK - 1 > q0;
#pragma unroll
        for (int r = 0; r < SR; ++r) {
            const int rho = SR * ty + r;
            const int pos = q0 + rho / GB;
            uint32_t dead = 0;
            float mx = m[r];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int key = k0 + tx + 16 * j;
                if (masked && (key > pos || key >= S)) dead |= 1u << j;
                s[r][j] = (dead >> j) & 1u ? kNegInf : s[r][j] * scale_log2;
                mx = fmaxf(mx, s[r][j]);
            }
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float corr = fast_exp2(m[r] - mx);
            m[r] = mx;
            l[r] *= corr;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float pj = (dead >> j) & 1u
                    ? 0.f : fast_exp2(s[r][j] - mx);
                l[r] += pj;
                s[r][j] = pj;
            }
            if (tx == 0) sCorr[rho] = corr;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int rc = 0; rc < SR / 4; ++rc)
                sP[swz<CP>(tx + 16 * j, SR * ty / 4 + rc)] =
                    make_float4(s[4 * rc][j], s[4 * rc + 1][j],
                                s[4 * rc + 2][j], s[4 * rc + 3][j]);
    }
    cluster_arrive();                            // the last sums are read
#pragma unroll
    for (int x = 0; x < M; ++x) {                // V of the last tile
        const float4* slab = next(i++);
        if (x == 0) rescale();
        f32_pv<CD, CP, TOC, OR, NJ>(acc[x], slab, sP, ox, oy);
    }

#pragma unroll
    for (int r = 0; r < SR; ++r) {
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
        if (tx == 0) sL[SR * ty + r] = l[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < OR; ++r) {
        const int rho = OR * oy + r;
        const int qi = rho / GB, g = gr * GB + rho % GB;
        if (qi >= BQ || g >= G || q0 + qi >= S) continue;
        const float den = fmaxf(sL[rho], 1e-30f);
        float* orow =
            o + ((int64_t(b) * S + q0 + qi) * H + kvh * G + g) * HD + col0;
#pragma unroll
        for (int x = 0; x < M; ++x) {
            if (col0 + x * D >= HD) continue;    // past hd: not stored
            float4* ochunk = reinterpret_cast<float4*>(orow + x * D);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                ochunk[ox + TOC * j] = make_float4(
                    acc[x][r][4 * j] / den, acc[x][r][4 * j + 1] / den,
                    acc[x][r][4 * j + 2] / den, acc[x][r][4 * j + 3] / den);
        }
    }
    cluster_wait();        // no block leaves while a peer may read its sums
}

// ---------------------------------------------------------------------------

// Stacked rows of one KV head: GB of its G query heads by BQ positions,
// in n_gr groups of heads.
struct Tiling {
    int G, GB, BQ, n_gr, n_qt, n_bh;
    Tiling(int B, int S, int H, int Hkv, int rows)
        : G(H / Hkv), GB(G < rows ? G : rows), BQ(rows / GB),
          n_gr((G + GB - 1) / GB), n_qt((S + BQ - 1) / BQ),
          n_bh(B * Hkv * n_gr) {}
    unsigned blocks() const { return unsigned(int64_t(n_qt) * n_bh); }
};

// the dtype codes of flash_attention_fwd
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename K, typename... Args>
int launch_kernel(K kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, threads, smem, stream>>>(args...);
    return int(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Hkv, float scale, cudaStream_t stream) {
    const Tiling t(B, S, H, Hkv, F32Plan<HD>::BM);
    return launch_kernel(
        flash_f32_kernel<HD>, dim3(t.blocks()), kF32Threads,
        F32Plan<HD>::smem, stream, static_cast<const float*>(q),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), S, H, Hkv, t.G, t.GB, t.BQ, t.n_qt, t.n_bh,
        scale * 1.4426950408889634f);
}

template <int HD, typename T>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Hkv, float scale, cudaStream_t stream) {
    const Tiling t(B, S, H, Hkv, kRows);
    return launch_kernel(
        flash_mma_kernel<HD, T>, dim3(t.blocks()), kThreads,
        (size_t(kStages) * 2 * kBK + kRows) * HD * 2, stream,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, t.G, t.GB,
        t.BQ, t.n_qt, t.n_bh, scale * 1.4426950408889634f);
}

template <int W, typename T>
int launch_mma_wide(const void* q, const void* k, const void* v, void* o,
                    int B, int S, int H, int Hkv, int row, float scale,
                    cudaStream_t stream) {
    const Tiling t(B, S, H, Hkv, kWideRows);
    return launch_kernel(
        flash_mma_wide_kernel<W, T>, dim3(t.blocks()), kWideThreads,
        WidePlan<W>::smem, stream, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), S, H, Hkv, row, t.G, t.GB, t.BQ, t.n_qt, t.n_bh,
        scale * 1.4426950408889634f);
}

// 16-bit heads: flash_mma_kernel up to 128, flash_mma_wide_kernel at 256,
// 384 and 512 (rows of `row` values in memory), the column-chunk kernel
// past 512
template <typename T>
int launch16(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int hd, int row, float scale,
             cudaStream_t s) {
    switch (hd) {
        case 16: return launch_mma<16, T>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 32: return launch_mma<32, T>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 64: return launch_mma<64, T>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 128:
            return launch_mma<128, T>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 256:
            return launch_mma_wide<256, T>(q, k, v, o, B, S, H, Hkv, row,
                                           scale, s);
        case 384:
            return launch_mma_wide<384, T>(q, k, v, o, B, S, H, Hkv, row,
                                           scale, s);
        case 512:
            return launch_mma_wide<512, T>(q, k, v, o, B, S, H, Hkv, row,
                                           scale, s);
        default: {
            const Tiling t(B, S, H, Hkv, kRows);
            return launch_kernel(
                flash_mma_chunk_kernel<T>, dim3(t.blocks(), hd / kChunk),
                kThreads, size_t(3) * kBK * kChunk * 2, s,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, hd,
                t.G, t.GB, t.BQ, t.n_qt, t.n_bh,
                scale * 1.4426950408889634f);
        }
    }
}

// flash_f32_cluster_kernel<BW>'s launch for clusters of NC blocks over
// ``tiles`` output tiles (cfg points at attr); *resident: the clusters of
// NC blocks the card holds at once
template <int BW>
cudaError_t cluster_setup(int NC, unsigned tiles, cudaStream_t stream,
                          cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                          int* resident) {
    auto kernel = flash_f32_cluster_kernel<BW>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(ClusterPlan<BW>::smem));
    if (err == cudaSuccess && NC > 8)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(tiles * unsigned(NC));
    cfg->blockDim = dim3(kF32Threads);
    cfg->dynamicSmemBytes = ClusterPlan<BW>::smem;
    cfg->stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = NC;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(resident, kernel, cfg);
}

// the cluster kernel's block width at the f32 width hd (a multiple of
// kChunk above 512): kChunk while hd / kChunk blocks fit a cluster, else
// kF32MaxBlockCols; 0 past the widest cluster (the column-chunk kernel)
int cluster_block_cols(int hd) {
    if (hd / kChunk <= kF32MaxCluster) return kChunk;
    if (hd <= kF32MaxCluster * kF32MaxBlockCols) return kF32MaxBlockCols;
    return 0;
}

template <int BW>
int launch_cluster(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int Hkv, int hd, float scale,
                   cudaStream_t s) {
    const int NC = (hd + BW - 1) / BW;
    const Tiling t(B, S, H, Hkv, ClusterPlan<BW>::BM);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int resident = 0;
    cudaError_t err = cluster_setup<BW>(NC, t.blocks(), s, &cfg, attr,
                                        &resident);
    if (err != cudaSuccess) return int(err);
    if (resident < 1) return int(cudaErrorInvalidConfiguration);
    err = cudaLaunchKernelEx(
        &cfg, flash_f32_cluster_kernel<BW>, static_cast<const float*>(q),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), S, H, Hkv, hd, t.G, t.GB, t.BQ, t.n_qt,
        t.n_bh, scale * 1.4426950408889634f);
    return err != cudaSuccess ? int(err) : int(cudaGetLastError());
}

// f32 heads: flash_f32_kernel up to 512, the cluster kernel up to
// kF32MaxCluster kF32MaxBlockCols, the column-chunk kernel past it (by
// width, before any launch)
int launch32(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int hd, float scale, cudaStream_t s) {
    switch (hd) {
        case 16: return launch_f32<16>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 32: return launch_f32<32>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 64: return launch_f32<64>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 128: return launch_f32<128>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 256: return launch_f32<256>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 384: return launch_f32<384>(q, k, v, o, B, S, H, Hkv, scale, s);
        case 512: return launch_f32<512>(q, k, v, o, B, S, H, Hkv, scale, s);
        default: break;
    }
    switch (cluster_block_cols(hd)) {
        case kChunk:
            return launch_cluster<kChunk>(q, k, v, o, B, S, H, Hkv, hd,
                                          scale, s);
        case kF32MaxBlockCols:
            return launch_cluster<kF32MaxBlockCols>(q, k, v, o, B, S, H, Hkv,
                                                    hd, scale, s);
        default: break;
    }
    const Tiling t(B, S, H, Hkv, kF32Threads / (kChunk / 32));
    return launch_kernel(
        flash_f32_wide_kernel, dim3(t.blocks(), hd / kChunk), kF32Threads,
        2 * size_t(kBK) * kChunk * sizeof(float), s,
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, hd,
        t.G, t.GB, t.BQ, t.n_qt, t.n_bh, scale);
}

template <int HD>
int f32_plan(int* out) {
    using P = F32Plan<HD>;
    const int v[] = {P::BM, P::D, P::R, P::SR, P::OR, P::TOC, P::NJ,
                     int(P::smem)};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
}

// the entry point flash_f32_cluster_plan's report at block width BW
template <int BW>
int cluster_plan(int hd, int* out) {
    using P = ClusterPlan<BW>;
    const int NC = (hd + BW - 1) / BW;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int resident = 0;
    const cudaError_t err = cluster_setup<BW>(NC, 1, nullptr, &cfg, attr,
                                              &resident);
    if (err != cudaSuccess) return int(err);
    const int v[] = {NC, BW, P::BM, P::D, P::R, P::SR, P::OR, P::TOC, P::NJ,
                     int(P::smem), kF32MaxCluster * kF32MaxBlockCols,
                     resident};
    for (int i = 0; i < 12; ++i) out[i] = v[i];
    return 0;
}

}  // namespace

extern "C" {

// q, o: (B, S, H, row); k, v: (B, S, Hkv, row); all contiguous, of one
// dtype (dtype 0 float32, 1 bf16, 2 f16); H a multiple of Hkv; hd, the
// width the kernels run at, in {16, 32, 64, 128, 256, 384, 512} or a
// multiple of 128 above 512 (the wrapper zero-pads any other width to the
// next of these and passes the true width's scale). row is hd, except for
// bf16 and f16 at hd 256, 384 and 512, whose kernel takes rows of any
// multiple of 8 above 128 up to hd and zero-fills the rest in shared
// memory.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int S, int H, int Hkv, int hd,
                        int row, int dtype, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool instance = hd == 16 || hd == 32 || hd == 64 || hd == 128
                          || hd == 256 || hd == 384 || hd == 512;
    const bool short_rows = dtype != kF32 && hd >= 256 && hd <= 512
                            && row > 128 && row < hd && row % 8 == 0;
    if (!(instance || (hd > 512 && hd % kChunk == 0))
        || (row != hd && !short_rows))
        return int(cudaErrorInvalidValue);
    switch (dtype) {
        case kBF16:
            return launch16<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd, row,
                                           scale, s);
        case kF16:
            return launch16<__half>(q, k, v, o, B, S, H, Hkv, hd, row, scale,
                                    s);
        default:
            return launch32(q, k, v, o, B, S, H, Hkv, hd, scale, s);
    }
}

// flash_f32_kernel<hd>'s tiles as F32Plan chooses them, for hd in {16, 32,
// 64, 128, 256, 384, 512}: out[0..7] = BM, D, R, SR, OR, TOC, NJ, smem
// (repro_torch.kernels.flash_attention.f32_plan mirrors the rule). Launches
// nothing.
int flash_f32_plan(int hd, int* out) {
    switch (hd) {
        case 16: return f32_plan<16>(out);
        case 32: return f32_plan<32>(out);
        case 64: return f32_plan<64>(out);
        case 128: return f32_plan<128>(out);
        case 256: return f32_plan<256>(out);
        case 384: return f32_plan<384>(out);
        case 512: return f32_plan<512>(out);
        default: return int(cudaErrorInvalidValue);
    }
}

// flash_f32_cluster_kernel's tiles at the f32 width hd (a multiple of 128
// from 640 to kF32MaxCluster kF32MaxBlockCols): out[0..11] = NC, BW, BM,
// D, R, SR, OR, TOC, NJ, smem, the widest width the kernel takes, and the
// clusters of NC blocks the card holds at once
// (repro_torch.kernels.flash_attention.f32_cluster_plan mirrors all but
// the last). Launches nothing.
int flash_f32_cluster_plan(int hd, int* out) {
    if (hd <= 512 || hd % kChunk) return int(cudaErrorInvalidValue);
    switch (cluster_block_cols(hd)) {
        case kChunk: return cluster_plan<kChunk>(hd, out);
        case kF32MaxBlockCols: return cluster_plan<kF32MaxBlockCols>(hd, out);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // extern "C"
