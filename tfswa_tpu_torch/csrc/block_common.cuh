// Device helpers shared by the port's kernels (fused_block.cu,
// fused_block_bwd.cu, row_attention.cu).  Each .cu is its own library; this
// header is compiled into each.
//
// The tensor-core tile: a warp-level bf16 product on
// mma.sync.aligned.m16n8k16 with f32 sums (and its int8 form, m16n8k32
// with exact int32 sums), its fragments loaded from shared memory by
// ldmatrix, and the block-level product block_gemm, which streams a weight
// through shared memory with cp.async.  Every product of B1's three
// launches (ln_qkv_kernel below; attn_kernel and post_kernel in
// fused_block.cu), of B2's launches (fused_block_bwd.cu) and of B4
// (row_attention.cu) runs on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // threads per block of the lab's SIMT launches
constexpr float SCORE_CLAMP = 110.0f;

typedef __nv_bfloat16 bf16;

// min(s, SCORE_CLAMP) that keeps a NaN s, as jnp.minimum and torch.clamp
// do (fminf returns the other operand: a NaN score would become 110 and p
// the finite 2^110).  PTX min.NaN, one instruction; its NaN is 0x7fffffff.
__device__ __forceinline__ float clamp_score(float s) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(s), "f"(SCORE_CLAMP));
    return r;
}

// max(a, b) that keeps a NaN, as jnp.max and torch.amax do (fmaxf drops
// it): PTX max.NaN, one instruction.  B3's row scales, so that a NaN q or
// k makes its row's scores NaN.
__device__ __forceinline__ float max_keep_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// 2^x on the MUFU, results below 2^-126 flushed to 0 (ex2.approx.ftz)
__device__ __forceinline__ float ex2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// ---------------------------------------------------------------------------
// The tensor-core tile.
//
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: D (16 x 8, f32) =
// A (16 x 16, bf16) B (16 x 8, bf16) + C.  The products of two bf16 are
// exact; the sums are f32, in the tensor core's own order.  With g = lane / 4
// and q = lane % 4, a thread holds
//   A, 4 registers of 2 bf16 (the lower k in the lower half):
//     a[0] = (row g,     k 2q, 2q+1)    a[1] = (row g + 8, k 2q, 2q+1)
//     a[2] = (row g,     k 2q+8, 2q+9)  a[3] = (row g + 8, k 2q+8, 2q+9)
//   B, 2 registers:  b[0] = (k 2q, 2q+1; col g)   b[1] = (k 2q+8, 2q+9; col g)
//   C and D, 4 f32:  c[0], c[1] = (row g, cols 2q, 2q+1)
//                    c[2], c[3] = (row g + 8, cols 2q, 2q+1)
// So the accumulators of two adjacent n-tiles (cols 0-7 and 8-15), rounded
// to bf16 and packed in pairs, are exactly the A fragment of a 16 x 16
// operand whose k runs over those 16 columns (pack_a): a product's result
// feeds the next product from registers (B4's t and p).
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i (16-byte aligned), and each thread receives of
// matrix i the pair (row g, cols 2q, 2q+1) in register i, or with .trans the
// pair (rows 2q, 2q+1; col g).  Hence:
//   A 16 x 16 from a row-major tile:  lane l points at row l % 16, col
//     8 (l / 16): registers a[0..3] as above (ldsm_a);
//   B 16 x 16 (two n-tiles) from a k-major tile (rows = k, a weight
//     W (K, N) as stored): the same addresses with .trans; registers 0, 1
//     are n-tile 0's b[0], b[1], registers 2, 3 n-tile 1's (ldsm_b_kmajor);
//   B from an n-major tile (rows = n, B's columns stored contiguously over
//     k, as the keys x of B4's scores): lane l points at row (l % 8) +
//     8 (l / 16), col 8 ((l / 8) % 2), no .trans; the same register order
//     (ldsm_b_nmajor).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product into d, from an accumulator c that is kept (a seed used
// for several products).
__device__ __forceinline__ void mma_bf16_to(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1, const float (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// m16n8k8: D (16 x 8, f32) = A (16 x 8, bf16) B (8 x 8, bf16) + c, half the
// k16 product's work: A 2 registers, a[0] = (row g, k 2q, 2q+1), a[1] = (row
// g + 8, k 2q, 2q+1), the k16 fragment's a[0], a[1] (k 0-7) or a[2], a[3]
// (k 8-15); B one register (k 2q, 2q+1; col g), the k16 fragment's b[0] or
// b[1].
__device__ __forceinline__ void mma_bf16_k8_to(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t b, const float (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(b), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: D (16 x 8, int32) =
// A (16 x 32, int8) B (32 x 8, int8) + C, summed exactly.  Four int8 a
// register, the lowest k in the lowest byte:
//   a[0] = (row g, k 4q..4q+3)       a[1] = (row g + 8, k 4q..4q+3)
//   a[2] = (row g, k 4q+16..4q+19)   a[3] = (row g + 8, k 4q+16..4q+19)
//   b[0] = (k 4q..4q+3; col g)       b[1] = (k 4q+16..4q+19; col g)
// and C, D as for the bf16 form.  An n-major int8 tile (rows = n, 32 bytes
// of k contiguous) gives its B fragments through ldsm_b_nmajor on the same
// bytes read as bf16 pairs (k0 = 0): byte pair 2q, 2q+1 of b16 lanes is
// bytes 4q..4q+3.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

// two matrices (lanes 0-15 give the addresses): one n-tile of B, k-major
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p))
                 : "memory");
}

// The A fragment of rows 0-15, cols k0..k0+15 of a row-major bf16 tile
// (row stride ld elements, a multiple of 8).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile, int ld, int k0) {
    const int l = threadIdx.x & 31;
    ldsm_x4(a, tile + (l & 15) * ld + k0 + (l >> 4) * 8);
}

// B fragments of n-tiles n0/8 and n0/8 + 1, k rows k0..k0+15, of a k-major
// tile (rows = k): b[0], b[1] the first n-tile's, b[2], b[3] the second's.
__device__ __forceinline__ void ldsm_b_kmajor(uint32_t (&b)[4], const bf16* tile, int ld,
                                              int k0, int n0) {
    const int l = threadIdx.x & 31;
    ldsm_x4_t(b, tile + (k0 + (l & 15)) * ld + n0 + (l >> 4) * 8);
}

// The same from an n-major tile (rows = n, k contiguous).
__device__ __forceinline__ void ldsm_b_nmajor(uint32_t (&b)[4], const bf16* tile, int ld,
                                              int k0, int n0) {
    const int l = threadIdx.x & 31;
    ldsm_x4(b, tile + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 + ((l >> 3) & 1) * 8);
}

// The A fragment of rows m0..m0+15, k rows k0..k0+15 of a k-major tile
// (rows = k, the rows of A stored contiguously: A^T as stored), by
// ldmatrix.trans: matrix i is k rows 8 (i / 2).. and A rows 8 (i % 2)..
__device__ __forceinline__ void ldsm_a_kmajor(uint32_t (&a)[4], const bf16* tile, int ld,
                                              int k0, int m0) {
    const int l = threadIdx.x & 31;
    ldsm_x4_t(a, tile + (k0 + (l & 7) + ((l >> 4) << 3)) * ld + m0 + ((l >> 3) & 1) * 8);
}

// Two f32 rounded to bf16 and packed, the first in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (k = the 16 columns of n-tiles j, j + 1) from two
// accumulators, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
    a[0] = pack_bf16(c0[0], c0[1]);
    a[1] = pack_bf16(c0[2], c0[3]);
    a[2] = pack_bf16(c1[0], c1[1]);
    a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes from device memory to shared memory, asynchronously; with
// valid false nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid = true) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows), the first `width` columns, of a row-major bf16
// tensor of row stride ld_src into a shared tile of row stride ld; rows
// from the M_left-th on as zeros; by all NTHR threads of the block,
// asynchronously (the caller commits).  width, ld_src multiples of 8.
template <int NTHR>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, int ld_src,
                                           size_t row0, int rows, int M_left, int width) {
    const int per_row = width / 8;
    for (int i = threadIdx.x; i < rows * per_row; i += NTHR) {
        const int r = i / per_row, c = (i % per_row) * 8;
        const bool valid = r < M_left;
        cp_async16(dst + r * ld + c, src + (row0 + (valid ? r : 0)) * ld_src + c, valid);
    }
}

// Block-level product on the tensor cores:
//   acc (this warp's 16 x 8 NT tile) += A[16 rows, 0:K] W[0:K, n0 + wcol0 .. + 8 NT)
// A: bf16 in shared memory (a points at the warp's first row, row stride
// lda); W: bf16 (K, ldw) row-major in device memory.  The block's NTHR
// threads stage W[k0:k0+KS, n0:n0+NCH] for k0 = 0, KS, ... into wbuf, two
// buffers of KS x (NCH + 8) bf16 (8 of padding, so that ldmatrix's eight
// rows fall on distinct banks), with cp.async, the next slice in flight
// while the warps multiply the current one.  Every thread of the block
// calls it (it holds barriers), with the same n0 and K; the caller's shared
// writes of A before the call are seen.  K % KS == 0, NT even, ldw and n0
// multiples of 8, W 16-byte aligned.  W's rows from k_valid on and its
// columns from n_valid on are read as zeros, and nothing past them is read
// (a ragged last chunk of the MLP's hidden units).
constexpr int KS = 32;

template <int NT, int NCH, int NTHR>
__device__ __forceinline__ void block_gemm(float (&acc)[NT][4], const bf16* a, int lda,
                                           const bf16* w, int ldw, int n0, int K, bf16* wbuf,
                                           int wcol0, int k_valid = 1 << 30,
                                           int n_valid = 1 << 30) {
    static_assert(NT % 2 == 0 && NCH % 8 == 0, "block_gemm: NT even, NCH a multiple of 8");
    constexpr int LDB = NCH + 8;
    constexpr int PER_ROW = NCH / 8;
    auto stage = [&](int s) {
        bf16* dst = wbuf + (s & 1) * KS * LDB;
        for (int i = threadIdx.x; i < KS * PER_ROW; i += NTHR) {
            const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
            const int k = s * KS + r;
            const bool ok = k < k_valid && n0 + c < n_valid;
            cp_async16(dst + r * LDB + c, ok ? w + (size_t)k * ldw + n0 + c : w, ok);
        }
    };
    const int nk = K / KS;
    stage(0);
    cp_async_commit();
    for (int s = 0; s < nk; ++s) {
        if (s + 1 < nk) stage(s + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const bf16* b = wbuf + (s & 1) * KS * LDB + wcol0;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
            uint32_t af[4];
            ldsm_a(af, a, lda, s * KS + kk);
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                uint32_t bfr[4];
                ldsm_b_kmajor(bfr, b, LDB, kk, 8 * j);
                mma_bf16(acc[j], af, bfr[0], bfr[1]);
                mma_bf16(acc[j + 1], af, bfr[2], bfr[3]);
            }
        }
        __syncthreads();          // the buffer is free before it is refilled
    }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// LayerNorm of one token row of C values (CP / 32 a lane: lane + 32 i; the
// lanes from C on hold 0 and are left out of the variance) in f32, eps
// 1e-5, rounded to bf16, 0 from C on: the statistics summed lane by lane,
// then across the warp.  CP is the width the kernel is instantiated for
// (prod_width(C)); at C = CP nothing is masked.
template <int CP>
__device__ __forceinline__ void layer_norm_row(const float (&v)[CP / 32], const bf16* scale,
                                               const bf16* bias, bf16 (&out)[CP / 32], int C) {
    const int lane = threadIdx.x & 31;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < CP / 32; ++i) s += v[i];
    const float mean = warp_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < CP / 32; ++i) {
        const float d = lane + 32 * i < C ? v[i] - mean : 0.f;
        var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) / C + 1e-5f);
#pragma unroll
    for (int i = 0; i < CP / 32; ++i) {
        const int c = lane + 32 * i;
        out[i] = c < C ? __float2bfloat16((v[i] - mean) * rstd * ld(scale + c) + ld(bias + c))
                       : __float2bfloat16(0.f);
    }
}

// The widths a launch runs at.  C, the block's width, is any multiple of
// 8 up to 512; the product kernels are instantiated for CP = prod_width(C)
// (32, 64, 128, 256, 384 or 512), their A tiles zero past C and the
// weights read as zeros past C (block_gemm's k_valid, n_valid).  The
// attention kernels take each of the H heads of D = C / H channels padded
// to DP = head_pad(D) (4, 8, ..., 512) channels of zeros, in a q|k|v
// buffer of 3 CA columns: head h's channels of q at h DP .. h DP + D - 1,
// CA = H DP rounded up to a multiple of 32 (the heads past H, at most
// 32 / DP - 1 of them, are zeros: their scores are 0 and nothing of them is
// written).  The caller pads W_qkv's columns the same way (zero columns),
// so that ln_qkv_kernel writes the padded layout itself; every attention
// kernel reads it and writes its results in the block's own layout (head
// h's channel d at h D + d).  At C in (32, 64, 128, 256) and D in (4, 8,
// 16, 32), CP = C, DP = D and CA = C: the layouts are the block's own.
__host__ __device__ constexpr int prod_width(int C) {
    return C <= 32 ? 32 : C <= 64 ? 64 : C <= 128 ? 128 : C <= 256 ? 256 : C <= 384 ? 384 : 512;
}

__host__ __device__ constexpr int head_pad(int D) {
    int p = 4;
    while (p < D) p *= 2;
    return p;
}

struct HeadPlan {
    int D, DP, CA, HK;    // true head dim, padded head dim, padded width, heads in CA
};

inline HeadPlan head_plan(int C, int H) {
    const int D = C / H, DP = head_pad(D);
    const int CA = (H * DP + 31) / 32 * 32;
    return {D, DP, CA, CA / DP};
}

// Two results of one head's adjacent channels d, d + 1 at p (the block's
// layout): one bf16x2 store where D is even (every head starts on an even
// channel), else one store each; `left` = D - d channels of the head from
// d on (nothing past the head is written).
__device__ __forceinline__ void store_head_pair(bf16* p, float a0, float a1, int left,
                                                bool even) {
    if (left <= 0) return;
    if (even && left >= 2) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a0, a1);
    } else {
        p[0] = __float2bfloat16(a0);
        if (left >= 2) p[1] = __float2bfloat16(a1);
    }
}

// 1. LN1 + the qkv product (B1, B1-train, B3, L; B2's recompute), on the
// tensor cores.  64 tokens a block, 4 warps; warp w owns tokens 16w..16w+15.
// Each warp normalises its 16 tokens (f32 statistics over the C channels)
// into the shared A tile n1 = bf16(LN1(x)) (64 x (CP + 8), zero past C);
// then the 3 CA output columns go in chunks of QKV_NCH, W_qkv (C x 3 CA,
// the heads padded by the caller; 384 KB at C = 256) streamed through
// shared memory in k-slices (block_gemm, its rows past C read as zeros),
// and every warp writes its 16 x QKV_NCH tile of bf16 q|k|v.  qkv is (M,
// 3 CA): [q | k | v] per token, each in the padded head layout.
// WITH_NORMED also writes n1 to normed (M, C), which B2 needs for the qkv
// weight gradient.  fix (B1 at a head of at most 8 channels; else null):
// the rows (of N tokens) whose k holds an inf or NaN, for the attention's
// fix-up (attn_kernel's MASK_K): fix[0] their count, fix[1 ..] the rows,
// each once, fix[1 + M / N + r] row r's flag; zeroed by the caller.
constexpr int LNQ_TOK = 64;
constexpr int LNQ_THREADS = 128;
constexpr int QKV_NCH = 96;       // output columns a chunk (3 CA is a multiple of 96)

template <int CP>
constexpr size_t ln_qkv_smem_bytes() {
    return sizeof(bf16) * ((size_t)LNQ_TOK * (CP + 8) + 2 * KS * (QKV_NCH + 8));
}

template <int CP, bool EXACT, bool WITH_NORMED>
__global__ void __launch_bounds__(LNQ_THREADS)
ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_s,
              const bf16* __restrict__ ln_b, const bf16* __restrict__ w,
              bf16* __restrict__ qkv, bf16* __restrict__ normed, int M, int c, int ca,
              int* __restrict__ fix, int N) {
    static_assert(CP % 32 == 0, "ln_qkv_kernel: CP");
    // EXACT: C = CA = CP, the flagship's layouts, known at compile time
    const int C = EXACT ? CP : c, CA = EXACT ? CP : ca;
    constexpr int LDA = CP + 8;
    constexpr int NT = QKV_NCH / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sa = reinterpret_cast<bf16*>(smem_raw);       // LNQ_TOK x LDA: n1
    bf16* wbuf = sa + LNQ_TOK * LDA;                      // 2 x KS x (QKV_NCH + 8)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t tok0 = (size_t)blockIdx.x * LNQ_TOK;
    const int ntok = min(LNQ_TOK, M - (int)tok0);
    for (int t = warp * 16; t < warp * 16 + 16; ++t) {
        bf16 n[CP / 32];
        if (t < ntok) {
            float v[CP / 32];
#pragma unroll
            for (int i = 0; i < CP / 32; ++i) {
                const int c = lane + 32 * i;
                v[i] = c < C ? ld(x + (tok0 + t) * C + c) : 0.f;
            }
            layer_norm_row<CP>(v, ln_s, ln_b, n, C);
            if (WITH_NORMED) {
#pragma unroll
                for (int i = 0; i < CP / 32; ++i)
                    if (lane + 32 * i < C) normed[(tok0 + t) * C + lane + 32 * i] = n[i];
            }
        } else {
#pragma unroll
            for (int i = 0; i < CP / 32; ++i) n[i] = __float2bfloat16(0.f);
        }
#pragma unroll
        for (int i = 0; i < CP / 32; ++i) sa[t * LDA + lane + 32 * i] = n[i];
    }
    const int g = lane >> 2, q = lane & 3;
    const bf16* a = sa + warp * 16 * LDA;
    const int ldo = 3 * CA;
    for (int n0 = 0; n0 < ldo; n0 += QKV_NCH) {
        float acc[NT][4];
        zero(acc);
        block_gemm<NT, QKV_NCH, LNQ_THREADS>(acc, a, LDA, w, ldo, n0, CP, wbuf, 0, C);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int col = n0 + 8 * j + 2 * q;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int t = warp * 16 + g + 8 * half;
                if (t < ntok) {
                    const __nv_bfloat162 v =
                        __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
                    *reinterpret_cast<__nv_bfloat162*>(qkv + (tok0 + t) * ldo + col) = v;
                    if (fix != nullptr && col >= CA && col < 2 * CA) {
                        const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
                        if ((u & 0x7f80u) == 0x7f80u || (u & 0x7f800000u) == 0x7f800000u) {
                            const int r = (int)((tok0 + t) / N);
                            if (atomicOr(fix + 1 + M / N + r, 1) == 0)
                                fix[1 + atomicAdd(fix, 1)] = r;
                        }
                    }
                }
            }
        }
    }
}

// Launch of ln_qkv_kernel at width C (CP = prod_width(C)) into a q|k|v
// buffer of 3 CA columns; the EXACT form where C = CA = CP.
template <bool WITH_NORMED>
cudaError_t launch_ln_qkv(const bf16* x, const bf16* ln_s, const bf16* ln_b, const bf16* w,
                          bf16* qkv, bf16* normed, int M, int C, int CA, cudaStream_t stream,
                          int* fix = nullptr, int N = 1) {
    auto go = [&](auto kernel, size_t smem) {
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        kernel<<<(unsigned)((M + LNQ_TOK - 1) / LNQ_TOK), LNQ_THREADS, smem, stream>>>(
            x, ln_s, ln_b, w, qkv, normed, M, C, CA, fix, N);
        return cudaGetLastError();
    };
    if (C % 8 || C > 512 || CA % 32) return cudaErrorInvalidValue;
    const bool exact = C == prod_width(C) && CA == C;
#define LNQ_AT(CPV)                                                                       \
    case CPV:                                                                             \
        return exact ? go(ln_qkv_kernel<CPV, true, WITH_NORMED>, ln_qkv_smem_bytes<CPV>()) \
                     : go(ln_qkv_kernel<CPV, false, WITH_NORMED>, ln_qkv_smem_bytes<CPV>());
    switch (prod_width(C)) {
        LNQ_AT(32) LNQ_AT(64) LNQ_AT(128) LNQ_AT(256)
        case 384: return go(ln_qkv_kernel<384, false, WITH_NORMED>, ln_qkv_smem_bytes<384>());
        default: return go(ln_qkv_kernel<512, false, WITH_NORMED>, ln_qkv_smem_bytes<512>());
    }
#undef LNQ_AT
}

}  // namespace
