// Device helpers shared by the port's kernels (fused_block.cu,
// fused_block_bwd.cu, row_attention.cu).  Each .cu is its own library; this
// header is compiled into each.
//
// Two kinds of helper:
//   - the SIMT pieces of B2's launches (TOK-token tiles, column_dot);
//   - the tensor-core tile: a warp-level bf16 product on
//     mma.sync.aligned.m16n8k16 with f32 sums, its fragments loaded from
//     shared memory by ldmatrix, and the block-level product block_gemm,
//     which streams a weight through shared memory with cp.async.  The
//     products of ln_qkv_kernel (below), post_kernel (fused_block.cu) and
//     every product of B4 (row_attention.cu) run on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TOK = 16;        // tokens per block in B2's O(N*C) kernels
constexpr int THREADS = 128;   // threads per block in B2's O(N*C) kernels
constexpr int KT = 128;        // keys (or queries) per shared-memory tile
constexpr float SCORE_CLAMP = 110.0f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// acc[t] = sum_k a[k*TOK + t] * w[k*ldw + j] for the block's TOK tokens.
__device__ __forceinline__ void column_dot(const float* a, const bf16* w, int ldw,
                                           int j, int K, float (&acc)[TOK]) {
#pragma unroll
    for (int t = 0; t < TOK; ++t) acc[t] = 0.f;
    for (int k = 0; k < K; ++k) {
        const float wk = ld(w + (size_t)k * ldw + j);
        const float4* a4 = reinterpret_cast<const float4*>(a + k * TOK);
#pragma unroll
        for (int q = 0; q < TOK / 4; ++q) {
            const float4 v = a4[q];
            acc[4 * q + 0] += v.x * wk;
            acc[4 * q + 1] += v.y * wk;
            acc[4 * q + 2] += v.z * wk;
            acc[4 * q + 3] += v.w * wk;
        }
    }
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
// multiples of 8, W 16-byte aligned.
constexpr int KS = 32;

template <int NT, int NCH, int NTHR>
__device__ __forceinline__ void block_gemm(float (&acc)[NT][4], const bf16* a, int lda,
                                           const bf16* w, int ldw, int n0, int K, bf16* wbuf,
                                           int wcol0) {
    static_assert(NT % 2 == 0 && NCH % 8 == 0, "block_gemm: NT even, NCH a multiple of 8");
    constexpr int LDB = NCH + 8;
    constexpr int PER_ROW = NCH / 8;
    auto stage = [&](int s) {
        bf16* dst = wbuf + (s & 1) * KS * LDB;
        const bf16* src = w + (size_t)s * KS * ldw + n0;
        for (int i = threadIdx.x; i < KS * PER_ROW; i += NTHR) {
            const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
            cp_async16(dst + r * LDB + c, src + (size_t)r * ldw + c);
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

// LayerNorm of one token row of C values (C / 32 a lane: lane + 32 i) in
// f32, eps 1e-5, rounded to bf16: the statistics summed lane by lane, then
// across the warp.
template <int C>
__device__ __forceinline__ void layer_norm_row(const float (&v)[C / 32], const bf16* scale,
                                               const bf16* bias, bf16 (&out)[C / 32]) {
    const int lane = threadIdx.x & 31;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) s += v[i];
    const float mean = warp_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
        const float d = v[i] - mean;
        var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) / C + 1e-5f);
#pragma unroll
    for (int i = 0; i < C / 32; ++i)
        out[i] = __float2bfloat16((v[i] - mean) * rstd * ld(scale + lane + 32 * i)
                                  + ld(bias + lane + 32 * i));
}

// 1. LN1 + the qkv product (B1, B1-train, B3, L; B2's recompute), on the
// tensor cores.  64 tokens a block, 4 warps; warp w owns tokens 16w..16w+15.
// Each warp normalises its 16 tokens (f32 statistics) into the shared A
// tile n1 = bf16(LN1(x)) (64 x (C + 8)); then the 3C output columns go in
// chunks of QKV_NCH, W_qkv (C x 3C, 384 KB at C = 256) streamed through
// shared memory in k-slices (block_gemm), and every warp writes its 16 x
// QKV_NCH tile of bf16 q|k|v.  qkv is (M, 3C): [q | k | v] per token.
// WITH_NORMED also writes n1 to normed (M, C), which B2 needs for the qkv
// weight gradient.
constexpr int LNQ_TOK = 64;
constexpr int LNQ_THREADS = 128;
constexpr int QKV_NCH = 96;       // output columns a chunk (3C = 96 at C = 32)

template <int C>
constexpr size_t ln_qkv_smem_bytes() {
    return sizeof(bf16) * ((size_t)LNQ_TOK * (C + 8) + 2 * KS * (QKV_NCH + 8));
}

template <int C, bool WITH_NORMED>
__global__ void __launch_bounds__(LNQ_THREADS)
ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_s,
              const bf16* __restrict__ ln_b, const bf16* __restrict__ w,
              bf16* __restrict__ qkv, bf16* __restrict__ normed, int M) {
    static_assert(C % 32 == 0 && (3 * C) % QKV_NCH == 0, "ln_qkv_kernel: C");
    constexpr int LDA = C + 8;
    constexpr int NT = QKV_NCH / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sa = reinterpret_cast<bf16*>(smem_raw);       // LNQ_TOK x LDA: n1
    bf16* wbuf = sa + LNQ_TOK * LDA;                      // 2 x KS x (QKV_NCH + 8)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t tok0 = (size_t)blockIdx.x * LNQ_TOK;
    const int ntok = min(LNQ_TOK, M - (int)tok0);
    for (int t = warp * 16; t < warp * 16 + 16; ++t) {
        bf16 n[C / 32];
        if (t < ntok) {
            float v[C / 32];
#pragma unroll
            for (int i = 0; i < C / 32; ++i) v[i] = ld(x + (tok0 + t) * C + lane + 32 * i);
            layer_norm_row<C>(v, ln_s, ln_b, n);
            if (WITH_NORMED) {
#pragma unroll
                for (int i = 0; i < C / 32; ++i) normed[(tok0 + t) * C + lane + 32 * i] = n[i];
            }
        } else {
#pragma unroll
            for (int i = 0; i < C / 32; ++i) n[i] = __float2bfloat16(0.f);
        }
#pragma unroll
        for (int i = 0; i < C / 32; ++i) sa[t * LDA + lane + 32 * i] = n[i];
    }
    const int g = lane >> 2, q = lane & 3;
    const bf16* a = sa + warp * 16 * LDA;
    for (int n0 = 0; n0 < 3 * C; n0 += QKV_NCH) {
        float acc[NT][4];
        zero(acc);
        block_gemm<NT, QKV_NCH, LNQ_THREADS>(acc, a, LDA, w, 3 * C, n0, C, wbuf, 0);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int col = n0 + 8 * j + 2 * q;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int t = warp * 16 + g + 8 * half;
                if (t < ntok)
                    *reinterpret_cast<__nv_bfloat162*>(qkv + (tok0 + t) * 3 * C + col) =
                        __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
            }
        }
    }
}

// Launch of ln_qkv_kernel at the given C (32, 64, 128 or 256).
template <bool WITH_NORMED>
cudaError_t launch_ln_qkv(const bf16* x, const bf16* ln_s, const bf16* ln_b, const bf16* w,
                          bf16* qkv, bf16* normed, int M, int C, cudaStream_t stream) {
    auto go = [&](auto kernel, size_t smem) {
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        kernel<<<(unsigned)((M + LNQ_TOK - 1) / LNQ_TOK), LNQ_THREADS, smem, stream>>>(
            x, ln_s, ln_b, w, qkv, normed, M);
        return cudaGetLastError();
    };
    switch (C) {
        case 32: return go(ln_qkv_kernel<32, WITH_NORMED>, ln_qkv_smem_bytes<32>());
        case 64: return go(ln_qkv_kernel<64, WITH_NORMED>, ln_qkv_smem_bytes<64>());
        case 128: return go(ln_qkv_kernel<128, WITH_NORMED>, ln_qkv_smem_bytes<128>());
        case 256: return go(ln_qkv_kernel<256, WITH_NORMED>, ln_qkv_smem_bytes<256>());
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace
