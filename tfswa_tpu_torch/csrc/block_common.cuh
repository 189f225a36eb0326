// Device helpers shared by the fused row-block kernels (fused_block.cu,
// fused_block_bwd.cu).  Each .cu is its own library; this header is
// compiled into both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TOK = 16;        // tokens per block in the O(N*C) kernels
constexpr int THREADS = 128;   // threads per block in the O(N*C) kernels
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

// LayerNorm of TOK token-major rows src[t*C + c] into dst[c*TOK + t]
// (k-major), rounded to bf16.  One warp per token.
__device__ void layer_norm_tile(const float* src, float* dst, const bf16* scale,
                                const bf16* bias, int C) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int t = warp; t < TOK; t += THREADS / 32) {
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s += src[t * C + c];
        const float mean = warp_sum(s) / C;
        float v = 0.f;
        for (int c = lane; c < C; c += 32) {
            const float d = src[t * C + c] - mean;
            v += d * d;
        }
        const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
        for (int c = lane; c < C; c += 32)
            dst[c * TOK + t] = round_bf16(
                (src[t * C + c] - mean) * rstd * ld(scale + c) + ld(bias + c));
    }
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

// LN1 + qkv projection, TOK tokens a block.  qkv is (M, 3C): [q | k | v]
// per token.  WITH_NORMED also writes bf16(LN1(x)) (M, C), which the
// backward needs for the qkv weight gradient.
template <bool WITH_NORMED>
__global__ void __launch_bounds__(THREADS)
ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_s,
              const bf16* __restrict__ ln_b, const bf16* __restrict__ w,
              bf16* __restrict__ qkv, bf16* __restrict__ normed, int M, int C) {
    extern __shared__ __align__(16) float smem[];
    float* xs = smem;              // TOK x C, token-major
    float* ns = smem + TOK * C;    // C x TOK, k-major
    const int tok0 = blockIdx.x * TOK;
    const int ntok = min(TOK, M - tok0);
    for (int i = threadIdx.x; i < TOK * C; i += THREADS) {
        const int t = i / C;
        xs[i] = t < ntok ? ld(x + (size_t)tok0 * C + i) : 0.f;
    }
    __syncthreads();
    layer_norm_tile(xs, ns, ln_s, ln_b, C);
    __syncthreads();
    if (WITH_NORMED) {
        for (int i = threadIdx.x; i < ntok * C; i += THREADS)
            normed[(size_t)tok0 * C + i] = __float2bfloat16(ns[(i % C) * TOK + i / C]);
    }
    const int ncol = 3 * C;
    for (int j = threadIdx.x; j < ncol; j += THREADS) {
        float acc[TOK];
        column_dot(ns, w, ncol, j, C, acc);
#pragma unroll
        for (int t = 0; t < TOK; ++t)
            if (t < ntok) qkv[(size_t)(tok0 + t) * ncol + j] = __float2bfloat16(acc[t]);
    }
}

}  // namespace
