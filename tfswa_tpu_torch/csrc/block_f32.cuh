// The float32 tile and the shared row kernels of the f32 forms of B1,
// B1-train, B2, B3 (fused_block_f32.cu, fused_block_bwd_f32.cu) and B4
// (row_attention_f32.cu), for Hopper (sm_90a).
//
// Arithmetic.  Every product is plain f32 FFMA on the CUDA cores: no
// tensor core, no TF32 (a single TF32 pass keeps about three decimal
// digits, far from the f32 function the TPU kernels compute with cd =
// float32).  3xTF32 on mma.sync.m16n8k8 is the faster f32-accurate route
// and is left to a redesign; these kernels are the simple, right form.
// Sums run in f32; LN statistics are f32, eps 1e-5; GELU is the erf form
// (erff); exp2 and exp are exp2f and expf (a few f32 ulp).  The build must
// not use --use_fast_math: B3's int8 quantisation needs the true division.
//
// What is here:
//   gemm_kernel: out = epilogue(op(A) @ B), A (M, K) with a transform on
//       load (none, LayerNorm from per-token statistics, erf GELU), B (K,
//       Nc) row-major (a weight, or a transposed copy of one), an epilogue
//       of bias, GELU or GELU's derivative at an auxiliary pre-activation,
//       and a residual.  64 x 64 output tiles, 16-deep k-slices of A and B
//       in shared memory, 256 threads of 4 x 4 outputs each;
//   atb_kernel: partial sums of op(A)^T B over a slice of the tokens per
//       block (blockIdx.z), the same tile; sum_parts_kernel adds the slices
//       in a fixed order, so a weight gradient has the same bits every run;
//   colsum_kernel: partial column sums of X (times the LayerNorm nhat of Y)
//       over a slice of the tokens, added by sum_parts_kernel;
//   ln_stats_kernel: per-token mean and rstd (a warp a token);
//   ln_bwd_kernel: base + LN's input gradient (a warp a token).
// Launch geometry: tokens and rows go on grid.x (up to 2^31 - 1 blocks),
// never on grid.y / grid.z (65535 at most).  No kernel returns before a
// __syncthreads that its block reaches.
//
// What bounds them on the H100: the products at C <= 64 sit below the
// card's FFMA rate for their bytes (bytes bound); above, 67 TFLOP/s of FFMA
// bounds them, and this simple tile reaches a fraction of it (PERF.md).
#pragma once

#ifndef TFSWA_EMU
#include <cuda_runtime.h>
#define LAUNCH(kernel, grid, block, stream, ...) \
    kernel<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)
#endif

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace f32 {

constexpr float SCORE_CLAMP = 110.0f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;
constexpr float SQRT_HALF = 0.7071067811865476f;
constexpr float LN_EPS = 1e-5f;

constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;
constexpr int ROW_WARPS = 8;                 // tokens a block of the row kernels

enum { AOP_NONE = 0, AOP_LN = 1, AOP_GELU = 2 };
enum { EPI_NONE = 0, EPI_GELU = 1, EPI_GELU_GRAD = 2 };

// The A operand of a product: element (m, k) of p (leading dimension ld),
// transformed on load: AOP_LN (p[m, k] - mean[m]) * rstd[m] * scale[k] +
// bias[k]; AOP_GELU gelu(p[m, k]).
struct Operand {
    const float* p;
    int ld;
    int op;
    const float* mean;
    const float* rstd;
    const float* scale;
    const float* bias;
};

// What a product does to each of its sums before the store: + bias[n];
// EPI_GELU gelu(.); EPI_GELU_GRAD . * gelu'(aux[m, n]); then resid[m, n] + .
struct Epilogue {
    int op;
    const float* bias;
    const float* resid;
    int ldr;
    const float* aux;
    int ldx;
};

inline Operand plain_a(const float* p, int ld) {
    return Operand{p, ld, AOP_NONE, nullptr, nullptr, nullptr, nullptr};
}

inline Operand ln_a(const float* p, int ld, const float* mean, const float* rstd,
                    const float* scale, const float* bias) {
    return Operand{p, ld, AOP_LN, mean, rstd, scale, bias};
}

inline Epilogue epi(int op = EPI_NONE, const float* bias = nullptr,
                    const float* resid = nullptr, int ldr = 0,
                    const float* aux = nullptr, int ldx = 0) {
    return Epilogue{op, bias, resid, ldr, aux, ldx};
}

__device__ __forceinline__ float gelu(float v) {
    return v * 0.5f * (1.0f + erff(v * SQRT_HALF));
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float load_a(const Operand& a, long m, int k) {
    float v = a.p[m * a.ld + k];
    if (a.op == AOP_LN) v = (v - a.mean[m]) * a.rstd[m] * a.scale[k] + a.bias[k];
    else if (a.op == AOP_GELU) v = gelu(v);
    return v;
}

// acc[i][j] += sum over the slice's 16 k of as[k][ty*4 + i] * bs[k][tx*4 + j]
__device__ __forceinline__ void tile_fma(const float (*as)[BM + 4], const float (*bs)[BN + 4],
                                         int tx, int ty, float (&acc)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// out (M, Nc), leading dimension ldc: e(op(A) (M, K) @ B (K, Nc)).
// grid (ceil(M / 64), ceil(Nc / 64)), 256 threads.
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(Operand a, const float* __restrict__ b, int ldb, float* __restrict__ out, int ldc,
            int M, int Nc, int K, Epilogue e) {
    __shared__ float as[BK][BM + 4];
    __shared__ float bs[BK][BN + 4];
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const long m0 = (long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += BK) {
        {
            const int r = tid >> 2, kk = (tid & 3) * 4;
            const long m = m0 + r;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int k = k0 + kk + i;
                as[kk + i][r] = (m < M && k < K) ? load_a(a, m, k) : 0.0f;
            }
        }
        {
            const int kk = tid >> 4, c = (tid & 15) * 4, k = k0 + kk;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = n0 + c + j;
                bs[kk][c + j] = (k < K && n < Nc) ? b[(long)k * ldb + n] : 0.0f;
            }
        }
        __syncthreads();
        tile_fma(as, bs, tx, ty, acc);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long m = m0 + ty * 4 + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx * 4 + j;
            if (n >= Nc) continue;
            float v = acc[i][j];
            if (e.bias) v += e.bias[n];
            if (e.op == EPI_GELU) {
                v = gelu(v);
            } else if (e.op == EPI_GELU_GRAD) {
                const float h = e.aux[m * e.ldx + n];
                const float gl = 0.5f * (1.0f + erff(h * SQRT_HALF));
                v = v * (gl + h * expf(-0.5f * h * h) * INV_SQRT_2PI);
            }
            if (e.resid) v = e.resid[m * e.ldr + n] + v;
            out[m * ldc + n] = v;
        }
    }
}

// part[z * stride + k1 * ldo + k2] = sum over the tokens m of slice z
// ([z * chunk, (z + 1) * chunk) within M) of op(A)[m, k1] * B[m, k2];
// grid (ceil(K2 / 64), ceil(K1 / 64), slices), 256 threads.
__global__ void __launch_bounds__(GEMM_THREADS)
atb_kernel(Operand a, const float* __restrict__ b, int ldb, int M, int K1, int K2, int chunk,
           float* __restrict__ part, long stride, int ldo) {
    __shared__ float as[BK][BM + 4];
    __shared__ float bs[BK][BN + 4];
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int k10 = blockIdx.y * BM, k20 = blockIdx.x * BN;
    const long mb = (long)blockIdx.z * chunk;
    const long me = mb + chunk < M ? mb + chunk : M;
    float acc[4][4] = {};
    for (long t0 = mb; t0 < me; t0 += BK) {
        const int r = tid >> 4, c = (tid & 15) * 4;
        const long m = t0 + r;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = k10 + c + i;
            as[r][c + i] = (m < me && k < K1) ? load_a(a, m, k) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = k20 + c + j;
            bs[r][c + j] = (m < me && n < K2) ? b[m * ldb + n] : 0.0f;
        }
        __syncthreads();
        tile_fma(as, bs, tx, ty, acc);
        __syncthreads();
    }
    float* dst = part + blockIdx.z * stride;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k1 = k10 + ty * 4 + i;
        if (k1 >= K1) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k2 = k20 + tx * 4 + j;
            if (k2 < K2) dst[(long)k1 * ldo + k2] = acc[i][j];
        }
    }
}

// part[z * stride + c] = sum over the tokens of slice z of x[m, c] (times
// (y[m, c] - mean[m]) * rstd[m] when y is given); grid (ceil(K / 256),
// slices), 256 threads.
__global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ x, int ldx, const float* __restrict__ y, int ldy,
              const float* __restrict__ mean, const float* __restrict__ rstd, int M, int K,
              int chunk, float* __restrict__ part, long stride) {
    const int c = blockIdx.x * 256 + threadIdx.x;
    if (c >= K) return;
    const long mb = (long)blockIdx.y * chunk;
    const long me = mb + chunk < M ? mb + chunk : M;
    float s = 0.0f;
    for (long m = mb; m < me; ++m) {
        float v = x[m * ldx + c];
        if (y) v = v * ((y[m * ldy + c] - mean[m]) * rstd[m]);
        s += v;
    }
    part[blockIdx.y * stride + c] = s;
}

// out[i] = sum over z = 0 .. parts-1, in that order, of part[z * stride + i]
__global__ void sum_parts_kernel(const float* __restrict__ part, int parts, long stride, long n,
                                 float* __restrict__ out) {
    const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.0f;
    for (int z = 0; z < parts; ++z) s += part[z * stride + i];
    out[i] = s;
}

// mean[m] and rstd[m] = 1 / sqrt(var + eps) of the C values of token m
// (biased variance, two passes); ROW_WARPS tokens a block.
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_stats_kernel(const float* __restrict__ x, int M, int C, float* __restrict__ mean,
                float* __restrict__ rstd) {
    const int lane = threadIdx.x & 31;
    const long m = (long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (m >= M) return;
    const float* row = x + m * C;
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mu = warp_sum(s) / C;
    float v = 0.0f;
    for (int c = lane; c < C; c += 32) {
        const float d = row[c] - mu;
        v += d * d;
    }
    const float var = warp_sum(v) / C;
    if (lane == 0) {
        mean[m] = mu;
        rstd[m] = 1.0f / sqrtf(var + LN_EPS);
    }
}

// out[m] = base[m] + rstd (d - mean(d) - nhat mean(d nhat)) with d = dy[m]
// * scale, nhat = (x[m] - mean[m]) rstd[m]: LayerNorm's input gradient,
// plus base; ROW_WARPS tokens a block.
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ scale, const float* __restrict__ base,
              float* __restrict__ out, int M, int C) {
    const int lane = threadIdx.x & 31;
    const long m = (long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (m >= M) return;
    const float mu = mean[m], rs = rstd[m];
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
        const float d = dy[m * C + c] * scale[c];
        s1 += d;
        s2 += d * ((x[m * C + c] - mu) * rs);
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
        const float d = dy[m * C + c] * scale[c];
        const float nh = (x[m * C + c] - mu) * rs;
        out[m * C + c] = base[m * C + c] + rs * (d - m1 - nh * m2);
    }
}

inline dim3 gemm_grid(long M, int Nc) {
    return dim3((unsigned)((M + BM - 1) / BM), (unsigned)((Nc + BN - 1) / BN));
}

inline dim3 row_grid(long M) {
    return dim3((unsigned)((M + ROW_WARPS - 1) / ROW_WARPS));
}

// out = e(op(A) @ B) for M tokens
inline void gemm(const Operand& a, const float* b, int ldb, float* out, int ldc, long M, int Nc,
                 int K, const Epilogue& e, cudaStream_t st) {
    LAUNCH(gemm_kernel, gemm_grid(M, Nc), GEMM_THREADS, st, a, b, ldb, out, ldc, (int)M, Nc, K,
           e);
}

inline void ln_stats(const float* x, long M, int C, float* mean, float* rstd, cudaStream_t st) {
    LAUNCH(ln_stats_kernel, row_grid(M), ROW_WARPS * 32, st, x, (int)M, C, mean, rstd);
}

// The slicing of the tokens for the deterministic sums over them: at most
// max_parts slices of at least 1024 tokens (a multiple of 16).
struct Slices {
    int parts;
    int chunk;
};

inline Slices token_slices(long M, long max_parts) {
    long parts = (M + 1023) / 1024;
    if (parts > max_parts) parts = max_parts;
    if (parts < 1) parts = 1;
    long chunk = (M + parts - 1) / parts;
    chunk = (chunk + 15) / 16 * 16;
    parts = (M + chunk - 1) / chunk;
    return Slices{(int)(parts < 1 ? 1 : parts), (int)chunk};
}

}  // namespace f32
