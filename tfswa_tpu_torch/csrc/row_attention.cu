// Bilinear row attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/row_attention.py
// _attention_kernel_bilinear (B4), reached through flash_row_attention.
// Per row of x (R, N, C), bf16 in and out, with A (H, C, C) bf16, A_h =
// Wq_h Wk_h^T / sqrt(D) (made outside, as the JAX package makes it), Wv and
// Wo (C, C) bf16 and the bias b (C) f32:
//   v   = bf16(x @ Wv)                                    f32 sums
//   per head h: t = bf16(x @ A_h)                         (N, C)
//               s[n, m] = t[n] . x[m]                     all C lanes, f32
//               p = bf16(exp(s - max_m s) / sum_m exp(s - max_m s))
//               acc[:, hD:(h+1)D] = sum_m p v[m, hD:(h+1)D]   f32
//   out = bf16(bf16(acc) @ Wo + b)
// p is normalised before its bf16 rounding, as the TPU kernel's
// jax.nn.softmax(...).astype(bf16) rounds it.
//
// Design.  Three launches:
//   1. rows_matmul_kernel: v = bf16(x @ Wv), 16 tokens a block (the tiled
//      SIMT product of block_common.cuh);
//   2. bilinear_attn_kernel: one block per (row, block of queries), looping
//      over the heads.  The row's keys x (N x C bf16, rows padded to C + 8
//      so that each thread's 16-byte reads of its own query's row fall on
//      distinct banks) stay in shared memory for the whole block, so every
//      head reads them from there; the current head's v (N x D) is
//      reloaded per head.  G = C / 32 adjacent threads own one query: each
//      holds 32 of t's C values in registers (lanes 8g + 8Gj + e, so that
//      the G threads read neighbouring 16-byte pieces of a key),
//      computes them from x[n] and A_h (read through L1/L2) and rounds them
//      to bf16; a score is the sum over its 32 lanes plus a shuffle across
//      the G threads.  t never goes to device memory (H * C values a token:
//      3.6 GB at the serving batch's stage-0 TSA).  Per head, pass 1 walks
//      the keys for the max and the f32 sum of exp(s - max) (rescaled when
//      the max moves); pass 2 recomputes each score, forms p = bf16(exp(s -
//      max) / sum) and adds p * v into D / G accumulator lanes a thread.
//      The rounding point of p forces the two passes: an online softmax
//      that rescales the accumulator rounds p elsewhere.  No (N, N) plane
//      exists anywhere;
//   3. rows_matmul_kernel: out = bf16(acc @ Wo + b), acc as written (bf16).
//
// What bounds it on the H100.  The function's scores are H * N^2 * C MACs
// a row (t is rounded to bf16, so no rank-D shortcut computes the same
// function), t adds H * N * C^2, and exp runs H * N^2 times.  This kernel
// runs the scores twice (the two passes) and every product on CUDA cores
// in f32, so it is bound by FMA throughput, far above the tensor-core
// bound of its bf16 operands (about 4.2e12 MACs a serving forward).
// Moving the scores to mma/wgmma is later work.
//
// Interface: plain C, loaded with ctypes.  Each launch goes on the caller's
// stream; the function returns the first non-zero cudaGetLastError().

#include "block_common.cuh"

namespace {

constexpr int ATT_THREADS = 128;
constexpr size_t MAX_SMEM = 232448;   // dynamic shared memory a block may use

// out = bf16(a @ w + bias) for TOK tokens a block: a (M, K) bf16, w (K,
// Nout) bf16, bias (Nout) f32 or null.
__global__ void __launch_bounds__(THREADS)
rows_matmul_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int M, int K, int Nout) {
    extern __shared__ __align__(16) float smem[];
    float* sa = smem;                  // K x TOK, k-major
    const int tok0 = blockIdx.x * TOK;
    const int ntok = min(TOK, M - tok0);
    for (int i = threadIdx.x; i < TOK * K; i += THREADS) {
        const int t = i / K, k = i % K;
        sa[k * TOK + t] = t < ntok ? ld(a + (size_t)tok0 * K + i) : 0.f;
    }
    __syncthreads();
    float acc[TOK];
    for (int j = threadIdx.x; j < Nout; j += THREADS) {
        column_dot(sa, w, Nout, j, K, acc);
        const float bj = bias != nullptr ? bias[j] : 0.f;
#pragma unroll
        for (int t = 0; t < TOK; ++t)
            if (t < ntok) out[(size_t)(tok0 + t) * Nout + j] = __float2bfloat16(acc[t] + bj);
    }
}

// Eight bf16 (16 bytes) as f32.
__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(p[i]);
        f[2 * i] = v.x;
        f[2 * i + 1] = v.y;
    }
}

// The score t . x[m] of the thread's query: its 32 lanes, then the sum over
// the G threads of the query (a butterfly, so all G hold the same value).
template <int G>
__device__ __forceinline__ float score(const float (&t)[32], const bf16* xm, int g) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(xm + 8 * g + 8 * G * j), f);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
            s0 = fmaf(t[8 * j + e], f[e], s0);
            s1 = fmaf(t[8 * j + e + 1], f[e + 1], s1);
        }
    }
    float s = s0 + s1;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

// 2. One block per (row, block of queries); see the design note above.
// t_out, if non-null, (R*N, H*C) bf16, receives t of every head.
template <int C, int H>
__global__ void __launch_bounds__(ATT_THREADS)
bilinear_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                     const bf16* __restrict__ v, bf16* __restrict__ acc_out,
                     bf16* __restrict__ t_out, int N, int nqb) {
    constexpr int G = C / 32;          // threads a query
    constexpr int D = C / H;           // lanes a head
    constexpr int DL = D / G;          // accumulator lanes a thread
    constexpr int LDX = C + 8;         // padded row of x in shared memory
    static_assert(G * 32 == C && DL * G == D && DL >= 1, "unsupported C, H");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* xs = reinterpret_cast<bf16*>(smem_raw);      // N x LDX
    bf16* vs = xs + (size_t)N * LDX;                    // N x D, this head's v
    const int qb = blockIdx.x % nqb;
    const size_t row0 = (size_t)(blockIdx.x / nqb) * N;
    const int g = threadIdx.x % G;
    const int n = qb * (blockDim.x / G) + threadIdx.x / G;
    const bool valid = n < N;
    // threads past the last query shadow it (they take part in the
    // shuffles and barriers) and write nothing
    const bf16* xn = xs + (size_t)(valid ? n : N - 1) * LDX;

    for (int i = threadIdx.x; i < N * (C / 8); i += blockDim.x) {
        const int m = i / (C / 8), c8 = i % (C / 8);
        *reinterpret_cast<uint4*>(xs + (size_t)m * LDX + 8 * c8) =
            *reinterpret_cast<const uint4*>(x + (row0 + m) * C + 8 * c8);
    }

    for (int h = 0; h < H; ++h) {
        __syncthreads();               // x loaded; the previous head's v read
        for (int i = threadIdx.x; i < N * D; i += blockDim.x)
            vs[i] = v[(row0 + i / D) * C + h * D + i % D];
        __syncthreads();

        // t = bf16(x[n] @ A_h) on the thread's 32 lanes
        float t[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) t[i] = 0.f;
        const bf16* ah = a + (size_t)h * C * C + 8 * g;
        for (int k0 = 0; k0 < C; k0 += 8) {
            float xk[8];
            unpack8(*reinterpret_cast<const uint4*>(xn + k0), xk);
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
                const bf16* arow = ah + (size_t)(k0 + kk) * C;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float f[8];
                    unpack8(__ldg(reinterpret_cast<const uint4*>(arow + 8 * G * j)), f);
#pragma unroll
                    for (int e = 0; e < 8; ++e) t[8 * j + e] = fmaf(xk[kk], f[e], t[8 * j + e]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) t[i] = round_bf16(t[i]);
        if (t_out != nullptr && valid) {
            bf16* tp = t_out + ((row0 + n) * H + h) * C + 8 * g;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 8; ++e) tp[8 * G * j + e] = __float2bfloat16(t[8 * j + e]);
        }

        // pass 1: the max and the f32 sum of exp(s - max) over the keys
        float mx = __int_as_float(0xff800000), l = 0.f;   // -inf
        for (int m = 0; m < N; ++m) {
            const float s = score<G>(t, xs + (size_t)m * LDX, g);
            if (s > mx) {
                l = l * expf(mx - s) + 1.f;
                mx = s;
            } else {
                l += expf(s - mx);
            }
        }
        // pass 2: p = bf16(exp(s - max) / sum), acc += p v
        float acc[DL];
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[e] = 0.f;
        for (int m = 0; m < N; ++m) {
            const float s = score<G>(t, xs + (size_t)m * LDX, g);
            const float p = round_bf16(expf(s - mx) / l);
            const bf16* vm = vs + m * D + g * DL;
#pragma unroll
            for (int e = 0; e < DL; ++e) acc[e] = fmaf(p, ld(vm + e), acc[e]);
        }
        if (valid) {
#pragma unroll
            for (int e = 0; e < DL; ++e)
                acc_out[(row0 + n) * C + h * D + g * DL + e] = __float2bfloat16(acc[e]);
        }
    }
}

cudaError_t launch_matmul(const bf16* a, const bf16* w, const float* bias, bf16* out, int M,
                          int K, int Nout, cudaStream_t stream) {
    const size_t smem = (size_t)K * TOK * sizeof(float);
    rows_matmul_kernel<<<(unsigned)((M + TOK - 1) / TOK), THREADS, smem, stream>>>(
        a, w, bias, out, M, K, Nout);
    return cudaGetLastError();
}

template <int C, int H>
cudaError_t launch_attn(const bf16* x, const bf16* a, const bf16* v, bf16* acc, bf16* t_out,
                        int R, int N, cudaStream_t stream) {
    constexpr int G = C / 32;
    const int threads = min(ATT_THREADS, ((N * G + 31) / 32) * 32);
    const int qpb = threads / G;
    const int nqb = (N + qpb - 1) / qpb;
    const size_t blocks = (size_t)R * nqb;
    const size_t smem = (size_t)N * (C + 8 + C / H) * sizeof(bf16);
    if (blocks > 0x7fffffffULL || smem > MAX_SMEM) return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(
        bilinear_attn_kernel<C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    bilinear_attn_kernel<C, H><<<(unsigned)blocks, threads, smem, stream>>>(
        x, a, v, acc, t_out, N, nqb);
    return cudaGetLastError();
}

template <int C>
cudaError_t launch_attn_heads(const bf16* x, const bf16* a, const bf16* v, bf16* acc,
                              bf16* t_out, int R, int N, int H, cudaStream_t stream) {
    switch (H) {
        case 2: return launch_attn<C, 2>(x, a, v, acc, t_out, R, N, stream);
        case 4: return launch_attn<C, 4>(x, a, v, acc, t_out, R, N, stream);
        case 8: return launch_attn<C, 8>(x, a, v, acc, t_out, R, N, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// x (R, N, C), a (H, C, C), wv and wp (C, C), all bf16; bias (C) f32.
// v_buf (R*N, C) and acc_buf (R, N, C) bf16 receive v and the attention
// output before the out-projection, out (R, N, C) bf16 the result;
// t_out, if non-null, (R*N, H*C) bf16 receives t.
extern "C" int row_attention_forward(
    const void* x, const void* a, const void* wv, const void* wp, const void* bias,
    void* v_buf, void* acc_buf, void* out, void* t_out, int R, int N, int C, int H,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (R <= 0 || N <= 0 || H <= 0 || C % H) return cudaErrorInvalidValue;
    const int M = R * N;
    const bf16* xb = (const bf16*)x;
    bf16* v = (bf16*)v_buf;
    bf16* acc = (bf16*)acc_buf;
    cudaError_t err = launch_matmul(xb, (const bf16*)wv, nullptr, v, M, C, C, stream);
    if (err != cudaSuccess) return err;
    const bf16* ab = (const bf16*)a;
    bf16* tb = (bf16*)t_out;
    switch (C) {
        case 32: err = launch_attn_heads<32>(xb, ab, v, acc, tb, R, N, H, stream); break;
        case 64: err = launch_attn_heads<64>(xb, ab, v, acc, tb, R, N, H, stream); break;
        case 128: err = launch_attn_heads<128>(xb, ab, v, acc, tb, R, N, H, stream); break;
        case 256: err = launch_attn_heads<256>(xb, ab, v, acc, tb, R, N, H, stream); break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    return launch_matmul(acc, (const bf16*)wp, (const float*)bias, (bf16*)out, M, C, C, stream);
}
