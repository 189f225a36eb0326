// Fused pre-LN row transformer block, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/fused_block.py
// _fused_block_kernel (no mask, no dropout), reached through fused_row_block,
// in its two forms: serving (B1) and training (B1-train, with_mid=True,
// which also exports mid = bf16(y) and the per-head denominators den; the
// attention output acc is written in both forms); and its int8-score
// serving form (B3, int8_attn=True, reached through fused_row_block_int8).
// Per row of rows (R, N, C), bf16 in and out:
//   n1  = bf16(LN1(x))                      f32 statistics, eps 1e-5
//   q,k,v = bf16(n1 @ Wq'), bf16(n1 @ Wk), bf16(n1 @ Wv)
//                                           Wq' = Wq * log2(e)/sqrt(D), in bf16
//   per head: p = bf16(exp2(min(q.k, 110)))  max-free softmax, SCORE_CLAMP
//             acc = (sum p v) / (sum p)      both sums in f32
//   y   = x + (bf16(acc) @ Wo + bo)          f32
//   out = bf16(y + (bf16(gelu(bf16(LN2(y)) @ W1 + b1)) @ W2 + b2))
// The bf16 rounding points are the TPU kernel's: p is rounded to bf16
// before the AV sum and the denominator is the sum of the rounded p, as
// the TPU's appended ones row gives it.
//
// B3 replaces the score q.k by (qi.ki) * (sq * sk): sq = max|q| / 127 over
// the row's N*C values of q (all heads), the same for k, in f32;
// qi = rint(q / sq) as int8 (a true division, rounded half to even; 0 where
// the scale is 0); the int8 dot product summed exactly in int32 (__dp4a).
// v is not quantised: the TPU kernel's int8_av is False, and p, the AV
// sums and the denominator stay as in B1.  The build must not use
// --use_fast_math: the division and the rounding have to give the plain
// version's int8 values bit for bit.
//
// Design.  Three launches (B3: four):
//   1. ln_qkv_kernel:  LN1 prologue + the qkv product, 16 tokens a block;
//  (B3) qk_scale_kernel: one block per row reduces max|q| and max|k| over
//                      the row's N*C values into an (R, 2) f32 buffer;
//   2. attn_kernel:    one block per (row, head, block of queries); keys and
//                      values of the head stream through shared memory in
//                      tiles of 128 keys; each thread owns one query and
//                      keeps q, acc and the denominator in registers.  No
//                      (N, N) score or probability plane exists anywhere:
//                      a score lives in one register for one key.  Keys past
//                      N are never visited, so a ragged last tile adds
//                      exactly 0 to the denominator.  In B3 (template flag
//                      INT8) each thread quantises its query once into D/4
//                      packed int8 words, the key tiles are quantised as
//                      they enter shared memory, and a score is D/4
//                      __dp4a (one at D = 4);
//   3. post_kernel:    out-projection + bias + residual + LN2 + fc1 + erf
//                      GELU + fc2 + bias + residual, 16 tokens a block, all
//                      intermediates in shared memory.
// The products are tiled SIMT: a block holds 16 normalised tokens in shared
// memory (k-major, so one float4 broadcast feeds 4 tokens) and each thread
// walks one output column at a time, reading the weight column from global
// memory (weights are at most 1 MB and stay in L1/L2).  Weights that do not
// fit shared memory (C = 256: W_qkv 384 KB, fc1 512 KB in bf16) are never
// staged there.
//
// What bounds it on the H100.  The path's attention at stage 0 has D = 4:
// a score costs 4 FMAs (B3: one __dp4a), one exp2 (MUFU, 16 per clock per
// SM) and 4 FMAs of AV, so that stage is bound by exp2 throughput and
// CUDA-core FMAs, not by tensor-core FLOPs (mma needs k = 16).  About 5e11
// exp2 per 8-segment batch, most of them in stage-0 TSA and FSA.  The split
// into three launches costs extra device-memory bytes over one fused
// kernel: q, k, v and the attention output make a round trip, about 16*C
// bytes a token (~0.5 KB at C = 32; ~3.6 GB, ~1 ms at 3.35 TB/s, at
// stage-0 TSA with 7 M tokens).  The products run on CUDA cores in f32;
// moving them to mma/wgmma and fusing the three launches is later work.
//
// The training form and B3 are the same code instantiated with template
// flags, so the serving form's instructions are unchanged.
//
// Interface: plain C, loaded with ctypes.  Each launch goes on the caller's
// stream; the function returns the first non-zero cudaGetLastError().

#include "block_common.cuh"

namespace {

// B3: q / s rounded half to even (rintf), as an int; 0 where s is 0.
__device__ __forceinline__ int quant_i8(float x, float s) {
    return s > 0.f ? (int)rintf(x / s) : 0;
}

// Four int8 values in one word, the first in the lowest byte (the order
// __dp4a pairs them in, and the order of an int8 array in memory).
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
    return (int)((unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) |
                 ((unsigned)(c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24));
}

// B3: the per-row scales of q and k, max|.| / 127 over the row's N*C values
// of each, into scales (R, 2).  One block per row.
constexpr int SCALE_THREADS = 256;
__global__ void __launch_bounds__(SCALE_THREADS)
qk_scale_kernel(const bf16* __restrict__ qkv, float* __restrict__ scales, int N, int C) {
    __shared__ float red[2][SCALE_THREADS / 32];
    const size_t row0 = (size_t)blockIdx.x * N;
    const int ldq = 3 * C;
    float mq = 0.f, mk = 0.f;
    for (int i = threadIdx.x; i < N * C; i += SCALE_THREADS) {
        const bf16* p = qkv + (row0 + i / C) * ldq + i % C;
        mq = fmaxf(mq, fabsf(ld(p)));
        mk = fmaxf(mk, fabsf(ld(p + C)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o));
        mk = fmaxf(mk, __shfl_xor_sync(0xffffffffu, mk, o));
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        red[0][warp] = mq;
        red[1][warp] = mk;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < SCALE_THREADS / 32; ++w) {
            mq = fmaxf(mq, red[0][w]);
            mk = fmaxf(mk, red[1][w]);
        }
        scales[2 * blockIdx.x] = mq / 127.0f;
        scales[2 * blockIdx.x + 1] = mk / 127.0f;
    }
}

// 2. Attention, one block per (row, head, block of queries).
// WITH_DEN also writes den (R, H, N), the f32 sum of the rounded p.
// INT8 (B3) takes int8 scores with the row scales in scales (R, 2); with
// qk_out non-null it also writes the int8 q | k it used, (R*N, 2C) int8
// as 32-bit words (keys by the blocks of query block 0).
template <int D, bool WITH_DEN, bool INT8>
__global__ void attn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                            float* __restrict__ den_out, const float* __restrict__ scales,
                            int* __restrict__ qk_out, int N, int C, int H, int nqb) {
    extern __shared__ __align__(16) float smem[];
    float* ks = smem;              // KT x D (INT8: KT x D/4 packed words)
    float* vs = smem + KT * D;     // KT x D
    const int qb = blockIdx.x % nqb;
    const int h = (blockIdx.x / nqb) % H;
    const size_t r = blockIdx.x / ((size_t)nqb * H);
    const int n = qb * blockDim.x + threadIdx.x;
    const bool valid = n < N;
    const size_t row0 = r * N;
    const int ldq = 3 * C;

    float q[D], acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        q[d] = valid ? ld(qkv + (row0 + n) * ldq + h * D + d) : 0.f;
        acc[d] = 0.f;
    }
    float den = 0.f;
    int qw[INT8 ? D / 4 : 1];
    float sk = 0.f, ss = 0.f;
    if constexpr (INT8) {
        const float sq = scales[2 * r];
        sk = scales[2 * r + 1];
        ss = sq * sk;
#pragma unroll
        for (int c = 0; c < D / 4; ++c)
            qw[c] = pack4(quant_i8(q[4 * c], sq), quant_i8(q[4 * c + 1], sq),
                          quant_i8(q[4 * c + 2], sq), quant_i8(q[4 * c + 3], sq));
        if (qk_out != nullptr && valid) {
#pragma unroll
            for (int c = 0; c < D / 4; ++c)
                qk_out[((row0 + n) * 2 * C + h * D) / 4 + c] = qw[c];
        }
    }

    for (int t0 = 0; t0 < N; t0 += KT) {
        const int nk = min(KT, N - t0);
        __syncthreads();
        if constexpr (INT8) {
            int* kw = reinterpret_cast<int*>(ks);
            for (int i = threadIdx.x; i < nk * (D / 4); i += blockDim.x) {
                const int j = i / (D / 4), c = i % (D / 4);
                const bf16* kp = qkv + (row0 + t0 + j) * ldq + C + h * D + 4 * c;
                const int w = pack4(quant_i8(ld(kp), sk), quant_i8(ld(kp + 1), sk),
                                    quant_i8(ld(kp + 2), sk), quant_i8(ld(kp + 3), sk));
                kw[i] = w;
                if (qk_out != nullptr && qb == 0)
                    qk_out[((row0 + t0 + j) * 2 * C + C + h * D) / 4 + c] = w;
            }
            for (int i = threadIdx.x; i < nk * D; i += blockDim.x)
                vs[i] = ld(qkv + (row0 + t0 + i / D) * ldq + 2 * C + h * D + i % D);
        } else {
            for (int i = threadIdx.x; i < nk * D; i += blockDim.x) {
                const size_t base = (row0 + t0 + i / D) * ldq + h * D + i % D;
                ks[i] = ld(qkv + base + C);
                vs[i] = ld(qkv + base + 2 * C);
            }
        }
        __syncthreads();
        for (int j = 0; j < nk; ++j) {
            const float4* v4 = reinterpret_cast<const float4*>(vs + j * D);
            float s = 0.f;
            if constexpr (INT8) {
                const int* k4 = reinterpret_cast<const int*>(ks) + j * (D / 4);
                int si = 0;
#pragma unroll
                for (int c = 0; c < D / 4; ++c) si = __dp4a(qw[c], k4[c], si);
                s = (float)si * ss;
            } else {
                const float4* k4 = reinterpret_cast<const float4*>(ks + j * D);
#pragma unroll
                for (int c = 0; c < D / 4; ++c) {
                    const float4 kk = k4[c];
                    s += q[4 * c] * kk.x + q[4 * c + 1] * kk.y
                       + q[4 * c + 2] * kk.z + q[4 * c + 3] * kk.w;
                }
            }
            const float p = round_bf16(exp2f(fminf(s, SCORE_CLAMP)));
            den += p;
#pragma unroll
            for (int c = 0; c < D / 4; ++c) {
                const float4 vv = v4[c];
                acc[4 * c] += p * vv.x;
                acc[4 * c + 1] += p * vv.y;
                acc[4 * c + 2] += p * vv.z;
                acc[4 * c + 3] += p * vv.w;
            }
        }
    }
    if (valid) {
        const float inv = 1.0f / den;
#pragma unroll
        for (int d = 0; d < D; ++d)
            out[(row0 + n) * C + h * D + d] = __float2bfloat16(acc[d] * inv);
        if (WITH_DEN) den_out[(r * H + h) * N + n] = den;
    }
}

// 3. Out-projection + residual + LN2 + MLP + residual.  WITH_MID also
// writes mid = bf16(y), the residual stream after the attention half.
template <bool WITH_MID>
__global__ void __launch_bounds__(THREADS)
post_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
            const bf16* __restrict__ wo, const bf16* __restrict__ bo,
            const bf16* __restrict__ ln_s, const bf16* __restrict__ ln_b,
            const bf16* __restrict__ w1, const bf16* __restrict__ b1,
            const bf16* __restrict__ w2, const bf16* __restrict__ b2,
            bf16* __restrict__ out, bf16* __restrict__ mid, int M, int C, int hidden) {
    extern __shared__ __align__(16) float smem[];
    float* sa = smem;                  // C x TOK  attention output, k-major
    float* sy = sa + C * TOK;          // TOK x C  residual stream y, token-major
    float* sn = sy + TOK * C;          // C x TOK  bf16(LN2(y)), k-major
    float* sh = sn + C * TOK;          // hidden x TOK  bf16(gelu(fc1)), k-major
    const int tok0 = blockIdx.x * TOK;
    const int ntok = min(TOK, M - tok0);
    for (int i = threadIdx.x; i < TOK * C; i += THREADS) {
        const int t = i / C, c = i % C;
        const bool in = t < ntok;
        sy[i] = in ? ld(x + (size_t)tok0 * C + i) : 0.f;
        sa[c * TOK + t] = in ? ld(attn + (size_t)tok0 * C + i) : 0.f;
    }
    __syncthreads();
    float acc[TOK];
    for (int j = threadIdx.x; j < C; j += THREADS) {
        column_dot(sa, wo, C, j, C, acc);
        const float bj = ld(bo + j);
#pragma unroll
        for (int t = 0; t < TOK; ++t) sy[t * C + j] += acc[t] + bj;
    }
    __syncthreads();
    if (WITH_MID) {
        for (int i = threadIdx.x; i < ntok * C; i += THREADS)
            mid[(size_t)tok0 * C + i] = __float2bfloat16(sy[i]);
    }
    layer_norm_tile(sy, sn, ln_s, ln_b, C);
    __syncthreads();
    for (int j = threadIdx.x; j < hidden; j += THREADS) {
        column_dot(sn, w1, hidden, j, C, acc);
        const float bj = ld(b1 + j);
#pragma unroll
        for (int t = 0; t < TOK; ++t) {
            const float hv = acc[t] + bj;
            sh[j * TOK + t] = round_bf16(0.5f * hv * (1.0f + erff(hv * 0.70710678118654752f)));
        }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < C; j += THREADS) {
        column_dot(sh, w2, C, j, hidden, acc);
        const float bj = ld(b2 + j);
#pragma unroll
        for (int t = 0; t < TOK; ++t)
            if (t < ntok)
                out[(size_t)(tok0 + t) * C + j] = __float2bfloat16(sy[t * C + j] + (acc[t] + bj));
    }
}

template <int D>
cudaError_t launch_attn(const bf16* qkv, bf16* attn, float* den, const float* scales,
                        int* qk_out, int R, int N, int C, int H, cudaStream_t stream) {
    const int threads = N <= 64 ? 64 : 128;
    const int nqb = (N + threads - 1) / threads;
    const size_t blocks = (size_t)R * H * nqb;
    if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    const size_t smem = 2 * KT * D * sizeof(float);
    if (scales)
        attn_kernel<D, false, true><<<(unsigned)blocks, threads, smem, stream>>>(
            qkv, attn, nullptr, scales, qk_out, N, C, H, nqb);
    else if (den)
        attn_kernel<D, true, false><<<(unsigned)blocks, threads, smem, stream>>>(
            qkv, attn, den, nullptr, nullptr, N, C, H, nqb);
    else
        attn_kernel<D, false, false><<<(unsigned)blocks, threads, smem, stream>>>(
            qkv, attn, nullptr, nullptr, nullptr, N, C, H, nqb);
    return cudaGetLastError();
}

// The whole block: launches 1-3, with B3's scale launch before the
// attention when scales is non-null.  mid and den: B1-train's exports.
cudaError_t forward(const void* x, const void* ln1_s, const void* ln1_b, const void* w_qkv,
                    const void* w_o, const void* b_o, const void* ln2_s, const void* ln2_b,
                    const void* w_1, const void* b_1, const void* w_2, const void* b_2,
                    void* qkv_buf, void* attn_buf, void* out, void* mid, void* den,
                    void* scales, void* qk_out, int R, int N, int C, int H, int hidden,
                    cudaStream_t stream) {
    const int M = R * N;
    const unsigned tok_blocks = (unsigned)((M + TOK - 1) / TOK);

    const size_t ln_smem = 2 * (size_t)TOK * C * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ln_qkv_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ln_smem);
    if (err != cudaSuccess) return err;
    ln_qkv_kernel<false><<<tok_blocks, THREADS, ln_smem, stream>>>(
        (const bf16*)x, (const bf16*)ln1_s, (const bf16*)ln1_b, (const bf16*)w_qkv,
        (bf16*)qkv_buf, nullptr, M, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    const bf16* qkv = (const bf16*)qkv_buf;
    if (scales) {
        qk_scale_kernel<<<(unsigned)R, SCALE_THREADS, 0, stream>>>(qkv, (float*)scales, N, C);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    bf16* attn = (bf16*)attn_buf;
    float* dn = (float*)den;
    const float* sc = (const float*)scales;
    int* qk = (int*)qk_out;
    switch (C / H) {
        case 4: err = launch_attn<4>(qkv, attn, dn, sc, qk, R, N, C, H, stream); break;
        case 8: err = launch_attn<8>(qkv, attn, dn, sc, qk, R, N, C, H, stream); break;
        case 16: err = launch_attn<16>(qkv, attn, dn, sc, qk, R, N, C, H, stream); break;
        case 32: err = launch_attn<32>(qkv, attn, dn, sc, qk, R, N, C, H, stream); break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;

    const size_t post_smem = (size_t)(3 * C + hidden) * TOK * sizeof(float);
    auto post = mid ? post_kernel<true> : post_kernel<false>;
    err = cudaFuncSetAttribute(post, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)post_smem);
    if (err != cudaSuccess) return err;
    post<<<tok_blocks, THREADS, post_smem, stream>>>(
        (const bf16*)x, attn, (const bf16*)w_o, (const bf16*)b_o,
        (const bf16*)ln2_s, (const bf16*)ln2_b, (const bf16*)w_1, (const bf16*)b_1,
        (const bf16*)w_2, (const bf16*)b_2, (bf16*)out, (bf16*)mid, M, C, hidden);
    return cudaGetLastError();
}

}  // namespace

// B1, B1-train and B3.  Serving form (B1): mid, den, scales and qk_out
// null.  Training form (B1-train): mid (R, N, C) bf16 and den (R, H, N) f32
// both given.  Int8 scores (B3, serving only): scales (R, 2) f32 receives
// the per-row scales of q and k and qk_out, if non-null, (R*N, 2C) int8 the
// int8 q | k the attention used.
extern "C" int fused_block_forward(
    const void* x, const void* ln1_s, const void* ln1_b, const void* w_qkv,
    const void* w_o, const void* b_o, const void* ln2_s, const void* ln2_b,
    const void* w_1, const void* b_1, const void* w_2, const void* b_2,
    void* qkv_buf, void* attn_buf, void* out, void* mid, void* den,
    void* scales, void* qk_out, int R, int N, int C, int H, int hidden, void* stream_ptr) {
    if (R <= 0 || N <= 0 || H <= 0 || C % H || (mid == nullptr) != (den == nullptr)
        || (scales != nullptr && mid != nullptr) || (qk_out != nullptr && scales == nullptr))
        return cudaErrorInvalidValue;
    return forward(x, ln1_s, ln1_b, w_qkv, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                   qkv_buf, attn_buf, out, mid, den, scales, qk_out, R, N, C, H, hidden,
                   static_cast<cudaStream_t>(stream_ptr));
}
