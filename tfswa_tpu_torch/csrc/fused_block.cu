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
// The kernel lab (L; replaces tools/kernel_lab.py _kernel_prod and its stage
// and flag forms, launched there by _call_kernel) is B1 cut at a stage or
// with one step of its score -> p line changed, also by template
// parameters of B1's own kernels, so that what it times is B1
// (fused_block_lab_forward; ops/lab_block.py has the function of each
// form).  Stage qkv adds q + k + v (qkv_sum_kernel); scores, exp2 and av
// run attn_kernel up to that step; attn runs post_kernel's attention half
// only.  A cut stage keeps only part of its work in its output (scores:
// min(C, N) keys, exp2: D queries), so each thread folds what it computed
// into a checksum, one f32 a warp written to a sink buffer outside the
// output: nvcc cannot drop the work and the time measures it.  The scores
// stage's output, a sum over heads (over blocks), comes from a small
// launch of its own (kept_scores_kernel: the dot product over all C lanes
// is that sum, a small product per row) rather than from per-head partial
// scores, whose scratch (R*H*N*min(C, N) f32, 7.2 GB at a stage-0 shape)
// cost more than the scores themselves.  The av stage sums over query blocks: each block
// writes its sums to scratch and a second launch adds them in a fixed
// order (av_sum_kernel), no atomics, so two runs give the same bits.  The
// flags: SCORE_BF16 takes p from the clamped score
// rounded to bf16 as the JAX package computes exp2 of a bf16 value (XLA
// lowers it as exp(bf16(x * bf16(ln 2)))), P_F32 leaves p unrounded into AV
// and the denominator, NO_CLAMP drops the clamp.
//
// Interface: plain C, loaded with ctypes.  Each launch goes on the caller's
// stream; the function returns the first non-zero cudaGetLastError().

#include <algorithm>

#include "block_common.cuh"

namespace {

// The lab's stages (ops/lab_block.py STAGES) and flag bits.
enum : int { STAGE_QKV, STAGE_SCORES, STAGE_EXP2, STAGE_AV, STAGE_ATTN, STAGE_FULL };
enum : int { SCORE_BF16 = 1, P_F32 = 2, NO_CLAMP = 4 };
constexpr float LN2_BF16 = 0.69140625f;   // ln 2 rounded to bf16

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
// The lab: STAGE cuts the attention after the scores (all kept in the
// checksum only), after p (out is then the final (R, N, C) output: p of
// queries n < D at [r, key, h*D + n]) or after the AV sums (acc / den
// summed over the block's queries to lab, (R*H*nqb, D) f32); FLAGS change
// the score -> p line.
template <int D, bool WITH_DEN, bool INT8, int STAGE = STAGE_FULL, int FLAGS = 0>
__global__ void attn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                            float* __restrict__ den_out, const float* __restrict__ scales,
                            int* __restrict__ qk_out, int N, int C, int H, int nqb,
                            float* __restrict__ lab, float* __restrict__ sink) {
    static_assert(STAGE == STAGE_FULL || (!WITH_DEN && !INT8 && FLAGS == 0),
                  "the lab cuts B1's serving form, flags only on the full attention");
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
    float chk = 0.f;               // the lab's cut stages: checksum of the work
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
                if (STAGE >= STAGE_AV) vs[i] = ld(qkv + base + 2 * C);
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
            if constexpr (STAGE == STAGE_SCORES) {
                chk += s;
                continue;
            }
            const float sc = (FLAGS & NO_CLAMP) ? s : fminf(s, SCORE_CLAMP);
            float e;
            if constexpr ((FLAGS & SCORE_BF16) != 0)
                e = expf(round_bf16(round_bf16(sc) * LN2_BF16));
            else
                e = exp2f(sc);
            const float p = ((FLAGS & P_F32) && !(FLAGS & SCORE_BF16)) ? e : round_bf16(e);
            if constexpr (STAGE == STAGE_EXP2) {
                if (n < D) out[(row0 + t0 + j) * C + h * D + n] = __float2bfloat16(p);
                chk += p;
                continue;
            }
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
    if constexpr (STAGE == STAGE_SCORES || STAGE == STAGE_EXP2) {
        chk = warp_sum(chk);
        if ((threadIdx.x & 31) == 0)
            sink[(size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)] = chk;
    } else if constexpr (STAGE == STAGE_AV) {
        __syncthreads();           // the key tile is free: the block's acc / den
        const float inv = 1.0f / den;
#pragma unroll
        for (int d = 0; d < D; ++d) ks[threadIdx.x * D + d] = valid ? acc[d] * inv : 0.f;
        __syncthreads();
        if (threadIdx.x < D) {
            float sum = 0.f;
            for (int t = 0; t < (int)blockDim.x; ++t) sum += ks[t * D + threadIdx.x];
            lab[(size_t)blockIdx.x * D + threadIdx.x] = sum;
        }
    } else {
        if (valid) {
            const float inv = 1.0f / den;
#pragma unroll
            for (int d = 0; d < D; ++d)
                out[(row0 + n) * C + h * D + d] = __float2bfloat16(acc[d] * inv);
            if (WITH_DEN) den_out[(r * H + h) * N + n] = den;
        }
    }
}

// 3. Out-projection + residual + LN2 + MLP + residual.  WITH_MID also
// writes mid = bf16(y), the residual stream after the attention half.
// ATTN_ONLY (the lab's stage attn) writes bf16(y) to out and stops there;
// it needs the shared memory of sa and sy only.
template <bool WITH_MID, bool ATTN_ONLY = false>
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
    if constexpr (ATTN_ONLY) {
        for (int i = threadIdx.x; i < ntok * C; i += THREADS)
            out[(size_t)tok0 * C + i] = __float2bfloat16(sy[i]);
        return;
    }
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

// The attention's grid: one block per (row, head, block of queries).
struct AttnGrid {
    int threads, nqb;
    size_t blocks;
};

AttnGrid attn_grid(int R, int N, int H) {
    const int threads = N <= 64 ? 64 : 128;
    const int nqb = (N + threads - 1) / threads;
    return {threads, nqb, (size_t)R * H * nqb};
}

template <int D>
cudaError_t launch_attn(const bf16* qkv, bf16* attn, float* den, const float* scales,
                        int* qk_out, int R, int N, int C, int H, cudaStream_t stream) {
    const AttnGrid g = attn_grid(R, N, H);
    if (g.blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    const size_t smem = 2 * KT * D * sizeof(float);
    if (scales)
        attn_kernel<D, false, true><<<(unsigned)g.blocks, g.threads, smem, stream>>>(
            qkv, attn, nullptr, scales, qk_out, N, C, H, g.nqb, nullptr, nullptr);
    else if (den)
        attn_kernel<D, true, false><<<(unsigned)g.blocks, g.threads, smem, stream>>>(
            qkv, attn, den, nullptr, nullptr, N, C, H, g.nqb, nullptr, nullptr);
    else
        attn_kernel<D, false, false><<<(unsigned)g.blocks, g.threads, smem, stream>>>(
            qkv, attn, nullptr, nullptr, nullptr, N, C, H, g.nqb, nullptr, nullptr);
    return cudaGetLastError();
}

// 1. LN1 + qkv into qkv_buf (M tokens, 3C).
cudaError_t launch_ln_qkv(const void* x, const void* ln1_s, const void* ln1_b,
                          const void* w_qkv, void* qkv_buf, int M, int C,
                          cudaStream_t stream) {
    const size_t ln_smem = 2 * (size_t)TOK * C * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ln_qkv_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ln_smem);
    if (err != cudaSuccess) return err;
    ln_qkv_kernel<false><<<(unsigned)((M + TOK - 1) / TOK), THREADS, ln_smem, stream>>>(
        (const bf16*)x, (const bf16*)ln1_s, (const bf16*)ln1_b, (const bf16*)w_qkv,
        (bf16*)qkv_buf, nullptr, M, C);
    return cudaGetLastError();
}

// 3. The out-projection and (unless ATTN_ONLY) the MLP half.
template <bool WITH_MID, bool ATTN_ONLY>
cudaError_t launch_post(const void* x, const bf16* attn, const void* w_o, const void* b_o,
                        const void* ln2_s, const void* ln2_b, const void* w_1,
                        const void* b_1, const void* w_2, const void* b_2, void* out,
                        void* mid, int M, int C, int hidden, cudaStream_t stream) {
    const size_t post_smem =
        (size_t)(ATTN_ONLY ? 2 * C : 3 * C + hidden) * TOK * sizeof(float);
    auto post = post_kernel<WITH_MID, ATTN_ONLY>;
    cudaError_t err = cudaFuncSetAttribute(
        post, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)post_smem);
    if (err != cudaSuccess) return err;
    post<<<(unsigned)((M + TOK - 1) / TOK), THREADS, post_smem, stream>>>(
        (const bf16*)x, attn, (const bf16*)w_o, (const bf16*)b_o,
        (const bf16*)ln2_s, (const bf16*)ln2_b, (const bf16*)w_1, (const bf16*)b_1,
        (const bf16*)w_2, (const bf16*)b_2, (bf16*)out, (bf16*)mid, M, C, hidden);
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
    cudaError_t err = launch_ln_qkv(x, ln1_s, ln1_b, w_qkv, qkv_buf, M, C, stream);
    if (err != cudaSuccess) return err;

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

    return mid ? launch_post<true, false>(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2,
                                          b_2, out, mid, M, C, hidden, stream)
               : launch_post<false, false>(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2,
                                           b_2, out, nullptr, M, C, hidden, stream);
}

// The lab's stage qkv: out = bf16((f32(q) + k) + v), per token and channel.
__global__ void qkv_sum_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                               size_t total, int C) {
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const bf16* t = qkv + (i / C) * 3 * C + i % C;
        out[i] = __float2bfloat16(ld(t) + ld(t + C) + ld(t + 2 * C));
    }
}

// The lab's stage scores, its output: out[r, n, c] = q_n . k_c over all C
// lanes (the sum over heads of s_h[r, query n, key c]) for c < kept =
// min(C, N), else 0: per row an (N, C) x (C, kept) product in f32, lanes
// summed in order.  One block per (row, KS_Q queries); the queries' and the
// kept keys' lanes go through shared memory KS_L at a time; warp w owns
// queries 8w..8w+7 and lane j the keys j, j + 32, ... (KG = ceil(kept / 32)
// groups; kept <= 256).
constexpr int KS_Q = 32, KS_L = 32, KS_KEYS = 256;

template <int KG>
__global__ void __launch_bounds__(THREADS)
kept_scores_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int C) {
    __shared__ __align__(16) float qs[KS_L][KS_Q + 4];   // lane-major: a warp's 8 queries
    __shared__ float ks[32 * KG][KS_L + 1];              // are two float4 loads
    const int nqt = (N + KS_Q - 1) / KS_Q;
    const size_t r = blockIdx.x / nqt;
    const int n0 = (int)(blockIdx.x % nqt) * KS_Q;
    const int kept = min(C, N), ldq = 3 * C;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bf16* row = qkv + r * N * ldq;
    float acc[8][KG];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int m = 0; m < KG; ++m) acc[i][m] = 0.f;
    for (int l0 = 0; l0 < C; l0 += KS_L) {
        __syncthreads();
        for (int i = threadIdx.x; i < KS_Q * KS_L; i += THREADS) {
            const int n = n0 + i / KS_L;
            qs[i % KS_L][i / KS_L] = n < N ? ld(row + (size_t)n * ldq + l0 + i % KS_L) : 0.f;
        }
        for (int i = threadIdx.x; i < 32 * KG * KS_L; i += THREADS) {
            const int j = i / KS_L;
            ks[j][i % KS_L] = j < kept ? ld(row + (size_t)j * ldq + C + l0 + i % KS_L) : 0.f;
        }
        __syncthreads();
        for (int l = 0; l < KS_L; ++l) {
            const float4 qa = *reinterpret_cast<const float4*>(&qs[l][8 * warp]);
            const float4 qb = *reinterpret_cast<const float4*>(&qs[l][8 * warp + 4]);
            const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
            for (int m = 0; m < KG; ++m) {
                const float kv = ks[32 * m + lane][l];
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[i][m] += qv[i] * kv;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int n = n0 + 8 * warp + i;
        if (n >= N) continue;
        bf16* o = out + (r * N + n) * C;
#pragma unroll
        for (int m = 0; m < KG; ++m)
            if (32 * m + lane < kept) o[32 * m + lane] = __float2bfloat16(acc[i][m]);
        for (int c = kept + lane; c < C; c += 32) o[c] = __float2bfloat16(0.f);
    }
}

// The lab's stage av, second launch: the per-block sums of acc / den summed
// over the query blocks in order, out[r, n, c] the same for every n.  One
// thread per (r, c).
__global__ void av_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                              int R, int N, int C, int H, int nqb) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)R * C) return;
    const size_t r = i / C;
    const int c = (int)(i % C), D = C / H, h = c / D, d = c % D;
    float s = 0.f;
    for (int qb = 0; qb < nqb; ++qb) s += part[((r * H + h) * nqb + qb) * D + d];
    const bf16 b = __float2bfloat16(s);
    for (int n = 0; n < N; ++n) out[(r * N + n) * C + c] = b;
}

template <int D, int STAGE, int FLAGS>
cudaError_t launch_attn_lab(const bf16* qkv, bf16* out, float* lab, float* sink, int R,
                            int N, int C, int H, cudaStream_t stream) {
    const AttnGrid g = attn_grid(R, N, H);
    if (g.blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    attn_kernel<D, false, false, STAGE, FLAGS>
        <<<(unsigned)g.blocks, g.threads, 2 * KT * D * sizeof(float), stream>>>(
            qkv, out, nullptr, nullptr, nullptr, N, C, H, g.nqb, lab, sink);
    return cudaGetLastError();
}

// The lab's attention at head dim D: a cut stage, or the full attention
// with the flags.
template <int D>
cudaError_t lab_attn(int stage, int flags, const bf16* qkv, bf16* out, float* lab,
                     float* sink, int R, int N, int C, int H, cudaStream_t stream) {
    switch (stage) {
        case STAGE_SCORES:
            return launch_attn_lab<D, STAGE_SCORES, 0>(qkv, out, lab, sink, R, N, C, H, stream);
        case STAGE_EXP2:
            return launch_attn_lab<D, STAGE_EXP2, 0>(qkv, out, lab, sink, R, N, C, H, stream);
        case STAGE_AV:
            return launch_attn_lab<D, STAGE_AV, 0>(qkv, out, lab, sink, R, N, C, H, stream);
        default:
            break;
    }
#define LAB_FLAGS(F) \
    case F: return launch_attn_lab<D, STAGE_FULL, F>(qkv, out, lab, sink, R, N, C, H, stream);
    switch (flags) {
        LAB_FLAGS(0) LAB_FLAGS(1) LAB_FLAGS(2) LAB_FLAGS(3)
        LAB_FLAGS(4) LAB_FLAGS(5) LAB_FLAGS(6) LAB_FLAGS(7)
        default: return cudaErrorInvalidValue;
    }
#undef LAB_FLAGS
}

// Scratch of a lab launch, in floats: stages scores and exp2 the sink, av
// the per-block sums.
size_t lab_scratch_floats(int R, int N, int C, int H, int stage) {
    const AttnGrid g = attn_grid(R, N, H);
    if (stage == STAGE_SCORES || stage == STAGE_EXP2) return g.blocks * (g.threads / 32);
    if (stage == STAGE_AV) return (size_t)R * C * g.nqb;
    return 0;
}

cudaError_t lab_forward(const void* x, const void* ln1_s, const void* ln1_b,
                        const void* w_qkv, const void* w_o, const void* b_o,
                        const void* ln2_s, const void* ln2_b, const void* w_1,
                        const void* b_1, const void* w_2, const void* b_2, void* qkv_buf,
                        void* attn_buf, void* out, void* scratch, int R, int N, int C,
                        int H, int hidden, int stage, int flags, cudaStream_t stream) {
    const int M = R * N;
    cudaError_t err = launch_ln_qkv(x, ln1_s, ln1_b, w_qkv, qkv_buf, M, C, stream);
    if (err != cudaSuccess) return err;
    const bf16* qkv = (const bf16*)qkv_buf;
    if (stage == STAGE_QKV) {
        const size_t total = (size_t)M * C;
        const size_t blocks = std::min<size_t>((total + 255) / 256, (size_t)1 << 20);
        qkv_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(qkv, (bf16*)out, total, C);
        return cudaGetLastError();
    }
    float* lab = (float*)scratch;
    float* sink = (float*)scratch;
    bf16* attn = stage == STAGE_EXP2 ? (bf16*)out : (bf16*)attn_buf;
    switch (C / H) {
        case 4: err = lab_attn<4>(stage, flags, qkv, attn, lab, sink, R, N, C, H, stream); break;
        case 8: err = lab_attn<8>(stage, flags, qkv, attn, lab, sink, R, N, C, H, stream); break;
        case 16: err = lab_attn<16>(stage, flags, qkv, attn, lab, sink, R, N, C, H, stream); break;
        case 32: err = lab_attn<32>(stage, flags, qkv, attn, lab, sink, R, N, C, H, stream); break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess || stage == STAGE_EXP2) return err;
    if (stage == STAGE_SCORES) {
        const int kept = std::min(C, N);
        const unsigned blocks = (unsigned)((size_t)R * ((N + KS_Q - 1) / KS_Q));
        auto kernel = kept <= 32 ? kept_scores_kernel<1> : kept <= 64 ? kept_scores_kernel<2>
                      : kept <= 128 ? kept_scores_kernel<4> : kept_scores_kernel<8>;
        kernel<<<blocks, THREADS, 0, stream>>>(qkv, (bf16*)out, N, C);
        return cudaGetLastError();
    }
    if (stage == STAGE_AV) {
        av_sum_kernel<<<(unsigned)(((size_t)R * C + 127) / 128), 128, 0, stream>>>(
            lab, (bf16*)out, R, N, C, H, attn_grid(R, N, H).nqb);
        return cudaGetLastError();
    }
    if (stage == STAGE_ATTN)
        return launch_post<false, true>(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                                        out, nullptr, M, C, hidden, stream);
    return launch_post<false, false>(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                                     out, nullptr, M, C, hidden, stream);
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

// The kernel lab (L): B1 cut at stage (0 qkv, 1 scores, 2 exp2, 3 av, 4 attn,
// 5 full) with flags (1 score_bf16, 2 p_f32, 4 no clamp; attn and full
// only); out (R, N, C) bf16.  qkv_buf (R*N, 3C) bf16 receives q|k|v;
// attn_buf (R, N, C) bf16 is needed by the attn and full stages, scratch of
// fused_block_lab_scratch_bytes by scores, exp2 and av.
extern "C" size_t fused_block_lab_scratch_bytes(int R, int N, int C, int H, int stage) {
    return lab_scratch_floats(R, N, C, H, stage) * sizeof(float);
}

extern "C" int fused_block_lab_forward(
    const void* x, const void* ln1_s, const void* ln1_b, const void* w_qkv,
    const void* w_o, const void* b_o, const void* ln2_s, const void* ln2_b,
    const void* w_1, const void* b_1, const void* w_2, const void* b_2,
    void* qkv_buf, void* attn_buf, void* out, void* scratch, int R, int N, int C, int H,
    int hidden, int stage, int flags, void* stream_ptr) {
    if (R <= 0 || N <= 0 || H <= 0 || C % H || stage < STAGE_QKV || stage > STAGE_FULL
        || flags < 0 || flags > 7 || (flags && stage < STAGE_ATTN)
        || (stage == STAGE_EXP2 && N < C / H) || (stage >= STAGE_ATTN && !attn_buf)
        || (stage == STAGE_SCORES && (std::min(C, N) > KS_KEYS || C % KS_L))
        || (lab_scratch_floats(R, N, C, H, stage) && !scratch))
        return cudaErrorInvalidValue;
    return lab_forward(x, ln1_s, ln1_b, w_qkv, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                       qkv_buf, attn_buf, out, scratch, R, N, C, H, hidden, stage, flags,
                       static_cast<cudaStream_t>(stream_ptr));
}
