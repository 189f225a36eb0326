// Fused pre-LN row transformer block, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/fused_block.py
// _fused_block_kernel (no mask, no dropout), reached through fused_row_block,
// in its two forms: serving (B1) and training (B1-train, with_mid=True,
// which also exports mid = bf16(y) and the per-head denominators den; the
// attention output acc is written in both forms).  Per row of rows
// (R, N, C), bf16 in and out:
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
// Design.  Three launches:
//   1. ln_qkv_kernel:  LN1 prologue + the qkv product, 16 tokens a block;
//   2. attn_kernel:    one block per (row, head, block of queries); keys and
//                      values of the head stream through shared memory in
//                      tiles of 128 keys; each thread owns one query and
//                      keeps q, acc and the denominator in registers.  No
//                      (N, N) score or probability plane exists anywhere:
//                      a score lives in one register for one key.  Keys past
//                      N are never visited, so a ragged last tile adds
//                      exactly 0 to the denominator.
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
// a score costs 4 FMAs, one exp2 (MUFU, 16 per clock per SM) and 4 FMAs of
// AV, so that stage is bound by exp2 throughput and CUDA-core FMAs, not by
// tensor-core FLOPs (mma needs k = 16).  About 5e11 exp2 per 8-segment
// batch, most of them in stage-0 TSA and FSA.  The split into three
// launches costs extra device-memory bytes over one fused kernel: q, k, v
// and the attention output make a round trip, about 16*C bytes a token
// (~0.5 KB at C = 32; ~3.6 GB, ~1 ms at 3.35 TB/s, at stage-0 TSA with
// 7 M tokens).  The products run on CUDA cores in f32; moving them to
// mma/wgmma and fusing the three launches is later work.
//
// The training form is the same code instantiated with its two exports
// (template flags), so the serving form's instructions are unchanged.
//
// Interface: plain C, loaded with ctypes.  Each launch goes on the caller's
// stream; the function returns the first non-zero cudaGetLastError().

#include "block_common.cuh"

namespace {

// 2. Attention, one block per (row, head, block of queries).
// WITH_DEN also writes den (R, H, N), the f32 sum of the rounded p.
template <int D, bool WITH_DEN>
__global__ void attn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                            float* __restrict__ den_out, int N, int C, int H, int nqb) {
    extern __shared__ __align__(16) float smem[];
    float* ks = smem;              // KT x D
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

    for (int t0 = 0; t0 < N; t0 += KT) {
        const int nk = min(KT, N - t0);
        __syncthreads();
        for (int i = threadIdx.x; i < nk * D; i += blockDim.x) {
            const size_t base = (row0 + t0 + i / D) * ldq + h * D + i % D;
            ks[i] = ld(qkv + base + C);
            vs[i] = ld(qkv + base + 2 * C);
        }
        __syncthreads();
        for (int j = 0; j < nk; ++j) {
            const float4* k4 = reinterpret_cast<const float4*>(ks + j * D);
            const float4* v4 = reinterpret_cast<const float4*>(vs + j * D);
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < D / 4; ++c) {
                const float4 kk = k4[c];
                s += q[4 * c] * kk.x + q[4 * c + 1] * kk.y
                   + q[4 * c + 2] * kk.z + q[4 * c + 3] * kk.w;
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
cudaError_t launch_attn(const bf16* qkv, bf16* attn, float* den, int R, int N, int C,
                        int H, cudaStream_t stream) {
    const int threads = N <= 64 ? 64 : 128;
    const int nqb = (N + threads - 1) / threads;
    const size_t blocks = (size_t)R * H * nqb;
    if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    const size_t smem = 2 * KT * D * sizeof(float);
    if (den)
        attn_kernel<D, true><<<(unsigned)blocks, threads, smem, stream>>>(
            qkv, attn, den, N, C, H, nqb);
    else
        attn_kernel<D, false><<<(unsigned)blocks, threads, smem, stream>>>(
            qkv, attn, nullptr, N, C, H, nqb);
    return cudaGetLastError();
}

}  // namespace

// mid and den are null in the serving form; in the training form both are
// given: mid (R, N, C) bf16, den (R, H, N) f32.
extern "C" int fused_block_forward(
    const void* x, const void* ln1_s, const void* ln1_b, const void* w_qkv,
    const void* w_o, const void* b_o, const void* ln2_s, const void* ln2_b,
    const void* w_1, const void* b_1, const void* w_2, const void* b_2,
    void* qkv_buf, void* attn_buf, void* out, void* mid, void* den,
    int R, int N, int C, int H, int hidden, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = R * N;
    if (M <= 0 || H <= 0 || C % H || (mid == nullptr) != (den == nullptr))
        return cudaErrorInvalidValue;
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
    bf16* attn = (bf16*)attn_buf;
    float* dn = (float*)den;
    switch (C / H) {
        case 4: err = launch_attn<4>(qkv, attn, dn, R, N, C, H, stream); break;
        case 8: err = launch_attn<8>(qkv, attn, dn, R, N, C, H, stream); break;
        case 16: err = launch_attn<16>(qkv, attn, dn, R, N, C, H, stream); break;
        case 32: err = launch_attn<32>(qkv, attn, dn, R, N, C, H, stream); break;
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
