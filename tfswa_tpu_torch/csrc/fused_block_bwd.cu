// Fused pre-LN row transformer block, backward (the whole-block VJP), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/fused_block.py
// _fused_block_bwd_kernel (reached through fused_row_block's custom VJP,
// _bwd -> _fused_block_bwd_impl).  Inputs: the rows x, the forward's
// exports mid = bf16(y), acc (attention output before the out-projection)
// and den (R, H, N) f32, the cotangent g, all bf16 except den.  Outputs: dx
// in bf16 and the 11 parameter gradients in f32.  It computes what the TPU
// kernel computes, at its rounding points:
//   MLP half:  LN2 statistics from the bf16 mid; n2 = bf16(LN2(mid));
//              h1pre = n2 @ W1 + b1, gl = Phi(h1pre), h1 = bf16(h1pre * gl);
//              d_h1pre = (g @ W2^T) * (gl + h1pre * phi(h1pre));
//              d_n2 = bf16(d_h1pre) @ W1^T; d_mid = g + LN2'(d_n2 * ln2_s)
//              in f32 (bf16 only as a product operand);
//   attention: d_acc = bf16(d_mid) @ Wo^T; per head
//              d_oe = bf16(d_acc / den), d_den = bf16(-(1/den) sum_D d_acc*acc);
//              s = q.k recomputed, p = exp2(min(s, 110)) in f32;
//              d_p = d_oe.v + d_den; d_s = s < 110 ? d_p * p * ln 2 : 0;
//              d_q = sum_k bf16(d_s) k, d_k = sum_q bf16(d_s) q,
//              d_v = sum_q bf16(p) d_oe, each in f32, then bf16;
//   LN1:       d_normed = [d_q|d_k|d_v] @ Wqkv^T; dx = d_mid + LN1'(...);
//   weights:   dW1 = n2^T d_h1pre, dW2 = h1^T g, dWo = acc^T d_mid,
//              dWqkv = normed^T [d_q|d_k|d_v] (bf16 operands, f32 sums);
//              bias and LN vectors as f32 sums over tokens.
//
// Design.  The TPU sums the parameter gradients across its sequential grid
// in place; CUDA blocks run in no order, so every sum over tokens is
// written as one partial per block (or per token split) and reduced in a
// second pass in a fixed order: the result does not depend on scheduling,
// and no float atomics are used.  Launches, all on the caller's stream:
//   1. ln_qkv_kernel<C, true>: B1's LN1 + qkv launch (tensor cores, 64
//                           tokens a block), also writes bf16 normed;
//   2. mlp_bwd_kernel:      per 16-token tile, the MLP half's VJP, LN2
//                           backward, d_acc and d_oe / d_den; writes the
//                           bf16 operands of the weight gradients and
//                           per-block partials of the five vectors;
//   3. attn_bwd_q_kernel:   one block per (row, head, query tile), one
//                           thread per query, keys streamed through shared
//                           memory: d_q;
//   4. attn_bwd_kv_kernel:  one block per (row, head, key tile), one thread
//                           per key, queries streamed: d_k, d_v;
//   5. ln1_bwd_kernel:      d_normed, LN1 backward, dx, and the LN1 vector
//                           partials;
//   6. atb_kernel x 4:      split-K A^T B over tokens (64 x 64 output tiles,
//                           4 x 4 per thread, f32 FMAs) for dW2, dW1, dWo,
//                           dWqkv, into per-split partials;
//   7. reduce_kernel:       the partial sums, in order.
// Neither attention kernel keeps an (N, N) plane: a score lives in one
// register, and keys (queries) past N are never visited.  Both recompute
// s and exp2, so the backward spends 2 H N^2 exp2 per row.
//
// What bounds it on the H100.  At stage 0 (D = 4) the attention kernels
// are bound by MUFU exp2 (16 per clock per SM) and CUDA-core FMAs (about
// 4 D + 10 per (query, key) pair); mma needs k = 16, so tensor cores do
// not apply at D = 4.  At C >= 64 the O(N C^2) products (here f32 SIMT)
// dominate; moving them and the attention products at D >= 16 to
// mma/wgmma is later work.  The bf16 intermediates that go through device
// memory (qkv, normed, n2, h1, d_h1pre, d_mid, d_oe, dqkv) add about
// (14 C + 4 hidden) bytes a token of round trips over one fused kernel.
//
// Interface: plain C, loaded with ctypes.  fused_block_backward_scratch_bytes
// gives the size of the scratch buffer the caller allocates; the function
// returns the first non-zero cudaGetLastError().

#include "block_common.cuh"

namespace {

constexpr float LN2F = 0.6931471805599453f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;
constexpr int MAX_TILE_BLOCKS = 1024;  // blocks of the tile loops: fixed, so the
                                       // partial sums have a fixed order
constexpr int SPLIT_TOKENS = 4096;     // tokens per split of the A^T B sums
constexpr int MAX_SPLITS = 256;
constexpr int ATB_T = 64;              // A^T B output tile
constexpr int ATB_K = 32;              // tokens per shared-memory stage

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

int tile_blocks(int M) { return min((M + TOK - 1) / TOK, MAX_TILE_BLOCKS); }

int splits(int M) { return max(1, min((M + SPLIT_TOKENS - 1) / SPLIT_TOKENS, MAX_SPLITS)); }

// LN statistics of a token-major tile, in place: src[t*C + c] becomes
// nhat = (x - mean) * rstd, and rstd[t] is kept.  One warp per token.
__device__ void ln_stats_tile(float* src, float* rstd, int C) {
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
        const float r = rsqrtf(warp_sum(v) / C + 1e-5f);
        for (int c = lane; c < C; c += 32) src[t * C + c] = (src[t * C + c] - mean) * r;
        if (lane == 0) rstd[t] = r;
    }
}

// LayerNorm backward of one token (one warp): the means over c of dn and
// dn * nhat, with dn and nhat token-major rows of length C.
__device__ __forceinline__ void ln_bwd_means(const float* dn, const float* nh, int C,
                                             float& m1, float& m2) {
    const int lane = threadIdx.x & 31;
    float a = 0.f, b = 0.f;
    for (int c = lane; c < C; c += 32) {
        a += dn[c];
        b += dn[c] * nh[c];
    }
    m1 = warp_sum(a) / C;
    m2 = warp_sum(b) / C;
}

// 2. MLP half VJP + LN2 backward + d_acc, d_oe, d_den, per 16-token tile.
// Partials per block: [df2b C | df1b hidden | dln2s C | dln2b C | dob C].
__global__ void __launch_bounds__(THREADS)
mlp_bwd_kernel(const bf16* __restrict__ mid, const bf16* __restrict__ g,
               const bf16* __restrict__ acc, const float* __restrict__ den,
               const bf16* __restrict__ ln2_s, const bf16* __restrict__ ln2_b,
               const bf16* __restrict__ w1, const bf16* __restrict__ b1,
               const bf16* __restrict__ w1t, const bf16* __restrict__ w2t,
               const bf16* __restrict__ wot,
               bf16* __restrict__ n2c, bf16* __restrict__ h1c, bf16* __restrict__ dh1c,
               float* __restrict__ d_mid, bf16* __restrict__ d_midc,
               bf16* __restrict__ d_oe, float* __restrict__ d_den,
               float* __restrict__ part, int M, int N, int C, int H, int hidden) {
    extern __shared__ __align__(16) float smem[];
    float* s_nh = smem;                    // TOK x C: mid -> nhat2 -> d_mid
    float* s_g = s_nh + TOK * C;           // C x TOK: g (k-major)
    float* s_n2 = s_g + C * TOK;           // C x TOK: bf16(n2)
    float* s_dh = s_n2 + C * TOK;          // hidden x TOK: bf16(d_h1pre)
    float* s_dn = s_dh + hidden * TOK;     // TOK x C: d_n2 * ln2_s, then d_acc
    float* s_dm = s_dn + TOK * C;          // C x TOK: bf16(d_mid)
    float* s_rstd = s_dm + C * TOK;        // TOK
    float* p_f2b = s_rstd + TOK;           // partial sums of this block
    float* p_f1b = p_f2b + C;
    float* p_l2s = p_f1b + hidden;
    float* p_l2b = p_l2s + C;
    float* p_ob = p_l2b + C;
    const int pw = 4 * C + hidden;
    const int D = C / H;
    const int warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < pw; i += THREADS) p_f2b[i] = 0.f;

    const int ntiles = (M + TOK - 1) / TOK;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int tok0 = tile * TOK;
        const int ntok = min(TOK, M - tok0);
        const size_t base = (size_t)tok0 * C;
        __syncthreads();
        for (int i = threadIdx.x; i < TOK * C; i += THREADS) {
            const int t = i / C, c = i % C;
            const bool in = t < ntok;
            s_nh[i] = in ? ld(mid + base + i) : 0.f;
            s_g[c * TOK + t] = in ? ld(g + base + i) : 0.f;
        }
        __syncthreads();
        ln_stats_tile(s_nh, s_rstd, C);
        __syncthreads();
        for (int i = threadIdx.x; i < TOK * C; i += THREADS) {
            const int t = i / C, c = i % C;
            const float n2 = round_bf16(s_nh[i] * ld(ln2_s + c) + ld(ln2_b + c));
            s_n2[c * TOK + t] = n2;
            if (t < ntok) n2c[base + i] = __float2bfloat16(n2);
        }
        __syncthreads();
        // fc1 recompute and d_h1 = g @ W2^T, one hidden column per thread
        for (int j = threadIdx.x; j < hidden; j += THREADS) {
            float a[TOK], d[TOK];
            column_dot(s_n2, w1, hidden, j, C, a);
            column_dot(s_g, w2t, hidden, j, C, d);
            const float bj = ld(b1 + j);
            float sum = 0.f;
#pragma unroll
            for (int t = 0; t < TOK; ++t) {
                const float hp = a[t] + bj;
                const float gl = 0.5f * (1.0f + erff(hp * 0.70710678118654752f));
                const float dhp = d[t] * (gl + hp * expf(-0.5f * hp * hp) * INV_SQRT_2PI);
                s_dh[j * TOK + t] = round_bf16(dhp);
                if (t < ntok) {
                    const size_t o = (size_t)(tok0 + t) * hidden + j;
                    h1c[o] = __float2bfloat16(hp * gl);
                    dh1c[o] = __float2bfloat16(dhp);
                    sum += dhp;
                }
            }
            p_f1b[j] += sum;
        }
        __syncthreads();
        // d_n2 = bf16(d_h1pre) @ W1^T, one channel per thread
        for (int c = threadIdx.x; c < C; c += THREADS) {
            float a[TOK];
            column_dot(s_dh, w1t, C, c, hidden, a);
            const float sc = ld(ln2_s + c);
            float s2 = 0.f, sb = 0.f, sg = 0.f;
#pragma unroll
            for (int t = 0; t < TOK; ++t) {
                if (t < ntok) {
                    s2 += a[t] * s_nh[t * C + c];
                    sb += a[t];
                    sg += s_g[c * TOK + t];
                }
                s_dn[t * C + c] = a[t] * sc;
            }
            p_l2s[c] += s2;
            p_l2b[c] += sb;
            p_f2b[c] += sg;
        }
        __syncthreads();
        // LN2 backward + residual: d_mid = g + rstd * (dn - m1 - nhat * m2)
        for (int t = warp; t < TOK; t += THREADS / 32) {
            float m1, m2;
            ln_bwd_means(s_dn + t * C, s_nh + t * C, C, m1, m2);
            for (int c = threadIdx.x & 31; c < C; c += 32) {
                const float dm = s_g[c * TOK + t]
                    + s_rstd[t] * (s_dn[t * C + c] - m1 - s_nh[t * C + c] * m2);
                s_nh[t * C + c] = dm;
                s_dm[c * TOK + t] = round_bf16(dm);
                if (t < ntok) {
                    d_mid[base + t * C + c] = dm;
                    d_midc[base + t * C + c] = __float2bfloat16(dm);
                }
            }
        }
        __syncthreads();
        // d_acc = bf16(d_mid) @ Wo^T, one channel per thread
        for (int c = threadIdx.x; c < C; c += THREADS) {
            float a[TOK];
            column_dot(s_dm, wot, C, c, C, a);
            float so = 0.f;
#pragma unroll
            for (int t = 0; t < TOK; ++t) {
                if (t < ntok) so += s_nh[t * C + c];
                s_dn[t * C + c] = a[t];
            }
            p_ob[c] += so;
        }
        __syncthreads();
        // d_oe = bf16(d_acc / den) and d_den = bf16(-(1/den) sum_D d_acc * acc)
        for (int i = threadIdx.x; i < ntok * H; i += THREADS) {
            const int t = i / H, h = i % H;
            const int tok = tok0 + t;
            const float dv = den[((size_t)(tok / N) * H + h) * N + tok % N];
            const float r = 1.0f / dv;
            float s = 0.f;
            for (int d = 0; d < D; ++d) {
                const int c = h * D + d;
                const float da = s_dn[t * C + c];
                s += da * ld(acc + base + t * C + c);
                d_oe[base + t * C + c] = __float2bfloat16(da * r);
            }
            d_den[(size_t)tok * H + h] = round_bf16(-r * s);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < pw; i += THREADS) part[(size_t)blockIdx.x * pw + i] = p_f2b[i];
}

// sum_d a[d] * b[d] in a fixed order, so that both attention kernels
// recompute the same score s and the same d_p.
template <int D>
__device__ __forceinline__ float head_dot(const float* a, const float* b) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
    return s;
}

// 3. d_q: one block per (row, head, query tile), one thread per query.
template <int D>
__global__ void attn_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ d_oe,
                                  const float* __restrict__ d_den, bf16* __restrict__ dqkv,
                                  int N, int C, int H, int nqb) {
    __shared__ __align__(16) float ks[KT * D];
    __shared__ __align__(16) float vs[KT * D];
    const int qb = blockIdx.x % nqb;
    const int h = (blockIdx.x / nqb) % H;
    const size_t row0 = (blockIdx.x / ((size_t)nqb * H)) * N;
    const int n = qb * blockDim.x + threadIdx.x;
    const bool valid = n < N;
    const int ldq = 3 * C;

    float q[D], e[D], dq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        q[d] = valid ? ld(qkv + (row0 + n) * ldq + h * D + d) : 0.f;
        e[d] = valid ? ld(d_oe + (row0 + n) * C + h * D + d) : 0.f;
        dq[d] = 0.f;
    }
    const float dd = valid ? d_den[(row0 + n) * H + h] : 0.f;

    for (int t0 = 0; t0 < N; t0 += KT) {
        const int nk = min(KT, N - t0);
        __syncthreads();
        for (int i = threadIdx.x; i < nk * D; i += blockDim.x) {
            const size_t b = (row0 + t0 + i / D) * ldq + h * D + i % D;
            ks[i] = ld(qkv + b + C);
            vs[i] = ld(qkv + b + 2 * C);
        }
        __syncthreads();
        for (int j = 0; j < nk; ++j) {
            const float* kj = ks + j * D;
            const float s = head_dot<D>(q, kj);
            const float p = exp2f(fminf(s, SCORE_CLAMP));
            const float dp = head_dot<D>(e, vs + j * D) + dd;
            const float ds = round_bf16(s < SCORE_CLAMP ? dp * p * LN2F : 0.f);
#pragma unroll
            for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
        }
    }
    if (valid) {
#pragma unroll
        for (int d = 0; d < D; ++d)
            dqkv[(row0 + n) * ldq + h * D + d] = __float2bfloat16(dq[d]);
    }
}

// 4. d_k, d_v: one block per (row, head, key tile), one thread per key.
template <int D>
__global__ void attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ d_oe,
                                   const float* __restrict__ d_den, bf16* __restrict__ dqkv,
                                   int N, int C, int H, int nkb) {
    __shared__ __align__(16) float qs[KT * D];
    __shared__ __align__(16) float es[KT * D];
    __shared__ float dds[KT];
    const int kb = blockIdx.x % nkb;
    const int h = (blockIdx.x / nkb) % H;
    const size_t row0 = (blockIdx.x / ((size_t)nkb * H)) * N;
    const int m = kb * blockDim.x + threadIdx.x;
    const bool valid = m < N;
    const int ldq = 3 * C;

    float k[D], v[D], dk[D], dv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        k[d] = valid ? ld(qkv + (row0 + m) * ldq + C + h * D + d) : 0.f;
        v[d] = valid ? ld(qkv + (row0 + m) * ldq + 2 * C + h * D + d) : 0.f;
        dk[d] = 0.f;
        dv[d] = 0.f;
    }

    for (int t0 = 0; t0 < N; t0 += KT) {
        const int nq = min(KT, N - t0);
        __syncthreads();
        for (int i = threadIdx.x; i < nq * D; i += blockDim.x) {
            const size_t tok = row0 + t0 + i / D;
            qs[i] = ld(qkv + tok * ldq + h * D + i % D);
            es[i] = ld(d_oe + tok * C + h * D + i % D);
        }
        for (int i = threadIdx.x; i < nq; i += blockDim.x)
            dds[i] = d_den[(row0 + t0 + i) * H + h];
        __syncthreads();
        for (int j = 0; j < nq; ++j) {
            const float* qj = qs + j * D;
            const float* ej = es + j * D;
            const float s = head_dot<D>(qj, k);
            const float p = exp2f(fminf(s, SCORE_CLAMP));
            const float dp = head_dot<D>(ej, v) + dds[j];
            const float ds = round_bf16(s < SCORE_CLAMP ? dp * p * LN2F : 0.f);
            const float pc = round_bf16(p);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                dk[d] = fmaf(ds, qj[d], dk[d]);
                dv[d] = fmaf(pc, ej[d], dv[d]);
            }
        }
    }
    if (valid) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            dqkv[(row0 + m) * ldq + C + h * D + d] = __float2bfloat16(dk[d]);
            dqkv[(row0 + m) * ldq + 2 * C + h * D + d] = __float2bfloat16(dv[d]);
        }
    }
}

// 5. d_normed = dqkv @ Wqkv^T, LN1 backward, dx = d_mid + LN1'(...).
// Partials per block: [dln1s C | dln1b C].
__global__ void __launch_bounds__(THREADS)
ln1_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dqkv,
               const float* __restrict__ d_mid, const bf16* __restrict__ ln1_s,
               const bf16* __restrict__ wqkvt, bf16* __restrict__ dx,
               float* __restrict__ part, int M, int C) {
    extern __shared__ __align__(16) float smem[];
    float* s_dq = smem;                    // 3C x TOK: dqkv (k-major)
    float* s_nh = s_dq + 3 * C * TOK;      // TOK x C: x -> nhat1
    float* s_dn = s_nh + TOK * C;          // TOK x C: d_normed * ln1_s
    float* s_rstd = s_dn + TOK * C;        // TOK
    float* p_l1s = s_rstd + TOK;
    float* p_l1b = p_l1s + C;
    const int warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < 2 * C; i += THREADS) p_l1s[i] = 0.f;

    const int ntiles = (M + TOK - 1) / TOK;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int tok0 = tile * TOK;
        const int ntok = min(TOK, M - tok0);
        __syncthreads();
        for (int i = threadIdx.x; i < TOK * 3 * C; i += THREADS) {
            const int t = i / (3 * C), j = i % (3 * C);
            s_dq[j * TOK + t] = t < ntok ? ld(dqkv + (size_t)tok0 * 3 * C + i) : 0.f;
        }
        for (int i = threadIdx.x; i < TOK * C; i += THREADS)
            s_nh[i] = i / C < ntok ? ld(x + (size_t)tok0 * C + i) : 0.f;
        __syncthreads();
        ln_stats_tile(s_nh, s_rstd, C);
        __syncthreads();
        for (int c = threadIdx.x; c < C; c += THREADS) {
            float a[TOK];
            column_dot(s_dq, wqkvt, C, c, 3 * C, a);
            const float sc = ld(ln1_s + c);
            float s1 = 0.f, sb = 0.f;
#pragma unroll
            for (int t = 0; t < TOK; ++t) {
                if (t < ntok) {
                    s1 += a[t] * s_nh[t * C + c];
                    sb += a[t];
                }
                s_dn[t * C + c] = a[t] * sc;
            }
            p_l1s[c] += s1;
            p_l1b[c] += sb;
        }
        __syncthreads();
        for (int t = warp; t < ntok; t += THREADS / 32) {
            float m1, m2;
            ln_bwd_means(s_dn + t * C, s_nh + t * C, C, m1, m2);
            const size_t o = (size_t)(tok0 + t) * C;
            for (int c = threadIdx.x & 31; c < C; c += 32)
                dx[o + c] = __float2bfloat16(
                    d_mid[o + c]
                    + s_rstd[t] * (s_dn[t * C + c] - m1 - s_nh[t * C + c] * m2));
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * C; i += THREADS)
        part[(size_t)blockIdx.x * 2 * C + i] = p_l1s[i];
}

// 6. part[s][i][j] = sum over split s's tokens t of A[t][i] * B[t][j].
__global__ void __launch_bounds__(256)
atb_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ part,
           int M, int Ka, int Kb, int per_split) {
    __shared__ __align__(16) float As[ATB_K][ATB_T];
    __shared__ __align__(16) float Bs[ATB_K][ATB_T];
    const int i0 = blockIdx.y * ATB_T, j0 = blockIdx.x * ATB_T;
    const int t_begin = blockIdx.z * per_split;
    const int t_end = min(M, t_begin + per_split);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[4][4] = {};
    for (int t0 = t_begin; t0 < t_end; t0 += ATB_K) {
        __syncthreads();
        for (int e = threadIdx.x; e < ATB_K * ATB_T; e += 256) {
            const int tt = e / ATB_T, c = e % ATB_T;
            const int t = t0 + tt;
            const bool in = t < t_end;
            As[tt][c] = in && i0 + c < Ka ? ld(A + (size_t)t * Ka + i0 + c) : 0.f;
            Bs[tt][c] = in && j0 + c < Kb ? ld(B + (size_t)t * Kb + j0 + c) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int tt = 0; tt < ATB_K; ++tt) {
            const float4 a = *reinterpret_cast<const float4*>(&As[tt][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[tt][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(av[u], bv[w], acc[u][w]);
        }
    }
    float* out = part + (size_t)blockIdx.z * Ka * Kb;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const int i = i0 + ty * 4 + u, j = j0 + tx * 4 + w;
            if (i < Ka && j < Kb) out[(size_t)i * Kb + j] = acc[u][w];
        }
}

// 7. out[e] = sum_s part[s * stride + e], s in order.
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                              int S, size_t stride, int n) {
    const int e = blockIdx.x * 256 + threadIdx.x;
    if (e >= n) return;
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += part[k * stride + e];
    out[e] = s;
}

cudaError_t reduce(const float* part, float* out, int S, size_t stride, int n,
                   cudaStream_t stream) {
    reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, out, S, stride, n);
    return cudaGetLastError();
}

// dst (Ka x Kb) = A^T B over M tokens, through the split partials.
cudaError_t atb(const bf16* A, const bf16* B, float* part, float* dst, int M, int Ka,
                int Kb, cudaStream_t stream) {
    const int S = splits(M);
    const int per = (M + S - 1) / S;
    dim3 grid((Kb + ATB_T - 1) / ATB_T, (Ka + ATB_T - 1) / ATB_T, S);
    atb_kernel<<<grid, 256, 0, stream>>>(A, B, part, M, Ka, Kb, per);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return reduce(part, dst, S, (size_t)Ka * Kb, Ka * Kb, stream);
}

template <int D>
cudaError_t launch_attn_bwd(const bf16* qkv, const bf16* d_oe, const float* d_den,
                            bf16* dqkv, int R, int N, int C, int H, cudaStream_t stream) {
    const int threads = N <= 64 ? 64 : 128;
    const int nb = (N + threads - 1) / threads;
    const size_t blocks = (size_t)R * H * nb;
    if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    attn_bwd_q_kernel<D><<<(unsigned)blocks, threads, 0, stream>>>(
        qkv, d_oe, d_den, dqkv, N, C, H, nb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_kv_kernel<D><<<(unsigned)blocks, threads, 0, stream>>>(
        qkv, d_oe, d_den, dqkv, N, C, H, nb);
    return cudaGetLastError();
}

// The scratch buffer's parts, in order.
struct Scratch {
    bf16 *qkv, *normed, *n2c, *h1c, *dh1c, *d_midc, *d_oe, *dqkv;
    float *d_mid, *d_den, *vec_part, *mat_part;
    size_t bytes;
};

Scratch carve(char* base, int R, int N, int C, int H, int hidden) {
    const size_t M = (size_t)R * N;
    Scratch s{};
    size_t off = 0;
    auto take = [&](size_t n) { char* p = base ? base + off : nullptr; off += align256(n); return p; };
    s.qkv = (bf16*)take(M * 3 * C * 2);
    s.normed = (bf16*)take(M * C * 2);
    s.n2c = (bf16*)take(M * C * 2);
    s.h1c = (bf16*)take(M * hidden * 2);
    s.dh1c = (bf16*)take(M * hidden * 2);
    s.d_midc = (bf16*)take(M * C * 2);
    s.d_oe = (bf16*)take(M * C * 2);
    s.dqkv = (bf16*)take(M * 3 * C * 2);
    s.d_mid = (float*)take(M * C * 4);
    s.d_den = (float*)take(M * H * 4);
    s.vec_part = (float*)take((size_t)tile_blocks((int)M) * (4 * C + hidden) * 4);
    const size_t mat = (size_t)max(hidden * C, 3 * C * C);
    s.mat_part = (float*)take((size_t)splits((int)M) * mat * 4);
    s.bytes = off;
    return s;
}

}  // namespace

extern "C" size_t fused_block_backward_scratch_bytes(int R, int N, int C, int H, int hidden) {
    return carve(nullptr, R, N, C, H, hidden).bytes;
}

// grads: one f32 buffer holding, back to back, the gradients of
// (ln1_s C, ln1_b C, w_qkv C x 3C (Wq part w.r.t. the pre-scaled Wq),
//  w_o C x C, b_o C, ln2_s C, ln2_b C, w_1 C x hidden, b_1 hidden,
//  w_2 hidden x C, b_2 C).  Weights are bf16 as the forward takes them;
// the *_t are transposed copies (w_qkv_t 3C x C, w_o_t, w_1_t hidden x C,
// w_2_t C x hidden).
extern "C" int fused_block_backward(
    const void* x, const void* mid, const void* acc, const void* den, const void* g,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* w_qkv_t,
    const void* w_o_t, const void* ln2_s, const void* ln2_b, const void* w_1,
    const void* w_1_t, const void* b_1, const void* w_2_t,
    void* scratch, void* dx, void* grads,
    int R, int N, int C, int H, int hidden, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = R * N;
    if (M <= 0 || H <= 0 || C % H) return cudaErrorInvalidValue;
    const Scratch s = carve((char*)scratch, R, N, C, H, hidden);
    float* gr = (float*)grads;
    float *g_ln1s = gr, *g_ln1b = g_ln1s + C, *g_qkv = g_ln1b + C, *g_wo = g_qkv + 3 * C * C,
          *g_ob = g_wo + C * C, *g_ln2s = g_ob + C, *g_ln2b = g_ln2s + C,
          *g_w1 = g_ln2b + C, *g_b1 = g_w1 + C * hidden, *g_w2 = g_b1 + hidden,
          *g_b2 = g_w2 + hidden * C;
    const bf16 *bx = (const bf16*)x, *bg = (const bf16*)g, *bacc = (const bf16*)acc;

    // 1. LN1 + qkv recompute (B1's launch, on the tensor cores)
    cudaError_t err = launch_ln_qkv<true>(bx, (const bf16*)ln1_s, (const bf16*)ln1_b,
                                          (const bf16*)w_qkv, s.qkv, s.normed, M, C, stream);
    if (err != cudaSuccess) return err;

    // 2. MLP half + LN2 backward + d_oe / d_den
    const int G = tile_blocks(M);
    const int pw = 4 * C + hidden;
    const size_t mlp_smem =
        ((size_t)5 * TOK * C + (size_t)hidden * TOK + TOK + pw) * sizeof(float);
    err = cudaFuncSetAttribute(mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)mlp_smem);
    if (err != cudaSuccess) return err;
    mlp_bwd_kernel<<<G, THREADS, mlp_smem, stream>>>(
        (const bf16*)mid, bg, bacc, (const float*)den, (const bf16*)ln2_s,
        (const bf16*)ln2_b, (const bf16*)w_1, (const bf16*)b_1, (const bf16*)w_1_t,
        (const bf16*)w_2_t, (const bf16*)w_o_t, s.n2c, s.h1c, s.dh1c, s.d_mid, s.d_midc,
        s.d_oe, s.d_den, s.vec_part, M, N, C, H, hidden);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const float* vp = s.vec_part;
    if ((err = reduce(vp, g_b2, G, pw, C, stream)) != cudaSuccess) return err;
    if ((err = reduce(vp + C, g_b1, G, pw, hidden, stream)) != cudaSuccess) return err;
    if ((err = reduce(vp + C + hidden, g_ln2s, G, pw, C, stream)) != cudaSuccess) return err;
    if ((err = reduce(vp + 2 * C + hidden, g_ln2b, G, pw, C, stream)) != cudaSuccess) return err;
    if ((err = reduce(vp + 3 * C + hidden, g_ob, G, pw, C, stream)) != cudaSuccess) return err;

    // 3-4. attention backward
    switch (C / H) {
        case 4: err = launch_attn_bwd<4>(s.qkv, s.d_oe, s.d_den, s.dqkv, R, N, C, H, stream); break;
        case 8: err = launch_attn_bwd<8>(s.qkv, s.d_oe, s.d_den, s.dqkv, R, N, C, H, stream); break;
        case 16: err = launch_attn_bwd<16>(s.qkv, s.d_oe, s.d_den, s.dqkv, R, N, C, H, stream); break;
        case 32: err = launch_attn_bwd<32>(s.qkv, s.d_oe, s.d_den, s.dqkv, R, N, C, H, stream); break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;

    // 5. LN1 backward and dx
    const size_t ln1_smem = ((size_t)5 * TOK * C + TOK + 2 * C) * sizeof(float);
    err = cudaFuncSetAttribute(ln1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ln1_smem);
    if (err != cudaSuccess) return err;
    ln1_bwd_kernel<<<G, THREADS, ln1_smem, stream>>>(
        bx, s.dqkv, s.d_mid, (const bf16*)ln1_s, (const bf16*)w_qkv_t, (bf16*)dx,
        s.vec_part, M, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = reduce(s.vec_part, g_ln1s, G, 2 * C, C, stream)) != cudaSuccess) return err;
    if ((err = reduce(s.vec_part + C, g_ln1b, G, 2 * C, C, stream)) != cudaSuccess) return err;

    // 6-7. weight gradients
    if ((err = atb(s.h1c, bg, s.mat_part, g_w2, M, hidden, C, stream)) != cudaSuccess) return err;
    if ((err = atb(s.n2c, s.dh1c, s.mat_part, g_w1, M, C, hidden, stream)) != cudaSuccess) return err;
    if ((err = atb(bacc, s.d_midc, s.mat_part, g_wo, M, C, C, stream)) != cudaSuccess) return err;
    return atb(s.normed, s.dqkv, s.mat_part, g_qkv, M, C, 3 * C, stream);
}
