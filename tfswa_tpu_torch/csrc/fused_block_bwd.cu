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
//   2. mlp_bwd_kernel<C>:   per 64-token tile, the MLP half's VJP, LN2
//                           backward, d_acc and d_oe / d_den, its four
//                           products on the tensor cores (see the kernel);
//                           writes the bf16 operands of the weight
//                           gradients and per-block partials of the five
//                           vectors;
//   3. attn_bwd_q_kernel:   one block per (row, head, query tile), one
//                           thread per query, keys streamed through shared
//                           memory: d_q;
//   4. attn_bwd_kv_kernel:  one block per (row, head, key tile), one thread
//                           per key, queries streamed: d_k, d_v;
//   5. ln1_bwd_kernel:      d_normed, LN1 backward, dx, and the LN1 vector
//                           partials;
//   6. atb_kernel x 4:      split-K A^T B over tokens on the tensor cores
//                           (64 x 64 output tiles, tokens as k) for dW2,
//                           dW1, dWo, dWqkv, into per-split partials;
//   7. reduce_kernel:       the partial sums, in order.
// Neither attention kernel keeps an (N, N) plane: a score lives in one
// register, and keys (queries) past N are never visited.  Both recompute
// s and exp2, so the backward spends 2 H N^2 exp2 per row.
//
// What bounds it on the H100.  The products of launches 2 and 6 (bf16
// operands, f32 sums on mma.sync) do about 6 C (C + hidden) FLOPs on about
// 60 C bytes of operands and results a token: far below the card's 295
// FLOP a byte, so device-memory bytes bound them (about 17-20 ms a
// flagship step each).  At stage 0 (D = 4) the attention kernels (launches
// 3-4, still SIMT) are bound by MUFU exp2 (16 per clock per SM) and
// CUDA-core FMAs (about 4 D + 10 per (query, key) pair); moving them to
// mma is later work.  The bf16 intermediates that go through device
// memory (qkv, normed, n2, h1, d_h1pre, d_mid, d_oe, dqkv) add about
// (14 C + 4 hidden) bytes a token of round trips over one fused kernel.
//
// Interface: plain C, loaded with ctypes.  fused_block_backward_scratch_bytes
// gives the size of the scratch buffer the caller allocates; the function
// returns the first non-zero cudaGetLastError().

#include <algorithm>

#include "block_common.cuh"

namespace {

constexpr float LN2F = 0.6931471805599453f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;
constexpr int MAX_TILE_BLOCKS = 1024;  // blocks of the tile loops: fixed, so the
                                       // partial sums have a fixed order
constexpr int SPLIT_TOKENS = 4096;     // tokens per split of the A^T B sums
constexpr int MAX_SPLITS = 256;
constexpr int MB_TOK = 64;             // tokens per tile of mlp_bwd_kernel,
constexpr int MB_THREADS = 256;        // its threads,
constexpr int MB_HC = 64;              // hidden units a chunk of its MLP
constexpr int ATB_T = 64;              // A^T B output tile
constexpr int ATB_K = 64;              // tokens per shared-memory stage

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// blocks of ln1_bwd_kernel (TOK-token tiles) and of mlp_bwd_kernel
// (MB_TOK-token tiles)
int tile_blocks(int M) { return min((M + TOK - 1) / TOK, MAX_TILE_BLOCKS); }
int mlp_blocks(int M) { return min((M + MB_TOK - 1) / MB_TOK, MAX_TILE_BLOCKS); }

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

// The sum over a warp's 16 rows (g and g + 8 of every quad) of v[j][0..1],
// a thread's two columns of n-tile j, into dst[8 j + 2 q], dst[8 j + 2 q +
// 1] by the lanes of row g = 0 (a fixed shuffle tree).
template <int NT>
__device__ __forceinline__ void warp_colsum(float (&v)[NT][2], float* dst) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) v[j][i] += __shfl_xor_sync(0xffffffffu, v[j][i], o);
    if (lane < 4) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            dst[8 * j + 2 * lane] = v[j][0];
            dst[8 * j + 2 * lane + 1] = v[j][1];
        }
    }
}

// p[i] += the sum of the tile's four token quarters' column sums red[k *
// width + i], in order, for i < n.  All threads of the block.
template <int NTHR>
__device__ __forceinline__ void add_quarters(float* p, const float* red, int width, int n) {
    for (int i = threadIdx.x; i < n; i += NTHR)
        p[i] += ((red[i] + red[width + i]) + red[2 * width + i]) + red[3 * width + i];
}

// 2. The MLP half's VJP, LN2 backward, d_acc, d_oe and d_den, on the tensor
// cores (the mirror of B1's post_kernel).  64 tokens a tile, 8 warps: warp
// w owns tokens 16 (w % 4) .. + 15 and, in every product, half w / 4 of the
// columns.  Per tile:
//   the bf16 g and mid to shared memory (cp.async); LN2 statistics of mid
//     (a warp per 8 tokens) and n2 = bf16(nhat2 * ln2_s + ln2_b) into the
//     A tile sn2 (and to n2c);
//   the hidden units in chunks of MB_HC: fc1 recomputed (sn2 W1[:, chunk]
//     + b1) and d_h1 = g W2^T[:, chunk] (sg w2t[:, chunk]) on mma into
//     registers; h1 = bf16(h1pre * gl) and bf16(d_h1pre) to device memory,
//     bf16(d_h1pre) into the A tile sh, and at once its share of d_n2 (sh
//     W1^T[chunk rows, :]) summed into registers across the chunks, so
//     d_n2 never leaves them;
//   the LN2 backward in registers (each token's means over C from the two
//     column halves through shared memory): d_mid in f32 and bf16 to
//     device memory, bf16(d_mid) into the A tile (sn2's place);
//   d_acc = bf16(d_mid) Wo^T on mma, staged in f32 over the three tiles
//     that are done, then d_oe and d_den per (token, head).
// The vector gradients [df2b C | df1b hidden | dln2s C | dln2b C | dob C]
// are summed per block over its tiles in shared memory (a column's sum over
// a tile: a shuffle tree over each warp's 16 tokens, then the 4 token
// quarters in order) and written once per block.  Weights stream through
// shared memory in k-slices (block_gemm).  A ragged last hidden chunk reads
// W1's and W2^T's columns and W1^T's rows past hidden as zeros and b1 as 0
// there, so those units give h1pre = 0, d_h1 = 0 and d_h1pre = 0.
template <int C>
size_t mlp_bwd_smem_bytes(int hidden) {
    constexpr size_t wb = (C > MB_HC ? C : MB_HC) + 8;
    return sizeof(bf16) * (3 * MB_TOK * (C + 8) + MB_TOK * (MB_HC + 8) + 2 * KS * wb)
           + sizeof(float) * ((size_t)4 * C + hidden + 16 * C + 4 * MB_HC + 6 * MB_TOK);
}

// Two blocks an SM up to C = 128 (C = 256 needs more than 128 registers a
// thread; the bound made C = 128's launch 1.5x faster on the H100).
template <int C>
__global__ void __launch_bounds__(MB_THREADS, C <= 128 ? 2 : 1)
mlp_bwd_kernel(const bf16* __restrict__ mid, const bf16* __restrict__ g,
               const bf16* __restrict__ acc, const float* __restrict__ den,
               const bf16* __restrict__ ln2_s, const bf16* __restrict__ ln2_b,
               const bf16* __restrict__ w1, const bf16* __restrict__ b1,
               const bf16* __restrict__ w1t, const bf16* __restrict__ w2t,
               const bf16* __restrict__ wot,
               bf16* __restrict__ n2c, bf16* __restrict__ h1c, bf16* __restrict__ dh1c,
               float* __restrict__ d_mid, bf16* __restrict__ d_midc,
               bf16* __restrict__ d_oe, float* __restrict__ d_den,
               float* __restrict__ part, int M, int N, int H, int hidden) {
    constexpr int LDA = C + 8, LDH = MB_HC + 8, LDF = C + 4;
    constexpr int FNT = MB_HC / 16;    // n-tiles a warp: a chunk's fc1 and d_h1,
    constexpr int ONT = C / 16;        // d_n2 and d_acc
    constexpr int WB = (C > MB_HC ? C : MB_HC) + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sg = reinterpret_cast<bf16*>(smem_raw);          // 64 x LDA: g
    bf16* sn2 = sg + MB_TOK * LDA;                          // 64 x LDA: n2, then bf16(d_mid)
    bf16* smid = sn2 + MB_TOK * LDA;                        // 64 x LDA: mid
    float* sacc = reinterpret_cast<float*>(smem_raw);       // 64 x LDF: d_acc, over the three
    bf16* sh = smid + MB_TOK * LDA;                         // 64 x LDH: bf16(d_h1pre)
    bf16* wbuf = sh + MB_TOK * LDH;                         // block_gemm's buffers
    float* p_f2b = reinterpret_cast<float*>(wbuf + 2 * KS * WB);   // the block's partials
    float* p_f1b = p_f2b + C;
    float* p_l2s = p_f1b + hidden;
    float* p_l2b = p_l2s + C;
    float* p_ob = p_l2b + C;
    float* red = p_ob + C;                                  // 4 vectors x 4 quarters x C
    float* red_h = red + 16 * C;                            // 4 quarters x MB_HC
    float* s_mean = red_h + 4 * MB_HC;                      // 64
    float* s_rstd = s_mean + MB_TOK;                        // 64
    float* s_rows = s_rstd + MB_TOK;                        // 64 x [2 halves x (sum dn, dn nh)]
    const int pw = 4 * C + hidden;
    const int D = C / H;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, q = lane & 3;
    const int quarter = warp & 3, half = warp >> 2;
    const int mrow = 16 * quarter;
    for (int i = threadIdx.x; i < pw; i += MB_THREADS) p_f2b[i] = 0.f;

    const int ntiles = (M + MB_TOK - 1) / MB_TOK;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int tok0 = tile * MB_TOK;
        const int ntok = min(MB_TOK, M - tok0);
        const size_t base = (size_t)tok0 * C;
        stage_rows<MB_THREADS>(sg, LDA, g, C, tok0, MB_TOK, ntok, C);
        stage_rows<MB_THREADS>(smid, LDA, mid, C, tok0, MB_TOK, ntok, C);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        // LN2 of mid, a warp per 8 tokens (padded tokens: zeros)
        for (int t = warp * (MB_TOK / 8); t < (warp + 1) * (MB_TOK / 8); ++t) {
            float v[C / 32];
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < C / 32; ++i) {
                v[i] = __bfloat162float(smid[t * LDA + lane + 32 * i]);
                sum += v[i];
            }
            const float mean = warp_sum(sum) / C;
            float var = 0.f;
#pragma unroll
            for (int i = 0; i < C / 32; ++i) var += (v[i] - mean) * (v[i] - mean);
            const float rstd = rsqrtf(warp_sum(var) / C + 1e-5f);
#pragma unroll
            for (int i = 0; i < C / 32; ++i) {
                const int c = lane + 32 * i;
                const bf16 n2 = __float2bfloat16((v[i] - mean) * rstd * ld(ln2_s + c)
                                                 + ld(ln2_b + c));
                sn2[t * LDA + c] = n2;
                if (t < ntok) n2c[base + t * C + c] = n2;
            }
            if (lane == 0) {
                s_mean[t] = mean;
                s_rstd[t] = rstd;
            }
        }
        // the MLP's hidden units, MB_HC at a time (block_gemm's first
        // barrier orders sn2)
        float dn2[ONT][4];
        zero(dn2);
        for (int h0 = 0; h0 < hidden; h0 += MB_HC) {
            float f[FNT][4], dd[FNT][4];
            zero(f);
            zero(dd);
            block_gemm<FNT, MB_HC, MB_THREADS>(f, sn2 + mrow * LDA, LDA, w1, hidden, h0, C, wbuf,
                                               half * MB_HC / 2, 1 << 30, hidden);
            block_gemm<FNT, MB_HC, MB_THREADS>(dd, sg + mrow * LDA, LDA, w2t, hidden, h0, C,
                                               wbuf, half * MB_HC / 2, 1 << 30, hidden);
            float cs[FNT][2] = {};
#pragma unroll
            for (int j = 0; j < FNT; ++j) {
                const int col = half * MB_HC / 2 + 8 * j + 2 * q;
                const int hc = h0 + col;
                const bool in = hc < hidden;
                const float bj0 = in ? ld(b1 + hc) : 0.f, bj1 = in ? ld(b1 + hc + 1) : 0.f;
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int t = mrow + gq + 8 * hr;
                    const float hp0 = f[j][2 * hr] + bj0, hp1 = f[j][2 * hr + 1] + bj1;
                    const float gl0 = 0.5f * (1.0f + erff(hp0 * 0.70710678118654752f));
                    const float gl1 = 0.5f * (1.0f + erff(hp1 * 0.70710678118654752f));
                    const float dhp0 = dd[j][2 * hr]
                        * (gl0 + hp0 * expf(-0.5f * hp0 * hp0) * INV_SQRT_2PI);
                    const float dhp1 = dd[j][2 * hr + 1]
                        * (gl1 + hp1 * expf(-0.5f * hp1 * hp1) * INV_SQRT_2PI);
                    *reinterpret_cast<__nv_bfloat162*>(sh + t * LDH + col) =
                        __floats2bfloat162_rn(dhp0, dhp1);
                    if (t < ntok && in) {
                        const size_t o = (size_t)(tok0 + t) * hidden + hc;
                        *reinterpret_cast<__nv_bfloat162*>(h1c + o) =
                            __floats2bfloat162_rn(hp0 * gl0, hp1 * gl1);
                        *reinterpret_cast<__nv_bfloat162*>(dh1c + o) =
                            __floats2bfloat162_rn(dhp0, dhp1);
                        cs[j][0] += dhp0;
                        cs[j][1] += dhp1;
                    }
                }
            }
            warp_colsum(cs, red_h + quarter * MB_HC + half * MB_HC / 2);
            // d_n2 += bf16(d_h1pre) W1^T[chunk rows, :] (the first barrier
            // orders sh and red)
            block_gemm<ONT, C, MB_THREADS>(dn2, sh + mrow * LDH, LDH, w1t + (size_t)h0 * C, C, 0,
                                           MB_HC, wbuf, half * C / 2, hidden - h0);
            add_quarters<MB_THREADS>(p_f1b + h0, red_h, MB_HC, min(MB_HC, hidden - h0));
        }
        // LN2 backward: d_mid = g + rstd (dn - m1 - nhat m2), dn = d_n2 ln2_s
        float ra[2] = {}, rb[2] = {};
        float c_l2s[ONT][2] = {}, c_l2b[ONT][2] = {};
#pragma unroll
        for (int j = 0; j < ONT; ++j) {
            const int col = half * C / 2 + 8 * j + 2 * q;
            const float ls0 = ld(ln2_s + col), ls1 = ld(ln2_s + col + 1);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int t = mrow + gq + 8 * hr;
                const float mean = s_mean[t], rstd = s_rstd[t];
                const float nh0 = (__bfloat162float(smid[t * LDA + col]) - mean) * rstd;
                const float nh1 = (__bfloat162float(smid[t * LDA + col + 1]) - mean) * rstd;
                const float dn0 = dn2[j][2 * hr] * ls0, dn1 = dn2[j][2 * hr + 1] * ls1;
                ra[hr] += dn0 + dn1;
                rb[hr] += dn0 * nh0 + dn1 * nh1;
                if (t < ntok) {
                    c_l2s[j][0] += dn2[j][2 * hr] * nh0;
                    c_l2s[j][1] += dn2[j][2 * hr + 1] * nh1;
                    c_l2b[j][0] += dn2[j][2 * hr];
                    c_l2b[j][1] += dn2[j][2 * hr + 1];
                }
            }
        }
        warp_colsum(c_l2s, red + (1 * 4 + quarter) * C + half * C / 2);
        warp_colsum(c_l2b, red + (2 * 4 + quarter) * C + half * C / 2);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
                ra[hr] += __shfl_xor_sync(0xffffffffu, ra[hr], o);
                rb[hr] += __shfl_xor_sync(0xffffffffu, rb[hr], o);
            }
            if (q == 0) {
                const int t = mrow + gq + 8 * hr;
                s_rows[t * 4 + 2 * half] = ra[hr];
                s_rows[t * 4 + 2 * half + 1] = rb[hr];
            }
        }
        __syncthreads();
        float c_ob[ONT][2] = {}, c_f2b[ONT][2] = {};
#pragma unroll
        for (int j = 0; j < ONT; ++j) {
            const int col = half * C / 2 + 8 * j + 2 * q;
            const float ls0 = ld(ln2_s + col), ls1 = ld(ln2_s + col + 1);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int t = mrow + gq + 8 * hr;
                const float mean = s_mean[t], rstd = s_rstd[t];
                const float m1 = (s_rows[t * 4] + s_rows[t * 4 + 2]) / C;
                const float m2 = (s_rows[t * 4 + 1] + s_rows[t * 4 + 3]) / C;
                const float nh0 = (__bfloat162float(smid[t * LDA + col]) - mean) * rstd;
                const float nh1 = (__bfloat162float(smid[t * LDA + col + 1]) - mean) * rstd;
                const float g0 = __bfloat162float(sg[t * LDA + col]);
                const float g1 = __bfloat162float(sg[t * LDA + col + 1]);
                const float dm0 = g0 + rstd * (dn2[j][2 * hr] * ls0 - m1 - nh0 * m2);
                const float dm1 = g1 + rstd * (dn2[j][2 * hr + 1] * ls1 - m1 - nh1 * m2);
                const __nv_bfloat162 dmc = __floats2bfloat162_rn(dm0, dm1);
                *reinterpret_cast<__nv_bfloat162*>(sn2 + t * LDA + col) = dmc;
                if (t < ntok) {
                    *reinterpret_cast<float2*>(d_mid + base + t * C + col) = make_float2(dm0, dm1);
                    *reinterpret_cast<__nv_bfloat162*>(d_midc + base + t * C + col) = dmc;
                    c_ob[j][0] += dm0;
                    c_ob[j][1] += dm1;
                    c_f2b[j][0] += g0;
                    c_f2b[j][1] += g1;
                }
            }
        }
        warp_colsum(c_f2b, red + (0 * 4 + quarter) * C + half * C / 2);
        warp_colsum(c_ob, red + (3 * 4 + quarter) * C + half * C / 2);
        // d_acc = bf16(d_mid) Wo^T (the first barrier orders sn2 and red)
        float da[ONT][4];
        zero(da);
        block_gemm<ONT, C, MB_THREADS>(da, sn2 + mrow * LDA, LDA, wot, C, 0, C, wbuf,
                                       half * C / 2);
        add_quarters<MB_THREADS>(p_f2b, red, C, C);
        add_quarters<MB_THREADS>(p_l2s, red + 4 * C, C, C);
        add_quarters<MB_THREADS>(p_l2b, red + 8 * C, C, C);
        add_quarters<MB_THREADS>(p_ob, red + 12 * C, C, C);
#pragma unroll
        for (int j = 0; j < ONT; ++j) {
            const int col = half * C / 2 + 8 * j + 2 * q;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int t = mrow + gq + 8 * hr;
                sacc[t * LDF + col] = da[j][2 * hr];
                sacc[t * LDF + col + 1] = da[j][2 * hr + 1];
            }
        }
        __syncthreads();
        // d_oe = bf16(d_acc / den) and d_den = bf16(-(1/den) sum_D d_acc * acc)
        for (int i = threadIdx.x; i < ntok * H; i += MB_THREADS) {
            const int t = i / H, h = i % H;
            const int tok = tok0 + t;
            const float dv = den[((size_t)(tok / N) * H + h) * N + tok % N];
            const float r = 1.0f / dv;
            float s = 0.f;
            for (int d = 0; d < D; ++d) {
                const int c = h * D + d;
                const float da_c = sacc[t * LDF + c];
                s += da_c * ld(acc + base + t * C + c);
                d_oe[base + t * C + c] = __float2bfloat16(da_c * r);
            }
            d_den[(size_t)tok * H + h] = round_bf16(-r * s);
        }
        __syncthreads();          // sacc is read before the next tile's g and mid
    }
    for (int i = threadIdx.x; i < pw; i += MB_THREADS) part[(size_t)blockIdx.x * pw + i] = p_f2b[i];
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

// 6. part[s][i][j] = sum over split s's tokens t of A[t][i] * B[t][j], on
// the tensor cores: tokens are the product's k.  A 64 x 64 output tile a
// block, 4 warps, warp w its rows 16 w .. + 15 and all 64 columns.  Both
// operands are token-major bf16 in device memory: stages of ATB_K tokens
// of each (ATB_K x 64, zero-filled past the split and past Ka, Kb) go to
// shared memory by cp.async, the next in flight while the current one is
// multiplied; A's fragments come from its k-major tile by ldmatrix.trans,
// B's likewise.  Ka, Kb multiples of 8, A and B 16-byte aligned.
constexpr int ATB_THREADS = 128;
constexpr int ATB_LD = ATB_T + 8;

__global__ void __launch_bounds__(ATB_THREADS)
atb_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ part,
           int M, int Ka, int Kb, int per_split) {
    __shared__ __align__(16) bf16 As[2][ATB_K * ATB_LD];
    __shared__ __align__(16) bf16 Bs[2][ATB_K * ATB_LD];
    const int i0 = blockIdx.y * ATB_T, j0 = blockIdx.x * ATB_T;
    const int t_begin = blockIdx.z * per_split;
    const int t_end = min(M, t_begin + per_split);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    float acc[ATB_T / 8][4];
    zero(acc);
    auto load = [&](int st, int t0) {
        for (int e = threadIdx.x; e < ATB_K * (ATB_T / 8); e += ATB_THREADS) {
            const int tt = e / (ATB_T / 8), c = (e % (ATB_T / 8)) * 8;
            const int t = t0 + tt;
            const bool in = t < t_end;
            const bool a_ok = in && i0 + c < Ka, b_ok = in && j0 + c < Kb;
            cp_async16(As[st] + tt * ATB_LD + c, a_ok ? A + (size_t)t * Ka + i0 + c : A, a_ok);
            cp_async16(Bs[st] + tt * ATB_LD + c, b_ok ? B + (size_t)t * Kb + j0 + c : B, b_ok);
        }
    };
    const int nst = t_end > t_begin ? (t_end - t_begin + ATB_K - 1) / ATB_K : 0;
    if (nst > 0) load(0, t_begin);
    cp_async_commit();
    for (int s = 0; s < nst; ++s) {
        if (s + 1 < nst) load((s + 1) & 1, t_begin + (s + 1) * ATB_K);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const bf16* a = As[s & 1];
        const bf16* b = Bs[s & 1];
#pragma unroll
        for (int kk = 0; kk < ATB_K; kk += 16) {
            uint32_t af[4];
            ldsm_a_kmajor(af, a, ATB_LD, kk, 16 * warp);
#pragma unroll
            for (int j = 0; j < ATB_T / 8; j += 2) {
                uint32_t bfr[4];
                ldsm_b_kmajor(bfr, b, ATB_LD, kk, 8 * j);
                mma_bf16(acc[j], af, bfr[0], bfr[1]);
                mma_bf16(acc[j + 1], af, bfr[2], bfr[3]);
            }
        }
        __syncthreads();          // the buffers are free before they are refilled
    }
    float* out = part + (size_t)blockIdx.z * Ka * Kb;
#pragma unroll
    for (int j = 0; j < ATB_T / 8; ++j) {
        const int col = j0 + 8 * j + 2 * q;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int i = i0 + 16 * warp + g + 8 * hr;
            if (i < Ka && col < Kb)
                *reinterpret_cast<float2*>(out + (size_t)i * Kb + col) =
                    make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
        }
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
    atb_kernel<<<grid, ATB_THREADS, 0, stream>>>(A, B, part, M, Ka, Kb, per);
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
    // mlp_bwd_kernel's partials and, after them, ln1_bwd_kernel's
    s.vec_part = (float*)take(std::max((size_t)mlp_blocks((int)M) * (4 * C + hidden),
                                       (size_t)tile_blocks((int)M) * 2 * C) * 4);
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
    const int G = mlp_blocks(M);
    const int pw = 4 * C + hidden;
    auto mlp = [&](auto kernel, size_t smem) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        kernel<<<G, MB_THREADS, smem, stream>>>(
            (const bf16*)mid, bg, bacc, (const float*)den, (const bf16*)ln2_s,
            (const bf16*)ln2_b, (const bf16*)w_1, (const bf16*)b_1, (const bf16*)w_1_t,
            (const bf16*)w_2_t, (const bf16*)w_o_t, s.n2c, s.h1c, s.dh1c, s.d_mid, s.d_midc,
            s.d_oe, s.d_den, s.vec_part, M, N, H, hidden);
        return cudaGetLastError();
    };
    switch (C) {
        case 32: err = mlp(mlp_bwd_kernel<32>, mlp_bwd_smem_bytes<32>(hidden)); break;
        case 64: err = mlp(mlp_bwd_kernel<64>, mlp_bwd_smem_bytes<64>(hidden)); break;
        case 128: err = mlp(mlp_bwd_kernel<128>, mlp_bwd_smem_bytes<128>(hidden)); break;
        case 256: err = mlp(mlp_bwd_kernel<256>, mlp_bwd_smem_bytes<256>(hidden)); break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
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
    const int G1 = tile_blocks(M);
    const size_t ln1_smem = ((size_t)5 * TOK * C + TOK + 2 * C) * sizeof(float);
    err = cudaFuncSetAttribute(ln1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ln1_smem);
    if (err != cudaSuccess) return err;
    ln1_bwd_kernel<<<G1, THREADS, ln1_smem, stream>>>(
        bx, s.dqkv, s.d_mid, (const bf16*)ln1_s, (const bf16*)w_qkv_t, (bf16*)dx,
        s.vec_part, M, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = reduce(s.vec_part, g_ln1s, G1, 2 * C, C, stream)) != cudaSuccess) return err;
    if ((err = reduce(s.vec_part + C, g_ln1b, G1, 2 * C, C, stream)) != cudaSuccess) return err;

    // 6-7. weight gradients
    if ((err = atb(s.h1c, bg, s.mat_part, g_w2, M, hidden, C, stream)) != cudaSuccess) return err;
    if ((err = atb(s.n2c, s.dh1c, s.mat_part, g_w1, M, C, hidden, stream)) != cudaSuccess) return err;
    if ((err = atb(bacc, s.d_midc, s.mat_part, g_wo, M, C, C, stream)) != cudaSuccess) return err;
    return atb(s.normed, s.dqkv, s.mat_part, g_qkv, M, C, 3 * C, stream);
}
