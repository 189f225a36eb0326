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
// and no float atomics are used.  Every product runs on the tensor cores
// (mma.sync, the tile of block_common.cuh).  Launches, all on the caller's
// stream:
//   1. ln_qkv_kernel<C, true>: B1's LN1 + qkv launch (64 tokens a block),
//                           also writes bf16 normed;
//   2. mlp_bwd_kernel<C>:   per 64-token tile, the MLP half's VJP, LN2
//                           backward, d_acc and d_oe / d_den (see the
//                           kernel); writes the bf16 operands of the
//                           weight gradients and per-block partials of the
//                           five vectors;
//   3. attn_bwd_norm_kernel: per row and head the bound max|q_h| max|k_h|
//                           that lets a pass skip the clamp (one small
//                           block per row);
//      attn_bwd_q_kernel<D>:  one block per (row, 16 NW queries), keys
//                           streamed through shared memory: d_q;
//   4. attn_bwd_kv_kernel<D>: one block per (row, 16 NW keys), queries
//                           streamed: d_k, d_v (see the two kernels);
//   5. ln1_bwd_kernel<C>:   per 64-token tile, d_normed = dqkv Wqkv^T, the
//                           LN1 backward, dx, and the LN1 vector partials;
//   6. atb_kernel x 4:      split-K A^T B over tokens (64 x 64 output
//                           tiles, tokens as k) for dW2, dW1, dWo, dWqkv,
//                           into per-split partials;
//   7. reduce_kernel:       the partial sums, in order.
// Widths: as B1's (fused_block.cu).  mlp_bwd_kernel and ln1_bwd_kernel run
// at CP (32 tokens a tile at CP >= 384); q|k|v is recomputed with the heads
// padded to DP and mlp_bwd_kernel writes d_oe padded the same way; the
// attention backward takes DP up to 32 (attn_bwd_q_kernel,
// attn_bwd_kv_kernel) or above (their _wide forms: the own rows' two
// tensors staged in shared memory, the output in parts) and writes dqkv in
// the block's layout, so that ln1_bwd_kernel and the weight gradients see
// the block's own widths.
// Neither attention kernel keeps an (N, N) plane: a score lives in
// registers, and key (query) chunks wholly past N are never visited.  Each
// launch owns its outputs (d_q; d_k and d_v), so both recompute s, d_p and
// exp2: the backward spends 2 H N^2 exp2 a row against the function's one
// (a one-pass design would need d_q partials per key tile in scratch).
//
// What bounds it on the H100.  At stage 0 (D = 4) the attention kernels
// are bound by the unit that runs exp2 (MUFU, 16 a clock an SM), which by
// their measured times also runs the f32 -> bf16 packs (F2FP): a (query,
// key) pair costs one exp2 and half a pack (d_s) in the q pass, one of
// each (d_s and p) in the kv pass, so the two run at most at 2/3 and 1/2
// of the exp2 rate; besides, two FMUL, and the clamp and select only where
// a score nears the clamp.  Their products (s and d_p, then d_q, or d_k
// and d_v) are a few percent of the tensor cores' rate at D = 4-16.  The
// product launches 2, 5 and 6 (bf16 operands, f32 sums) do about 6 C (2 C
// + hidden) FLOPs on about 70 C bytes of operands and results a token: far
// below the card's 295 FLOP a byte, so device-memory bytes bound them.
// The bf16 intermediates that go through device memory (qkv, normed, n2,
// h1, d_h1pre, d_mid, d_oe, dqkv) add about (14 C + 4 hidden) bytes a token
// of round trips over one fused kernel.
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

// blocks of the 64-token tile loops (mlp_bwd_kernel, ln1_bwd_kernel)
int token_blocks(int M) { return min((M + MB_TOK - 1) / MB_TOK, MAX_TILE_BLOCKS); }

int splits(int M) { return max(1, min((M + SPLIT_TOKENS - 1) / SPLIT_TOKENS, MAX_SPLITS)); }

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

// The same for RG token parts (RG = 4: add_quarters; RG = 2: the 32-token
// tiles of the wide plans).
template <int NTHR, int RG>
__device__ __forceinline__ void add_parts(float* p, const float* red, int width, int n) {
    if constexpr (RG == 4) {
        add_quarters<NTHR>(p, red, width, n);
    } else {
        for (int i = threadIdx.x; i < n; i += NTHR) {
            float s = red[i];
#pragma unroll
            for (int k = 1; k < RG; ++k) s += red[k * width + i];
            p[i] += s;
        }
    }
}

// Tokens a tile of mlp_bwd_kernel and ln1_bwd_kernel at product width CP
// (64; 32 at CP >= 384, so that the tiles fit shared memory), their row
// groups of 16 tokens (RG) and column parts (CS, 8 warps = RG x CS).
template <int CP>
__host__ __device__ constexpr int tile_tok() { return CP >= 384 ? 32 : MB_TOK; }

// 2. The MLP half's VJP, LN2 backward, d_acc, d_oe and d_den, on the tensor
// cores (the mirror of B1's post_kernel).  TOK = tile_tok<CP>() tokens a
// tile, 8 warps: warp w owns tokens 16 (w % RG) .. + 15 and, in every
// product, part w / RG of the CS parts of the columns.  Per tile:
//   the bf16 g and mid to shared memory (cp.async, zero past C); LN2
//     statistics of mid over its C channels (a warp per TOK / 8 tokens) and
//     n2 = bf16(nhat2 * ln2_s + ln2_b) into the A tile sn2 (and to n2c);
//   the hidden units in chunks of MB_HC: fc1 recomputed (sn2 W1[:, chunk]
//     + b1) and d_h1 = g W2^T[:, chunk] (sg w2t[:, chunk]) on mma into
//     registers; h1 = bf16(h1pre * gl) and bf16(d_h1pre) to device memory,
//     bf16(d_h1pre) into the A tile sh, and at once its share of d_n2 (sh
//     W1^T[chunk rows, :]) summed into registers across the chunks, so
//     d_n2 never leaves them;
//   the LN2 backward in registers (each token's means over C from the
//     column parts through shared memory): d_mid in f32 and bf16 to
//     device memory, bf16(d_mid) into the A tile (sn2's place);
//   d_acc = bf16(d_mid) Wo^T on mma, staged in f32 over the three tiles
//     that are done, then d_oe and d_den per (token, head): d_oe in the
//     attention's padded head layout (CA columns, zeros past each head's D
//     channels and in the heads past H; see head_plan), d_den (M, H).
// The tiles are CP = prod_width(C) wide, zero past C, and every weight is
// read as zeros past C, so nothing past C reaches a result.
// The vector gradients [df2b C | df1b hidden | dln2s C | dln2b C | dob C]
// are summed per block over its tiles in shared memory (a column's sum over
// a tile: a shuffle tree over each warp's 16 tokens, then the RG token
// parts in order) and written once per block.  Weights stream through
// shared memory in k-slices (block_gemm).  A ragged last hidden chunk reads
// W1's and W2^T's columns and W1^T's rows past hidden as zeros and b1 as 0
// there, so those units give h1pre = 0, d_h1 = 0 and d_h1pre = 0.
template <int CP>
size_t mlp_bwd_smem_bytes(int hidden) {
    constexpr size_t T = tile_tok<CP>(), RG = T / 16, CS = 8 / RG;
    constexpr size_t wb = (CP > MB_HC ? CP : MB_HC) + 8;
    return sizeof(bf16) * (3 * T * (CP + 8) + T * (MB_HC + 8) + 2 * KS * wb)
           + sizeof(float) * ((size_t)4 * CP + hidden + 4 * RG * CP + RG * MB_HC + 2 * T
                              + 2 * CS * T);
}

// Two blocks an SM up to C = 128 (C = 256 needs more than 128 registers a
// thread; the bound made C = 128's launch 1.5x faster on the H100).
template <int CP, bool EXACT>
__global__ void __launch_bounds__(MB_THREADS, CP <= 128 ? 2 : 1)
mlp_bwd_kernel(const bf16* __restrict__ mid, const bf16* __restrict__ g,
               const bf16* __restrict__ acc, const float* __restrict__ den,
               const bf16* __restrict__ ln2_s, const bf16* __restrict__ ln2_b,
               const bf16* __restrict__ w1, const bf16* __restrict__ b1,
               const bf16* __restrict__ w1t, const bf16* __restrict__ w2t,
               const bf16* __restrict__ wot,
               bf16* __restrict__ n2c, bf16* __restrict__ h1c, bf16* __restrict__ dh1c,
               float* __restrict__ d_mid, bf16* __restrict__ d_midc,
               bf16* __restrict__ d_oe, float* __restrict__ d_den,
               float* __restrict__ part, int M, int N, int H, int hidden, int c, int dp,
               int ca) {
    // EXACT: C = CA = CP and DP = D (the flagship's layouts), C and CA
    // known at compile time
    const int C = EXACT ? CP : c, CA = EXACT ? CP : ca, DP = EXACT ? CP / H : dp;
    constexpr int TOK = tile_tok<CP>(), RG = TOK / 16, CS = 8 / RG;
    constexpr int LDA = CP + 8, LDH = MB_HC + 8, LDF = CP + 4;
    constexpr int FNT = MB_HC / (8 * CS);    // n-tiles a warp: a chunk's fc1 and d_h1,
    constexpr int ONT = CP / (8 * CS);       // d_n2 and d_acc
    constexpr int WB = (CP > MB_HC ? CP : MB_HC) + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sg = reinterpret_cast<bf16*>(smem_raw);          // TOK x LDA: g
    bf16* sn2 = sg + TOK * LDA;                             // TOK x LDA: n2, then bf16(d_mid)
    bf16* smid = sn2 + TOK * LDA;                           // TOK x LDA: mid
    float* sacc = reinterpret_cast<float*>(smem_raw);       // TOK x LDF: d_acc, over the three
    bf16* sh = smid + TOK * LDA;                            // TOK x LDH: bf16(d_h1pre)
    bf16* wbuf = sh + TOK * LDH;                            // block_gemm's buffers
    float* p_f2b = reinterpret_cast<float*>(wbuf + 2 * KS * WB);   // the block's partials
    float* p_f1b = p_f2b + C;
    float* p_l2s = p_f1b + hidden;
    float* p_l2b = p_l2s + C;
    float* p_ob = p_l2b + C;
    float* red = p_f2b + 4 * CP + hidden;                   // 4 vectors x RG parts x CP
    float* red_h = red + 4 * RG * CP;                       // RG parts x MB_HC
    float* s_mean = red_h + RG * MB_HC;                     // TOK
    float* s_rstd = s_mean + TOK;                           // TOK
    float* s_rows = s_rstd + TOK;                           // TOK x [CS parts x (sum dn, dn nh)]
    const int pw = 4 * C + hidden;
    const int D = C / H;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, q = lane & 3;
    const int rg = warp % RG, cpart = warp / RG;
    const int mrow = 16 * rg;
    const int ccol0 = cpart * CP / CS;                      // the warp's first column
    for (int i = threadIdx.x; i < pw; i += MB_THREADS) p_f2b[i] = 0.f;

    const int ntiles = (M + TOK - 1) / TOK;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int tok0 = tile * TOK;
        const int ntok = min(TOK, M - tok0);
        const size_t base = (size_t)tok0 * C;
        stage_rows<MB_THREADS>(sg, LDA, g, C, tok0, TOK, ntok, C);
        stage_rows<MB_THREADS>(smid, LDA, mid, C, tok0, TOK, ntok, C);
        cp_async_commit();
        if (C < CP) {
            for (int i = threadIdx.x; i < TOK * (CP - C); i += MB_THREADS) {
                const int o = (i / (CP - C)) * LDA + C + i % (CP - C);
                sg[o] = smid[o] = __float2bfloat16(0.f);
            }
        }
        cp_async_wait<0>();
        __syncthreads();
        // LN2 of mid, a warp per TOK / 8 tokens (padded tokens: zeros)
        for (int t = warp * (TOK / 8); t < (warp + 1) * (TOK / 8); ++t) {
            float v[CP / 32];
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < CP / 32; ++i) {
                v[i] = __bfloat162float(smid[t * LDA + lane + 32 * i]);
                sum += v[i];
            }
            const float mean = warp_sum(sum) / C;
            float var = 0.f;
#pragma unroll
            for (int i = 0; i < CP / 32; ++i)
                if (lane + 32 * i < C) var += (v[i] - mean) * (v[i] - mean);
            const float rstd = rsqrtf(warp_sum(var) / C + 1e-5f);
#pragma unroll
            for (int i = 0; i < CP / 32; ++i) {
                const int c = lane + 32 * i;
                const bf16 n2 = c < C ? __float2bfloat16((v[i] - mean) * rstd * ld(ln2_s + c)
                                                         + ld(ln2_b + c))
                                      : __float2bfloat16(0.f);
                sn2[t * LDA + c] = n2;
                if (t < ntok && c < C) n2c[base + t * C + c] = n2;
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
            block_gemm<FNT, MB_HC, MB_THREADS>(f, sn2 + mrow * LDA, LDA, w1, hidden, h0, CP, wbuf,
                                               cpart * MB_HC / CS, C, hidden);
            block_gemm<FNT, MB_HC, MB_THREADS>(dd, sg + mrow * LDA, LDA, w2t, hidden, h0, CP,
                                               wbuf, cpart * MB_HC / CS, C, hidden);
            float cs[FNT][2] = {};
#pragma unroll
            for (int j = 0; j < FNT; ++j) {
                const int col = cpart * MB_HC / CS + 8 * j + 2 * q;
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
            warp_colsum(cs, red_h + rg * MB_HC + cpart * MB_HC / CS);
            // d_n2 += bf16(d_h1pre) W1^T[chunk rows, :] (the first barrier
            // orders sh and red)
            block_gemm<ONT, CP, MB_THREADS>(dn2, sh + mrow * LDH, LDH, w1t + (size_t)h0 * C, C,
                                            0, MB_HC, wbuf, ccol0, hidden - h0, C);
            add_parts<MB_THREADS, RG>(p_f1b + h0, red_h, MB_HC, min(MB_HC, hidden - h0));
        }
        // LN2 backward: d_mid = g + rstd (dn - m1 - nhat m2), dn = d_n2 ln2_s
        // (the columns past C: none of it)
        float ra[2] = {}, rb[2] = {};
        float c_l2s[ONT][2] = {}, c_l2b[ONT][2] = {};
#pragma unroll
        for (int j = 0; j < ONT; ++j) {
            const int col = ccol0 + 8 * j + 2 * q;
            if (col >= C) continue;
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
        warp_colsum(c_l2s, red + (1 * RG + rg) * CP + ccol0);
        warp_colsum(c_l2b, red + (2 * RG + rg) * CP + ccol0);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
                ra[hr] += __shfl_xor_sync(0xffffffffu, ra[hr], o);
                rb[hr] += __shfl_xor_sync(0xffffffffu, rb[hr], o);
            }
            if (q == 0) {
                const int t = mrow + gq + 8 * hr;
                s_rows[t * 2 * CS + 2 * cpart] = ra[hr];
                s_rows[t * 2 * CS + 2 * cpart + 1] = rb[hr];
            }
        }
        __syncthreads();
        float c_ob[ONT][2] = {}, c_f2b[ONT][2] = {};
#pragma unroll
        for (int j = 0; j < ONT; ++j) {
            const int col = ccol0 + 8 * j + 2 * q;
            if (col >= C) continue;
            const float ls0 = ld(ln2_s + col), ls1 = ld(ln2_s + col + 1);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int t = mrow + gq + 8 * hr;
                const float mean = s_mean[t], rstd = s_rstd[t];
                float sa_ = s_rows[t * 2 * CS], sb_ = s_rows[t * 2 * CS + 1];
#pragma unroll
                for (int k = 1; k < CS; ++k) {
                    sa_ += s_rows[t * 2 * CS + 2 * k];
                    sb_ += s_rows[t * 2 * CS + 2 * k + 1];
                }
                const float m1 = sa_ / C, m2 = sb_ / C;
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
        warp_colsum(c_f2b, red + (0 * RG + rg) * CP + ccol0);
        warp_colsum(c_ob, red + (3 * RG + rg) * CP + ccol0);
        // d_acc = bf16(d_mid) Wo^T (the first barrier orders sn2 and red;
        // sn2 past C holds LN2's zeros)
        float da[ONT][4];
        zero(da);
        block_gemm<ONT, CP, MB_THREADS>(da, sn2 + mrow * LDA, LDA, wot, C, 0, CP, wbuf, ccol0, C,
                                        C);
        add_parts<MB_THREADS, RG>(p_f2b, red, CP, C);
        add_parts<MB_THREADS, RG>(p_l2s, red + RG * CP, CP, C);
        add_parts<MB_THREADS, RG>(p_l2b, red + 2 * RG * CP, CP, C);
        add_parts<MB_THREADS, RG>(p_ob, red + 3 * RG * CP, CP, C);
#pragma unroll
        for (int j = 0; j < ONT; ++j) {
            const int col = ccol0 + 8 * j + 2 * q;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int t = mrow + gq + 8 * hr;
                sacc[t * LDF + col] = da[j][2 * hr];
                sacc[t * LDF + col + 1] = da[j][2 * hr + 1];
            }
        }
        __syncthreads();
        // d_oe = bf16(d_acc / den) and d_den = bf16(-(1/den) sum_D d_acc * acc),
        // d_oe padded per head to DP channels of zeros (CA = HK DP columns)
        const int HK = CA / DP;
        for (int i = threadIdx.x; i < ntok * HK; i += MB_THREADS) {
            const int t = i / HK, h = i % HK;
            const int tok = tok0 + t;
            bf16* dst = d_oe + (size_t)tok * CA + h * DP;
            int d = 0;
            if (h < H) {
                const float dv = den[((size_t)(tok / N) * H + h) * N + tok % N];
                const float r = 1.0f / dv;
                float s = 0.f;
                for (; d < D; ++d) {
                    const int c = h * D + d;
                    const float da_c = sacc[t * LDF + c];
                    s += da_c * ld(acc + base + t * C + c);
                    dst[d] = __float2bfloat16(da_c * r);
                }
                d_den[(size_t)tok * H + h] = round_bf16(-r * s);
            }
            for (; d < DP; ++d) dst[d] = __float2bfloat16(0.f);
        }
        __syncthreads();          // sacc is read before the next tile's g and mid
    }
    for (int i = threadIdx.x; i < pw; i += MB_THREADS) part[(size_t)blockIdx.x * pw + i] = p_f2b[i];
}

// 3-4. The attention backward on the tensor cores, in two launches that
// share one design (the mirror of B1's attn_kernel): one block per (row,
// 16 NW rows of its side), NW warps (8 where N > 64, else 4); warp w owns
// the rows r0 + 16 w .. + 15 of its side (queries for attn_bwd_q_kernel,
// keys for attn_bwd_kv_kernel), and the block streams the row's other side
// through shared memory in tiles of AK tokens (128 where N > 64, else 64),
// double buffered with cp.async.  The heads go in passes of PASS = max(16,
// D) channels (16 / D heads a pass, or one head): a staged tile row holds
// the pass's channels of two tensors (k | v, or q | d_oe), whole 16-byte
// chunks, so that one tile serves every head of the pass and every warp.
// The warp's own operands are A fragments in registers, loaded once a
// pass (head_frags).  A score or d_p product spans the head's channels
// only: at D <= 8 one m16n8k8 step (at D = 4 it holds two heads, and the
// other head's channels of A are zeroed, as the forward masks q), else its
// k16 steps; at D <= 8 a k16 step, as the forward takes, would be half or
// three quarters zeros.  Per 16 rows of the other side and head, on mma:
//   attn_bwd_q:  s = q k^T and d_p = d_oe v^T + d_den (the accumulator
//                seeded with the query's d_den: the same sum as the JAX
//                kernel's augmented product [d_oe | d_den] [v | 1]^T, whose
//                ones column adds d_den * 1 exactly), both with B = the key
//                tile read n-major; the line in registers (bwd_line); d_s
//                packed to a bf16 A fragment (pack_a), and d_q += d_s k with
//                B = the same key tile read k-major (rows = keys);
//   attn_bwd_kv: s^T = k q^T and d_p^T = v d_oe^T + d_den (seeded per
//                column from the tile's d_den, staged beside it), B = the
//                query tile read n-major; d_s^T and bf16(p^T) packed, d_k +=
//                d_s^T q and d_v += p^T d_oe with B = the q and d_oe tile
//                read k-major from the same rows.
// At D = 4 an n-tile of d_q (d_k, d_v) spans two heads: B's columns of the
// other head are zeroed in registers, so the two heads' sums share the
// accumulator (head_acc).  Both passes see the same s and d_p for a pair,
// so they agree on the clamp: the products of bf16 are exact in f32, each
// pass puts channel c of the head at the same k position of the same mma
// shape, with the same accumulator seed (0 for s, d_den for d_p), and the
// tensor cores' sum is a fixed function of its inputs' positions; a score
// near the clamp is recomputed by the same FMA chain in both (clamp_band).
// The other side's tokens past N are zero-filled, not masked: a zero key
// meets k = 0 in d_q (its d_s is d_den ln 2 but adds d_s * 0), and a zero
// query has d_oe = 0 and d_den = 0, so d_p = 0, d_s = 0 and p * d_oe = 0:
// both add exactly 0.  The warp's own rows past N compute on zeros and
// write nothing; a warp whose rows are all past N only helps to load.
// The line (clamp, exp2, select) has a short form without the clamp and
// the select, the same bits where every score lies below the clamp's band:
// a pass whose heads' row bound max|q_h| max|k_h| (attn_bwd_norm_kernel,
// Cauchy-Schwarz) is at most SAFE_SCORE runs it for every chunk with no
// test, so that the heads' steps interleave; any other pass runs it where
// a warp vote finds the warp's 16 x 16 below the band (below_band), else
// recomputes the scores near the clamp (clamp_band) and runs the full line.
// exp2 is ex2.approx.ftz alone (exp2f's value, but results under 2^-126
// flushed to 0): p enters the backward only through d_s and bf16(p), where
// a subnormal p moves no result at the checks' limits (the TPU flushes f32
// subnormals too), so the forward's range fix-up is not needed here.
// Three blocks an SM where D < 32 (at D = 32 the 80 registers spill).
constexpr int AB_MAX_WARPS = 8;

template <int D>
struct BwdPass {
    static_assert(D == 4 || D == 8 || D == 16 || D == 32, "head dim");
    static constexpr int PASS = D < 16 ? 16 : D;   // channels a pass
    static constexpr int HP = PASS / D;            // heads a pass
    static constexpr int KSN = PASS / 16;          // k16 steps of the pass
    static constexpr int NTP = PASS / 8;           // n-tiles of the pass's channels
    // a head's A fragment: one k8 step (D <= 8), else its k16 steps
    static constexpr int AW = D <= 8 ? 2 : 4 * (D / 16);
    static constexpr int LD = 2 * PASS + 8;        // bf16 a staged row: two tensors + padding
};

template <int D>
size_t attn_bwd_smem_bytes(int ak, bool kv) {
    using P = BwdPass<D>;
    return sizeof(bf16) * 2 * (size_t)ak * P::LD + (kv ? sizeof(float) * 2 * P::HP * ak : 0);
}

// 4 bytes from device memory to shared memory, asynchronously (zeros
// where not valid)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

// The A fragments of a warp's 16 tokens n0 .. n0 + 15 of a row of N tokens
// (token row0 on; tokens from N on as zeros), channels l0 .. l0 + PASS - 1
// of a token-major bf16 tensor of row stride `stride`, per head of the pass:
// am[hh] is head hh's k8 step (D <= 8; at D = 4 it spans two heads, and
// the other head's channels are zeroed) or its k16 steps.
template <int D>
__device__ __forceinline__ void head_frags(uint32_t (&am)[BwdPass<D>::HP][BwdPass<D>::AW],
                                           const bf16* t, int stride, size_t row0, int n0, int N,
                                           int l0) {
    using P = BwdPass<D>;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    uint32_t a[P::KSN][4];
#pragma unroll
    for (int kg = 0; kg < P::KSN; ++kg)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int n = n0 + g + 8 * (i & 1);
            const int c = 16 * kg + 2 * q + 8 * (i >> 1);    // channel of the pass
            a[kg][i] =
                n < N ? *reinterpret_cast<const uint32_t*>(t + (row0 + n) * stride + l0 + c) : 0u;
        }
#pragma unroll
    for (int hh = 0; hh < P::HP; ++hh) {
        if constexpr (D <= 8) {
            const int ks = hh * D / 8;                       // the head's k8 step
            const bool own = (8 * ks + 2 * q) / D == hh;
            am[hh][0] = own ? a[0][2 * ks] : 0u;
            am[hh][1] = own ? a[0][2 * ks + 1] : 0u;
        } else {
#pragma unroll
            for (int w = 0; w < P::AW; ++w) am[hh][w] = a[w / 4][w % 4];
        }
    }
}

// Scores within CLAMP_BAND of SCORE_CLAMP, where d_s jumps between 0 and
// d_p p ln 2, recomputed as one f32 FMA chain over the head's D channels
// in order from 0 (the sum that an f32 matrix product's inner loop, and
// the plain version on the card, forms; the tensor cores sum in another
// order and round otherwise, so a score within an ulp of the clamp could
// land on the other side); and NaN scores: at D = 4 a head's product
// takes the other head's channels of A zeroed times B, which a non-finite
// B there turns into NaN (0 x inf) where the head's own product is
// finite.  s: the warp's 16 x 16 scores (rows n0 + g, +
// 8 of its own side, columns 8 j + 2 q + (e & 1) of the chunk); own: the
// own side's token 0 of the row at the head's first channel (row stride
// lda); other: the chunk's first row of the staged tile at the head's first
// channel (row stride ldt).
constexpr float CLAMP_BAND = 1.0f / 64;

template <int D>
__device__ __forceinline__ void clamp_band(float (&s)[2][4], const bf16* own, int lda, int n0,
                                           int N, const bf16* other, int ldt) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int n = n0 + g + 8 * (e >> 1);
            if (!(fabsf(s[j][e] - SCORE_CLAMP) >= CLAMP_BAND) && n < N) {   // or NaN
                const bf16* a = own + (size_t)n * lda;
                const bf16* b = other + (8 * j + 2 * q + (e & 1)) * ldt;
                float x = 0.f;
                for (int d = 0; d < D; ++d) x = fmaf(ld(a + d), __bfloat162float(b[d]), x);
                s[j][e] = x;
            }
        }
}

// Whether every score of the warp's 16 x 16 lies below the clamp's band:
// then min(s, 110) = s and s < 110, and the line needs no clamp, no select
// and no recompute (bwd_line_low, the same bits; the common case).
__device__ __forceinline__ bool below_band(const float (&s)[2][4]) {
    bool low = true;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) low = low && s[j][e] < SCORE_CLAMP - CLAMP_BAND;
    return __all_sync(0xffffffffu, low);
}

// acc (16 x 16, two n-tiles of 8 columns) = seed + a b^T over head hh's
// channels: a its A fragment (head_frags), b the other side's n-major B
// fragments of the pass's k16 steps (b[kg]: n-tile 0's k 0-7, k 8-15, then
// n-tile 1's).  D <= 8: one m16n8k8 product a n-tile.
template <int D>
__device__ __forceinline__ void head_product(float (&acc)[2][4],
                                             const uint32_t (&a)[BwdPass<D>::AW],
                                             const uint32_t (&b)[BwdPass<D>::KSN][4],
                                             const float (&seed)[2][4], int hh) {
    if constexpr (D <= 8) {
        const int ks = hh * D / 8;
        mma_bf16_k8_to(acc[0], a[0], a[1], b[0][ks], seed[0]);
        mma_bf16_k8_to(acc[1], a[0], a[1], b[0][2 + ks], seed[1]);
    } else {
        const uint32_t a0[4] = {a[0], a[1], a[2], a[3]};
        mma_bf16_to(acc[0], a0, b[0][0], b[0][1], seed[0]);
        mma_bf16_to(acc[1], a0, b[0][2], b[0][3], seed[1]);
#pragma unroll
        for (int kg = 1; kg < D / 16; ++kg) {
            const uint32_t ak[4] = {a[4 * kg], a[4 * kg + 1], a[4 * kg + 2], a[4 * kg + 3]};
            mma_bf16(acc[0], ak, b[kg][0], b[kg][1]);
            mma_bf16(acc[1], ak, b[kg][2], b[kg][3]);
        }
    }
}

// acc[t] += a B[:, n-tile t] for the n-tiles of head hh's channels, B the
// other side's k-major fragments of the pass (b[u]: n-tiles 2u, 2u + 1).
// At D = 4 a n-tile holds heads 2m, 2m + 1: thread column g belongs to head
// 2m + g / 4, and the other head's columns of B are zeroed.  ``apart`` (a
// pass whose q or k holds a non-finite value, where a's p or d_s can be
// NaN): the product goes to a fresh accumulator and only the head's own
// columns take it, since a NaN in a times the other head's zeroed columns
// would make theirs NaN.
template <int D>
__device__ __forceinline__ void head_acc(float (&acc)[BwdPass<D>::NTP][4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[BwdPass<D>::NTP / 2][4], int hh,
                                         bool apart = false) {
    if constexpr (D == 4) {
        const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
        const int t = hh >> 1;
        const bool own = (g >> 2) == (hh & 1);
        const uint32_t b0 = own ? b[t >> 1][2 * (t & 1)] : 0u;
        const uint32_t b1 = own ? b[t >> 1][2 * (t & 1) + 1] : 0u;
        if (apart) {
            const float zero4[4] = {};
            float d[4];
            mma_bf16_to(d, a, b0, b1, zero4);
            if ((q >> 1) == (hh & 1)) {          // this thread's columns 2q, 2q + 1
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[t][e] += d[e];
            }
        } else {
            mma_bf16(acc[t], a, b0, b1);
        }
    } else {
#pragma unroll
        for (int u = 0; u < D / 8; ++u) {
            const int t = hh * (D / 8) + u;
            mma_bf16(acc[t], a, b[t >> 1][2 * (t & 1)], b[t >> 1][2 * (t & 1) + 1]);
        }
    }
}

// The line of 16 x 16 pairs, in registers: p = 2^min(s, 110) into s, and
// d_s = s < 110 ? d_p p ln 2 : 0 into ds (f32; its bf16 rounding is
// pack_a's).
__device__ __forceinline__ void bwd_line(float (&s)[2][4], const float (&dp)[2][4],
                                         float (&ds)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = ex2_ftz(clamp_score(s[j][e]));
            ds[j][e] = s[j][e] < SCORE_CLAMP ? dp[j][e] * p * LN2F : 0.f;
            s[j][e] = p;
        }
}

// The same as bwd_line where every score is below the band (below_band):
// no clamp and no select.
__device__ __forceinline__ void bwd_line_low(float (&s)[2][4], const float (&dp)[2][4],
                                             float (&ds)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = ex2_ftz(s[j][e]);
            ds[j][e] = dp[j][e] * p * LN2F;
            s[j][e] = p;
        }
}

// The bound that picks the short line for a whole pass: per row and head,
// max|q_h| max|k_h| over the row's N tokens into bound (R, H) f32 (by
// Cauchy-Schwarz no score of the head exceeds it; NaN where a q or k of
// the head is NaN, so that the pass takes the full line).  C, H: the padded
// layout (CA, HK).  One block per row; where H divides NORM_THREADS each
// thread keeps one head, else (H up to MAX_NORM_HEADS) the threads walk
// (token, head) pairs and the heads' maxima meet in shared memory
// (atomicMax on the bits of non-negative floats).  Named for the attention
// backward, whose time it is part of.
constexpr int NORM_THREADS = 256;
constexpr int MAX_NORM_HEADS = 512;
constexpr float SAFE_SCORE = 109.0f;   // below the band, with room for rounding

__global__ void __launch_bounds__(NORM_THREADS)
attn_bwd_norm_kernel(const bf16* __restrict__ qkv, float* __restrict__ bound, int N, int C,
                     int H) {
    __shared__ float red[2][MAX_NORM_HEADS];
    const int D = C / H;
    const size_t row0 = (size_t)blockIdx.x * N;
    auto norms = [&](int j, int h, float& q2, float& k2) {
        const bf16* p = qkv + (row0 + j) * 3 * C + h * D;
        q2 = 0.f;
        k2 = 0.f;
        for (int d = 0; d < D; ++d) {
            const float a = ld(p + d), b = ld(p + C + d);
            q2 += a * a;
            k2 += b * b;
        }
    };
    if (NORM_THREADS % H == 0) {
        const int h = threadIdx.x % H, step = NORM_THREADS / H;
        float mq = 0.f, mk = 0.f;
        for (int j = threadIdx.x / H; j < N; j += step) {
            float q2, k2;
            norms(j, h, q2, k2);
            mq = max_keep_nan(mq, q2);
            mk = max_keep_nan(mk, k2);
        }
        red[0][threadIdx.x] = mq;
        red[1][threadIdx.x] = mk;
        __syncthreads();
        if (threadIdx.x < H) {
            for (int t = threadIdx.x + H; t < NORM_THREADS; t += H) {
                mq = max_keep_nan(mq, red[0][t]);
                mk = max_keep_nan(mk, red[1][t]);
            }
            bound[(size_t)blockIdx.x * H + threadIdx.x] = sqrtf(mq) * sqrtf(mk);
        }
        return;
    }
    unsigned* bq = reinterpret_cast<unsigned*>(red[0]);
    unsigned* bk = reinterpret_cast<unsigned*>(red[1]);
    for (int h = threadIdx.x; h < H; h += NORM_THREADS) bq[h] = bk[h] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < N * H; i += NORM_THREADS) {
        float q2, k2;
        norms(i / H, i % H, q2, k2);
        atomicMax(bq + i % H, __float_as_uint(q2));
        atomicMax(bk + i % H, __float_as_uint(k2));
    }
    __syncthreads();
    for (int h = threadIdx.x; h < H; h += NORM_THREADS)
        bound[(size_t)blockIdx.x * H + h] =
            sqrtf(__uint_as_float(bq[h])) * sqrtf(__uint_as_float(bk[h]));
}

// Whether a head of the pass at channel l0 has a non-finite row bound: a q
// or k of it is inf or NaN (block-uniform; head_acc's ``apart``).
template <int D>
__device__ __forceinline__ bool pass_nonfinite(const float* bound, size_t r, int H, int l0) {
    bool bad = false;
#pragma unroll
    for (int hh = 0; hh < BwdPass<D>::HP; ++hh)
        bad = bad || !(fabsf(bound[r * H + l0 / D + hh]) <= 3.402823466e38f);
    return bad;
}

// Whether every head of the pass at channel l0 has its row bound at most
// SAFE_SCORE (block-uniform).
template <int D>
__device__ __forceinline__ bool pass_below_band(const float* bound, size_t r, int H, int l0) {
    bool safe = true;
#pragma unroll
    for (int hh = 0; hh < BwdPass<D>::HP; ++hh)
        safe = safe && bound[r * H + l0 / D + hh] <= SAFE_SCORE;
    return safe;
}

// The warp's accumulators (16 rows x the pass's channels at padded channel
// l0 on) rounded to bf16 into out (row stride `stride`), rows below N, each
// padded channel c = h DP + d (D = DP: the padded layout's head dim) at
// column col0 + h Dt + d of the block's layout if h < Ht and d < Dt.
template <int NTP>
__device__ __forceinline__ void store_rows(bf16* out, int stride, const float (&acc)[NTP][4],
                                           size_t row0, int n0, int N, int col0, int l0, int DP,
                                           int Ht, int Dt) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const bool even = (Dt & 1) == 0;
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
        const int c = l0 + 8 * t + 2 * q, h = c / DP, d = c % DP;
        if (h >= Ht) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int n = n0 + g + 8 * hr;
            if (n < N)
                store_head_pair(out + (row0 + n) * stride + col0 + h * Dt + d, acc[t][2 * hr],
                                acc[t][2 * hr + 1], Dt - d, even);
        }
    }
}

// 3. d_q (query-major).
template <int D, bool EXACT>
__global__ void __launch_bounds__(32 * AB_MAX_WARPS, D < 32 ? 3 : 2)
attn_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ d_oe,
                  const float* __restrict__ d_den, const float* __restrict__ bound,
                  bf16* __restrict__ dqkv, int N, int C, int H, int ct, int ht, int dt, int nb,
                  int ak) {
    // C, H, D: the padded layout of qkv and d_oe (CA, HK, DP); Ct, Ht, Dt
    // the block's, of d_den and dqkv (EXACT: the same, D at compile time)
    const int Ct = EXACT ? C : ct, Ht = EXACT ? H : ht, Dt = EXACT ? D : dt;
    using P = BwdPass<D>;
    constexpr int CH = P::PASS / 8;                  // 16-byte chunks a tensor a row
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* kv = reinterpret_cast<bf16*>(smem_raw);   // 2 x ak x LD: k | v
    const int nw = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const size_t r = blockIdx.x / nb;
    const size_t row0 = r * N;
    const int qrow = (blockIdx.x % nb) * 16 * nw + warp * 16;   // the warp's first query
    const bool active = qrow < N;
    const int ldq = 3 * C;
    const int nkt = (N + ak - 1) / ak;
    const float zs[2][4] = {};       // the scores' seed
    for (int l0 = 0; l0 < C; l0 += P::PASS) {
        uint32_t qm[P::HP][P::AW], em[P::HP][P::AW];
        head_frags<D>(qm, qkv, ldq, row0, qrow, N, l0);
        head_frags<D>(em, d_oe, C, row0, qrow, N, l0);
        float dd[P::HP][2][4];       // d_p's seed: d_den of rows g, g + 8
#pragma unroll
        for (int hh = 0; hh < P::HP; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = qrow + g + 8 * (e >> 1), h = l0 / D + hh;
                dd[hh][0][e] = dd[hh][1][e] = n < N && h < Ht ? d_den[(row0 + n) * Ht + h] : 0.f;
            }
        float dq[P::NTP][4];
        zero(dq);
        const bool low = pass_below_band<D>(bound, r, H, l0);
        const bool apart = D == 4 && pass_nonfinite<D>(bound, r, H, l0);
        // a key tile: the pass's channels of k, then of v
        auto load = [&](int kt) {
            const int k0 = kt * ak;
            bf16* dst = kv + (kt & 1) * ak * P::LD;
            for (int i = threadIdx.x; i < ak * 2 * CH; i += blockDim.x) {
                const int j = i / (2 * CH), c = i % (2 * CH);
                const bool key_in = k0 + j < N;
                const size_t tok = row0 + (key_in ? k0 + j : 0);
                cp_async16(dst + j * P::LD + 8 * c,
                           qkv + tok * ldq + (c < CH ? C : 2 * C) + l0 + 8 * (c % CH), key_in);
            }
        };
        load(0);
        cp_async_commit();
        for (int kt = 0; kt < nkt; ++kt) {
            const int k0 = kt * ak;
            if (kt + 1 < nkt) load(kt + 1);
            cp_async_commit();
            cp_async_wait<1>();
            __syncthreads();
            const bf16* tile = kv + (kt & 1) * ak * P::LD;
            for (int kc = 0; active && kc < ak && k0 + kc < N; kc += 16) {
                uint32_t kf[P::KSN][4], vf[P::KSN][4], kb[P::NTP / 2][4];
#pragma unroll
                for (int kg = 0; kg < P::KSN; ++kg) {
                    ldsm_b_nmajor(kf[kg], tile, P::LD, 16 * kg, kc);
                    ldsm_b_nmajor(vf[kg], tile + P::PASS, P::LD, 16 * kg, kc);
                }
#pragma unroll
                for (int u = 0; u < P::NTP / 2; ++u) ldsm_b_kmajor(kb[u], tile, P::LD, kc, 16 * u);
                // one head: the short line where the pass is below the band
                // (no vote, so the heads' steps interleave), else a vote
                auto head = [&](int hh, bool pass_low) {
                    float s[2][4], dp[2][4], ds[2][4];
                    head_product<D>(s, qm[hh], kf, zs, hh);
                    head_product<D>(dp, em[hh], vf, dd[hh], hh);
                    if (pass_low || below_band(s)) {
                        bwd_line_low(s, dp, ds);
                    } else {
                        clamp_band<D>(s, qkv + row0 * ldq + l0 + hh * D, ldq, qrow, N,
                                      tile + kc * P::LD + hh * D, P::LD);
                        bwd_line(s, dp, ds);
                    }
                    uint32_t a[4];
                    pack_a(a, ds[0], ds[1]);
                    head_acc<D>(dq, a, kb, hh, !pass_low && apart);
                };
                if (low) {
#pragma unroll
                    for (int hh = 0; hh < P::HP; ++hh) head(hh, true);
                } else {
#pragma unroll
                    for (int hh = 0; hh < P::HP; ++hh) head(hh, false);
                }
            }
            __syncthreads();      // the buffers are free before they are refilled
        }
        store_rows<P::NTP>(dqkv, 3 * Ct, dq, row0, qrow, N, 0, l0, D, Ht, Dt);
    }
}

// 4. d_k, d_v (key-major).
template <int D, bool EXACT>
__global__ void __launch_bounds__(32 * AB_MAX_WARPS, D < 32 ? 3 : 2)
attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ d_oe,
                   const float* __restrict__ d_den, const float* __restrict__ bound,
                   bf16* __restrict__ dqkv, int N, int C, int H, int ct, int ht, int dt, int nb,
                   int ak) {
    const int Ct = EXACT ? C : ct, Ht = EXACT ? H : ht, Dt = EXACT ? D : dt;
    using P = BwdPass<D>;
    constexpr int CH = P::PASS / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qe = reinterpret_cast<bf16*>(smem_raw);                   // 2 x ak x LD: q | d_oe
    float* sden = reinterpret_cast<float*>(qe + 2 * ak * P::LD);    // 2 x HP x ak: d_den
    const int nw = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q = lane & 3;
    const size_t r = blockIdx.x / nb;
    const size_t row0 = r * N;
    const int krow = (blockIdx.x % nb) * 16 * nw + warp * 16;   // the warp's first key
    const bool active = krow < N;
    const int ldq = 3 * C;
    const int nqt = (N + ak - 1) / ak;
    const float zs[2][4] = {};       // the scores' seed
    for (int l0 = 0; l0 < C; l0 += P::PASS) {
        uint32_t km[P::HP][P::AW], vm[P::HP][P::AW];
        head_frags<D>(km, qkv + C, ldq, row0, krow, N, l0);
        head_frags<D>(vm, qkv + 2 * C, ldq, row0, krow, N, l0);
        float dk[P::NTP][4], dv[P::NTP][4];
        zero(dk);
        zero(dv);
        const bool low = pass_below_band<D>(bound, r, H, l0);
        const bool apart = D == 4 && pass_nonfinite<D>(bound, r, H, l0);
        // a query tile: the pass's channels of q, then of d_oe; the pass's
        // heads' d_den, head-major
        auto load = [&](int qt) {
            const int t0 = qt * ak;
            bf16* dst = qe + (qt & 1) * ak * P::LD;
            for (int i = threadIdx.x; i < ak * 2 * CH; i += blockDim.x) {
                const int j = i / (2 * CH), c = i % (2 * CH);
                const bool q_in = t0 + j < N;
                const size_t tok = row0 + (q_in ? t0 + j : 0);
                cp_async16(dst + j * P::LD + 8 * c,
                           c < CH ? qkv + tok * ldq + l0 + 8 * c
                                  : d_oe + tok * C + l0 + 8 * (c - CH),
                           q_in);
            }
            float* dds = sden + (qt & 1) * P::HP * ak;
            for (int i = threadIdx.x; i < ak * P::HP; i += blockDim.x) {
                const int j = i / P::HP, hh = i % P::HP, h = l0 / D + hh;
                const bool q_in = t0 + j < N && h < Ht;
                const size_t tok = row0 + (q_in ? t0 + j : 0);
                cp_async4(dds + hh * ak + j, d_den + tok * Ht + (q_in ? h : 0), q_in);
            }
        };
        load(0);
        cp_async_commit();
        for (int qt = 0; qt < nqt; ++qt) {
            const int t0 = qt * ak;
            if (qt + 1 < nqt) load(qt + 1);
            cp_async_commit();
            cp_async_wait<1>();
            __syncthreads();
            const bf16* tile = qe + (qt & 1) * ak * P::LD;
            const float* dds = sden + (qt & 1) * P::HP * ak;
            for (int qc = 0; active && qc < ak && t0 + qc < N; qc += 16) {
                uint32_t qf[P::KSN][4], ef[P::KSN][4], qb[P::NTP / 2][4], eb[P::NTP / 2][4];
#pragma unroll
                for (int kg = 0; kg < P::KSN; ++kg) {
                    ldsm_b_nmajor(qf[kg], tile, P::LD, 16 * kg, qc);
                    ldsm_b_nmajor(ef[kg], tile + P::PASS, P::LD, 16 * kg, qc);
                }
#pragma unroll
                for (int u = 0; u < P::NTP / 2; ++u) {
                    ldsm_b_kmajor(qb[u], tile, P::LD, qc, 16 * u);
                    ldsm_b_kmajor(eb[u], tile + P::PASS, P::LD, qc, 16 * u);
                }
                // one head, as in attn_bwd_q_kernel
                auto head = [&](int hh, bool pass_low) {
                    float s[2][4], dp[2][4], ds[2][4], seed[2][4];
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        // d_den of this thread's query columns 2q, 2q + 1
                        const float2 d2 =
                            *reinterpret_cast<const float2*>(dds + hh * ak + qc + 8 * j + 2 * q);
                        seed[j][0] = seed[j][2] = d2.x;
                        seed[j][1] = seed[j][3] = d2.y;
                    }
                    head_product<D>(s, km[hh], qf, zs, hh);
                    head_product<D>(dp, vm[hh], ef, seed, hh);
                    if (pass_low || below_band(s)) {
                        bwd_line_low(s, dp, ds);
                    } else {
                        clamp_band<D>(s, qkv + row0 * ldq + C + l0 + hh * D, ldq, krow, N,
                                      tile + qc * P::LD + hh * D, P::LD);
                        bwd_line(s, dp, ds);
                    }
                    uint32_t a[4], pa[4];
                    pack_a(a, ds[0], ds[1]);
                    pack_a(pa, s[0], s[1]);
                    head_acc<D>(dk, a, qb, hh, !pass_low && apart);
                    head_acc<D>(dv, pa, eb, hh, !pass_low && apart);
                };
                if (low) {
#pragma unroll
                    for (int hh = 0; hh < P::HP; ++hh) head(hh, true);
                } else {
#pragma unroll
                    for (int hh = 0; hh < P::HP; ++hh) head(hh, false);
                }
            }
            __syncthreads();      // the buffers are free before they are refilled
        }
        store_rows<P::NTP>(dqkv, 3 * Ct, dk, row0, krow, N, Ct, l0, D, Ht, Dt);
        store_rows<P::NTP>(dqkv, 3 * Ct, dv, row0, krow, N, 2 * Ct, l0, D, Ht, Dt);
    }
}

// 3'-4'. The attention backward of a head wider than a pass (DP = 64 ..
// 512, one head a pass): attn_bwd_q_kernel's and attn_bwd_kv_kernel's
// function, line and clamp agreement at a head width whose fragments no
// longer fit registers.  One block per (row, 64 rows of its side), 4
// warps; per head the block stages its own rows' DP channels of two
// tensors (q and d_oe; k and v) in shared memory once, and a score's or
// d_p's A fragments come from there by ldmatrix, DP / 16 k16 steps in
// order from channel 0, the first seeded (0 for s, d_den for d_p): the
// same steps at the same k positions in both kernels, so that they agree
// on the clamp, as the narrow kernels do.  The other side streams through
// shared memory AK tokens at a time (two tensors' DP channels; the kv
// kernel also their d_den).  The output goes in parts of OW channels (the
// q kernel min(DP, 128), the kv kernel's two outputs min(DP, 64)), each
// part streaming the other side again and recomputing s, d_p and the line
// (the same bits each time).
template <int DP>
struct WideBwd {
    static constexpr int LD = DP + 8;                // bf16 a staged row of one tensor
    static constexpr int AK = DP >= 512 ? 16 : DP >= 256 ? 32 : 64;   // other-side tokens a tile
    static constexpr int OWQ = DP < 128 ? DP : 128;  // d_q channels a part
    static constexpr int OWKV = DP < 64 ? DP : 64;   // d_k, d_v channels a part
    static constexpr int WARPS = 4;
};

template <int DP>
size_t attn_bwd_wide_smem_bytes(bool kv) {
    using W = WideBwd<DP>;
    return sizeof(bf16) * (2 * 16 * W::WARPS * (size_t)W::LD + 2 * 2 * W::AK * (size_t)W::LD)
           + (kv ? sizeof(float) * 2 * W::AK : 0);
}

// The block's own rows r0 .. r0 + 63 of a head's DP channels of two
// tensors (a at column ca, b at column cb of row strides lda, ldb) into
// shared memory, rows past N as zeros (cp.async, waited for).
template <int DP>
__device__ __forceinline__ void stage_own(bf16* dst, const bf16* a, int lda, const bf16* b,
                                          int ldb, size_t row0, int r0, int N) {
    using W = WideBwd<DP>;
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < 2 * 16 * W::WARPS * CH; i += blockDim.x) {
        const int t = i / CH / (16 * W::WARPS), rr = (i / CH) % (16 * W::WARPS), c = i % CH;
        const bool valid = r0 + rr < N;
        const size_t tok = row0 + (valid ? r0 + rr : 0);
        cp_async16(dst + (t * 16 * W::WARPS + rr) * W::LD + 8 * c,
                   (t ? b + tok * ldb : a + tok * lda) + 8 * c, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
}

// acc (16 x 16) = seed + a b^T over the head's DP channels: a the warp's
// own rows (row-major, ld LD), b the other side's 16 rows from kc of a tile
// (n-major, ld LD), k16 steps in order, the first from the seed.
template <int DP>
__device__ __forceinline__ void wide_product(float (&acc)[2][4], const bf16* a, const bf16* b,
                                             int kc, const float (&seed)[2][4]) {
    constexpr int LD = WideBwd<DP>::LD;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
        uint32_t af[4], bfr[4];
        ldsm_a(af, a, LD, 16 * ks);
        ldsm_b_nmajor(bfr, b, LD, 16 * ks, kc);
        if (ks == 0) {
            mma_bf16_to(acc[0], af, bfr[0], bfr[1], seed[0]);
            mma_bf16_to(acc[1], af, bfr[2], bfr[3], seed[1]);
        } else {
            mma_bf16(acc[0], af, bfr[0], bfr[1]);
            mma_bf16(acc[1], af, bfr[2], bfr[3]);
        }
    }
}

// d_q of a head wider than a pass.
template <int DP>
__global__ void __launch_bounds__(32 * WideBwd<DP>::WARPS, 1)
attn_bwd_q_wide_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ d_oe,
                       const float* __restrict__ d_den, const float* __restrict__ bound,
                       bf16* __restrict__ dqkv, int N, int C, int H, int Ct, int Ht, int Dt,
                       int nb) {
    using W = WideBwd<DP>;
    constexpr int AK = W::AK, LD = W::LD, OW = W::OWQ, OT = OW / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* own = reinterpret_cast<bf16*>(smem_raw);            // 2 x 64 x LD: q, d_oe
    bf16* kv = own + 2 * 16 * W::WARPS * LD;                  // 2 x AK x 2 LD: k | v
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const size_t r = blockIdx.x / nb;
    const size_t row0 = r * N;
    const int r0 = (blockIdx.x % nb) * 16 * W::WARPS;
    const int qrow = r0 + warp * 16;
    const bool active = qrow < N;
    const int ldq = 3 * C;
    const int nkt = (N + AK - 1) / AK;
    const float zs[2][4] = {};
    const bf16* qw = own + warp * 16 * LD;
    const bf16* ew = own + (16 * W::WARPS + warp * 16) * LD;
    for (int h = 0; h < Ht; ++h) {
        __syncthreads();          // the previous head is done with the own rows
        stage_own<DP>(own, qkv + h * DP, ldq, d_oe + h * DP, C, row0, r0, N);
        float dd[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int n = qrow + g + 8 * (e >> 1);
            dd[0][e] = dd[1][e] = n < N ? d_den[(row0 + n) * Ht + h] : 0.f;
        }
        const bool low = bound[r * H + h] <= SAFE_SCORE;
        for (int v0 = 0; v0 < DP; v0 += OW) {
            float dq[OT][4];
            zero(dq);
            auto load = [&](int kt) {
                const int k0 = kt * AK;
                bf16* dst = kv + (kt & 1) * AK * 2 * LD;
                constexpr int CH = DP / 8;
                for (int i = threadIdx.x; i < AK * 2 * CH; i += blockDim.x) {
                    const int j = i / (2 * CH), c = i % (2 * CH);
                    const bool in_row = k0 + j < N;
                    const size_t tok = row0 + (in_row ? k0 + j : 0);
                    cp_async16(dst + (c < CH ? 0 : AK * LD) + j * LD + 8 * (c % CH),
                               qkv + tok * ldq + (c < CH ? C : 2 * C) + h * DP + 8 * (c % CH),
                               in_row);
                }
            };
            load(0);
            cp_async_commit();
            for (int kt = 0; kt < nkt; ++kt) {
                const int k0 = kt * AK;
                if (kt + 1 < nkt) load(kt + 1);
                cp_async_commit();
                cp_async_wait<1>();
                __syncthreads();
                const bf16* kt_ = kv + (kt & 1) * AK * 2 * LD;
                const bf16* vt_ = kt_ + AK * LD;
                for (int kc = 0; active && kc < AK && k0 + kc < N; kc += 16) {
                    float sc[2][4], dp[2][4], ds[2][4];
                    wide_product<DP>(sc, qw, kt_, kc, zs);
                    wide_product<DP>(dp, ew, vt_, kc, dd);
                    if (low || below_band(sc)) {
                        bwd_line_low(sc, dp, ds);
                    } else {
                        clamp_band<DP>(sc, qkv + row0 * ldq + h * DP, ldq, qrow, N,
                                       kt_ + kc * LD, LD);
                        bwd_line(sc, dp, ds);
                    }
                    uint32_t a[4];
                    pack_a(a, ds[0], ds[1]);
#pragma unroll
                    for (int u = 0; u < OT / 2; ++u) {
                        uint32_t b[4];
                        ldsm_b_kmajor(b, kt_, LD, kc, v0 + 16 * u);
                        mma_bf16(dq[2 * u], a, b[0], b[1]);
                        mma_bf16(dq[2 * u + 1], a, b[2], b[3]);
                    }
                }
                __syncthreads();  // the buffers are free before they are refilled
            }
            store_rows<OT>(dqkv, 3 * Ct, dq, row0, qrow, N, 0, h * DP + v0, DP, Ht, Dt);
        }
    }
}

// d_k, d_v of a head wider than a pass.
template <int DP>
__global__ void __launch_bounds__(32 * WideBwd<DP>::WARPS, 1)
attn_bwd_kv_wide_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ d_oe,
                        const float* __restrict__ d_den, const float* __restrict__ bound,
                        bf16* __restrict__ dqkv, int N, int C, int H, int Ct, int Ht, int Dt,
                        int nb) {
    using W = WideBwd<DP>;
    constexpr int AK = W::AK, LD = W::LD, OW = W::OWKV, OT = OW / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* own = reinterpret_cast<bf16*>(smem_raw);            // 2 x 64 x LD: k, v
    bf16* qe = own + 2 * 16 * W::WARPS * LD;                  // 2 x AK x 2 LD: q | d_oe
    float* sden = reinterpret_cast<float*>(qe + 2 * AK * 2 * LD);   // 2 x AK: d_den
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q = lane & 3;
    const size_t r = blockIdx.x / nb;
    const size_t row0 = r * N;
    const int r0 = (blockIdx.x % nb) * 16 * W::WARPS;
    const int krow = r0 + warp * 16;
    const bool active = krow < N;
    const int ldq = 3 * C;
    const int nqt = (N + AK - 1) / AK;
    const float zs[2][4] = {};
    const bf16* kw = own + warp * 16 * LD;
    const bf16* vw = own + (16 * W::WARPS + warp * 16) * LD;
    for (int h = 0; h < Ht; ++h) {
        __syncthreads();
        stage_own<DP>(own, qkv + C + h * DP, ldq, qkv + 2 * C + h * DP, ldq, row0, r0, N);
        const bool low = bound[r * H + h] <= SAFE_SCORE;
        for (int v0 = 0; v0 < DP; v0 += OW) {
            float dk[OT][4], dv[OT][4];
            zero(dk);
            zero(dv);
            auto load = [&](int qt) {
                const int t0 = qt * AK;
                bf16* dst = qe + (qt & 1) * AK * 2 * LD;
                constexpr int CH = DP / 8;
                for (int i = threadIdx.x; i < AK * 2 * CH; i += blockDim.x) {
                    const int j = i / (2 * CH), c = i % (2 * CH);
                    const bool q_in = t0 + j < N;
                    const size_t tok = row0 + (q_in ? t0 + j : 0);
                    cp_async16(dst + (c < CH ? 0 : AK * LD) + j * LD + 8 * (c % CH),
                               c < CH ? qkv + tok * ldq + h * DP + 8 * c
                                      : d_oe + tok * C + h * DP + 8 * (c - CH),
                               q_in);
                }
                for (int j = threadIdx.x; j < AK; j += blockDim.x) {
                    const bool q_in = t0 + j < N;
                    const size_t tok = row0 + (q_in ? t0 + j : 0);
                    cp_async4(sden + (qt & 1) * AK + j, d_den + tok * Ht + h, q_in);
                }
            };
            load(0);
            cp_async_commit();
            for (int qt = 0; qt < nqt; ++qt) {
                const int t0 = qt * AK;
                if (qt + 1 < nqt) load(qt + 1);
                cp_async_commit();
                cp_async_wait<1>();
                __syncthreads();
                const bf16* qt_ = qe + (qt & 1) * AK * 2 * LD;
                const bf16* et_ = qt_ + AK * LD;
                const float* dds = sden + (qt & 1) * AK;
                for (int qc = 0; active && qc < AK && t0 + qc < N; qc += 16) {
                    float sc[2][4], dp[2][4], ds[2][4], seed[2][4];
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const float2 d2 =
                            *reinterpret_cast<const float2*>(dds + qc + 8 * j + 2 * q);
                        seed[j][0] = seed[j][2] = d2.x;
                        seed[j][1] = seed[j][3] = d2.y;
                    }
                    wide_product<DP>(sc, kw, qt_, qc, zs);
                    wide_product<DP>(dp, vw, et_, qc, seed);
                    if (low || below_band(sc)) {
                        bwd_line_low(sc, dp, ds);
                    } else {
                        clamp_band<DP>(sc, qkv + row0 * ldq + C + h * DP, ldq, krow, N,
                                       qt_ + qc * LD, LD);
                        bwd_line(sc, dp, ds);
                    }
                    uint32_t a[4], pa[4];
                    pack_a(a, ds[0], ds[1]);
                    pack_a(pa, sc[0], sc[1]);
#pragma unroll
                    for (int u = 0; u < OT / 2; ++u) {
                        uint32_t b[4];
                        ldsm_b_kmajor(b, qt_, LD, qc, v0 + 16 * u);
                        mma_bf16(dk[2 * u], a, b[0], b[1]);
                        mma_bf16(dk[2 * u + 1], a, b[2], b[3]);
                        ldsm_b_kmajor(b, et_, LD, qc, v0 + 16 * u);
                        mma_bf16(dv[2 * u], pa, b[0], b[1]);
                        mma_bf16(dv[2 * u + 1], pa, b[2], b[3]);
                    }
                }
                __syncthreads();
            }
            store_rows<OT>(dqkv, 3 * Ct, dk, row0, krow, N, Ct, h * DP + v0, DP, Ht, Dt);
            store_rows<OT>(dqkv, 3 * Ct, dv, row0, krow, N, 2 * Ct, h * DP + v0, DP, Ht, Dt);
        }
    }
}

// 5. d_normed = dqkv Wqkv^T, the LN1 backward and dx = d_mid + LN1'(...),
// on the tensor cores (the mirror of mlp_bwd_kernel).  TOK =
// tile_tok<CP>() tokens a tile, 8 warps: warp w owns tokens 16 (w % RG) ..
// + 15 and part w / RG of the CS parts of the columns.  Per tile: the bf16
// dqkv (the A tile, TOK x 3C, zero up to K3 = 3C rounded up to 32) and x
// to shared memory (cp.async); LN1 statistics of x over its C channels in
// f32 (a warp per TOK / 8 tokens); d_normed on mma into registers, Wqkv^T
// (3C x C) streamed in k-slices (block_gemm, read as zeros past 3C and past
// C); the LN backward in registers (each token's means over C from the
// column parts through shared memory), d_mid read from device memory, dx
// rounded to bf16.  The partials [dln1s C | dln1b C] are summed per block
// over its tiles (a fixed shuffle tree over each warp's 16 tokens, then
// the RG token parts in order) and written once.
constexpr int LB_TOK = 64;
constexpr int LB_THREADS = 256;

template <int CP>
constexpr size_t ln1_bwd_smem_bytes() {
    constexpr size_t T = tile_tok<CP>(), RG = T / 16, CS = 8 / RG;
    return sizeof(bf16) * (T * (3 * CP + 8) + T * (CP + 8) + 2 * KS * (CP + 8))
           + sizeof(float) * ((size_t)2 * CP + 2 * RG * CP + 2 * T + 2 * CS * T);
}

template <int CP, bool EXACT>
__global__ void __launch_bounds__(LB_THREADS, CP <= 128 ? 2 : 1)
ln1_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dqkv,
               const float* __restrict__ d_mid, const bf16* __restrict__ ln1_s,
               const bf16* __restrict__ wqkvt, bf16* __restrict__ dx,
               float* __restrict__ part, int M, int c) {
    const int C = EXACT ? CP : c;     // EXACT: C = CP, known at compile time
    constexpr int TOK = tile_tok<CP>(), RG = TOK / 16, CS = 8 / RG;
    constexpr int LDA = 3 * CP + 8, LDX = CP + 8;
    constexpr int ONT = CP / (8 * CS);     // n-tiles a warp (its part of the columns)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sa = reinterpret_cast<bf16*>(smem_raw);                 // TOK x LDA: dqkv
    bf16* sx = sa + TOK * LDA;                                    // TOK x LDX: x
    bf16* wbuf = sx + TOK * LDX;                                  // block_gemm's buffers
    float* p_l1s = reinterpret_cast<float*>(wbuf + 2 * KS * (CP + 8));   // the block's partials
    float* p_l1b = p_l1s + C;
    float* red = p_l1s + 2 * CP;                                  // 2 vectors x RG parts x CP
    float* s_mean = red + 2 * RG * CP;                            // TOK
    float* s_rstd = s_mean + TOK;                                 // TOK
    float* s_rows = s_rstd + TOK;              // TOK x [CS parts x (sum dn, dn nh)]
    const int C3 = 3 * C, K3 = (C3 + KS - 1) / KS * KS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, q = lane & 3;
    const int rg = warp % RG, cpart = warp / RG;
    const int mrow = 16 * rg;
    const int ccol0 = cpart * CP / CS;
    for (int i = threadIdx.x; i < 2 * C; i += LB_THREADS) p_l1s[i] = 0.f;

    const int ntiles = (M + TOK - 1) / TOK;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int tok0 = tile * TOK;
        const int ntok = min(TOK, M - tok0);
        const size_t base = (size_t)tok0 * C;
        stage_rows<LB_THREADS>(sa, LDA, dqkv, C3, tok0, TOK, ntok, C3);
        stage_rows<LB_THREADS>(sx, LDX, x, C, tok0, TOK, ntok, C);
        cp_async_commit();
        if (C3 < K3) {
            for (int i = threadIdx.x; i < TOK * (K3 - C3); i += LB_THREADS)
                sa[(i / (K3 - C3)) * LDA + C3 + i % (K3 - C3)] = __float2bfloat16(0.f);
        }
        cp_async_wait<0>();
        __syncthreads();
        // LN1 statistics of x, a warp per TOK / 8 tokens (padded tokens: zeros)
        for (int t = warp * (TOK / 8); t < (warp + 1) * (TOK / 8); ++t) {
            float v[CP / 32];
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < CP / 32; ++i) {
                v[i] = lane + 32 * i < C ? __bfloat162float(sx[t * LDX + lane + 32 * i]) : 0.f;
                sum += v[i];
            }
            const float mean = warp_sum(sum) / C;
            float var = 0.f;
#pragma unroll
            for (int i = 0; i < CP / 32; ++i)
                if (lane + 32 * i < C) var += (v[i] - mean) * (v[i] - mean);
            const float rstd = rsqrtf(warp_sum(var) / C + 1e-5f);
            if (lane == 0) {
                s_mean[t] = mean;
                s_rstd[t] = rstd;
            }
        }
        // d_normed = dqkv Wqkv^T (block_gemm's first barrier orders the
        // statistics)
        float dn[ONT][4];
        zero(dn);
        block_gemm<ONT, CP, LB_THREADS>(dn, sa + mrow * LDA, LDA, wqkvt, C, 0, K3, wbuf, ccol0,
                                        C3, C);
        // LN1 backward: dx = d_mid + rstd (dn - m1 - nhat m2), dn = d_normed ln1_s
        float ra[2] = {}, rb[2] = {};
        float c_s[ONT][2] = {}, c_b[ONT][2] = {};
#pragma unroll
        for (int j = 0; j < ONT; ++j) {
            const int col = ccol0 + 8 * j + 2 * q;
            if (col >= C) continue;
            const float ls0 = ld(ln1_s + col), ls1 = ld(ln1_s + col + 1);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int t = mrow + gq + 8 * hr;
                const float mean = s_mean[t], rstd = s_rstd[t];
                const float nh0 = (__bfloat162float(sx[t * LDX + col]) - mean) * rstd;
                const float nh1 = (__bfloat162float(sx[t * LDX + col + 1]) - mean) * rstd;
                const float dn0 = dn[j][2 * hr] * ls0, dn1 = dn[j][2 * hr + 1] * ls1;
                ra[hr] += dn0 + dn1;
                rb[hr] += dn0 * nh0 + dn1 * nh1;
                if (t < ntok) {
                    c_s[j][0] += dn[j][2 * hr] * nh0;
                    c_s[j][1] += dn[j][2 * hr + 1] * nh1;
                    c_b[j][0] += dn[j][2 * hr];
                    c_b[j][1] += dn[j][2 * hr + 1];
                }
            }
        }
        warp_colsum(c_s, red + (0 * RG + rg) * CP + ccol0);
        warp_colsum(c_b, red + (1 * RG + rg) * CP + ccol0);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
                ra[hr] += __shfl_xor_sync(0xffffffffu, ra[hr], o);
                rb[hr] += __shfl_xor_sync(0xffffffffu, rb[hr], o);
            }
            if (q == 0) {
                const int t = mrow + gq + 8 * hr;
                s_rows[t * 2 * CS + 2 * cpart] = ra[hr];
                s_rows[t * 2 * CS + 2 * cpart + 1] = rb[hr];
            }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < ONT; ++j) {
            const int col = ccol0 + 8 * j + 2 * q;
            if (col >= C) continue;
            const float ls0 = ld(ln1_s + col), ls1 = ld(ln1_s + col + 1);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int t = mrow + gq + 8 * hr;
                if (t >= ntok) continue;
                const float mean = s_mean[t], rstd = s_rstd[t];
                float sa_ = s_rows[t * 2 * CS], sb_ = s_rows[t * 2 * CS + 1];
#pragma unroll
                for (int k = 1; k < CS; ++k) {
                    sa_ += s_rows[t * 2 * CS + 2 * k];
                    sb_ += s_rows[t * 2 * CS + 2 * k + 1];
                }
                const float m1 = sa_ / C, m2 = sb_ / C;
                const float nh0 = (__bfloat162float(sx[t * LDX + col]) - mean) * rstd;
                const float nh1 = (__bfloat162float(sx[t * LDX + col + 1]) - mean) * rstd;
                const float2 dm = *reinterpret_cast<const float2*>(d_mid + base + t * C + col);
                *reinterpret_cast<__nv_bfloat162*>(dx + base + t * C + col) =
                    __floats2bfloat162_rn(
                        dm.x + rstd * (dn[j][2 * hr] * ls0 - m1 - nh0 * m2),
                        dm.y + rstd * (dn[j][2 * hr + 1] * ls1 - m1 - nh1 * m2));
            }
        }
        add_parts<LB_THREADS, RG>(p_l1s, red, CP, C);
        add_parts<LB_THREADS, RG>(p_l1b, red + RG * CP, CP, C);
        __syncthreads();          // sx, red and s_rows are read before the next tile's
    }
    for (int i = threadIdx.x; i < 2 * C; i += LB_THREADS)
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

// The attention backward's grid: one block per (row, block of 16 x warps
// rows), 8 warps and 128-token tiles where N > 64, else 4 warps and 64.
struct BwdGrid {
    int threads, nb, tile;
    size_t blocks;
};

BwdGrid attn_bwd_grid(int R, int N) {
    const int warps = N > 64 ? AB_MAX_WARPS : 4;
    const int nb = (N + 16 * warps - 1) / (16 * warps);
    return {32 * warps, nb, N > 64 ? 128 : 64, (size_t)R * nb};
}

// The attention backward at padded head dim DP (p: the widths, head_plan
// of the block's C, H): attn_bwd_norm_kernel, then d_q and d_k, d_v.
// bound: R * HK floats of scratch.
template <int DP>
cudaError_t launch_attn_bwd(const bf16* qkv, const bf16* d_oe, const float* d_den, float* bound,
                            bf16* dqkv, int R, int N, int C, int H, const HeadPlan& p,
                            cudaStream_t stream) {
    const BwdGrid g = attn_bwd_grid(R, N);
    if (g.blocks > 0x7fffffffULL || p.HK > MAX_NORM_HEADS) return cudaErrorInvalidConfiguration;
    attn_bwd_norm_kernel<<<(unsigned)R, NORM_THREADS, 0, stream>>>(qkv, bound, N, p.CA, p.HK);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if constexpr (DP <= 32) {
        if (p.CA % BwdPass<DP>::PASS) return cudaErrorInvalidConfiguration;
        auto go = [&](auto kernel, size_t smem) {
            cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return e;
            kernel<<<(unsigned)g.blocks, g.threads, smem, stream>>>(
                qkv, d_oe, d_den, bound, dqkv, N, p.CA, p.HK, C, H, p.D, g.nb, g.tile);
            return cudaGetLastError();
        };
        const size_t q_smem = attn_bwd_smem_bytes<DP>(g.tile, false);
        const size_t kv_smem = attn_bwd_smem_bytes<DP>(g.tile, true);
        if (p.CA == C && p.DP == p.D) {
            err = go(attn_bwd_q_kernel<DP, true>, q_smem);
            return err != cudaSuccess ? err : go(attn_bwd_kv_kernel<DP, true>, kv_smem);
        }
        err = go(attn_bwd_q_kernel<DP, false>, q_smem);
        return err != cudaSuccess ? err : go(attn_bwd_kv_kernel<DP, false>, kv_smem);
    } else {
        constexpr int W = WideBwd<DP>::WARPS;
        const int nb = (N + 16 * W - 1) / (16 * W);
        const size_t blocks = (size_t)R * nb;
        if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
        auto go = [&](auto kernel, size_t smem) {
            cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return e;
            kernel<<<(unsigned)blocks, 32 * W, smem, stream>>>(qkv, d_oe, d_den, bound, dqkv, N,
                                                               p.CA, p.HK, C, H, p.D, nb);
            return cudaGetLastError();
        };
        err = go(attn_bwd_q_wide_kernel<DP>, attn_bwd_wide_smem_bytes<DP>(false));
        if (err != cudaSuccess) return err;
        return go(attn_bwd_kv_wide_kernel<DP>, attn_bwd_wide_smem_bytes<DP>(true));
    }
}

// The scratch buffer's parts, in order, as byte offsets.
struct Layout {
    size_t qkv, normed, n2c, h1c, dh1c, d_midc, d_oe, dqkv, d_mid, d_den, bound, vec_part,
        mat_part;
    size_t bytes;
};

Layout layout(int R, int N, int C, int H, int hidden) {
    const size_t M = (size_t)R * N;
    const HeadPlan p = head_plan(C, H);
    Layout l{};
    size_t off = 0;
    auto take = [&](size_t n) { const size_t at = off; off += align256(n); return at; };
    l.qkv = take(M * 3 * p.CA * 2);
    l.normed = take(M * C * 2);
    l.n2c = take(M * C * 2);
    l.h1c = take(M * hidden * 2);
    l.dh1c = take(M * hidden * 2);
    l.d_midc = take(M * C * 2);
    l.d_oe = take(M * p.CA * 2);
    l.dqkv = take(M * 3 * C * 2);
    l.d_mid = take(M * C * 4);
    l.d_den = take(M * H * 4);
    l.bound = take((size_t)R * p.HK * 4);
    // mlp_bwd_kernel's partials and, after them, ln1_bwd_kernel's
    l.vec_part = take((size_t)token_blocks((int)M) * (4 * C + hidden) * 4);
    const size_t mat = (size_t)max(hidden * C, 3 * C * C);
    l.mat_part = take((size_t)splits((int)M) * mat * 4);
    l.bytes = off;
    return l;
}

struct Scratch {
    bf16 *qkv, *normed, *n2c, *h1c, *dh1c, *d_midc, *d_oe, *dqkv;
    float *d_mid, *d_den, *bound, *vec_part, *mat_part;
};

Scratch carve(char* base, const Layout& l) {
    return {(bf16*)(base + l.qkv), (bf16*)(base + l.normed), (bf16*)(base + l.n2c),
            (bf16*)(base + l.h1c), (bf16*)(base + l.dh1c), (bf16*)(base + l.d_midc),
            (bf16*)(base + l.d_oe), (bf16*)(base + l.dqkv), (float*)(base + l.d_mid),
            (float*)(base + l.d_den), (float*)(base + l.bound), (float*)(base + l.vec_part),
            (float*)(base + l.mat_part)};
}

}  // namespace

extern "C" size_t fused_block_backward_scratch_bytes(int R, int N, int C, int H, int hidden) {
    return layout(R, N, C, H, hidden).bytes;
}

// Where the attention backward's operands and result lie in the scratch
// buffer after a call, as byte offsets: d_oe (R*N, CA) bf16 in the padded
// head layout (head_plan), d_den (R*N, H) f32 (bf16 values) and dqkv
// (R*N, 3C) bf16.
extern "C" void fused_block_backward_part_offsets(int R, int N, int C, int H, int hidden,
                                                  size_t* offsets) {
    const Layout l = layout(R, N, C, H, hidden);
    offsets[0] = l.d_oe;
    offsets[1] = l.d_den;
    offsets[2] = l.dqkv;
}

extern "C" int fused_block_backward(
    const void* x, const void* mid, const void* acc, const void* den, const void* g,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* w_qkv_t,
    const void* w_o_t, const void* ln2_s, const void* ln2_b, const void* w_1,
    const void* w_1_t, const void* b_1, const void* w_2_t,
    void* scratch, void* dx, void* grads,
    int R, int N, int C, int H, int hidden, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = R * N;
    if (M <= 0 || H <= 0 || C % 8 || C > 512 || C % H || hidden <= 0 || hidden % 8)
        return cudaErrorInvalidValue;
    const HeadPlan p = head_plan(C, H);
    const Scratch s = carve((char*)scratch, layout(R, N, C, H, hidden));
    float* gr = (float*)grads;
    float *g_ln1s = gr, *g_ln1b = g_ln1s + C, *g_qkv = g_ln1b + C, *g_wo = g_qkv + 3 * C * C,
          *g_ob = g_wo + C * C, *g_ln2s = g_ob + C, *g_ln2b = g_ln2s + C,
          *g_w1 = g_ln2b + C, *g_b1 = g_w1 + C * hidden, *g_w2 = g_b1 + hidden,
          *g_b2 = g_w2 + hidden * C;
    const bf16 *bx = (const bf16*)x, *bg = (const bf16*)g, *bacc = (const bf16*)acc;

    // 1. LN1 + qkv recompute (B1's launch, on the tensor cores)
    cudaError_t err = launch_ln_qkv<true>(bx, (const bf16*)ln1_s, (const bf16*)ln1_b,
                                          (const bf16*)w_qkv, s.qkv, s.normed, M, C, p.CA,
                                          stream);
    if (err != cudaSuccess) return err;

    // 2. MLP half + LN2 backward + d_oe / d_den
    const int G = token_blocks(M);
    const int pw = 4 * C + hidden;
    auto mlp = [&](auto kernel, size_t smem) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        kernel<<<G, MB_THREADS, smem, stream>>>(
            (const bf16*)mid, bg, bacc, (const float*)den, (const bf16*)ln2_s,
            (const bf16*)ln2_b, (const bf16*)w_1, (const bf16*)b_1, (const bf16*)w_1_t,
            (const bf16*)w_2_t, (const bf16*)w_o_t, s.n2c, s.h1c, s.dh1c, s.d_mid, s.d_midc,
            s.d_oe, s.d_den, s.vec_part, M, N, H, hidden, C, p.DP, p.CA);
        return cudaGetLastError();
    };
    // the EXACT forms where the widths are the flagship's (C = CA = CP, DP = D)
    const bool exact = C == prod_width(C) && p.CA == C && p.DP == p.D;
#define WIDTH_SWITCH(F)                                                 \
    switch (prod_width(C)) {                                            \
        case 32: err = exact ? F(32, true) : F(32, false); break;       \
        case 64: err = exact ? F(64, true) : F(64, false); break;       \
        case 128: err = exact ? F(128, true) : F(128, false); break;    \
        case 256: err = exact ? F(256, true) : F(256, false); break;    \
        case 384: err = F(384, false); break;                           \
        default: err = F(512, false); break;                            \
    }
#define MLP_AT(CPV, EX) mlp(mlp_bwd_kernel<CPV, EX>, mlp_bwd_smem_bytes<CPV>(hidden))
    WIDTH_SWITCH(MLP_AT)
#undef MLP_AT
    if (err != cudaSuccess) return err;
    const float* vp = s.vec_part;
    if ((err = reduce(vp, g_b2, G, pw, C, stream)) != cudaSuccess) return err;
    if ((err = reduce(vp + C, g_b1, G, pw, hidden, stream)) != cudaSuccess) return err;
    if ((err = reduce(vp + C + hidden, g_ln2s, G, pw, C, stream)) != cudaSuccess) return err;
    if ((err = reduce(vp + 2 * C + hidden, g_ln2b, G, pw, C, stream)) != cudaSuccess) return err;
    if ((err = reduce(vp + 3 * C + hidden, g_ob, G, pw, C, stream)) != cudaSuccess) return err;

    // 3-4. attention backward
#define ATTN_AT(DPV)                                                                      \
    case DPV:                                                                             \
        err = launch_attn_bwd<DPV>(s.qkv, s.d_oe, s.d_den, s.bound, s.dqkv, R, N, C, H, p, \
                                   stream);                                              \
        break;
    switch (p.DP) {
        ATTN_AT(4) ATTN_AT(8) ATTN_AT(16) ATTN_AT(32) ATTN_AT(64) ATTN_AT(128) ATTN_AT(256)
        ATTN_AT(512)
        default: return cudaErrorInvalidValue;
    }
#undef ATTN_AT
    if (err != cudaSuccess) return err;

    // 5. LN1 backward and dx
    auto ln1 = [&](auto kernel, size_t smem) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        kernel<<<G, LB_THREADS, smem, stream>>>(bx, s.dqkv, s.d_mid, (const bf16*)ln1_s,
                                                (const bf16*)w_qkv_t, (bf16*)dx, s.vec_part, M,
                                                C);
        return cudaGetLastError();
    };
#define LN1_AT(CPV, EX) ln1(ln1_bwd_kernel<CPV, EX>, ln1_bwd_smem_bytes<CPV>())
    WIDTH_SWITCH(LN1_AT)
#undef LN1_AT
#undef WIDTH_SWITCH
    if (err != cudaSuccess) return err;
    if ((err = reduce(s.vec_part, g_ln1s, G, 2 * C, C, stream)) != cudaSuccess) return err;
    if ((err = reduce(s.vec_part + C, g_ln1b, G, 2 * C, C, stream)) != cudaSuccess) return err;

    // 6-7. weight gradients
    if ((err = atb(s.h1c, bg, s.mat_part, g_w2, M, hidden, C, stream)) != cudaSuccess) return err;
    if ((err = atb(s.n2c, s.dh1c, s.mat_part, g_w1, M, C, hidden, stream)) != cudaSuccess) return err;
    if ((err = atb(bacc, s.d_midc, s.mat_part, g_wo, M, C, C, stream)) != cudaSuccess) return err;
    return atb(s.normed, s.dqkv, s.mat_part, g_qkv, M, C, 3 * C, stream);
}
