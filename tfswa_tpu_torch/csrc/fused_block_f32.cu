// Fused pre-LN row transformer block, forward, in float32, for Hopper
// (sm_90a): the f32 forms of B1 (serving), B1-train (also mid and den) and
// B3 (int8 scores), and of the kernel lab L (B1 cut at a stage or with its
// score -> p line changed; fused_block_lab_forward_f32 below).
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/fused_block.py
// _fused_block_kernel with cd = float32 (it computes in x_ref.dtype), in
// its serving, with_mid=True and int8_attn=True forms.  Per row of rows
// (R, N, C), f32 in and out; Wq pre-scaled by log2(e)/sqrt(D) outside:
//   n1  = LN1(x)                          statistics in f32, eps 1e-5
//   q,k,v = n1 @ Wq', n1 @ Wk, n1 @ Wv
//   per head: p = exp2(min(q.k, 110))     the max-free softmax, SCORE_CLAMP
//             den = sum p, acc = (sum p v) / den
//   y   = x + (acc @ Wo + bo)              (B1-train: mid = y)
//   out = y + (gelu(LN2(y) @ W1 + b1) @ W2 + b2)
// B3: q.k becomes (qi.ki) * (sq * sk), sq = max|q| / 127 over the row's
// N*C values of q (all heads; the same for k), qi = rint(q / sq) as int8 (a
// true division, rounded half to even; 0 where the scale is 0), the int8
// dot product summed exactly (in f32: at most 32 * 127^2 < 2^24); v, p and
// the sums as in B1.
//
// Design (see block_f32.cuh for the tile).  Launches:
//   ln_stats_kernel (x) -> gemm qkv = LN1(x) @ Wqkv' -> (B3) qk_scale_kernel,
//   quantize_kernel -> attention -> gemm y = x + acc @ Wo + bo ->
//   ln_stats_kernel (y) -> gemm h = gelu(LN2(y) @ W1 + b1) ->
//   gemm out = y + h @ W2 + b2.
// Every product (the four gemms) runs in 3xTF32 on the tensor cores.  The
// attention, one design per head width, chosen at compile time:
//   D <= 8 (attn_ffma_kernel): a thread a query holding its q and its D
//       sums in registers, the head's keys and values streaming through
//       shared memory, read by every thread (broadcast): the score chain,
//       one exp2 and D FMAs of p . v a score, all on the CUDA cores;
//   8 < D <= 32 (attn_kernel<DC>): a warp owns 16 queries, the keys come
//       64 at a time through shared memory; each n-tile of 8 keys gets its
//       scores as FMA chains (f32, the plain version's sum), p = exp2(min(s,
//       110)) and p . v in 3xTF32 on the tensor cores (p's C fragment
//       re-used as the A fragment); B3's scores are the int8 dot on IMMA
//       (mma.sync m16n8k32, exact) times sq sk;
//   D > 32 (attn_kernel<32, WIDE>): the same, the scores continued over
//       the head's channels 32 at a time, the output in parts of 32
//       channels (grid.z), each part's block recomputing the scores.
// No (N, N) plane exists.  q, k, v, the attention output, y and the MLP's
// hidden activation (4 C a token) go through device memory.
//
// What bounds it: at D <= 8 the attention runs about 16 instructions a
// score (the chain, the clamp, exp2 and its range checks, the row sum,
// p . v), about twice the SFU's one exp2 a score: the tensor cores would
// take p . v but cost p's split and the fragments' reads, more than the D
// FMAs (stage 0's attention took 132.4 ms on them against 40.6 on this
// form, PERF.md).
// Above, the chain's D FMAs a score and 3xTF32's p . v; the products at
// stage 0 by their bytes, above by 3xTF32's rate (PERF.md).  Against a
// CUDA-core form for every D (a thread a query), these forms take
// wide384's D = 48 and 96 attention from 451.3 to 303.1 ms a forward and
// D = 24 from 167.2 to 157.6; D = 12 is level (557.5, 556.6; PERF.md).
#include "block_f32.cuh"

namespace f32 {
namespace {

// The lab's stages (ops/lab_block.py STAGES) and flag bits, as in
// fused_block.cu.  An attention launch takes STAGE_SCORES (the scores kept
// in a checksum only), STAGE_EXP2 (p of the first D queries written out,
// the rest in the checksum) or STAGE_FULL; FLAGS change its score -> p
// line (p_of).  P_F32 has nothing to change here: p is never rounded in f32.
enum : int { STAGE_QKV, STAGE_SCORES, STAGE_EXP2, STAGE_AV, STAGE_ATTN, STAGE_FULL };
enum : int { SCORE_BF16 = 1, P_F32 = 2, NO_CLAMP = 4 };
constexpr float LN2_BF16 = 0.69140625f;   // ln 2 rounded to bf16

// x rounded to the nearest bf16 value (ties to even), as an f32
__device__ __forceinline__ float round_bf16(float x) {
    const uint32_t u = __float_as_uint(x);
    return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// p of a score: exp2(min(s, 110)); SCORE_BF16 exp of the bf16-rounded
// product of the bf16-rounded clamped score and ln 2 (the plain version's
// exp2 of a bf16 value, as XLA lowers it); NO_CLAMP drops the clamp.
template <int FLAGS>
__device__ __forceinline__ float p_of(float s) {
    if constexpr ((FLAGS & NO_CLAMP) == 0) s = clamp_score(s);
    if constexpr ((FLAGS & SCORE_BF16) != 0) return expf(round_bf16(round_bf16(s) * LN2_BF16));
    return exp2f(s);
}

// A cut stage's checksum: the warp's sum, written by its lane 0 to sink (a
// float a warp of the launch), so that no part of the cut is dead code.
__device__ __forceinline__ void sink_warp(float v, float* sink) {
    v = warp_sum(v);
    const long b = (long)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if ((threadIdx.x & 31) == 0) sink[b * (blockDim.x >> 5) + (threadIdx.x >> 5)] = v;
}

constexpr int AQ = 64;            // queries a block: 4 warps of 16
constexpr int AK = 64;            // keys a staged tile: 8 n-tiles
constexpr int ATT_THREADS = 128;
constexpr int KW = 12;            // words a staged int8 key row (32 channels, padded)

// acc_out[(r N + i) C + h D + v0 + d] = (sum_j p_ij v_jd) / den_i for the
// part's channels d < DC, den_out[(r H + h) N + i] = den_i (B1-train);
// p_ij = exp2(min(s_ij, 110)).  s_ij = q_i . k_j, the FMA chain
// (chain_scores), or B3's (qi_i . ki_j) * sq * sk, the int8 dot exact on
// IMMA (qk (R N, 2C) int8, scales (R, 2)); p . v in 3xTF32.  grid (R *
// q_tiles, H, parts), 128 threads: a warp owns 16 queries (their q rows in
// registers), the keys come AK at a time through shared memory (k raw, v
// split as it is staged).  DC: the head's D channels rounded up to 8, 16 or
// 32 (zeros past D), one part; WIDE (D > 32): the scores continued over the
// head's channels DC = 32 at a time (the q rows of each chunk read again),
// the output in parts of 32 channels (grid.z), each part's block
// recomputing the scores.  Keys past N get p = 0; queries past N are
// computed and not stored.  The lab: STAGE_SCORES stops at the scores,
// STAGE_EXP2 at p, writing acc_out[(r N + j) C + h D + i] = p_ij for the
// queries i < D (one part: grid.z 1); both leave their checksum in sink.
template <int DC, bool WIDE, bool INT8, int STAGE = STAGE_FULL, int FLAGS = 0>
__global__ void __launch_bounds__(ATT_THREADS)
attn_kernel(const float* __restrict__ qkv, const int8_t* __restrict__ qk,
            const float* __restrict__ scales, float* __restrict__ acc_out,
            float* __restrict__ den_out, int N, int C, int H, int q_tiles,
            float* __restrict__ sink) {
    static_assert(STAGE == STAGE_FULL || (!INT8 && FLAGS == 0),
                  "the lab cuts B1's serving form, flags only on the full attention");
    constexpr int KS = DC / 8;
    __shared__ __align__(16) float kr[INT8 ? 1 : AK][DC + 4];
    __shared__ Staged<AK, DC> vs;
    __shared__ __align__(16) uint32_t k8s[INT8 ? AK : 1][KW];
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
    const int D = C / H, r = blockIdx.x / q_tiles, h = blockIdx.y, v0 = blockIdx.z * DC;
    const int i0 = (blockIdx.x % q_tiles) * AQ + warp * 16;
    const long row0 = (long)r * N, C3 = 3L * C, C2 = 2L * C;
    const int chunks = WIDE ? (D + DC - 1) / DC : 1;
    const float* qrow = qkv + row0 * C3 + h * D;
    float qo[INT8 ? 1 : 2][DC];
    uint32_t qi[4];
    auto load_q = [&](int c0) {
        const int dc = imin(DC, D - c0);
        if constexpr (INT8) {
            const int8_t* q8 = qk + row0 * C2 + h * D + c0;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                const int i = i0 + g + 8 * (w & 1), c = 4 * t + 16 * (w >> 1);
                uint32_t word = 0;
                for (int u = 0; u < 4; ++u)
                    if (i < N && c + u < dc)
                        word |= (uint32_t)(uint8_t)q8[(long)i * C2 + c + u] << (8 * u);
                qi[w] = word;
            }
        } else {
            own_rows(qo, qrow + c0, C3, i0, N, dc);
        }
    };
    if (!WIDE) load_q(0);
    const float sqsk = INT8 ? scales[2 * r] * scales[2 * r + 1] : 0.0f;
    const int vd = imin(DC, D - v0);
    float o[KS][4] = {};
    float den[2] = {0.0f, 0.0f};
    // the scores of n-tile nt of the staged keys (chunk c0 .. c0 + dc) added to sv
    auto scores = [&](int nt, float (&sv)[4]) {
        if constexpr (INT8) {
            int si[4] = {};
            const uint32_t b[2] = {k8s[nt * 8 + g][t], k8s[nt * 8 + g][4 + t]};
            mma_s8(si, qi, b);
#pragma unroll
            for (int e = 0; e < 4; ++e) sv[e] += (float)si[e];
        } else {
            chain_scores(sv, qo, kr, nt * 8);
        }
    };
    auto stage_k = [&](const float* kb, int j0, int nk, int c0, int dc) {
        if constexpr (INT8) {
            int8_t* k8 = reinterpret_cast<int8_t*>(&k8s[0][0]);
            const int8_t* src = qk + (row0 + j0) * C2 + C + h * D + c0;
            for (int e = threadIdx.x; e < AK * 32; e += ATT_THREADS) {
                const int j = e >> 5, d = e & 31;
                k8[j * 4 * KW + d] = j < nk && d < dc ? src[(long)j * C2 + d] : (int8_t)0;
            }
        } else {
            stage_raw<ATT_THREADS>(kr, kb + c0, C3, nk, dc);
        }
    };
    // p of n-tile nt's scores (keys j0 ..), the row sums and o += p v
    auto accumulate = [&](int j0, int nt, int nk, const float (&sv)[4]) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x = INT8 ? sv[e] * sqsk : sv[e];
            p[e] = nt * 8 + 2 * t + (e & 1) < nk ? p_of<FLAGS>(x) : 0.0f;
        }
        den[0] += p[0] + p[1];
        den[1] += p[2] + p[3];
        if constexpr (STAGE == STAGE_EXP2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = i0 + g + 8 * (e >> 1), j = nt * 8 + 2 * t + (e & 1);
                if (i < D && j < nk) acc_out[(row0 + j0 + j) * C + h * D + i] = p[e];
            }
            return;
        }
        uint32_t pa[2][4];
        frag_from_c(pa, p);
#pragma unroll
        for (int c8 = 0; c8 < KS; ++c8) {
            uint32_t b[2][2];
            frag_col(b, vs, nt * 8, 8 * c8);
            mma3(o[c8], pa, b);
        }
    };
    for (int j0 = 0; j0 < N; j0 += AK) {
        const int nk = imin(AK, N - j0);
        const float* kb = qkv + (row0 + j0) * C3 + C + h * D;     // key j's k; its v at + C
        if constexpr (!WIDE) {
            // one chunk: k and v staged together, each n-tile's scores used at once
            __syncthreads();
            stage_k(kb, j0, nk, 0, D);
            if (STAGE == STAGE_FULL) stage<ATT_THREADS>(vs, kb + C, C3, nk, D);
            __syncthreads();
#pragma unroll 2
            for (int nt = 0; nt < 8; ++nt) {
                float sv[4] = {};
                scores(nt, sv);
                if (STAGE == STAGE_SCORES) den[0] += (sv[0] + sv[1]) + (sv[2] + sv[3]);
                else accumulate(j0, nt, nk, sv);
            }
        } else {
            float sv[8][4] = {};
            for (int c = 0; c < chunks; ++c) {
                const int c0 = c * DC;
                __syncthreads();
                stage_k(kb, j0, nk, c0, imin(DC, D - c0));
                __syncthreads();
                load_q(c0);
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) scores(nt, sv[nt]);
            }
            if constexpr (STAGE == STAGE_SCORES) {
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
                    den[0] += (sv[nt][0] + sv[nt][1]) + (sv[nt][2] + sv[nt][3]);
                continue;
            }
            __syncthreads();
            if (STAGE == STAGE_FULL) stage<ATT_THREADS>(vs, kb + C + v0, C3, nk, vd);
            __syncthreads();
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) accumulate(j0, nt, nk, sv[nt]);
        }
    }
    if constexpr (STAGE != STAGE_FULL) {
        sink_warp(den[0] + den[1], sink);
        return;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        den[hh] += __shfl_xor_sync(0xffffffffu, den[hh], 1);
        den[hh] += __shfl_xor_sync(0xffffffffu, den[hh], 2);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + g + 8 * hh;
        if (i >= N) continue;
#pragma unroll
        for (int c8 = 0; c8 < KS; ++c8)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int d = 8 * c8 + 2 * t + j;
                if (d < vd) acc_out[(row0 + i) * C + h * D + v0 + d] = o[c8][2 * hh + j] / den[hh];
            }
        if (den_out && blockIdx.z == 0 && t == 0) den_out[((long)r * H + h) * N + i] = den[hh];
    }
}

constexpr int QT = 128;   // queries a block of attn_ffma_kernel
constexpr int KT = 128;   // keys a shared-memory tile of it

// The same for a head of at most 8 channels, on the CUDA cores: one block
// per (row, QT queries) and head, a thread a query holding its q and its D
// sums in registers, the head's keys and values streaming through shared
// memory QT at a time, read by every thread (broadcast).  At D <= 8 the
// attention is bound by the instructions it runs a score (the chain, one
// exp2, p . v), not by its products: p . v on the tensor cores costs p's
// split and the fragments' reads, more than D FFMAs (PERF.md: the
// tensor-core form ran stage 0 at 132.4 ms against this form's 40.6).
// DP: D rounded up to 4 or 8 (zeros past D); B3's int8 dot summed in f32
// (exact: at most 8 * 127^2).  STAGE and FLAGS as attn_kernel's (the
// exp2 cut: the threads of queries i < D write their p).
template <int DP, int STAGE = STAGE_FULL, int FLAGS = 0>
__global__ void __launch_bounds__(QT)
attn_ffma_kernel(const float* __restrict__ qkv, const int8_t* __restrict__ qk,
            const float* __restrict__ scales, float* __restrict__ acc_out,
            float* __restrict__ den_out, int N, int C, int H, int q_tiles,
            float* __restrict__ sink) {
    __shared__ float ks[KT][DP];
    __shared__ float vs[KT][DP];
    const int D = C / H;
    const int r = blockIdx.x / q_tiles;
    const int i = (blockIdx.x % q_tiles) * QT + threadIdx.x;
    const int h = blockIdx.y;
    const long row0 = (long)r * N;
    const long C3 = 3L * C, C2 = 2L * C;
    const bool int8 = qk != nullptr;
    const float sqsk = int8 ? scales[2 * r] * scales[2 * r + 1] : 0.0f;
    const bool live = i < N;
    float q[DP], acc[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
        q[d] = !live || d >= D ? 0.0f
               : int8 ? (float)qk[(row0 + i) * C2 + h * D + d]
                      : qkv[(row0 + i) * C3 + h * D + d];
        acc[d] = 0.0f;
    }
    float den = 0.0f;
    for (int j0 = 0; j0 < N; j0 += KT) {
        const int nk = N - j0 < KT ? N - j0 : KT;
        for (int e = threadIdx.x; e < nk * DP; e += QT) {
            const int j = e / DP, d = e % DP;
            const long t = row0 + j0 + j;
            const bool in = d < D;
            ks[j][d] = !in ? 0.0f
                       : int8 ? (float)qk[t * C2 + C + h * D + d] : qkv[t * C3 + C + h * D + d];
            if (STAGE == STAGE_FULL) vs[j][d] = in ? qkv[t * C3 + 2 * C + h * D + d] : 0.0f;
        }
        __syncthreads();
        auto key = [&](int j) {
            float s = 0.0f;
#pragma unroll
            for (int d = 0; d < DP; ++d) s = fmaf(q[d], ks[j][d], s);
            if (int8) s = s * sqsk;
            if constexpr (STAGE == STAGE_SCORES) {
                den += s;
                return;
            }
            const float p = p_of<FLAGS>(s);
            den += p;
            if constexpr (STAGE == STAGE_EXP2) {
                if (i < D) acc_out[(row0 + j0 + j) * C + h * D + i] = p;
                return;
            }
#pragma unroll
            for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
        };
        if (live && nk == KT) {          // a full tile: a fixed trip count, unrolled
#pragma unroll 8
            for (int j = 0; j < KT; ++j) key(j);
        } else if (live) {
            for (int j = 0; j < nk; ++j) key(j);
        }
        __syncthreads();
    }
    if constexpr (STAGE != STAGE_FULL) {
        sink_warp(den, sink);
        return;
    }
    if (live) {
#pragma unroll
        for (int d = 0; d < DP; ++d)
            if (d < D) acc_out[(row0 + i) * C + h * D + d] = acc[d] / den;
        if (den_out) den_out[((long)r * H + h) * N + i] = den;
    }
}

// scales[2 r] = max|q| / 127 and scales[2 r + 1] = max|k| / 127 over row r's
// N * C values (NaN where one is NaN); a block of 256 threads a row.
__global__ void __launch_bounds__(256)
qk_scale_kernel(const float* __restrict__ qkv, int N, int C, float* __restrict__ scales) {
    __shared__ float red[2][8];
    const long row0 = (long)blockIdx.x * N;
    const long C3 = 3L * C;
    float mq = 0.0f, mk = 0.0f;
    for (long e = threadIdx.x; e < (long)N * C; e += 256) {
        const long t = row0 + e / C;
        const int c = (int)(e % C);
        mq = max_keep_nan(mq, fabsf(qkv[t * C3 + c]));
        mk = max_keep_nan(mk, fabsf(qkv[t * C3 + C + c]));
    }
    for (int o = 16; o > 0; o >>= 1) {
        mq = max_keep_nan(mq, __shfl_xor_sync(0xffffffffu, mq, o));
        mk = max_keep_nan(mk, __shfl_xor_sync(0xffffffffu, mk, o));
    }
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        red[0][w] = mq;
        red[1][w] = mk;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 1; k < 8; ++k) {
            mq = max_keep_nan(mq, red[0][k]);
            mk = max_keep_nan(mk, red[1][k]);
        }
        scales[2 * blockIdx.x] = mq / 127.0f;
        scales[2 * blockIdx.x + 1] = mk / 127.0f;
    }
}

// qk[t, c] = rint(qkv[t, c] / s) for c < 2C (q then k), s the row's scale
// of q or k; 0 where s is 0.
__global__ void __launch_bounds__(256)
quantize_kernel(const float* __restrict__ qkv, const float* __restrict__ scales, long M, int N,
                int C, int8_t* __restrict__ qk) {
    const long e = (long)blockIdx.x * 256 + threadIdx.x;
    if (e >= M * 2 * C) return;
    const long t = e / (2 * C);
    const int c = (int)(e % (2 * C));
    const float s = scales[2 * (t / N) + (c >= C)];
    const float v = qkv[t * 3L * C + c];
    qk[e] = (int8_t)(s > 0.0f ? rintf(v / s) : 0.0f);
}

template <int DP, int STAGE, int FLAGS>
void launch_attn_ffma(const float* qkv, const int8_t* qk, const float* scales, float* attn,
                      float* den, float* sink, int R, int N, int C, int H, cudaStream_t st) {
    const int q_tiles = (N + QT - 1) / QT;
    auto* kernel = attn_ffma_kernel<DP, STAGE, FLAGS>;
    LAUNCH(kernel, dim3((unsigned)((long)R * q_tiles), (unsigned)H), QT, st, qkv, qk, scales,
           attn, den, N, C, H, q_tiles, sink);
}

template <int DC, bool WIDE, int STAGE, int FLAGS>
void launch_attn(const float* qkv, const int8_t* qk, const float* scales, float* attn,
                 float* den, float* sink, int R, int N, int C, int H, cudaStream_t st) {
    const int q_tiles = (N + AQ - 1) / AQ;
    const dim3 grid((unsigned)((long)R * q_tiles), (unsigned)H,
                    WIDE && STAGE == STAGE_FULL ? (unsigned)((C / H + DC - 1) / DC) : 1u);
    if constexpr (STAGE == STAGE_FULL && FLAGS == 0) {
        auto* kernel = qk ? attn_kernel<DC, WIDE, true> : attn_kernel<DC, WIDE, false>;
        LAUNCH(kernel, grid, ATT_THREADS, st, qkv, qk, scales, attn, den, N, C, H, q_tiles,
               sink);
    } else {
        auto* kernel = attn_kernel<DC, WIDE, false, STAGE, FLAGS>;
        LAUNCH(kernel, grid, ATT_THREADS, st, qkv, qk, scales, attn, den, N, C, H, q_tiles,
               sink);
    }
}

// The attention launch of B1's design at the head width D = C / H, cut at
// STAGE or with FLAGS (the lab; B1, B1-train and B3 take STAGE_FULL, 0).
template <int STAGE, int FLAGS>
void attention(const float* qkv, const int8_t* qk, const float* scales, float* attn, float* den,
               float* sink, int R, int N, int C, int H, cudaStream_t st) {
    const int D = C / H;
    if (D <= 4) launch_attn_ffma<4, STAGE, FLAGS>(qkv, qk, scales, attn, den, sink, R, N, C, H, st);
    else if (D <= 8)
        launch_attn_ffma<8, STAGE, FLAGS>(qkv, qk, scales, attn, den, sink, R, N, C, H, st);
    else if (D <= 16)
        launch_attn<16, false, STAGE, FLAGS>(qkv, qk, scales, attn, den, sink, R, N, C, H, st);
    else if (D <= 32)
        launch_attn<32, false, STAGE, FLAGS>(qkv, qk, scales, attn, den, sink, R, N, C, H, st);
    else launch_attn<32, true, STAGE, FLAGS>(qkv, qk, scales, attn, den, sink, R, N, C, H, st);
}

// qkv = LN1(x) @ Wqkv', the LN1 statistics into mean1, rstd1
int qkv_part(const float* x, const float* ln1_s, const float* ln1_b, const float* w_qkv,
             float* qkv, float* mean1, float* rstd1, long M, int C, cudaStream_t st) {
    ln_stats(x, M, C, mean1, rstd1, st);
    return gemm(ln_a(x, C, mean1, rstd1, ln1_s, ln1_b), w_qkv, 3 * C, qkv, 3 * C, M, 3 * C, C,
                epi(), st);
}

// y = x + attn @ Wo + bo, then out = y + gelu(LN2(y) @ W1 + b1) @ W2 + b2
// (stats: LN2's mean and rstd)
int post(const float* x, const float* attn, const float* w_o, const float* b_o,
         const float* ln2_s, const float* ln2_b, const float* w_1, const float* b_1,
         const float* w_2, const float* b_2, float* y, float* stats, float* hbuf, float* out,
         long M, int C, int hidden, cudaStream_t st) {
    float *mean2 = stats, *rstd2 = stats + M;
    F32_TRY(gemm(plain_a(attn, C), w_o, C, y, C, M, C, C, epi(EPI_NONE, b_o, x, C), st));
    ln_stats(y, M, C, mean2, rstd2, st);
    F32_TRY(gemm(ln_a(y, C, mean2, rstd2, ln2_s, ln2_b), w_1, hidden, hbuf, hidden, M, hidden,
                 C, epi(EPI_GELU, b_1), st));
    return gemm(plain_a(hbuf, hidden), w_2, C, out, C, M, C, hidden, epi(EPI_NONE, b_2, y, C),
                st);
}

int forward(const float* x, const float* ln1_s, const float* ln1_b, const float* w_qkv,
            const float* w_o, const float* b_o, const float* ln2_s, const float* ln2_b,
            const float* w_1, const float* b_1, const float* w_2, const float* b_2,
            float* qkv, float* stats, float* y, float* hbuf, float* attn, float* out, float* den,
            float* scales, int8_t* qk, int R, int N, int C, int H, int hidden,
            cudaStream_t st) {
    const long M = (long)R * N;
    F32_TRY(qkv_part(x, ln1_s, ln1_b, w_qkv, qkv, stats, stats + M, M, C, st));
    if (qk) {
        LAUNCH(qk_scale_kernel, (unsigned)R, 256, st, qkv, N, C, scales);
        LAUNCH(quantize_kernel, (unsigned)((M * 2 * C + 255) / 256), 256, st, qkv, scales, M, N,
               C, qk);
    }
    attention<STAGE_FULL, 0>(qkv, qk, scales, attn, den, nullptr, R, N, C, H, st);
    F32_TRY(post(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2, y, stats + 2 * M, hbuf,
                 out, M, C, hidden, st));
    return cudaGetLastError();
}

// ------------------------------------------------------------------ the lab
// The cuts' own output launches (counterparts of fused_block.cu's
// qkv_sum_kernel, kept_scores_kernel and av_sum_kernel).  Each is bound by
// the bytes it writes (scores, av: the (R, N, C) output) or reads (qkv).

// stage qkv: out[t, c] = (q + k) + v, per token t and channel c
__global__ void __launch_bounds__(256)
qkv_sum_kernel(const float* __restrict__ qkv, float* __restrict__ out, long total, int C) {
    for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < total; i += (long)gridDim.x * 256) {
        const float* t = qkv + (i / C) * 3 * C + i % C;
        out[i] = (t[0] + t[C]) + t[2 * C];
    }
}

// stage scores: out[r, n, c] = sum over heads h in order of s_h[n, c] = q_h[n]
// . k_h[c] (an FMA chain over the head's D channels in order) for c < kept
// = min(C, N), else 0.  One block per (row, KS_Q queries), 128 threads:
// warp w owns queries 8w .. 8w + 7, lane j the keys j, j + 32, .. (KG =
// ceil(kept / 32) groups; kept <= KS_KEYS); the queries' and the kept keys'
// channels go through shared memory KS_L at a time.
constexpr int KS_Q = 32, KS_L = 32, KS_KEYS = 256, KS_THREADS = 128;

template <int KG>
__global__ void __launch_bounds__(KS_THREADS)
kept_scores_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N, int C,
                   int D) {
    __shared__ float qs[KS_Q][KS_L + 1];
    __shared__ float ks[32 * KG][KS_L + 1];
    const int nqt = (N + KS_Q - 1) / KS_Q;
    const long r = blockIdx.x / nqt;
    const int n0 = (int)(blockIdx.x % nqt) * KS_Q;
    const int kept = imin(C, N);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long ld = 3L * C;
    const float* row = qkv + r * N * ld;
    float acc[8][KG], s[8][KG];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int m = 0; m < KG; ++m) acc[i][m] = s[i][m] = 0.0f;
    for (int l0 = 0; l0 < C; l0 += KS_L) {
        const int nl = imin(KS_L, C - l0);
        __syncthreads();
        for (int e = threadIdx.x; e < KS_Q * KS_L; e += KS_THREADS) {
            const int n = n0 + e / KS_L, l = e % KS_L;
            qs[e / KS_L][l] = n < N && l < nl ? row[n * ld + l0 + l] : 0.0f;
        }
        for (int e = threadIdx.x; e < 32 * KG * KS_L; e += KS_THREADS) {
            const int j = e / KS_L, l = e % KS_L;
            ks[j][l] = j < kept && l < nl ? row[j * ld + C + l0 + l] : 0.0f;
        }
        __syncthreads();
        for (int l = 0; l < nl; ++l) {
            const bool head_end = (l0 + l + 1) % D == 0;
#pragma unroll
            for (int m = 0; m < KG; ++m) {
                const float kv = ks[32 * m + lane][l];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    s[i][m] = fmaf(qs[8 * warp + i][l], kv, s[i][m]);
                    if (head_end) {
                        acc[i][m] += s[i][m];
                        s[i][m] = 0.0f;
                    }
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int n = n0 + 8 * warp + i;
        if (n >= N) continue;
        float* o = out + (r * N + n) * C;
#pragma unroll
        for (int m = 0; m < KG; ++m)
            if (32 * m + lane < kept) o[32 * m + lane] = acc[i][m];
        for (int c = kept + lane; c < C; c += 32) o[c] = 0.0f;
    }
}

// stage av: out[r, n, c] = sum over the queries q in order of attn[r, q, c]
// (the f32 attention output, normalised), the same for every n; a thread
// per (r, c).
__global__ void __launch_bounds__(128)
av_sum_kernel(const float* __restrict__ attn, float* __restrict__ out, int R, int N, int C) {
    const long i = (long)blockIdx.x * 128 + threadIdx.x;
    if (i >= (long)R * C) return;
    const long r = i / C;
    const int c = (int)(i % C);
    const float* a = attn + r * N * C + c;
    float s = 0.0f;
    for (int n = 0; n < N; ++n) s += a[(long)n * C];
    float* o = out + r * N * C + c;
    for (int n = 0; n < N; ++n) o[(long)n * C] = s;
}

// the head widths the lab takes (those of fused_block.cu's lab)
constexpr int LAB_MAX_D = 128;

// Scratch of a lab launch, in floats: LN1's statistics (2 M); stages scores
// and exp2 the sink (a float a warp of the attention launch); stage full
// LN2's statistics (2 M), y (M C) and the MLP's hidden activation (M hidden).
size_t lab_scratch_floats(int R, int N, int C, int H, int hidden, int stage) {
    const size_t M = (size_t)R * N;
    if (stage == STAGE_SCORES || stage == STAGE_EXP2)
        return 2 * M + (size_t)R * ((N + AQ - 1) / AQ) * H * (ATT_THREADS / 32);
    if (stage == STAGE_FULL) return 4 * M + M * C + M * hidden;
    return 2 * M;
}

template <int FLAGS>
void attention_flags(const float* qkv, float* attn, int R, int N, int C, int H, cudaStream_t st) {
    attention<STAGE_FULL, FLAGS>(qkv, nullptr, nullptr, attn, nullptr, nullptr, R, N, C, H, st);
}

// The full attention with the flags (P_F32 ignored: p is never rounded)
void attention_with(int flags, const float* qkv, float* attn, int R, int N, int C, int H,
                    cudaStream_t st) {
    switch (flags & ~P_F32) {
        case SCORE_BF16: attention_flags<SCORE_BF16>(qkv, attn, R, N, C, H, st); break;
        case NO_CLAMP: attention_flags<NO_CLAMP>(qkv, attn, R, N, C, H, st); break;
        case SCORE_BF16 | NO_CLAMP:
            attention_flags<SCORE_BF16 | NO_CLAMP>(qkv, attn, R, N, C, H, st);
            break;
        default: attention_flags<0>(qkv, attn, R, N, C, H, st);
    }
}

int lab_forward(const float* x, const float* ln1_s, const float* ln1_b, const float* w_qkv,
                const float* w_o, const float* b_o, const float* ln2_s, const float* ln2_b,
                const float* w_1, const float* b_1, const float* w_2, const float* b_2,
                float* qkv, float* attn, float* out, float* scratch, int R, int N, int C, int H,
                int hidden, int stage, int flags, cudaStream_t st) {
    const long M = (long)R * N;
    F32_TRY(qkv_part(x, ln1_s, ln1_b, w_qkv, qkv, scratch, scratch + M, M, C, st));
    float* sink = scratch + 2 * M;
    switch (stage) {
        case STAGE_QKV: {
            const long total = M * C, blocks = (total + 255) / 256;
            LAUNCH(qkv_sum_kernel, (unsigned)(blocks < (1L << 20) ? blocks : 1L << 20), 256, st,
                   qkv, out, total, C);
            break;
        }
        case STAGE_SCORES: {
            attention<STAGE_SCORES, 0>(qkv, nullptr, nullptr, nullptr, nullptr, sink, R, N, C,
                                       H, st);
            const int kept = C < N ? C : N;
            const unsigned blocks = (unsigned)((long)R * ((N + KS_Q - 1) / KS_Q));
            auto* kernel = kept <= 32 ? kept_scores_kernel<1> : kept <= 64 ? kept_scores_kernel<2>
                           : kept <= 128 ? kept_scores_kernel<4> : kept_scores_kernel<8>;
            LAUNCH(kernel, blocks, KS_THREADS, st, qkv, out, N, C, C / H);
            break;
        }
        case STAGE_EXP2:
            attention<STAGE_EXP2, 0>(qkv, nullptr, nullptr, out, nullptr, sink, R, N, C, H, st);
            break;
        case STAGE_AV:
            attention<STAGE_FULL, 0>(qkv, nullptr, nullptr, attn, nullptr, nullptr, R, N, C, H,
                                     st);
            LAUNCH(av_sum_kernel, (unsigned)(((long)R * C + 127) / 128), 128, st, attn, out, R, N,
                   C);
            break;
        case STAGE_ATTN:
            attention_with(flags, qkv, attn, R, N, C, H, st);
            F32_TRY(gemm(plain_a(attn, C), w_o, C, out, C, M, C, C, epi(EPI_NONE, b_o, x, C),
                         st));
            break;
        default:          // full: B1's launches, the attention with the flags
            attention_with(flags, qkv, attn, R, N, C, H, st);
            F32_TRY(post(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                         scratch + 4 * M, scratch + 2 * M, scratch + 4 * M + M * C, out, M, C,
                         hidden, st));
    }
    return cudaGetLastError();
}

}  // namespace
}  // namespace f32

// B1 (den, scales and qk null), B1-train (den given: y is then mid) or B3
// (scales and qk given).  All f32 but qk (R N, 2C) int8.  Buffers:
// qkv (R N, 3C), stats (4 R N), y (R N, C), hbuf (R N, hidden), attn and
// out (R N, C), den (R, H, N), scales (R, 2).  Returns a CUDA error code.
extern "C" int fused_block_forward_f32(
    const float* x, const float* ln1_s, const float* ln1_b, const float* w_qkv,
    const float* w_o, const float* b_o, const float* ln2_s, const float* ln2_b,
    const float* w_1, const float* b_1, const float* w_2, const float* b_2,
    float* qkv, float* stats, float* y, float* hbuf, float* attn, float* out, float* den,
    float* scales, int8_t* qk, int R, int N, int C, int H, int hidden, void* stream) {
    if (R <= 0 || N <= 0 || H <= 0 || C <= 0 || C % 8 || C > 512 || C % H || hidden <= 0
        || (scales == nullptr) != (qk == nullptr)
        || (den != nullptr && qk != nullptr))
        return cudaErrorInvalidValue;
    return f32::forward(x, ln1_s, ln1_b, w_qkv, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2, qkv,
                        stats, y, hbuf, attn, out, den, scales, qk, R, N, C, H, hidden,
                        static_cast<cudaStream_t>(stream));
}

// The kernel lab L in f32: B1 f32 cut at stage (0 qkv, 1 scores, 2 exp2,
// 3 av, 4 attn, 5 full) with flags (1 score_bf16, 2 p_f32, 4 no clamp;
// attn and full only; p_f32 changes nothing in f32), as ops/lab_block.py's
// plain version computes them; out (R, N, C) f32.  The full form with no
// flag launches B1 f32's kernels in B1's order (its output B1's bits).
// qkv (R N, 3C) receives q|k|v; attn (R N, C) is needed by stages av, attn
// and full, scratch of fused_block_lab_scratch_bytes_f32 by every stage.
// Head widths up to 128 channels.  Returns a CUDA error code.
extern "C" size_t fused_block_lab_scratch_bytes_f32(int R, int N, int C, int H, int hidden,
                                                    int stage) {
    return f32::lab_scratch_floats(R, N, C, H, hidden, stage) * sizeof(float);
}

extern "C" int fused_block_lab_forward_f32(
    const float* x, const float* ln1_s, const float* ln1_b, const float* w_qkv,
    const float* w_o, const float* b_o, const float* ln2_s, const float* ln2_b,
    const float* w_1, const float* b_1, const float* w_2, const float* b_2, float* qkv,
    float* attn, float* out, float* scratch, int R, int N, int C, int H, int hidden, int stage,
    int flags, void* stream) {
    if (R <= 0 || N <= 0 || H <= 0 || C <= 0 || C % 8 || C > 512 || C % H || hidden <= 0
        || C / H > f32::LAB_MAX_D || stage < f32::STAGE_QKV || stage > f32::STAGE_FULL
        || flags < 0 || flags > 7 || (flags && stage < f32::STAGE_ATTN)
        || (stage == f32::STAGE_EXP2 && N < C / H) || (stage >= f32::STAGE_AV && !attn)
        || (stage == f32::STAGE_SCORES && (C < N ? C : N) > f32::KS_KEYS) || !scratch)
        return cudaErrorInvalidValue;
    return f32::lab_forward(x, ln1_s, ln1_b, w_qkv, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                            qkv, attn, out, scratch, R, N, C, H, hidden, stage, flags,
                            static_cast<cudaStream_t>(stream));
}
