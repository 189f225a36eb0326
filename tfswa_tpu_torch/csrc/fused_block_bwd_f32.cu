// Fused pre-LN row transformer block, backward (the whole block's VJP), in
// float32, for Hopper (sm_90a): the f32 form of B2.
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/fused_block.py
// _fused_block_bwd_kernel with cd = float32.  From the forward's inputs
// rows x, its residuals mid (y), acc and den (B1-train's f32 form) and the
// cotangent g, all (R, N, C) f32 but den (R, H, N), it computes dx and the
// 11 parameter gradients, recomputing LN1, q|k|v, LN2, fc1 and the scores:
//   h1pre = LN2(mid) @ W1 + b1;  d_h1pre = (g @ W2^T) * gelu'(h1pre)
//   d_mid = g + LN2's input gradient of d_n2 = d_h1pre @ W1^T
//   d_acc = d_mid @ Wo^T; per head r = 1 / den:
//     d_oe = d_acc * r, d_den = -r * sum_D(d_acc * acc)
//   s = q.k, p = exp2(min(s, 110)), d_p = d_oe.v + d_den,
//   d_s = (s < 110) * d_p * p * ln 2
//   d_q = sum_keys d_s k, d_k = sum_queries d_s q, d_v = sum_queries p d_oe
//   dx = d_mid + LN1's input gradient of d_normed = dqkv @ Wqkv'^T
//   weights: fc2 gelu(h1pre)^T g, fc1 LN2(mid)^T d_h1pre, Wo acc^T d_mid,
//   Wqkv' LN1(x)^T dqkv (its q columns re-scaled by the caller); vectors:
//   column sums of g, d_h1pre, d_n2 nhat2, d_n2, d_mid, d_normed nhat1,
//   d_normed.
//
// Design (see block_f32.cuh for the tile).  A chain of launches: LN2
// statistics, the three MLP products (gemm_kernel with GELU's derivative
// fused into the second's epilogue), LN2's input gradient (ln_bwd_kernel),
// d_acc, d_oe / d_den (attn_prep_kernel), LN1 statistics and q|k|v, the
// attention backward in two kernels (a query side owning d_q, a key side
// owning d_k and d_v, each recomputing s, p and d_p), d_normed and dx; then
// every weight gradient (atb_kernel) and vector (colsum_kernel) as partial
// sums over fixed slices of the tokens, added slice by slice in a fixed
// order (sum_parts_kernel).  No atomics: two runs give the same bits.  No
// (N, N) plane exists.  Every product runs in 3xTF32 on the tensor cores.
// The attention backward, one design per head width:
//   D <= 8 (attn_bwd_{q,kv}_ffma_kernel): a thread a query (a key), the
//       other side streaming through shared memory, everything on the CUDA
//       cores (as the forward's attn_ffma_kernel, for the same reason);
//   D > 8 (attn_bwd_{q,kv}_kernel<DC, WIDE>): a warp owns 16 tokens; the
//       scores as f32 FMA chains in channel order (chain_scores), so that
//       the clamp's mask s < 110, where d_s jumps by d_p p ln 2 with p =
//       2^110, is the plain version's on both sides; d_p = d_oe . v + d_den,
//       d_q += d_s k, d_k += d_s^T q and d_v += p^T d_oe in 3xTF32 (C
//       fragments of d_s and p re-used as A fragments); a head wider than
//       32 channels sums s and d_p over chunks of 32, the output in parts.
//
// What bounds it: the attention backward's pairs (at D <= 8 about 3 D FMAs
// and one exp2 each, twice: once per kernel) at the CUDA cores'
// instruction rate, and the products (about 48 C^2 FLOPs a token with the recompute)
// at 3xTF32's rate (at C = 32, their bytes).  Against a CUDA-core form for
// every D, the tensor-core forms take wide384's D = 48 and 96 attention
// backward from 561.9 to 354.8 ms a step; at D = 24 and 12 they are 3 and
// 7 % slower (153.5 -> 158.8, 469.6 -> 502.6), at the flagship's D = 16
// 6 % faster (72.6 -> 68.4; PERF.md).
#include "block_f32.cuh"

namespace f32 {
namespace {

constexpr int BQ = 64;            // own tokens a block: 4 warps of 16
constexpr int BT = 32;            // other-side tokens a staged tile: 4 n-tiles
constexpr int ATT_THREADS = 128;

// d_oe[m, h D + d] = d_acc * r, d_den[m, h] = -r * sum_d d_acc * acc, with
// r = 1 / den[r, h, n] for token m = r N + n; a thread a (token, head).
__global__ void __launch_bounds__(256)
attn_prep_kernel(const float* __restrict__ d_acc, const float* __restrict__ acc,
                 const float* __restrict__ den, long M, int N, int C, int H,
                 float* __restrict__ d_oe, float* __restrict__ d_den) {
    const long e = (long)blockIdx.x * 256 + threadIdx.x;
    if (e >= M * H) return;
    const long m = e / H;
    const int h = (int)(e % H), D = C / H;
    const float r = 1.0f / den[((m / N) * H + h) * N + m % N];
    float s = 0.0f;
    for (int d = 0; d < D; ++d) {
        const long i = m * C + h * D + d;
        d_oe[i] = d_acc[i] * r;
        s += d_acc[i] * acc[i];
    }
    d_den[m * H + h] = -r * s;
}

constexpr int QT = 128;   // queries (or keys) a block of the _ffma kernels
constexpr int KT = 128;   // keys (or queries) a shared-memory tile of them

// The two kernels for a head of at most 8 channels, on the CUDA cores (as
// the forward's attn_ffma_kernel, for the same reason: the tensor-core
// form ran them at 2.1x and 1.9x these forms' times at stage 0, PERF.md).
// dqkv[(r N + i) 3C + h D + d] = d_q: one block per (row, QT queries) and
// head, a thread a query; s, p and d_p as the FMA chains over d in order.
// DP: D rounded up to 4 or 8 (the operands zero past D).
template <int DP>
__global__ void __launch_bounds__(QT)
attn_bwd_q_ffma_kernel(const float* __restrict__ qkv, const float* __restrict__ d_oe,
                  const float* __restrict__ d_den, float* __restrict__ dqkv, int N, int C, int H,
                  int q_tiles) {
    __shared__ float ks[KT][DP];
    __shared__ float vs[KT][DP];
    const int D = C / H;
    const int r = blockIdx.x / q_tiles;
    const int i = (blockIdx.x % q_tiles) * QT + threadIdx.x;
    const int h = blockIdx.y;
    const long row0 = (long)r * N;
    const long C3 = 3L * C;
    const bool live = i < N;
    float q[DP], o[DP], dq[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
        q[d] = live && d < D ? qkv[(row0 + i) * C3 + h * D + d] : 0.0f;
        o[d] = live && d < D ? d_oe[(row0 + i) * C + h * D + d] : 0.0f;
        dq[d] = 0.0f;
    }
    const float dd = live ? d_den[(row0 + i) * H + h] : 0.0f;
    for (int j0 = 0; j0 < N; j0 += KT) {
        const int nk = N - j0 < KT ? N - j0 : KT;
        for (int e = threadIdx.x; e < nk * DP; e += QT) {
            const int j = e / DP, d = e % DP;
            const long t = row0 + j0 + j;
            ks[j][d] = d < D ? qkv[t * C3 + C + h * D + d] : 0.0f;
            vs[j][d] = d < D ? qkv[t * C3 + 2 * C + h * D + d] : 0.0f;
        }
        __syncthreads();
        auto key = [&](int j) {
            float s = 0.0f, dp = 0.0f;
#pragma unroll
            for (int d = 0; d < DP; ++d) {
                s = fmaf(q[d], ks[j][d], s);
                dp = fmaf(o[d], vs[j][d], dp);
            }
            const float p = exp2f(clamp_score(s));
            const float ds = s < SCORE_CLAMP ? (dp + dd) * p * LN2 : 0.0f;
#pragma unroll
            for (int d = 0; d < DP; ++d) dq[d] = fmaf(ds, ks[j][d], dq[d]);
        };
        if (live && nk == KT) {          // a full tile: a fixed trip count, unrolled
#pragma unroll 8
            for (int j = 0; j < KT; ++j) key(j);
        } else if (live) {
            for (int j = 0; j < nk; ++j) key(j);
        }
        __syncthreads();
    }
    if (live) {
#pragma unroll
        for (int d = 0; d < DP; ++d)
            if (d < D) dqkv[(row0 + i) * C3 + h * D + d] = dq[d];
    }
}

// dqkv's d_k and d_v columns: one block per (row, QT keys) and head, a
// thread a key; the queries' q, d_oe and d_den stream through shared memory.
template <int DP>
__global__ void __launch_bounds__(QT)
attn_bwd_kv_ffma_kernel(const float* __restrict__ qkv, const float* __restrict__ d_oe,
                   const float* __restrict__ d_den, float* __restrict__ dqkv, int N, int C,
                   int H, int k_tiles) {
    __shared__ float qs[KT][DP];
    __shared__ float os[KT][DP];
    __shared__ float ds_[KT];
    const int D = C / H;
    const int r = blockIdx.x / k_tiles;
    const int j = (blockIdx.x % k_tiles) * QT + threadIdx.x;
    const int h = blockIdx.y;
    const long row0 = (long)r * N;
    const long C3 = 3L * C;
    const bool live = j < N;
    float k[DP], v[DP], dk[DP], dv[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
        k[d] = live && d < D ? qkv[(row0 + j) * C3 + C + h * D + d] : 0.0f;
        v[d] = live && d < D ? qkv[(row0 + j) * C3 + 2 * C + h * D + d] : 0.0f;
        dk[d] = 0.0f;
        dv[d] = 0.0f;
    }
    for (int i0 = 0; i0 < N; i0 += KT) {
        const int nq = N - i0 < KT ? N - i0 : KT;
        for (int e = threadIdx.x; e < nq * DP; e += QT) {
            const int i = e / DP, d = e % DP;
            const long t = row0 + i0 + i;
            qs[i][d] = d < D ? qkv[t * C3 + h * D + d] : 0.0f;
            os[i][d] = d < D ? d_oe[t * C + h * D + d] : 0.0f;
        }
        for (int i = threadIdx.x; i < nq; i += QT) ds_[i] = d_den[(row0 + i0 + i) * H + h];
        __syncthreads();
        auto query = [&](int i) {
            float s = 0.0f, dp = 0.0f;
#pragma unroll
            for (int d = 0; d < DP; ++d) {
                s = fmaf(qs[i][d], k[d], s);
                dp = fmaf(os[i][d], v[d], dp);
            }
            const float p = exp2f(clamp_score(s));
            const float ds = s < SCORE_CLAMP ? (dp + ds_[i]) * p * LN2 : 0.0f;
#pragma unroll
            for (int d = 0; d < DP; ++d) {
                dk[d] = fmaf(ds, qs[i][d], dk[d]);
                dv[d] = fmaf(p, os[i][d], dv[d]);
            }
        };
        if (live && nq == KT) {          // a full tile: a fixed trip count, unrolled
#pragma unroll 8
            for (int i = 0; i < KT; ++i) query(i);
        } else if (live) {
            for (int i = 0; i < nq; ++i) query(i);
        }
        __syncthreads();
    }
    if (live) {
#pragma unroll
        for (int d = 0; d < DP; ++d) {
            if (d >= D) continue;
            dqkv[(row0 + j) * C3 + C + h * D + d] = dk[d];
            dqkv[(row0 + j) * C3 + 2 * C + h * D + d] = dv[d];
        }
    }
}

// dqkv[(r N + i) 3C + h D + v0 + d] = d_q for the part's channels d < DC:
// grid (R * tiles, H, parts), 128 threads, a warp owning 16 queries (their
// q rows and split d_oe fragments in registers), the keys' k (raw and
// split) and v staged BT at a time; s = q . k as the FMA chain
// (chain_scores), d_p = d_oe . v + d_den on the tensor cores, then d_s and
// d_q += d_s k on them.  DC and WIDE as in the forward's attn_kernel: a
// head wider than 32 channels sums s and d_p over chunks of 32 and stages
// the part's k channels for d_q.
template <int DC, bool WIDE>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_q_kernel(const float* __restrict__ qkv, const float* __restrict__ d_oe,
                  const float* __restrict__ d_den, float* __restrict__ dqkv, int N, int C, int H,
                  int tiles) {
    constexpr int KS = DC / 8;
    __shared__ Staged<BT, DC> ks;
    __shared__ Staged<BT, DC> vs;
    __shared__ __align__(16) float kr[BT][DC + 4];
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
    const int D = C / H, r = blockIdx.x / tiles, h = blockIdx.y, v0 = blockIdx.z * DC;
    const int i0 = (blockIdx.x % tiles) * BQ + warp * 16;
    const long row0 = (long)r * N, C3 = 3L * C;
    const int chunks = WIDE ? (D + DC - 1) / DC : 1;
    const float* qrow = qkv + row0 * C3 + h * D;
    const float* orow = d_oe + row0 * C + h * D;
    float qo[2][DC];
    uint32_t oa[KS][2][4];
    auto load_own = [&](int c0) {
        const int dc = imin(DC, D - c0);
        own_rows(qo, qrow + c0, C3, i0, N, dc);
#pragma unroll
        for (int k8 = 0; k8 < KS; ++k8) frag_a(oa[k8], orow + c0, C, i0, N, 8 * k8, dc);
    };
    if (!WIDE) load_own(0);
    float dd[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + g + 8 * hh;
        dd[hh] = i < N ? d_den[(row0 + i) * H + h] : 0.0f;
    }
    const int vd = imin(DC, D - v0);
    float dq[KS][4] = {};
    for (int j0 = 0; j0 < N; j0 += BT) {
        const int nk = imin(BT, N - j0);
        const float* kb = qkv + (row0 + j0) * C3 + C + h * D;     // key j's k; its v at + C
        float s[4][4] = {}, dp[4][4] = {};
        for (int c = 0; c < chunks; ++c) {
            const int c0 = c * DC, dc = imin(DC, D - c0);
            __syncthreads();
            stage_raw<ATT_THREADS>(kr, kb + c0, C3, nk, dc);
            if (!WIDE) stage<ATT_THREADS>(ks, kb, C3, nk, dc);
            stage<ATT_THREADS>(vs, kb + C + c0, C3, nk, dc);
            __syncthreads();
            if (WIDE) load_own(c0);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                chain_scores(s[nt], qo, kr, nt * 8);
#pragma unroll
                for (int k8 = 0; k8 < KS; ++k8) {
                    uint32_t b[2][2];
                    frag_row(b, vs, nt * 8, 8 * k8);
                    mma3(dp[nt], oa[k8], b);
                }
            }
        }
        if (WIDE) {
            __syncthreads();
            stage<ATT_THREADS>(ks, kb + v0, C3, nk, vd);
            __syncthreads();
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(clamp_score(s[nt][e]));
                ds[e] = nt * 8 + 2 * t + (e & 1) < nk && s[nt][e] < SCORE_CLAMP
                            ? (dp[nt][e] + dd[e >> 1]) * p * LN2 : 0.0f;
            }
            uint32_t da[2][4];
            frag_from_c(da, ds);
#pragma unroll
            for (int c8 = 0; c8 < KS; ++c8) {
                uint32_t b[2][2];
                frag_col(b, ks, nt * 8, 8 * c8);
                mma3(dq[c8], da, b);
            }
        }
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
                if (d < vd) dqkv[(row0 + i) * C3 + h * D + v0 + d] = dq[c8][2 * hh + j];
            }
    }
}

// dqkv's d_k and d_v columns for the part's channels: a warp owning 16 keys
// (their k rows and split v fragments in registers), the queries' q (raw
// and split), d_oe and d_den staged BT at a time; s^T = k . q as the FMA
// chain (the same chain as attn_bwd_q_kernel's, so both take the same side
// of the clamp), d_p^T = v . d_oe on the tensor cores, then d_s and p, d_k
// += d_s^T q and d_v += p^T d_oe on them.
template <int DC, bool WIDE>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_kv_kernel(const float* __restrict__ qkv, const float* __restrict__ d_oe,
                   const float* __restrict__ d_den, float* __restrict__ dqkv, int N, int C,
                   int H, int tiles) {
    constexpr int KS = DC / 8;
    __shared__ Staged<BT, DC> qs;
    __shared__ Staged<BT, DC> os;
    __shared__ __align__(16) float qr[BT][DC + 4];
    __shared__ float dds[BT];
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
    const int D = C / H, r = blockIdx.x / tiles, h = blockIdx.y, v0 = blockIdx.z * DC;
    const int j0w = (blockIdx.x % tiles) * BQ + warp * 16;
    const long row0 = (long)r * N, C3 = 3L * C;
    const int chunks = WIDE ? (D + DC - 1) / DC : 1;
    const float* krow = qkv + row0 * C3 + C + h * D;
    float ko[2][DC];
    uint32_t va[KS][2][4];
    auto load_own = [&](int c0) {
        const int dc = imin(DC, D - c0);
        own_rows(ko, krow + c0, C3, j0w, N, dc);
#pragma unroll
        for (int k8 = 0; k8 < KS; ++k8) frag_a(va[k8], krow + C + c0, C3, j0w, N, 8 * k8, dc);
    };
    if (!WIDE) load_own(0);
    const int vd = imin(DC, D - v0);
    float dk[KS][4] = {}, dv[KS][4] = {};
    for (int q0 = 0; q0 < N; q0 += BT) {
        const int nq = imin(BT, N - q0);
        const float* qb = qkv + (row0 + q0) * C3 + h * D;
        const float* ob = d_oe + (row0 + q0) * C + h * D;
        float s[4][4] = {}, dp[4][4] = {};
        for (int c = 0; c < chunks; ++c) {
            const int c0 = c * DC, dc = imin(DC, D - c0);
            __syncthreads();
            stage_raw<ATT_THREADS>(qr, qb + c0, C3, nq, dc);
            if (!WIDE) {
                stage<ATT_THREADS>(qs, qb, C3, nq, dc);
                stage<ATT_THREADS>(os, ob, C, nq, dc);
            }
            if (c == 0)
                for (int i = threadIdx.x; i < BT; i += ATT_THREADS)
                    dds[i] = i < nq ? d_den[(row0 + q0 + i) * H + h] : 0.0f;
            if (WIDE) stage<ATT_THREADS>(os, ob + c0, C, nq, dc);
            __syncthreads();
            if (WIDE) load_own(c0);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                chain_scores(s[nt], ko, qr, nt * 8);
#pragma unroll
                for (int k8 = 0; k8 < KS; ++k8) {
                    uint32_t b[2][2];
                    frag_row(b, os, nt * 8, 8 * k8);
                    mma3(dp[nt], va[k8], b);
                }
            }
        }
        if (WIDE) {
            __syncthreads();
            stage<ATT_THREADS>(qs, qb + v0, C3, nq, vd);
            stage<ATT_THREADS>(os, ob + v0, C, nq, vd);
            __syncthreads();
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            float ds[4], pv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = nt * 8 + 2 * t + (e & 1);
                const float p = exp2f(clamp_score(s[nt][e]));
                pv[e] = i < nq ? p : 0.0f;
                ds[e] = i < nq && s[nt][e] < SCORE_CLAMP ? (dp[nt][e] + dds[i]) * p * LN2 : 0.0f;
            }
            uint32_t da[2][4], pa[2][4];
            frag_from_c(da, ds);
            frag_from_c(pa, pv);
#pragma unroll
            for (int c8 = 0; c8 < KS; ++c8) {
                uint32_t b[2][2];
                frag_col(b, qs, nt * 8, 8 * c8);
                mma3(dk[c8], da, b);
                frag_col(b, os, nt * 8, 8 * c8);
                mma3(dv[c8], pa, b);
            }
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int j = j0w + g + 8 * hh;
        if (j >= N) continue;
#pragma unroll
        for (int c8 = 0; c8 < KS; ++c8)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int d = 8 * c8 + 2 * t + u;
                if (d >= vd) continue;
                dqkv[(row0 + j) * C3 + C + h * D + v0 + d] = dk[c8][2 * hh + u];
                dqkv[(row0 + j) * C3 + 2 * C + h * D + v0 + d] = dv[c8][2 * hh + u];
            }
    }
}

template <int DP>
void launch_attn_bwd_ffma(const float* qkv, const float* d_oe, const float* d_den, float* dqkv,
                          int R, int N, int C, int H, cudaStream_t st) {
    const int tiles = (N + QT - 1) / QT;
    const dim3 grid((unsigned)((long)R * tiles), (unsigned)H);
    LAUNCH(attn_bwd_q_ffma_kernel<DP>, grid, QT, st, qkv, d_oe, d_den, dqkv, N, C, H, tiles);
    LAUNCH(attn_bwd_kv_ffma_kernel<DP>, grid, QT, st, qkv, d_oe, d_den, dqkv, N, C, H, tiles);
}

template <int DC, bool WIDE>
void launch_attn_bwd(const float* qkv, const float* d_oe, const float* d_den, float* dqkv, int R,
                     int N, int C, int H, cudaStream_t st) {
    const int tiles = (N + BQ - 1) / BQ;
    const dim3 grid((unsigned)((long)R * tiles), (unsigned)H,
                    WIDE ? (unsigned)((C / H + DC - 1) / DC) : 1u);
    auto* q = attn_bwd_q_kernel<DC, WIDE>;
    auto* kv = attn_bwd_kv_kernel<DC, WIDE>;
    LAUNCH(q, grid, ATT_THREADS, st, qkv, d_oe, d_den, dqkv, N, C, H, tiles);
    LAUNCH(kv, grid, ATT_THREADS, st, qkv, d_oe, d_den, dqkv, N, C, H, tiles);
}

// The attention backward: dqkv (R N, 3C) from q|k|v (R N, 3C), d_oe (R N,
// C) and d_den (R N, H), all f32.
void attn_backward(const float* qkv, const float* d_oe, const float* d_den, float* dqkv, int R,
                   int N, int C, int H, cudaStream_t st) {
    const int D = C / H;
    if (D <= 4) launch_attn_bwd_ffma<4>(qkv, d_oe, d_den, dqkv, R, N, C, H, st);
    else if (D <= 8) launch_attn_bwd_ffma<8>(qkv, d_oe, d_den, dqkv, R, N, C, H, st);
    else if (D <= 16) launch_attn_bwd<16, false>(qkv, d_oe, d_den, dqkv, R, N, C, H, st);
    else if (D <= 32) launch_attn_bwd<32, false>(qkv, d_oe, d_den, dqkv, R, N, C, H, st);
    else launch_attn_bwd<32, true>(qkv, d_oe, d_den, dqkv, R, N, C, H, st);
}

// The scratch, in floats, each region a multiple of 64 floats (256 bytes).
enum Region { STATS, H1P, DH, DN2, DMID, DACC, DOE, DDEN, QKV, DQKV, DNRM, PART, REGIONS };

// The 11 gradient leaves' offsets in the grads buffer, in RowBlockParams
// order: ln1_s, ln1_b, W_qkv (C, 3C), W_o (C, C), b_o, ln2_s, ln2_b, W_1
// (C, hidden), b_1, W_2 (hidden, C), b_2.
struct Leaves {
    long off[12];
};

Leaves leaves(int C, int hidden) {
    const long sizes[11] = {C, C, 3L * C * C, (long)C * C, C, C, C, (long)C * hidden, hidden,
                            (long)hidden * C, C};
    Leaves l;
    l.off[0] = 0;
    for (int i = 0; i < 11; ++i) l.off[i + 1] = l.off[i] + sizes[i];
    return l;
}

// at most 256 MB of partial sums
Slices grad_slices(long M, int C, int hidden) {
    return token_slices(M, (64L << 20) / leaves(C, hidden).off[11]);
}

void regions(long M, int C, int H, int hidden, long* off) {
    const long total = leaves(C, hidden).off[11];
    const long sizes[REGIONS] = {4 * M, M * hidden, M * hidden, M * C, M * C, M * C, M * C,
                                 M * H, 3 * M * C, 3 * M * C, M * C,
                                 (long)grad_slices(M, C, hidden).parts * total};
    long at = 0;
    for (int i = 0; i < REGIONS; ++i) {
        off[i] = at;
        at += (sizes[i] + 63) / 64 * 64;
    }
    off[REGIONS] = at;
}

int backward(const float* x, const float* mid, const float* acc, const float* den,
             const float* g, const float* ln1_s, const float* ln1_b, const float* w_qkv,
             const float* w_qkv_t, const float* w_o_t, const float* ln2_s, const float* ln2_b,
             const float* w_1, const float* w_1_t, const float* b_1, const float* w_2_t,
             float* scratch, float* dx, float* grads, int R, int N, int C, int H, int hidden,
             cudaStream_t st) {
    const long M = (long)R * N;
    long off[REGIONS + 1];
    regions(M, C, H, hidden, off);
    float* at[REGIONS];
    for (int i = 0; i < REGIONS; ++i) at[i] = scratch + off[i];
    float *mean1 = at[STATS], *rstd1 = mean1 + M, *mean2 = mean1 + 2 * M, *rstd2 = mean1 + 3 * M;
    float *h1p = at[H1P], *dh = at[DH], *dn2 = at[DN2], *dmid = at[DMID], *dacc = at[DACC];
    float *doe = at[DOE], *dden = at[DDEN], *qkv = at[QKV], *dqkv = at[DQKV], *dnrm = at[DNRM];
    const int C3 = 3 * C;

    // the MLP half
    ln_stats(mid, M, C, mean2, rstd2, st);
    F32_TRY(gemm(ln_a(mid, C, mean2, rstd2, ln2_s, ln2_b), w_1, hidden, h1p, hidden, M, hidden,
                 C, epi(EPI_NONE, b_1), st));
    F32_TRY(gemm(plain_a(g, C), w_2_t, hidden, dh, hidden, M, hidden, C,
                 epi(EPI_GELU_GRAD, nullptr, nullptr, 0, h1p, hidden), st));
    F32_TRY(gemm(plain_a(dh, hidden), w_1_t, C, dn2, C, M, C, hidden, epi(), st));
    LAUNCH(ln_bwd_kernel, row_grid(M), ROW_WARPS * 32, st, dn2, mid, mean2, rstd2, ln2_s, g, dmid,
           (int)M, C);
    // the attention half
    F32_TRY(gemm(plain_a(dmid, C), w_o_t, C, dacc, C, M, C, C, epi(), st));
    LAUNCH(attn_prep_kernel, (unsigned)((M * H + 255) / 256), 256, st, dacc, acc, den, M, N, C, H,
           doe, dden);
    ln_stats(x, M, C, mean1, rstd1, st);
    F32_TRY(gemm(ln_a(x, C, mean1, rstd1, ln1_s, ln1_b), w_qkv, C3, qkv, C3, M, C3, C, epi(),
                 st));
    attn_backward(qkv, doe, dden, dqkv, R, N, C, H, st);
    F32_TRY(gemm(plain_a(dqkv, C3), w_qkv_t, C, dnrm, C, M, C, C3, epi(), st));
    LAUNCH(ln_bwd_kernel, row_grid(M), ROW_WARPS * 32, st, dnrm, x, mean1, rstd1, ln1_s, dmid, dx,
           (int)M, C);

    // the parameter gradients: partial sums over token slices, then added
    const Leaves l = leaves(C, hidden);
    const long total = l.off[11];
    const Slices sl = grad_slices(M, C, hidden);
    float* part = at[PART];
    auto atb_leaf = [&](const Operand& a, const float* b, int ldb, int K1, int K2, int leaf) {
        atb(a, b, ldb, M, K1, K2, sl.parts, sl.chunk, part + l.off[leaf], total, st);
    };
    auto colsum = [&](const float* xs, int ldx, const float* ys, const float* mu,
                      const float* rs, int K, int leaf) {
        const dim3 grid((unsigned)((K + 255) / 256), (unsigned)sl.parts);
        LAUNCH(colsum_kernel, grid, 256, st, xs, ldx, ys, ldx, mu, rs, (int)M, K, sl.chunk,
               part + l.off[leaf], total);
    };
    atb_leaf(ln_a(x, C, mean1, rstd1, ln1_s, ln1_b), dqkv, C3, C, C3, 2);
    atb_leaf(plain_a(acc, C), dmid, C, C, C, 3);
    atb_leaf(ln_a(mid, C, mean2, rstd2, ln2_s, ln2_b), dh, hidden, C, hidden, 7);
    atb_leaf(Operand{h1p, hidden, AOP_GELU, nullptr, nullptr, nullptr, nullptr}, g, C, hidden, C,
             9);
    colsum(dnrm, C, x, mean1, rstd1, C, 0);
    colsum(dnrm, C, nullptr, nullptr, nullptr, C, 1);
    colsum(dmid, C, nullptr, nullptr, nullptr, C, 4);
    colsum(dn2, C, mid, mean2, rstd2, C, 5);
    colsum(dn2, C, nullptr, nullptr, nullptr, C, 6);
    colsum(dh, hidden, nullptr, nullptr, nullptr, hidden, 8);
    colsum(g, C, nullptr, nullptr, nullptr, C, 10);
    LAUNCH(sum_parts_kernel, (unsigned)((total + 255) / 256), 256, st, part, sl.parts, total,
           total, grads);
    return cudaGetLastError();
}

}  // namespace
}  // namespace f32

extern "C" size_t fused_block_backward_f32_scratch_bytes(int R, int N, int C, int H, int hidden) {
    long off[f32::REGIONS + 1];
    f32::regions((long)R * N, C, H, hidden, off);
    return (size_t)off[f32::REGIONS] * sizeof(float);
}

// Byte offsets in the scratch of d_oe (R N, C), d_den (R N, H) and dqkv
// (R N, 3C), all f32.
extern "C" void fused_block_backward_f32_part_offsets(int R, int N, int C, int H, int hidden,
                                                      size_t* out) {
    long off[f32::REGIONS + 1];
    f32::regions((long)R * N, C, H, hidden, off);
    out[0] = (size_t)off[f32::DOE] * sizeof(float);
    out[1] = (size_t)off[f32::DDEN] * sizeof(float);
    out[2] = (size_t)off[f32::DQKV] * sizeof(float);
}

// The attention backward alone (dqkv from q|k|v, d_oe and d_den, all f32 in
// the layouts above): a test entry point.  Returns a CUDA error code.
extern "C" int fused_block_attn_backward_f32(const float* qkv, const float* d_oe,
                                             const float* d_den, float* dqkv, int R, int N,
                                             int C, int H, void* stream) {
    if (R <= 0 || N <= 0 || H <= 0 || C <= 0 || C % 8 || C > 512 || C % H)
        return cudaErrorInvalidValue;
    f32::attn_backward(qkv, d_oe, d_den, dqkv, R, N, C, H, static_cast<cudaStream_t>(stream));
    return cudaGetLastError();
}

// dx (R, N, C) and the 11 gradients, concatenated in RowBlockParams order,
// from f32 inputs (the weights as fused_block_backward takes them: W_qkv
// with its q columns pre-scaled, and transposed copies).  Returns a CUDA
// error code.
extern "C" int fused_block_backward_f32(
    const float* x, const float* mid, const float* acc, const float* den, const float* g,
    const float* ln1_s, const float* ln1_b, const float* w_qkv, const float* w_qkv_t,
    const float* w_o_t, const float* ln2_s, const float* ln2_b, const float* w_1,
    const float* w_1_t, const float* b_1, const float* w_2_t, void* scratch, float* dx,
    float* grads, int R, int N, int C, int H, int hidden, void* stream) {
    if (R <= 0 || N <= 0 || H <= 0 || C <= 0 || C % 8 || C > 512 || C % H || hidden <= 0
        || !scratch)
        return cudaErrorInvalidValue;
    return f32::backward(x, mid, acc, den, g, ln1_s, ln1_b, w_qkv, w_qkv_t, w_o_t, ln2_s, ln2_b,
                         w_1, w_1_t, b_1, w_2_t, static_cast<float*>(scratch), dx, grads, R, N,
                         C, H, hidden, static_cast<cudaStream_t>(stream));
}
