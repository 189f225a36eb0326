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
// Design (every product f32 FFMA, see block_f32.cuh).  A chain of launches:
// LN2 statistics, the three MLP products (gemm_kernel with GELU's
// derivative fused into the second's epilogue), LN2's input gradient
// (ln_bwd_kernel), d_acc, d_oe / d_den (attn_prep_kernel), LN1 statistics
// and q|k|v, the attention backward in two kernels (attn_bwd_q_kernel: a
// thread a query, its d_q summed over the keys streamed through shared
// memory; attn_bwd_kv_kernel: a thread a key, its d_k and d_v summed over
// the queries streamed through shared memory; each recomputes s, p and
// d_p), d_normed and dx; then every weight gradient (atb_kernel) and
// vector (colsum_kernel) as partial sums over fixed slices of the tokens,
// added slice by slice in a fixed order (sum_parts_kernel).  No atomics:
// two runs give the same bits.  No (N, N) plane exists.  The attention
// kernels hold a head's D channels (rounded up to 4, 8, 16 or 32, zeros
// past D) in registers; a head wider than 32 channels runs their _wide
// forms, the output in parts of 32 channels whose blocks sum s and d_p
// over the head's channels 32 at a time.
//
// What bounds it: the attention backward's pairs (about 4 D FFMA and one
// exp2 each, twice: once per kernel) at the CUDA cores' issue rate, and
// the products (about 48 C^2 FLOPs a token with the recompute) at the FFMA
// rate.
#include "block_f32.cuh"

namespace f32 {
namespace {

constexpr int QT = 128;   // queries (or keys) a block
constexpr int KT = 128;   // keys (or queries) a shared-memory tile

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

// dqkv[(r N + i) 3C + h D + d] = d_q: one block per (row, QT queries) and
// head, a thread a query.  DP: the head dim D rounded up to 4, 8, 16 or 32
// (the operands zero past D).
template <int DP>
__global__ void __launch_bounds__(QT)
attn_bwd_q_kernel(const float* __restrict__ qkv, const float* __restrict__ d_oe,
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
        if (live) {
            for (int j = 0; j < nk; ++j) {
                float s = 0.0f, dp = 0.0f;
#pragma unroll
                for (int d = 0; d < DP; ++d) {
                    s = fmaf(q[d], ks[j][d], s);
                    dp = fmaf(o[d], vs[j][d], dp);
                }
                const float p = exp2f(fminf(s, SCORE_CLAMP));
                const float ds = s < SCORE_CLAMP ? (dp + dd) * p * LN2 : 0.0f;
#pragma unroll
                for (int d = 0; d < DP; ++d) dq[d] = fmaf(ds, ks[j][d], dq[d]);
            }
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
attn_bwd_kv_kernel(const float* __restrict__ qkv, const float* __restrict__ d_oe,
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
        if (live) {
            for (int i = 0; i < nq; ++i) {
                float s = 0.0f, dp = 0.0f;
#pragma unroll
                for (int d = 0; d < DP; ++d) {
                    s = fmaf(qs[i][d], k[d], s);
                    dp = fmaf(os[i][d], v[d], dp);
                }
                const float p = exp2f(fminf(s, SCORE_CLAMP));
                const float ds = s < SCORE_CLAMP ? (dp + ds_[i]) * p * LN2 : 0.0f;
#pragma unroll
                for (int d = 0; d < DP; ++d) {
                    dk[d] = fmaf(ds, qs[i][d], dk[d]);
                    dv[d] = fmaf(p, os[i][d], dv[d]);
                }
            }
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

// The two kernels for a head wider than 32 channels (D up to 512): the
// output in parts of WCH channels (grid.z), each part's block streaming the
// other side WKT tokens at a time; s and d_p summed over the head's
// channels WCH at a time in order (the own token's channels read from
// device memory, the other side's through shared memory: the FMA chains of
// the kernels above), then the part's channels of the other side staged
// for the output sums.  Each part recomputes s, d_p and p.
constexpr int WKT = 32;   // other-side tokens a tile
constexpr int WCH = 32;   // channels a chunk, and an output part

// s[j] and dp[j] of the own token (a, e: its rows of the two tensors at
// the head's channel 0, or null) against the tile's WKT other-side tokens
// t0 .. (b, f: their rows at the head's channel 0, row strides ldb, ldf),
// tokens past n_in as zeros.  All threads of the block.
__device__ __forceinline__ void wide_scores(float (&s)[WKT], float (&dp)[WKT], const float* a,
                                            const float* e, const float* b, long ldb,
                                            const float* f, long ldf, int n_in, int D,
                                            float (*xs)[WCH], float (*ys)[WCH]) {
    for (int j = 0; j < WKT; ++j) s[j] = dp[j] = 0.0f;
    for (int c0 = 0; c0 < D; c0 += WCH) {
        __syncthreads();
        for (int i = threadIdx.x; i < WKT * WCH; i += QT) {
            const int j = i / WCH, d = i % WCH;
            const bool in = j < n_in && c0 + d < D;
            xs[j][d] = in ? b[j * ldb + c0 + d] : 0.0f;
            ys[j][d] = in ? f[j * ldf + c0 + d] : 0.0f;
        }
        __syncthreads();
        float ac[WCH], ec[WCH];
        for (int d = 0; d < WCH; ++d) {
            ac[d] = a && c0 + d < D ? a[c0 + d] : 0.0f;
            ec[d] = a && c0 + d < D ? e[c0 + d] : 0.0f;
        }
        for (int j = 0; j < WKT; ++j)
            for (int d = 0; d < WCH; ++d) {
                s[j] = fmaf(ac[d], xs[j][d], s[j]);
                dp[j] = fmaf(ec[d], ys[j][d], dp[j]);
            }
    }
    __syncthreads();
}

__global__ void __launch_bounds__(QT)
attn_bwd_q_wide_kernel(const float* __restrict__ qkv, const float* __restrict__ d_oe,
                       const float* __restrict__ d_den, float* __restrict__ dqkv, int N, int C,
                       int H, int q_tiles) {
    __shared__ float xs[WKT][WCH];
    __shared__ float ys[WKT][WCH];
    const int D = C / H, v0 = blockIdx.z * WCH;
    const int r = blockIdx.x / q_tiles;
    const int i = (blockIdx.x % q_tiles) * QT + threadIdx.x;
    const int h = blockIdx.y;
    const long row0 = (long)r * N;
    const long C3 = 3L * C;
    const bool live = i < N;
    const float* qa = live ? qkv + (row0 + i) * C3 + h * D : nullptr;
    const float* oa = live ? d_oe + (row0 + i) * C + h * D : nullptr;
    const float dd = live ? d_den[(row0 + i) * H + h] : 0.0f;
    float dq[WCH];
    for (int d = 0; d < WCH; ++d) dq[d] = 0.0f;
    for (int j0 = 0; j0 < N; j0 += WKT) {
        const int nk = N - j0 < WKT ? N - j0 : WKT;
        const float* kb = qkv + (row0 + j0) * C3 + C + h * D;
        float s[WKT], dp[WKT];
        wide_scores(s, dp, qa, oa, kb, C3, kb + C, C3, nk, D, xs, ys);
        for (int e = threadIdx.x; e < WKT * WCH; e += QT) {
            const int j = e / WCH, d = e % WCH;
            xs[j][d] = j < nk && v0 + d < D ? kb[j * C3 + v0 + d] : 0.0f;
        }
        __syncthreads();
        if (live) {
            for (int j = 0; j < nk; ++j) {
                const float p = exp2f(fminf(s[j], SCORE_CLAMP));
                const float ds = s[j] < SCORE_CLAMP ? (dp[j] + dd) * p * LN2 : 0.0f;
                for (int d = 0; d < WCH; ++d) dq[d] = fmaf(ds, xs[j][d], dq[d]);
            }
        }
    }
    if (live) {
        for (int d = 0; d < WCH; ++d)
            if (v0 + d < D) dqkv[(row0 + i) * C3 + h * D + v0 + d] = dq[d];
    }
}

__global__ void __launch_bounds__(QT)
attn_bwd_kv_wide_kernel(const float* __restrict__ qkv, const float* __restrict__ d_oe,
                        const float* __restrict__ d_den, float* __restrict__ dqkv, int N, int C,
                        int H, int k_tiles) {
    __shared__ float xs[WKT][WCH];
    __shared__ float ys[WKT][WCH];
    __shared__ float ds_[WKT];
    const int D = C / H, v0 = blockIdx.z * WCH;
    const int r = blockIdx.x / k_tiles;
    const int j = (blockIdx.x % k_tiles) * QT + threadIdx.x;
    const int h = blockIdx.y;
    const long row0 = (long)r * N;
    const long C3 = 3L * C;
    const bool live = j < N;
    const float* ka = live ? qkv + (row0 + j) * C3 + C + h * D : nullptr;
    const float* va = live ? qkv + (row0 + j) * C3 + 2 * C + h * D : nullptr;
    float dk[WCH], dv[WCH];
    for (int d = 0; d < WCH; ++d) dk[d] = dv[d] = 0.0f;
    for (int i0 = 0; i0 < N; i0 += WKT) {
        const int nq = N - i0 < WKT ? N - i0 : WKT;
        const float* qb = qkv + (row0 + i0) * C3 + h * D;
        const float* ob = d_oe + (row0 + i0) * C + h * D;
        float s[WKT], dp[WKT];
        wide_scores(s, dp, ka, va, qb, C3, ob, C, nq, D, xs, ys);
        for (int e = threadIdx.x; e < WKT * WCH; e += QT) {
            const int i = e / WCH, d = e % WCH;
            const bool in = i < nq && v0 + d < D;
            xs[i][d] = in ? qb[i * C3 + v0 + d] : 0.0f;
            ys[i][d] = in ? ob[i * C + v0 + d] : 0.0f;
        }
        for (int i = threadIdx.x; i < WKT; i += QT)
            ds_[i] = i < nq ? d_den[(row0 + i0 + i) * H + h] : 0.0f;
        __syncthreads();
        if (live) {
            for (int i = 0; i < nq; ++i) {
                const float p = exp2f(fminf(s[i], SCORE_CLAMP));
                const float ds = s[i] < SCORE_CLAMP ? (dp[i] + ds_[i]) * p * LN2 : 0.0f;
                for (int d = 0; d < WCH; ++d) {
                    dk[d] = fmaf(ds, xs[i][d], dk[d]);
                    dv[d] = fmaf(p, ys[i][d], dv[d]);
                }
            }
        }
    }
    if (live) {
        for (int d = 0; d < WCH; ++d) {
            if (v0 + d >= D) continue;
            dqkv[(row0 + j) * C3 + C + h * D + v0 + d] = dk[d];
            dqkv[(row0 + j) * C3 + 2 * C + h * D + v0 + d] = dv[d];
        }
    }
}

template <int DP>
void launch_attn_bwd(const float* qkv, const float* d_oe, const float* d_den, float* dqkv, int R,
                     int N, int C, int H, cudaStream_t st) {
    const int tiles = (N + QT - 1) / QT;
    const dim3 grid((unsigned)((long)R * tiles), (unsigned)H);
    LAUNCH(attn_bwd_q_kernel<DP>, grid, QT, st, qkv, d_oe, d_den, dqkv, N, C, H, tiles);
    LAUNCH(attn_bwd_kv_kernel<DP>, grid, QT, st, qkv, d_oe, d_den, dqkv, N, C, H, tiles);
}

void launch_attn_bwd_wide(const float* qkv, const float* d_oe, const float* d_den, float* dqkv,
                          int R, int N, int C, int H, cudaStream_t st) {
    const int tiles = (N + QT - 1) / QT;
    const dim3 grid((unsigned)((long)R * tiles), (unsigned)H,
                    (unsigned)((C / H + WCH - 1) / WCH));
    LAUNCH(attn_bwd_q_wide_kernel, grid, QT, st, qkv, d_oe, d_den, dqkv, N, C, H, tiles);
    LAUNCH(attn_bwd_kv_wide_kernel, grid, QT, st, qkv, d_oe, d_den, dqkv, N, C, H, tiles);
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
    gemm(ln_a(mid, C, mean2, rstd2, ln2_s, ln2_b), w_1, hidden, h1p, hidden, M, hidden, C,
         epi(EPI_NONE, b_1), st);
    gemm(plain_a(g, C), w_2_t, hidden, dh, hidden, M, hidden, C,
         epi(EPI_GELU_GRAD, nullptr, nullptr, 0, h1p, hidden), st);
    gemm(plain_a(dh, hidden), w_1_t, C, dn2, C, M, C, hidden, epi(), st);
    LAUNCH(ln_bwd_kernel, row_grid(M), ROW_WARPS * 32, st, dn2, mid, mean2, rstd2, ln2_s, g, dmid,
           (int)M, C);
    // the attention half
    gemm(plain_a(dmid, C), w_o_t, C, dacc, C, M, C, C, epi(), st);
    LAUNCH(attn_prep_kernel, (unsigned)((M * H + 255) / 256), 256, st, dacc, acc, den, M, N, C, H,
           doe, dden);
    ln_stats(x, M, C, mean1, rstd1, st);
    gemm(ln_a(x, C, mean1, rstd1, ln1_s, ln1_b), w_qkv, C3, qkv, C3, M, C3, C, epi(), st);
    const int D = C / H;
    if (D <= 4) launch_attn_bwd<4>(qkv, doe, dden, dqkv, R, N, C, H, st);
    else if (D <= 8) launch_attn_bwd<8>(qkv, doe, dden, dqkv, R, N, C, H, st);
    else if (D <= 16) launch_attn_bwd<16>(qkv, doe, dden, dqkv, R, N, C, H, st);
    else if (D <= 32) launch_attn_bwd<32>(qkv, doe, dden, dqkv, R, N, C, H, st);
    else launch_attn_bwd_wide(qkv, doe, dden, dqkv, R, N, C, H, st);
    gemm(plain_a(dqkv, C3), w_qkv_t, C, dnrm, C, M, C, C3, epi(), st);
    LAUNCH(ln_bwd_kernel, row_grid(M), ROW_WARPS * 32, st, dnrm, x, mean1, rstd1, ln1_s, dmid, dx,
           (int)M, C);

    // the parameter gradients: partial sums over token slices, then added
    const Leaves l = leaves(C, hidden);
    const long total = l.off[11];
    const Slices sl = grad_slices(M, C, hidden);
    float* part = at[PART];
    auto atb = [&](const Operand& a, const float* b, int ldb, int K1, int K2, int leaf) {
        const dim3 grid((unsigned)((K2 + BN - 1) / BN), (unsigned)((K1 + BM - 1) / BM),
                        (unsigned)sl.parts);
        LAUNCH(atb_kernel, grid, GEMM_THREADS, st, a, b, ldb, (int)M, K1, K2, sl.chunk,
               part + l.off[leaf], total, K2);
    };
    auto colsum = [&](const float* xs, int ldx, const float* ys, const float* mu,
                      const float* rs, int K, int leaf) {
        const dim3 grid((unsigned)((K + 255) / 256), (unsigned)sl.parts);
        LAUNCH(colsum_kernel, grid, 256, st, xs, ldx, ys, ldx, mu, rs, (int)M, K, sl.chunk,
               part + l.off[leaf], total);
    };
    atb(ln_a(x, C, mean1, rstd1, ln1_s, ln1_b), dqkv, C3, C, C3, 2);
    atb(plain_a(acc, C), dmid, C, C, C, 3);
    atb(ln_a(mid, C, mean2, rstd2, ln2_s, ln2_b), dh, hidden, C, hidden, 7);
    atb(Operand{h1p, hidden, AOP_GELU, nullptr, nullptr, nullptr, nullptr}, g, C, hidden, C, 9);
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
