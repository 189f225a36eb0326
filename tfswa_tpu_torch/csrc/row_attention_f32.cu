// Bilinear row attention, forward, in float32, for Hopper (sm_90a): the
// f32 form of B4.
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/row_attention.py
// _attention_kernel_bilinear with compute_dtype = float32 (it computes in
// x_ref.dtype): per row of x (R, N, C), f32 in and out,
//   out = concat_h(softmax(x A_h x^T) v_h) Wo + b,  A_h = Wq_h Wk_h^T / sqrt(D),
//   v = x Wv.
// The TPU kernel folds each head's q . k into the bilinear t = x A_h and
// scores t . x over all C lanes, because Mosaic's lane layout makes (N, D)
// slices of a narrow head costly.  A GPU has no such constraint, and the
// same scores are q_h . k_h over the head's D channels with q_h = x Wq_h /
// sqrt(D) and k_h = x Wk_h: H times less work than t . x.  So here:
//   qkv_kernel:  q|k (R N, 2C) f64 and v (R N, C) = x (f32, widened) @ wqkv
//                (C, 3C) f64 = [Wq / sqrt(D) | Wk | Wv], made by the host
//                from the f32 weights, on the FP64 tensor cores (DMMA,
//                mma.sync m16n8k4 f64); v rounded to f32;
//   attn_kernel: per (row, 64 queries, head, part of the head's outputs), the
//                scores q_h . k_h in f64 on DMMA, an online softmax with its
//                running max in f64, p = 2^(s - max) in f32 and p . v in f32
//                FFMA, divided by the sum at the end; no (N, N) plane;
//   gemm_kernel: out = acc @ Wo + b, 3xTF32 on the tensor cores
//                (block_f32.cuh).
//
// Arithmetic.  The scores are f64: a score reaches the hundreds where the
// softmax is peaked, and an f32 score that large is off by tens of its ulp
// (3e-5 at 500), which exp turns into a relative error of p above the f32
// limit (1e-4 of the output's max over 4).  A product of two f32 values is
// exact in f64, so q and k carry no f32 rounding.  s - max is taken in f64
// and only then rounded to f32 for the SFU's 2^x: the error left in p is a
// few f32 ulp.  p . v and the out-projection are f32 (the TPU kernel's
// function at compute_dtype = float32).
//
// attn_kernel's layout.  A block has 4 warps of 16 queries (two 8-row
// m-tiles each).  Keys stream through shared memory in tiles of KT, as k in
// f64 (W channels at a time: D is zero-padded to W, and a head wider than
// 32 sums its scores over 32-channel chunks) and the part's VW columns of v
// in f32, double-buffered with cp.async.  DMMA's C fragment gives lane (g,
// j) = (lane / 4, lane % 4) the scores of query g and keys 2j, 2j + 1 of
// each 8-key n-tile, so the quad of lanes g shares a query: its max is a
// two-step shuffle, and each lane sums p . v over its own keys into all VW
// outputs of its queries (float4 reads of v, broadcast over the 8 lanes of
// the same j); the quad's partial sums are added once at the end.  A head
// with D > 32 runs ceil(D / 32) parts of VW outputs, each recomputing its
// scores (the accumulators of 16 queries x 32 outputs fill a lane's
// registers).  Ragged keys are zero-filled and their scores set to -inf;
// ragged queries are computed and not stored.
//
// What bounds it: the instructions issued a score (the f64 subtraction, its
// conversion and 2^x, the row sum, VW FFMAs of p . v, the max), not the
// DMMA work: at D = 4 it runs at about 4x the SFU's bound of one 2^x a
// score (PERF.md).
#include "block_f32.cuh"

namespace f32 {
namespace {

constexpr int ATT_THREADS = 128;         // 4 warps
constexpr int ATT_QUERIES = 64;          // 16 a warp
constexpr int MT = 2;                    // 8-row halves of a warp's 16 queries
constexpr int QK_BM = 64, QK_BN = 64, QK_BK = 16, QK_THREADS = 128;

// The lane's C fragment (c0, c1: C[g][2j + i]; c2, c3: C[g + 8][2j + i]) +=
// A (16 x 4, row) @ B (4 x 8, col), f64, with a0 = A[g][j], a1 = A[g + 8][j],
// b = B[j][g] (g = lane / 4, j = lane % 4).  The FP64 tensor cores' sm_90
// shape: twice m8n8k4's rate on the H100 (tools/dmma_rate.cu, PERF.md).
__device__ __forceinline__ void dmma(double& c0, double& c1, double& c2, double& c3, double a0,
                                     double a1, double b) {
#ifdef TFSWA_EMU
    emu_mma_m16n8k4_f64(c0, c1, c2, c3, a0, a1, b);
#else
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, "
                 "{%6}, {%0, %1, %2, %3};\n"
                 : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
                 : "d"(a0), "d"(a1), "d"(b));
#endif
}

// q|k (M, 2C) f64 and v (M, C) f32 = x (M, C) f32 @ w (C, 3C) f64 = [Wq /
// sqrt(D) | Wk | Wv], on DMMA, v rounded to f32.  grid (ceil(M / 64),
// ceil(3C / 64)), 4 warps, each a 32 x 32 corner of the 64 x 64 tile (2 x 4
// 16 x 8 fragments); 16-deep k-slices of x (f32, widened as each A fragment
// is read) and of w, double-buffered with cp.async.  Row strides 20 floats
// and 68 doubles: a fragment's reads fall in distinct banks.
__global__ void __launch_bounds__(QK_THREADS)
qkv_kernel(const float* __restrict__ x, const double* __restrict__ w, double* __restrict__ qk,
           float* __restrict__ v, long M, int C) {
    __shared__ __align__(16) float as[2][QK_BM][QK_BK + 4];
    __shared__ __align__(16) double bs[2][QK_BK][QK_BN + 4];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, j = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const long m0 = (long)blockIdx.x * QK_BM;
    const int n0 = blockIdx.y * QK_BN, ldw = 3 * C, ldq = 2 * C;
    // slice k0 into buffer s: 16-byte copies, 2 of x and 4 of w a thread (C
    // and 3C multiples of 8: a copy is in range or out of it as a whole)
    auto issue = [&](int s, int k0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int e = tid + i * QK_THREADS, m = e >> 2, kc = (e & 3) * 4;
            const bool ok = m0 + m < M && k0 + kc < C;
            cp_async<16>(&as[s][m][kc], ok ? x + (m0 + m) * C + k0 + kc : x, ok);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int e = tid + i * QK_THREADS, k = e >> 5, nc = (e & 31) * 2;
            const bool ok = k0 + k < C && n0 + nc < ldw;
            cp_async<16>(&bs[s][k][nc], ok ? w + (long)(k0 + k) * ldw + n0 + nc : w, ok);
        }
        cp_async_commit();
    };
    double acc[2][4][4] = {};
    const int slices = (C + QK_BK - 1) / QK_BK;
    issue(0, 0);
    for (int sl = 0; sl < slices; ++sl) {
        if (sl + 1 < slices) {
            issue((sl + 1) & 1, (sl + 1) * QK_BK);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int s = sl & 1;
#pragma unroll
        for (int kk = 0; kk < QK_BK; kk += 4) {
            double a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = (double)as[s][wm + i * 8 + g][kk + j];
#pragma unroll
            for (int i = 0; i < 4; ++i) b[i] = bs[s][kk + j][wn + i * 8 + g];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
                    dmma(acc[mi][ni][0], acc[mi][ni][1], acc[mi][ni][2], acc[mi][ni][3],
                         a[2 * mi], a[2 * mi + 1], b[ni]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {                       // 8-row halves of the 16-row tiles
        const long m = m0 + wm + mi * 8 + g;
        const int h = (mi & 1) * 2;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int n = n0 + wn + ni * 8 + 2 * j;        // even, as 2C: a pair is q|k or v
            const double* c = &acc[mi >> 1][ni][h];
            if (m >= M || n >= ldw) continue;
            if (n < ldq) {
                qk[m * ldq + n] = c[0];
                qk[m * ldq + n + 1] = c[1];
            } else {
                v[m * C + n - ldq] = (float)c[0];
                v[m * C + n - ldq + 1] = (float)c[1];
            }
        }
    }
}

constexpr double LOG2E = 1.4426950408889634;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// 2^f in f32 on the SFU (within 2 f32 ulp; a denormal result flushed to 0,
// 2^-inf = 0)
__device__ __forceinline__ float ex2(float f) {
#ifdef TFSWA_EMU
    return exp2f(f);
#else
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(f));
    return r;
#endif
}

// acc_out[(r N + i) C + h D + part VW + d] for every row r, query i, head h
// and part of the head's outputs: grid R * q_tiles * H * parts (part
// fastest, then head), ATT_THREADS threads.  VW outputs a part (a multiple
// of 4 up to 32); W (4, 8, 16 or 32, the power of two at least VW) the
// channels of a score chunk; KT keys a tile (64, 32 at W = 32, where the
// accumulators take more registers).  qk: (R N, 2C) f64, q at columns [0,
// C), k at [C, 2C); v: (R N, C) f32.  Scores in log2 units (q times
// log2(e)), so that p = 2^(s - max).  At most 128 registers a thread at W
// <= 8 (4 blocks an SM), 168 above (3): more blocks hide the latency of
// the exp chain better than the registers the compiler would spend.
template <int W, int VW>
__global__ void __launch_bounds__(ATT_THREADS, W <= 8 ? 4 : 3)
attn_kernel(const double* __restrict__ qk, const float* __restrict__ v,
            float* __restrict__ acc_out, int N, int C, int H, int q_tiles, int parts) {
    constexpr int KT = W == 32 ? 32 : 64;
    constexpr int KN = KT / 8;               // 8-key n-tiles a tile
    constexpr int KS = W / 4;                // DMMA k-steps a chunk
    constexpr int SK = W == 4 ? 4 : W + 4;   // row strides = 4 mod 8: no bank conflicts
    constexpr int SV = VW % 8 == 4 ? VW : VW + 4;
    constexpr int ROWS = ATT_THREADS / W;    // key rows a pass of the block's copies
    constexpr int COPIES = KT / ROWS;        // copies of k (and of v) a thread a stage
    __shared__ __align__(16) double ks[2][KT][SK];
    __shared__ __align__(16) float vs[2][KT][SV];
    long b = blockIdx.x;
    const int part = (int)(b % parts);
    b /= parts;
    const int h = (int)(b % H);
    b /= H;
    const int qt = (int)(b % q_tiles);
    const long row0 = (b / q_tiles) * (long)N;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, j = lane & 3;
    const int D = C / H, ldq = 2 * C;
    const int chunks = (D + W - 1) / W;
    const int tiles = (N + KT - 1) / KT;
    const int stages = tiles * chunks;
    const int q0 = qt * ATT_QUERIES + warp * 16;
    // this thread's copies: column cc of key rows kr0 + i ROWS of a tile
    const int cc = tid % W, kr0 = tid / W;
    const double* ksrc = qk + (row0 + kr0) * ldq + C + (long)h * D + cc;
    const float* vsrc = v + (row0 + kr0) * C + (long)h * D + (long)part * VW + cc;
    const bool v_ok = part * VW + cc < D;   // (cc < VW: the v tile has VW columns)

    // stage f: key tile f / chunks, channels (f % chunks) W of the head's k,
    // and (with the tile's first chunk) the part's columns of its v
    auto issue = [&](int f, int t, int c) {
        const int j0 = t * KT;
        const bool k_ok = c * W + cc < D;
#pragma unroll
        for (int i = 0; i < COPIES; ++i) {
            const int kr = kr0 + i * ROWS;
            const bool ok = k_ok && j0 + kr < N;
            cp_async<8>(&ks[f & 1][kr][cc], ok ? ksrc + (j0 + i * ROWS) * ldq + c * W : qk, ok);
        }
        if (c == 0 && cc < VW) {
#pragma unroll
            for (int i = 0; i < COPIES; ++i) {
                const int kr = kr0 + i * ROWS;
                const bool ok = v_ok && j0 + kr < N;
                cp_async<4>(&vs[t & 1][kr][cc], ok ? vsrc + (j0 + i * ROWS) * C : v, ok);
            }
        }
        cp_async_commit();
    };

    double a[MT][KS];                        // q's A fragments of the chunk, log2 units
    auto load_q = [&](int c) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
            const int i = q0 + mi * 8 + g;
#pragma unroll
            for (int s = 0; s < KS; ++s) {
                const int ch = c * W + s * 4 + j;
                a[mi][s] = i < N && ch < D ? LOG2E * qk[(row0 + i) * ldq + (long)h * D + ch]
                                           : 0.0;
            }
        }
    };

    double sc[MT][KN][2];                    // the tile's scores (C fragments)
    float acc[MT][VW];
    double mx[MT];
    float sum[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
        mx[mi] = -INFINITY;
        sum[mi] = 0.0f;
#pragma unroll
        for (int d = 0; d < VW; ++d) acc[mi][d] = 0.0f;
    }
    if (chunks == 1) load_q(0);
    issue(0, 0, 0);
    int t = 0, c = 0;                        // stage f's tile and chunk
    for (int f = 0; f < stages; ++f) {
        const int tn = c + 1 == chunks ? t + 1 : t, cn = c + 1 == chunks ? 0 : c + 1;
        if (f + 1 < stages) {
            issue(f + 1, tn, cn);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (c == 0) {
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
                for (int nt = 0; nt < KN; ++nt) sc[mi][nt][0] = sc[mi][nt][1] = 0.0;
        }
        if (chunks > 1) load_q(c);
        const int ksteps = (D - c * W + 3) / 4;  // the chunk's k-steps, zero padding left out
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            if (KS > 1 && kk >= ksteps) break;
#pragma unroll
            for (int nt = 0; nt < KN; ++nt) {     // the warp's 16 queries: one 16-row tile
                const double b = ks[f & 1][nt * 8 + g][kk * 4 + j];
                dmma(sc[0][nt][0], sc[0][nt][1], sc[1][nt][0], sc[1][nt][1], a[0][kk], a[1][kk], b);
            }
        }
        if (c == chunks - 1) {
            const int j0 = t * KT;
            if (j0 + KT > N) {                   // the ragged last tile: its keys past N
#pragma unroll
                for (int mi = 0; mi < MT; ++mi)
#pragma unroll
                    for (int nt = 0; nt < KN; ++nt)
#pragma unroll
                        for (int e = 0; e < 2; ++e)
                            if (j0 + nt * 8 + 2 * j + e >= N) sc[mi][nt][e] = -INFINITY;
            }
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
                // the tile's max from the scores' high words as integers:
                // the largest if one is >= 0, else (all scores negative) the
                // smallest, a negative double's bits growing with its
                // magnitude.  Within 2^-20 of the max, which a
                // max-subtracted softmax takes as well as the max itself.
                int kmax = -0x7fffffff - 1, kmin = 0x7fffffff;
#pragma unroll
                for (int nt = 0; nt < KN; ++nt)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int hi = __double2hiint(sc[mi][nt][e]);
                        kmax = imax(kmax, hi);
                        kmin = imin(kmin, hi);
                    }
                kmax = imax(kmax, __shfl_xor_sync(0xffffffffu, kmax, 1));
                kmin = imin(kmin, __shfl_xor_sync(0xffffffffu, kmin, 1));
                kmax = imax(kmax, __shfl_xor_sync(0xffffffffu, kmax, 2));
                kmin = imin(kmin, __shfl_xor_sync(0xffffffffu, kmin, 2));
                const double new_max = fmax(mx[mi], __hiloint2double(kmax >= 0 ? kmax : kmin, 0));
                const float rescale = ex2((float)(mx[mi] - new_max));
                mx[mi] = new_max;
                sum[mi] *= rescale;
#pragma unroll
                for (int d = 0; d < VW; ++d) acc[mi][d] *= rescale;
            }
#pragma unroll
            for (int nt = 0; nt < KN; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float p[MT];
#pragma unroll
                    for (int mi = 0; mi < MT; ++mi) {
                        p[mi] = ex2((float)(sc[mi][nt][e] - mx[mi]));
                        sum[mi] += p[mi];
                    }
                    const float* vr = vs[t & 1][nt * 8 + 2 * j + e];
#pragma unroll
                    for (int d = 0; d < VW; d += 4) {
                        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
                        for (int mi = 0; mi < MT; ++mi) {
                            acc[mi][d] = fmaf(p[mi], vv.x, acc[mi][d]);
                            acc[mi][d + 1] = fmaf(p[mi], vv.y, acc[mi][d + 1]);
                            acc[mi][d + 2] = fmaf(p[mi], vv.z, acc[mi][d + 2]);
                            acc[mi][d + 3] = fmaf(p[mi], vv.w, acc[mi][d + 3]);
                        }
                    }
                }
            }
        }
        __syncthreads();
        t = tn;
        c = cn;
    }
    // the quad's partial sums over its keys, then lane j stores outputs j, j + 4, ...
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
        sum[mi] += __shfl_xor_sync(0xffffffffu, sum[mi], 1);
        sum[mi] += __shfl_xor_sync(0xffffffffu, sum[mi], 2);
        const int i = q0 + mi * 8 + g;
        const int vcols = D - part * VW < VW ? D - part * VW : VW;
        float* dst = acc_out + (row0 + i) * C + (long)h * D + (long)part * VW;
#pragma unroll
        for (int d = 0; d < VW; ++d) {
            float s = acc[mi][d];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if ((d & 3) == j && i < N && d < vcols) dst[d] = s / sum[mi];
        }
    }
}

template <int W, int VW>
void launch_attn(const double* qk, const float* v, float* acc, int R, int N, int C, int H,
                 cudaStream_t st) {
    const int q_tiles = (N + ATT_QUERIES - 1) / ATT_QUERIES;
    const int parts = (C / H + VW - 1) / VW;
    auto kernel = attn_kernel<W, VW>;
    LAUNCH(kernel, (unsigned)((long)R * q_tiles * H * parts), ATT_THREADS, st, qk, v, acc, N, C,
           H, q_tiles, parts);
}

int forward(const float* x, const double* wqkv, const float* wo, const float* bias, float* v,
            float* acc, float* out, double* qk, int R, int N, int C, int H, cudaStream_t st) {
    const long M = (long)R * N;
    const int D = C / H;
    LAUNCH(qkv_kernel, dim3((unsigned)((M + QK_BM - 1) / QK_BM),
                            (unsigned)((3 * C + QK_BN - 1) / QK_BN)),
           QK_THREADS, st, x, wqkv, qk, v, M, C);
    // the plan: W the power of two >= min(D, 32) (at least 4); ceil(D / 32)
    // parts of VW outputs, VW their share of D rounded up to 4
    const int parts = (D + 31) / 32, vw = ((D + parts - 1) / parts + 3) / 4 * 4;
    switch (vw) {
        case 4: launch_attn<4, 4>(qk, v, acc, R, N, C, H, st); break;
        case 8: launch_attn<8, 8>(qk, v, acc, R, N, C, H, st); break;
        case 12: launch_attn<16, 12>(qk, v, acc, R, N, C, H, st); break;
        case 16: launch_attn<16, 16>(qk, v, acc, R, N, C, H, st); break;
        case 20: launch_attn<32, 20>(qk, v, acc, R, N, C, H, st); break;
        case 24: launch_attn<32, 24>(qk, v, acc, R, N, C, H, st); break;
        case 28: launch_attn<32, 28>(qk, v, acc, R, N, C, H, st); break;
        default: launch_attn<32, 32>(qk, v, acc, R, N, C, H, st); break;
    }
    F32_TRY(gemm(plain_a(acc, C), wo, C, out, C, M, C, C, epi(EPI_NONE, bias), st));
    return cudaGetLastError();
}

}  // namespace
}  // namespace f32

// out, acc (the attention output before the out-projection) and v, all
// (R N, C) f32; wqkv (C, 3C) f64, [Wq / sqrt(D) | Wk | Wv]; qk (R N, 2C)
// f64, x @ its first 2C columns (q at columns [0, C), k at [C, 2C)), v the
// rest rounded to f32.  C a multiple of 8 up to 512, H dividing it.
// Returns a CUDA error code.
extern "C" int row_attention_forward_f32(const float* x, const double* wqkv, const float* wo,
                                         const float* bias, float* v, float* acc, float* out,
                                         double* qk, int R, int N, int C, int H, void* stream) {
    if (R <= 0 || N <= 0 || H <= 0 || C <= 0 || C % 8 || C > 512 || C % H || !qk)
        return cudaErrorInvalidValue;
    return f32::forward(x, wqkv, wo, bias, v, acc, out, qk, R, N, C, H,
                        static_cast<cudaStream_t>(stream));
}
