// Bilinear row attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/row_attention.py
// _attention_kernel_bilinear (B4), reached through flash_row_attention.
// Per row of x (R, N, C), bf16 in and out, with A (H, C, C) bf16, A_h =
// Wq_h Wk_h^T / sqrt(D) (made outside, as the JAX package makes it), Wv and
// Wo (C, C) bf16 and the bias b (C) f32:
//   v   = bf16(x @ Wv)                                    f32 sums
//   per head h: t = bf16(x @ A_h)                         (N, C)
//               s[n, m] = t[n] . x[m]                     all C lanes, f32
//               p = bf16(exp(s - max_m s) / sum_m exp(s - max_m s))
//               acc[:, hD:(h+1)D] = sum_m p v[m, hD:(h+1)D]   f32
//   out = bf16(bf16(acc) @ Wo + b)
// p is normalised before its bf16 rounding, as the TPU kernel's
// jax.nn.softmax(...).astype(bf16) rounds it.
//
// Design.  Every product runs on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 sums: the tile of block_common.cuh).  Three launches:
//   1. proj_kernel: v = bf16(x @ Wv), 64 tokens a block (4 warps of 16), Wv
//      streamed through shared memory in k-slices (block_gemm);
//   2. bilinear_attn_kernel: one block per (row, 128 queries), 8 warps (64
//      queries, 4 warps, where N <= 64), warp w owning queries
//      16w..16w+15; the heads in a loop inside the block.  Every key tile
//      streamed serves all the block's queries, so the larger block halves
//      the keys' traffic from L2.  Per head:
//      - t = bf16(x_q A_h) is an mma over K = C, A_h streamed through
//        shared memory 64 columns at a time; each chunk's f32 accumulators
//        are rounded to bf16 and packed in registers as the A fragments of
//        the score product (two adjacent n-tiles make one k16 fragment,
//        pack_a).  t never goes to device memory (H C values a token:
//        3.6 GB at the serving batch's stage-0 TSA) nor to shared memory:
//        C / 4 registers a thread;
//      - the row's keys x stream through shared memory in tiles of 128
//        keys (64 at C >= 128 and in 4-warp blocks; cp.async, two
//        buffers), so shared memory does not grow with N;
//        the scores s = t . x_key are an mma with K = C whose B operand is
//        the key rows themselves (ldmatrix without .trans);
//      - pass 1: per query the running max (reduced across the 4 threads
//        that share an accumulator row, every tile) and each thread's f32
//        sum of exp(s - max), rescaled when the max moves, summed across
//        the 4 threads at the end;
//      - pass 2 recomputes the scores and forms p = bf16(exp(s - max) /
//        sum) in registers as the A fragments of P v_h (keys as K), v_h
//        read by ldmatrix.trans from a key tile that holds only the head's
//        columns of v.  At D = 4 the tile holds the 8 columns of the
//        n-tile that holds the head (its even neighbour's 4 beside it:
//        cp.async and ldmatrix need 16-byte aligned rows); all 8 are
//        multiplied and the head's 4 kept.
//      The rounding point of p forces the two passes: an online softmax
//      that rescales the accumulator rounds p elsewhere.  A ragged last key
//      tile has its keys past N zero-filled and its scores set to -inf,
//      so they add exactly 0 to the sums (zero keys alone would add
//      exp(0 - max)).  No (N, N) plane exists anywhere;
//   3. proj_kernel: out = bf16(acc @ Wo + b), acc as written (bf16).
// exp is ex2.approx.ftz (MUFU.EX2, results below 2^-126 flushed to 0) of a
// pre-scaled argument: exp(s - max) = exp2(s log2 e - max log2 e), one FMA
// and one MUFU op, and pass 2 folds the division by the sum into the
// exponent, p = exp2(s log2 e - (max log2 e + log2 sum)), so a p costs one
// FMA and one exp2 (the f32 result differs from the division in its last
// bits only; p is then rounded to bf16).
//
// What bounds it on the H100.  The function's scores are H N^2 C MACs a
// row (t is rounded to bf16, so no rank-D shortcut computes the same
// function), t adds H N C^2, and exp runs H N^2 times.  At the serving
// shapes exp decides the bound (16 a clock an SM on the MUFU), and two
// passes run it twice: that, not the tensor cores (under 50 ms a serving
// forward even with the scores counted twice), is this design's floor.
//
// Widths: bilinear_attn_kernel is instantiated for the flagship's C in (32,
// 64, 128, 256) with H in (2, 4, 8); any other C (a multiple of 8 up to
// 512) and H dividing it run bilinear_attn_any_kernel (below), and
// proj_kernel runs at C rounded up to 32, 64, 128, 256, 384 or 512.
//
// Interface: plain C, loaded with ctypes.  Each launch goes on the caller's
// stream; the function returns the first non-zero cudaGetLastError().

#include "block_common.cuh"

namespace {

constexpr int PROJ_TOK = 64;       // tokens a block of proj_kernel
constexpr int PROJ_THREADS = 128;
constexpr int TCH = 64;            // columns of t a chunk
constexpr float LOG2E_F = 1.4426950408889634f;

template <int C>
__host__ __device__ constexpr int proj_nch() { return C < 128 ? C : 128; }

template <int C>
constexpr size_t proj_smem_bytes() {
    return sizeof(bf16) * ((size_t)PROJ_TOK * (C + 8) + 2 * KS * (proj_nch<C>() + 8));
}

template <int C>
__host__ __device__ constexpr int t_chunk() { return C < TCH ? C : TCH; }

// keys a shared-memory tile: 128 in the 8-warp blocks (rows of more than
// 64 keys) at C <= 64, for fewer barriers a key and more independent work
// a warp between them; else 64 (registers, and no half-empty tile at N = 64)
template <int C, int NW>
__host__ __device__ constexpr int key_tile() { return NW == 8 && C <= 64 ? 128 : 64; }

// columns of v a key tile holds: the head's, at least the 8 of one n-tile
template <int D>
__host__ __device__ constexpr int v_width() { return D < 8 ? 8 : D; }

// the NW x 16 queries' x, A_h's slices, and two buffers each of key rows x
// and of the head's columns of their v
template <int C, int H, int NW>
constexpr size_t attn_smem_bytes() {
    return sizeof(bf16) * ((size_t)16 * NW * (C + 8) + 2 * KS * (t_chunk<C>() + 8)
                           + 2 * (size_t)key_tile<C, NW>() * (C + 8 + v_width<C / H>() + 8));
}

// 2^x on the MUFU (ex2.approx, results below 2^-126 flushed to 0), x <= 0
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// 1, 3. out = bf16(a @ w + bias) for 64 tokens a block: a (M, C) bf16, w
// (C, C) bf16, bias (C) f32 or null.  Warp w owns tokens 16w..16w+15.  The
// tile is CP = prod_width(C) wide, zero past C, w read as zeros past C.
template <int CP>
__global__ void __launch_bounds__(PROJ_THREADS)
proj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
            const float* __restrict__ bias, bf16* __restrict__ out, int M, int C) {
    constexpr int LDA = CP + 8, NCH = proj_nch<CP>(), NT = NCH / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sa = reinterpret_cast<bf16*>(smem_raw);       // PROJ_TOK x LDA
    bf16* wbuf = sa + PROJ_TOK * LDA;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const size_t tok0 = (size_t)blockIdx.x * PROJ_TOK;
    const int ntok = min(PROJ_TOK, M - (int)tok0);
    stage_rows<PROJ_THREADS>(sa, LDA, a, C, tok0, PROJ_TOK, ntok, C);
    cp_async_commit();
    if (C < CP) {
        for (int i = threadIdx.x; i < PROJ_TOK * (CP - C); i += PROJ_THREADS)
            sa[(i / (CP - C)) * LDA + C + i % (CP - C)] = __float2bfloat16(0.f);
    }
    for (int n0 = 0; n0 < CP; n0 += NCH) {
        float acc[NT][4];
        zero(acc);
        block_gemm<NT, NCH, PROJ_THREADS>(acc, sa + warp * 16 * LDA, LDA, w, C, n0, CP, wbuf, 0,
                                          C, C);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int col = n0 + 8 * j + 2 * q;
            if (col >= C) continue;
            const float b0 = bias != nullptr ? bias[col] : 0.f;
            const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int t = warp * 16 + g + 8 * hh;
                if (t < ntok)
                    *reinterpret_cast<__nv_bfloat162*>(out + (tok0 + t) * C + col) =
                        __floats2bfloat162_rn(acc[j][2 * hh] + b0, acc[j][2 * hh + 1] + b1);
            }
        }
    }
}

// The scores of the warp's 16 queries against a tile of 8 SNT keys (rows of
// a key tile of row stride ld): t's A fragments tf against the key rows as
// B (n-major), K = C.
template <int KSTEPS, int SNT>
__device__ __forceinline__ void tile_scores(float (&s)[SNT][4], const uint32_t (&tf)[KSTEPS][4],
                                            const bf16* keys, int ld) {
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int j = 0; j < SNT; j += 2) {
            uint32_t b[4];
            ldsm_b_nmajor(b, keys, ld, 16 * kk, 8 * j);
            mma_bf16(s[j], tf[kk], b[0], b[1]);
            mma_bf16(s[j + 1], tf[kk], b[2], b[3]);
        }
}

// Scores of keys at or past N (the ragged last tile, first key k0) to -inf.
template <int SNT>
__device__ __forceinline__ void mask_keys(float (&s)[SNT][4], int k0, int N) {
    if (k0 + 8 * SNT <= N) return;
    const int q = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < SNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * q + (e & 1) >= N) s[j][e] = -INFINITY;
}

// 2. One block per (row, 16 NW queries), NW warps; see the design note
// above.  t_out, if non-null, (R*N, H*C) bf16, receives t of every head.
template <int C, int H, int NW>
__global__ void __launch_bounds__(32 * NW)
bilinear_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                     const bf16* __restrict__ v, bf16* __restrict__ acc_out,
                     bf16* __restrict__ t_out, int N, int nqb) {
    constexpr int D = C / H;                 // lanes a head
    constexpr int LDX = C + 8;               // padded rows: ldmatrix's 8 rows on distinct banks
    constexpr int TC = t_chunk<C>();
    constexpr int TNT = TC / 8;              // n-tiles of a chunk of t
    constexpr int KSTEPS = C / 16;           // k16 steps of the scores
    constexpr int AK = key_tile<C, NW>();    // keys a tile
    constexpr int SNT = AK / 8;              // n-tiles of a key tile's scores
    constexpr int VW = v_width<D>();         // columns of a v tile,
    constexpr int LDV = VW + 8;              // padded
    constexpr int VNT = VW / 8;              // n-tiles of P v_h
    constexpr int AQ = 16 * NW;              // queries a block
    constexpr int NTHR = 32 * NW;
    static_assert(C % 32 == 0 && C % H == 0 && (D == 4 || D % 8 == 0) && (VNT == 1 || VNT % 2 == 0),
                  "unsupported C, H");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* xq = reinterpret_cast<bf16*>(smem_raw);      // AQ x LDX: the block's queries
    bf16* abuf = xq + AQ * LDX;                         // A_h's k-slices (block_gemm)
    bf16* kx = abuf + 2 * KS * (TC + 8);                // 2 x AK x LDX: key rows x
    bf16* kv = kx + 2 * AK * LDX;                       // 2 x AK x LDV: the head's v
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int q0 = (blockIdx.x % nqb) * AQ;
    const size_t row0 = (size_t)(blockIdx.x / nqb) * N;
    const bf16* xrow = x + row0 * C;
    const bf16* vrow = v + row0 * C;
    const int nkt = (N + AK - 1) / AK;
    stage_rows<NTHR>(xq, LDX, xrow, C, q0, AQ, N - q0, C);
    cp_async_commit();

    // the pipeline over key tiles: tile kt + 1 in flight while tile kt is
    // used; with v_col >= 0 also the VW columns of v from v_col on
    auto key_pass = [&](int v_col, auto&& use) {
        auto load = [&](int kt) {
            const int k0 = kt * AK;
            stage_rows<NTHR>(kx + (kt & 1) * AK * LDX, LDX, xrow, C, k0, AK, N - k0, C);
            if (v_col >= 0)
                stage_rows<NTHR>(kv + (kt & 1) * AK * LDV, LDV, vrow + v_col, C, k0, AK, N - k0,
                                 VW);
        };
        load(0);
        cp_async_commit();
        for (int kt = 0; kt < nkt; ++kt) {
            if (kt + 1 < nkt) load(kt + 1);
            cp_async_commit();
            cp_async_wait<1>();
            __syncthreads();
            use(kt, kx + (kt & 1) * AK * LDX, kv + (kt & 1) * AK * LDV);
            __syncthreads();      // the buffers are free before they are refilled
        }
    };

    for (int h = 0; h < H; ++h) {
        // t = bf16(x_q A_h) as A fragments: tf[kk] holds t's columns 16kk..16kk+15
        uint32_t tf[KSTEPS][4];
#pragma unroll
        for (int c0 = 0; c0 < C; c0 += TC) {
            float acc[TNT][4];
            zero(acc);
            block_gemm<TNT, TC, NTHR>(acc, xq + warp * 16 * LDX, LDX,
                                             a + (size_t)h * C * C, C, c0, C, abuf, 0);
#pragma unroll
            for (int j = 0; j < TNT; j += 2) pack_a(tf[(c0 + 8 * j) / 16], acc[j], acc[j + 1]);
            if (t_out != nullptr) {
#pragma unroll
                for (int j = 0; j < TNT; ++j)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int n = q0 + warp * 16 + g + 8 * hh;
                        if (n < N)
                            *reinterpret_cast<__nv_bfloat162*>(
                                t_out + ((row0 + n) * H + h) * C + c0 + 8 * j + 2 * q) =
                                __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
                    }
            }
        }

        // pass 1: per query (rows g, g + 8 of the warp's tile) the max and
        // the f32 sum of exp(s - max)
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        key_pass(-1, [&](int kt, const bf16* keys, const bf16*) {
            float s[SNT][4];
            tile_scores(s, tf, keys, LDX);
            mask_keys(s, kt * AK, N);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float mt = m[hh];
#pragma unroll
                for (int j = 0; j < SNT; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
                const float ms = mt * LOG2E_F;
                float sum0 = 0.f, sum1 = 0.f;     // two chains of adds
#pragma unroll
                for (int j = 0; j < SNT; ++j) {
                    sum0 += ex2(fmaf(s[j][2 * hh], LOG2E_F, -ms));
                    sum1 += ex2(fmaf(s[j][2 * hh + 1], LOG2E_F, -ms));
                }
                l[hh] = l[hh] * ex2((m[hh] - mt) * LOG2E_F) + (sum0 + sum1);
                m[hh] = mt;
            }
        });
        float bias2[2];           // max log2 e + log2 sum, per row
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
            bias2[hh] = fmaf(m[hh], LOG2E_F, log2f(l[hh]));
        }

        // pass 2: p = bf16(exp(s - max) / sum), o += p v_h
        const int vcol = (h * D) & ~7;      // the n-tile(s) holding the head's columns
        float o[VNT][4];
        zero(o);
        key_pass(vcol, [&](int kt, const bf16* keys, const bf16* vt) {
            float s[SNT][4];
            tile_scores(s, tf, keys, LDX);
            mask_keys(s, kt * AK, N);
#pragma unroll
            for (int j = 0; j < SNT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = ex2(fmaf(s[j][e], LOG2E_F, -bias2[e >> 1]));
#pragma unroll
            for (int kk = 0; kk < AK / 16; ++kk) {
                uint32_t pf[4];
                pack_a(pf, s[2 * kk], s[2 * kk + 1]);
                if constexpr (VNT == 1) {
                    uint32_t bv[2];
                    ldsm_x2_t(bv, vt + (16 * kk + (lane & 15)) * LDV);
                    mma_bf16(o[0], pf, bv[0], bv[1]);
                } else {
#pragma unroll
                    for (int j = 0; j < VNT; j += 2) {
                        uint32_t bv[4];
                        ldsm_b_kmajor(bv, vt, LDV, 16 * kk, 8 * j);
                        mma_bf16(o[j], pf, bv[0], bv[1]);
                        mma_bf16(o[j + 1], pf, bv[2], bv[3]);
                    }
                }
            }
        });
#pragma unroll
        for (int j = 0; j < VNT; ++j) {
            const int col = vcol + 8 * j + 2 * q;
            if (col < h * D || col >= (h + 1) * D) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int n = q0 + warp * 16 + g + 8 * hh;
                if (n < N)
                    *reinterpret_cast<__nv_bfloat162*>(acc_out + (row0 + n) * C + col) =
                        __floats2bfloat162_rn(o[j][2 * hh], o[j][2 * hh + 1]);
            }
        }
    }
}

// 2'. The same attention at any width C (a multiple of 8 up to 512) and any
// H dividing it (D = C / H from 1 to 512): the widths and head counts that
// bilinear_attn_kernel's instantiations (C in 32 .. 256, H in 2, 4, 8) do
// not take.  One block per (row, 64 queries), 4 warps; the tiles are CP =
// prod_width(C) wide, x zero past C and A_h read as zeros past C, so t is
// 0 there and the scores are the C-lane sums.  What changes against
// bilinear_attn_kernel:
//   - t = bf16(x_q A_h) is held in shared memory (the block's 64 queries x
//     CP, C / 4 registers a thread no longer fit at C = 384, 512), and each
//     score's A fragments come from there by ldmatrix;
//   - the keys stream in tiles of AK = 64 (32 at CP >= 384);
//   - H is a loop count, and the head's columns of v go in parts of VW
//     columns from vcol = (h D) rounded down to 8 (cp.async and ldmatrix
//     take 16-byte aligned rows), each part a pass 2 of its own over the
//     keys (pass 1 once a head); only the head's own columns are written.
// VW is 16 (D up to 9) or 64 (larger D, in parts of 64 columns).
constexpr int ANY_THREADS = 128;

template <int CP>
__host__ __device__ constexpr int any_key_tile() { return CP >= 384 ? 32 : 64; }

template <int CP, int VW>
constexpr size_t any_smem_bytes() {
    constexpr size_t TC = t_chunk<CP>();
    return sizeof(bf16) * (2 * (size_t)64 * (CP + 8) + 2 * KS * (TC + 8)
                           + 2 * (size_t)any_key_tile<CP>() * (CP + 8 + VW + 8));
}

template <int CP, int VW>
__global__ void __launch_bounds__(ANY_THREADS, 1)
bilinear_attn_any_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                         const bf16* __restrict__ v, bf16* __restrict__ acc_out,
                         bf16* __restrict__ t_out, int N, int nqb, int C, int H) {
    constexpr int NW = 4, AQ = 64, NTHR = ANY_THREADS;
    constexpr int LDX = CP + 8;
    constexpr int TC = t_chunk<CP>();
    constexpr int TNT = TC / 8;
    constexpr int KSTEPS = CP / 16;
    constexpr int AK = any_key_tile<CP>();
    constexpr int SNT = AK / 8;
    constexpr int LDV = VW + 8;
    constexpr int VNT = VW / 8;
    static_assert(VNT % 2 == 0, "VW a multiple of 16");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* xq = reinterpret_cast<bf16*>(smem_raw);      // AQ x LDX: the block's queries
    bf16* ts = xq + AQ * LDX;                           // AQ x LDX: their t of the head
    bf16* abuf = ts + AQ * LDX;                         // A_h's k-slices (block_gemm)
    bf16* kx = abuf + 2 * KS * (TC + 8);                // 2 x AK x LDX: key rows x
    bf16* kv = kx + 2 * AK * LDX;                       // 2 x AK x LDV: a part of v
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int q0 = (blockIdx.x % nqb) * AQ;
    const size_t row0 = (size_t)(blockIdx.x / nqb) * N;
    const bf16* xrow = x + row0 * C;
    const bf16* vrow = v + row0 * C;
    const int nkt = (N + AK - 1) / AK;
    const int D = C / H;
    stage_rows<NTHR>(xq, LDX, xrow, C, q0, AQ, N - q0, C);
    cp_async_commit();
    if (C < CP) {            // the columns past C, which no copy writes, as zeros
        for (int i = threadIdx.x; i < AQ * (CP - C); i += NTHR) {
            const int rr = i / (CP - C), c = C + i % (CP - C);
            xq[rr * LDX + c] = __float2bfloat16(0.f);
        }
        for (int i = threadIdx.x; i < 2 * AK * (CP - C); i += NTHR) {
            const int rr = i / (CP - C), c = C + i % (CP - C);
            kx[rr * LDX + c] = __float2bfloat16(0.f);
        }
    }

    auto key_pass = [&](int v_col, int v_width, auto&& use) {
        auto load = [&](int kt) {
            const int k0 = kt * AK;
            stage_rows<NTHR>(kx + (kt & 1) * AK * LDX, LDX, xrow, C, k0, AK, N - k0, C);
            if (v_col >= 0)
                stage_rows<NTHR>(kv + (kt & 1) * AK * LDV, LDV, vrow + v_col, C, k0, AK, N - k0,
                                 v_width);
        };
        load(0);
        cp_async_commit();
        for (int kt = 0; kt < nkt; ++kt) {
            if (kt + 1 < nkt) load(kt + 1);
            cp_async_commit();
            cp_async_wait<1>();
            __syncthreads();
            use(kt, kx + (kt & 1) * AK * LDX, kv + (kt & 1) * AK * LDV);
            __syncthreads();      // the buffers are free before they are refilled
        }
    };
    // the warp's 16 queries' scores against a key tile, t's A fragments
    // from ts
    const bf16* tw = ts + warp * 16 * LDX;
    auto scores = [&](float (&s)[SNT][4], const bf16* keys) {
        zero(s);
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            uint32_t tf[4];
            ldsm_a(tf, tw, LDX, 16 * kk);
#pragma unroll
            for (int j = 0; j < SNT; j += 2) {
                uint32_t b[4];
                ldsm_b_nmajor(b, keys, LDX, 16 * kk, 8 * j);
                mma_bf16(s[j], tf, b[0], b[1]);
                mma_bf16(s[j + 1], tf, b[2], b[3]);
            }
        }
    };

    for (int h = 0; h < H; ++h) {
        // t = bf16(x_q A_h) into the warp's rows of ts (and t_out)
        for (int c0 = 0; c0 < CP; c0 += TC) {
            float acc[TNT][4];
            zero(acc);
            block_gemm<TNT, TC, NTHR>(acc, xq + warp * 16 * LDX, LDX, a + (size_t)h * C * C, C,
                                      c0, CP, abuf, 0, C, C);
#pragma unroll
            for (int j = 0; j < TNT; ++j)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int rr = warp * 16 + g + 8 * hh, col = c0 + 8 * j + 2 * q;
                    const __nv_bfloat162 tv =
                        __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
                    *reinterpret_cast<__nv_bfloat162*>(ts + rr * LDX + col) = tv;
                    const int n = q0 + rr;
                    if (t_out != nullptr && n < N && col < C)
                        *reinterpret_cast<__nv_bfloat162*>(t_out + ((row0 + n) * H + h) * C + col) =
                            tv;
                }
        }
        __syncwarp();

        // pass 1: per query the max and the f32 sum of exp(s - max)
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        key_pass(-1, 0, [&](int kt, const bf16* keys, const bf16*) {
            float s[SNT][4];
            scores(s, keys);
            mask_keys(s, kt * AK, N);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float mt = m[hh];
#pragma unroll
                for (int j = 0; j < SNT; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
                const float ms = mt * LOG2E_F;
                float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
                for (int j = 0; j < SNT; ++j) {
                    sum0 += ex2(fmaf(s[j][2 * hh], LOG2E_F, -ms));
                    sum1 += ex2(fmaf(s[j][2 * hh + 1], LOG2E_F, -ms));
                }
                l[hh] = l[hh] * ex2((m[hh] - mt) * LOG2E_F) + (sum0 + sum1);
                m[hh] = mt;
            }
        });
        float bias2[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
            bias2[hh] = fmaf(m[hh], LOG2E_F, log2f(l[hh]));
        }

        // pass 2, a part of VW of the head's columns at a time
        for (int vcol = (h * D) & ~7; vcol < (h + 1) * D; vcol += VW) {
            float o[VNT][4];
            zero(o);
            key_pass(vcol, min(VW, C - vcol), [&](int kt, const bf16* keys, const bf16* vt) {
                float s[SNT][4];
                scores(s, keys);
                mask_keys(s, kt * AK, N);
#pragma unroll
                for (int j = 0; j < SNT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        s[j][e] = ex2(fmaf(s[j][e], LOG2E_F, -bias2[e >> 1]));
#pragma unroll
                for (int kk = 0; kk < AK / 16; ++kk) {
                    uint32_t pf[4];
                    pack_a(pf, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
                    for (int j = 0; j < VNT; j += 2) {
                        uint32_t bv[4];
                        ldsm_b_kmajor(bv, vt, LDV, 16 * kk, 8 * j);
                        mma_bf16(o[j], pf, bv[0], bv[1]);
                        mma_bf16(o[j + 1], pf, bv[2], bv[3]);
                    }
                }
            });
#pragma unroll
            for (int j = 0; j < VNT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = vcol + 8 * j + 2 * q + (e & 1);
                    const int n = q0 + warp * 16 + g + 8 * (e >> 1);
                    if (n < N && col >= h * D && col < (h + 1) * D)
                        acc_out[(row0 + n) * C + col] = __float2bfloat16(o[j][e]);
                }
        }
    }
}

template <int C>
cudaError_t launch_proj(const bf16* a, const bf16* w, const float* bias, bf16* out, int M,
                        int Cw, cudaStream_t stream) {
    constexpr size_t smem = proj_smem_bytes<C>();
    cudaError_t err = cudaFuncSetAttribute(
        proj_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    proj_kernel<C><<<(unsigned)((M + PROJ_TOK - 1) / PROJ_TOK), PROJ_THREADS, smem, stream>>>(
        a, w, bias, out, M, Cw);
    return cudaGetLastError();
}

template <int C, int H, int NW>
cudaError_t launch_attn_nw(const bf16* x, const bf16* a, const bf16* v, bf16* acc,
                           bf16* t_out, int R, int N, cudaStream_t stream) {
    const int nqb = (N + 16 * NW - 1) / (16 * NW);
    const size_t blocks = (size_t)R * nqb;
    constexpr size_t smem = attn_smem_bytes<C, H, NW>();
    if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(
        bilinear_attn_kernel<C, H, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    bilinear_attn_kernel<C, H, NW><<<(unsigned)blocks, 32 * NW, smem, stream>>>(
        x, a, v, acc, t_out, N, nqb);
    return cudaGetLastError();
}

// 128 queries a block (8 warps) where a row has more than 64, so that each
// pass over the keys serves twice the queries; else 64 (4 warps).
template <int C, int H>
cudaError_t launch_attn(const bf16* x, const bf16* a, const bf16* v, bf16* acc, bf16* t_out,
                        int R, int N, cudaStream_t stream) {
    return N > 64 ? launch_attn_nw<C, H, 8>(x, a, v, acc, t_out, R, N, stream)
                  : launch_attn_nw<C, H, 4>(x, a, v, acc, t_out, R, N, stream);
}

template <int CP, int VW>
cudaError_t launch_attn_any(const bf16* x, const bf16* a, const bf16* v, bf16* acc,
                            bf16* t_out, int R, int N, int C, int H, cudaStream_t stream) {
    const int nqb = (N + 63) / 64;
    const size_t blocks = (size_t)R * nqb;
    constexpr size_t smem = any_smem_bytes<CP, VW>();
    if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(
        bilinear_attn_any_kernel<CP, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    bilinear_attn_any_kernel<CP, VW><<<(unsigned)blocks, ANY_THREADS, smem, stream>>>(
        x, a, v, acc, t_out, N, nqb, C, H);
    return cudaGetLastError();
}

// The three launches at width C (CP = prod_width(C)): bilinear_attn_kernel
// at its instantiated C and H, else bilinear_attn_any_kernel.
template <int CP>
cudaError_t forward(const bf16* x, const bf16* a, const bf16* wv, const bf16* wp,
                    const float* bias, bf16* v, bf16* acc, bf16* out, bf16* t_out, int R, int N,
                    int C, int H, cudaStream_t stream) {
    const int M = R * N;
    cudaError_t err = launch_proj<CP>(x, wv, nullptr, v, M, C, stream);
    if (err != cudaSuccess) return err;
    const bool listed = C == CP && CP <= 256 && (H == 2 || H == 4 || H == 8);
    if constexpr (CP <= 256) {
        if (listed) {
            switch (H) {
                case 2: err = launch_attn<CP, 2>(x, a, v, acc, t_out, R, N, stream); break;
                case 4: err = launch_attn<CP, 4>(x, a, v, acc, t_out, R, N, stream); break;
                default: err = launch_attn<CP, 8>(x, a, v, acc, t_out, R, N, stream); break;
            }
        }
    }
    if (!listed) {
        // VW: the head's columns from (h D) rounded down to 8, in one part
        // up to D = 9, else in parts of 64
        const int D = C / H;
        err = D + 7 <= 16 ? launch_attn_any<CP, 16>(x, a, v, acc, t_out, R, N, C, H, stream)
                          : launch_attn_any<CP, 64>(x, a, v, acc, t_out, R, N, C, H, stream);
    }
    if (err != cudaSuccess) return err;
    return launch_proj<CP>(acc, wp, bias, out, M, C, stream);
}

}  // namespace

// x (R, N, C), a (H, C, C), wv and wp (C, C), all bf16 and 16-byte aligned;
// bias (C) f32; C a multiple of 8 up to 512, H dividing it.  v_buf (R*N, C)
// and acc_buf (R, N, C) bf16 receive v and the attention output before the
// out-projection, out (R, N, C) bf16 the result; t_out, if non-null,
// (R*N, H*C) bf16 receives t.
extern "C" int row_attention_forward(
    const void* x, const void* a, const void* wv, const void* wp, const void* bias,
    void* v_buf, void* acc_buf, void* out, void* t_out, int R, int N, int C, int H,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (R <= 0 || N <= 0 || H <= 0 || C <= 0 || C % 8 || C > 512 || C % H)
        return cudaErrorInvalidValue;
    const bf16 *xb = (const bf16*)x, *ab = (const bf16*)a, *wvb = (const bf16*)wv,
               *wpb = (const bf16*)wp;
    const float* bb = (const float*)bias;
    bf16 *v = (bf16*)v_buf, *acc = (bf16*)acc_buf, *o = (bf16*)out, *tb = (bf16*)t_out;
    switch (prod_width(C)) {
        case 32: return forward<32>(xb, ab, wvb, wpb, bb, v, acc, o, tb, R, N, C, H, stream);
        case 64: return forward<64>(xb, ab, wvb, wpb, bb, v, acc, o, tb, R, N, C, H, stream);
        case 128: return forward<128>(xb, ab, wvb, wpb, bb, v, acc, o, tb, R, N, C, H, stream);
        case 256: return forward<256>(xb, ab, wvb, wpb, bb, v, acc, o, tb, R, N, C, H, stream);
        case 384: return forward<384>(xb, ab, wvb, wpb, bb, v, acc, o, tb, R, N, C, H, stream);
        default: return forward<512>(xb, ab, wvb, wpb, bb, v, acc, o, tb, R, N, C, H, stream);
    }
}
