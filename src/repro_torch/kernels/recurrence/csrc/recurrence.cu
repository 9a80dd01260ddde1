// The recurrence scans for NVIDIA Hopper (sm_90a): the RWKV-6 WKV recurrence
// and the Mamba2 (SSD) state recurrence, each over a whole sequence in one
// launch, as chunked scans whose chunk products run on the tensor cores.
//
// Replaces no Pallas kernel.  The JAX package runs both recurrences with
// lax.scan (src/repro/models/rwkv.py:138-154, the WKV step of
// rwkv_time_mix_seq; src/repro/models/ssm.py:91-108, the step of mamba_seq),
// which XLA compiles into one loop on the device.  The port compiles nothing,
// so without these kernels the plain version is a Python loop of about six
// small launches per time step.  scan_chunk only places JAX's
// rematerialisation checkpoints and changes nothing in the forward pass, so
// nothing here reads it.
//
// wkv6_scan: r, k, v, w (B, S, H, 64) float32 and u (H, 64); with the state
// S (64 x 64 per (b, h), key row i, value column j) starting at zero, for
// t = 0 .. S-1
//
//     y_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//     S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
//
// ssd_scan: decay (B, S, H), dtx (B, S, H, 64), b and c (B, S, 64); with h
// (64 x 64 per (b, h), head-dim row d, state n) starting at zero
//
//     h[d,n] <- decay_t * h[d,n] + dtx_t[d] * b_t[n]
//     y_t[d]  = sum_n h[d,n] * c_t[n]
//
// Inputs are read through element strides (batch, sequence, head), the last
// dimension contiguous, so the projections' views need no copy; y is written
// contiguous (B, S, H, 64).
//
// The chunked algorithm.  The sequence is cut into chunks of CHUNK = 32
// steps, each into two sub-chunks of SUB = 16 (one tensor-core tile edge);
// only the state passes from one chunk to the next.  For WKV-6, with
// P_t = prod_{start <= tau < t} w_tau and Q_s = prod_{s < tau < end} w_tau
// (per key channel i), a chunk is
//
//     y      = (r * P) S_start + A V
//     S_end  = diag(P_L) S_start + (k * Q)^T V
//     A[t,s] = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i]   (s < t)
//     A[t,t] = sum_i r_t[i] u[i] k_t[i]                          (the bonus)
//
// y_t reads the state before step t's update, so its decay excludes step t.
// The SSD scan is the same with the state as h^T (n rows, d columns), C for
// r, B for k, dtx for v and one scalar decay per step; y_t reads the state
// after step t's update, so its decays include step t and A's diagonal is
// C_t . B_t:
//
//     y       = pre * (C h^T_start) + (Ls * C B^T) X
//     h^T_end = P_L h^T_start + (suf * B)^T X
//
// with pre_t = prod_{start <= tau <= t}, suf_s = prod_{s < tau < end} and
// Ls[t,s] = prod_{s < tau <= t} of the decays.
//
// Where the factors are formed.  Every decay factor is a product of the
// decays over one segment, each factor <= 1: never a quotient of two prefix
// products and never the exp of a difference of log sums, because w =
// exp(-exp(x)) underflows to exactly 0 for x > ~4.5 and a Mamba decay
// reaches 0 at a large dt (1/P then overflows, the logs give -inf - -inf),
// and a large decay early in a chunk wipes out the float32 precision of a
// difference of prefix sums taken after it.  WKV-6: one thread per
// (sub-chunk, channel) runs the product of w forward from the sub-chunk's
// start (r_t times it is staged as ra, and the whole product as g) and
// another backward from its end (k_s times it, kb); P_t and Q_s are those
// times g of the other sub-chunk, applied as the tensor-core operands are
// loaded.  A's off-diagonal 16 x 16 block (t in sub-chunk 1, s in 0) splits
// its product at sub-chunk 1's start: ra_t . kb_s exactly.  The diagonal
// blocks are formed pairwise on the CUDA cores: a lane carries k_s times
// the running product of w along t for eight channels, all lanes of a warp
// read the same row of r and w at each t, and the lanes of one (t, s) add
// their shares by shuffles.  SSD: warp 0 forms the scalar products to and
// from each step's sub-chunk edges, warp 1 Ls inside each sub-chunk as
// running products along t; C B^T (the whole lower triangle on the tensor
// cores) is scaled by Ls afterwards.
//
// The tensor cores, at float32 accuracy.  Every chunk product is
// mma.sync.m16n8k8 in TF32 with the 3xTF32 split (the helpers, and the
// staging's, are in recurrence_common.cuh, which recurrence_bwd.cu shares):
// each operand x becomes
// big (x with the 13 low mantissa bits cleared: what the tensor core reads)
// and small = x - big, and a product is small*big + big*small + big*big,
// the three accumulated apart in float32 so that they do not wait on one
// another.  What is lost is 2^-20 of each operand (small's low bits and
// small*small).  Plain TF32 keeps about three decimal digits and would not
// hold 1e-4 of each head's largest output; the split holds ~1e-6.  The
// state stays in float32 registers as the accumulator of its own update, and
// a float32 copy in shared memory is the operand of the next chunk's
// product with it.
//
// The grid.  One CTA of eight warps per (b, h) runs the whole sequence: 80
// CTAs at rwkv6-3b (B = 2, H = 40), 128 at zamba2-1.2b (B = 2, H = 64), one
// a SM, in one wave.  (Blocks of 32 value columns would give 160 CTAs but
// recompute A and read r, k and w twice.)  Inputs are staged four chunks
// deep: each row of each input is one bulk copy (cp.async.bulk) counted on
// its buffer's mbarrier, issued by lanes of all warps after the
// __syncthreads that frees the buffer, the byte count posted before it.
// Views whose bases or strides are not on 16 bytes are staged by 4-byte
// cp.async instead.  A chunk takes three phases between barriers: (1) the
// running products and the diagonal blocks (SSD: the decay factors beside
// C B^T); (2) the off-diagonal block, y from the state, the state update;
// (3) A V into y and the stores.
//
// What bounds them on the H100.  WKV-6 at rwkv6-3b (B = 2, S = 32768,
// H = 40) must read and write 3.36 GB: 1.00 ms at 3.35 TB/s.  Its chunk
// products are 960 mma.sync a CTA and chunk, 1.6e11 TF32 flops with the
// split (0.33 ms at 495 TFLOP/s), the diagonal blocks 3e9 float32 flops on
// the CUDA cores.  The SSD scan at zamba2-1.2b (B = 2, S = 32768, H = 64,
// N = 64) must move 2.2 GB (0.66 ms); its chunk products are 1056 mma.sync
// a CTA and chunk, 2.8e11 TF32 flops with the split (0.57 ms).  The
// recurrence itself, stepped, is 5 float32 operations per state entry and
// step (0.81 and 1.28 ms at 67 TFLOP/s).  Bytes bound both.  What keeps
// them from it: a chunk is a chain of dependent phases between barriers on
// one CTA of eight warps an SM, each warp issuing its fragment loads, the
// 3xTF32 splits and the products in turn, and WKV-6's diagonal blocks run
// on the CUDA cores with about half their lanes idle (columns s > t).

#include "recurrence_common.cuh"

namespace {

constexpr int HD = 64;  // head dim (WKV-6) and head dim / state size (SSD)

// ============================================================================
// The chunked kernels.
// ============================================================================

struct WkvParams {
    const float* r;
    const float* k;
    const float* v;
    const float* w;
    const float* u;  // (H, 64) contiguous
    float* y;        // (B, S, H, 64) contiguous
    // Element strides for batch, sequence and head of r, k, v and w.
    long long r_sb, r_ss, r_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long w_sb, w_ss, w_sh;
    int seq_len;
    int heads;
    int vec;  // every base and stride allows 16-byte copies
};

struct SsdParams {
    const float* decay;  // (B, S, H)
    const float* dtx;    // (B, S, H, 64)
    const float* bm;     // (B, S, 64)
    const float* cm;     // (B, S, 64)
    float* y;            // (B, S, H, 64) contiguous
    long long dec_sb, dec_ss, dec_sh;
    long long x_sb, x_ss, x_sh;
    long long b_sb, b_ss;
    long long c_sb, c_ss;
    int seq_len;
    int heads;
    int vec;  // every base and stride of dtx, b and c allows 16-byte copies
};

constexpr int CHUNK = 32;  // time steps a chunk
constexpr int SUB = 16;    // time steps a sub-chunk: one tile edge
constexpr int NSUB = CHUNK / SUB;
constexpr int WARPS = 8;  // a CTA: one (b, h), all 64 columns (rows) of its state
constexpr int THREADS = 32 * WARPS;
constexpr int WKV_STAGES = 4;  // chunk buffers: the one read now and three in flight
constexpr int SSD_STAGES = 4;
constexpr int NTW = HD / (4 * WARPS);  // output n-tiles a warp (2 m-tiles x 8 n-tiles)
constexpr int NTS = HD / (2 * WARPS);  // state n-tiles a warp (4 m-tiles x 8 n-tiles)
static_assert(NSUB == 2 && CHUNK == 4 * WARPS,
              "the warps' roles below are laid out for two sub-chunks and four staged rows "
              "a warp");

// Shared-memory row strides (floats) are chosen so that the fragment loads
// of mma.sync hit 32 distinct banks: a row-major A operand read by rows
// (and a B operand read as [n][k]) wants a stride of 4 mod 32; an operand
// read by columns ([k][m] or [k][n]) wants 8 mod 32.

// y (rows t and t + 8, columns col and col + 1 of the head) from one output
// tile, rows past seq_len dropped.
__device__ __forceinline__ void store_y(float* yb, long long y_ss, int t, int seq_len, int col,
                                        const Tile& acc)
{
    if (t < seq_len)
        *reinterpret_cast<float2*>(yb + t * y_ss + col) = make_float2(acc.value(0), acc.value(1));
    if (t + 8 < seq_len)
        *reinterpret_cast<float2*>(yb + (t + 8) * y_ss + col) =
            make_float2(acc.value(2), acc.value(3));
}

struct WkvSmem {
    uint64_t bar[WKV_STAGES];        // the bulk copies of each buffer
    alignas(16) float r[WKV_STAGES][CHUNK][HD];  // raw inputs, one buffer a chunk in flight
    float k[WKV_STAGES][CHUNK][HD];
    float w[WKV_STAGES][CHUNK][HD];
    float v[WKV_STAGES][CHUNK][HD + 8];
    float ra[CHUNK][HD + 4];  // r_t[i] * prod_{sub-chunk start <= tau < t} w_tau[i]
    float kb[CHUNK][HD + 8];  // k_s[i] * prod_{s < tau < sub-chunk end} w_tau[i]
    float g[NSUB][HD];        // each sub-chunk's whole product of w
    float amat[CHUNK][CHUNK + 4];
    float ofd[SUB][SUB + 4];  // the second channel half of A's off-diagonal block
    float s[HD][HD + 8];      // the state at the chunk's start
    float u[HD];
};

// WKV-6's diagonal 16 x 16 blocks of A on the CUDA cores (see the note).
// Warps 4 a .. 4 a + 3 form sub-chunk a's block; warp gi of them takes the
// columns s = gi, 7 - gi, 8 + gi and 15 - gi (34 (t, s) pairs each).  A lane
// takes one of the four (slot) and eight of the 64 channels (part) and
// carries k_s times the running product of w along t; all lanes read the
// same row of r and w at each t, each part's two float4 in an order rotated
// by part / 4, so the eight parts hit distinct banks.  Each (t, s) sum is
// added across the parts after the loop.
__device__ __forceinline__ void wkv_diag_blocks(const float (*r)[HD], const float (*k)[HD],
                                                const float (*w)[HD], const float* u,
                                                float (*amat)[CHUNK + 4], int warp, int lane)
{
    static_assert(WARPS == 2 * 4, "four warps a diagonal block");
    const int base = (warp >> 2) * SUB, gi = warp & 3;
    const int slot = lane & 3, part = lane >> 2;
    const int s = slot == 0 ? gi : slot == 1 ? 7 - gi : slot == 2 ? 8 + gi : 15 - gi;
    const int rot = (part >> 2) & 1;
    const int co[2] = {part * 8 + rot * 4, part * 8 + (rot ^ 1) * 4};  // one float4 each
    float e[8], sums[SUB + 1];
    // The bonus at t = s first; e starts as k_s.
    {
        float rs[8], uu[8];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
            *reinterpret_cast<float4*>(&e[4 * f]) = *reinterpret_cast<const float4*>(&k[base + s][co[f]]);
            *reinterpret_cast<float4*>(&rs[4 * f]) = *reinterpret_cast<const float4*>(&r[base + s][co[f]]);
            *reinterpret_cast<float4*>(&uu[4 * f]) = *reinterpret_cast<const float4*>(&u[co[f]]);
        }
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc = fmaf(rs[c], uu[c] * e[c], acc);
        sums[SUB] = acc;
    }
#pragma unroll
    for (int t = 1; t < SUB; ++t) {
        sums[t - 1] = 0.f;
        if (t <= gi) continue;  // no column of this warp lies before t
        float rt[8], wt[8];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
            *reinterpret_cast<float4*>(&rt[4 * f]) = *reinterpret_cast<const float4*>(&r[base + t][co[f]]);
            *reinterpret_cast<float4*>(&wt[4 * f]) = *reinterpret_cast<const float4*>(&w[base + t][co[f]]);
        }
        const bool live = t > s;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            acc = fmaf(rt[c], e[c], acc);
            e[c] = live ? e[c] * wt[c] : e[c];
        }
        sums[t - 1] = live ? acc : 0.f;  // A[t][s]
    }
#pragma unroll
    for (int j = 0; j <= SUB; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sums[j] += __shfl_xor_sync(0xffffffffu, sums[j], off);
    if (part == 0) {
        amat[base + s][base + s] = sums[SUB];
#pragma unroll
        for (int t = 1; t < SUB; ++t)
            if (t > s) amat[base + t][base + s] = sums[t - 1];
    }
}

__global__ void __launch_bounds__(THREADS, 1) wkv6_scan_kernel(const WkvParams p)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    WkvSmem& sm = *reinterpret_cast<WkvSmem*>(smem_raw);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;  // the fragment's row group and column
    const int h = blockIdx.x;
    const long long b = blockIdx.y;
    const float* rb = p.r + b * p.r_sb + h * p.r_sh;
    const float* kb = p.k + b * p.k_sb + h * p.k_sh;
    const float* wb = p.w + b * p.w_sb + h * p.w_sh;
    const float* vb = p.v + b * p.v_sb + h * p.v_sh;
    const long long y_ss = static_cast<long long>(p.heads) * HD;
    float* yb = p.y + b * p.seq_len * y_ss + h * HD;
    const int n_chunks = (p.seq_len + CHUNK - 1) / CHUNK;
    const bool vec = p.vec != 0;

    // The bytes chunk c's bulk copies bring, announced on its buffer's barrier
    // by thread 0 before the __syncthreads that precedes the copies.
    auto expect = [&](int c, int buf) {
        if (vec && tid == 0)
            mbar_expect_tx(&sm.bar[buf], min(CHUNK, p.seq_len - c * CHUNK) * 4 * HD * 4);
    };
    // Chunk c into buffer buf: one row of one input a lane (lanes 0-15, four
    // rows a warp) through the bulk copy engine; or by every thread, 4 bytes
    // at a time.
    auto stage = [&](int c, int buf) {
        const int t0 = c * CHUNK;
        if (vec) {
            if (lane < 16) {
                const int row = warp * 4 + (lane >> 2), which = lane & 3;
                const bool ok = t0 + row < p.seq_len;
                const long long t = ok ? t0 + row : 0;
                if (which == 0) stage_row_bulk<HD>(sm.r[buf][row], rb + t * p.r_ss, ok, &sm.bar[buf]);
                if (which == 1) stage_row_bulk<HD>(sm.k[buf][row], kb + t * p.k_ss, ok, &sm.bar[buf]);
                if (which == 2) stage_row_bulk<HD>(sm.w[buf][row], wb + t * p.w_ss, ok, &sm.bar[buf]);
                if (which == 3) stage_row_bulk<HD>(sm.v[buf][row], vb + t * p.v_ss, ok, &sm.bar[buf]);
            }
        } else {
            stage_rows_4<CHUNK, HD, HD, THREADS>(&sm.r[buf][0][0], rb, p.r_ss, t0, p.seq_len);
            stage_rows_4<CHUNK, HD, HD, THREADS>(&sm.k[buf][0][0], kb, p.k_ss, t0, p.seq_len);
            stage_rows_4<CHUNK, HD, HD, THREADS>(&sm.w[buf][0][0], wb, p.w_ss, t0, p.seq_len);
            stage_rows_4<CHUNK, HD, HD + 8, THREADS>(&sm.v[buf][0][0], vb, p.v_ss, t0, p.seq_len);
        }
    };

    // A's upper triangle is never written: zero it once.  The state starts at zero.
    for (int e = tid; e < CHUNK * (CHUNK + 4); e += THREADS) (&sm.amat[0][0])[e] = 0.f;
    for (int e = tid; e < HD * (HD + 8); e += THREADS) (&sm.s[0][0])[e] = 0.f;
    if (tid < HD) sm.u[tid] = p.u[h * HD + tid];
    if (tid == 0) {
        for (int i = 0; i < WKV_STAGES; ++i) mbar_init(&sm.bar[i], 1);
        mbar_fence_init();
    }
    __syncthreads();
    for (int c = 0; c < WKV_STAGES - 1 && c < n_chunks; ++c) expect(c, c);
    __syncthreads();
    for (int c = 0; c < WKV_STAGES - 1; ++c) {  // one commit group a chunk, empty or not
        if (c < n_chunks) stage(c, c);
        cp_async_commit();
    }

    const int my = warp & 1, m0 = my * SUB;  // this warp's output rows: sub-chunk my
    const int nt0 = (warp >> 1) * NTW;       // and its output n-tiles
    const int si0 = 16 * (warp & 3);         // its state rows si0 + g and + 8
    const int sn0 = (warp >> 2) * NTS;       // and state n-tiles
    float st[NTS][4];                        // its state, columns 8 n + 2 q and + 1
#pragma unroll
    for (int n = 0; n < NTS; ++n)
        for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
    Tile yacc[NTW];  // its output tiles, from (2) of a chunk to (3)

    // (1) Running products inside each sub-chunk (thread: direction,
    // sub-chunk, channel), and A's diagonal blocks.
    auto phase1 = [&](int c) {
        const int buf = c % WKV_STAGES;
        const float (*r)[HD] = sm.r[buf];
        const float (*k)[HD] = sm.k[buf];
        const float (*w)[HD] = sm.w[buf];
        if (tid < 2 * NSUB * HD) {
            const int a = (tid >> 6) & 1, i = tid & 63, t0 = a * SUB;
            float wv[SUB];
#pragma unroll
            for (int tl = 0; tl < SUB; ++tl) wv[tl] = w[t0 + tl][i];
            float pr = 1.f;
            if (tid < 128) {
#pragma unroll
                for (int tl = 0; tl < SUB; ++tl) {
                    sm.ra[t0 + tl][i] = r[t0 + tl][i] * pr;
                    pr *= wv[tl];
                }
                sm.g[a][i] = pr;
            } else {
#pragma unroll
                for (int tl = SUB - 1; tl >= 0; --tl) {
                    sm.kb[t0 + tl][i] = k[t0 + tl][i] * pr;
                    pr *= wv[tl];
                }
            }
        }
        wkv_diag_blocks(r, k, w, sm.u, sm.amat, warp, lane);
    };

    // (2) A's off-diagonal block, y from the state, the state's update.
    auto phase2 = [&](int c) {
        const float (*v)[HD + 8] = sm.v[c % WKV_STAGES];
        // A's off-diagonal block (t in sub-chunk 1, s in sub-chunk 0): warps
        // 0-3, one 16 x 8 tile and half the channels each, the product split
        // at t's sub-chunk start (ra . kb, nothing between them).
        if (warp < 4) {
            const int n0 = (warp & 1) * 8, kh = (warp >> 1) * (HD / 2);
            Tile acc;
            acc.zero();
#pragma unroll
            for (int k0 = kh; k0 < kh + HD / 2; k0 += 8) {
                uint32_t ab[4], as[4];
                load_a(sm.ra, SUB, k0, g, q, 1.f, 1.f, ab, as);
                mma3_b(acc, ab, as, sm.kb[n0 + g][k0 + q], sm.kb[n0 + g][k0 + q + 4]);
            }
            if (kh == 0)
                store_tile(sm.amat, SUB, n0, g, q, acc);
            else
                store_tile(sm.ofd, 0, n0, g, q, acc);
        }

        // y = (r * P) S_start: P_t is ra's prefix times g of sub-chunk 0 for
        // t in sub-chunk 1.
#pragma unroll
        for (int n = 0; n < NTW; ++n) yacc[n].zero();
#pragma unroll
        for (int k0 = 0; k0 < HD; k0 += 8) {
            uint32_t ab[4], as[4];
            load_a(sm.ra, m0, k0, g, q, my ? sm.g[0][k0 + q] : 1.f, my ? sm.g[0][k0 + q + 4] : 1.f,
                   ab, as);
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
                const int col = (nt0 + n) * 8 + g;
                mma3_b(yacc[n], ab, as, sm.s[k0 + q][col], sm.s[k0 + q + 4][col]);
            }
        }

        // S <- diag(P_L) S + (k * Q)^T V: Q_s is kb's suffix times g of
        // sub-chunk 1 for s in sub-chunk 0.
        const float g1_top = sm.g[1][si0 + g], g1_bottom = sm.g[1][si0 + g + 8];
        Tile ds[NTS];
#pragma unroll
        for (int n = 0; n < NTS; ++n) ds[n].zero();
#pragma unroll
        for (int k0 = 0; k0 < CHUNK; k0 += 8) {
            uint32_t ab[4], as[4];
            const bool first = k0 < SUB;
            load_at(sm.kb, si0, k0, g, q, first ? g1_top : 1.f, first ? g1_bottom : 1.f, 1.f, 1.f,
                    ab, as);
#pragma unroll
            for (int n = 0; n < NTS; ++n) {
                const int col = (sn0 + n) * 8 + g;
                mma3_b(ds[n], ab, as, v[k0 + q][col], v[k0 + q + 4][col]);
            }
        }
        const float pl_top = sm.g[0][si0 + g] * g1_top;
        const float pl_bottom = sm.g[0][si0 + g + 8] * g1_bottom;
#pragma unroll
        for (int n = 0; n < NTS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                st[n][e] = fmaf(st[n][e], e < 2 ? pl_top : pl_bottom, ds[n].value(e));
    };

    // (3) y += A V over the sub-chunks up to this warp's, then store y and
    // the state (after chunk c: the next chunk's S_start).
    auto phase3 = [&](int c) {
        const float (*v)[HD + 8] = sm.v[c % WKV_STAGES];
        const float (*amat)[CHUNK + 4] = sm.amat;
        const float (*ofd)[SUB + 4] = sm.ofd;
#pragma unroll
        for (int k0 = 0; k0 < CHUNK; k0 += 8) {
            if (k0 >= m0 + SUB) break;
            float av[4] = {amat[m0 + g][k0 + q], amat[m0 + g + 8][k0 + q],
                           amat[m0 + g][k0 + q + 4], amat[m0 + g + 8][k0 + q + 4]};
            if (k0 < m0) {  // the off-diagonal block's second half
                av[0] += ofd[g][k0 + q];
                av[1] += ofd[g + 8][k0 + q];
                av[2] += ofd[g][k0 + q + 4];
                av[3] += ofd[g + 8][k0 + q + 4];
            }
            uint32_t ab[4], as[4];
            split4(av, ab, as);
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
                const int col = (nt0 + n) * 8 + g;
                mma3_b(yacc[n], ab, as, v[k0 + q][col], v[k0 + q + 4][col]);
            }
        }
#pragma unroll
        for (int n = 0; n < NTW; ++n)
            store_y(yb, y_ss, c * CHUNK + m0 + g, p.seq_len, (nt0 + n) * 8 + 2 * q, yacc[n]);
        store_state(sm.s, st, si0, sn0, g, q);
    };

    // Three barriers a chunk.  The buffer of chunk c - 1 is free after the
    // first: chunk c - 1 + WKV_STAGES is staged into it.
    for (int c = 0; c < n_chunks; ++c) {
        const int next = c - 1 + WKV_STAGES;
        if (vec)
            mbar_wait(&sm.bar[c % WKV_STAGES], (c / WKV_STAGES) & 1);
        else
            cp_async_wait<WKV_STAGES - 2>();
        if (next < n_chunks) expect(next, next % WKV_STAGES);
        __syncthreads();  // chunk c staged; every read of chunk c - 1 done
        if (next < n_chunks) stage(next, next % WKV_STAGES);
        cp_async_commit();
        phase1(c);
        __syncthreads();  // ra, kb, g and A's diagonal blocks
        phase2(c);
        __syncthreads();  // A complete; every read of the old state done
        phase3(c);
    }
}

struct SsdSmem {
    uint64_t bar[SSD_STAGES];
    alignas(16) float c[SSD_STAGES][CHUNK][HD + 4];  // raw inputs, one buffer a chunk in flight
    float bm[SSD_STAGES][CHUNK][HD + 8];
    float x[SSD_STAGES][CHUNK][HD + 8];
    float dec[SSD_STAGES][CHUNK];
    float pinc[CHUNK];  // prod_{sub-chunk start <= tau <= t} dec_tau
    float sexc[CHUNK];  // prod_{s < tau < sub-chunk end} dec_tau
    float pre[CHUNK];   // prod_{chunk start <= tau <= t} dec_tau
    float suf[CHUNK];   // prod_{s < tau < chunk end} dec_tau
    float ldiag[NSUB][SUB][SUB];  // prod_{s < tau <= t} dec_tau inside a sub-chunk
    float gsub[NSUB];             // each sub-chunk's whole product
    float amat[CHUNK][CHUNK + 4];
    float h[HD][HD + 8];  // h^T at the chunk's start
};

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(const SsdParams p)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    SsdSmem& sm = *reinterpret_cast<SsdSmem*>(smem_raw);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int h = blockIdx.x;
    const long long b = blockIdx.y;
    const float* decb = p.decay + b * p.dec_sb + h * p.dec_sh;
    const float* xb = p.dtx + b * p.x_sb + h * p.x_sh;
    const float* bb_ = p.bm + b * p.b_sb;
    const float* cb = p.cm + b * p.c_sb;
    const long long y_ss = static_cast<long long>(p.heads) * HD;
    float* yb = p.y + b * p.seq_len * y_ss + h * HD;
    const int n_chunks = (p.seq_len + CHUNK - 1) / CHUNK;
    const bool vec = p.vec != 0;

    auto expect = [&](int c, int buf) {
        if (vec && tid == 0)
            mbar_expect_tx(&sm.bar[buf], min(CHUNK, p.seq_len - c * CHUNK) * 3 * HD * 4);
    };
    // Chunk c into buffer buf: one row of one input a lane (lanes 0-11, four
    // rows a warp), the decays (one float a step, any stride) by 4-byte
    // cp.async; or everything 4 bytes at a time.
    auto stage = [&](int c, int buf) {
        const int t0 = c * CHUNK;
        if (vec) {
            if (lane < 12) {
                const int row = warp * 4 + lane / 3, which = lane % 3;
                const bool ok = t0 + row < p.seq_len;
                const long long t = ok ? t0 + row : 0;
                if (which == 0) stage_row_bulk<HD>(sm.c[buf][row], cb + t * p.c_ss, ok, &sm.bar[buf]);
                if (which == 1) stage_row_bulk<HD>(sm.bm[buf][row], bb_ + t * p.b_ss, ok, &sm.bar[buf]);
                if (which == 2) stage_row_bulk<HD>(sm.x[buf][row], xb + t * p.x_ss, ok, &sm.bar[buf]);
            } else if (warp == 0 && lane >= 16) {
                for (int row = lane - 16; row < CHUNK; row += 16) {
                    const bool ok = t0 + row < p.seq_len;
                    cp_async4(&sm.dec[buf][row], ok ? decb + (t0 + row) * p.dec_ss : decb, ok);
                }
            }
        } else {
            stage_rows_4<CHUNK, HD, HD + 4, THREADS>(&sm.c[buf][0][0], cb, p.c_ss, t0, p.seq_len);
            stage_rows_4<CHUNK, HD, HD + 8, THREADS>(&sm.bm[buf][0][0], bb_, p.b_ss, t0, p.seq_len);
            stage_rows_4<CHUNK, HD, HD + 8, THREADS>(&sm.x[buf][0][0], xb, p.x_ss, t0, p.seq_len);
            stage_rows_4<CHUNK, 1, 1, THREADS>(&sm.dec[buf][0], decb, p.dec_ss, t0, p.seq_len);
        }
    };

    for (int e = tid; e < CHUNK * (CHUNK + 4); e += THREADS) (&sm.amat[0][0])[e] = 0.f;
    for (int e = tid; e < HD * (HD + 8); e += THREADS) (&sm.h[0][0])[e] = 0.f;
    if (tid == 0) {
        for (int i = 0; i < SSD_STAGES; ++i) mbar_init(&sm.bar[i], 1);
        mbar_fence_init();
    }
    __syncthreads();
    for (int c = 0; c < SSD_STAGES - 1 && c < n_chunks; ++c) expect(c, c);
    __syncthreads();
    for (int c = 0; c < SSD_STAGES - 1; ++c) {  // one commit group a chunk, empty or not
        if (c < n_chunks) stage(c, c);
        cp_async_commit();
    }

    const int my = warp & 1, m0 = my * SUB;
    const int nt0 = (warp >> 1) * NTW;
    const int si0 = 16 * (warp & 3);  // this warp's state rows n = si0 + g and + 8
    const int sn0 = (warp >> 2) * NTS;
    float hst[NTS][4];  // h^T, columns d = 8 n + 2 q and + 1
#pragma unroll
    for (int n = 0; n < NTS; ++n)
        for (int e = 0; e < 4; ++e) hst[n][e] = 0.f;
    Tile yacc[NTW];  // this warp's output tiles, from (2) of a chunk to (3)
    // C B^T on the lower blocks (0, 0), (1, 0), (1, 1): warps 2-7, one 16 x 8
    // tile each, from (1) of a chunk to (2).
    const int item = warp - 2;
    const int ca = item >= 2, cbb = item >= 4;
    const int cm0 = ca * SUB, cn0 = cbb * SUB + (item & 1) * 8;
    Tile cbt;

    // (1) C B^T's tiles, and the decay factors, each lane from the chunk's
    // decays in registers: warp 0 lane t the products to and from t's
    // sub-chunk edges and the chunk's, warp 1 lane (a, s) Ls inside
    // sub-chunk a.
    auto phase1 = [&](int c) {
        const int buf = c % SSD_STAGES;
        const float (*cc)[HD + 4] = sm.c[buf];
        const float (*bm)[HD + 8] = sm.bm[buf];
        const float* dec = sm.dec[buf];
        if (item >= 0) {
            cbt.zero();
#pragma unroll
            for (int k0 = 0; k0 < HD; k0 += 8) {
                uint32_t ab[4], as[4];
                load_a(cc, cm0, k0, g, q, 1.f, 1.f, ab, as);
                mma3_b(cbt, ab, as, bm[cn0 + g][k0 + q], bm[cn0 + g][k0 + q + 4]);
            }
        }
        if (warp < 2) {
            float dv[CHUNK];
#pragma unroll
            for (int t = 0; t < CHUNK; t += 4)
                *reinterpret_cast<float4*>(&dv[t]) = *reinterpret_cast<const float4*>(&dec[t]);
            if (warp == 0) {
                const int t = lane, a = t / SUB;
                float g0 = 1.f, g1 = 1.f, pin = 1.f, sex = 1.f;
#pragma unroll
                for (int tau = 0; tau < SUB; ++tau) {
                    g0 *= dv[tau];
                    g1 *= dv[SUB + tau];
                    if (tau <= t - a * SUB) pin *= dv[a * SUB + tau];
                }
#pragma unroll
                for (int tau = 0; tau < SUB; ++tau)
                    if (a * SUB + tau > t) sex *= dv[a * SUB + tau];
                sm.pinc[t] = pin;
                sm.sexc[t] = sex;
                sm.pre[t] = (a ? g0 : 1.f) * pin;
                sm.suf[t] = sex * (a ? 1.f : g1);
                if (lane < NSUB) sm.gsub[lane] = lane ? g1 : g0;
            } else {
                const int a = lane / SUB, sl = lane % SUB;
                float pr = 1.f;
#pragma unroll
                for (int tl = 0; tl < SUB; ++tl) {
                    if (tl > sl) pr *= dv[a * SUB + tl];
                    if (tl >= sl) sm.ldiag[a][tl][sl] = pr;
                }
            }
        }
    };

    // (2) A = Ls * C B^T (Ls split at sub-chunk 1's start off the diagonal,
    // from ldiag on it), y from the state, the state's update.
    auto phase2 = [&](int c) {
        const int buf = c % SSD_STAGES;
        const float (*cc)[HD + 4] = sm.c[buf];
        const float (*bm)[HD + 8] = sm.bm[buf];
        const float (*x)[HD + 8] = sm.x[buf];
        if (item >= 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = cm0 + g + (e >> 1) * 8, s = cn0 + 2 * q + (e & 1);
                float l;
                if (cbb < ca)
                    l = sm.pinc[t] * sm.sexc[s];
                else
                    l = s <= t ? sm.ldiag[ca][t - cm0][s - cm0] : 0.f;
                sm.amat[t][s] = cbt.value(e) * l;
            }
        }

        // y = pre * (C h^T_start) for this warp's tiles.
#pragma unroll
        for (int n = 0; n < NTW; ++n) yacc[n].zero();
#pragma unroll
        for (int k0 = 0; k0 < HD; k0 += 8) {
            uint32_t ab[4], as[4];
            load_a(cc, m0, k0, g, q, 1.f, 1.f, ab, as);
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
                const int col = (nt0 + n) * 8 + g;
                mma3_b(yacc[n], ab, as, sm.h[k0 + q][col], sm.h[k0 + q + 4][col]);
            }
        }
#pragma unroll
        for (int n = 0; n < NTW; ++n) yacc[n].scale_rows(sm.pre[m0 + g], sm.pre[m0 + g + 8]);

        // h^T <- P_L h^T + (suf * B)^T X for this warp's state rows.
        Tile dh[NTS];
#pragma unroll
        for (int n = 0; n < NTS; ++n) dh[n].zero();
#pragma unroll
        for (int k0 = 0; k0 < CHUNK; k0 += 8) {
            uint32_t ab[4], as[4];
            load_at(bm, si0, k0, g, q, 1.f, 1.f, sm.suf[k0 + q], sm.suf[k0 + q + 4], ab, as);
#pragma unroll
            for (int n = 0; n < NTS; ++n) {
                const int col = (sn0 + n) * 8 + g;
                mma3_b(dh[n], ab, as, x[k0 + q][col], x[k0 + q + 4][col]);
            }
        }
        const float pl = sm.gsub[0] * sm.gsub[1];
#pragma unroll
        for (int n = 0; n < NTS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) hst[n][e] = fmaf(hst[n][e], pl, dh[n].value(e));
    };

    // (3) y += A X over the sub-chunks up to this warp's, then store y and
    // the state.
    auto phase3 = [&](int c) {
        const float (*x)[HD + 8] = sm.x[c % SSD_STAGES];
#pragma unroll
        for (int k0 = 0; k0 < CHUNK; k0 += 8) {
            if (k0 >= m0 + SUB) break;
            uint32_t ab[4], as[4];
            load_a(sm.amat, m0, k0, g, q, 1.f, 1.f, ab, as);
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
                const int col = (nt0 + n) * 8 + g;
                mma3_b(yacc[n], ab, as, x[k0 + q][col], x[k0 + q + 4][col]);
            }
        }
#pragma unroll
        for (int n = 0; n < NTW; ++n)
            store_y(yb, y_ss, c * CHUNK + m0 + g, p.seq_len, (nt0 + n) * 8 + 2 * q, yacc[n]);
        store_state(sm.h, hst, si0, sn0, g, q);
    };

    // Three barriers a chunk, as in the WKV-6 kernel.
    for (int c = 0; c < n_chunks; ++c) {
        const int next = c - 1 + SSD_STAGES;
        if (vec) mbar_wait(&sm.bar[c % SSD_STAGES], (c / SSD_STAGES) & 1);
        cp_async_wait<SSD_STAGES - 2>();  // the decays (and everything, off 16 bytes)
        if (next < n_chunks) expect(next, next % SSD_STAGES);
        __syncthreads();
        if (next < n_chunks) stage(next, next % SSD_STAGES);
        cp_async_commit();
        phase1(c);
        __syncthreads();
        phase2(c);
        __syncthreads();
        phase3(c);
    }
}

bool bad_shape(int batch, int seq_len, int heads)
{
    return batch < 1 || batch > 65535 || seq_len < 1 || heads < 1 || heads > 0x7fffffff / HD;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// 16-byte copies need every base and every (batch, sequence, head) stride
// on a 16-byte boundary.
bool vec_ok(const void* const* ptrs, int n_ptrs, const long long* strides, int n_strides)
{
    for (int i = 0; i < n_ptrs; ++i)
        if (!aligned16(ptrs[i])) return false;
    for (int i = 0; i < n_strides; ++i)
        if (strides[i] % 4 != 0) return false;
    return true;
}

WkvParams wkv_params(const void* r, const void* k, const void* v, const void* w, const void* u,
                     void* y, const long long* strides, int seq_len, int heads)
{
    WkvParams p;
    p.r = static_cast<const float*>(r);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u);
    p.y = static_cast<float*>(y);
    p.r_sb = strides[0]; p.r_ss = strides[1]; p.r_sh = strides[2];
    p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
    p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
    p.w_sb = strides[9]; p.w_ss = strides[10]; p.w_sh = strides[11];
    p.seq_len = seq_len;
    p.heads = heads;
    const void* ptrs[4] = {r, k, v, w};
    p.vec = vec_ok(ptrs, 4, strides, 12);
    return p;
}

SsdParams ssd_params(const void* decay, const void* dtx, const void* b, const void* c, void* y,
                     const long long* strides, int seq_len, int heads)
{
    SsdParams p;
    p.decay = static_cast<const float*>(decay);
    p.dtx = static_cast<const float*>(dtx);
    p.bm = static_cast<const float*>(b);
    p.cm = static_cast<const float*>(c);
    p.y = static_cast<float*>(y);
    p.dec_sb = strides[0]; p.dec_ss = strides[1]; p.dec_sh = strides[2];
    p.x_sb = strides[3]; p.x_ss = strides[4]; p.x_sh = strides[5];
    p.b_sb = strides[6]; p.b_ss = strides[7];
    p.c_sb = strides[8]; p.c_ss = strides[9];
    p.seq_len = seq_len;
    p.heads = heads;
    const void* ptrs[3] = {dtx, b, c};
    p.vec = vec_ok(ptrs, 3, strides + 3, 7);  // the decay is copied 4 bytes at a time
    return p;
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the cudaError_t of the launch (0 = queued).
// strides: element strides (batch, sequence, head) of r, k, v and w (12).
int wkv6_scan_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                     void* y, const long long* strides, int batch, int seq_len, int heads,
                     void* stream)
{
    if (bad_shape(batch, seq_len, heads)) return static_cast<int>(cudaErrorInvalidValue);
    const WkvParams p = wkv_params(r, k, v, w, u, y, strides, seq_len, heads);
    const int smem = static_cast<int>(sizeof(WkvSmem));
    const cudaError_t err =
        cudaFuncSetAttribute(wkv6_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(heads, batch);
    wkv6_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// strides: decay (batch, sequence, head), dtx (batch, sequence, head), b
// (batch, sequence), c (batch, sequence): 10 element strides.  state must be 64.
int ssd_scan_launch(const void* decay, const void* dtx, const void* b, const void* c, void* y,
                    const long long* strides, int batch, int seq_len, int heads, int state,
                    void* stream)
{
    if (bad_shape(batch, seq_len, heads) || state != HD)
        return static_cast<int>(cudaErrorInvalidValue);
    const SsdParams p = ssd_params(decay, dtx, b, c, y, strides, seq_len, heads);
    const int smem = static_cast<int>(sizeof(SsdSmem));
    const cudaError_t err =
        cudaFuncSetAttribute(ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(heads, batch);
    ssd_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

const char* recurrence_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
