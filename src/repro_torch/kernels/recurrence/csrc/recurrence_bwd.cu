// The backward passes of the recurrence scans for NVIDIA Hopper (sm_90a):
// the gradients of the RWKV-6 WKV scan and of the Mamba2 (SSD) state scan
// (recurrence.cu) against their outputs' gradient dy, each over a whole
// sequence in one launch.
//
// Replaces no Pallas kernel.  The JAX package obtains this work by
// differentiating the lax.scan of rwkv_time_mix_seq and mamba_seq through
// _chunked_scan's checkpoints (src/repro/models/rwkv.py:77-102, used at :154
// and in src/repro/models/ssm.py:108): the forward scan's carries are saved
// at chunk boundaries and each chunk is run again, step by step, in the
// backward.
//
// wkv6_scan_bwd: r, k, v, w (B, S, H, 64) float32, u (H, 64), dy (B, S, H,
// 64); writes dr, dk and dlogw (the gradient of log w), (B, S, H, 64), each
// half's share of dv, dv_part (2, B, S, H, 64), and du_part (B, H, 64), each
// (b, h)'s share of du; the caller sums dv_part over its first dimension and
// du_part over the batch.  ssd_scan_bwd: decay (B, S, H), dtx (B, S, H, 64),
// b and c (B, S, 64), dy (B, S, H, 64); writes the halves' shares of dlogdec
// and ddtx, dlog_part (2, B, S, H) and dx_part (2, B, S, H, 64), and the
// per-head db_h and dc_h (B, S, H, 64), summed over the heads by the caller
// (b and c are shared by every head).  No float atomics: every sum is formed
// in a fixed order, so two launches agree bit for bit.
//
// The algorithm (kernels/recurrence/ref.py's wkv6_scan_bwd_chunked_ref and
// ssd_scan_bwd_chunked_ref are it in plain PyTorch).  The sequence is cut
// into chunks of L = 32 steps.  A first pass runs the chunks forward from the
// zero state and writes each chunk's start state into a scratch buffer
// (B * H * n_chunks * 64 * 64 floats, the caller's): the backward needs them
// in reverse order and a state cannot be stepped back without dividing by a
// decay.  The second pass runs the chunks in reverse, carrying G, the
// gradient of the state at the chunk's end (zero after the last chunk).  For
// WKV-6, with S0 the chunk's start state and, per key channel i, P_t =
// prod_{tau<t} w, Q_s = prod_{s<tau<L} w, P_L the whole chunk's product and
// W(s,t) = prod_{s<tau<t} w (s < t), D[t,s] = dy_t . v_s and A[t,s] =
// sum_i r_t k_s W (A[t,t] = sum_i r_t u k_t, the bonus):
//
//     S_end   = diag(P_L) S0 + (k Q)^T V                 (the first pass)
//     dv_s    = sum_{t>=s} A[t,s] dy_t + sum_i Q_s[i] k_s[i] G[i,:]
//     dr'_t   = P_t * (S0 dy_t) + sum_{s<t} D[t,s] k_s W(s,t)
//     dki_s   = sum_{t>s} D[t,s] r_t W(s,t),   dke_s = Q_s * (G v_s)
//     dr_t    = dr'_t + u k_t D[t,t],          dk_s = dki_s + dke_s + u r_s D[s,s]
//     du     += sum_t r_t k_t D[t,t]
//     dlogw_t = sum_{s<t<tau} X[tau,s] + sum_{tau>t} r_tau P_tau (S0 dy_tau)
//               + sum_{s<t} k_s dke_s + P_L * rowsum(G * S0)
//     G      <- diag(P_L) G + (r P)^T dy
//
// with X[tau,s] = D[tau,s] r_tau k_s W(s,tau) per channel.  dlogw counts
// each product of the expansion that holds w_t once, as the derivative in
// log w_t does: the pairs of steps s < t < tau inside the chunk, those
// through the start state (tau > t) and those through the end state (s < t,
// and the start state's).  Each is summed directly, never as the difference
// of two larger sums, so a gradient that is 0 (at t = 0, where the state is
// zero, or where w_t is exactly 0) comes out 0, and nothing divides by a
// decay: a decay of exactly 0 gives finite gradients.  The SSD is the same
// with the state h (64 x N: head-dim row d, state n), x = dtx, B, C and one
// decay a step, y_t reading the state after step t: pre_t = prod_{tau<=t},
// suf_s = prod_{s<tau<L}, Ls[t,s] = prod_{s<tau<=t} (s <= t), E[t,s] =
// dy_t . x_s,
//
//     h_end   = P_L h0 + (suf x)^T B                     (the first pass)
//     dc_t    = pre_t (h0^T dy_t) + sum_{s<=t} Ls E[t,s] b_s
//     db_s    = sum_{t>=s} Ls E[t,s] c_t + suf_s (G^T x_s)
//     dx_s    = sum_{t>=s} Ls (c_t . b_s) dy_t + suf_s (G b_s)
//     dlog_t  = sum_{tau>=t} c_tau . dc0_tau + sum_{s<t<=tau} M[tau,s]
//               + sum_{s<t} b_s . dbe_s + P_L * sum(G * h0)
//     G      <- P_L G + (pre dy)^T C
//
// with dc0 and dbe the start and end states' parts of dc and db and M[tau,s]
// = Ls[tau,s] E[tau,s] (c_tau . b_s).  W(s,t) and Ls are running products
// along t, never quotients.
//
// The pairs of dlogw in O(L^2) a chunk.  With lanes for s, a warp carries
// W(s,tau) along tau for each of its channels and forms, at each tau, the
// row's terms Y[tau,s] = D[tau,s] k_s W(s,tau) (X = r_tau Y); a prefix sum
// across the lanes gives R[tau][t] = sum_{s<t} Y[tau,s] (held in lane t - 1,
// the lanes shifted once at the end), which adds r_tau R[tau][t] for tau > t
// into pairs_t: a running sum along tau.  R[tau][tau] is dr'_t's pair part.
// Each sum adds terms (the prefix is a tree of sums of lanes below, never a
// difference), so t = 0's is exactly 0 and a zero w_t zeroes every term of
// pairs_t.  The same running W(s,tau) gives dki.  A (a sum over the
// channels) is formed as the forward kernel forms it: its off-diagonal
// 16 x 16 block splits W(s,t) at step 16 into ra_t . kb_s on the tensor
// cores, its diagonal blocks run on the CUDA cores, lanes over channel
// parts.  The SSD's pairs are scalars M[tau,s], the same prefix across
// lanes, summed for tau >= t.
//
// The grid: two CTAs for each (b, h), 2 B H in all (160 at rwkv6-3b's B = 2,
// H = 40; 256 at zamba2-1.2b's H = 64), one wave of at most two CTAs an SM
// (__launch_bounds__(256, 2); shared memory under 113 KB a CTA).  Each CTA
// takes half of the state's key dimension: 32 key channels i of WKV-6's
// state (rows of S and G), 32 state columns n of the SSD's (columns of h and
// G).  That is the dimension the state's input side sums over (S = sum
// k v^T over i; h = sum x b^T over n), so every output of the other side is
// local to a half and one is a partial: WKV-6's dr, dk, dlogw and du are the
// half's channels, dv = A^T dy + (k Q) G sums over all channels (A and the G
// term), so each half writes its share; the SSD's dc and db are the half's
// columns, dx (its G term sums over n) and dlog (sums over n) are shares.
// The halves' shares are summed by the caller in a fixed order (dv_part[0] +
// dv_part[1]; chosen over exchanging them through a 2-CTA cluster's shared
// memory, which would add a cluster barrier a chunk, for one extra
// elementwise pass over one output).  The other split (WKV-6's value
// columns j, the SSD's rows d) would leave D or E partial, and four (three)
// outputs as shares, and each half would run the per-channel pair work of
// all 64 channels.  The pair matrices D (WKV-6) and E, C B^T (SSD) sum over
// the whole head dim, so each CTA forms them whole from full rows of dy and
// v (x, b, c): 32 x 32 x 64 products, a little work twice for no exchange.
// The bonus A[t,t] enters dv through the first half alone, and the SSD's
// Ls (C B^T) dy term of dx is split by d between the halves, so at S = 1
// (G = 0) the shares are the whole gradient and 0.
//
// The tensor cores.  Every product with a 64 x 64 state or its gradient,
// D and A's off-diagonal block is mma.sync.m16n8k8 in TF32 with the 3xTF32
// split (recurrence_common.cuh; recurrence.cu's note): WKV-6's recompute
// (k Q)^T V, S0 dy^T, G v^T, dv's [A^T | k Q] [dy; G] and G's update
// (r P)^T dy; the SSD's recompute, dy h0, x G, b G^T, dc's Ls E b, db's
// (Ls E)^T c, dx's (Ls C B^T)^T dy and G's update.  Their tiles are 32 or
// 64 rows by 32 or 64 columns with K of 32 or 64 a chunk: one warp a 16 x 8
// tile or two, eight warps, where wgmma's 64-row tiles would leave a 32-row
// product half empty and its asynchronous issue has no long K loop to hide.
// The SSD's E and C B^T run in float64 on the tensor cores
// (mma.sync.m8n8k4.f64, accumulated in float64 and rounded once): in
// 3xTF32 (their diagonals in float64) the 176 edge cases failed, dlogdec
// 1.31e-4 of its (b, h)'s largest at S = 2, H = 40, where dlog_1 is the one
// product M[1,0] = a_1 E[1,0] (c_1 . b_0) and a 64-term dot product that
// cancels carries the rounding of its largest terms into the gradient's
// scale; in float64, 1.642e-6.  WKV-6's D holds the cases in 3xTF32; its
// diagonal and A's (the bonus, over all 64 channels in the first half) are
// the whole gradient at S = 1 (dr_0 = u k_0 D[0,0], dv_0 = A[0,0] dy_0) and
// are formed in float64 and rounded once.  Worst error over every gradient
// of the cases, the rest unchanged: both diagonals in float64 1.357e-5;
// both in float32 2.849e-5; D's from its 3xTF32 tile and the bonus in
// float32 6.397e-5; the bonus split between the halves in float32 (each
// half's share of dv rounded apart) 3.58e-4 at S = 1, H = 40, a failure.
// Float64 keeps these two 32-entry diagonals a chunk at a seventh of the
// limit for no measurable time.  What stays off the tensor cores: the
// decays' running products, the per-channel pair work above (WKV-6, 496
// pairs x 32 channels a CTA and chunk, in float32) and A's diagonal blocks.
//
// Staging.  Each chunk's rows (WKV-6: the half's r, k and w, all of v and dy;
// SSD: c, b, x, dy; the decays) and its start state are brought by the bulk
// copy engine (cp.async.bulk, one row a copy) on an mbarrier, a chunk ahead
// into the second of two buffers, issued after the barrier that frees it;
// the decays, and inputs whose bases or strides are not on 16 bytes, by
// 4-byte cp.async.  A chunk's work (~10^4 cycles) is far longer than a
// copy's latency, and a third buffer (40 KB) would not fit two CTAs an SM.
// Barriers a chunk: WKV-6 four (the products with the state, G and D; the
// pair work and A's operands; A and the outputs' staging; the stores, dv and
// G), SSD three (products; the pair matrices; the chunk's products with
// them).
//
// What bounds them on the H100: the function must move 0.755 GB at
// rwkv6-3b's training shape (B = 2, S = 4096, H = 40; 0.225 ms at 3.35
// TB/s) and 0.415 GB at zamba2-1.2b's (H = 64), whose products bound it
// (0.168 ms at 495 TFLOP/s).  The kernels' own work is larger: each CTA
// reads the chunk-start states back, forms D (E, C B^T) whole, and WKV-6's
// pair work runs on the CUDA cores with a prefix sum across lanes a pair
// row and channel (about 2.5 x 10^3 instructions a warp and chunk, a third
// of them shuffles, which issue at a quarter of the float32 rate).

#include "recurrence_common.cuh"

namespace {

constexpr int HD = 64;      // head dim (WKV-6), head dim and state size (SSD)
constexpr int HALF = HD / 2;  // the key channels (state columns) of one CTA
constexpr int L = 32;       // time steps a chunk
constexpr int SUB = 16;     // a sub-chunk: A's diagonal blocks are SUB x SUB
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;   // chunk buffers: the one read now and the next
constexpr int RP = HD + 4;  // row stride of 64-wide arrays
constexpr int CP = HALF + 4;  // row stride of 32-wide arrays
static_assert(L == 32 && HALF == 32 && WARPS == 8,
              "a warp's lanes are a chunk's steps, its eight warps four channels each");

// Shared-memory row strides: a stride of 4 mod 32 floats puts the fragment
// loads of an operand read by rows (a row-major A, or B as [n][k]) on 32
// distinct banks; operands read by columns take two-way conflicts.

struct WkvBwdParams {
    const float* r;
    const float* k;
    const float* v;
    const float* w;
    const float* u;   // (H, 64) contiguous
    const float* dy;  // (B, S, H, 64) contiguous, 16-byte aligned
    float* dr;        // (B, S, H, 64) contiguous, and dk, dlw
    float* dk;
    float* dlw;
    float* dv_part;   // (2, B, S, H, 64): each half's share of dv
    float* du_part;   // (B, H, 64)
    float* states;    // (B * H * 2, n_chunks, 32, 64) scratch
    long long r_sb, r_ss, r_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long w_sb, w_ss, w_sh;
    int seq_len;
    int heads;
    int batch;
    int vec;  // every base and stride of r, k, v, w allows 16-byte copies
};

struct SsdBwdParams {
    const float* decay;  // (B, S, H)
    const float* dtx;    // (B, S, H, 64)
    const float* bm;     // (B, S, 64)
    const float* cm;     // (B, S, 64)
    const float* dy;     // (B, S, H, 64) contiguous, 16-byte aligned
    float* dlog_part;    // (2, B, S, H): each half's share of dlogdec
    float* dx_part;      // (2, B, S, H, 64): each half's share of ddtx
    float* db;           // (B, S, H, 64) contiguous, and dc
    float* dc;
    float* states;       // (B * H * 2, n_chunks, 64, 32) scratch
    long long dec_sb, dec_ss, dec_sh;
    long long x_sb, x_ss, x_sh;
    long long b_sb, b_ss;
    long long c_sb, c_ss;
    int seq_len;
    int heads;
    int batch;
    int vec;  // every base and stride of dtx, b and c allows 16-byte copies
};

// The sum of x over the 8 lanes of one group (lanes 8 m .. 8 m + 7), in a
// fixed order; every lane gets it.
template <typename T>
__device__ __forceinline__ T group8_sum(T x)
{
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    return x;
}

__device__ __forceinline__ float warp_sum(float x)
{
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// sum_{lane' < lane} x: a tree of sums of the lanes below (Kogge-Stone,
// then a shift), each a sum of terms; lane 0 gets exactly 0.
__device__ __forceinline__ float prefix_excl(float x, int lane)
{
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
    }
    const float y = __shfl_up_sync(0xffffffffu, x, 1);
    return lane == 0 ? 0.f : y;
}

// sum_{lane' > lane} x (lane 31 gets 0), or sum_{lane' >= lane} x when incl.
__device__ __forceinline__ float suffix(float x, int lane, bool incl)
{
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_down_sync(0xffffffffu, x, off);
        if (lane + off < 32) x += y;
    }
    if (incl) return x;
    const float y = __shfl_down_sync(0xffffffffu, x, 1);
    return lane == 31 ? 0.f : y;
}

// The split A operand whose entries are x * y elementwise: row-major
// (A[m][k] = x[m][k] y[m][k]) or transposed (A[m][k] = x[k][m] y[k][m]).
template <int ST>
__device__ __forceinline__ void load_a_prod(const float (*x)[ST], const float (*y)[ST], int m0,
                                            int k0, int g, int q, uint32_t (&big)[4],
                                            uint32_t (&small)[4])
{
    const float av[4] = {x[m0 + g][k0 + q] * y[m0 + g][k0 + q],
                         x[m0 + g + 8][k0 + q] * y[m0 + g + 8][k0 + q],
                         x[m0 + g][k0 + q + 4] * y[m0 + g][k0 + q + 4],
                         x[m0 + g + 8][k0 + q + 4] * y[m0 + g + 8][k0 + q + 4]};
    split4(av, big, small);
}

template <int ST>
__device__ __forceinline__ void load_at_prod(const float (*x)[ST], const float (*y)[ST], int m0,
                                             int k0, int g, int q, uint32_t (&big)[4],
                                             uint32_t (&small)[4])
{
    const float av[4] = {x[k0 + q][m0 + g] * y[k0 + q][m0 + g],
                         x[k0 + q][m0 + g + 8] * y[k0 + q][m0 + g + 8],
                         x[k0 + q + 4][m0 + g] * y[k0 + q + 4][m0 + g],
                         x[k0 + q + 4][m0 + g + 8] * y[k0 + q + 4][m0 + g + 8]};
    split4(av, big, small);
}

// d += a * b for one 8 x 8 x 4 float64 tile on the tensor cores (a row-major
// 8 x 4: a = A[g][q]; b 4 x 8: b = B[q][g]; d = D[g][2 q] and D[g][2 q + 1]),
// from float32 operands (exact in float64).
__device__ __forceinline__ void dmma_m8n8k4(double (&d)[2], float a, float b)
{
    const double ad = a, bd = b;
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
                 : "+d"(d[0]), "+d"(d[1])
                 : "d"(ad), "d"(bd));
}

// Rows t and t + 8 (columns col, col + 1) of a (.., S, ..) output from
// four values, rows past seq_len dropped.
__device__ __forceinline__ void store_pair_rows(float* base, long long ss, int t, int seq_len,
                                                int col, float v0, float v1, float v2, float v3)
{
    if (t < seq_len) *reinterpret_cast<float2*>(base + t * ss + col) = make_float2(v0, v1);
    if (t + 8 < seq_len) *reinterpret_cast<float2*>(base + (t + 8) * ss + col) = make_float2(v2, v3);
}

// Every thread's writes to global memory visible to the bulk copies that
// read them after the next __syncthreads (the generic and async proxies).
__device__ __forceinline__ void fence_proxy_async()
{
    asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The loads of the two passes, numbered ld = 0, 1, ...: the first pass's
// chunks 0 .. n - 2 forward, then the second pass's n - 1 .. 0; load ld
// lands in buffer ld % 2 and completes phase (ld / 2) % 2 of its barrier.
struct LoadPlan {
    int n_chunks;
    __device__ __forceinline__ int count() const { return 2 * n_chunks - 1; }
    __device__ __forceinline__ bool second(int ld) const { return ld >= n_chunks - 1; }
    __device__ __forceinline__ int chunk(int ld) const
    {
        return second(ld) ? 2 * (n_chunks - 1) - ld : ld;
    }
};

// ============================================================================
// WKV-6
// ============================================================================

struct WkvStage {
    float r[L][CP];  // the half's channels
    float k[L][CP];
    float w[L][CP];
    float v[L][RP];  // v and s0 adjacent: after a chunk's first phase both
    float s0[L][RP];  // are dead and hold A and its off-diagonal block's operands
    float dy[L][RP];
};
static_assert(2 * L * RP >= (L + 2 * SUB) * CP, "A, ra and kb fit in v and s0");

// A's entries in its diagonal 16 x 16 blocks below the diagonal, over the
// half's 32 channels, as recurrence.cu's wkv_diag_blocks forms them: warps
// 4 a .. 4 a + 3 take sub-chunk a's block, warp gi of them the columns s =
// gi, 7 - gi, 8 + gi and 15 - gi (34 (t, s) pairs each); a lane takes one of
// the four (slot) and four of the 32 channels (part) and carries k_s times
// the running product of w along t; each (t, s) sum is added across the
// parts by shuffles, in a fixed order.
__device__ __forceinline__ void wkv_diag_pairs(const float (*r)[CP], const float (*k)[CP],
                                               const float (*w)[CP], float (*amat)[CP], int warp,
                                               int lane)
{
    const int base = (warp >> 2) * SUB, gi = warp & 3;
    const int slot = lane & 3, part = lane >> 2;
    const int s = slot == 0 ? gi : slot == 1 ? 7 - gi : slot == 2 ? 8 + gi : 15 - gi;
    float e[4], sums[SUB - 1];
    *reinterpret_cast<float4*>(e) = *reinterpret_cast<const float4*>(&k[base + s][4 * part]);
#pragma unroll
    for (int t = 1; t < SUB; ++t) {
        sums[t - 1] = 0.f;
        if (t <= gi) continue;  // no column of this warp lies before t
        float rt[4], wt[4];
        *reinterpret_cast<float4*>(rt) = *reinterpret_cast<const float4*>(&r[base + t][4 * part]);
        *reinterpret_cast<float4*>(wt) = *reinterpret_cast<const float4*>(&w[base + t][4 * part]);
        const bool live = t > s;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            acc = fmaf(rt[c], e[c], acc);
            e[c] = live ? e[c] * wt[c] : e[c];
        }
        sums[t - 1] = live ? acc : 0.f;  // A[t][s]
    }
#pragma unroll
    for (int j = 0; j < SUB - 1; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sums[j] += __shfl_xor_sync(0xffffffffu, sums[j], off);
    if (part == 0) {
#pragma unroll
        for (int t = 1; t < SUB; ++t)
            if (t > s) amat[base + t][base + s] = sums[t - 1];
    }
}

struct WkvBwdSmem {
    uint64_t bar[STAGES];
    alignas(16) WkvStage st[STAGES];
    alignas(16) float g[HALF][RP];  // G's rows of the half's channels
    float d[L][CP];   // D[t][s]; then dlogw's rows, staged for the stores
    float x1[L][CP];  // (S0 dy^T)[i][t]; then dr's rows
    float x2[L][CP];  // (G v^T)[i][s]; then dk's rows
    float p[L][CP];   // P_t[i]
    float q[L][CP];   // Q_s[i]
    float u[HD];
    float pl[HALF];   // P_L[i]
    float gs[HALF];   // rowsum(G * S0)
    float ddiag[L];   // D[t][t], in float64 and rounded once
    float du[HALF];   // the half's channels' share of du, over the chunks so far
    float bonus[L];   // A[t][t] = sum_i r_t u k_t over all 64 channels (half 0)
};

__global__ void __launch_bounds__(THREADS, 2) wkv6_scan_bwd_kernel(const WkvBwdParams p)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    WkvBwdSmem& sm = *reinterpret_cast<WkvBwdSmem*>(smem_raw);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int half = blockIdx.x & 1, h = blockIdx.x >> 1;
    const long long b = blockIdx.y;
    const int c0 = half * HALF;  // the half's first channel
    const float* rb = p.r + b * p.r_sb + h * p.r_sh;
    const float* kb = p.k + b * p.k_sb + h * p.k_sh;
    const float* vb = p.v + b * p.v_sb + h * p.v_sh;
    const float* wb = p.w + b * p.w_sb + h * p.w_sh;
    const long long o_ss = static_cast<long long>(p.heads) * HD;  // outputs' row stride
    const long long o_base = b * p.seq_len * o_ss + h * HD;
    const float* dyb = p.dy + o_base;
    float* dvb = p.dv_part + half * (static_cast<long long>(p.batch) * p.seq_len * o_ss) + o_base;
    const int n_chunks = (p.seq_len + L - 1) / L;
    float* states = p.states + ((b * p.heads + h) * 2 + half) * static_cast<long long>(n_chunks) * HALF * HD;
    const bool vec = p.vec != 0;
    const LoadPlan plan{n_chunks};

    // Load ld into its buffer.  Bulk copies: one row of one input a thread;
    // thread 0 announces their bytes before the __syncthreads that precedes
    // them.  Off 16 bytes, r, k, w and v by 4-byte cp.async (one commit
    // group a load, empty or not).
    auto expect = [&](int ld) {
        if (tid != 0) return;
        const int rows = min(L, p.seq_len - plan.chunk(ld) * L);
        uint32_t bytes = 0;
        if (plan.second(ld))
            bytes = rows * (vec ? (3 * HALF + 2 * HD) * 4 : HD * 4) + L * HD * 4;
        else if (vec)
            bytes = rows * (2 * HALF + HD) * 4;
        mbar_expect_tx(&sm.bar[ld % STAGES], bytes);
    };
    auto issue = [&](int ld) {
        const int c = plan.chunk(ld), t0 = c * L, buf = ld % STAGES;
        WkvStage& s = sm.st[buf];
        uint64_t* bar = &sm.bar[buf];
        const bool second = plan.second(ld);
        fence_proxy_async();
        if (vec) {
            const int which = tid >> 5, row = lane;  // which: 0 r, 1 k, 2 w, 3 v, 4 s0, 5 dy
            const bool ok = t0 + row < p.seq_len;
            const long long t = ok ? t0 + row : 0;
            if (which == 0 && second) stage_row_bulk<HALF>(s.r[row], rb + t * p.r_ss + c0, ok, bar);
            if (which == 1) stage_row_bulk<HALF>(s.k[row], kb + t * p.k_ss + c0, ok, bar);
            if (which == 2) stage_row_bulk<HALF>(s.w[row], wb + t * p.w_ss + c0, ok, bar);
            if (which == 3) stage_row_bulk<HD>(s.v[row], vb + t * p.v_ss, ok, bar);
        } else {
            if (second) stage_rows_4<L, HALF, CP, THREADS>(&s.r[0][0], rb + c0, p.r_ss, t0, p.seq_len);
            stage_rows_4<L, HALF, CP, THREADS>(&s.k[0][0], kb + c0, p.k_ss, t0, p.seq_len);
            stage_rows_4<L, HALF, CP, THREADS>(&s.w[0][0], wb + c0, p.w_ss, t0, p.seq_len);
            stage_rows_4<L, HD, RP, THREADS>(&s.v[0][0], vb, p.v_ss, t0, p.seq_len);
        }
        if (second) {
            const int which = tid >> 5, row = lane;
            const bool ok = t0 + row < p.seq_len;
            if (which == 4)
                bulk_copy(s.s0[row], states + (static_cast<long long>(c) * HALF + row) * HD, HD * 4, bar);
            if (which == 5) stage_row_bulk<HD>(s.dy[row], dyb + (ok ? t0 + row : 0) * o_ss, ok, bar);
        }
        cp_async_commit();
    };
    auto wait = [&](int ld) {
        mbar_wait(&sm.bar[ld % STAGES], (ld / STAGES) & 1);
        cp_async_wait<0>();
    };

    if (tid == 0) {
        for (int i = 0; i < STAGES; ++i) mbar_init(&sm.bar[i], 1);
        mbar_fence_init();
    }
    if (tid < HD) sm.u[tid] = p.u[h * HD + tid];
    if (tid < HALF) sm.du[tid] = 0.f;
    __syncthreads();

    // The state's tiles a warp: rows m0 + g and + 8 of the half's 32, columns
    // of n-tiles nt0 and nt0 + 1 (the same tiles for dv's rows s).  The
    // first pass keeps S in registers; the second keeps G in shared memory
    // alone, each thread updating its own entries.
    const int m0 = 16 * (warp & 1), nt0 = 2 * (warp >> 1);
    float st[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = 0.f;

    // Pass 1: the chunk-start states, S <- diag(P_L) S + (k Q)^T V.
    if (n_chunks > 1) {
        expect(0);
        __syncthreads();
        issue(0);
    }
    for (int c = 0; c < n_chunks; ++c) {
        store_state(reinterpret_cast<float (*)[HD]>(states + static_cast<long long>(c) * HALF * HD),
                    st, m0, nt0, g, q);
        if (c == n_chunks - 1) break;
        const int ld = c;
        wait(ld);
        const bool next = ld + 1 < n_chunks - 1;  // the second pass's first load waits for the states
        if (next) expect(ld + 1);
        __syncthreads();  // load ld staged; every read of load ld - 1 done
        if (next) issue(ld + 1);
        const WkvStage& s = sm.st[ld % STAGES];
        if (warp == 0) {  // lane: channel; Q backward and P_L
            float pr = 1.f;
#pragma unroll
            for (int t = L - 1; t >= 0; --t) {
                sm.q[t][lane] = pr;
                pr *= s.w[t][lane];
            }
            sm.pl[lane] = pr;
        }
        __syncthreads();
        Tile ds[2];
        ds[0].zero();
        ds[1].zero();
#pragma unroll
        for (int k0 = 0; k0 < L; k0 += 8) {
            uint32_t ab[4], as[4];
            load_at_prod<CP>(s.k, sm.q, m0, k0, g, q, ab, as);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const int col = (nt0 + n) * 8 + g;
                mma3_b(ds[n], ab, as, s.v[k0 + q][col], s.v[k0 + q + 4][col]);
            }
        }
        const float pt = sm.pl[m0 + g], pb = sm.pl[m0 + g + 8];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[n][e] = fmaf(st[n][e], e < 2 ? pt : pb, ds[n].value(e));
    }

    // G starts at zero.
    for (int e = tid; e < HALF * RP; e += THREADS) (&sm.g[0][0])[e] = 0.f;
    fence_proxy_async();
    {
        const int ld = n_chunks - 1;
        expect(ld);
        __syncthreads();  // every state stored, G zeroed
        issue(ld);
    }

    const int cw = 4 * warp;  // this warp's four channels in the pair work

    for (int idx = 0; idx < n_chunks; ++idx) {
        const int ld = n_chunks - 1 + idx, c = n_chunks - 1 - idx, t0 = c * L;
        WkvStage& s = sm.st[ld % STAGES];
        wait(ld);
        const bool next = ld + 1 < plan.count();
        if (next) expect(ld + 1);
        __syncthreads();  // (0) load ld staged, G written; every read of load ld - 1 done
        if (next) issue(ld + 1);

        // (A) D, S0 dy^T and G v^T on the tensor cores (one 16 x 8 tile of
        // each a warp); the decays' products (warps 0, 1); D's diagonal in
        // float64 and rowsum(G * S0); the bonus (half 0, in float64 over all
        // 64 channels, the partner half's r and k read from global memory).
        {
            const int n0 = 8 * (warp >> 1);
            Tile td, t1, t2;
            td.zero();
            t1.zero();
            t2.zero();
#pragma unroll
            for (int k0 = 0; k0 < HD; k0 += 8) {
                uint32_t ab[4], as[4];
                const float vb0 = s.v[n0 + g][k0 + q], vb1 = s.v[n0 + g][k0 + q + 4];
                load_a<RP>(s.dy, m0, k0, g, q, 1.f, 1.f, ab, as);
                mma3_b(td, ab, as, vb0, vb1);
                load_a<RP>(s.s0, m0, k0, g, q, 1.f, 1.f, ab, as);
                mma3_b(t1, ab, as, s.dy[n0 + g][k0 + q], s.dy[n0 + g][k0 + q + 4]);
                load_a<RP>(sm.g, m0, k0, g, q, 1.f, 1.f, ab, as);
                mma3_b(t2, ab, as, vb0, vb1);
            }
            store_tile<CP>(sm.d, m0, n0, g, q, td);
            store_tile<CP>(sm.x1, m0, n0, g, q, t1);
            store_tile<CP>(sm.x2, m0, n0, g, q, t2);
        }
        if (warp == 0) {
            float pr = 1.f;
#pragma unroll
            for (int t = 0; t < L; ++t) {
                sm.p[t][lane] = pr;
                pr *= s.w[t][lane];
            }
            sm.pl[lane] = pr;
        } else if (warp == 1) {
            float pr = 1.f;
#pragma unroll
            for (int t = L - 1; t >= 0; --t) {
                sm.q[t][lane] = pr;
                pr *= s.w[t][lane];
            }
        }
        const int gt = tid >> 3, part = tid & 7;  // a row (step or channel), 8 of its 64 columns
        {
            double acc = 0.0;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                acc = fma(static_cast<double>(s.dy[gt][8 * part + j]),
                          static_cast<double>(s.v[gt][8 * part + j]), acc);
            acc = group8_sum(acc);
            float gsum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) gsum = fmaf(sm.g[gt][8 * part + j], s.s0[gt][8 * part + j], gsum);
            gsum = group8_sum(gsum);
            if (part == 0) {
                sm.ddiag[gt] = static_cast<float>(acc);
                sm.gs[gt] = gsum;
            }
        }
        if (half == 0) {  // A[t][t] = sum_i r_t u k_t: 4 own and 4 partner channels a thread
            float orr[4] = {0.f, 0.f, 0.f, 0.f}, okk[4] = {0.f, 0.f, 0.f, 0.f};
            if (t0 + gt < p.seq_len) {
                const float* rr = rb + (t0 + gt) * p.r_ss + HALF + 4 * part;
                const float* kk = kb + (t0 + gt) * p.k_ss + HALF + 4 * part;
                if (vec) {
                    const float4 r4 = *reinterpret_cast<const float4*>(rr);
                    const float4 k4 = *reinterpret_cast<const float4*>(kk);
                    orr[0] = r4.x; orr[1] = r4.y; orr[2] = r4.z; orr[3] = r4.w;
                    okk[0] = k4.x; okk[1] = k4.y; okk[2] = k4.z; okk[3] = k4.w;
                } else {
#pragma unroll
                    for (int f = 0; f < 4; ++f) {
                        orr[f] = rr[f];
                        okk[f] = kk[f];
                    }
                }
            }
            double acc = 0.0;
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const int i = 4 * part + f;
                acc = fma(static_cast<double>(s.r[gt][i]), static_cast<double>(sm.u[i] * s.k[gt][i]), acc);
                acc = fma(static_cast<double>(orr[f]), static_cast<double>(sm.u[HALF + i] * okk[f]), acc);
            }
            acc = group8_sum(acc);
            if (part == 0) sm.bonus[gt] = static_cast<float>(acc);
        }
        __syncthreads();  // (1): v and s0 are dead from here to the chunk's end

        // (B1) A's operands: its off-diagonal block (t in sub-chunk 1, s in
        // sub-chunk 0) splits W(s, t) at step 16, ra_t . kb_s over the half's
        // channels (warps 0, 1: a channel a lane); A's upper triangle is 0,
        // its diagonal the bonus (half 0) or 0.
        float (*amat)[CP] = reinterpret_cast<float (*)[CP]>(&s.v[0][0]);
        float (*ra)[CP] = amat + L;        // r_t prod_{16 <= tau < t} w, t in sub-chunk 1
        float (*kbs)[CP] = amat + L + SUB;  // k_s prod_{s < tau < 16} w, s in sub-chunk 0
        if (warp == 0) {
            float pr = 1.f;
#pragma unroll
            for (int tl = 0; tl < SUB; ++tl) {
                ra[tl][lane] = s.r[SUB + tl][lane] * pr;
                pr *= s.w[SUB + tl][lane];
            }
        } else if (warp == 1) {
            float pr = 1.f;
#pragma unroll
            for (int tl = SUB - 1; tl >= 0; --tl) {
                kbs[tl][lane] = s.k[tl][lane] * pr;
                pr *= s.w[tl][lane];
            }
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) {
            const int sc = 4 * part + f;
            if (sc >= gt) amat[gt][sc] = sc == gt && half == 0 ? sm.bonus[gt] : 0.f;
        }

        // The pair work: lane s (and t), this warp's four channels one at a
        // time (two at once spill at the 128 registers two CTAs an SM allow).
        float outr[4], outk[4], outw[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const int i = cw + m;
            const float ks = s.k[lane][i];
            float wr = 1.f, dki = 0.f, pairs = 0.f, drp = 0.f;
#pragma unroll
            for (int tau = 1; tau < L; ++tau) {
                const bool live = lane < tau;
                const float dts = sm.d[tau][lane];
                const float rt = s.r[tau][i], wt = s.w[tau][i];
                const float wl = live ? wr : 0.f;  // W(s, tau), 0 off the pairs
                dki = fmaf(rt, dts * wl, dki);
                // sum_{s <= lane} Y[tau, s] for lane < tau (Y is 0 from lane tau
                // on, so ceil(log2 tau) steps of the prefix suffice), held one lane
                // early: R[tau][t] sits in lane t - 1 until the shift below.
                float row = dts * (ks * wl);
#pragma unroll
                for (int off = 1; off < tau; off <<= 1) {
                    const float y = __shfl_up_sync(0xffffffffu, row, off);
                    if (lane >= off) row += y;
                }
                if (lane == tau - 1) drp = row;
                if (lane < tau - 1) pairs = fmaf(rt, row, pairs);
                if (live) wr *= wt;
            }
            // Each lane t - 1's sums to lane t; lane 0's are 0.
            const float d_up = __shfl_up_sync(0xffffffffu, drp, 1);
            const float p_up = __shfl_up_sync(0xffffffffu, pairs, 1);
            drp = lane == 0 ? 0.f : d_up;
            pairs = lane == 0 ? 0.f : p_up;
            // The outputs of step t = lane, channel i.
            const float dd = sm.ddiag[lane];
            const float rl = s.r[lane][i];
            const float bonus = sm.u[c0 + i] * dd;
            const float s0dy = sm.p[lane][i] * sm.x1[i][lane];
            const float dke = sm.q[lane][i] * sm.x2[i][lane];
            outr[m] = fmaf(bonus, ks, drp + s0dy);
            outk[m] = fmaf(bonus, rl, dki + dke);
            const float after = suffix(rl * s0dy, lane, false);  // sum_{tau > t}
            const float before = prefix_excl(ks * dke, lane);    // sum_{s < t}
            outw[m] = (pairs + after) + (before + sm.pl[i] * sm.gs[i]);
            const float dup = warp_sum(rl * ks * dd);
            if (lane == 0) sm.du[i] += dup;
        }
        __syncthreads();  // (2) every read of D, x1, x2 done; ra, kb written

        // (B2) Every warp stages its outputs (dr, dk, dlogw by rows); A's
        // entries below the diagonal: the off-diagonal block on the tensor
        // cores (warps 0, 1), the diagonal sub-blocks on the CUDA cores
        // (wkv_diag_pairs); dv's G term, (k Q) G.
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            sm.x1[lane][cw + m] = outr[m];
            sm.x2[lane][cw + m] = outk[m];
            sm.d[lane][cw + m] = outw[m];
        }
        if (warp < 2) {
            const int n0 = 8 * warp;
            Tile acc;
            acc.zero();
#pragma unroll
            for (int k0 = 0; k0 < HALF; k0 += 8) {
                uint32_t ab[4], as[4];
                load_a<CP>(ra, 0, k0, g, q, 1.f, 1.f, ab, as);
                mma3_b(acc, ab, as, kbs[n0 + g][k0 + q], kbs[n0 + g][k0 + q + 4]);
            }
            store_tile<CP>(amat, SUB, n0, g, q, acc);
        }
        wkv_diag_pairs(s.r, s.k, s.w, amat, warp, lane);
        Tile dvt[2];
        dvt[0].zero();
        dvt[1].zero();
#pragma unroll
        for (int k0 = 0; k0 < HALF; k0 += 8) {
            uint32_t ab[4], as[4];
            load_a_prod<CP>(s.k, sm.q, m0, k0, g, q, ab, as);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const int col = (nt0 + n) * 8 + g;
                mma3_b(dvt[n], ab, as, sm.g[k0 + q][col], sm.g[k0 + q + 4][col]);
            }
        }
        __syncthreads();  // (3) A complete; the outputs staged; every read of G done

        // (C) dr, dk and dlogw stored by rows; dv's share += A^T dy; G <-
        // diag(P_L) G + (r P)^T dy, each thread updating its own entries (read
        // again after the next chunk's (0)).
        if (t0 + gt < p.seq_len) {
            const long long off = o_base + (t0 + gt) * o_ss + c0 + 4 * part;
            *reinterpret_cast<float4*>(p.dr + off) = *reinterpret_cast<const float4*>(&sm.x1[gt][4 * part]);
            *reinterpret_cast<float4*>(p.dk + off) = *reinterpret_cast<const float4*>(&sm.x2[gt][4 * part]);
            *reinterpret_cast<float4*>(p.dlw + off) = *reinterpret_cast<const float4*>(&sm.d[gt][4 * part]);
        }
        {
            Tile dg[2];
            dg[0].zero();
            dg[1].zero();
#pragma unroll
            for (int k0 = 0; k0 < L; k0 += 8) {
                uint32_t ab[4], as[4], gb[4], gsm[4];
                load_at<CP>(amat, m0, k0, g, q, 1.f, 1.f, 1.f, 1.f, ab, as);
                load_at_prod<CP>(s.r, sm.p, m0, k0, g, q, gb, gsm);
#pragma unroll
                for (int n = 0; n < 2; ++n) {
                    const int col = (nt0 + n) * 8 + g;
                    const float b0 = s.dy[k0 + q][col], b1 = s.dy[k0 + q + 4][col];
                    mma3_b(dvt[n], ab, as, b0, b1);
                    mma3_b(dg[n], gb, gsm, b0, b1);
                }
            }
#pragma unroll
            for (int n = 0; n < 2; ++n)
                store_pair_rows(dvb, o_ss, t0 + m0 + g, p.seq_len, (nt0 + n) * 8 + 2 * q,
                                dvt[n].value(0), dvt[n].value(1), dvt[n].value(2), dvt[n].value(3));
            const float pt = sm.pl[m0 + g], pb = sm.pl[m0 + g + 8];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const int col = (nt0 + n) * 8 + 2 * q;
                float2& top = *reinterpret_cast<float2*>(&sm.g[m0 + g][col]);
                float2& bot = *reinterpret_cast<float2*>(&sm.g[m0 + g + 8][col]);
                top = make_float2(fmaf(top.x, pt, dg[n].value(0)), fmaf(top.y, pt, dg[n].value(1)));
                bot = make_float2(fmaf(bot.x, pb, dg[n].value(2)), fmaf(bot.y, pb, dg[n].value(3)));
            }
        }
    }
    __syncthreads();
    if (tid < HALF) p.du_part[(b * p.heads + h) * HD + c0 + tid] = sm.du[tid];
}

// ============================================================================
// SSD
// ============================================================================

struct SsdStage {
    float c[L][RP];
    float b[L][RP];
    float x[L][RP];
    float dy[L][RP];
    float h0[HD][CP];  // the chunk-start state's columns n of the half, rows d
    float dec[L];
};

struct SsdBwdSmem {
    uint64_t bar[STAGES];
    alignas(16) SsdStage st[STAGES];
    alignas(16) float g[HD][CP];  // G's columns of the half, rows d
    float e[L][CP];   // E[t][s] (in float64, rounded once), then Ls E
    float cb[L][CP];  // (C B^T)[t][s] (the same), then Ls (C B^T)
    float mm[L][CP];  // Ls[t][s] (s <= t), then M
    float pre[L];     // prod_{tau <= t} a
    float suf[L];     // prod_{s < tau < L} a
    float cpart[4][L];  // c_t . dc0_t over each 8 of the half's columns
    float bpart[4][L];  // b_s . dbe_s
    float ghw[WARPS];   // sum(G * h0) over each warp's entries
    float pl;
};

__global__ void __launch_bounds__(THREADS, 2) ssd_scan_bwd_kernel(const SsdBwdParams p)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    SsdBwdSmem& sm = *reinterpret_cast<SsdBwdSmem*>(smem_raw);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int half = blockIdx.x & 1, h = blockIdx.x >> 1;
    const long long b = blockIdx.y;
    const int n0h = half * HALF;  // the half's first state column
    const float* decb = p.decay + b * p.dec_sb + h * p.dec_sh;
    const float* xb = p.dtx + b * p.x_sb + h * p.x_sh;
    const float* bb = p.bm + b * p.b_sb;
    const float* cb = p.cm + b * p.c_sb;
    const long long o_ss = static_cast<long long>(p.heads) * HD;
    const long long o_base = b * p.seq_len * o_ss + h * HD;
    const float* dyb = p.dy + o_base;
    const long long bsh = static_cast<long long>(p.batch) * p.seq_len * p.heads;
    float* dxb = p.dx_part + half * bsh * HD + o_base;
    float* dlogb = p.dlog_part + half * bsh + b * p.seq_len * p.heads + h;
    const int n_chunks = (p.seq_len + L - 1) / L;
    float* states = p.states + ((b * p.heads + h) * 2 + half) * static_cast<long long>(n_chunks) * HD * HALF;
    const bool vec = p.vec != 0;
    const LoadPlan plan{n_chunks};

    // Load ld: b and x (and, in the second pass, c, dy and the start state)
    // one row a thread by bulk copies, the decays by 4-byte cp.async.
    auto expect = [&](int ld) {
        if (tid != 0) return;
        const int rows = min(L, p.seq_len - plan.chunk(ld) * L);
        uint32_t bytes = 0;
        if (plan.second(ld))
            bytes = rows * (vec ? 4 * HD * 4 : HD * 4) + HD * HALF * 4;
        else if (vec)
            bytes = rows * 2 * HD * 4;
        mbar_expect_tx(&sm.bar[ld % STAGES], bytes);
    };
    auto issue = [&](int ld) {
        const int c = plan.chunk(ld), t0 = c * L, buf = ld % STAGES;
        SsdStage& s = sm.st[buf];
        uint64_t* bar = &sm.bar[buf];
        const bool second = plan.second(ld);
        const bool ok = t0 + lane < p.seq_len;
        const long long t = ok ? t0 + lane : 0;
        fence_proxy_async();
        if (vec) {
            if (warp == 0) stage_row_bulk<HD>(s.b[lane], bb + t * p.b_ss, ok, bar);
            if (warp == 1) stage_row_bulk<HD>(s.x[lane], xb + t * p.x_ss, ok, bar);
            if (warp == 2 && second) stage_row_bulk<HD>(s.c[lane], cb + t * p.c_ss, ok, bar);
        } else {
            stage_rows_4<L, HD, RP, THREADS>(&s.b[0][0], bb, p.b_ss, t0, p.seq_len);
            stage_rows_4<L, HD, RP, THREADS>(&s.x[0][0], xb, p.x_ss, t0, p.seq_len);
            if (second) stage_rows_4<L, HD, RP, THREADS>(&s.c[0][0], cb, p.c_ss, t0, p.seq_len);
        }
        if (second) {
            if (warp == 3) stage_row_bulk<HD>(s.dy[lane], dyb + t * o_ss, ok, bar);
            if (warp == 4 || warp == 5) {
                const int row = (warp - 4) * 32 + lane;
                bulk_copy(s.h0[row], states + (static_cast<long long>(c) * HD + row) * HALF, HALF * 4, bar);
            }
        }
        if (warp == 6) cp_async4(&s.dec[lane], ok ? decb + (t0 + lane) * p.dec_ss : decb, ok);
        cp_async_commit();
    };
    auto wait = [&](int ld) {
        mbar_wait(&sm.bar[ld % STAGES], (ld / STAGES) & 1);
        cp_async_wait<0>();
    };

    if (tid == 0) {
        for (int i = 0; i < STAGES; ++i) mbar_init(&sm.bar[i], 1);
        mbar_fence_init();
    }
    __syncthreads();

    // The state's tiles a warp: rows d = m0s + g and + 8, the half's columns
    // of n-tiles nt0s and nt0s + 1: h in registers in the first pass, G in
    // shared memory alone in the second.
    const int m0s = 16 * (warp & 3), nt0s = 2 * (warp >> 2);
    float st[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = 0.f;

    // Pass 1: the chunk-start states, h <- P_L h + (suf x)^T B.
    if (n_chunks > 1) {
        expect(0);
        __syncthreads();
        issue(0);
    }
    for (int c = 0; c < n_chunks; ++c) {
        store_state(reinterpret_cast<float (*)[HALF]>(states + static_cast<long long>(c) * HD * HALF),
                    st, m0s, nt0s, g, q);
        if (c == n_chunks - 1) break;
        const int ld = c;
        wait(ld);
        const bool next = ld + 1 < n_chunks - 1;
        if (next) expect(ld + 1);
        __syncthreads();
        if (next) issue(ld + 1);
        const SsdStage& s = sm.st[ld % STAGES];
        if (warp == 0) {
            float sf = 1.f, all = 1.f;
#pragma unroll
            for (int tau = 0; tau < L; ++tau) {
                if (tau > lane) sf *= s.dec[tau];
                all *= s.dec[tau];
            }
            sm.suf[lane] = sf;
            if (lane == 0) sm.pl = all;
        }
        __syncthreads();
        Tile ds[2];
        ds[0].zero();
        ds[1].zero();
#pragma unroll
        for (int k0 = 0; k0 < L; k0 += 8) {
            uint32_t ab[4], as[4];
            load_at<RP>(s.x, m0s, k0, g, q, 1.f, 1.f, sm.suf[k0 + q], sm.suf[k0 + q + 4], ab, as);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const int col = n0h + (nt0s + n) * 8 + g;
                mma3_b(ds[n], ab, as, s.b[k0 + q][col], s.b[k0 + q + 4][col]);
            }
        }
        const float pl = sm.pl;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[n][e] = fmaf(st[n][e], pl, ds[n].value(e));
    }

    for (int e = tid; e < HD * CP; e += THREADS) (&sm.g[0][0])[e] = 0.f;  // G, in shared memory alone
    fence_proxy_async();
    {
        const int ld = n_chunks - 1;
        expect(ld);
        __syncthreads();
        issue(ld);
    }

    const int m0 = 16 * (warp & 1);  // rows t (s) of the chunk's 32 x 32 and 32 x 64 tiles
    const int n0 = 8 * (warp >> 1);  // E's and C B^T's columns s
    const int nc = warp >> 1;        // dc's and db's n-tile of the half's columns
    const int nt0 = 2 * (warp >> 1);  // dx's d-tiles
    const bool dx_pairs = (warp >> 1) / 2 == half;  // this warp adds Ls (C B^T)^T dy to dx
    const int gt = tid >> 3, part = tid & 7;

    for (int idx = 0; idx < n_chunks; ++idx) {
        const int ld = n_chunks - 1 + idx, c = n_chunks - 1 - idx, t0 = c * L;
        const SsdStage& s = sm.st[ld % STAGES];
        wait(ld);
        const bool next = ld + 1 < plan.count();
        if (next) expect(ld + 1);
        __syncthreads();  // (0) load ld staged, G written; every read of load ld - 1 done
        if (next) issue(ld + 1);

        // (A) E and C B^T (float64), dy h0, x G and b G^T (3xTF32) on the
        // tensor cores; the decay factors (warps 0, 1); sum(G * h0).
        Tile tdc, tdb, tdx[2];
        {  // E and C B^T in float64 on the tensor cores: 8 x 8 tiles warp and warp + 8
            double de[2][2] = {{0.0, 0.0}, {0.0, 0.0}}, dcb[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll 4
            for (int k0 = 0; k0 < HD; k0 += 4) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int tile = warp + 8 * j, r0 = 8 * (tile >> 2), c0_ = 8 * (tile & 3);
                    dmma_m8n8k4(de[j], s.dy[r0 + g][k0 + q], s.x[c0_ + g][k0 + q]);
                    dmma_m8n8k4(dcb[j], s.c[r0 + g][k0 + q], s.b[c0_ + g][k0 + q]);
                }
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int tile = warp + 8 * j, r0 = 8 * (tile >> 2), c0_ = 8 * (tile & 3);
                sm.e[r0 + g][c0_ + 2 * q] = static_cast<float>(de[j][0]);
                sm.e[r0 + g][c0_ + 2 * q + 1] = static_cast<float>(de[j][1]);
                sm.cb[r0 + g][c0_ + 2 * q] = static_cast<float>(dcb[j][0]);
                sm.cb[r0 + g][c0_ + 2 * q + 1] = static_cast<float>(dcb[j][1]);
            }
        }
        {
            tdc.zero();
            tdb.zero();
#pragma unroll
            for (int k0 = 0; k0 < HD; k0 += 8) {
                uint32_t ab[4], as[4];
                load_a<RP>(s.dy, m0, k0, g, q, 1.f, 1.f, ab, as);
                mma3_b(tdc, ab, as, s.h0[k0 + q][8 * nc + g], s.h0[k0 + q + 4][8 * nc + g]);
                load_a<RP>(s.x, m0, k0, g, q, 1.f, 1.f, ab, as);
                mma3_b(tdb, ab, as, sm.g[k0 + q][8 * nc + g], sm.g[k0 + q + 4][8 * nc + g]);
            }
            tdx[0].zero();
            tdx[1].zero();
#pragma unroll
            for (int k0 = 0; k0 < HALF; k0 += 8) {
                uint32_t ab[4], as[4];
                load_a<RP>(s.b, m0, n0h + k0, g, q, 1.f, 1.f, ab, as);
#pragma unroll
                for (int n = 0; n < 2; ++n) {
                    const int col = (nt0 + n) * 8 + g;
                    mma3_b(tdx[n], ab, as, sm.g[col][k0 + q], sm.g[col][k0 + q + 4]);
                }
            }
        }
        if (warp == 0) {
            float pr = 1.f, sf = 1.f, all = 1.f;
#pragma unroll
            for (int tau = 0; tau < L; ++tau) {
                const float a = s.dec[tau];
                if (tau <= lane) pr *= a;
                if (tau > lane) sf *= a;
                all *= a;
            }
            sm.pre[lane] = pr;
            sm.suf[lane] = sf;
            if (lane == 0) sm.pl = all;
        } else if (warp == 1) {  // Ls's column s = lane, a running product along t
            float pr = 1.f;
#pragma unroll
            for (int t = 0; t < L; ++t) {
                if (t > lane) pr *= s.dec[t];
                sm.mm[t][lane] = t >= lane ? pr : 0.f;
            }
        }
        {
            const int d = tid >> 2, nb = 8 * (tid & 3);
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc = fmaf(sm.g[d][nb + j], s.h0[d][nb + j], acc);
            acc = warp_sum(acc);
            if (lane == 0) sm.ghw[warp] = acc;
        }
        __syncthreads();  // (1)

        // (B1) The state terms scaled by the decays, their shares of dlog's
        // dot products; Ls E, Ls (C B^T) and M.
        float dc0[4], dbe[4], dxe[2][4];
        {
            const float pt = sm.pre[m0 + g], pb = sm.pre[m0 + g + 8];
            const float st_ = sm.suf[m0 + g], sb = sm.suf[m0 + g + 8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                dc0[e] = tdc.value(e) * (e < 2 ? pt : pb);
                dbe[e] = tdb.value(e) * (e < 2 ? st_ : sb);
                dxe[0][e] = tdx[0].value(e) * (e < 2 ? st_ : sb);
                dxe[1][e] = tdx[1].value(e) * (e < 2 ? st_ : sb);
            }
            const int col = n0h + 8 * nc + 2 * q;
            float ct = fmaf(s.c[m0 + g][col], dc0[0], s.c[m0 + g][col + 1] * dc0[1]);
            float cbot = fmaf(s.c[m0 + g + 8][col], dc0[2], s.c[m0 + g + 8][col + 1] * dc0[3]);
            float bt = fmaf(s.b[m0 + g][col], dbe[0], s.b[m0 + g][col + 1] * dbe[1]);
            float bbot = fmaf(s.b[m0 + g + 8][col], dbe[2], s.b[m0 + g + 8][col + 1] * dbe[3]);
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                ct += __shfl_xor_sync(0xffffffffu, ct, off);
                cbot += __shfl_xor_sync(0xffffffffu, cbot, off);
                bt += __shfl_xor_sync(0xffffffffu, bt, off);
                bbot += __shfl_xor_sync(0xffffffffu, bbot, off);
            }
            if (q == 0) {
                sm.cpart[nc][m0 + g] = ct;
                sm.cpart[nc][m0 + g + 8] = cbot;
                sm.bpart[nc][m0 + g] = bt;
                sm.bpart[nc][m0 + g + 8] = bbot;
            }
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const int sc = 4 * part + f;
                const float l = sm.mm[gt][sc];
                const float ev = sm.e[gt][sc], cbv = sm.cb[gt][sc];
                const float le = l * ev;
                sm.e[gt][sc] = le;
                sm.cb[gt][sc] = l * cbv;
                sm.mm[gt][sc] = le * cbv;
            }
        }
        __syncthreads();  // (2)

        // (B2) dc += Ls E b, db += (Ls E)^T c, dx += (Ls C B^T)^T dy (the
        // half's d), the stores; G's update; dlog (warp 7).
        {
            Tile tc, tb, tx[2];
            tc.zero();
            tb.zero();
            tx[0].zero();
            tx[1].zero();
            const int ncol = n0h + 8 * nc + g;
#pragma unroll
            for (int k0 = 0; k0 < L; k0 += 8) {
                uint32_t ab[4], as[4];
                load_a<CP>(sm.e, m0, k0, g, q, 1.f, 1.f, ab, as);
                mma3_b(tc, ab, as, s.b[k0 + q][ncol], s.b[k0 + q + 4][ncol]);
                load_at<CP>(sm.e, m0, k0, g, q, 1.f, 1.f, 1.f, 1.f, ab, as);
                mma3_b(tb, ab, as, s.c[k0 + q][ncol], s.c[k0 + q + 4][ncol]);
                if (dx_pairs) {
                    load_at<CP>(sm.cb, m0, k0, g, q, 1.f, 1.f, 1.f, 1.f, ab, as);
#pragma unroll
                    for (int n = 0; n < 2; ++n) {
                        const int col = (nt0 + n) * 8 + g;
                        mma3_b(tx[n], ab, as, s.dy[k0 + q][col], s.dy[k0 + q + 4][col]);
                    }
                }
            }
            const int t = t0 + m0 + g, col = n0h + 8 * nc + 2 * q;
            store_pair_rows(p.dc + o_base, o_ss, t, p.seq_len, col, dc0[0] + tc.value(0),
                            dc0[1] + tc.value(1), dc0[2] + tc.value(2), dc0[3] + tc.value(3));
            store_pair_rows(p.db + o_base, o_ss, t, p.seq_len, col, tb.value(0) + dbe[0],
                            tb.value(1) + dbe[1], tb.value(2) + dbe[2], tb.value(3) + dbe[3]);
#pragma unroll
            for (int n = 0; n < 2; ++n)
                store_pair_rows(dxb, o_ss, t, p.seq_len, (nt0 + n) * 8 + 2 * q,
                                dxe[n][0] + tx[n].value(0), dxe[n][1] + tx[n].value(1),
                                dxe[n][2] + tx[n].value(2), dxe[n][3] + tx[n].value(3));
        }
        {
            Tile dg[2];
            dg[0].zero();
            dg[1].zero();
#pragma unroll
            for (int k0 = 0; k0 < L; k0 += 8) {
                uint32_t ab[4], as[4];
                load_at<RP>(s.dy, m0s, k0, g, q, 1.f, 1.f, sm.pre[k0 + q], sm.pre[k0 + q + 4], ab, as);
#pragma unroll
                for (int n = 0; n < 2; ++n) {
                    const int col = n0h + (nt0s + n) * 8 + g;
                    mma3_b(dg[n], ab, as, s.c[k0 + q][col], s.c[k0 + q + 4][col]);
                }
            }
            const float pl = sm.pl;
#pragma unroll
            for (int n = 0; n < 2; ++n) {  // each thread its own entries of G
                const int col = (nt0s + n) * 8 + 2 * q;
                float2& top = *reinterpret_cast<float2*>(&sm.g[m0s + g][col]);
                float2& bot = *reinterpret_cast<float2*>(&sm.g[m0s + g + 8][col]);
                top = make_float2(fmaf(top.x, pl, dg[n].value(0)), fmaf(top.y, pl, dg[n].value(1)));
                bot = make_float2(fmaf(bot.x, pl, dg[n].value(2)), fmaf(bot.y, pl, dg[n].value(3)));
            }
        }
        if (warp == WARPS - 1) {  // lane t: dlog_t's share
            float inner = 0.f;  // the pairs s < t <= tau (half 0)
            if (half == 0) {
#pragma unroll 4
                for (int tau = 1; tau < L; ++tau) {
                    const float m = lane < tau ? sm.mm[tau][lane] : 0.f;
                    const float row = prefix_excl(m, lane);  // sum_{s < lane} M[tau, s]
                    if (lane <= tau) inner += row;
                }
            }
            const float cdc0 = (sm.cpart[0][lane] + sm.cpart[1][lane]) + (sm.cpart[2][lane] + sm.cpart[3][lane]);
            const float bdbe = (sm.bpart[0][lane] + sm.bpart[1][lane]) + (sm.bpart[2][lane] + sm.bpart[3][lane]);
            float ghs = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) ghs += sm.ghw[w];
            const float after = suffix(cdc0, lane, true);  // sum_{tau >= t}
            const float before = prefix_excl(bdbe, lane);  // sum_{s < t}
            if (t0 + lane < p.seq_len)
                dlogb[static_cast<long long>(t0 + lane) * p.heads] = (after + inner) + (before + sm.pl * ghs);
        }
    }
}

bool bad_shape(int batch, int seq_len, int heads)
{
    return batch < 1 || batch > 65535 || seq_len < 1 || heads < 1 || heads > 0x3fffffff / HD;
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem)
{
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the cudaError_t of the launch (0 = queued).
// strides: element strides (batch, sequence, head) of r, k, v and w (12).
// dy must be contiguous and 16-byte aligned.  states: B * H * ceil(S / 32)
// * 64 * 64 floats of scratch.  dv_part: 2 * B * S * H * 64 floats.
int wkv6_scan_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* dy, void* dr, void* dk, void* dv_part,
                         void* dlw, void* du_part, void* states, const long long* strides,
                         int batch, int seq_len, int heads, void* stream)
{
    if (bad_shape(batch, seq_len, heads) || !aligned16(dy))
        return static_cast<int>(cudaErrorInvalidValue);
    WkvBwdParams p;
    p.r = static_cast<const float*>(r);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u);
    p.dy = static_cast<const float*>(dy);
    p.dr = static_cast<float*>(dr);
    p.dk = static_cast<float*>(dk);
    p.dv_part = static_cast<float*>(dv_part);
    p.dlw = static_cast<float*>(dlw);
    p.du_part = static_cast<float*>(du_part);
    p.states = static_cast<float*>(states);
    p.r_sb = strides[0]; p.r_ss = strides[1]; p.r_sh = strides[2];
    p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
    p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
    p.w_sb = strides[9]; p.w_ss = strides[10]; p.w_sh = strides[11];
    p.seq_len = seq_len;
    p.heads = heads;
    p.batch = batch;
    const void* ptrs[4] = {r, k, v, w};
    p.vec = vec_ok(ptrs, 4, strides, 12);
    const int smem = static_cast<int>(sizeof(WkvBwdSmem));
    const cudaError_t err = allow_smem(wkv6_scan_bwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv6_scan_bwd_kernel<<<dim3(2 * heads, batch), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// strides: decay (batch, sequence, head), dtx (batch, sequence, head), b
// (batch, sequence), c (batch, sequence): 10 element strides.  state must be
// 64.  dlog_part: 2 * B * S * H floats; dx_part: 2 * B * S * H * 64.
int ssd_scan_bwd_launch(const void* decay, const void* dtx, const void* b, const void* c,
                        const void* dy, void* dlog_part, void* dx_part, void* db_h, void* dc_h,
                        void* states, const long long* strides, int batch, int seq_len, int heads,
                        int state, void* stream)
{
    if (bad_shape(batch, seq_len, heads) || state != HD || !aligned16(dy))
        return static_cast<int>(cudaErrorInvalidValue);
    SsdBwdParams p;
    p.decay = static_cast<const float*>(decay);
    p.dtx = static_cast<const float*>(dtx);
    p.bm = static_cast<const float*>(b);
    p.cm = static_cast<const float*>(c);
    p.dy = static_cast<const float*>(dy);
    p.dlog_part = static_cast<float*>(dlog_part);
    p.dx_part = static_cast<float*>(dx_part);
    p.db = static_cast<float*>(db_h);
    p.dc = static_cast<float*>(dc_h);
    p.states = static_cast<float*>(states);
    p.dec_sb = strides[0]; p.dec_ss = strides[1]; p.dec_sh = strides[2];
    p.x_sb = strides[3]; p.x_ss = strides[4]; p.x_sh = strides[5];
    p.b_sb = strides[6]; p.b_ss = strides[7];
    p.c_sb = strides[8]; p.c_ss = strides[9];
    p.seq_len = seq_len;
    p.heads = heads;
    p.batch = batch;
    const void* ptrs[3] = {dtx, b, c};
    p.vec = vec_ok(ptrs, 3, strides + 3, 7);  // the decay is copied 4 bytes at a time
    const int smem = static_cast<int>(sizeof(SsdBwdSmem));
    const cudaError_t err = allow_smem(ssd_scan_bwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_scan_bwd_kernel<<<dim3(2 * heads, batch), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// The launch geometry of each backward kernel, for the wrapper to report:
// into out, its CTAs resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at its block size and shared memory), threads a CTA and shared memory a
// CTA in bytes.  kind: 0 WKV-6, 1 SSD.  Returns the cudaError_t.
int recurrence_bwd_occupancy(int kind, int* out)
{
    const int smem = static_cast<int>(kind == 0 ? sizeof(WkvBwdSmem) : sizeof(SsdBwdSmem));
    cudaError_t err = kind == 0 ? allow_smem(wkv6_scan_bwd_kernel, smem)
                                : allow_smem(ssd_scan_bwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = kind == 0
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_scan_bwd_kernel, THREADS, smem)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_scan_bwd_kernel, THREADS, smem);
    out[0] = blocks;
    out[1] = THREADS;
    out[2] = smem;
    return static_cast<int>(err);
}

const char* recurrence_bwd_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
