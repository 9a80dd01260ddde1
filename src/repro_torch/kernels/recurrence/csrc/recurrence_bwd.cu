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
// 64); writes dr, dk, dv and dlogw (the gradient of log w), (B, S, H, 64),
// and du_part (B, H, 64), each (b, h)'s share of du, summed over the batch
// by the caller.  ssd_scan_bwd: decay (B, S, H), dtx (B, S, H, 64), b and c
// (B, S, 64), dy (B, S, H, 64); writes dlogdec (B, S, H), ddtx (B, S, H,
// 64) and the per-head db_h and dc_h (B, S, H, 64), summed over the heads
// by the caller (b and c are shared by every head).  No float atomics: each
// sum is formed by one thread, or by shuffles in a fixed order, so two
// launches agree bit for bit.
//
// The algorithm (kernels/recurrence/ref.py's wkv6_scan_bwd_chunked_ref and
// ssd_scan_bwd_chunked_ref are it in plain PyTorch).  The sequence is cut
// into chunks of L = 32 steps.  A first pass steps the recurrence forward
// from the zero state and writes each chunk's start state into a scratch
// buffer (B * H * n_chunks * 64 * 64 floats, the caller's): the backward
// needs them in reverse order and a state cannot be stepped back without
// dividing by a decay.  (The forward kernel could have written them, as the
// flash kernel writes its lse; recomputing them here costs a pass of 2
// float32 operations a state entry and step, keeps the forward kernel as it
// is, and holds nothing from the forward to the backward: under remat
// "full" the forward runs twice and only the second would need them.)
// The second pass runs the chunks in reverse, carrying G, the gradient of
// the state at the chunk's end (zero after the last chunk).  For WKV-6, with
// S0 the chunk's start state and, per key channel i, P_t = prod_{tau<t} w,
// Q_s = prod_{s<tau<L} w, P_L the whole chunk's product and W(s,t) =
// prod_{s<tau<t} w (s < t), D[t,s] = dy_t . v_s and A[t,s] = sum_i r_t k_s W
// (A[t,t] = sum_i r_t u k_t, the bonus):
//
//     dv_s    = sum_{t>=s} A[t,s] dy_t + sum_i Q_s[i] k_s[i] G[i,:]
//     dr'_t   = P_t * (S0 dy_t) + sum_{s<t} D[t,s] k_s W(s,t)
//     dki_s   = sum_{t>s} D[t,s] r_t W(s,t),   dke_s = Q_s * (G v_s)
//     dr_t    = dr'_t + u k_t D[t,t],          dk_s = dki_s + dke_s + u r_s D[s,s]
//     du     += sum_t r_t k_t D[t,t]
//     dlogw_t = sum_{s<t<tau} D[tau,s] r_tau k_s W(s,tau)
//               + sum_{tau>t} r_tau P_tau (S0 dy_tau)
//               + sum_{s<t} k_s dke_s + P_L * rowsum(G * S0)
//     G      <- diag(P_L) G + sum_t (r_t P_t) dy_t^T
//
// dlogw counts each product of the expansion that holds w_t once, as the
// derivative in log w_t does: the pairs of steps s < t < tau inside the
// chunk, those through the start state (tau > t) and those through the end
// state (s < t, and the start state's).  Each is summed directly, never as
// the difference of two larger sums, so a gradient that is 0 (at t = 0,
// where the state is zero) comes out 0, and nothing divides by a decay: a
// decay of exactly 0 gives finite gradients (a zero where every such
// product holds it).  The pairs' sum splits W(s,tau) at t into W(s,t) w_t
// W(t,tau), running products away from t.  The SSD is the same with the
// state h (64 x N: head-dim row d, state n), x = dtx, B, C and one decay a
// step, y_t reading the state after step t: pre_t = prod_{tau<=t},
// suf_s = prod_{s<tau<L}, Ls[t,s] = prod_{s<tau<=t} (s <= t), E[t,s] =
// dy_t . x_s,
//
//     dc_t    = pre_t (h0^T dy_t) + sum_{s<=t} Ls E[t,s] b_s
//     db_s    = sum_{t>=s} Ls E[t,s] c_t + suf_s (G^T x_s)
//     dx_s    = sum_{t>=s} Ls (c_t . b_s) dy_t + suf_s (G b_s)
//     dlog_t  = sum_{tau>=t} pre_tau dy_tau . (h0 c_tau) + sum_{s<t<=tau} M[tau,s]
//               + sum_{s<t} suf_s x_s . (G b_s) + P_L * sum(G * h0)
//     G      <- P_L G + sum_t pre_t dy_t c_t^T
//
// with M[tau,s] = Ls[tau,s] E[tau,s] (c_tau . b_s), the pairs summed
// directly as in WKV-6.
// W(s,t) and Ls are running products along t, never quotients.
//
// The layout.  One CTA of 256 threads per (b, h) runs the whole sequence,
// everything on the CUDA cores in float32 from shared memory: a chunk's
// inputs (32 rows of 64), S0 and G (64 x 64), the 32 x 32 pair matrices.
// Each chunk is five phases between barriers.  This is the simple kernel:
// its products are plain FMA loops (about 1 M FMA a chunk for WKV-6), the
// grid is one wave of B * H CTAs, one an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;     // head dim (WKV-6), head dim and state size (SSD)
constexpr int L = 32;      // time steps a chunk
constexpr int THREADS = 256;
constexpr int SP = HD + 1;  // row stride of the 64 x 64 state arrays
constexpr int LP = L + 1;   // row stride of the 32 x 32 pair arrays

struct WkvBwdParams {
    const float* r;
    const float* k;
    const float* v;
    const float* w;
    const float* u;   // (H, 64) contiguous
    const float* dy;  // (B, S, H, 64) contiguous
    float* dr;        // (B, S, H, 64) contiguous, and dk, dv, dlw
    float* dk;
    float* dv;
    float* dlw;
    float* du_part;   // (B, H, 64)
    float* states;    // (B * H, n_chunks, 64, 64) scratch
    long long r_sb, r_ss, r_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long w_sb, w_ss, w_sh;
    int seq_len;
    int heads;
};

struct SsdBwdParams {
    const float* decay;  // (B, S, H)
    const float* dtx;    // (B, S, H, 64)
    const float* bm;     // (B, S, 64)
    const float* cm;     // (B, S, 64)
    const float* dy;     // (B, S, H, 64) contiguous
    float* dlog;         // (B, S, H) contiguous
    float* dx;           // (B, S, H, 64) contiguous, and db_h, dc_h
    float* db;
    float* dc;
    float* states;       // (B * H, n_chunks, 64, 64) scratch
    long long dec_sb, dec_ss, dec_sh;
    long long x_sb, x_ss, x_sh;
    long long b_sb, b_ss;
    long long c_sb, c_ss;
    int seq_len;
    int heads;
};

// Rows t0 .. t0 + L - 1 of one (b, h)'s slice src (row stride ss, 64
// contiguous floats a row) into dst (L x 64), zeros past seq_len.
__device__ __forceinline__ void load_rows(float (*dst)[HD], const float* src, long long ss, int t0,
                                          int seq_len)
{
    for (int e = threadIdx.x; e < L * HD; e += THREADS) {
        const int row = e / HD, col = e % HD;
        dst[row][col] = t0 + row < seq_len ? src[(t0 + row) * ss + col] : 0.f;
    }
}

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

// The dot product of two rows of 64, accumulated in double and rounded once:
// the pair products D, A, E and C B^T, 64 terms of either sign each, are the
// whole gradient at the shortest lengths (S = 1: dv = A[0,0] dy_0), where a
// float32 sum would carry the rounding of its largest terms into a small
// result.
__device__ __forceinline__ float dot64(const float* a, const float* b)
{
    double acc = 0.0;
#pragma unroll 16
    for (int j = 0; j < HD; ++j) acc = fma(static_cast<double>(a[j]), static_cast<double>(b[j]), acc);
    return static_cast<float>(acc);
}

// One 64 x 64 state: the thread's 16 entries (row tid / 4, columns
// 16 (tid % 4) ..) to and from the scratch buffer.
__device__ __forceinline__ void store_entries(float* dst, const float (&st)[16])
{
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int f = 0; f < 4; ++f) d[f] = make_float4(st[4 * f], st[4 * f + 1], st[4 * f + 2], st[4 * f + 3]);
}

struct WkvBwdSmem {
    float r[L][HD], k[L][HD], v[L][HD], w[L][HD], dy[L][HD];
    float p[L][HD];  // prod_{tau < t} w_tau
    float q[L][HD];  // prod_{s < tau < L} w_tau
    float pl[HD];    // the chunk's whole product
    float gs[HD];    // rowsum(G * S0)
    float u[HD];
    float s0[HD][SP];  // the chunk's start state
    float g[HD][SP];   // the gradient of its end state
    float dmat[L][LP];  // D[t][s] = dy_t . v_s
    float amat[L][LP];  // A[t][s] (s <= t), 0 above
    float drs[L][HD];   // dr' (without the bonus)
    float dki[L][HD];
    float dke[L][HD];
    float rs0[L][HD];   // r_t * P_t * (S0 dy_t): the start state's part of r_t dr'_t
    float pairs[L][HD];  // w_t * sum_{s<t<tau} D[tau,s] k_s r_tau W(s,tau) / w_t
};

__global__ void __launch_bounds__(THREADS, 1) wkv6_scan_bwd_kernel(const WkvBwdParams p)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    WkvBwdSmem& sm = *reinterpret_cast<WkvBwdSmem*>(smem_raw);
    const int tid = threadIdx.x;
    const int h = blockIdx.x;
    const long long b = blockIdx.y;
    const float* rb = p.r + b * p.r_sb + h * p.r_sh;
    const float* kb = p.k + b * p.k_sb + h * p.k_sh;
    const float* vb = p.v + b * p.v_sb + h * p.v_sh;
    const float* wb = p.w + b * p.w_sb + h * p.w_sh;
    const long long o_ss = static_cast<long long>(p.heads) * HD;  // outputs' row stride
    const long long o_base = b * p.seq_len * o_ss + h * HD;
    const float* dyb = p.dy + o_base;
    const int n_chunks = (p.seq_len + L - 1) / L;
    float* states = p.states + (b * p.heads + h) * static_cast<long long>(n_chunks) * HD * HD;
    const int ei = tid >> 2, ej = (tid & 3) * 16;  // this thread's 16 state entries

    // Pass 1: the chunk-start states, stepping forward from zero.
    {
        float st[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) st[e] = 0.f;
        for (int c = 0; c < n_chunks; ++c) {
            store_entries(states + (static_cast<long long>(c) * HD + ei) * HD + ej, st);
            if (c == n_chunks - 1) break;
            load_rows(sm.k, kb, p.k_ss, c * L, p.seq_len);
            load_rows(sm.v, vb, p.v_ss, c * L, p.seq_len);
            load_rows(sm.w, wb, p.w_ss, c * L, p.seq_len);
            __syncthreads();
            for (int t = 0; t < L; ++t) {
                const float wt = sm.w[t][ei], kt = sm.k[t][ei];
#pragma unroll
                for (int e = 0; e < 16; ++e) st[e] = fmaf(wt, st[e], kt * sm.v[t][ej + e]);
            }
            __syncthreads();
        }
    }

    for (int e = tid; e < HD * SP; e += THREADS) (&sm.g[0][0])[e] = 0.f;
    if (tid < HD) sm.u[tid] = p.u[h * HD + tid];
    float du = 0.f;  // threads 0-63: channel tid's share of du
    __syncthreads();  // every state stored (the scratch is read back by other threads)

    // Pass 2: the chunks in reverse.
    for (int c = n_chunks - 1; c >= 0; --c) {
        const int t0 = c * L;
        // (1) The chunk's rows and its start state.
        load_rows(sm.r, rb, p.r_ss, t0, p.seq_len);
        load_rows(sm.k, kb, p.k_ss, t0, p.seq_len);
        load_rows(sm.v, vb, p.v_ss, t0, p.seq_len);
        load_rows(sm.w, wb, p.w_ss, t0, p.seq_len);
        load_rows(sm.dy, dyb, o_ss, t0, p.seq_len);
        {
            const float* src = states + static_cast<long long>(c) * HD * HD;
            for (int e = tid; e < HD * HD; e += THREADS) sm.s0[e / HD][e % HD] = src[e];
        }
        __syncthreads();

        // (2) The decays' prefix and suffix products, rowsum(G * S0) and D.
        if (tid < HD) {
            float pr = 1.f;
            for (int t = 0; t < L; ++t) {
                sm.p[t][tid] = pr;
                pr *= sm.w[t][tid];
            }
            sm.pl[tid] = pr;
        } else if (tid < 2 * HD) {
            const int i = tid - HD;
            float pr = 1.f;
            for (int t = L - 1; t >= 0; --t) {
                sm.q[t][i] = pr;
                pr *= sm.w[t][i];
            }
        } else if (tid < 3 * HD) {
            const int i = tid - 2 * HD;
            float acc = 0.f;
            for (int j = 0; j < HD; ++j) acc = fmaf(sm.g[i][j], sm.s0[i][j], acc);
            sm.gs[i] = acc;
        }
        {
            const int t = tid >> 3;
            for (int m = 0; m < 4; ++m) {
                const int s = (tid & 7) + 8 * m;
                sm.dmat[t][s] = dot64(sm.dy[t], sm.v[s]);
            }
        }
        __syncthreads();

        // (3) Thread (row x = tid / 8, channels 8 (tid % 8) ..): A's column s = x
        // and dki_s, both from k_s (r_t) carried along t times W(s, t); dr'_t = x
        // with W(s, t) carried back along s; dke_s = x.
        {
            const int x = tid >> 3, c0 = (tid & 7) * 8;
            float e[8], dk_acc[8];
#pragma unroll
            for (int f = 0; f < 8; ++f) {
                e[f] = 1.f;  // W(x, t)
                dk_acc[f] = 0.f;
            }
            for (int t = 0; t < L; ++t) {
                double part = 0.0;  // A's entries in double, as dot64 (the note there)
                if (t == x) {
#pragma unroll
                    for (int f = 0; f < 8; ++f)
                        part = fma(static_cast<double>(sm.r[t][c0 + f]),
                                   static_cast<double>(sm.u[c0 + f] * sm.k[x][c0 + f]), part);
                } else if (t > x) {
                    const float d = sm.dmat[t][x];
#pragma unroll
                    for (int f = 0; f < 8; ++f) {
                        const float rw = sm.r[t][c0 + f] * e[f];
                        part = fma(static_cast<double>(rw), static_cast<double>(sm.k[x][c0 + f]), part);
                        dk_acc[f] = fmaf(d, rw, dk_acc[f]);
                        e[f] *= sm.w[t][c0 + f];
                    }
                }
                part = group8_sum(part);
                if ((tid & 7) == 0) sm.amat[t][x] = static_cast<float>(part);  // 0 above the diagonal
            }
            float dr_acc[8];
#pragma unroll
            for (int f = 0; f < 8; ++f) {
                dr_acc[f] = 0.f;
                e[f] = 1.f;  // W(s, x), s descending
            }
            for (int s = x - 1; s >= 0; --s) {
                const float d = sm.dmat[x][s];
#pragma unroll
                for (int f = 0; f < 8; ++f) {
                    dr_acc[f] = fmaf(d, sm.k[s][c0 + f] * e[f], dr_acc[f]);
                    e[f] *= sm.w[s][c0 + f];
                }
            }
#pragma unroll
            for (int f = 0; f < 8; ++f) {
                const int i = c0 + f;
                float s0dy = 0.f, gv = 0.f;
                for (int j = 0; j < HD; ++j) {
                    s0dy = fmaf(sm.s0[i][j], sm.dy[x][j], s0dy);
                    gv = fmaf(sm.g[i][j], sm.v[x][j], gv);
                }
                const float start = sm.p[x][i] * s0dy;
                sm.drs[x][i] = start + dr_acc[f];
                sm.rs0[x][i] = sm.r[x][i] * start;
                sm.dki[x][i] = dk_acc[f];
                sm.dke[x][i] = sm.q[x][i] * gv;
            }
        }
        __syncthreads();

        // (4) dv: thread (row s = tid / 8, columns 8 (tid % 8) ..).
        {
            const int s = tid >> 3, j0 = (tid & 7) * 8;
            float acc[8];
#pragma unroll
            for (int f = 0; f < 8; ++f) acc[f] = 0.f;
            for (int t = s; t < L; ++t) {
                const float a = sm.amat[t][s];
#pragma unroll
                for (int f = 0; f < 8; ++f) acc[f] = fmaf(a, sm.dy[t][j0 + f], acc[f]);
            }
            for (int i = 0; i < HD; ++i) {
                const float kq = sm.k[s][i] * sm.q[s][i];
#pragma unroll
                for (int f = 0; f < 8; ++f) acc[f] = fmaf(kq, sm.g[i][j0 + f], acc[f]);
            }
            if (t0 + s < p.seq_len) {
                float4* dst = reinterpret_cast<float4*>(p.dv + o_base + (t0 + s) * o_ss + j0);
                dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
                dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
            }
        }
        // The pairs s < t < tau of dlogw_t: thread (t = tid / 8, channels
        // 8 (tid % 8) ..); W(s, tau) = W(s, t) w_t W(t, tau), so the sum is
        // w_t sum_{tau>t} r_tau W(t, tau) sum_{s<t} D[tau, s] k_s W(s, t), each
        // W a running product away from t.
        {
            const int t = tid >> 3, c0 = (tid & 7) * 8;
            float acc[8], wt[8];
#pragma unroll
            for (int f = 0; f < 8; ++f) {
                acc[f] = 0.f;
                wt[f] = 1.f;  // W(t, tau)
            }
            for (int tau = t + 1; tau < L; ++tau) {
                float inner[8], a[8];
#pragma unroll
                for (int f = 0; f < 8; ++f) {
                    inner[f] = 0.f;
                    a[f] = 1.f;  // W(s, t), s descending
                }
                for (int s = t - 1; s >= 0; --s) {
                    const float d = sm.dmat[tau][s];
#pragma unroll
                    for (int f = 0; f < 8; ++f) {
                        inner[f] = fmaf(d, sm.k[s][c0 + f] * a[f], inner[f]);
                        a[f] *= sm.w[s][c0 + f];
                    }
                }
#pragma unroll
                for (int f = 0; f < 8; ++f) {
                    acc[f] = fmaf(sm.r[tau][c0 + f] * wt[f], inner[f], acc[f]);
                    wt[f] *= sm.w[tau][c0 + f];
                }
            }
#pragma unroll
            for (int f = 0; f < 8; ++f) sm.pairs[t][c0 + f] = sm.w[t][c0 + f] * acc[f];
        }
        __syncthreads();  // every read of G done

        // (5) dr, dk, dlogw, du, and G for the chunk before.
        for (int e = tid; e < L * HD; e += THREADS) {
            const int t = e / HD, i = e % HD;
            if (t0 + t >= p.seq_len) continue;
            const float bonus = sm.u[i] * sm.dmat[t][t];
            p.dr[o_base + (t0 + t) * o_ss + i] = fmaf(bonus, sm.k[t][i], sm.drs[t][i]);
            p.dk[o_base + (t0 + t) * o_ss + i] = fmaf(bonus, sm.r[t][i], sm.dki[t][i] + sm.dke[t][i]);
        }
        if (tid < HD) {
            const int i = tid;
            float pre[L];  // sum_{s < t} k_s dke_s
            float run = 0.f;
#pragma unroll
            for (int t = 0; t < L; ++t) {
                pre[t] = run;
                run = fmaf(sm.k[t][i], sm.dke[t][i], run);
                du = fmaf(sm.r[t][i] * sm.k[t][i], sm.dmat[t][t], du);
            }
            const float end = sm.pl[i] * sm.gs[i];
            float after = 0.f;  // sum_{tau > t} r_tau P_tau (S0 dy_tau)
#pragma unroll
            for (int t = L - 1; t >= 0; --t) {
                if (t0 + t < p.seq_len)
                    p.dlw[o_base + (t0 + t) * o_ss + i] = (sm.pairs[t][i] + after) + (pre[t] + end);
                after += sm.rs0[t][i];
            }
        }
        {
            float acc[16];
            const float pl = sm.pl[ei];
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[e] = pl * sm.g[ei][ej + e];
            for (int t = 0; t < L; ++t) {
                const float rp = sm.r[t][ei] * sm.p[t][ei];
#pragma unroll
                for (int e = 0; e < 16; ++e) acc[e] = fmaf(rp, sm.dy[t][ej + e], acc[e]);
            }
#pragma unroll
            for (int e = 0; e < 16; ++e) sm.g[ei][ej + e] = acc[e];
        }
        __syncthreads();  // the next chunk's loads overwrite what (5) read
    }
    if (tid < HD) p.du_part[(b * p.heads + h) * HD + tid] = du;
}

struct SsdBwdSmem {
    float x[L][HD], bm[L][HD], cm[L][HD], dy[L][HD];
    float a[L];
    float pre[L];  // prod_{tau <= t} a
    float suf[L];  // prod_{s < tau < L} a
    float h0[HD][SP];  // the chunk's start state (d, n)
    float g[HD][SP];   // the gradient of its end state
    float lm[L][LP];   // Ls[t][s] (s <= t), 0 above
    float le[L][LP];   // Ls E
    float lcb[L][LP];  // Ls (C B^T)
    float mm[L][LP];   // M = Ls E (C B^T)
    float cdc0[L];     // c_t . dc0_t (the start state's part of dc)
    float bdbe[L];     // b_s . dbe_s (the end state's part of db)
    float inner[L];    // sum_{s < t <= tau} M[tau][s]
    float gh[HD];      // rowsum(G * h0)
};

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_bwd_kernel(const SsdBwdParams p)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    SsdBwdSmem& sm = *reinterpret_cast<SsdBwdSmem*>(smem_raw);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int h = blockIdx.x;
    const long long b = blockIdx.y;
    const float* decb = p.decay + b * p.dec_sb + h * p.dec_sh;
    const float* xb = p.dtx + b * p.x_sb + h * p.x_sh;
    const float* bb = p.bm + b * p.b_sb;
    const float* cb = p.cm + b * p.c_sb;
    const long long o_ss = static_cast<long long>(p.heads) * HD;
    const long long o_base = b * p.seq_len * o_ss + h * HD;
    const float* dyb = p.dy + o_base;
    const int n_chunks = (p.seq_len + L - 1) / L;
    float* states = p.states + (b * p.heads + h) * static_cast<long long>(n_chunks) * HD * HD;
    const int ed = tid >> 2, en = (tid & 3) * 16;  // this thread's 16 state entries

    auto load_decays = [&](int t0) {
        if (tid < L) sm.a[tid] = t0 + tid < p.seq_len ? decb[(t0 + tid) * p.dec_ss] : 0.f;
    };

    // Pass 1: the chunk-start states.
    {
        float st[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) st[e] = 0.f;
        for (int c = 0; c < n_chunks; ++c) {
            store_entries(states + (static_cast<long long>(c) * HD + ed) * HD + en, st);
            if (c == n_chunks - 1) break;
            load_rows(sm.x, xb, p.x_ss, c * L, p.seq_len);
            load_rows(sm.bm, bb, p.b_ss, c * L, p.seq_len);
            load_decays(c * L);
            __syncthreads();
            for (int t = 0; t < L; ++t) {
                const float at = sm.a[t], xt = sm.x[t][ed];
#pragma unroll
                for (int e = 0; e < 16; ++e) st[e] = fmaf(at, st[e], xt * sm.bm[t][en + e]);
            }
            __syncthreads();
        }
    }

    for (int e = tid; e < HD * SP; e += THREADS) (&sm.g[0][0])[e] = 0.f;
    __syncthreads();

    for (int c = n_chunks - 1; c >= 0; --c) {
        const int t0 = c * L;
        // (1) The chunk's rows and its start state.
        load_rows(sm.x, xb, p.x_ss, t0, p.seq_len);
        load_rows(sm.bm, bb, p.b_ss, t0, p.seq_len);
        load_rows(sm.cm, cb, p.c_ss, t0, p.seq_len);
        load_rows(sm.dy, dyb, o_ss, t0, p.seq_len);
        load_decays(t0);
        {
            const float* src = states + static_cast<long long>(c) * HD * HD;
            for (int e = tid; e < HD * HD; e += THREADS) sm.h0[e / HD][e % HD] = src[e];
        }
        __syncthreads();

        // (2) The decay factors (warp 0: pre and suf, lane t; warp 1: column
        // s = lane of Ls), rowsum(G * h0) (warps 2-3), E and C B^T (all).
        if (warp == 0) {
            float pr = 1.f, sf = 1.f;
            for (int tau = 0; tau < L; ++tau) {
                if (tau <= lane) pr *= sm.a[tau];
                if (tau > lane) sf *= sm.a[tau];
            }
            sm.pre[lane] = pr;
            sm.suf[lane] = sf;
        } else if (warp == 1) {
            const int s = lane;
            float pr = 1.f;
            for (int t = 0; t < L; ++t) {
                if (t > s) pr *= sm.a[t];
                sm.lm[t][s] = t >= s ? pr : 0.f;
            }
        } else if (warp < 4) {
            const int d = tid - 64;
            float acc = 0.f;
            for (int n = 0; n < HD; ++n) acc = fmaf(sm.g[d][n], sm.h0[d][n], acc);
            sm.gh[d] = acc;
        }
        float ev[4], cbv[4];
        {
            const int t = tid >> 3;
            for (int m = 0; m < 4; ++m) {
                const int s = (tid & 7) + 8 * m;
                ev[m] = dot64(sm.dy[t], sm.x[s]);
                cbv[m] = dot64(sm.cm[t], sm.bm[s]);
            }
        }
        __syncthreads();
        {
            const int t = tid >> 3;
            for (int m = 0; m < 4; ++m) {
                const int s = (tid & 7) + 8 * m;
                const float l = sm.lm[t][s];
                sm.le[t][s] = l * ev[m];
                sm.lcb[t][s] = l * cbv[m];
                sm.mm[t][s] = (l * ev[m]) * cbv[m];
            }
        }
        __syncthreads();

        // (3) dc, db and dx: thread (row x = tid / 8, columns 8 (tid % 8) ..);
        // warp 7 also sums the pairs.
        {
            const int x = tid >> 3, c0 = (tid & 7) * 8;
            float dc0[8], dcs[8], dbi[8], dbe[8], dxa[8];  // dxa: (G b_x)
#pragma unroll
            for (int f = 0; f < 8; ++f) dc0[f] = dcs[f] = dbi[f] = dbe[f] = dxa[f] = 0.f;
            for (int d = 0; d < HD; ++d) {
                const float dyd = sm.dy[x][d], xd = sm.x[x][d];
#pragma unroll
                for (int f = 0; f < 8; ++f) {
                    dc0[f] = fmaf(dyd, sm.h0[d][c0 + f], dc0[f]);  // (h0^T dy_x)[n]
                    dbe[f] = fmaf(xd, sm.g[d][c0 + f], dbe[f]);    // (G^T x_x)[n]
                }
            }
            for (int n = 0; n < HD; ++n) {
                const float bn = sm.bm[x][n];
#pragma unroll
                for (int f = 0; f < 8; ++f) dxa[f] = fmaf(bn, sm.g[c0 + f][n], dxa[f]);  // (G b_x)[d]
            }
            for (int s = 0; s <= x; ++s) {
                const float le = sm.le[x][s];
#pragma unroll
                for (int f = 0; f < 8; ++f) dcs[f] = fmaf(le, sm.bm[s][c0 + f], dcs[f]);
            }
            float dxi[8];
#pragma unroll
            for (int f = 0; f < 8; ++f) dxi[f] = 0.f;
            for (int t = x; t < L; ++t) {
                const float le = sm.le[t][x], lcb = sm.lcb[t][x];
#pragma unroll
                for (int f = 0; f < 8; ++f) {
                    dbi[f] = fmaf(le, sm.cm[t][c0 + f], dbi[f]);
                    dxi[f] = fmaf(lcb, sm.dy[t][c0 + f], dxi[f]);
                }
            }
            const float pre = sm.pre[x], suf = sm.suf[x];
            float cpart = 0.f, bpart = 0.f;
            float outc[8], outb[8], outx[8];
#pragma unroll
            for (int f = 0; f < 8; ++f) {
                const float dc_start = pre * dc0[f], db_end = suf * dbe[f];
                cpart = fmaf(sm.cm[x][c0 + f], dc_start, cpart);
                bpart = fmaf(sm.bm[x][c0 + f], db_end, bpart);
                outc[f] = dc_start + dcs[f];
                outb[f] = dbi[f] + db_end;
                outx[f] = fmaf(suf, dxa[f], dxi[f]);
            }
            cpart = group8_sum(cpart);
            bpart = group8_sum(bpart);
            if ((tid & 7) == 0) {
                sm.cdc0[x] = cpart;
                sm.bdbe[x] = bpart;
            }
            if (t0 + x < p.seq_len) {
                const long long off = o_base + (t0 + x) * o_ss + c0;
                float4* dc4 = reinterpret_cast<float4*>(p.dc + off);
                float4* db4 = reinterpret_cast<float4*>(p.db + off);
                float4* dx4 = reinterpret_cast<float4*>(p.dx + off);
                dc4[0] = make_float4(outc[0], outc[1], outc[2], outc[3]);
                dc4[1] = make_float4(outc[4], outc[5], outc[6], outc[7]);
                db4[0] = make_float4(outb[0], outb[1], outb[2], outb[3]);
                db4[1] = make_float4(outb[4], outb[5], outb[6], outb[7]);
                dx4[0] = make_float4(outx[0], outx[1], outx[2], outx[3]);
                dx4[1] = make_float4(outx[4], outx[5], outx[6], outx[7]);
            }
        }
        if (warp == 7) {  // lane t: the pairs s < t <= tau
            const int t = lane;
            float acc = 0.f;
            for (int s = 0; s < t; ++s)
                for (int tau = t; tau < L; ++tau) acc += sm.mm[tau][s];
            sm.inner[t] = acc;
        }
        __syncthreads();

        // (4) dlog (warp 0, lane t), and G for the chunk before.
        if (warp == 0) {
            const int t = lane;
            float after = 0.f, before = 0.f, ghs = 0.f;
            for (int tau = t; tau < L; ++tau) after += sm.cdc0[tau];
            for (int s = 0; s < t; ++s) before += sm.bdbe[s];
            for (int d = 0; d < HD; ++d) ghs += sm.gh[d];
            const float pl = sm.pre[L - 1];
            if (t0 + t < p.seq_len)
                p.dlog[(b * p.seq_len + t0 + t) * p.heads + h] = (after + sm.inner[t]) + (before + pl * ghs);
        }
        {
            float acc[16];
            const float pl = sm.pre[L - 1];
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[e] = pl * sm.g[ed][en + e];
            for (int t = 0; t < L; ++t) {
                const float pd = sm.pre[t] * sm.dy[t][ed];
#pragma unroll
                for (int e = 0; e < 16; ++e) acc[e] = fmaf(pd, sm.cm[t][en + e], acc[e]);
            }
#pragma unroll
            for (int e = 0; e < 16; ++e) sm.g[ed][en + e] = acc[e];
        }
        __syncthreads();
    }
}

bool bad_shape(int batch, int seq_len, int heads)
{
    return batch < 1 || batch > 65535 || seq_len < 1 || heads < 1 || heads > 0x7fffffff / HD;
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the cudaError_t of the launch (0 = queued).
// strides: element strides (batch, sequence, head) of r, k, v and w (12).
// states: B * H * ceil(S / 32) * 64 * 64 floats of scratch.
int wkv6_scan_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* dy, void* dr, void* dk, void* dv, void* dlw,
                         void* du_part, void* states, const long long* strides, int batch,
                         int seq_len, int heads, void* stream)
{
    if (bad_shape(batch, seq_len, heads)) return static_cast<int>(cudaErrorInvalidValue);
    WkvBwdParams p;
    p.r = static_cast<const float*>(r);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u);
    p.dy = static_cast<const float*>(dy);
    p.dr = static_cast<float*>(dr);
    p.dk = static_cast<float*>(dk);
    p.dv = static_cast<float*>(dv);
    p.dlw = static_cast<float*>(dlw);
    p.du_part = static_cast<float*>(du_part);
    p.states = static_cast<float*>(states);
    p.r_sb = strides[0]; p.r_ss = strides[1]; p.r_sh = strides[2];
    p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
    p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
    p.w_sb = strides[9]; p.w_ss = strides[10]; p.w_sh = strides[11];
    p.seq_len = seq_len;
    p.heads = heads;
    const int smem = static_cast<int>(sizeof(WkvBwdSmem));
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv6_scan_bwd_kernel<<<dim3(heads, batch), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// strides: decay (batch, sequence, head), dtx (batch, sequence, head), b
// (batch, sequence), c (batch, sequence): 10 element strides.  state must be 64.
int ssd_scan_bwd_launch(const void* decay, const void* dtx, const void* b, const void* c,
                        const void* dy, void* dlog, void* ddtx, void* db_h, void* dc_h,
                        void* states, const long long* strides, int batch, int seq_len, int heads,
                        int state, void* stream)
{
    if (bad_shape(batch, seq_len, heads) || state != HD)
        return static_cast<int>(cudaErrorInvalidValue);
    SsdBwdParams p;
    p.decay = static_cast<const float*>(decay);
    p.dtx = static_cast<const float*>(dtx);
    p.bm = static_cast<const float*>(b);
    p.cm = static_cast<const float*>(c);
    p.dy = static_cast<const float*>(dy);
    p.dlog = static_cast<float*>(dlog);
    p.dx = static_cast<float*>(ddtx);
    p.db = static_cast<float*>(db_h);
    p.dc = static_cast<float*>(dc_h);
    p.states = static_cast<float*>(states);
    p.dec_sb = strides[0]; p.dec_ss = strides[1]; p.dec_sh = strides[2];
    p.x_sb = strides[3]; p.x_ss = strides[4]; p.x_sh = strides[5];
    p.b_sb = strides[6]; p.b_ss = strides[7];
    p.c_sb = strides[8]; p.c_ss = strides[9];
    p.seq_len = seq_len;
    p.heads = heads;
    const int smem = static_cast<int>(sizeof(SsdBwdSmem));
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_scan_bwd_kernel<<<dim3(heads, batch), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

const char* recurrence_bwd_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
