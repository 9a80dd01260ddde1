// Sequential recurrence scans for NVIDIA Hopper (sm_90a): the RWKV-6 WKV
// recurrence and the Mamba2 (SSD) state recurrence, each over a whole sequence
// in one launch.
//
// Replaces no Pallas kernel.  The JAX package runs both recurrences with
// lax.scan (src/repro/models/rwkv.py:138-154, the WKV step of
// rwkv_time_mix_seq; src/repro/models/ssm.py:91-108, the step of mamba_seq),
// which XLA compiles into one loop on the device.  The port compiles nothing,
// so without these kernels the plain version is a Python loop of about six
// small launches per time step (over six million launches for one rwkv6-3b
// prefill of 32768 tokens).  Each kernel keeps the loop on the card, as XLA's
// loop does.  scan_chunk only places JAX's rematerialisation checkpoints and
// changes nothing in the forward pass, so nothing here reads it.
//
// wkv6_scan: r, k, v, w (B, S, H, 64) float32 and u (H, 64); with the state
// S (64 x 64 per (b, h)) starting at zero, for t = 0 .. S-1
//
//     y_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//     S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
//
// ssd_scan: decay (B, S, H), dtx (B, S, H, 64), b and c (B, S, 64); with h
// (64 x 64 per (b, h)) starting at zero
//
//     h[d,n] <- decay_t * h[d,n] + dtx_t[d] * b_t[n]
//     y_t[d]  = sum_n h[d,n] * c_t[n]
//
// Inputs are read through element strides (batch, sequence, head), the last
// dimension contiguous, so the projections' views need no copy; y is written
// contiguous (B, S, H, 64).
//
// What bounds them on the H100.  Per (b, h) the work is a chain of S
// dependent state updates; across (b, h) it is independent.  WKV-6 at
// rwkv6-3b (B = 2, S = 32768, H = 40) reads and writes 3.36 GB (1.00 ms at
// 3.35 TB/s) and needs 5 float32 operations per state entry and step (2 for
// y, 3 for S) and 5 per step and column for the bonus term, 5.5e10 (0.81 ms
// at 67 TFLOP/s): bytes bound it.  The SSD scan at zamba2-1.2b (B = 2,
// S = 32768, H = 64, N = 64) moves 2.2 GB (0.66 ms) and does 5 per entry and
// step, 8.6e10 (1.28 ms): operations bound it.  Both are about 1 ms a layer.
//
// The design is the simple one: one CTA per (b, h), one thread per state
// column (WKV-6: column j of S; SSD: row d of h), holding its 64 state
// entries in registers for the whole sequence, so the state never leaves the
// SM.  A run of T time steps of the inputs is staged in shared memory at a
// time (each step's 64 values a coalesced 256-byte load), and the products
// read the broadcast operands from it as float4.  With B * H = 80 to 128
// CTAs of two warps each, most of the card idles and each step is a serial
// chain of about 300 instructions: the kernels are several times their
// bounds.  A chunked form that puts the intra-chunk products on the tensor
// cores is the later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;       // head dim (WKV-6) and head dim / state size (SSD)
constexpr int T = 32;        // time steps staged in shared memory per pass
constexpr int THREADS = 64;  // one per state column

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
};

__global__ void __launch_bounds__(THREADS) wkv6_scan_kernel(const WkvParams p)
{
    __shared__ __align__(16) float s_r[T][HD];
    __shared__ __align__(16) float s_k[T][HD];
    __shared__ __align__(16) float s_w[T][HD];
    __shared__ __align__(16) float s_uk[T][HD];  // u[i] * k_t[i]
    __shared__ float s_v[T][HD];

    const int j = threadIdx.x;
    const int h = blockIdx.x;
    const long long b = blockIdx.y;
    const float uj = p.u[h * HD + j];
    const float* rb = p.r + b * p.r_sb + h * p.r_sh + j;
    const float* kb = p.k + b * p.k_sb + h * p.k_sh + j;
    const float* vb = p.v + b * p.v_sb + h * p.v_sh + j;
    const float* wb = p.w + b * p.w_sb + h * p.w_sh + j;
    const long long y_ss = static_cast<long long>(p.heads) * HD;
    float* yb = p.y + b * p.seq_len * y_ss + h * HD + j;

    float st[HD];  // st[i] = S[i, j]
#pragma unroll
    for (int i = 0; i < HD; ++i) st[i] = 0.f;

    for (int t0 = 0; t0 < p.seq_len; t0 += T) {
        const int n = min(T, p.seq_len - t0);
#pragma unroll 4
        for (int tt = 0; tt < n; ++tt) {
            const long long t = t0 + tt;
            const float kj = kb[t * p.k_ss];
            s_r[tt][j] = rb[t * p.r_ss];
            s_k[tt][j] = kj;
            s_w[tt][j] = wb[t * p.w_ss];
            s_uk[tt][j] = uj * kj;
            s_v[tt][j] = vb[t * p.v_ss];
        }
        __syncthreads();
        for (int tt = 0; tt < n; ++tt) {
            const float vj = s_v[tt][j];
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < HD; i += 4) {
                const float4 r4 = *reinterpret_cast<const float4*>(&s_r[tt][i]);
                const float4 k4 = *reinterpret_cast<const float4*>(&s_k[tt][i]);
                const float4 w4 = *reinterpret_cast<const float4*>(&s_w[tt][i]);
                const float4 u4 = *reinterpret_cast<const float4*>(&s_uk[tt][i]);
                acc[0] = fmaf(r4.x, fmaf(u4.x, vj, st[i]), acc[0]);
                acc[1] = fmaf(r4.y, fmaf(u4.y, vj, st[i + 1]), acc[1]);
                acc[2] = fmaf(r4.z, fmaf(u4.z, vj, st[i + 2]), acc[2]);
                acc[3] = fmaf(r4.w, fmaf(u4.w, vj, st[i + 3]), acc[3]);
                st[i] = fmaf(w4.x, st[i], k4.x * vj);
                st[i + 1] = fmaf(w4.y, st[i + 1], k4.y * vj);
                st[i + 2] = fmaf(w4.z, st[i + 2], k4.z * vj);
                st[i + 3] = fmaf(w4.w, st[i + 3], k4.w * vj);
            }
            yb[(t0 + tt) * y_ss] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        }
        __syncthreads();
    }
}

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
};

__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(const SsdParams p)
{
    __shared__ __align__(16) float s_b[T][HD];
    __shared__ __align__(16) float s_c[T][HD];
    __shared__ float s_x[T][HD];
    __shared__ float s_dec[T];

    const int d = threadIdx.x;  // this thread's row of h; also the column it stages
    const int h = blockIdx.x;
    const long long b = blockIdx.y;
    const float* decb = p.decay + b * p.dec_sb + h * p.dec_sh;
    const float* xb = p.dtx + b * p.x_sb + h * p.x_sh + d;
    const float* bb = p.bm + b * p.b_sb + d;
    const float* cb = p.cm + b * p.c_sb + d;
    const long long y_ss = static_cast<long long>(p.heads) * HD;
    float* yb = p.y + b * p.seq_len * y_ss + h * HD + d;

    float hs[HD];  // hs[n] = h[d, n]
#pragma unroll
    for (int n = 0; n < HD; ++n) hs[n] = 0.f;

    for (int t0 = 0; t0 < p.seq_len; t0 += T) {
        const int n_steps = min(T, p.seq_len - t0);
#pragma unroll 4
        for (int tt = 0; tt < n_steps; ++tt) {
            const long long t = t0 + tt;
            s_b[tt][d] = bb[t * p.b_ss];
            s_c[tt][d] = cb[t * p.c_ss];
            s_x[tt][d] = xb[t * p.x_ss];
        }
        if (d < n_steps) s_dec[d] = decb[(t0 + d) * p.dec_ss];
        __syncthreads();
        for (int tt = 0; tt < n_steps; ++tt) {
            const float dec = s_dec[tt];
            const float xd = s_x[tt][d];
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int n = 0; n < HD; n += 4) {
                const float4 b4 = *reinterpret_cast<const float4*>(&s_b[tt][n]);
                const float4 c4 = *reinterpret_cast<const float4*>(&s_c[tt][n]);
                hs[n] = fmaf(xd, b4.x, dec * hs[n]);
                hs[n + 1] = fmaf(xd, b4.y, dec * hs[n + 1]);
                hs[n + 2] = fmaf(xd, b4.z, dec * hs[n + 2]);
                hs[n + 3] = fmaf(xd, b4.w, dec * hs[n + 3]);
                acc[0] = fmaf(hs[n], c4.x, acc[0]);
                acc[1] = fmaf(hs[n + 1], c4.y, acc[1]);
                acc[2] = fmaf(hs[n + 2], c4.z, acc[2]);
                acc[3] = fmaf(hs[n + 3], c4.w, acc[3]);
            }
            yb[(t0 + tt) * y_ss] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
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

// Both launch on `stream` and return the cudaError_t of the launch (0 = queued).
// strides: element strides (batch, sequence, head) of r, k, v and w (12).
int wkv6_scan_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                     void* y, const long long* strides, int batch, int seq_len, int heads,
                     void* stream)
{
    if (bad_shape(batch, seq_len, heads)) return static_cast<int>(cudaErrorInvalidValue);
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
    const dim3 grid(heads, batch);
    wkv6_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
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
    const dim3 grid(heads, batch);
    ssd_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

const char* recurrence_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
