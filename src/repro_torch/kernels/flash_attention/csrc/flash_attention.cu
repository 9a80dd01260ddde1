// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:_kernel
// (line 24, launched by flash_attention_fwd).  It computes, for every batch b,
// head h and query row i < S,
//
//     o[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,g,:] * D^-0.5) v[b,j,g,:],
//
// g = h / (H / KV) (grouped-query attention by index: no repeated K/V copy),
// over keys j < S_kv, and j <= i when causal.  The softmax is the online one of
// the TPU kernel: a running max m, a running sum l and the output accumulator
// are carried in float32 over the key tiles, masked scores are -1e30 (so a
// fully masked row never forms -inf - -inf), and the output is
// acc / max(l, 1e-30), stored in q's dtype.  When the caller passes an lse
// buffer, each row's m + log(max(l, 1e-30)) (natural log, scaled scores) is
// stored there too, float32 (B, H, S), for the recomputing backward; a null
// lse stores nothing more than the output.
//
// Layout.  q and o are read and written as (B, S, H, D), k and v as
// (B, S_kv, KV, D), through element strides for batch, sequence and head (the
// last dimension is contiguous): the model's projections need no transposed
// copies.  A non-causal call takes a key length S_kv of its own
// (cross-attention); a causal one has S_kv = S.  Query rows at or past S and
// key rows at or past S_kv are masked here; nothing is padded.  Every offset
// is 64-bit.
//
// Translation.  The TPU kernel runs one grid step per (batch*head, q-block)
// and walks K/V held whole in VMEM with a fori_loop.  Here one CTA owns one
// (b, h, 64-query tile) and loops over 64-key tiles that it stages in shared
// memory; for causal attention the loop stops at the diagonal tile, and the
// CTAs with the longest loops are scheduled first.
//
// What bounds it on the H100: operations.  A causal (b, h) needs
// 4 * D * S(S+1)/2 flops (2.75e11 at S = 32768, D = 128) against 8*S*D bytes
// of q, k, v and o, far above the card's 295 flops per byte.  What the design
// does about it, for bfloat16 inputs: both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate); scores and probabilities stay
// in registers and never reach device memory (the probabilities are rounded
// to bf16 for the second product, as the JAX blocked path rounds them); K/V
// tiles arrive by cp.async in a two-stage ring, so the next tile's load
// overlaps this tile's products; fragments come out of shared memory by
// ldmatrix from rows padded by 16 bytes (no bank conflicts).  What it does not
// do yet: wgmma, TMA and warp specialisation, the route to the card's full
// tensor-core rate, are for a later change.
//
// float32 inputs are computed in float32 on the CUDA cores (no bf16 or TF32
// rounding: the f32 tolerance is 2e-5), four threads per query row, with
// 32-key tiles in shared memory.  That path is exact rather than fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;  // (B, H, S) row log-sum-exp of the scaled scores; null: not stored
    // Element strides for batch, sequence and head; the last dim is contiguous.
    long long q_sb, q_ss, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long o_sb, o_ss, o_sh;
    int seq_len;
    int kv_len;   // keys; equal to seq_len when causal
    int group;    // H / KV
    float scale;  // D^-0.5
    int causal;
};

// ---------------------------------------------------------------- bf16 path

constexpr int BQ = 64;    // query rows per CTA, 16 per warp
constexpr int BKV = 64;   // keys per tile
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; when !valid the destination is zero-filled, nothing read.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid)
{
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
    return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [0, 64) of a (rows, D) slice into shared memory rows of D + 8
// elements; rows at or past `rows_valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int rows_valid, int tid)
{
    constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
    constexpr int PER_THREAD = 64 * CHUNKS / THREADS;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int c = tid + i * THREADS;
        const int row = c / CHUNKS;
        const int col = (c % CHUNKS) * 8;
        const bool valid = row < rows_valid;
        const bf16* g = src + (valid ? row * row_stride : 0) + col;
        cp_async_16(smem_u32(dst + row * (D + 8) + col), g, valid);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16_kernel(const Params p)
{
    constexpr int LDS = D + 8;  // padded row: ldmatrix rows fall in distinct banks
    constexpr int KSTEPS = D / 16;
    constexpr int NT_S = BKV / 8;  // score n-tiles per warp
    constexpr int NT_O = D / 8;    // output n-tiles per warp
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + BQ * LDS;       // two stages of BKV x LDS
    bf16* sV = sK + 2 * BKV * LDS;  // two stages of BKV x LDS

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int qt = p.causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int S = p.seq_len;
    const int q0 = qt * BQ;

    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
    const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
    const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

    const int SK = p.kv_len;
    const int n_kv_all = (SK + BKV - 1) / BKV;
    const int n_kv = p.causal ? min(n_kv_all, (q0 + BQ - 1) / BKV + 1) : n_kv_all;

    load_tile<D>(sQ, qg, p.q_ss, S - q0, tid);
    load_tile<D>(sK, kg, p.k_ss, SK, tid);
    load_tile<D>(sV, vg, p.v_ss, SK, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // ldmatrix lane addressing: A / transposed-B tiles (rows r, r+8; cols c, c+8)
    // and non-transposed B tiles (two n-tiles of 8 keys; k cols c, c+8).
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_col = (lane >> 4) * 8;
    const int b_row = (lane & 7) + (lane >> 4) * 8;
    const int b_col = ((lane >> 3) & 1) * 8;

    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(sQ + (warp * 16 + a_row) * LDS + kk * 16 + a_col));

    float o[NT_O][4];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's partial row sums; reduced at the end
    const float scale_log2 = p.scale * LOG2E;
    const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8

    for (int j = 0; j < n_kv; ++j) {
        if (j + 1 < n_kv) {
            const int nxt = (j + 1) & 1;
            const long long k1 = static_cast<long long>(j + 1) * BKV;
            load_tile<D>(sK + nxt * BKV * LDS, kg + k1 * p.k_ss, p.k_ss, SK - (j + 1) * BKV, tid);
            load_tile<D>(sV + nxt * BKV * LDS, vg + k1 * p.v_ss, p.v_ss, SK - (j + 1) * BKV, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* sKs = sK + (j & 1) * BKV * LDS;
        const bf16* sVs = sV + (j & 1) * BKV * LDS;

        // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
        float s[NT_S][4];
#pragma unroll
        for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
            for (int np = 0; np < NT_S / 2; ++np) {
                uint32_t r[4];
                ldmatrix_x4(r, smem_u32(sKs + (np * 16 + b_row) * LDS + kk * 16 + b_col));
                mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
                mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
            }
        }

        // Scale into the exp2 domain; mask keys past S_kv and, on the diagonal, above it.
        const int kv0 = j * BKV;
        const bool need_mask = (p.causal && kv0 + BKV - 1 > q0) || kv0 + BKV > SK;
        float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[n][e] * scale_log2;
                if (need_mask) {
                    const int key = kv0 + n * 8 + (lane & 3) * 2 + (e & 1);
                    const int row = row0 + (e >> 1) * 8;
                    if (key >= SK || (p.causal && key > row)) x = NEG_INF;
                }
                s[n][e] = x;
                tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
            }
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(FULL, tmax[i], 1));
            tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(FULL, tmax[i], 2));
            const float m_new = fmaxf(m[i], tmax[i]);
            alpha[i] = exp2f(m[i] - m_new);
            m[i] = m_new;
            l[i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
            o[n][0] *= alpha[0];
            o[n][1] *= alpha[0];
            o[n][2] *= alpha[1];
            o[n][3] *= alpha[1];
        }
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[n][e] = exp2f(s[n][e] - m[e >> 1]);
                l[e >> 1] += s[n][e];
            }
        }

        // O += P V: the score accumulators of two n-tiles are one A fragment.
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
            const uint32_t a[4] = {
                pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
                uint32_t r[4];
                ldmatrix_x4_trans(r, smem_u32(sVs + (kk * 16 + a_row) * LDS + dp * 16 + a_col));
                mma_bf16(o[2 * dp], a, r[0], r[1]);
                mma_bf16(o[2 * dp + 1], a, r[2], r[3]);
            }
        }
        __syncthreads();  // this stage is refilled two iterations on
    }

    float denom[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(FULL, l[i], 1);
        l[i] += __shfl_xor_sync(FULL, l[i], 2);
        denom[i] = fmaxf(l[i], 1e-30f);
    }
    bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = row0 + i * 8;
        if (row >= S) continue;
        // m is in log2 units of the scaled scores: lse = m ln 2 + ln l.
        if (p.lse != nullptr && (lane & 3) == 0)
            p.lse[(static_cast<long long>(b) * gridDim.y + h) * S + row] =
                m[i] * LN2 + logf(denom[i]);
        bf16* orow = og + row * p.o_ss + (lane & 3) * 2;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
            *reinterpret_cast<uint32_t*>(orow + n * 8) =
                pack_bf16(o[n][2 * i] / denom[i], o[n][2 * i + 1] / denom[i]);
        }
    }
}

// ----------------------------------------------------------------- f32 path

constexpr int F_BQ = 64;   // query rows per CTA, four threads each
constexpr int F_BKV = 32;  // keys per tile
constexpr int F_THREADS = 256;

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32_kernel(const Params p)
{
    constexpr int PER = D / 4;  // thread `sub` owns columns sub, sub + 4, ...
    __shared__ __align__(16) float sK[F_BKV][D];
    __shared__ __align__(16) float sV[F_BKV][D];

    const int tid = threadIdx.x;
    const int sub = tid & 3;
    const int qt = p.causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int S = p.seq_len;
    const int q0 = qt * F_BQ;
    const int row = q0 + (tid >> 2);

    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
    const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

    float qr[PER], acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        qr[i] = row < S ? qg[row * p.q_ss + sub + 4 * i] : 0.f;
        acc[i] = 0.f;
    }
    float m = NEG_INF, l = 0.f;

    const int SK = p.kv_len;
    const int n_kv_all = (SK + F_BKV - 1) / F_BKV;
    const int n_kv = p.causal ? min(n_kv_all, (q0 + F_BQ - 1) / F_BKV + 1) : n_kv_all;
    constexpr int CHUNKS = D / 4;  // float4 per row
    constexpr int LOADS = F_BKV * CHUNKS / F_THREADS;
    static_assert(LOADS * F_THREADS == F_BKV * CHUNKS, "D must be a multiple of 32");
    for (int j = 0; j < n_kv; ++j) {
        const int kv0 = j * F_BKV;
        __syncthreads();  // the previous tile's readers are done
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
            const int c = tid + i * F_THREADS;
            const int r = c / CHUNKS;
            const int col = (c % CHUNKS) * 4;
            float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
            if (kv0 + r < SK) {
                const long long key = kv0 + r;
                kx = *reinterpret_cast<const float4*>(kg + key * p.k_ss + col);
                vx = *reinterpret_cast<const float4*>(vg + key * p.v_ss + col);
            }
            *reinterpret_cast<float4*>(&sK[r][col]) = kx;
            *reinterpret_cast<float4*>(&sV[r][col]) = vx;
        }
        __syncthreads();

        float sc[F_BKV];
        float tmax = NEG_INF;
#pragma unroll
        for (int t = 0; t < F_BKV; ++t) {
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < PER; ++i) part = fmaf(qr[i], sK[t][sub + 4 * i], part);
            part += __shfl_xor_sync(FULL, part, 1);
            part += __shfl_xor_sync(FULL, part, 2);
            const int key = kv0 + t;
            float x = part * p.scale;
            if (key >= SK || (p.causal && key > row)) x = NEG_INF;
            sc[t] = x;
            tmax = fmaxf(tmax, x);
        }
        const float m_new = fmaxf(m, tmax);
        const float alpha = expf(m - m_new);
        m = m_new;
        float psum = 0.f;
#pragma unroll
        for (int t = 0; t < F_BKV; ++t) {
            sc[t] = expf(sc[t] - m_new);
            psum += sc[t];
        }
        l = l * alpha + psum;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            float a = acc[i] * alpha;
#pragma unroll
            for (int t = 0; t < F_BKV; ++t) a = fmaf(sc[t], sV[t][sub + 4 * i], a);
            acc[i] = a;
        }
    }
    if (row < S) {
        float* orow = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
        const float denom = fmaxf(l, 1e-30f);
#pragma unroll
        for (int i = 0; i < PER; ++i) orow[sub + 4 * i] = acc[i] / denom;
        if (p.lse != nullptr && sub == 0)
            p.lse[(static_cast<long long>(b) * gridDim.y + h) * S + row] = m + logf(denom);
    }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int batch, int heads, cudaStream_t stream)
{
    const size_t smem = static_cast<size_t>(BQ + 4 * BKV) * (D + 8) * sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.seq_len + BQ - 1) / BQ, heads, batch);
    flash_fwd_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, int batch, int heads, cudaStream_t stream)
{
    const dim3 grid((p.seq_len + F_BQ - 1) / F_BQ, heads, batch);
    flash_fwd_f32_kernel<D><<<grid, F_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = queued).
// strides: 12 element strides, (batch, sequence, head) for q, k, v and o.
// kv_len: the keys' sequence length; a causal call must pass seq_len.
// lse: null, or a contiguous float32 (batch, num_heads, seq_len) output that
// takes each row's log-sum-exp (natural log) of the D^-0.5-scaled scores.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                           const long long* strides, int batch, int seq_len, int kv_len,
                           int num_heads, int num_kv_heads, int head_dim, int causal,
                           int is_bf16, void* stream)
{
    if (batch < 1 || batch > 65535 || seq_len < 1 || kv_len < 1 ||
        (causal && kv_len != seq_len) || num_heads < 1 || num_heads > 65535 ||
        num_kv_heads < 1 || num_heads % num_kv_heads != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.lse = static_cast<float*>(lse);
    p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
    p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
    p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
    p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
    p.seq_len = seq_len;
    p.kv_len = kv_len;
    p.group = num_heads / num_kv_heads;
    p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim)));
    p.causal = causal ? 1 : 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (head_dim * 2 + (is_bf16 ? 1 : 0)) {
        case 32 * 2 + 1: err = launch_bf16<32>(p, batch, num_heads, s); break;
        case 64 * 2 + 1: err = launch_bf16<64>(p, batch, num_heads, s); break;
        case 128 * 2 + 1: err = launch_bf16<128>(p, batch, num_heads, s); break;
        case 32 * 2: err = launch_f32<32>(p, batch, num_heads, s); break;
        case 64 * 2: err = launch_f32<64>(p, batch, num_heads, s); break;
        case 128 * 2: err = launch_f32<128>(p, batch, num_heads, s); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

const char* flash_attention_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
