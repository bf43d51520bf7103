// K electrical Izhikevich steps on a stencil-coupled (rows, cols) lattice.
//
// Replaces the three TPU kernels of spiking_neural_networks_tpu/ops/
// pallas_stencil.py that carry the electrical Izhikevich lattice:
//   fused_izhikevich_stencil_step      (one step per launch),
//   fused_izhikevich_multistep         (K steps, whole lattice on chip),
//   fused_izhikevich_multistep_tiled   (K steps on row tiles, uniform params).
// The three compute one function and differ only in the layout their
// compiler forced; here it has three designs (below), every one bit-equal
// to the twin.
//
// Per step and cell (r, c), in the fused association of the TPU kernels:
//   wsum = sum_o w_o                       (offset order, from 0)
//   acc  = sum_o w_o * v[r+dr_o, c+dc_o]   (offset order, from 0)
//   i    = gap * (acc - v * wsum) / max(in_deg, 1)
//   dv   = (0.04 v v + 5 v + 140 - w + i) * (dt / c_m)
//   dw   = (a * (b v - w)) * (dt / tau_m)
//   v' = v + dv, w' = w + dw; spike = v' >= v_th -> v' = c, w' += d,
//   lft = clock0 + k.
// Off-grid neighbours are skipped by a bounds check, never read.  Build with
// -fmad=false: the kernel then rounds exactly as its plain PyTorch twin
// (ops/stencil_kernels.izhikevich_stencil_steps_reference).
//
// Three designs, routed by ops/stencil_kernels.route (the route follows
// what was timed on an H100, PERF.md section 6 rows 1-3):
//
// The persistent design (where ops/stencil_kernels.persistent_plan holds a
// block's weights in shared memory: at radius 2 up to ~735 x 735, the
// 512 x 512 main path) replaces fused_izhikevich_multistep, the TPU kernel
// that keeps the whole lattice on chip for K steps.  It is not in this
// file: it is model_persistent_kernel<Izh, CPT> of model_stencil.cu (kind
// MS_IZH, the plain Izhikevich over its own field order), one cooperative
// launch per 16 steps, the weights, wsum, max(in_deg, 1) and the 9
// parameter planes in shared memory, v, w and lft in registers, v through
// two global planes and a grid.sync() a step; with an emission pointer it
// writes each step's pre-reset v.  izhikevich_step there is this file's
// arithmetic op for op.  What bounds it: the shared-memory reads, the
// arithmetic and the barrier, not HBM (the step's 29 MB at 512 x 512 are
// read once per call).
//
// The tiled design (izh_tiled_kernel<CPT>; where every parameter plane is
// uniform and ops/stencil_kernels.tile_plan fits the halo: pad <= 4, the
// 1024^2, 2048^2 and 4096^2 main paths) replaces
// fused_izhikevich_multistep_tiled, the TPU kernel's temporal blocking,
// redesigned for an SM: block (bx, by) loads a th x tw interior tile plus
// a halo of kb * pad cells into shared memory (the weights and two v
// buffers; w, wsum, max(in_deg, 1), lft and the on-grid mask in
// registers), runs kb steps behind __syncthreads(), computing on step s
// only the cells within halo - (s + 1) * pad of the interior (their
// neighbours were computed on step s - 1, so the interior is exact), and
// writes the interior's v, w, lft, last-step spikes and, when emitting,
// each step's pre-reset v.  Halo cells are recomputed with the same ops,
// so the interior keeps the twin's bits.  The parameters are 9 scalars
// (the TPU kernel's contract, checked bit for bit once per run by
// ops/stencil_kernels.uniform_scalars).  One launch per kb steps, so the
// weights and in_deg are read once per kb steps and the parameter planes
// never: at radius 2 with the 48 x 48 interior, kb = 4, ~28 bytes a cell
// a step against the per-step design's 112.  What bounds it: HBM for the
// loaded tiles (a 64 x 64 tile for a 48 x 48 interior), then the shared-
// memory reads and the halo's recomputation (~1.3x the interior's cells).
//
// The per-step design (izh_stencil_step_kernel: one thread per cell, 2-D
// blocks of 32 x 8, one launch per step, per-neuron parameter planes)
// replaces fused_izhikevich_stencil_step.  It serves what neither design
// above takes (per-neuron parameters past the persistent plan, stencils
// reaching farther than 4 cells) and the comparison in turns
// (design="per_step").  What bounds it: memory traffic, 25 planes read
// and 3 written a step at radius 2, 112 bytes a cell: 470 MB a step at
// 2048 x 2048 from HBM.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>

#define IZH_MAX_OFFSETS 64
#define IZH_TILE_THREADS 1024   // at most, a tiled block's threads
#define IZH_TILE_MAX_CPT 4      // loaded cells a tiled thread

struct Stencil {
    int n;
    int dr[IZH_MAX_OFFSETS];
    int dc[IZH_MAX_OFFSETS];
};

struct Params {
    const float* a;
    const float* b;
    const float* c;
    const float* d;
    const float* v_th;
    const float* gap;
    const float* tau_m;
    const float* c_m;
    const float* dt;
};

__global__ void izh_stencil_step_kernel(
    const float* __restrict__ v_in, const float* __restrict__ w_in,
    const int* __restrict__ lft_in,
    float* __restrict__ v_out, float* __restrict__ w_out,
    int* __restrict__ lft_out,
    unsigned char* __restrict__ spk_out,   // null except on the last step
    float* __restrict__ v_pre_out,         // null unless emitting
    const float* __restrict__ weights, const float* __restrict__ in_deg,
    Params p, Stencil st, int rows, int cols, int clock)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row >= rows || col >= cols) return;
    const size_t n = (size_t)rows * cols;
    const size_t i = (size_t)row * cols + col;

    const float v = v_in[i];
    const float w = w_in[i];
    float acc = 0.0f;
    float wsum = 0.0f;
    for (int o = 0; o < st.n; ++o) {
        const float wo = weights[(size_t)o * n + i];
        wsum = wsum + wo;
        const int sr = row + st.dr[o];
        const int sc = col + st.dc[o];
        if (sr >= 0 && sr < rows && sc >= 0 && sc < cols)
            acc = acc + wo * v_in[(size_t)sr * cols + sc];
    }
    const float cnt = fmaxf(in_deg[i], 1.0f);
    const float i_syn = p.gap[i] * (acc - v * wsum) / cnt;
    const float dt = p.dt[i];
    const float dt_cm = dt / p.c_m[i];
    const float dt_tau = dt / p.tau_m[i];
    const float dv = (0.04f * v * v + 5.0f * v + 140.0f - w + i_syn) * dt_cm;
    const float dw = (p.a[i] * (p.b[i] * v - w)) * dt_tau;
    const float v_pre = v + dv;
    const float w_pre = w + dw;
    const bool spike = v_pre >= p.v_th[i];

    v_out[i] = spike ? p.c[i] : v_pre;
    w_out[i] = spike ? w_pre + p.d[i] : w_pre;
    lft_out[i] = spike ? clock : lft_in[i];
    if (spk_out) spk_out[i] = spike ? 1 : 0;
    if (v_pre_out) v_pre_out[i] = v_pre;
}

// ---------------------------------------------------------------------------
// The tiled design
// ---------------------------------------------------------------------------

// One tiled launch: n_steps (at most kb) steps from (v_in, w_in, lft_in)
// into (v_out, w_out, lft_out), the 9 parameters as scalars.  Block
// (bx, by) owns the interior rows [by th, by th + th) x columns
// [bx tw, bx tw + tw) and loads it with `halo` = kb * pad cells of halo on
// each side: an (lh, lw) tile whose cell (0, 0) is the global cell
// (by th - halo, bx tw - halo).
struct TileP {
    const float* v_in;
    const float* w_in;
    const int* lft_in;
    float* v_out;
    float* w_out;
    int* lft_out;
    unsigned char* spk_out;   // null unless the launch ends the call
    float* v_pre;             // null unless emitting: step s at s * n
    const float* weights;
    const float* in_deg;
    float a, b, c, d, v_th, gap, tau_m, c_m, dt;
    int lin[IZH_MAX_OFFSETS]; // dr * lw + dc: each offset inside the tile
    Stencil st;
    int rows, cols, clock0, n_steps, pad;
    int th, tw, halo, lh, lw;
};

// Thread t holds the tile's cells t + q * blockDim.x (q < CPT).  A cell at
// Chebyshev distance `dist` from the interior is computed on step s while
// dist <= halo - (s + 1) * pad: its neighbours, at most pad further out,
// were computed on step s - 1 (or loaded), so the interior (dist 0) is
// exact after kb steps.  Cells off the grid are neither loaded nor read
// (dist -1, and the on-grid mask of each computed cell).  EDGE: the tile
// reaches past the grid's border; a tile inside it (!EDGE) has every cell
// on the grid and every computed cell's neighbours too, so it needs no
// bounds and no masks, and its rows load as 16-byte copies where the
// addresses allow.
template <int CPT, bool EDGE>
__device__ __forceinline__ void tiled_body(const TileP& P, float* sw,
                                           int r0, int c0)
{
    const int cells = P.lh * P.lw;
    float* sv0 = sw + (size_t)P.st.n * cells;            // v, two buffers
    float* sv1 = sv0 + cells;
    const size_t n = (size_t)P.rows * P.cols;
    const int n_off = P.st.n;
    float v[CPT], w[CPT], wsum[CPT], cnt[CPT];
    int lft[CPT], dist[CPT];
    unsigned long long on[CPT];    // the offsets of on-grid neighbours
    // the tile's v and the computed cells' weights go to shared memory as
    // asynchronous copies, all in flight at once; w, in_deg and lft come
    // into registers meanwhile
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
        const int loc = threadIdx.x + q * blockDim.x;
        dist[q] = -1;
        if (loc >= cells) continue;
        const int lr = loc / P.lw;
        const int lc = loc - lr * P.lw;
        const int gr = r0 + lr;
        const int gc = c0 + lc;
        if (EDGE && (gr < 0 || gr >= P.rows || gc < 0 || gc >= P.cols))
            continue;
        const int dr = max(P.halo - lr, lr - (P.halo + P.th - 1));
        const int dc = max(P.halo - lc, lc - (P.halo + P.tw - 1));
        dist[q] = max(max(dr, dc), 0);
    }
    const bool vec = !EDGE && P.cols % 4 == 0 && c0 % 4 == 0
        && P.lw % 4 == 0 && ((size_t)P.v_in | (size_t)P.weights) % 16 == 0;
    if (vec) {
        // rows of 16-byte chunks; the weights of the rows that hold a
        // computed cell
        const int per_row = P.lw / 4;
        for (int k = threadIdx.x; k < P.lh * per_row; k += blockDim.x) {
            const int lr = k / per_row;
            const int loc = lr * P.lw + (k - lr * per_row) * 4;
            const size_t i = (size_t)(r0 + lr) * P.cols + c0
                + (k - lr * per_row) * 4;
            __pipeline_memcpy_async(sv0 + loc, P.v_in + i, 16);
            if (lr < P.pad || lr >= P.lh - P.pad) continue;
            for (int o = 0; o < n_off; ++o)
                __pipeline_memcpy_async(sw + (size_t)o * cells + loc,
                                        P.weights + (size_t)o * n + i, 16);
        }
    } else {
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
            if (dist[q] < 0) continue;
            const int loc = threadIdx.x + q * blockDim.x;
            const int lr = loc / P.lw;
            const size_t i = (size_t)(r0 + lr) * P.cols
                + (c0 + loc - lr * P.lw);
            __pipeline_memcpy_async(sv0 + loc, P.v_in + i, sizeof(float));
            if (dist[q] > P.halo - P.pad) continue;   // read, never computed
            for (int o = 0; o < n_off; ++o)
                __pipeline_memcpy_async(sw + (size_t)o * cells + loc,
                                        P.weights + (size_t)o * n + i,
                                        sizeof(float));
        }
    }
    __pipeline_commit();
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
        if (dist[q] < 0 || dist[q] > P.halo - P.pad) continue;
        const int loc = threadIdx.x + q * blockDim.x;
        const int lr = loc / P.lw;
        const int gr = r0 + lr;
        const int gc = c0 + loc - lr * P.lw;
        const size_t i = (size_t)gr * P.cols + gc;
        w[q] = P.w_in[i];
        cnt[q] = fmaxf(P.in_deg[i], 1.0f);
        if (dist[q] == 0) lft[q] = P.lft_in[i];
        if constexpr (EDGE) {
            unsigned long long m = 0;
            for (int o = 0; o < n_off; ++o) {
                const int sr = gr + P.st.dr[o];
                const int sc = gc + P.st.dc[o];
                if (sr >= 0 && sr < P.rows && sc >= 0 && sc < P.cols)
                    m |= 1ull << o;
            }
            on[q] = m;
        }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    // wsum from the copies, in offset order (the twin's sum, so its bits)
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
        if (dist[q] < 0 || dist[q] > P.halo - P.pad) continue;
        const int loc = threadIdx.x + q * blockDim.x;
        float s = 0.0f;
        for (int o = 0; o < n_off; ++o) s = s + sw[(size_t)o * cells + loc];
        wsum[q] = s;
        v[q] = sv0[loc];
    }
    const float dt_cm = P.dt / P.c_m;
    const float dt_tau = P.dt / P.tau_m;
    for (int s = 0; s < P.n_steps; ++s) {
        const float* vs = (s & 1) ? sv1 : sv0;
        float* vd = (s & 1) ? sv0 : sv1;
        const int reach = P.halo - (s + 1) * P.pad;
        const bool last = s + 1 == P.n_steps;
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
            if (dist[q] < 0 || dist[q] > reach) continue;
            const int loc = threadIdx.x + q * blockDim.x;
            const float* wo = sw + loc;
            const float* vl = vs + loc;
            float acc = 0.0f;
            if constexpr (EDGE) {
                for (int o = 0; o < n_off; ++o)
                    if ((on[q] >> o) & 1ull)
                        acc = acc + wo[(size_t)o * cells] * vl[P.lin[o]];
            } else {
#pragma unroll 4
                for (int o = 0; o < n_off; ++o)
                    acc = acc + wo[o * cells] * vl[P.lin[o]];
            }
            const float vv = v[q];
            const float ww = w[q];
            const float i_syn = P.gap * (acc - vv * wsum[q]) / cnt[q];
            const float dv = (0.04f * vv * vv + 5.0f * vv + 140.0f - ww
                              + i_syn) * dt_cm;
            const float dw = (P.a * (P.b * vv - ww)) * dt_tau;
            const float v_pre = vv + dv;
            const float w_pre = ww + dw;
            const bool spike = v_pre >= P.v_th;
            v[q] = spike ? P.c : v_pre;
            w[q] = spike ? w_pre + P.d : w_pre;
            vd[loc] = v[q];
            if (dist[q] != 0) continue;
            const int lr = loc / P.lw;
            const size_t i = (size_t)(r0 + lr) * P.cols
                + (c0 + loc - lr * P.lw);
            if (spike) lft[q] = P.clock0 + s;
            if (P.v_pre) P.v_pre[(size_t)s * n + i] = v_pre;
            if (last) {
                P.v_out[i] = v[q];
                P.w_out[i] = w[q];
                P.lft_out[i] = lft[q];
                if (P.spk_out) P.spk_out[i] = spike ? 1 : 0;
            }
        }
        __syncthreads();
    }
}

template <int CPT>
__global__ void __launch_bounds__(IZH_TILE_THREADS, 1)
izh_tiled_kernel(const __grid_constant__ TileP P)
{
    extern __shared__ __align__(16) unsigned char izh_smem[];
    const int r0 = (int)blockIdx.y * P.th - P.halo;
    const int c0 = (int)blockIdx.x * P.tw - P.halo;
    if (r0 < 0 || c0 < 0 || r0 + P.lh > P.rows || c0 + P.lw > P.cols)
        tiled_body<CPT, true>(P, (float*)izh_smem, r0, c0);
    else
        tiled_body<CPT, false>(P, (float*)izh_smem, r0, c0);
}

template <int CPT>
static cudaError_t launch_tiled(const TileP& P, dim3 grid, int threads,
                                size_t smem, cudaStream_t s)
{
    cudaError_t err = cudaFuncSetAttribute(
        izh_tiled_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    izh_tiled_kernel<CPT><<<grid, threads, smem, s>>>(P);
    return cudaGetLastError();
}

extern "C" {

// Runs n_steps steps from (v, w, lft) on `stream`.  Step k writes buffer set
// k % 2 (v_buf[k % 2], ...), so the result is in set (n_steps - 1) % 2; the
// inputs are only read.  `spikes` receives the last step's spike flags and
// `v_pre`, when not null, the pre-reset voltage of step k at k * rows * cols.
// `params` holds the 9 parameter planes in the order a, b, c, d, v_th,
// gap_conductance, tau_m, c_m, dt.  *launched (when not null) gains one
// for each kernel launched.  Returns the first CUDA error, 0 if none.
int izh_stencil_steps(
    const float* v, const float* w, const int* lft,
    const float* weights, const float* in_deg, const float* const* params,
    float* v_buf0, float* w_buf0, int* lft_buf0,
    float* v_buf1, float* w_buf1, int* lft_buf1,
    unsigned char* spikes, float* v_pre,
    const int* dr, const int* dc, int n_off,
    int rows, int cols, int clock0, int n_steps, int* launched,
    void* stream)
{
    if (n_off < 0 || n_off > IZH_MAX_OFFSETS || rows <= 0 || cols <= 0
        || n_steps <= 0)
        return (int)cudaErrorInvalidValue;
    Stencil st;
    st.n = n_off;
    for (int o = 0; o < n_off; ++o) {
        st.dr[o] = dr[o];
        st.dc[o] = dc[o];
    }
    Params p = {params[0], params[1], params[2], params[3], params[4],
                params[5], params[6], params[7], params[8]};
    float* v_buf[2] = {v_buf0, v_buf1};
    float* w_buf[2] = {w_buf0, w_buf1};
    int* lft_buf[2] = {lft_buf0, lft_buf1};
    const size_t n = (size_t)rows * cols;
    const dim3 block(32, 8);
    const dim3 grid((cols + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    cudaStream_t s = (cudaStream_t)stream;

    const float* v_src = v;
    const float* w_src = w;
    const int* lft_src = lft;
    for (int k = 0; k < n_steps; ++k) {
        const int b = k & 1;
        izh_stencil_step_kernel<<<grid, block, 0, s>>>(
            v_src, w_src, lft_src, v_buf[b], w_buf[b], lft_buf[b],
            k == n_steps - 1 ? spikes : nullptr,
            v_pre ? v_pre + (size_t)k * n : nullptr,
            weights, in_deg, p, st, rows, cols, clock0 + k);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        if (launched) ++*launched;
        v_src = v_buf[b];
        w_src = w_buf[b];
        lft_src = lft_buf[b];
    }
    return 0;
}

// IZH_MAX_OFFSETS, IZH_TILE_THREADS and IZH_TILE_MAX_CPT, in order.
void izh_stencil_limits(int* out)
{
    out[0] = IZH_MAX_OFFSETS;
    out[1] = IZH_TILE_THREADS;
    out[2] = IZH_TILE_MAX_CPT;
}

// Runs n_steps steps as izh_stencil_steps does, in the tiled design (the
// plan of ops/stencil_kernels.tile_plan): one launch per kb steps (the last
// takes what is left), launch j writing buffer set j % 2, so the result is
// in set (launches - 1) % 2.  Interior tiles of th x tw cells, each loaded
// with a halo of kb * pad cells (pad: the stencil's largest |dr| or |dc|)
// by a block of `threads` threads, cpt loaded cells a thread.  `scalars`
// holds the 9 parameters (uniform planes) in the order of izh_stencil_steps'
// planes.  *launched (when not null) gains one for each kernel launched.
// Returns the first CUDA error, 0 if none.
int izh_stencil_tiled(
    const float* v, const float* w, const int* lft,
    const float* weights, const float* in_deg, const float* scalars,
    float* v_buf0, float* w_buf0, int* lft_buf0,
    float* v_buf1, float* w_buf1, int* lft_buf1,
    unsigned char* spikes, float* v_pre,
    const int* dr, const int* dc, int n_off,
    int rows, int cols, int clock0, int n_steps,
    int th, int tw, int kb, int threads, int cpt, int* launched,
    void* stream)
{
    if (n_off < 0 || n_off > IZH_MAX_OFFSETS || rows <= 0 || cols <= 0
        || n_steps <= 0 || th <= 0 || tw <= 0 || kb <= 0 || threads < 32
        || threads > IZH_TILE_THREADS || threads % 32 != 0 || cpt < 1
        || cpt > IZH_TILE_MAX_CPT)
        return (int)cudaErrorInvalidValue;
    TileP P = {};
    P.st.n = n_off;
    int pad = 0;
    for (int o = 0; o < n_off; ++o) {
        P.st.dr[o] = dr[o];
        P.st.dc[o] = dc[o];
        const int ar = dr[o] < 0 ? -dr[o] : dr[o];
        const int ac = dc[o] < 0 ? -dc[o] : dc[o];
        pad = ar > pad ? ar : pad;
        pad = ac > pad ? ac : pad;
    }
    P.pad = pad;
    P.th = th;
    P.tw = tw;
    P.halo = kb * pad;
    P.lh = th + 2 * P.halo;
    P.lw = tw + 2 * P.halo;
    const long long cells = (long long)P.lh * P.lw;
    if (cells > (long long)threads * cpt) return (int)cudaErrorInvalidValue;
    for (int o = 0; o < n_off; ++o) P.lin[o] = dr[o] * P.lw + dc[o];
    const size_t smem = (size_t)4 * cells * (n_off + 2);
    int dev, optin;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
            != cudaSuccess)
        return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    P.a = scalars[0];
    P.b = scalars[1];
    P.c = scalars[2];
    P.d = scalars[3];
    P.v_th = scalars[4];
    P.gap = scalars[5];
    P.tau_m = scalars[6];
    P.c_m = scalars[7];
    P.dt = scalars[8];
    P.weights = weights;
    P.in_deg = in_deg;
    P.rows = rows;
    P.cols = cols;
    P.v_in = v;
    P.w_in = w;
    P.lft_in = lft;
    float* v_buf[2] = {v_buf0, v_buf1};
    float* w_buf[2] = {w_buf0, w_buf1};
    int* lft_buf[2] = {lft_buf0, lft_buf1};
    const size_t n = (size_t)rows * cols;
    const dim3 grid((cols + tw - 1) / tw, (rows + th - 1) / th);
    cudaStream_t s = (cudaStream_t)stream;
    for (int k0 = 0, j = 0; k0 < n_steps; k0 += kb, ++j) {
        const int b = j & 1;
        P.v_out = v_buf[b];
        P.w_out = w_buf[b];
        P.lft_out = lft_buf[b];
        P.n_steps = n_steps - k0 < kb ? n_steps - k0 : kb;
        P.spk_out = k0 + P.n_steps == n_steps ? spikes : nullptr;
        P.v_pre = v_pre ? v_pre + (size_t)k0 * n : nullptr;
        P.clock0 = clock0 + k0;
        switch (cpt) {
        case 1: err = launch_tiled<1>(P, grid, threads, smem, s); break;
        case 2: err = launch_tiled<2>(P, grid, threads, smem, s); break;
        case 3: err = launch_tiled<3>(P, grid, threads, smem, s); break;
        default: err = launch_tiled<4>(P, grid, threads, smem, s);
        }
        if (err != cudaSuccess) return (int)err;
        if (launched) ++*launched;
        P.v_in = P.v_out;
        P.w_in = P.w_out;
        P.lft_in = P.lft_out;
    }
    return 0;
}

}  // extern "C"
