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
// The tiled design (where every parameter plane is uniform and the stencil
// reaches at most 4 cells: the 1024^2, 2048^2 and 4096^2 main paths)
// replaces fused_izhikevich_multistep_tiled, the TPU kernel's temporal
// blocking.  The parameters are 9 scalars (the TPU kernel's contract,
// checked bit for bit once per run by ops/stencil_kernels.uniform_scalars);
// kb steps a launch, the weights and in_deg read once a launch and the
// parameter planes never.  It has two plans (ops/stencil_kernels.
// tiled_plan):
//
// Streamed rows (izh_tiled_kernel_rows<KB, R2>, ops/stencil_kernels.
// stream_plan; a reach of 2 to 4).  A block owns a strip of tw interior
// columns and a segment of seg rows and marches down it r = pad rows an
// iteration, its strip loaded kb * pad columns wider on each side.  Shared
// memory holds rings of rows: the weights of the (kb + 1) r rows levels
// 1..kb compute and the r in flight (each row loaded once a launch, used
// by every time level that passes it), the loaded v and each level's v.
// Time level l computes the row l r behind the newest, from level l - 1's
// rows; the next rows' v and weights go into the rings' free slots by
// cp.async before the current rows are computed, so the loads run under
// the arithmetic; w, lft, wsum and max(in_deg, 1) pass from level to
// level in registers.  Halo is recomputed only on the strip's sides and at
// the segment's ends (at 2048^2, radius 2: 1.17x the interior, against the
// 2-D tiles' 1.67x weights re-read every 4 steps).  The radius-2 disc
// takes an instantiation of its own (R2: each neighbour at a compile-time
// column offset from one of 5 row bases).  What bounds it: not HBM (the
// loads, ~50 MB a step at 2048^2, hide under the arithmetic) but each
// level's phase: a barrier, then every thread's cell as one dependent
// chain (window reads, 12 ordered adds, a division, the Izhikevich
// update), ~780 cycles with 12 warps an SM, the shared memory holding no
// more cells a phase (PERF.md section 6 row 3).
//
// 2-D tiles (izh_tiled_kernel<CPT>, ops/stencil_kernels.tile_plan; a
// reach of 1, where a level's cells are too few for the streamed plan's
// barriers): block (bx, by) loads a th x tw interior tile plus a halo of
// kb * pad cells into shared memory (the weights and two v buffers; w,
// wsum, max(in_deg, 1), lft and the on-grid mask in registers), runs kb
// steps behind __syncthreads(), computing on step s only the cells within
// halo - (s + 1) * pad of the interior (their neighbours were computed on
// step s - 1, so the interior is exact), and writes the interior's v, w,
// lft, last-step spikes and, when emitting, each step's pre-reset v.  What
// bounds it: its loads, not overlapped with its arithmetic (one
// 1024-thread block an SM), and the tile's weights re-read by
// neighbouring tiles.
//
// In both, halo cells are recomputed with the same ops, so the interior
// keeps the twin's bits.
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
#define IZH_STREAM_THREADS 384  // at most, a streamed block's threads

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

// ---------------------------------------------------------------------------
// The tiled design, streamed rows
// ---------------------------------------------------------------------------

// One streamed launch: n_steps (at most KB) steps, the 9 parameters as
// scalars.  Block (bx, by) owns the interior columns [bx tw, bx tw + tw)
// and rows [by seg, by seg + seg), clipped to the grid; its strip is lw =
// tw + 2 halo columns wide (halo = KB * pad), local column c the global
// column bx tw - halo + c, and local row u the global row by seg - halo +
// u, u in [0, nl) with nl = the segment's rows + 2 halo.
struct StreamP {
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
    int lin[IZH_MAX_OFFSETS]; // dr * lw + dc: each offset inside a ring
    int n_off, stride;        // offsets; floats a cell's weights take
    int rows, cols, clock0, n_steps, pad, r, tw, seg, halo, lw;
    int dw, d0, dv;           // rows of the weight, loaded-v and level rings
};

__device__ __forceinline__ int ring_sub(int x, int k, int depth)
{
    x -= k;
    return x < 0 ? x + depth : x;
}

// floats a cell's weights take in the ring (stencil_kernels.weight_stride)
__host__ __device__ constexpr int weight_stride(int n_off)
{
    return (n_off + 3) / 4 * 4 + ((n_off + 3) / 4 % 2 == 0 && n_off ? 4 : 0);
}

// The radius-2 disc (ops/graph.radius_offsets(2.0)), in its order: offset
// o is (r2_dr(o), r2_dc(o)), on the host and in the kernel.  The
// instantiation for it (R2 = true) reads each neighbour at a compile-time
// column offset from one of 5 row bases.
__host__ __device__ constexpr int r2_dr(int o)
{
    const int dr[12] = {-2, -1, -1, -1, 0, 0, 0, 0, 1, 1, 1, 2};
    return dr[o];
}
__host__ __device__ constexpr int r2_dc(int o)
{
    const int dc[12] = {0, -1, 0, 1, -2, -1, 1, 2, -1, 0, 1, 0};
    return dc[o];
}

// Thread (i, c) = (tid / lw, tid % lw) holds column c of each level's r
// rows.  Iteration t: wait for the copies of iteration t - 1 (the loaded v
// of rows [t r, t r + r), the weights of rows [t r - r, t r)); issue the
// loaded v of rows [(t + 1) r, (t + 2) r) and the weights of rows
// [t r, t r + r) into the rings' free slots, w and in_deg of those rows
// into registers; then level l = 1..n_steps computes row t r - l r + i
// from level l - 1's v rows (the loaded v for level 1) and writes its v
// row into its own ring, a barrier between levels (KB - 1 of them in
// every iteration, whichever levels have rows: barriers under a branch
// raced on the card, though the branches were uniform).  A row's w, lft,
// wsum and max(in_deg, 1) pass from level to level in registers: the thread
// that computes row u at level l computes it at level l + 1 one iteration
// later.  Level l computes the cells within (KB - l) * pad of the interior
// (rows [l pad, nl - l pad), columns [l pad, lw - l pad)); their
// neighbours, within (KB - l + 1) * pad, are level l - 1's, so the
// interior is exact after n_steps levels, and its cells write their
// pre-reset v on each level and v, w, lft and spikes on the last.  Cells
// off the grid read 0 (the loaded ring's zeros, and each level writes 0
// for its off-grid cells): w_o * 0 adds what the twin's zero padding adds.
// R2: the radius-2 disc, its offsets, count and ring strides at compile
// time.
template <int KB, bool R2>
__global__ void __launch_bounds__(IZH_STREAM_THREADS, 1)
izh_tiled_kernel_rows(const __grid_constant__ StreamP P)
{
    // the rings, as float offsets into izh_ring: the weights at 0 (slot s,
    // column c at (s lw + c) stride), the loaded v after them (2 d0 rows),
    // then levels 1..KB-1's v (2 dv rows each)
    extern __shared__ __align__(16) float izh_ring[];
    const int R = P.r, pad = R2 ? 2 : P.pad, H = P.halo, LW = P.lw;
    const int DW = P.dw, D0 = P.d0, DV = P.dv;
    const int n_off = R2 ? 12 : P.n_off;
    const int stride = R2 ? 12 : P.stride;
    const int i = (int)threadIdx.x / LW;
    const int c = (int)threadIdx.x - i * LW;
    const int x0 = (int)blockIdx.x * P.tw;
    const int y0 = (int)blockIdx.y * P.seg;
    const int twb = min(P.tw, P.cols - x0);
    const int segb = min(P.seg, P.rows - y0);
    const int lwb = twb + 2 * H;
    const int nl = segb + 2 * H;
    const int gc = x0 - H + c;
    const int grow0 = y0 - H;           // the global row of local row 0
    const bool lane = i < R && c < lwb;
    const bool col_on = lane && gc >= 0 && gc < P.cols;
    const bool col_in = c >= H && c < H + twb;
    const bool col_1 = c >= pad && c < lwb - pad;
    const int n = P.n_steps;
    const size_t plane = (size_t)P.rows * P.cols;
    const float dt_cm = P.dt / P.c_m;
    const float dt_tau = P.dt / P.tau_m;
    const int v0c = DW * LW * stride + c;     // column c of the loaded ring
    const int lvc = v0c + 2 * D0 * LW;        // column c of level 1's ring
    const int ring = 2 * DV * LW;             // floats of a level's ring
    unsigned cols = 0;                        // bit l: c is a level-l column
#pragma unroll
    for (int l = 1; l <= KB; ++l)
        if (lane && c >= l * pad && c < lwb - l * pad) cols |= 1u << l;

    // the slots of row t r + i in each ring, advanced r rows an iteration,
    // and level l's distance behind them: its row (t - l) r + i in its own
    // ring, its window's top in level l - 1's
    int xw = i % DW, x0s = i % D0, xv = i % DV;
    int kv[KB], kr[KB];
#pragma unroll
    for (int l = 1; l <= KB; ++l) {
        kv[l - 1] = (l * R) % DV;
        kr[l - 1] = (l * R + pad) % (l == 1 ? D0 : DV);
    }
    // the loaded v of row u (< nl) into both of its slots
    auto load_v = [&](int u, int slot) {
        const int g = grow0 + u;
        float* dst = izh_ring + v0c + slot * LW;
        if (col_on && (unsigned)g < (unsigned)P.rows) {
            const float* src = P.v_in + (size_t)g * P.cols + gc;
            __pipeline_memcpy_async(dst, src, sizeof(float));
            __pipeline_memcpy_async(dst + D0 * LW, src, sizeof(float));
        } else {
            dst[0] = 0.0f;
            dst[D0 * LW] = 0.0f;
        }
    };
    if (lane) load_v(i, x0s);
    __pipeline_commit();

    // a row's w, lft, wsum and max(in_deg, 1) after level l, which level
    // l + 1 takes one iteration later
    float sw[KB], ssum[KB], scnt[KB];
    int slft[KB];
#pragma unroll
    for (int l = 0; l < KB; ++l) {
        sw[l] = 0.0f;
        ssum[l] = 0.0f;
        scnt[l] = 1.0f;
        slft[l] = 0;
    }
    float pw = 0.0f, pcnt = 1.0f;   // level 1's next row, from registers
    int plft = 0;
    const int iters = (nl - n * pad - 1) / R + n + 1;
    for (int t = 0, tr = 0; t < iters; ++t, tr += R) {
        __pipeline_wait_prior(0);
        __syncthreads();
        // level 1's row t r - r + i: its w, lft and count came last iteration
        float cw = pw, ccnt = pcnt, csum = 0.0f;
        int clft = plft;
        if (lane && tr + R + i < nl)
            load_v(tr + R + i, x0s + R >= D0 ? x0s + R - D0 : x0s + R);
        {
            const int u = tr + i;
            const int g = grow0 + u;
            if (col_on && col_1 && u >= pad && u < nl - pad
                && (unsigned)g < (unsigned)P.rows) {
                const size_t gi = (size_t)g * P.cols + gc;
                float* dst = izh_ring + (xw * LW + c) * stride;
                const float* src = P.weights + gi;
#pragma unroll 4
                for (int o = 0; o < n_off; ++o)
                    __pipeline_memcpy_async(dst + o, src + o * plane,
                                            sizeof(float));
                pw = P.w_in[gi];
                pcnt = fmaxf(P.in_deg[gi], 1.0f);
                plft = (col_in && u >= H && u < H + segb) ? P.lft_in[gi] : 0;
            }
        }
        __pipeline_commit();
        // the radius-2 instantiation reads each level's weights before the
        // barrier that precedes it
        float4 qn[3];
        if constexpr (R2) {
            const float4* w1p = (const float4*)(izh_ring
                + (ring_sub(xw, R, DW) * LW + c) * 12);
            qn[0] = w1p[0];
            qn[1] = w1p[1];
            qn[2] = w1p[2];
        }
#pragma unroll
        for (int l = 1; l <= KB; ++l) {
            float4 qc[3];
            if constexpr (R2) {
                qc[0] = qn[0];
                qc[1] = qn[1];
                qc[2] = qn[2];
                if (l < KB) {
                    const float4* np = (const float4*)(izh_ring
                        + (ring_sub(xw, (l + 1) * R, DW) * LW + c) * 12);
                    qn[0] = np[0];
                    qn[1] = np[1];
                    qn[2] = np[2];
                }
            }
            // what level l + 1 takes: level l's row of the last iteration
            const float nw = sw[l - 1], nsum = ssum[l - 1], ncnt = scnt[l - 1];
            const int nlft = slft[l - 1];
            const int u = tr - l * R + i;
            if (l <= n && ((cols >> l) & 1) && u >= l * pad
                && u < nl - l * pad) {
                const int g = grow0 + u;
                // this level's row in its own ring
                const int sv = lvc + (l - 1) * ring
                    + ring_sub(xv, kv[l - 1], DV) * LW;
                if (col_on && (unsigned)g < (unsigned)P.rows) {
                    // the window's centre: row u, column c of level l - 1
                    const float* win = izh_ring + ((l == 1)
                        ? v0c + (ring_sub(x0s, kr[0], D0) + pad) * LW
                        : lvc + (l - 2) * ring
                          + (ring_sub(xv, kr[l - 1], DV) + pad) * LW);
                    const float* wr = izh_ring
                        + (ring_sub(xw, l * R, DW) * LW + c) * stride;
                    // in offset order, 4 weights a 16-byte read
                    float acc = 0.0f, ws = 0.0f;
                    auto four = [&](int o4) {
                        const float4 q = R2 ? qc[o4 / 4]
                                            : *(const float4*)(wr + o4);
                        const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            if (o4 + k >= n_off) break;
                            const float nb = R2
                                ? win[r2_dr(o4 + k) * LW + r2_dc(o4 + k)]
                                : win[P.lin[o4 + k]];
                            acc = acc + qv[k] * nb;
                            if (l == 1) ws = ws + qv[k];
                        }
                    };
                    if constexpr (R2) {
#pragma unroll
                        for (int o4 = 0; o4 < 12; o4 += 4) four(o4);
                    } else {
#pragma unroll 1
                        for (int o4 = 0; o4 < n_off; o4 += 4) four(o4);
                    }
                    const float vv = win[0];
                    const float ww = cw;
                    const float wsum = (l == 1) ? ws : csum;
                    const float i_syn = P.gap * (acc - vv * wsum) / ccnt;
                    const float dv = (0.04f * vv * vv + 5.0f * vv + 140.0f
                                      - ww + i_syn) * dt_cm;
                    const float dw = (P.a * (P.b * vv - ww)) * dt_tau;
                    const float v_pre = vv + dv;
                    const float w_pre = ww + dw;
                    const bool spike = v_pre >= P.v_th;
                    const float v1 = spike ? P.c : v_pre;
                    const float w1 = spike ? w_pre + P.d : w_pre;
                    const int lf = spike ? P.clock0 + l - 1 : clft;
                    sw[l - 1] = w1;
                    ssum[l - 1] = wsum;
                    scnt[l - 1] = ccnt;
                    slft[l - 1] = lf;
                    if (l < n) {
                        izh_ring[sv] = v1;
                        izh_ring[sv + DV * LW] = v1;
                    }
                    if (col_in && u >= H && u < H + segb) {
                        const size_t gi = (size_t)g * P.cols + gc;
                        if (P.v_pre) P.v_pre[(size_t)(l - 1) * plane + gi]
                            = v_pre;
                        if (l == n) {
                            P.v_out[gi] = v1;
                            P.w_out[gi] = w1;
                            P.lft_out[gi] = lf;
                            if (P.spk_out) P.spk_out[gi] = spike ? 1 : 0;
                        }
                    }
                } else if (l < n) {
                    // level l + 1 reads 0 for a cell off the grid
                    izh_ring[sv] = 0.0f;
                    izh_ring[sv + DV * LW] = 0.0f;
                }
            }
            // every thread passes every barrier, outside any branch: level
            // l + 1 reads what level l wrote
            if (l < KB) __syncthreads();
            cw = nw;
            csum = nsum;
            ccnt = ncnt;
            clft = nlft;
        }
        xw = xw + R >= DW ? xw + R - DW : xw + R;
        x0s = x0s + R >= D0 ? x0s + R - D0 : x0s + R;
        xv = xv + R >= DV ? xv + R - DV : xv + R;
    }
    __pipeline_wait_prior(0);
}

template <int KB, bool R2>
static cudaError_t launch_rows(const StreamP& P, dim3 grid, int threads,
                               size_t smem, cudaStream_t s)
{
    cudaError_t err = cudaFuncSetAttribute(
        izh_tiled_kernel_rows<KB, R2>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    izh_tiled_kernel_rows<KB, R2><<<grid, threads, smem, s>>>(P);
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

// IZH_MAX_OFFSETS, IZH_TILE_THREADS, IZH_TILE_MAX_CPT and
// IZH_STREAM_THREADS, in order.
void izh_stencil_limits(int* out)
{
    out[0] = IZH_MAX_OFFSETS;
    out[1] = IZH_TILE_THREADS;
    out[2] = IZH_TILE_MAX_CPT;
    out[3] = IZH_STREAM_THREADS;
}

// The radius-2 disc that izh_stencil_tiled gives its own instantiation:
// offset o at (dr[o], dc[o]), 12 of them.
void izh_stencil_r2(int* dr, int* dc)
{
    for (int o = 0; o < 12; ++o) {
        dr[o] = r2_dr(o);
        dc[o] = r2_dc(o);
    }
}

// Runs n_steps steps as izh_stencil_steps does, in the tiled design's
// streamed plan (ops/stencil_kernels.stream_plan): one launch per kb steps
// (the last takes what is left), launch j writing buffer set j % 2, so the
// result is in set (launches - 1) % 2.  Strips of tw interior columns by
// segments of seg interior rows, each block streaming its strip with a
// halo of kb * pad cells (pad: the stencil's largest |dr| or |dc|) r rows
// an iteration (r >= pad), on `threads` >= r * (tw + 2 kb pad) threads.
// `scalars` holds the 9 parameters (uniform planes) in the order of
// izh_stencil_steps' planes.  kb is 2, 4 or 8.  *launched (when not null)
// gains one for each kernel launched.  Returns the first CUDA error, 0 if
// none.
int izh_stencil_tiled(
    const float* v, const float* w, const int* lft,
    const float* weights, const float* in_deg, const float* scalars,
    float* v_buf0, float* w_buf0, int* lft_buf0,
    float* v_buf1, float* w_buf1, int* lft_buf1,
    unsigned char* spikes, float* v_pre,
    const int* dr, const int* dc, int n_off,
    int rows, int cols, int clock0, int n_steps,
    int tw, int seg, int kb, int r, int threads, int* launched,
    void* stream)
{
    if (n_off < 0 || n_off > IZH_MAX_OFFSETS || rows <= 0 || cols <= 0
        || n_steps <= 0 || tw <= 0 || seg <= 0 || r <= 0
        || (kb != 2 && kb != 4 && kb != 8) || threads > IZH_STREAM_THREADS
        || threads % 32 != 0)
        return (int)cudaErrorInvalidValue;
    StreamP P = {};
    int pad = 0;
    for (int o = 0; o < n_off; ++o) {
        const int ar = dr[o] < 0 ? -dr[o] : dr[o];
        const int ac = dc[o] < 0 ? -dc[o] : dc[o];
        pad = ar > pad ? ar : pad;
        pad = ac > pad ? ac : pad;
    }
    if (r < pad) return (int)cudaErrorInvalidValue;
    P.n_off = n_off;
    // n_off to a multiple of 4 whose quarter is odd: a warp's 16-byte reads
    // of neighbouring cells then hit every bank once
    P.stride = weight_stride(n_off);
    P.pad = pad;
    P.r = r;
    P.tw = tw;
    P.seg = seg;
    P.halo = kb * pad;
    P.lw = tw + 2 * P.halo;
    if ((long long)r * P.lw > threads) return (int)cudaErrorInvalidValue;
    P.dw = (kb + 1) * r;
    P.d0 = 3 * r + pad;
    P.dv = 2 * r + pad;
    for (int o = 0; o < n_off; ++o) P.lin[o] = dr[o] * P.lw + dc[o];
    // the radius-2 disc in its order takes its own instantiation
    bool r2 = n_off == 12;
    for (int o = 0; r2 && o < 12; ++o)
        r2 = dr[o] == r2_dr(o) && dc[o] == r2_dc(o);
    const size_t smem = (size_t)4 * P.lw * ((size_t)P.dw * P.stride
        + 2 * P.d0 + (size_t)(kb - 1) * 2 * P.dv);
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
    const dim3 grid((cols + tw - 1) / tw, (rows + seg - 1) / seg);
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
        if (kb == 8 && r2)
            err = launch_rows<8, true>(P, grid, threads, smem, s);
        else if (kb == 8)
            err = launch_rows<8, false>(P, grid, threads, smem, s);
        else if (kb == 4)
            err = launch_rows<4, false>(P, grid, threads, smem, s);
        else
            err = launch_rows<2, false>(P, grid, threads, smem, s);
        if (err != cudaSuccess) return (int)err;
        if (launched) ++*launched;
        P.v_in = P.v_out;
        P.w_in = P.w_out;
        P.lft_in = P.lft_out;
    }
    return 0;
}

// Runs n_steps steps as izh_stencil_tiled does, in the tiled design's 2-D
// tiles (ops/stencil_kernels.tile_plan: a reach of 1): interior tiles of
// th x tw cells, each loaded with a halo of kb * pad cells by a block of
// `threads` threads, cpt loaded cells a thread.  *launched (when not null)
// gains one for each kernel launched.  Returns the first CUDA error, 0 if
// none.
int izh_stencil_tiled2d(
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
