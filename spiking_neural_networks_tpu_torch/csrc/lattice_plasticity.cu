// K steps of one stencil lattice with STDP or R-STDP plasticity.
//
// Replaces the single-lattice form of the TPU kernel
// spiking_neural_networks_tpu/ops/pallas_reward.py:_fused_chunk (body
// _make_kernel): one lattice of Izhikevich, adaptive leaky (ALIF) or leaky
// (LIF) integrate-and-fire neurons on a stencil graph, of kind
//   plain   (no plasticity; dopamine still takes the rewards),
//   plastic (STDP on every masked slot),
//   mod     (the R-STDP double visit of weights and eligibility traces).
// Per step k, in the TPU kernel's order and association:
//   1. phase A from the current weights, offsets summed from 0 in order:
//        acc = sum_o w_o * v[r+dr_o, c+dc_o], wsum = sum_o w_o,
//        i = gap * (acc - v * wsum) / max(in_deg, 1);
//   2. dopamine (rewards only): dop = dop * exp_dd + tau_d * reward_k;
//   3. phase B: the model step; lft = clock0 + k on a spike;
//   4. plastic: w_o += delta(lft_pre, lft_post) * (spk_pre + spk_post);
//      mod: two visits of (w_o, c_o, dw_o, counter_o) with that delta,
//   from the post-step lft and spikes of both endpoints, on masked slots.
// Off-grid neighbours are skipped by a bounds check (lft NEVER, spike 0).
// Build with -fmad=false and without fast math; the STDP delta's exp is
// kernel_exp (plasticity_common.cuh), built from correctly rounded float
// operations: the kernels then round as their plain PyTorch twin
// (ops/reward_kernels.lattice_plasticity_steps_reference) on any device.
//
// Schedule (the main path).  Step 4 reads the neighbours' post-step lft
// and spikes, and phase A of step k+1 the neighbours' new v, so every
// step needs a grid-wide ordering point: a launch boundary.  A call of K
// steps is K + 1 launches of lp_step_kernel (K for kind plain):
//   launch 0      step 0's phases A and B;
//   launch k      step k-1's edge pass (step 4) on the thread's own slots,
//                 then step k's phase A from the weights that pass left,
//                 still in registers, and phase B;
//   launch K      step K-1's edge pass alone (the edge kernel, below).
// Weights and traces are stored per destination (o, r, c), so a thread
// reads and writes only its own slots and no two threads touch one slot.
// Launch k reads step k-1's state (v, w, lft, refr in buffer set
// (k-1) % 2, spike flags in parity plane (k-1) % 2) and writes step k's
// into set k % 2 and plane k % 2, while other blocks still read k-1's.
// The dopamine kernel is gone from this path: each thread folds the
// rewards of its step into the dopamine (at most 16, passed by value, from
// *dop_in or the dopamine written at the end of the previous 16), in
// lp_dopamine_kernel's float order, and block 0 writes it to dop_steps.
// The per-step design (cell kernel, then the edge kernel, each step, and
// the dopamine kernel per call) stays reachable with per_step = 1: STDP on
// ALIF at 512 x 512 took less device time so on an H100 (the runner's
// route, ops/reward_kernels.per_step_route), and the two designs are timed
// against each other.  Every launch is counted (lp_counted).
//
// The edge pass.  A block of 32 x 8 threads owns a tile of 8 rows x 32
// columns, one cell a thread.  The block stages its tile plus a halo of
// the stencil's radius (lft and spike flags for the edge pass, v for phase
// A) in shared memory, off-grid cells as lft NEVER, spike 0 and v 0 (and
// skipped by the bounds check, as before); a halo wider than LP_HALO_MAX
// reads global memory instead.  Four consecutive columns a thread with
// 16-byte loads, and two with 8-byte loads, ran slower on an H100 in trial
// builds at nearly every size from 64 x 64 to 512 x 512 (PERF.md): they
// took 71-84 and 47-72 registers against 40-48, so 3 blocks an SM instead
// of 5 and fewer loads in flight, and below 512 x 512 they launch fewer
// blocks than the card has SMs.  A value
// is stored only where its bits changed, which is exact by construction:
// an unchanged value's store would write the bits already there.  It
// keeps the sign rule of w + delta * 0 on a -0.0 weight (+0.0: the bits
// change, so it is stored).  For R-STDP two visits per step toggle the
// counter twice, so counters of 0 and 1 end the step as they began and
// are not stored (a counter of 2 becomes 1 and is), and after a step that
// began with counter 0, dw is +0.0 and stored only if it was not.
//
// What bounds it on an H100: the latency of each thread's chain of loads.
// Per cell and step phase A/B read up to 13 parameter planes, in_deg, v,
// w, lft and refr and write them back; the R-STDP pass reads the mask, w,
// c, dw and counter of every offset and writes w, c and (where changed)
// dw, the weights read once for both the pass and phase A.  With radius 2
// (12 offsets) that is about 350 bytes per cell per step for R-STDP (93 MB
// per step at 512 x 512, beyond the 50 MB L2) and 130 for STDP (34 MB),
// moved at 1.7 and 1.25 TB/s of the card's 3.35 (PERF.md); below
// 256 x 256 the launches' latency.
//
// The closed loop (lattice_plasticity_env_step; replaces the env form of
// the TPU kernel, _make_kernel(spec, n, env) driven by _env_advance) runs
// one step per launch between the environment's callbacks, which stay
// PyTorch operations on the device and may write the state planes.  The
// reward, the dopamine and the clock are device memory, not arguments, so
// that a CUDA graph of K such launches reads the values of each replay.
// Launch k is lp_step_kernel as above: step k-1's edge pass, deferred
// across the callbacks, then step k's phases A and B; block 0 folds step
// k's reward into the dopamine, in lp_dopamine_kernel's float order, and
// advances the clock.  The deferred pass must not see what the callbacks
// wrote, so step k also writes its firing times and spike flags into
// kernel-private planes of parity k % 2, which launch k + 1 reads, and the
// dopamine and the clock live in two slots each: launch k reads one, and
// block 0 writes the other, which no block of the launch reads.  A flush
// (step K-1's edge pass alone, and the scalars back into slot 0) settles
// the weights, traces and scalars after K steps: K + 1 launches with
// plasticity, K without (ops/reward_kernels.EnvChain keeps the parity).

#include "plasticity_common.cuh"

#define LP_REWARD_CHUNK 16
#define LP_TILE_ROWS 8       // block of 32 x LP_TILE_ROWS threads, a cell each
#define LP_HALO_MAX 8        // wider halos read global memory

struct Rewards {
    float r[LP_REWARD_CHUNK];
};

// One launch of lp_step_kernel.
struct LpStep {
    // step k-1's state (the call's input for step 0); spk its spike flags
    const float* v;
    const float* w;
    const int* lft;
    const float* refr;
    const unsigned char* spk;
    // step k-1's post-step firing times for its edge pass (lft, but for the
    // closed loop's kept plane)
    const int* lft_edge;
    // step k's state
    float* v_out;
    float* w_out;
    int* lft_out;
    float* refr_out;
    unsigned char* spk_out;
    float* v_pre;             // null unless emitting
    // the closed loop: step k's firing times and spike flags kept for its
    // deferred edge pass (else null)
    int* lft_keep;
    unsigned char* spk_keep;
    float* weights;
    const unsigned char* mask;
    float* tr_c;
    float* tr_dw;
    int* tr_counter;
    const float* in_deg;
    // the dopamine: *dop_base with n_rew rewards folded in; block 0 writes
    // it to dop_write (when not null)
    const float* dop_base;
    float* dop_write;
    // the closed loop (clock_ptr not null): the clock read from *clock_ptr,
    // block 0 writes the next to clock_write and step k's dopamine, from
    // *dop_base and *reward (when not null), to dop_write
    const float* reward;
    const int* clock_ptr;
    int* clock_write;
    Rewards rw;
    int n_rew;
    float exp_dd, tau_d;
    Params P;
    Stencil st;
    Rule r;
    int rows, cols, clock, halo, tiled;
};

template <int MODEL>
__global__ void lp_cell_kernel(
    const float* __restrict__ v_in, const float* __restrict__ w_in,
    const int* __restrict__ lft_in, const float* __restrict__ refr_in,
    float* __restrict__ v_out, float* __restrict__ w_out,
    int* __restrict__ lft_out, float* __restrict__ refr_out,
    unsigned char* __restrict__ spk_out,
    float* __restrict__ v_pre_out,         // null unless emitting
    const float* __restrict__ weights, const float* __restrict__ in_deg,
    Params P, Stencil st, int rows, int cols, int clock)
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
        const int sr = row + st.dr[o];
        const int sc = col + st.dc[o];
        if (sr >= 0 && sr < rows && sc >= 0 && sc < cols)
            acc = acc + wo * v_in[(size_t)sr * cols + sc];
        wsum = wsum + wo;
    }
    const float cnt = fmaxf(in_deg[i], 1.0f);
    const float i_syn = P.p[gap_param<MODEL>()][i] * (acc - v * wsum) / cnt;
    const bool refractory = MODEL != MODEL_IZHIKEVICH;
    float v_pre, v_new, w_new, refr_new;
    bool spike;
    model_step<MODEL>(P.p, i, v, w, refractory ? refr_in[i] : 0.0f, i_syn,
                      v_pre, v_new, w_new, refr_new, spike);
    v_out[i] = v_new;
    w_out[i] = w_new;
    if (refractory) refr_out[i] = refr_new;
    lft_out[i] = spike ? clock : lft_in[i];
    spk_out[i] = spike ? 1 : 0;
    if (v_pre_out) v_pre_out[i] = v_pre;
}

// Stores x at p[i] where its bits differ from old's (a store of the
// same bits would change nothing).
template <typename T>
__device__ __forceinline__ void store_changed(T* p, size_t i, T x, T old)
{
    int a, b;
    memcpy(&a, &x, 4);
    memcpy(&b, &old, 4);
    if (a != b) p[i] = x;
}

// Step k-1's edge pass (EDGE, kind KIND) and step k's phases A and B
// (CELL) of one tile of LP_TILE_ROWS x 32 cells, one thread a cell; see
// the head of the file.  Edge-only (CELL false) is the edge kernel of the
// per-step design, the networks' per-step path and the closed loop's
// flush; neither, the closed loop's scalars alone.
template <int MODEL, int KIND, bool EDGE, bool CELL>
__global__ void __launch_bounds__(32 * LP_TILE_ROWS)
lp_step_kernel(const LpStep a)
{
    extern __shared__ __align__(16) unsigned char lp_smem[];
    const int rows = a.rows, cols = a.cols, halo = a.halo;
    const int tw = 32 + 2 * halo;
    const int tn = tw * (LP_TILE_ROWS + 2 * halo);
    int* s_lft = reinterpret_cast<int*>(lp_smem);
    float* s_v = reinterpret_cast<float*>(s_lft + (EDGE ? tn : 0));
    unsigned char* s_spk =
        reinterpret_cast<unsigned char*>(s_v + (CELL ? tn : 0));
    const int row0 = blockIdx.y * LP_TILE_ROWS;
    const int col0 = blockIdx.x * 32;
    const bool edge = EDGE && KIND != KIND_PLAIN;

    // the dopamine of the edge pass's step (and, for block 0, of the step
    // whose dopamine this launch writes)
    const bool lead = blockIdx.x == 0 && blockIdx.y == 0
        && threadIdx.x == 0 && threadIdx.y == 0;
    float dop = 0.0f;
    if (a.clock_ptr) {
        // the closed loop: the slots this launch reads are not the ones
        // block 0 writes
        if (a.dop_base) dop = *a.dop_base;
        if (lead && a.dop_write)
            *a.dop_write = a.reward ? dop * a.exp_dd + a.tau_d * *a.reward
                                    : dop;
        if (lead && a.clock_write)
            *a.clock_write = *a.clock_ptr + (CELL ? 1 : 0);
    } else if ((edge && KIND == KIND_MOD) || a.dop_write) {
        float d = *a.dop_base;
        for (int j = 0; j < a.n_rew; ++j)
            d = d * a.exp_dd + a.tau_d * a.rw.r[j];
        dop = d;
        if (a.dop_write && lead) *a.dop_write = d;
    }
    if (a.tiled) {
        for (int q = threadIdx.y * 32 + threadIdx.x; q < tn;
             q += 32 * LP_TILE_ROWS) {
            const int sr = row0 - halo + q / tw;
            const int sc = col0 - halo + q % tw;
            const bool on = sr >= 0 && sr < rows && sc >= 0 && sc < cols;
            const size_t j = (size_t)sr * cols + sc;
            if (EDGE) {
                s_lft[q] = on ? a.lft_edge[j] : LP_NEVER;
                s_spk[q] = on ? a.spk[j] : 0;
            }
            if (CELL) s_v[q] = on ? a.v[j] : 0.0f;
        }
        __syncthreads();
    }
    const int row = row0 + threadIdx.y;
    const int col = col0 + threadIdx.x;
    if (row >= rows || col >= cols) return;
    const size_t n = (size_t)rows * cols;
    const size_t i = (size_t)row * cols + col;
    // a cell of the tile and halo, in shared memory
    auto tile = [&](int sr, int sc) {
        return (sr - row0 + halo) * tw + (sc - col0 + halo);
    };

    const int t_post = !edge ? LP_NEVER
        : a.tiled ? s_lft[tile(row, col)] : a.lft_edge[i];
    const float s_post = edge && (a.tiled ? s_spk[tile(row, col)]
                                          : a.spk[i]) ? 1.0f : 0.0f;
    float acc = 0.0f;
    float wsum = 0.0f;
    // a slot's loads, issued together before its mask is known.  For
    // R-STDP slot o + 1's are issued before slot o's stores (other
    // addresses), so that a slot does not wait behind the stores of the
    // one before it: faster on an H100 for R-STDP at 512 x 512 and 64 x 64
    // and for the closed loop at 10 x 10, slower for STDP (PERF.md)
    constexpr bool ahead = EDGE && KIND == KIND_MOD;
    float w_n = 0.0f, c_n = 0.0f, dw_n = 0.0f;
    int ct_n = 0;
    bool m_n = false;
    auto fetch = [&](int o) {
        const size_t e = (size_t)o * n + i;
        w_n = a.weights[e];
        m_n = edge && a.mask[e];
        if (edge && KIND == KIND_MOD) {
            c_n = a.tr_c[e];
            dw_n = a.tr_dw[e];
            ct_n = a.tr_counter[e];
        }
    };
    if (ahead && a.st.n > 0) fetch(0);
    for (int o = 0; o < a.st.n; ++o) {
        const int sr = row + a.st.dr[o];
        const int sc = col + a.st.dc[o];
        const bool on = sr >= 0 && sr < rows && sc >= 0 && sc < cols;
        const size_t e = (size_t)o * n + i;
        if (!ahead) fetch(o);
        float w = w_n;
        const bool masked = m_n;
        float c = c_n, dw = dw_n;
        int ct = ct_n;
        if (ahead && o + 1 < a.st.n) fetch(o + 1);
        if (masked) {
            int t_pre = LP_NEVER;
            float s_pre = 0.0f;
            if (on) {
                if (a.tiled) {
                    t_pre = s_lft[tile(sr, sc)];
                    s_pre = s_spk[tile(sr, sc)] ? 1.0f : 0.0f;
                } else {
                    const size_t j = (size_t)sr * cols + sc;
                    t_pre = a.lft_edge[j];
                    s_pre = a.spk[j] ? 1.0f : 0.0f;
                }
            }
            const float delta = stdp_delta(t_pre, t_post, a.r);
            const float w0 = w;
            if (KIND == KIND_PLASTIC) {
                w = w + delta * (s_pre + s_post);
            } else {
                const float c0 = c, dw0 = dw;
                const int ct0 = ct;
                rstdp_visit(w, c, dw, ct, delta, dop, a.r);
                rstdp_visit(w, c, dw, ct, delta, dop, a.r);
                store_changed(a.tr_c, e, c, c0);
                store_changed(a.tr_dw, e, dw, dw0);
                store_changed(a.tr_counter, e, ct, ct0);
            }
            store_changed(a.weights, e, w, w0);
        }
        if (CELL) {
            if (on)
                acc = acc + w * (a.tiled ? s_v[tile(sr, sc)]
                                         : a.v[(size_t)sr * cols + sc]);
            wsum = wsum + w;
        }
    }
    if (!CELL) return;
    const bool refractory = MODEL != MODEL_IZHIKEVICH;
    const float v = a.tiled ? s_v[tile(row, col)] : a.v[i];
    const float cnt = fmaxf(a.in_deg[i], 1.0f);
    const float i_syn =
        a.P.p[gap_param<MODEL>()][i] * (acc - v * wsum) / cnt;
    float v_pre, v_new, w_new, refr_new;
    bool spike;
    model_step<MODEL>(a.P.p, i, v, a.w[i], refractory ? a.refr[i] : 0.0f,
                      i_syn, v_pre, v_new, w_new, refr_new, spike);
    a.v_out[i] = v_new;
    a.w_out[i] = w_new;
    if (refractory) a.refr_out[i] = refr_new;
    const int clock = a.clock_ptr ? *a.clock_ptr : a.clock;
    const int lft = spike ? clock : a.lft[i];
    a.lft_out[i] = lft;
    a.spk_out[i] = spike ? 1 : 0;
    if (a.lft_keep) {
        a.lft_keep[i] = lft;
        a.spk_keep[i] = spike ? 1 : 0;
    }
    if (a.v_pre) a.v_pre[i] = v_pre;
}

// dop_out[j] = dopamine after reward j of this chunk, from *dop_in.
__global__ void lp_dopamine_kernel(const float* dop_in, Rewards rw,
                                   int count, float exp_dd, float tau_d,
                                   float* dop_out)
{
    float d = *dop_in;
    for (int j = 0; j < count; ++j) {
        d = d * exp_dd + tau_d * rw.r[j];
        dop_out[j] = d;
    }
}

// The staged halo (the stencil's radius) and whether it fits shared
// memory, for a launch over `a`'s stencil.
static void lp_geometry(LpStep& a)
{
    int halo = 0;
    for (int o = 0; o < a.st.n; ++o) {
        const int dr = a.st.dr[o] < 0 ? -a.st.dr[o] : a.st.dr[o];
        const int dc = a.st.dc[o] < 0 ? -a.st.dc[o] : a.st.dc[o];
        halo = dr > halo ? dr : halo;
        halo = dc > halo ? dc : halo;
    }
    a.tiled = halo <= LP_HALO_MAX;
    a.halo = a.tiled ? halo : 0;
}

template <int MODEL, int KIND, bool EDGE, bool CELL>
static cudaError_t lp_launch_step(const LpStep& a, cudaStream_t s,
                                  int* launched)
{
    const dim3 block(32, LP_TILE_ROWS);
    const dim3 grid((a.cols + 31) / 32,
                    (a.rows + LP_TILE_ROWS - 1) / LP_TILE_ROWS);
    const size_t tn = a.tiled ? (size_t)(32 + 2 * a.halo)
        * (LP_TILE_ROWS + 2 * a.halo) : 0;
    const size_t smem = tn * ((EDGE ? 5 : 0) + (CELL ? 4 : 0));
    lp_step_kernel<MODEL, KIND, EDGE, CELL><<<grid, block, smem, s>>>(a);
    return lp_counted(launched);
}

// The edge pass alone on a's planes (lft, spk: the post-step state).
template <int KIND>
static cudaError_t lp_launch_edge(LpStep a, cudaStream_t s, int* launched)
{
    lp_geometry(a);
    return lp_launch_step<MODEL_IZHIKEVICH, KIND, true, false>(a, s,
                                                              launched);
}

static LpStep lp_edge_args(const int* lft, const unsigned char* spk,
                           float* weights, const unsigned char* mask,
                           const Rule& r, const Stencil& st, int rows,
                           int cols)
{
    LpStep a = {};
    a.lft = lft;
    a.lft_edge = lft;
    a.spk = spk;
    a.weights = weights;
    a.mask = mask;
    a.r = r;
    a.st = st;
    a.rows = rows;
    a.cols = cols;
    return a;
}

cudaError_t lp_launch_stdp_edge(const int* lft, const unsigned char* spk,
                                float* weights, const unsigned char* mask,
                                const Rule& r, const Stencil& st, int rows,
                                int cols, cudaStream_t s, int* launched)
{
    return lp_launch_edge<KIND_PLASTIC>(
        lp_edge_args(lft, spk, weights, mask, r, st, rows, cols), s,
        launched);
}

cudaError_t lp_launch_rstdp_edge(const int* lft, const unsigned char* spk,
                                 float* weights, const unsigned char* mask,
                                 float* tr_c, float* tr_dw, int* tr_counter,
                                 const float* dop, const Rule& r,
                                 const Stencil& st, int rows, int cols,
                                 cudaStream_t s, int* launched)
{
    LpStep a = lp_edge_args(lft, spk, weights, mask, r, st, rows, cols);
    a.tr_c = tr_c;
    a.tr_dw = tr_dw;
    a.tr_counter = tr_counter;
    a.dop_base = dop;
    return lp_launch_edge<KIND_MOD>(a, s, launched);
}

cudaError_t lp_launch_dopamine(const float* dop_in, const float* rewards,
                               int n_steps, float exp_dd, float tau_d,
                               float* dop_steps, cudaStream_t s,
                               int* launched)
{
    for (int j0 = 0; j0 < n_steps; j0 += LP_REWARD_CHUNK) {
        Rewards rw;
        const int count = n_steps - j0 < LP_REWARD_CHUNK
            ? n_steps - j0 : LP_REWARD_CHUNK;
        for (int j = 0; j < count; ++j) rw.r[j] = rewards[j0 + j];
        lp_dopamine_kernel<<<1, 1, 0, s>>>(
            j0 == 0 ? dop_in : dop_steps + j0 - 1, rw, count, exp_dd, tau_d,
            dop_steps + j0);
        const cudaError_t err = lp_counted(launched);
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

template <int MODEL>
static cudaError_t launch_cell(int* launched, dim3 grid, dim3 block,
                               cudaStream_t s, const float* v, const float* w,
                               const int* lft, const float* refr, float* vo,
                               float* wo, int* lfto, float* refro,
                               unsigned char* spk, float* v_pre,
                               const float* weights, const float* in_deg,
                               const Params& P, const Stencil& st, int rows,
                               int cols, int clock)
{
    lp_cell_kernel<MODEL><<<grid, block, 0, s>>>(
        v, w, lft, refr, vo, wo, lfto, refro, spk, v_pre, weights, in_deg,
        P, st, rows, cols, clock);
    return lp_counted(launched);
}

// One launch of the fused schedule for MODEL: edge-only, cell-only, both
// or (the closed loop's scalars) neither (see the head of the file).
template <int MODEL>
static cudaError_t lp_launch_fused(int kind, bool edge, bool cell,
                                   const LpStep& a, cudaStream_t s,
                                   int* launched)
{
    if (!edge && !cell)
        return lp_launch_step<MODEL_IZHIKEVICH, KIND_PLAIN, false, false>(
            a, s, launched);
    if (!edge)
        return lp_launch_step<MODEL, KIND_PLAIN, false, true>(a, s, launched);
    if (!cell)
        return kind == KIND_PLASTIC
            ? lp_launch_step<MODEL_IZHIKEVICH, KIND_PLASTIC, true, false>(
                a, s, launched)
            : lp_launch_step<MODEL_IZHIKEVICH, KIND_MOD, true, false>(
                a, s, launched);
    return kind == KIND_PLASTIC
        ? lp_launch_step<MODEL, KIND_PLASTIC, true, true>(a, s, launched)
        : lp_launch_step<MODEL, KIND_MOD, true, true>(a, s, launched);
}

// The host structs of one call from its C arguments; false if the
// arguments are out of range.
static bool lp_setup(int model, int kind, int n_params, int n_off,
                     int rows, int cols, const float* const* params,
                     const int* dr, const int* dc, const float* rule,
                     Stencil& st, Params& P, Rule& r)
{
    static const int n_params_of[3] = {9, 13, 10};
    if (model < 0 || model > 2 || kind < 0 || kind > 2
        || n_params != n_params_of[model]
        || n_off < 0 || n_off > LP_MAX_OFFSETS || rows <= 0 || cols <= 0)
        return false;
    st.n = n_off;
    for (int o = 0; o < n_off; ++o) {
        st.dr[o] = dr[o];
        st.dc[o] = dc[o];
    }
    for (int q = 0; q < LP_MAX_PARAMS; ++q)
        P.p[q] = q < n_params ? params[q] : nullptr;
    r = {rule[0], rule[1], rule[2], rule[3], rule[4], rule[5], rule[6]};
    return true;
}

extern "C" {

int lp_max_offsets() { return LP_MAX_OFFSETS; }

// Runs n_steps steps from state_in = {v, w, lft, refr} on `stream`.  Step
// k writes buffer set k % 2 (state_buf[4 * (k % 2) + f] for f = v, w,
// lft, refr), so the result is in set (n_steps - 1) % 2; the inputs are
// only read.  refr and its buffers are null for Izhikevich.  `spikes`
// (2 * rows * cols bytes) receives step k's spike flags in plane k % 2,
// `v_pre`, when not null, the pre-reset voltage of step k at
// k * rows * cols.  `params` holds n_params planes in MODEL_PARAM_KEYS
// order.  `weights`, and for kind mod `tr_c`, `tr_dw`, `tr_counter`, are
// updated in place.  `rule` = {a_plus, a_minus, tau_plus, tau_minus, dt,
// tau_c, exp_dc, tau_d, exp_dd}; `rewards` (host, n_steps floats) feed the
// dopamine, which starts from *dop_in and is written per step to
// dop_steps (with rewards only; without, kind mod reads *dop_in every
// step).  per_step = 0 takes the fused schedule (n_steps + 1 launches, or
// n_steps for kind plain), 1 the per-step design (a cell and an edge
// launch per step, and the dopamine kernel).  *launched (when not null)
// gains one for each kernel launched.  Returns the first CUDA error, 0 if
// none.
int lattice_plasticity_steps(
    int model, int kind, int with_reward,
    const void* const* state_in, void* const* state_buf,
    unsigned char* spikes, float* v_pre,
    const float* in_deg, const float* const* params, int n_params,
    float* weights, const unsigned char* mask,
    float* tr_c, float* tr_dw, int* tr_counter,
    const float* dop_in, float* dop_steps,
    const float* rule, const float* rewards,
    const int* dr, const int* dc, int n_off,
    int rows, int cols, int clock0, int n_steps, int per_step, int* launched,
    void* stream)
{
    Stencil st;
    Params P;
    Rule r;
    if (!lp_setup(model, kind, n_params, n_off, rows, cols, params, dr, dc,
                  rule, st, P, r)
        || n_steps <= 0 || (kind != KIND_PLAIN && !mask)
        || (kind == KIND_MOD && (!tr_c || !tr_dw || !tr_counter || !dop_in))
        || (with_reward && (!dop_in || !dop_steps || !rewards))
        || (model != MODEL_IZHIKEVICH && !state_in[3]))
        return (int)cudaErrorInvalidValue;
    const float tau_d = rule[7];
    const float exp_dd = rule[8];
    const size_t n = (size_t)rows * cols;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaSuccess;

    if (!per_step) {
        LpStep a = {};
        a.weights = weights;
        a.mask = mask;
        a.tr_c = tr_c;
        a.tr_dw = tr_dw;
        a.tr_counter = tr_counter;
        a.in_deg = in_deg;
        a.exp_dd = exp_dd;
        a.tau_d = tau_d;
        a.P = P;
        a.st = st;
        a.r = r;
        a.rows = rows;
        a.cols = cols;
        lp_geometry(a);
        for (int k = 0; k <= n_steps && err == cudaSuccess; ++k) {
            const bool edge = k > 0 && kind != KIND_PLAIN;
            const bool cell = k < n_steps;
            if (!edge && !cell) break;
            void* const* in = state_buf + 4 * ((k - 1) & 1);
            void* const* out = state_buf + 4 * (k & 1);
            a.v = k ? (const float*)in[0] : (const float*)state_in[0];
            a.w = k ? (const float*)in[1] : (const float*)state_in[1];
            a.lft = k ? (const int*)in[2] : (const int*)state_in[2];
            a.lft_edge = a.lft;
            a.refr = k ? (const float*)in[3] : (const float*)state_in[3];
            a.spk = k ? spikes + n * ((k - 1) & 1) : nullptr;
            a.v_out = (float*)out[0];
            a.w_out = (float*)out[1];
            a.lft_out = (int*)out[2];
            a.refr_out = (float*)out[3];
            a.spk_out = spikes + n * (k & 1);
            a.v_pre = v_pre && cell ? v_pre + (size_t)k * n : nullptr;
            a.clock = clock0 + k;
            // the step whose dopamine this launch takes: the edge pass's
            // (kind mod), else the cell phase's (kind plain, written only)
            const int ds = kind == KIND_MOD ? k - 1 : k;
            a.dop_base = dop_in;
            a.dop_write = nullptr;
            a.n_rew = 0;
            if (with_reward && (kind == KIND_MOD ? edge : cell)) {
                const int j0 = ds - ds % LP_REWARD_CHUNK;
                a.dop_base = j0 ? dop_steps + j0 - 1 : dop_in;
                a.dop_write = dop_steps + ds;
                a.n_rew = ds - j0 + 1;
                for (int j = 0; j < a.n_rew; ++j) a.rw.r[j] = rewards[j0 + j];
            }
            switch (model) {
            case MODEL_IZHIKEVICH:
                err = lp_launch_fused<MODEL_IZHIKEVICH>(kind, edge, cell, a, s,
                                                        launched);
                break;
            case MODEL_ALIF:
                err = lp_launch_fused<MODEL_ALIF>(kind, edge, cell, a, s,
                                                  launched);
                break;
            default:
                err = lp_launch_fused<MODEL_LIF>(kind, edge, cell, a, s,
                                                 launched);
            }
        }
        return (int)err;
    }

    const dim3 block(32, 8);
    const dim3 grid((cols + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    if (with_reward
        && (err = lp_launch_dopamine(dop_in, rewards, n_steps, exp_dd, tau_d,
                                     dop_steps, s, launched)) != cudaSuccess)
        return (int)err;

    const float* v = (const float*)state_in[0];
    const float* w = (const float*)state_in[1];
    const int* lft = (const int*)state_in[2];
    const float* refr = (const float*)state_in[3];
    for (int k = 0; k < n_steps; ++k) {
        void* const* b = state_buf + 4 * (k & 1);
        float* vo = (float*)b[0];
        float* wo = (float*)b[1];
        int* lfto = (int*)b[2];
        float* refro = (float*)b[3];
        unsigned char* spk = spikes + n * (k & 1);
        float* vp = v_pre ? v_pre + (size_t)k * n : nullptr;
        switch (model) {
        case MODEL_IZHIKEVICH:
            err = launch_cell<MODEL_IZHIKEVICH>(launched, grid, block, s, v,
                w, lft, refr, vo, wo, lfto, refro, spk, vp, weights, in_deg,
                P, st, rows, cols, clock0 + k);
            break;
        case MODEL_ALIF:
            err = launch_cell<MODEL_ALIF>(launched, grid, block, s, v, w,
                lft, refr, vo, wo, lfto, refro, spk, vp, weights, in_deg, P,
                st, rows, cols, clock0 + k);
            break;
        default:
            err = launch_cell<MODEL_LIF>(launched, grid, block, s, v, w,
                lft, refr, vo, wo, lfto, refro, spk, vp, weights, in_deg, P,
                st, rows, cols, clock0 + k);
        }
        if (err != cudaSuccess) return (int)err;
        const float* dop = with_reward ? dop_steps + k : dop_in;
        if (kind == KIND_PLASTIC) {
            err = lp_launch_stdp_edge(lfto, spk, weights, mask, r, st,
                                      rows, cols, s, launched);
        } else if (kind == KIND_MOD) {
            err = lp_launch_rstdp_edge(lfto, spk, weights, mask, tr_c,
                                       tr_dw, tr_counter, dop, r, st, rows,
                                       cols, s, launched);
        }
        if (err != cudaSuccess) return (int)err;
        v = vo;
        w = wo;
        lft = lfto;
        refr = refro;
    }
    return 0;
}

// One launch of the closed loop on `stream` (see the head of the file):
// with `edge`, step k-1's edge pass of kind plastic or mod (weights and
// traces in place) from its kept firing times and spike flags lft_edge
// and spk_edge and the dopamine *dop_read; with `cell`, step k from
// state_in = {v, w, lft, refr} into state_out (distinct planes; refr null
// for Izhikevich) at the clock *clock_read, its spike flags into `spikes`
// and both into the kept planes lft_keep and spk_keep.  Block 0 writes
// *dop_read, with *reward folded in (a step with a reward), to *dop_write
// and *clock_read + cell to *clock_write, each where not null.  The slots
// read and written must differ.  A launch with neither edge nor cell
// writes the scalars alone.  Every pointer is device memory that the
// caller owns, so a CUDA graph of such launches replays on the values the
// buffers hold.  The other arguments are as for lattice_plasticity_steps;
// *launched (when not null) gains one for each kernel launched.  Returns
// the first CUDA error, 0 if none.
int lattice_plasticity_env_step(
    int model, int kind, int edge, int cell,
    const void* const* state_in, void* const* state_out,
    unsigned char* spikes, int* lft_keep, unsigned char* spk_keep,
    const int* lft_edge, const unsigned char* spk_edge,
    const float* in_deg, const float* const* params, int n_params,
    float* weights, const unsigned char* mask,
    float* tr_c, float* tr_dw, int* tr_counter,
    const float* dop_read, float* dop_write, const float* reward,
    const int* clock_read, int* clock_write,
    const float* rule, const int* dr, const int* dc, int n_off,
    int rows, int cols, int* launched, void* stream)
{
    Stencil st;
    Params P;
    Rule r;
    if (!lp_setup(model, kind, n_params, n_off, rows, cols, params, dr, dc,
                  rule, st, P, r)
        || !clock_read || clock_read == clock_write
        || (dop_write && (!dop_read || dop_read == dop_write))
        || (reward && (!cell || !dop_write))
        || (edge && (kind == KIND_PLAIN || !mask || !lft_edge || !spk_edge))
        || (edge && kind == KIND_MOD
            && (!tr_c || !tr_dw || !tr_counter || !dop_read))
        || (cell && (!spikes || !lft_keep || !spk_keep || !in_deg
                     || !state_in[0] || !state_in[1] || !state_in[2]
                     || !state_out[0] || !state_out[1] || !state_out[2]))
        || (cell && model != MODEL_IZHIKEVICH
            && (!state_in[3] || !state_out[3])))
        return (int)cudaErrorInvalidValue;
    LpStep a = {};
    a.lft_edge = lft_edge;
    a.spk = spk_edge;
    a.weights = weights;
    a.mask = mask;
    a.tr_c = tr_c;
    a.tr_dw = tr_dw;
    a.tr_counter = tr_counter;
    a.in_deg = in_deg;
    a.dop_base = dop_read;
    a.dop_write = dop_write;
    a.reward = reward;
    a.clock_ptr = clock_read;
    a.clock_write = clock_write;
    a.exp_dd = rule[8];
    a.tau_d = rule[7];
    a.P = P;
    a.st = st;
    a.r = r;
    a.rows = rows;
    a.cols = cols;
    lp_geometry(a);
    if (cell) {
        a.v = (const float*)state_in[0];
        a.w = (const float*)state_in[1];
        a.lft = (const int*)state_in[2];
        a.refr = (const float*)state_in[3];
        a.v_out = (float*)state_out[0];
        a.w_out = (float*)state_out[1];
        a.lft_out = (int*)state_out[2];
        a.refr_out = (float*)state_out[3];
        a.spk_out = spikes;
        a.lft_keep = lft_keep;
        a.spk_keep = spk_keep;
    } else if (!edge) {
        // the scalars alone: no slot and no staged tile
        a.st.n = 0;
        a.tiled = 0;
    }
    cudaStream_t s = (cudaStream_t)stream;
    switch (model) {
    case MODEL_IZHIKEVICH:
        return (int)lp_launch_fused<MODEL_IZHIKEVICH>(kind, edge, cell, a, s,
                                                      launched);
    case MODEL_ALIF:
        return (int)lp_launch_fused<MODEL_ALIF>(kind, edge, cell, a, s,
                                                launched);
    default:
        return (int)lp_launch_fused<MODEL_LIF>(kind, edge, cell, a, s,
                                               launched);
    }
}

}  // extern "C"
