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
// Design.  Steps 4 read the neighbours' post-step lft and spikes, and
// phase A of step k+1 reads the neighbours' new v, so every step needs a
// grid-wide ordering point.  The TPU kernel keeps the whole lattice in
// VMEM for K steps; on Hopper a cooperative grid sync with one thread per
// cell would sit near the limit of co-resident threads at 512 x 512 (a
// grid of a few blocks per SM whose threads walk the cells does not:
// network_persistent.cu, one grid.sync() of ~1.1 us a step on an H100).
// Here each step is two launches on the caller's stream: a cell kernel
// (phases A and B, one thread per cell, writing v, w, lft, refr into one
// of two buffer sets and the spikes into a byte plane) and an edge kernel
// (step 4, one thread per destination cell).  Weights and traces are stored per
// destination (o, r, c), so each edge thread updates only its own slots,
// in place, and no two threads write one slot.  Dopamine is a one-thread
// kernel per call that writes the dopamine of every step.
//
// What bounds it on an H100 is memory traffic: per cell and step the cell
// kernel reads n_off weights, up to 13 parameter planes, in_deg, v, w,
// lft and refr and writes them back; the R-STDP edge kernel reads the
// mask and reads and writes weights, c, dw and counter for every offset.
// With radius 2 (12 offsets) that is about 500 bytes per cell per step
// for R-STDP (131 MB per step at 512 x 512, beyond the 50 MB L2: 39 us
// per step at 3.35 TB/s) and about 200 bytes for STDP.  Later work:
// fuse the edge pass of step k into the cell kernel of step k+1, keep
// tiles and halos in shared memory.
//
// The closed loop (lattice_plasticity_env_step; replaces the env form of
// the TPU kernel, _make_kernel(spec, n, env) driven by _env_advance) runs
// one step per call between the environment's callbacks, which stay
// PyTorch operations on the device.  Its reward and clock are device
// memory, not arguments, so that a CUDA graph of K such steps reads the
// values of each replay: the cell kernel reads the clock through a
// pointer (DEV_CLOCK), and lp_env_scalar_kernel updates the dopamine from
// the reward in device memory, in lp_dopamine_kernel's float order, and
// advances the clock.  Three launches per step (cell, scalars, edge).

#include "plasticity_common.cuh"

#define LP_REWARD_CHUNK 16

struct Rewards {
    float r[LP_REWARD_CHUNK];
};

template <int MODEL, bool DEV_CLOCK>
__global__ void lp_cell_kernel(
    const float* __restrict__ v_in, const float* __restrict__ w_in,
    const int* __restrict__ lft_in, const float* __restrict__ refr_in,
    float* __restrict__ v_out, float* __restrict__ w_out,
    int* __restrict__ lft_out, float* __restrict__ refr_out,
    unsigned char* __restrict__ spk_out,
    float* __restrict__ v_pre_out,         // null unless emitting
    const float* __restrict__ weights, const float* __restrict__ in_deg,
    Params P, Stencil st, int rows, int cols, int clock,
    const int* __restrict__ clock_ptr)    // read instead with DEV_CLOCK
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
    lft_out[i] = spike ? (DEV_CLOCK ? *clock_ptr : clock) : lft_in[i];
    spk_out[i] = spike ? 1 : 0;
    if (v_pre_out) v_pre_out[i] = v_pre;
}

template <int KIND>
__global__ void lp_edge_kernel(
    const int* __restrict__ lft, const unsigned char* __restrict__ spk,
    float* __restrict__ weights, const unsigned char* __restrict__ mask,
    float* __restrict__ tr_c, float* __restrict__ tr_dw,
    int* __restrict__ tr_counter, const float* __restrict__ dop_ptr,
    Rule r, Stencil st, int rows, int cols)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row >= rows || col >= cols) return;
    const size_t n = (size_t)rows * cols;
    const size_t i = (size_t)row * cols + col;
    const int t_post = lft[i];
    const float s_post = spk[i] ? 1.0f : 0.0f;
    const float dop = KIND == KIND_MOD ? *dop_ptr : 0.0f;
    for (int o = 0; o < st.n; ++o) {
        const size_t e = (size_t)o * n + i;
        if (!mask[e]) continue;
        const int sr = row + st.dr[o];
        const int sc = col + st.dc[o];
        int t_pre = LP_NEVER;
        float s_pre = 0.0f;
        if (sr >= 0 && sr < rows && sc >= 0 && sc < cols) {
            const size_t j = (size_t)sr * cols + sc;
            t_pre = lft[j];
            s_pre = spk[j] ? 1.0f : 0.0f;
        }
        const float delta = stdp_delta(t_pre, t_post, r);
        if (KIND == KIND_PLASTIC) {
            weights[e] = weights[e] + delta * (s_pre + s_post);
        } else {
            float w = weights[e];
            float c = tr_c[e];
            float dw = tr_dw[e];
            int ct = tr_counter[e];
            rstdp_visit(w, c, dw, ct, delta, dop, r);
            rstdp_visit(w, c, dw, ct, delta, dop, r);
            weights[e] = w;
            tr_c[e] = c;
            tr_dw[e] = dw;
            tr_counter[e] = ct;
        }
    }
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

// The closed loop's scalars after step k's cell kernel: the dopamine from
// the reward in device memory (null: no reward), in lp_dopamine_kernel's
// float order, then clock + 1.
__global__ void lp_env_scalar_kernel(float* dop, const float* reward,
                                     float exp_dd, float tau_d, int* clock)
{
    if (reward) *dop = *dop * exp_dd + tau_d * *reward;
    *clock = *clock + 1;
}

cudaError_t lp_launch_stdp_edge(const int* lft, const unsigned char* spk,
                                float* weights, const unsigned char* mask,
                                const Rule& r, const Stencil& st, int rows,
                                int cols, cudaStream_t s)
{
    const dim3 block(32, 8);
    const dim3 grid((cols + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    lp_edge_kernel<KIND_PLASTIC><<<grid, block, 0, s>>>(
        lft, spk, weights, mask, nullptr, nullptr, nullptr, nullptr, r, st,
        rows, cols);
    return cudaGetLastError();
}

cudaError_t lp_launch_rstdp_edge(const int* lft, const unsigned char* spk,
                                 float* weights, const unsigned char* mask,
                                 float* tr_c, float* tr_dw, int* tr_counter,
                                 const float* dop, const Rule& r,
                                 const Stencil& st, int rows, int cols,
                                 cudaStream_t s)
{
    const dim3 block(32, 8);
    const dim3 grid((cols + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    lp_edge_kernel<KIND_MOD><<<grid, block, 0, s>>>(
        lft, spk, weights, mask, tr_c, tr_dw, tr_counter, dop, r, st, rows,
        cols);
    return cudaGetLastError();
}

cudaError_t lp_launch_dopamine(const float* dop_in, const float* rewards,
                               int n_steps, float exp_dd, float tau_d,
                               float* dop_steps, cudaStream_t s)
{
    for (int j0 = 0; j0 < n_steps; j0 += LP_REWARD_CHUNK) {
        Rewards rw;
        const int count = n_steps - j0 < LP_REWARD_CHUNK
            ? n_steps - j0 : LP_REWARD_CHUNK;
        for (int j = 0; j < count; ++j) rw.r[j] = rewards[j0 + j];
        lp_dopamine_kernel<<<1, 1, 0, s>>>(
            j0 == 0 ? dop_in : dop_steps + j0 - 1, rw, count, exp_dd, tau_d,
            dop_steps + j0);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

template <int MODEL, bool DEV_CLOCK = false>
static void launch_cell(dim3 grid, dim3 block, cudaStream_t s,
                        const float* v, const float* w, const int* lft,
                        const float* refr, float* vo, float* wo, int* lfto,
                        float* refro, unsigned char* spk, float* v_pre,
                        const float* weights, const float* in_deg,
                        const Params& P, const Stencil& st, int rows,
                        int cols, int clock, const int* clock_ptr = nullptr)
{
    lp_cell_kernel<MODEL, DEV_CLOCK><<<grid, block, 0, s>>>(
        v, w, lft, refr, vo, wo, lfto, refro, spk, v_pre, weights, in_deg,
        P, st, rows, cols, clock, clock_ptr);
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
// receives each step's spike flags (the last step's at the end), `v_pre`,
// when not null, the pre-reset voltage of step k at k * rows * cols.
// `params` holds n_params planes in MODEL_PARAM_KEYS order.  `weights`,
// and for kind mod `tr_c`, `tr_dw`, `tr_counter`, are updated in place.
// `rule` = {a_plus, a_minus, tau_plus, tau_minus, dt, tau_c, exp_dc,
// tau_d, exp_dd}; `rewards` (host, n_steps floats) feed the dopamine,
// which starts from *dop_in and is written per step to dop_steps (with
// rewards only; without, kind mod reads *dop_in every step).  Returns the
// first CUDA error, 0 if none.
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
    int rows, int cols, int clock0, int n_steps, void* stream)
{
    Stencil st;
    Params P;
    Rule r;
    if (!lp_setup(model, kind, n_params, n_off, rows, cols, params, dr, dc,
                  rule, st, P, r)
        || n_steps <= 0 || (kind != KIND_PLAIN && !mask)
        || (kind == KIND_MOD && (!tr_c || !tr_dw || !tr_counter || !dop_in))
        || (with_reward && (!dop_in || !dop_steps))
        || (model != MODEL_IZHIKEVICH && !state_in[3]))
        return (int)cudaErrorInvalidValue;
    const float tau_d = rule[7];
    const float exp_dd = rule[8];
    const size_t n = (size_t)rows * cols;
    const dim3 block(32, 8);
    const dim3 grid((cols + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;

    if (with_reward
        && (err = lp_launch_dopamine(dop_in, rewards, n_steps, exp_dd, tau_d,
                                     dop_steps, s)) != cudaSuccess)
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
        float* vp = v_pre ? v_pre + (size_t)k * n : nullptr;
        switch (model) {
        case MODEL_IZHIKEVICH:
            launch_cell<MODEL_IZHIKEVICH>(grid, block, s, v, w, lft, refr,
                vo, wo, lfto, refro, spikes, vp, weights, in_deg, P, st,
                rows, cols, clock0 + k);
            break;
        case MODEL_ALIF:
            launch_cell<MODEL_ALIF>(grid, block, s, v, w, lft, refr, vo, wo,
                lfto, refro, spikes, vp, weights, in_deg, P, st, rows, cols,
                clock0 + k);
            break;
        default:
            launch_cell<MODEL_LIF>(grid, block, s, v, w, lft, refr, vo, wo,
                lfto, refro, spikes, vp, weights, in_deg, P, st, rows, cols,
                clock0 + k);
        }
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        const float* dop = with_reward ? dop_steps + k : dop_in;
        if (kind == KIND_PLASTIC) {
            err = lp_launch_stdp_edge(lfto, spikes, weights, mask, r, st,
                                      rows, cols, s);
        } else if (kind == KIND_MOD) {
            err = lp_launch_rstdp_edge(lfto, spikes, weights, mask, tr_c,
                                       tr_dw, tr_counter, dop, r, st, rows,
                                       cols, s);
        }
        if (err != cudaSuccess) return (int)err;
        v = vo;
        w = wo;
        lft = lfto;
        refr = refro;
    }
    return 0;
}

// One closed-loop step from state_in = {v, w, lft, refr} into state_out
// (distinct planes; refr null for Izhikevich) on `stream`: the cell
// kernel at clock *clock, then lp_env_scalar_kernel (with_reward: dopamine
// from *reward, in place; then *clock + 1), then the edge kernel of kind
// plastic or mod (weights and traces in place; mod reads *dopamine).
// `spikes` receives the step's spike flags.  Every pointer is device
// memory that the caller owns, so a CUDA graph of such calls replays on
// the values the buffers hold.  The other arguments are as for
// lattice_plasticity_steps.  Returns the first CUDA error, 0 if none.
int lattice_plasticity_env_step(
    int model, int kind, int with_reward,
    const void* const* state_in, void* const* state_out,
    unsigned char* spikes,
    const float* in_deg, const float* const* params, int n_params,
    float* weights, const unsigned char* mask,
    float* tr_c, float* tr_dw, int* tr_counter,
    float* dopamine, const float* reward, int* clock,
    const float* rule, const int* dr, const int* dc, int n_off,
    int rows, int cols, void* stream)
{
    Stencil st;
    Params P;
    Rule r;
    if (!lp_setup(model, kind, n_params, n_off, rows, cols, params, dr, dc,
                  rule, st, P, r)
        || !clock || (kind != KIND_PLAIN && !mask)
        || (kind == KIND_MOD && (!tr_c || !tr_dw || !tr_counter || !dopamine))
        || (with_reward && (!dopamine || !reward))
        || (model != MODEL_IZHIKEVICH && (!state_in[3] || !state_out[3])))
        return (int)cudaErrorInvalidValue;
    const float tau_d = rule[7];
    const float exp_dd = rule[8];
    const dim3 block(32, 8);
    const dim3 grid((cols + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    cudaStream_t s = (cudaStream_t)stream;
    const float* v = (const float*)state_in[0];
    const float* w = (const float*)state_in[1];
    const int* lft = (const int*)state_in[2];
    const float* refr = (const float*)state_in[3];
    float* vo = (float*)state_out[0];
    float* wo = (float*)state_out[1];
    int* lfto = (int*)state_out[2];
    float* refro = (float*)state_out[3];
    switch (model) {
    case MODEL_IZHIKEVICH:
        launch_cell<MODEL_IZHIKEVICH, true>(grid, block, s, v, w, lft, refr,
            vo, wo, lfto, refro, spikes, nullptr, weights, in_deg, P, st,
            rows, cols, 0, clock);
        break;
    case MODEL_ALIF:
        launch_cell<MODEL_ALIF, true>(grid, block, s, v, w, lft, refr, vo,
            wo, lfto, refro, spikes, nullptr, weights, in_deg, P, st, rows,
            cols, 0, clock);
        break;
    default:
        launch_cell<MODEL_LIF, true>(grid, block, s, v, w, lft, refr, vo,
            wo, lfto, refro, spikes, nullptr, weights, in_deg, P, st, rows,
            cols, 0, clock);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lp_env_scalar_kernel<<<1, 1, 0, s>>>(
        dopamine, with_reward ? reward : nullptr, exp_dd, tau_d, clock);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (kind == KIND_PLASTIC)
        err = lp_launch_stdp_edge(lfto, spikes, weights, mask, r, st, rows,
                                  cols, s);
    else if (kind == KIND_MOD)
        err = lp_launch_rstdp_edge(lfto, spikes, weights, mask, tr_c, tr_dw,
                                   tr_counter, dopamine, r, st, rows, cols,
                                   s);
    return (int)err;
}

}  // extern "C"
