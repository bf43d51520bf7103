// K steps of a Hodgkin-Huxley lattice with chemical synapses.
//
// Replaces the TPU kernel spiking_neural_networks_tpu/ops/pallas_hh.py:
// fused_hh_multistep: a Hodgkin-Huxley lattice with Ionotropic receptors
// (AMPA, NMDA, GABA) on a stencil graph, with Destexhe or approximate
// neurotransmitter and receptor kinetics, electrical synapses on or off,
// STDP on or off.  Per step k and cell (r, c), in the TPU kernel's order
// and association:
//   1. electrical: acc = sum_o w_o * v[r+dr_o, c+dc_o], wsum = sum_o w_o
//      (offset order, from 0), i_elec = gap * (acc - v * wsum) / max(in_deg, 1);
//   2. chemical, per type q: sums = sum_o w_o * (t_q * m_q)[r+dr_o, c+dc_o],
//      cnts = sum_o emask_o * m_q[r+dr_o, c+dc_o], t_in = sums / max(cnts, 1),
//      valid = cnts > 0 (m_q the neurotransmitter presence mask);
//   3. receptors on valid, inserted slots (Destexhe: r += (alpha t (1 - r)
//      - beta r) dt; approximate: r = t_in), currents g r (v - e) at the
//      pre-update v with the NMDA block 1 / (1 + (exp(-0.062 v) mg) / 3.75),
//      i_ligand = ((I_0 + I_1) + I_2) * (dt / c_m);
//   4. gates from the old v (the m and n rates at their limits where they
//      are 0 / 0, v = -40 and -55); i_na = m (m m) h g (v - e), i_k = ((n n)(n n))
//      g (v - e), i_kl = g (v - e); v' = v + dt (i_elec - ((i_na + i_k) +
//      i_kl)) / c_m - i_ligand;
//   5. release: Destexhe t = t_max / (1 + exp(-(v' - v_p) / k_p));
//      approximate t = clip(t + (dt (-clearance)) t + spike_prev t_max,
//      0, t_max); 0 where no neurotransmitter is inserted;
//   6. spike = v' > v_th && was_increasing && !(v < v'); lft = clock0 + k;
//   7. STDP (plastic): w_o += delta(lft_pre, lft_post) (spk_pre + spk_post)
//      on masked slots, from the post-step lft and spikes (run by the next
//      step's launch, below).
// Off-grid neighbours are skipped by a bounds check.  The receptor
// kinetics and the release are chem_common.cuh's, shared with the network
// kernels' chemical arm.  Every exp is
// kernel_exp (plasticity_common.cuh); built with -fmad=false and without
// fast math, the kernels round as their plain PyTorch twin
// (ops/hh_kernels.hh_steps_reference) on any device.
//
// Design.  The TPU kernel keeps the whole lattice in VMEM for K steps; a
// step reads its neighbours' previous v and concentrations, and STDP reads
// their post-step lft and spikes, so on Hopper every step ends at a launch
// boundary.  Step k is a launch of hh_cell_kernel (one thread per cell,
// templated on the two kinetics; the electrical switch is an argument,
// uniform over the launch) that reads buffer set (k-1) % 2 and writes set
// k % 2.  With STDP, launch k (k >= 1) first runs step k-1's STDP pass on
// the cell's own slots (EDGE): weights are stored per destination, and the
// pass reads step k-1's lft and spike flags, which set (k-1) % 2 already
// holds and nobody writes in launch k; the updated weights stay in
// registers for the electrical and chemical sums.  A weight is stored only
// where its bits changed (exact: the store of an unchanged value writes
// the bits already there; w + 0 on a -0.0 weight gives +0.0, which is a
// change and is stored).  After the last step one launch of the edge
// kernel of lattice_plasticity.cu runs step K-1's pass: K + 1 launches per
// K-step call.  The per-step design (a cell launch, then the edge kernel,
// each step: 2 K launches) stays reachable with per_step = 1, for the
// comparison in turns only: it was slower at 128 x 128 and 512 x 512.
// Every launch is counted (lp_counted).  Per-type fields keep the state's
// (N, 3) layout; masks and flags are bytes (PyTorch's bool).
//
// What bounds it on an H100 is memory traffic: per cell and step the cell
// kernel reads 10 parameter planes, 9 or 15 receptor and 6 or 9
// neurotransmitter parameters, both (N, 3) masks, 12 weights and 12 mask
// bytes (radius 2), in_deg and the state, and writes the state: about
// 330-400 bytes, the STDP pass riding on the weight and mask loads.  At
// 512 x 512 that is over 100 MB per step, beyond the 50 MB L2.  Later
// work: temporal blocking (K steps on a tile plus a K * pad halo in shared
// memory), so that parameters and weights are read once per K steps.

#include "chem_common.cuh"

#define HH_TYPES 3
#define HH_STATE_FIELDS 9

enum { KIN_DESTEXHE = 0, KIN_APPROXIMATE = 1 };

// Parameter planes in PARAM_ORDER (ops/hh_kernels.py).
namespace hp { enum { dt, c_m, v_th, gap, na_g, na_e, k_g, k_e, kl_g, kl_e,
                      count }; }

struct HHState {
    float* v;
    float* m;
    float* h;
    float* n;
    unsigned char* wasinc;
    unsigned char* spk;
    int* lft;
    float* ntt;       // (N, 3)
    float* recr;      // (N, 3)
};

struct HHCurrents {   // written on the last step only
    float* rec;       // (N, 3)
    float* na;
    float* k;
    float* kleak;
};

struct HHParams {
    const float* p[hp::count];
    const float* nt[3];    // (N, 3) each, in nt_param_keys order
    const float* rec[5];   // (N, 3) each, in rec_param_keys order
};

// Step k of one cell; with EDGE, first step k-1's STDP pass on the
// cell's own slots (from `in`'s lft and spike flags, step k-1's), whose
// weights the electrical and chemical sums then take from registers.
template <int NT, int REC, bool EDGE>
__global__ void hh_cell_kernel(
    HHState in, HHState out, HHCurrents cur, HHParams P, int elec,
    const unsigned char* __restrict__ nt_mask,
    const unsigned char* __restrict__ rec_mask,
    float* __restrict__ weights, const unsigned char* __restrict__ emask,
    const float* __restrict__ in_deg, Stencil st, Rule rule, int rows,
    int cols, int clock, int last)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row >= rows || col >= cols) return;
    const size_t n = (size_t)rows * cols;
    const size_t i = (size_t)row * cols + col;
    const float* const* p = P.p;

    const float v = in.v[i];
    const float dt = p[hp::dt][i];
    const float c_m = p[hp::c_m][i];

    // 1. electrical input; 2. chemical input, one pass over the offsets
    float acc = 0.0f, wsum = 0.0f;
    float sums[HH_TYPES] = {0.0f, 0.0f, 0.0f};
    float cnts[HH_TYPES] = {0.0f, 0.0f, 0.0f};
    const int t_post = EDGE ? in.lft[i] : LP_NEVER;
    const float s_post = EDGE && in.spk[i] ? 1.0f : 0.0f;
    for (int o = 0; o < st.n; ++o) {
        const size_t e = (size_t)o * n + i;
        float wo = weights[e];
        const bool me = emask[e];
        const int sr = row + st.dr[o];
        const int sc = col + st.dc[o];
        const bool on = sr >= 0 && sr < rows && sc >= 0 && sc < cols;
        const size_t j = (size_t)sr * cols + sc;
        if (EDGE && me) {
            // the edge kernel's update, stored only where its bits change
            const int t_pre = on ? in.lft[j] : LP_NEVER;
            const float s_pre = on && in.spk[j] ? 1.0f : 0.0f;
            const float nw = wo + stdp_delta(t_pre, t_post, rule)
                * (s_pre + s_post);
            if (__float_as_int(nw) != __float_as_int(wo)) weights[e] = nw;
            wo = nw;
        }
        wsum = wsum + wo;
        if (!on) continue;
        if (elec) acc = acc + wo * in.v[j];
        const float em = me ? 1.0f : 0.0f;
        for (int q = 0; q < HH_TYPES; ++q) {
            const float mq = nt_mask[HH_TYPES * j + q] ? 1.0f : 0.0f;
            sums[q] = sums[q] + wo * (in.ntt[HH_TYPES * j + q] * mq);
            cnts[q] = cnts[q] + em * mq;
        }
    }
    const float i_elec = elec
        ? p[hp::gap][i] * (acc - v * wsum) / fmaxf(in_deg[i], 1.0f) : 0.0f;

    // 3. receptor kinetics, then the currents at the pre-update v
    const int rg = REC == KIN_DESTEXHE ? 2 : 0;   // index of rec$g
    float r[HH_TYPES], reccur[HH_TYPES];
    const float block = 1.0f / (1.0f + kernel_exp(-0.062f * v)
                                * P.rec[rg + 2][HH_TYPES * i + 1] / 3.75f);
    for (int q = 0; q < HH_TYPES; ++q) {
        const size_t iq = HH_TYPES * i + q;
        r[q] = in.recr[iq];
        if (cnts[q] > 0.0f && rec_mask[iq])
            r[q] = rec_kinetics(
                REC == KIN_DESTEXHE ? REC_DESTEXHE : REC_APPROXIMATE, r[q],
                sums[q] / fmaxf(cnts[q], 1.0f), P.rec[0][iq], P.rec[1][iq],
                dt);
        float c = P.rec[rg][iq] * r[q] * (v - P.rec[rg + 1][iq]);
        if (q == 1) c = c * block;
        reccur[q] = rec_mask[iq] ? c : 0.0f;
    }
    const float i_ligand = (reccur[0] + reccur[1] + reccur[2]) * (dt / c_m);

    // 4. gates from the old v, then the voltage; the m and n rates take
    // their limits (1 and 0.1) where they are 0 / 0, at v = -40 and -55
    const float xm = v + 40.0f;
    const float m_alpha = xm == 0.0f ? 1.0f
        : 0.1f * (xm / (1.0f - kernel_exp(-xm / 10.0f)));
    const float m_beta = 4.0f * kernel_exp(-(v + 65.0f) / 18.0f);
    const float h_alpha = 0.07f * kernel_exp(-(v + 65.0f) / 20.0f);
    const float h_beta = 1.0f / (kernel_exp(-(v + 35.0f) / 10.0f) + 1.0f);
    float m = in.m[i];
    float h = in.h[i];
    float nn = in.n[i];
    m = m + dt * (m_alpha * (1.0f - m) - m_beta * m);
    h = h + dt * (h_alpha * (1.0f - h) - h_beta * h);
    const float xn = v + 55.0f;
    const float n_alpha = xn == 0.0f ? 0.1f
        : 0.01f * xn / (1.0f - kernel_exp(-xn / 10.0f));
    const float n_beta = 0.125f * kernel_exp(-(v + 65.0f) / 80.0f);
    nn = nn + dt * (n_alpha * (1.0f - nn) - n_beta * nn);
    const float i_na = m * (m * m) * h * p[hp::na_g][i] * (v - p[hp::na_e][i]);
    const float i_k = (nn * nn) * (nn * nn) * p[hp::k_g][i]
        * (v - p[hp::k_e][i]);
    const float i_kl = p[hp::kl_g][i] * (v - p[hp::kl_e][i]);
    const float v_new = v + dt * (i_elec - (i_na + i_k + i_kl)) / c_m
        - i_ligand;

    // 5. neurotransmitter release, from the previous step's spike flag
    const float spk_prev = in.spk[i] ? 1.0f : 0.0f;
    for (int q = 0; q < HH_TYPES; ++q) {
        const size_t iq = HH_TYPES * i + q;
        const float t = nt_release(
            NT == KIN_DESTEXHE ? NT_DESTEXHE : NT_APPROXIMATE, in.ntt[iq],
            v_new, spk_prev, P.nt[0][iq], P.nt[1][iq], opt(P.nt[2], iq), dt);
        out.ntt[iq] = nt_mask[iq] ? t : 0.0f;
        out.recr[iq] = r[q];
        if (last) cur.rec[iq] = reccur[q];
    }

    // 6. peak-detection spikes
    const bool inc = v < v_new;
    const bool spike = v_new > p[hp::v_th][i] && in.wasinc[i] && !inc;
    out.v[i] = v_new;
    out.m[i] = m;
    out.h[i] = h;
    out.n[i] = nn;
    out.wasinc[i] = inc ? 1 : 0;
    out.spk[i] = spike ? 1 : 0;
    out.lft[i] = spike ? clock : in.lft[i];
    if (last) {
        cur.na[i] = i_na;
        cur.k[i] = i_k;
        cur.kleak[i] = i_kl;
    }
}

static HHState state_of(void* const* f)
{
    HHState s = {(float*)f[0], (float*)f[1], (float*)f[2], (float*)f[3],
                 (unsigned char*)f[4], (unsigned char*)f[5], (int*)f[6],
                 (float*)f[7], (float*)f[8]};
    return s;
}

extern "C" {

int hh_max_offsets() { return LP_MAX_OFFSETS; }

// Runs n_steps steps from state_in = {v, m, h, n, was_increasing,
// is_spiking, lft, nt$t, rec$r} on `stream`.  Step k writes buffer set
// k % 2 (state_buf[9 * (k % 2) + f]), so the result is in set
// (n_steps - 1) % 2; the inputs are only read.  `currents` = {rec$current
// (N, 3), na, k, kleak} receive the last step's currents.  `params` holds
// the 10 planes of PARAM_ORDER, `nt_params` / `rec_params` the kinetics'
// (N, 3) parameters in nt_param_keys / rec_param_keys order.  With
// `plastic`, `weights` are updated in place by STDP with `rule` = {a_plus,
// a_minus, tau_plus, tau_minus, dt}: per_step = 0 runs step k-1's STDP
// pass inside step k's launch and one edge launch after the last step
// (n_steps + 1 launches), 1 an edge launch after every step (2 n_steps).
// *launched (when not null) gains one for each kernel launched.  Kinetics
// ids: 0 Destexhe, 1 approximate.  Returns the first CUDA error, 0 if none.
int hh_chemical_steps(
    int nt_kind, int rec_kind, int electrical, int plastic,
    const void* const* state_in, void* const* state_buf,
    void* const* currents, const float* const* params,
    const float* const* nt_params, int n_nt_params,
    const float* const* rec_params, int n_rec_params,
    const unsigned char* nt_mask, const unsigned char* rec_mask,
    float* weights, const unsigned char* emask, const float* in_deg,
    const float* rule, const int* dr, const int* dc, int n_off,
    int rows, int cols, int clock0, int n_steps, int per_step, int* launched,
    void* stream)
{
    if (nt_kind < 0 || nt_kind > 1 || rec_kind < 0 || rec_kind > 1
        || n_nt_params != (nt_kind == KIN_DESTEXHE ? 3 : 2)
        || n_rec_params != (rec_kind == KIN_DESTEXHE ? 5 : 3)
        || n_off < 0 || n_off > LP_MAX_OFFSETS || rows <= 0 || cols <= 0
        || n_steps <= 0)
        return (int)cudaErrorInvalidValue;
    Stencil st;
    st.n = n_off;
    for (int o = 0; o < n_off; ++o) {
        st.dr[o] = dr[o];
        st.dc[o] = dc[o];
    }
    HHParams P;
    for (int q = 0; q < hp::count; ++q) P.p[q] = params[q];
    for (int q = 0; q < 3; ++q) P.nt[q] = q < n_nt_params ? nt_params[q] : nullptr;
    for (int q = 0; q < 5; ++q)
        P.rec[q] = q < n_rec_params ? rec_params[q] : nullptr;
    const Rule r = {rule[0], rule[1], rule[2], rule[3], rule[4], 0.0f, 0.0f};
    HHState in = state_of((void* const*)state_in);
    const HHCurrents cur = {(float*)currents[0], (float*)currents[1],
                            (float*)currents[2], (float*)currents[3]};
    const dim3 block(32, 8);
    const dim3 grid((cols + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    // the fused schedule: launch k (k >= 1) runs step k-1's STDP pass
    // before step k; a trailing edge launch ends the call
    const bool fused = plastic && !per_step;
    for (int k = 0; k < n_steps; ++k) {
        const HHState out = state_of(state_buf + HH_STATE_FIELDS * (k & 1));
        const int last = k == n_steps - 1;
        const bool edge = fused && k > 0;
#define HH_LAUNCH(NT, REC)                                                  \
        do {                                                                \
            if (edge)                                                       \
                hh_cell_kernel<NT, REC, true><<<grid, block, 0, s>>>(       \
                    in, out, cur, P, electrical, nt_mask, rec_mask,         \
                    weights, emask, in_deg, st, r, rows, cols, clock0 + k,  \
                    last);                                                  \
            else                                                            \
                hh_cell_kernel<NT, REC, false><<<grid, block, 0, s>>>(      \
                    in, out, cur, P, electrical, nt_mask, rec_mask,         \
                    weights, emask, in_deg, st, r, rows, cols, clock0 + k,  \
                    last);                                                  \
        } while (0)
        if (nt_kind == KIN_DESTEXHE && rec_kind == KIN_DESTEXHE)
            HH_LAUNCH(KIN_DESTEXHE, KIN_DESTEXHE);
        else if (nt_kind == KIN_DESTEXHE)
            HH_LAUNCH(KIN_DESTEXHE, KIN_APPROXIMATE);
        else if (rec_kind == KIN_DESTEXHE)
            HH_LAUNCH(KIN_APPROXIMATE, KIN_DESTEXHE);
        else
            HH_LAUNCH(KIN_APPROXIMATE, KIN_APPROXIMATE);
#undef HH_LAUNCH
        if ((err = lp_counted(launched)) != cudaSuccess) return (int)err;
        if (plastic && (per_step || last)) {
            err = lp_launch_stdp_edge(out.lft, out.spk, weights, emask, r,
                                      st, rows, cols, s, launched);
            if (err != cudaSuccess) return (int)err;
        }
        in = out;
    }
    return 0;
}

}  // extern "C"
