// K steps of a network of stencil lattices, spike trains and one-to-one
// or resample connections, with STDP, and of a reward network with
// R-STDP.
//
// Replaces the grid-mode plain-network form of the TPU kernel
// spiking_neural_networks_tpu/ops/pallas_reward.py:_fused_chunk (body
// _make_kernel, built by plain_network_runner): Izhikevich, adaptive leaky
// (ALIF) or leaky (LIF) lattices of mixed grid shapes on stencil (or
// edgeless) graphs, Poisson or Rate trains, and connections that are
// one-to-one or resample taps (pooling, upsampling, shifted projections:
// post (r, c) reads pre (f(r) + dr, f(c) + dc) with f(r) = r * fr for a
// stride, r / -fr for a repeat).  Per step k, in the TPU kernel's order and
// association (ops/network_kernels.py holds the plain twin):
//   1. net_cell_kernel, one launch per lattice: phase A,
//        total = (acc - v * wsum) + each incoming connection in plan order:
//        one-to-one (m * w) * (v_pre - v), or (m * w) * effect from a train;
//        resample: tacc = sum over taps in order of w_t * (a_t - sub_t * v)
//        (w_t * a_t from a train), total = total + tacc;
//        i = gap * total / cnt, cnt = max(in_deg + sum of masks, 1);
//      a train's effect is computed from its previous firing times as
//        amp * exp(decay * tdiff * tdiff) + v_resting (exponential decay:
//        decay * tdiff), v_resting where it never fired; every exp is
//        kernel_exp (plasticity_common.cuh), bit-equal to the twin's;
//      then phase B (model_step, plasticity_common.cuh); lft = clock0 + k;
//   2. STDP on every plastic lattice's stencil weights (lp_launch_stdp_edge,
//      the plasticity kernel's own edge kernel);
//   3. net_conn_edge_kernel on every connection with a plastic endpoint:
//        w += delta(lft_pre, lft_post) * (pre_plastic * spk_pre
//                                         + post_plastic * spk_post);
//   4. net_train_kernel, one launch per train: Poisson u_k <= chance, Rate
//      step + dt >= rate; lft = clock0 + k on a spike.
// Trains step last, so every read of a train's firing times in a step sees
// the previous step's; trains are never plastic endpoints.
//
// Design.  Phase A of lattice j reads lattice i's pre-step v, so every
// lattice's v, w, lft and refr are double-buffered by step parity (step k
// writes set k % 2) and read from set (k - 1) % 2; the edge kernels then
// read the post-step lft and spikes of both endpoints.  Each kernel has one
// thread per post cell that owns its weight slots, so the STDP updates are
// in place without atomics.  A step costs one launch per lattice, plastic
// lattice, updating connection and train (7 for a config-5 network);
// cnt is computed once per call by net_count_kernel.
//
// What bounds it on an H100: at 64 x 64 the launches (7 a step for a
// config-5 network, each a few us of host time for a few us of device
// time); at 512 x 512 memory traffic, about 120 bytes per cell and step
// for a radius-2 lattice and 16 bytes per cell and tap for a connection
// (computed from the shapes), the weights read by the cell kernel and
// again by the edge kernels.  So grid-mode electrical networks, reward
// networks, flat mode and chemical networks whose residency plan holds
// every member take the persistent kernel of network_persistent.cu (one
// cooperative launch per call, step k-1's edge passes fused into step k's
// cell phase, what only a cell's owner reads in shared memory); these
// per-step launches serve chemical networks with streamed members (2 x
// 512^2: 98 against 159 us a step of device time on an H100), specs of
// more members than the persistent kernel's description holds (8
// lattices, 8 trains, 16 connections), and the other specs only through
// network_steps(..., per_step=True), to compare the designs.
//
// The chemical arm (the chemical form of _make_kernel, pallas_reward.py
// :653-832 and :1012-1019): net_chem_cell_kernel takes step 1's place for
// a chemical network.  Per cell and neurotransmitter type q it gathers
// sums_q = sum_o w_o * (t_q * m_q)[r+dr, c+dc] and cnt_q = sum_o emask_o *
// m_q[r+dr, c+dc] from the previous step's concentrations t and presence
// masks m, re-expanded as (sums / max(cnt, 1)) * max(cnt, 1) * (cnt > 0),
// adds each incoming one-to-one connection's (w * t) * m and m where its
// mask holds, and takes t_in = sums / max(cnts, 1), valid = cnts > 0;
// then the receptor kinetics on valid, inserted slots, the Ionotropic or
// DopaGluGABA currents at the pre-update v (chem_common.cuh), v_pre = v +
// dv - sum(I) * (dt / c_m), and the release from v_pre and the previous
// step's spike flag.  Families and kinetics are ids uniform over a launch
// (one instantiation per model); the electrical input is an argument too.
// Concentrations are double-buffered like v (neighbours read them); the
// gating values and modifiers, which only their own cell reads, and the
// spike flags are updated in place.  net_train_kernel releases a train's
// neurotransmitter after its new spike.  Per cell and step a radius-2
// DopaGluGABA lattice moves about 300 bytes (the (N, 3) state and
// parameter fields, 9 parameter planes, the weights and masks), so at
// 512 x 512 it is memory-bound like the plain form.
//
// Flat mode (the flat form of _make_kernel, pallas_reward.py :600-608,
// :623-630, :678-690, :704-709, built by plain_network_runner :2097-2166):
// a lattice whose intra graph is a dense (N, N) weight matrix with a mask,
// or a connection that is a dense (n_pre, n_post) block, N <= NET_DENSE_MAX.
// Every lattice and train is then a (1, N) row.  The dense sums go to a
// kernel of their own, net_dense_gather_kernel, once per step for all the
// network's matrices (one "job" each, blockIdx.y); the cell kernels read its
// results.  A block is 32 destinations j by NET_DENSE_SEG = 32 segments k:
// thread (j, k) sums the sources i = k, k + 32, k + 64, ... in that order,
// a multiply then an add per term (no FMA: -fmad=false), and the 32 partial
// sums of a destination are then added from 0 in segment order.  That order
// is the contract with the twin's _seg_dot (ops/network_kernels.py); the
// TPU kernel takes the same sums as MXU products.  Per job and step:
//   the electrical sum of a_i * W_ij over the sources' previous v or, from a
//     train, its effects of this step (net_effect_kernel writes them);
//   per type q the chemical sum of (t * m)_iq * W_ij;
// with W = mask ? W : 0 for an intra graph (a block's weights are 0 off its
// edges).  Once per call the same kernel takes what no step changes (flat
// mode has no plasticity): the column sums of W (0 from a train) and per
// type the counts sum_i m_iq * mask_ij.  The cell kernels then form
//   electrical intra: d = max(in_deg_j, 1), total = (wa - v_j * wsub) / d * d;
//   electrical block: total += dot - v_j * sdot;
//   chemical intra: sums_q and cnt_q, re-expanded as for a stencil;
//   chemical block: csum_q += ds_q, ccnt_q += dc_q;
// and cnt adds a block's mask column sums (net_count_kernel).
// Adjacent threads read adjacent j of one matrix row, so the loads
// coalesce; 32 warps per block hide each other's latency.  At N = 512 the
// (512, 512) matrices and masks (1.3 MB each) sit in L2.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 24), the Bayesian
// network of 512 + 512 neurons with three such matrices: the gather launch
// 8.7 us of 27 us of device time per step, the two chemical cell launches
// 12; the step is bound by the host's 5 launches (95-98 us of wall time).
// One thread per destination walking its 512 sources in index order, the
// first design, took 438 us of device time per step: a full L2 latency per
// source on one warp per SM.  Flat mode's main path now takes the
// persistent kernel's flat instantiation (network_persistent.cu); these
// launches serve network_steps(..., per_step=True).

// The reward arm (the reward-network form of _make_kernel, built by
// pallas_reward.py network_runner, :1863-1929; the step :863-987): a
// RewardModulatedLatticeNetwork of one grid shape with one-to-one
// connections.  Lattice kind mod takes the R-STDP double visit of its
// stencil weights and (c, dw, counter) traces after the STDP, through the
// single-lattice kernels' edge kernel of kind mod (lp_launch_rstdp_edge);
// the dopamine of every step of a call is one launch before the steps
// (lp_launch_dopamine, the rewards by value), and step k's visits read
// entry k.  net_conn_edge_kernel counts `static` visits (the endpoints that
// are modulated lattices, visiting every step) and, on a reward
// connection, takes up to two gated R-STDP visits of (w, c, dw, counter)
// per slot with the reward rule's delta.  Per step the bench's network
// (a reward lattice, a plastic lattice, a train, a plain and a reward
// connection) runs 7 launches: 2 cell kernels, the STDP and the R-STDP
// edge kernels, 2 connection edge kernels and the train.  At 512 x 512 it
// is memory-bound like 6a's R-STDP lattice: the R-STDP edge kernel reads
// and writes weights and three traces for each of 12 slots per cell.  The
// main path takes the persistent kernel instead (network_persistent.cu:
// one launch per call, the R-STDP visits of step k-1 fused into step k's
// phase A); this arm stays for network_steps(..., per_step=True) and
// for reward networks of more members than that kernel holds.

#include "chem_common.cuh"
#include "network_common.cuh"

#define NET_DENSE_MAX 512
#define NET_DENSE_SEG 32
// jobs per launch of net_dense_gather_kernel (its argument's size)
#define NET_DENSE_JOBS 32
// strides of the flat per-lattice, per-train and per-connection
// descriptions (ops/network_kernels.py NL_I, NL_P, NT_I, NT_P, NC_I, NC_P)
#define NL_I (8 + 2 * LP_MAX_OFFSETS)
#define NL_P 36
#define NT_I 5
#define NT_P 10
#define NC_I 13
#define NC_P 7
#define NLC_P 32
#define NTC_P 8

// One incoming connection as the cell kernel reads it.
struct InConn {
    int kind, pre_is_st, refractoriness, R1, C1, fr, fc, n_taps;
    const int* taps;                     // device (dr, dc) pairs; resample
    const float* w;                      // (n_taps, rows, cols) post grid;
    const unsigned char* mask;           // dense: (n_taps = n_pre, n_post)
    const float* eff;                    // dense block from a train: its
                                         // effects of this step (scratch)
    const float* gather;                 // dense block: (8, n_post) sums of
                                         // net_dense_gather_kernel
    const float* pre_v;                  // lattice source: pre-step v
    const int* tr_lft;                   // train source planes
    const float* tr_v_th;
    const float* tr_v_rest;
    const float* tr_k;
    const float* tr_dt;
    const float* pre_ntt;                // chemical source: (N, 3) t, m;
    const unsigned char* pre_ntm;        // null for a train without NT
};

struct InConns {
    int n;
    InConn c[NET_MAX_IN];
};

// A train's effect at cell j (network_common.cuh).
__device__ __forceinline__ float train_effect(const InConn& c, size_t j,
                                              int clock)
{
    return train_effect(c.tr_lft, c.tr_v_th, c.tr_v_rest, c.tr_k, c.tr_dt,
                        c.refractoriness, j, clock);
}

__global__ void net_count_kernel(const float* __restrict__ in_deg,
                                 InConns in, float* __restrict__ cnt,
                                 int rows, int cols)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row >= rows || col >= cols) return;
    const size_t n = (size_t)rows * cols;
    const size_t i = (size_t)row * cols + col;
    float c = in_deg[i];
    for (int q = 0; q < in.n; ++q) {
        const InConn& cn = in.c[q];
        // a resample's taps, a dense block's source rows
        const int taps = cn.kind == CONN_ONE2ONE ? 1 : cn.n_taps;
        for (int t = 0; t < taps; ++t)   // integers: exact in any order
            c = c + (cn.mask[(size_t)t * n + i] ? 1.0f : 0.0f);
    }
    cnt[i] = fmaxf(c, 1.0f);
}

// The effects of a train that a dense block reads, once per step.
__global__ void net_effect_kernel(InConn c, float* __restrict__ eff, int n,
                                  int clock)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) eff[i] = train_effect(c, i, clock);
}

// One dense matrix of a flat-mode network: a lattice's intra graph or a
// connection block.  `gather` is (8, n_post): rows 0-3 are a step's sums
// (electrical, then the three chemical types), rows 4-7 the call's
// constants (the weights' column sums, then the three types' counts).
struct DenseJob {
    const float* w;                      // (n_src, n_post)
    const unsigned char* mask;           // (n_src, n_post)
    const float* a;                      // (n_src) electrical sources; null
    const float* t;                      // (n_src, 3) concentrations; null
    const unsigned char* m;              // (n_src, 3) presence; null
    float* gather;
    int n_src, n_post;
    int masked_w;                        // intra graph: W = mask ? W : 0
    int sub;                             // the sources' v is subtracted
};

struct DenseJobs {
    DenseJob j[NET_DENSE_JOBS];
};

enum { GATHER_WA = 0, GATHER_CHEM = 1, GATHER_WSUB = 4, GATHER_CNT = 5 };

// The dense sums of every job: per step (constants 0) the electrical and
// chemical sums, once per call (constants 1) the column sums and counts.
__global__ void __launch_bounds__(32 * NET_DENSE_SEG)
net_dense_gather_kernel(DenseJobs jobs, int constants)
{
    __shared__ float part[4][NET_DENSE_SEG][32];
    const DenseJob& J = jobs.j[blockIdx.y];
    if ((int)blockIdx.x * 32 >= J.n_post) return;      // the whole block
    const int tx = threadIdx.x;
    const int k = threadIdx.y;
    const int j = blockIdx.x * 32 + tx;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (j < J.n_post) {
        for (int i = k; i < J.n_src; i += NET_DENSE_SEG) {
            const size_t e = (size_t)i * J.n_post + j;
            const float wv = J.w[e];
            const bool mk = J.mask[e] != 0;
            const float w = J.masked_w && !mk ? 0.0f : wv;
            if (constants) {
                if (J.sub) acc[0] = acc[0] + w;
                if (J.m) {
                    const float cm = mk ? 1.0f : 0.0f;
                    for (int q = 0; q < CHEM_TYPES; ++q)
                        acc[1 + q] = acc[1 + q]
                            + (J.m[CHEM_TYPES * i + q] ? 1.0f : 0.0f) * cm;
                }
            } else {
                if (J.a) acc[0] = acc[0] + J.a[i] * w;
                if (J.t) {
                    for (int q = 0; q < CHEM_TYPES; ++q) {
                        const float mq = J.m[CHEM_TYPES * i + q] ? 1.0f : 0.0f;
                        acc[1 + q] = acc[1 + q]
                            + (J.t[CHEM_TYPES * i + q] * mq) * w;
                    }
                }
            }
        }
    }
    for (int q = 0; q < 4; ++q) part[q][k][tx] = acc[q];
    __syncthreads();
    if (k < 4 && j < J.n_post) {
        float total = 0.0f;
        for (int seg = 0; seg < NET_DENSE_SEG; ++seg)
            total = total + part[k][seg][tx];
        J.gather[(size_t)((constants ? GATHER_WSUB : GATHER_WA) + k)
                 * J.n_post + j] = total;
    }
}

// A lattice's dense intra graph (flat mode; null gather: none): the sums of
// net_dense_gather_kernel, (8, cols), and the in-degree that re-expands
// the electrical sum.
struct DenseIntra {
    const float* gather;
    const float* in_deg;
};

// Phase A's electrical input of cell (row, col): gap * total / cnt.
template <int MODEL>
__device__ __forceinline__ float electrical_input(
    const float* __restrict__ v_in, float v,
    const float* __restrict__ weights, const float* __restrict__ cnt,
    const Params& P, const Stencil& st, const DenseIntra& dn,
    const InConns& in, int row, int col, int rows, int cols, size_t i,
    int clock)
{
    const size_t n = (size_t)rows * cols;
    float total;
    if (dn.gather) {
        const float wa = dn.gather[(size_t)GATHER_WA * n + i];
        const float wsub = dn.gather[(size_t)GATHER_WSUB * n + i];
        const float d = fmaxf(dn.in_deg[i], 1.0f);
        total = (wa - v * wsub) / d * d;
    } else {
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
        total = acc - v * wsum;
    }
    for (int q = 0; q < in.n; ++q) {
        const InConn& c = in.c[q];
        if (c.kind == CONN_DENSE) {
            // the v term's weight sum is 0 from a train
            total = total + (c.gather[(size_t)GATHER_WA * n + i]
                             - v * c.gather[(size_t)GATHER_WSUB * n + i]);
            continue;
        }
        if (c.kind == CONN_ONE2ONE) {
            const float mw = (c.mask[i] ? 1.0f : 0.0f) * c.w[i];
            total = total + mw * (c.pre_is_st ? train_effect(c, i, clock)
                                              : c.pre_v[i] - v);
            continue;
        }
        float tacc = 0.0f;
        for (int t = 0; t < c.n_taps; ++t) {
            const int sr = resample_index(c.fr, row, c.taps[2 * t]);
            const int sc = resample_index(c.fc, col, c.taps[2 * t + 1]);
            const bool inb = sr >= 0 && sr < c.R1 && sc >= 0 && sc < c.C1;
            const size_t j = (size_t)sr * c.C1 + sc;
            const float wt = c.w[(size_t)t * n + i];
            if (c.pre_is_st) {
                tacc = tacc + wt * (inb ? train_effect(c, j, clock) : 0.0f);
            } else {
                const float a = inb ? c.pre_v[j] : 0.0f;
                const float sub = inb ? 1.0f : 0.0f;
                tacc = tacc + wt * (a - sub * v);
            }
        }
        total = total + tacc;
    }
    return P.p[gap_param<MODEL>()][i] * total / cnt[i];
}

template <int MODEL>
__global__ void net_cell_kernel(
    const float* __restrict__ v_in, const float* __restrict__ w_in,
    const int* __restrict__ lft_in, const float* __restrict__ refr_in,
    float* __restrict__ v_out, float* __restrict__ w_out,
    int* __restrict__ lft_out, float* __restrict__ refr_out,
    unsigned char* __restrict__ spk_out,
    float* __restrict__ v_pre_out,         // null unless emitting
    const float* __restrict__ weights, const float* __restrict__ cnt,
    Params P, Stencil st, DenseIntra dn, InConns in, int rows, int cols,
    int clock)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row >= rows || col >= cols) return;
    const size_t i = (size_t)row * cols + col;

    const float v = v_in[i];
    const float w = w_in[i];
    const float i_syn = electrical_input<MODEL>(v_in, v, weights, cnt, P, st,
                                                dn, in, row, col, rows, cols,
                                                i, clock);
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

// One lattice's chemical fields for a step, (N, 3) unless noted
// (ops/network_kernels.py _chem_pointers).
struct ChemLat {
    const float* ntt_in;                 // the previous step's t
    float* ntt_out;                      // this step's
    float* recr;                         // gating values, in place
    float* recr2;                        // DopaGluGABA's second slot
    float* cur;                          // currents, written on the last step
    float* inh;                          // (N,) DopaGluGABA modifiers,
    float* nmda;                         // in place
    const unsigned char* ntm;
    const unsigned char* recm;
    const float* ntp[3];                 // NT_PARAM_KEYS order
    const float* kin[2];                 // REC_KIN_KEYS order
    const float* kin2[2];                // of recr2
    const float* rp[9];                  // DOPA_PLANES (N,), or g, e, mg
};

struct ChemKinds {
    int fam, rec, nt, elec;
};

// Phases A, A', B' and B of one cell of a chemical network (the chemical
// form of pallas_reward.py _make_kernel, :653-832); Izhikevich and ALIF.
template <int MODEL>
__global__ void net_chem_cell_kernel(
    const float* __restrict__ v_in, const float* __restrict__ w_in,
    const int* __restrict__ lft_in, const float* __restrict__ refr_in,
    float* __restrict__ v_out, float* __restrict__ w_out,
    int* __restrict__ lft_out, float* __restrict__ refr_out,
    unsigned char* __restrict__ spk,       // the previous step's, then this
    float* __restrict__ v_pre_out,         // null unless emitting
    const float* __restrict__ weights, const unsigned char* __restrict__ emask,
    const float* __restrict__ cnt, Params P, Stencil st, DenseIntra dn,
    InConns in, ChemLat C, ChemKinds K, int rows, int cols, int clock,
    int last)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row >= rows || col >= cols) return;
    const size_t n = (size_t)rows * cols;
    const size_t i = (size_t)row * cols + col;
    const size_t i3 = (size_t)CHEM_TYPES * i;

    const float v = v_in[i];
    const float w = w_in[i];
    const float i_syn = K.elec
        ? electrical_input<MODEL>(v_in, v, weights, cnt, P, st, dn, in, row,
                                  col, rows, cols, i, clock)
        : 0.0f;

    // A'. the chemical input per type: the intra sums and counts,
    // re-expanded, then the incoming connections in plan order
    float sums[CHEM_TYPES] = {0.0f, 0.0f, 0.0f};
    float gcnt[CHEM_TYPES] = {0.0f, 0.0f, 0.0f};
    for (int o = 0; o < st.n; ++o) {
        const int sr = row + st.dr[o];
        const int sc = col + st.dc[o];
        if (sr < 0 || sr >= rows || sc < 0 || sc >= cols) continue;
        const size_t e = (size_t)o * n + i;
        const float wo = weights[e];
        const float em = emask[e] ? 1.0f : 0.0f;
        const size_t j3 = (size_t)CHEM_TYPES * ((size_t)sr * cols + sc);
        for (int q = 0; q < CHEM_TYPES; ++q) {
            const float mq = C.ntm[j3 + q] ? 1.0f : 0.0f;
            sums[q] = sums[q] + wo * (C.ntt_in[j3 + q] * mq);
            gcnt[q] = gcnt[q] + em * mq;
        }
    }
    if (dn.gather) {
        for (int q = 0; q < CHEM_TYPES; ++q) {
            sums[q] = dn.gather[(size_t)(GATHER_CHEM + q) * n + i];
            gcnt[q] = dn.gather[(size_t)(GATHER_CNT + q) * n + i];
        }
    }
    float csum[CHEM_TYPES], ccnt[CHEM_TYPES];
    for (int q = 0; q < CHEM_TYPES; ++q) {
        const float g1 = fmaxf(gcnt[q], 1.0f);
        csum[q] = sums[q] / g1 * g1 * (gcnt[q] > 0.0f ? 1.0f : 0.0f);
        ccnt[q] = gcnt[q];
    }
    for (int c = 0; c < in.n; ++c) {
        const InConn& cn = in.c[c];
        if (!cn.pre_ntm) continue;         // a train without NT
        if (cn.kind == CONN_DENSE) {
            for (int q = 0; q < CHEM_TYPES; ++q) {
                csum[q] = csum[q]
                    + cn.gather[(size_t)(GATHER_CHEM + q) * n + i];
                ccnt[q] = ccnt[q]
                    + cn.gather[(size_t)(GATHER_CNT + q) * n + i];
            }
            continue;
        }
        if (!cn.mask[i]) continue;
        for (int q = 0; q < CHEM_TYPES; ++q) {
            const float m = cn.pre_ntm[i3 + q] ? 1.0f : 0.0f;
            csum[q] = csum[q] + cn.w[i] * cn.pre_ntt[i3 + q] * m;
            ccnt[q] = ccnt[q] + m;
        }
    }
    float t_in[CHEM_TYPES];
    bool upd[CHEM_TYPES];
    for (int q = 0; q < CHEM_TYPES; ++q) {
        t_in[q] = csum[q] / fmaxf(ccnt[q], 1.0f);
        upd[q] = ccnt[q] > 0.0f && C.recm[i3 + q];
    }

    // B'. receptor kinetics, then the currents at the pre-update v
    const bool izh = MODEL == MODEL_IZHIKEVICH;
    const float dt = P.p[izh ? izh::dt : alif::dt][i];
    const float dt_cm = dt / P.p[izh ? izh::c_m : alif::c_m][i];
    const float ex = kernel_exp(-0.062f * v);
    float r[CHEM_TYPES], cur[CHEM_TYPES], rec_dv;
    for (int q = 0; q < CHEM_TYPES; ++q) {
        r[q] = C.recr[i3 + q];
        if (upd[q])
            r[q] = rec_kinetics(K.rec, r[q], t_in[q], opt(C.kin[0], i3 + q),
                                opt(C.kin[1], i3 + q), dt);
        C.recr[i3 + q] = r[q];
    }
    if (K.fam == FAM_DOPAGLUGABA) {
        float r2[CHEM_TYPES];
        for (int q = 0; q < CHEM_TYPES; ++q) {
            r2[q] = C.recr2[i3 + q];
            if (upd[q])
                r2[q] = rec_kinetics(K.rec, r2[q], t_in[q],
                                     opt(C.kin2[0], i3 + q),
                                     opt(C.kin2[1], i3 + q), dt);
            C.recr2[i3 + q] = r2[q];
        }
        // DOPA_PLANES: g_ampa, g_nmda, e_ampa, e_nmda, mg, g_gaba, e_gaba,
        // s_d1, s_d2; the modifiers are the previous step's
        const float* const* rp = C.rp;
        const float inh = C.inh[i];
        const float block = 1.0f / (1.0f + ex * rp[4][i] / 3.57f);
        float glu = inh * rp[0][i] * r[0] * (v - rp[2][i])
            + block * inh * rp[1][i] * kernel_pow(r2[0], C.nmda[i])
            * (v - rp[3][i]);
        if (!C.recm[i3]) glu = 0.0f;
        float gaba = rp[5][i] * r[1] * (v - rp[6][i]);
        if (!C.recm[i3 + 1]) gaba = 0.0f;
        if (C.recm[i3 + 2]) {
            C.inh[i] = 1.0f - r2[2] * rp[8][i];
            C.nmda[i] = 1.0f - r[2] * rp[7][i];
        }
        cur[0] = glu;
        cur[1] = gaba;
        cur[2] = 0.0f;
        rec_dv = (glu + gaba) * dt_cm;
    } else {
        // g, e, mg per type; the NMDA block at 3.75
        const float block = 1.0f / (1.0f + ex * C.rp[2][i3 + 1] / 3.75f);
        for (int q = 0; q < CHEM_TYPES; ++q) {
            float c = C.rp[0][i3 + q] * r[q] * (v - C.rp[1][i3 + q]);
            if (q == 1) c = c * block;
            cur[q] = C.recm[i3 + q] ? c : 0.0f;
        }
        rec_dv = (cur[0] + cur[1] + cur[2]) * dt_cm;
    }

    // B. the model step less rec_dv, then the release from the pre-reset
    // v and the previous step's spike flag
    const bool refractory = MODEL != MODEL_IZHIKEVICH;
    float v_pre, v_new, w_new, refr_new;
    bool spike;
    model_step<MODEL>(P.p, i, v, w, refractory ? refr_in[i] : 0.0f, i_syn,
                      v_pre, v_new, w_new, refr_new, spike, rec_dv);
    const float spk_prev = spk[i] ? 1.0f : 0.0f;
    for (int q = 0; q < CHEM_TYPES; ++q) {
        const float t = nt_release(K.nt, C.ntt_in[i3 + q], v_pre, spk_prev,
                                   C.ntp[0][i3 + q], opt(C.ntp[1], i3 + q),
                                   opt(C.ntp[2], i3 + q), dt);
        C.ntt_out[i3 + q] = C.ntm[i3 + q] ? t : 0.0f;
        if (last) C.cur[i3 + q] = cur[q];
    }
    v_out[i] = v_new;
    w_out[i] = w_new;
    if (refractory) refr_out[i] = refr_new;
    lft_out[i] = spike ? clock : lft_in[i];
    spk[i] = spike ? 1 : 0;
    if (v_pre_out) v_pre_out[i] = v_pre;
}

// STDP on one connection's weights, one thread per post cell.  lft_pre is
// the pre lattice's post-step lft (or a train's previous one); spk_pre is
// read only when the pre lattice is plastic.  A resample slot whose pre
// cell is off the grid reads lft 0 and spike 0, as the TPU kernel's zero
// padding does; the mask holds no such slot.  The visit count is
//   count = static + pre_plastic * spk_pre + post_plastic * spk_post,
// where `static` (reward networks) counts the endpoints that visit every
// step.  A reward connection (`tr` not null) takes, per masked slot, up to
// two R-STDP visits of (w, c, dw, counter) with the delta of the reward
// rule `rr` and the step's dopamine *dop: the first where count >= 1, the
// second where count >= 2.
struct ConnTraces {
    float* c;
    float* dw;
    int* counter;
    const float* dop;
};

__global__ void net_conn_edge_kernel(
    float* __restrict__ w, const unsigned char* __restrict__ mask,
    const int* __restrict__ taps, int kind,
    const int* __restrict__ lft_pre, const unsigned char* __restrict__ spk_pre,
    const int* __restrict__ lft_post,
    const unsigned char* __restrict__ spk_post,
    int pre_plastic, int post_plastic, int R1, int C1, int fr, int fc,
    int n_taps, Rule r, int rows, int cols, int static_count,
    ConnTraces tr, Rule rr)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row >= rows || col >= cols) return;
    const size_t n = (size_t)rows * cols;
    const size_t i = (size_t)row * cols + col;
    const int t_post = lft_post[i];
    const float s_post = spk_post[i] ? 1.0f : 0.0f;
    const float dop = tr.c ? *tr.dop : 0.0f;
    for (int t = 0; t < n_taps; ++t) {
        const size_t e = (size_t)t * n + i;
        if (!mask[e]) continue;
        int t_pre = 0;
        float s_pre = 0.0f;
        if (kind == CONN_ONE2ONE) {
            t_pre = lft_pre[i];
            if (pre_plastic) s_pre = spk_pre[i] ? 1.0f : 0.0f;
        } else {
            const int sr = resample_index(fr, row, taps[2 * t]);
            const int sc = resample_index(fc, col, taps[2 * t + 1]);
            if (sr >= 0 && sr < R1 && sc >= 0 && sc < C1) {
                const size_t j = (size_t)sr * C1 + sc;
                t_pre = lft_pre[j];
                if (pre_plastic) s_pre = spk_pre[j] ? 1.0f : 0.0f;
            }
        }
        float count = (float)static_count;
        if (pre_plastic) count = count + s_pre;
        if (post_plastic) count = count + s_post;
        if (!tr.c) {
            w[e] = w[e] + stdp_delta(t_pre, t_post, r) * count;
            continue;
        }
        const float delta = stdp_delta(t_pre, t_post, rr);
        float wv = w[e];
        float c = tr.c[e];
        float dw = tr.dw[e];
        int ct = tr.counter[e];
        if (count >= 1.0f) rstdp_visit(wv, c, dw, ct, delta, dop, rr);
        if (count >= 2.0f) rstdp_visit(wv, c, dw, ct, delta, dop, rr);
        w[e] = wv;
        tr.c[e] = c;
        tr.dw[e] = dw;
        tr.counter[e] = ct;
    }
}

// A train's neurotransmitter release (kind -1: none): (N, 3) t updated in
// place, its mask and NT_PARAM_KEYS parameters.
struct TrainNT {
    int kind;
    const float* v_th;
    const float* v_rest;
    float* ntt;
    const unsigned char* ntm;
    const float* p[3];
};

__global__ void net_train_kernel(
    int kind, int* __restrict__ lft, float* __restrict__ step,
    unsigned char* __restrict__ spk, const float* __restrict__ u,
    const float* __restrict__ chance, const float* __restrict__ rate,
    const float* __restrict__ dt, int n, int clock, TrainNT nt)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    bool s;
    if (kind == TRAIN_POISSON) {
        s = u[i] <= chance[i];
    } else {
        const float stepped = step[i] + dt[i];
        s = rate[i] != 0.0f && stepped >= rate[i];
        step[i] = s ? 0.0f : stepped;
    }
    if (s) lft[i] = clock;
    spk[i] = s ? 1 : 0;
    if (nt.kind < 0) return;
    // released after the new spike, from v_th or v_resting
    const float v = s ? nt.v_th[i] : nt.v_rest[i];
    const float sf = s ? 1.0f : 0.0f;
    for (int q = 0; q < CHEM_TYPES; ++q) {
        const size_t iq = (size_t)CHEM_TYPES * i + q;
        const float t = nt_release(nt.kind, nt.ntt[iq], v, sf, nt.p[0][iq],
                                   opt(nt.p[1], iq), opt(nt.p[2], iq),
                                   dt[i]);
        nt.ntt[iq] = nt.ntm[iq] ? t : 0.0f;
    }
}

template <int MODEL>
static cudaError_t launch_net_cell(dim3 grid, dim3 block, cudaStream_t s,
                                   void* const* in, void* const* out,
                                   unsigned char* spk, float* v_pre,
                                   const float* weights, const float* cnt,
                                   const Params& P, const Stencil& st,
                                   const DenseIntra& dn, const InConns& ic,
                                   int rows, int cols, int clock)
{
    net_cell_kernel<MODEL><<<grid, block, 0, s>>>(
        (const float*)in[0], (const float*)in[1], (const int*)in[2],
        (const float*)in[3], (float*)out[0], (float*)out[1], (int*)out[2],
        (float*)out[3], spk, v_pre, weights, cnt, P, st, dn, ic, rows, cols,
        clock);
    return cudaGetLastError();
}

template <int MODEL>
static cudaError_t launch_net_chem_cell(dim3 grid, dim3 block,
                                        cudaStream_t s, void* const* in,
                                        void* const* out, unsigned char* spk,
                                        float* v_pre, const float* weights,
                                        const unsigned char* emask,
                                        const float* cnt, const Params& P,
                                        const Stencil& st,
                                        const DenseIntra& dn,
                                        const InConns& ic,
                                        const ChemLat& C, const ChemKinds& K,
                                        int rows, int cols, int clock,
                                        int last)
{
    net_chem_cell_kernel<MODEL><<<grid, block, 0, s>>>(
        (const float*)in[0], (const float*)in[1], (const int*)in[2],
        (const float*)in[3], (float*)out[0], (float*)out[1], (int*)out[2],
        (float*)out[3], spk, v_pre, weights, emask, cnt, P, st, dn, ic, C, K,
        rows, cols, clock, last);
    return cudaGetLastError();
}

// One lattice's chemical fields from its NLC_P pointers (the concentration
// sets are chosen per step).
static ChemLat chem_lat(void* const* c)
{
    ChemLat C;
    C.ntt_in = (const float*)c[0];
    C.ntt_out = (float*)c[1];
    C.recr = (float*)c[3];
    C.recr2 = (float*)c[4];
    C.cur = (float*)c[5];
    C.inh = (float*)c[6];
    C.nmda = (float*)c[7];
    C.ntm = (const unsigned char*)c[8];
    C.recm = (const unsigned char*)c[9];
    for (int q = 0; q < 3; ++q) C.ntp[q] = (const float*)c[10 + q];
    for (int q = 0; q < 2; ++q) {
        C.kin[q] = (const float*)c[13 + q];
        C.kin2[q] = (const float*)c[15 + q];
    }
    for (int q = 0; q < 9; ++q) C.rp[q] = (const float*)c[17 + q];
    return C;
}

// One launch of net_dense_gather_kernel per NET_DENSE_JOBS jobs.
static cudaError_t launch_dense_gather(const DenseJob* jobs, int n_jobs,
                                       int constants, cudaStream_t s)
{
    cudaError_t err = cudaSuccess;
    for (int j0 = 0; j0 < n_jobs && err == cudaSuccess;
         j0 += NET_DENSE_JOBS) {
        DenseJobs batch = {};
        const int nb = n_jobs - j0 < NET_DENSE_JOBS ? n_jobs - j0
                                                     : NET_DENSE_JOBS;
        int widest = 0;
        for (int b = 0; b < nb; ++b) {
            batch.j[b] = jobs[j0 + b];
            if (batch.j[b].n_post > widest) widest = batch.j[b].n_post;
        }
        net_dense_gather_kernel<<<dim3((widest + 31) / 32, nb),
                                  dim3(32, NET_DENSE_SEG), 0, s>>>(
            batch, constants);
        err = cudaGetLastError();
    }
    return err;
}

static dim3 grid_of(dim3 block, int rows, int cols)
{
    return dim3((cols + block.x - 1) / block.x,
                (rows + block.y - 1) / block.y);
}

extern "C" {

// NET_MAX_IN, LP_MAX_OFFSETS, NET_MAX_TAPS, the eight strides,
// NET_DENSE_MAX and NET_DENSE_SEG, in order.
void net_limits(int* out)
{
    const int v[13] = {NET_MAX_IN, LP_MAX_OFFSETS, NET_MAX_TAPS, NL_I, NL_P,
                       NT_I, NT_P, NC_I, NC_P, NLC_P, NTC_P, NET_DENSE_MAX,
                       NET_DENSE_SEG};
    for (int q = 0; q < 13; ++q) out[q] = v[q];
}

// Runs n_steps network steps from clock0 on `stream`.  Flat descriptions
// (host memory), one record per member:
//   lattice ints (NL_I): model, kind (0 plain, 1 plastic: STDP, 2 mod:
//     R-STDP), rows, cols, n_off, n_params, emit,
//     dense (1: rows is 1, n_off 0, weights and mask are (cols, cols)),
//     dr[LP_MAX_OFFSETS], dc[LP_MAX_OFFSETS];
//   lattice pointers (NL_P): v, w, lft, refr (inputs, only read); buffer
//     set 0 v, w, lft, refr; set 1 v, w, lft, refr; spikes (bytes, the last
//     step's at the end); v_pre (n_steps planes, or null); in_deg; cnt
//     (scratch); weights (updated in place when plastic); mask (bytes);
//     then n_params parameter planes in MODEL_PARAM_KEYS order.  refr and
//     its buffers are null for Izhikevich; weights and mask for n_off 0
//     without a dense graph.  Pointer 32: a dense graph's (8, cols) floats
//     of scratch for net_dense_gather_kernel; 33-35: a mod lattice's
//     traces c, dw (floats) and counter (ints) shaped like its weights,
//     updated in place.
//     Step k writes set k % 2, so the result is in set (n_steps - 1) % 2.
//   train ints (NT_I): kind, refractoriness, rows, cols, NT kinetics
//     (-1: the train releases no neurotransmitter);
//   train pointers (NT_P): lft (updated in place), v_th, v_resting,
//     refractoriness k, dt, chance, uniforms (n_steps planes), rate, step
//     (updated in place), spikes (bytes); chance and uniforms Poisson only,
//     rate and step Rate only.
//   connection ints (NC_I): kind, pre_is_st, pre, post, pre_plastic,
//     post_plastic, R1, C1, fr, fc, n_taps (1 for one-to-one, n_pre for a
//     dense block), static (the endpoints that visit every step), reward
//     (1: an R-STDP connection);
//   connection pointers (NC_P): w (updated in place when an endpoint is
//     plastic), mask (bytes), then a resample's taps (device (dr, dc)
//     ints) or, for a dense block that reads a train, n_pre floats of
//     scratch for the train's effects, then a dense block's (8, n_post)
//     floats of scratch for net_dense_gather_kernel, then a reward
//     connection's traces c, dw and counter, updated in place.
// rule = {a_plus, a_minus, tau_plus, tau_minus, dt}: STDP.  The reward arm:
//   rrule = {a_plus, a_minus, tau_plus, tau_minus, dt, tau_c, exp_dc,
//     tau_d, exp_dd} (the R-STDP rule, null without mod lattices and
//     reward connections); dop_in (device, one float) the dopamine before
//   the call; with_reward: `rewards` (host, n_steps floats) move it, and
//   dop_steps (device, n_steps floats) receives each step's, which step k's
//   visits read (without: *dop_in).  The chemical arm:
//   chem_i = {family (-1: none), receptor kinetics, NT kinetics,
//     electrical}; the spikes start as the previous step's;
//   lattice chemical pointers (NLC_P, ops/network_kernels.py
//     _chem_pointers): t in, t sets 0 and 1, r, r2, currents, inh and
//     nmda modifiers, nt$mask, rec$mask, NT parameters [3], kinetics
//     parameters [2], r2 kinetics parameters [2], current parameters [9];
//   train chemical pointers (NTC_P): t (updated in place), nt$mask, NT
//     parameters [3].
// Returns the first CUDA error, 0 if none.
int net_steps(int n_lat, const int* lat_i, void* const* lat_p,
              int n_tr, const int* tr_i, void* const* tr_p,
              int n_cn, const int* cn_i, void* const* cn_p,
              const float* rule, int clock0, int n_steps, const int* chem_i,
              void* const* lat_c, void* const* tr_c, const float* rrule,
              int with_reward, const float* rewards, const float* dop_in,
              float* dop_steps, void* stream)
{
    const ChemKinds K = {chem_i[0], chem_i[1], chem_i[2], chem_i[3]};
    const bool chem = K.fam >= 0;
    static const int n_params_of[3] = {9, 13, 10};
    if (n_lat <= 0 || n_tr < 0 || n_cn < 0 || n_steps <= 0)
        return (int)cudaErrorInvalidValue;
    for (int k = 0; k < n_lat; ++k) {
        const int* li = lat_i + NL_I * k;
        void* const* lp = lat_p + NL_P * k;
        if (li[0] < 0 || li[0] > 2 || li[1] < KIND_PLAIN || li[1] > KIND_MOD
            || li[2] <= 0 || li[3] <= 0
            || li[4] < 0 || li[4] > LP_MAX_OFFSETS || li[5] != n_params_of[li[0]]
            || (li[0] != MODEL_IZHIKEVICH && !lp[3])
            || ((li[4] > 0 || li[7]) && (!lp[16] || !lp[17]))
            || (li[7] && !lp[32])
            || (li[7] && (li[1] || li[2] != 1 || li[3] > NET_DENSE_MAX
                          || li[4] != 0))
            || (li[1] == KIND_MOD
                && (chem || li[7] || !rrule || !dop_in
                    || (li[4] > 0 && (!lp[33] || !lp[34] || !lp[35])))))
            return (int)cudaErrorInvalidValue;
        void* const* lc = lat_c + NLC_P * k;
        if (chem && (li[0] == MODEL_LIF || !lc[0] || !lc[1] || !lc[2]
                     || !lc[3] || !lc[5] || !lc[8] || !lc[9] || !lc[10]
                     || (K.fam == FAM_DOPAGLUGABA
                         && (!lc[4] || !lc[6] || !lc[7]))))
            return (int)cudaErrorInvalidValue;
    }
    if (chem && (K.fam > FAM_DOPAGLUGABA || K.rec < 0
                 || K.rec > REC_EXP_DECAY || K.nt < 0
                 || K.nt > NT_DESTEXHE))
        return (int)cudaErrorInvalidValue;
    for (int j = 0; j < n_tr; ++j) {
        const int nt = tr_i[NT_I * j + 4];
        if (nt >= 0 && (!chem || nt > NT_DESTEXHE || !tr_c[NTC_P * j]
                        || !tr_c[NTC_P * j + 1] || !tr_c[NTC_P * j + 2]))
            return (int)cudaErrorInvalidValue;
    }
    int n_in[256] = {0};
    if (n_lat > 256) return (int)cudaErrorInvalidValue;
    for (int q = 0; q < n_cn; ++q) {
        const int* ci = cn_i + NC_I * q;
        const int pre_max = ci[1] ? n_tr : n_lat;
        if (ci[0] < 0 || ci[0] > CONN_DENSE || ci[2] < 0 || ci[2] >= pre_max
            || ci[3] < 0 || ci[3] >= n_lat || (ci[1] && ci[4])
            || ++n_in[ci[3]] > NET_MAX_IN || ci[11] < 0
            || (ci[12] && (chem || ci[0] == CONN_DENSE || !rrule || !dop_in
                           || !cn_p[NC_P * q + 4] || !cn_p[NC_P * q + 5]
                           || !cn_p[NC_P * q + 6]))
            || (ci[0] == CONN_RESAMPLE
                && (chem || ci[10] <= 0 || ci[10] > NET_MAX_TAPS || !ci[8]
                    || !ci[9] || !cn_p[NC_P * q + 2]))
            || (ci[0] == CONN_DENSE
                && (ci[4] || ci[5] || ci[11] || ci[10] <= 0
                    || ci[10] > NET_DENSE_MAX
                    || lat_i[NL_I * ci[3] + 2] != 1
                    || !cn_p[NC_P * q + 1] || !cn_p[NC_P * q + 3]
                    || (ci[1] && !cn_p[NC_P * q + 2]))))
            return (int)cudaErrorInvalidValue;
    }
    if (with_reward && (!rrule || !rewards || !dop_in || !dop_steps))
        return (int)cudaErrorInvalidValue;
    const float* rf = rule;
    const Rule r = {rf[0], rf[1], rf[2], rf[3], rf[4], 0.0f, 0.0f};
    const Rule rr = rrule ? Rule{rrule[0], rrule[1], rrule[2], rrule[3],
                                 rrule[4], rrule[5], rrule[6]}
                          : Rule{};
    const dim3 block(32, 8);
    // a (1, N) row: one warp per block, spread over the SMs
    const dim3 row_block(32, 1);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;

    // per-lattice stencils, parameters and incoming connections (the
    // lattice sources' v pointers are set per step), then cnt
    Stencil* st = new Stencil[n_lat];
    Params* P = new Params[n_lat];
    InConns* ic = new InConns[n_lat];
    DenseIntra* dn = new DenseIntra[n_lat];
    // the dense jobs, lattices' intra graphs first, and each one's source:
    // a lattice, or (negative) train -1 - index
    DenseJob* jobs = new DenseJob[n_lat + n_cn];
    int* job_src = new int[n_lat + n_cn];
    int n_jobs = 0;
    const bool elec = !chem || K.elec;
    int* src_of = new int[n_lat * NET_MAX_IN];   // pre lattice, or -1
    for (int k = 0; k < n_lat; ++k) {
        const int* li = lat_i + NL_I * k;
        void* const* lp = lat_p + NL_P * k;
        st[k].n = li[4];
        for (int o = 0; o < LP_MAX_OFFSETS; ++o) {
            st[k].dr[o] = li[8 + o];
            st[k].dc[o] = li[8 + LP_MAX_OFFSETS + o];
        }
        for (int q = 0; q < LP_MAX_PARAMS; ++q)
            P[k].p[q] = q < li[5] ? (const float*)lp[18 + q] : nullptr;
        ic[k].n = 0;
        dn[k].gather = li[7] ? (const float*)lp[32] : nullptr;
        dn[k].in_deg = (const float*)lp[14];
        if (li[7]) {
            DenseJob& J = jobs[n_jobs];
            J = DenseJob{};
            J.w = (const float*)lp[16];
            J.mask = (const unsigned char*)lp[17];
            J.m = chem ? (const unsigned char*)lat_c[NLC_P * k + 8] : nullptr;
            J.gather = (float*)lp[32];
            J.n_src = J.n_post = li[3];
            J.masked_w = J.sub = 1;
            job_src[n_jobs++] = k;
        }
    }
    for (int q = 0; q < n_cn; ++q) {
        const int* ci = cn_i + NC_I * q;
        void* const* cp = cn_p + NC_P * q;
        const int post = ci[3];
        InConn& c = ic[post].c[ic[post].n];
        src_of[post * NET_MAX_IN + ic[post].n] = ci[1] ? -1 : ci[2];
        ic[post].n += 1;
        c.kind = ci[0];
        c.pre_is_st = ci[1];
        c.R1 = ci[6];
        c.C1 = ci[7];
        c.fr = ci[8];
        c.fc = ci[9];
        c.n_taps = ci[10];
        c.taps = ci[0] == CONN_RESAMPLE ? (const int*)cp[2] : nullptr;
        c.eff = ci[0] == CONN_DENSE ? (const float*)cp[2] : nullptr;
        c.gather = ci[0] == CONN_DENSE ? (const float*)cp[3] : nullptr;
        c.w = (const float*)cp[0];
        c.mask = (const unsigned char*)cp[1];
        c.pre_v = nullptr;
        c.refractoriness = 0;
        c.tr_lft = nullptr;
        c.tr_v_th = c.tr_v_rest = c.tr_k = c.tr_dt = nullptr;
        c.pre_ntt = nullptr;
        c.pre_ntm = nullptr;
        if (chem && ci[1] && tr_i[NT_I * ci[2] + 4] >= 0) {
            c.pre_ntt = (const float*)tr_c[NTC_P * ci[2]];
            c.pre_ntm = (const unsigned char*)tr_c[NTC_P * ci[2] + 1];
        } else if (chem && !ci[1]) {
            c.pre_ntm = (const unsigned char*)lat_c[NLC_P * ci[2] + 8];
        }
        if (ci[0] == CONN_DENSE) {
            DenseJob& J = jobs[n_jobs];
            J = DenseJob{};
            J.w = c.w;
            J.mask = c.mask;
            J.m = c.pre_ntm;
            J.gather = (float*)cp[3];
            J.n_src = ci[10];
            J.n_post = lat_i[NL_I * post + 3];
            J.sub = !ci[1];
            J.a = ci[1] && elec ? c.eff : nullptr;   // a train's effects
            job_src[n_jobs++] = ci[1] ? -1 - ci[2] : ci[2];
        }
        if (ci[1]) {
            const int* ti = tr_i + NT_I * ci[2];
            void* const* tp = tr_p + NT_P * ci[2];
            c.refractoriness = ti[1];
            c.tr_lft = (const int*)tp[0];
            c.tr_v_th = (const float*)tp[1];
            c.tr_v_rest = (const float*)tp[2];
            c.tr_k = (const float*)tp[3];
            c.tr_dt = (const float*)tp[4];
        }
    }
    err = cudaSuccess;
    for (int k = 0; k < n_lat && err == cudaSuccess; ++k) {
        const int* li = lat_i + NL_I * k;
        void* const* lp = lat_p + NL_P * k;
        const dim3 b = li[2] == 1 ? row_block : block;
        net_count_kernel<<<grid_of(b, li[2], li[3]), b, 0, s>>>(
            (const float*)lp[14], ic[k], (float*)lp[15], li[2], li[3]);
        err = cudaGetLastError();
    }
    // the dense jobs' constants: weight column sums and per-type counts
    if (err == cudaSuccess) err = launch_dense_gather(jobs, n_jobs, 1, s);
    // the dopamine of every step of the call, before the steps
    if (err == cudaSuccess && with_reward)
        err = lp_launch_dopamine(dop_in, rewards, n_steps, rrule[8], rrule[7],
                                 dop_steps, s);

    for (int k = 0; k < n_steps && err == cudaSuccess; ++k) {
        const int clock = clock0 + k;
        // 0. the effects of the trains that dense blocks read
        for (int l = 0; l < n_lat && err == cudaSuccess; ++l) {
            for (int q = 0; q < ic[l].n && err == cudaSuccess; ++q) {
                const InConn& c = ic[l].c[q];
                if (c.kind != CONN_DENSE || !c.pre_is_st) continue;
                net_effect_kernel<<<(c.n_taps + 127) / 128, 128, 0, s>>>(
                    c, (float*)c.eff, c.n_taps, clock);
                err = cudaGetLastError();
            }
        }
        // then the dense sums of the step, from the previous step's set
        for (int b = 0; b < n_jobs; ++b) {
            DenseJob& J = jobs[b];
            const int src = job_src[b];
            if (src < 0) {
                J.t = J.m ? (const float*)tr_c[NTC_P * (-1 - src)] : nullptr;
            } else {
                void* const* pp = lat_p + NL_P * src;
                J.a = !elec ? nullptr : (const float*)
                    (k == 0 ? pp[0] : pp[4 + 4 * ((k - 1) & 1)]);
                void* const* pc = lat_c + NLC_P * src;
                J.t = !J.m ? nullptr : (const float*)
                    (k == 0 ? pc[0] : pc[1 + ((k - 1) & 1)]);
            }
        }
        if (err == cudaSuccess && n_jobs > 0)
            err = launch_dense_gather(jobs, n_jobs, 0, s);
        // 1. phases A and B of every lattice, from the previous step's set
        for (int l = 0; l < n_lat && err == cudaSuccess; ++l) {
            const int* li = lat_i + NL_I * l;
            void* const* lp = lat_p + NL_P * l;
            void* const* in = k == 0 ? lp : lp + 4 + 4 * ((k - 1) & 1);
            void* const* out = lp + 4 + 4 * (k & 1);
            for (int q = 0; q < ic[l].n; ++q) {
                const int pre = src_of[l * NET_MAX_IN + q];
                if (pre < 0) continue;
                void* const* pp = lat_p + NL_P * pre;
                ic[l].c[q].pre_v = (const float*)
                    (k == 0 ? pp[0] : pp[4 + 4 * ((k - 1) & 1)]);
                if (chem) {
                    void* const* pc = lat_c + NLC_P * pre;
                    ic[l].c[q].pre_ntt = (const float*)
                        (k == 0 ? pc[0] : pc[1 + ((k - 1) & 1)]);
                }
            }
            float* v_pre = lp[13] ? (float*)lp[13]
                + (size_t)k * li[2] * li[3] : nullptr;
            const dim3 blk = li[2] == 1 ? row_block : block;
            const dim3 grid = grid_of(blk, li[2], li[3]);
            const float* weights = (const float*)lp[16];
            const float* cnt = (const float*)lp[15];
            unsigned char* spk = (unsigned char*)lp[12];
            if (chem) {
                void* const* lc = lat_c + NLC_P * l;
                ChemLat C = chem_lat(lc);
                C.ntt_in = (const float*)(k == 0 ? lc[0]
                                                 : lc[1 + ((k - 1) & 1)]);
                C.ntt_out = (float*)lc[1 + (k & 1)];
                const unsigned char* emask = (const unsigned char*)lp[17];
                const int last = k == n_steps - 1;
                err = li[0] == MODEL_IZHIKEVICH
                    ? launch_net_chem_cell<MODEL_IZHIKEVICH>(
                          grid, blk, s, in, out, spk, v_pre, weights,
                          emask, cnt, P[l], st[l], dn[l], ic[l], C, K, li[2],
                          li[3], clock, last)
                    : launch_net_chem_cell<MODEL_ALIF>(
                          grid, blk, s, in, out, spk, v_pre, weights,
                          emask, cnt, P[l], st[l], dn[l], ic[l], C, K, li[2],
                          li[3], clock, last);
                continue;
            }
            switch (li[0]) {
            case MODEL_IZHIKEVICH:
                err = launch_net_cell<MODEL_IZHIKEVICH>(
                    grid, blk, s, in, out, spk, v_pre, weights, cnt, P[l],
                    st[l], dn[l], ic[l], li[2], li[3], clock);
                break;
            case MODEL_ALIF:
                err = launch_net_cell<MODEL_ALIF>(
                    grid, blk, s, in, out, spk, v_pre, weights, cnt, P[l],
                    st[l], dn[l], ic[l], li[2], li[3], clock);
                break;
            default:
                err = launch_net_cell<MODEL_LIF>(
                    grid, blk, s, in, out, spk, v_pre, weights, cnt, P[l],
                    st[l], dn[l], ic[l], li[2], li[3], clock);
            }
        }
        // 2. STDP on the plastic lattices' stencil weights, then the
        // R-STDP double visit on the mod lattices' weights and traces
        const float* dop = with_reward ? dop_steps + k : dop_in;
        for (int l = 0; l < n_lat && err == cudaSuccess; ++l) {
            const int* li = lat_i + NL_I * l;
            void* const* lp = lat_p + NL_P * l;
            if (li[1] == KIND_PLAIN || li[4] == 0) continue;
            const int* lft = (const int*)lp[4 + 4 * (k & 1) + 2];
            const unsigned char* spk = (const unsigned char*)lp[12];
            err = li[1] == KIND_PLASTIC
                ? lp_launch_stdp_edge(lft, spk, (float*)lp[16],
                                      (const unsigned char*)lp[17], r, st[l],
                                      li[2], li[3], s)
                : lp_launch_rstdp_edge(lft, spk, (float*)lp[16],
                                       (const unsigned char*)lp[17],
                                       (float*)lp[33], (float*)lp[34],
                                       (int*)lp[35], dop, rr, st[l], li[2],
                                       li[3], s);
        }
        // 3. STDP on the connections with a plastic endpoint or static
        // visits, and the reward connections' R-STDP visits
        for (int q = 0; q < n_cn && err == cudaSuccess; ++q) {
            const int* ci = cn_i + NC_I * q;
            void* const* cp = cn_p + NC_P * q;
            if (!ci[4] && !ci[5] && !ci[11] && !ci[12]) continue;
            const ConnTraces tr = ci[12]
                ? ConnTraces{(float*)cp[4], (float*)cp[5], (int*)cp[6], dop}
                : ConnTraces{nullptr, nullptr, nullptr, nullptr};
            void* const* post = lat_p + NL_P * ci[3];
            const int* post_i = lat_i + NL_I * ci[3];
            const int* lft_pre;
            const unsigned char* spk_pre = nullptr;
            if (ci[1]) {
                lft_pre = (const int*)tr_p[NT_P * ci[2]];
            } else {
                void* const* pre = lat_p + NL_P * ci[2];
                lft_pre = (const int*)pre[4 + 4 * (k & 1) + 2];
                spk_pre = (const unsigned char*)pre[12];
            }
            net_conn_edge_kernel<<<grid_of(block, post_i[2], post_i[3]),
                                   block, 0, s>>>(
                (float*)cp[0], (const unsigned char*)cp[1],
                (const int*)cp[2], ci[0], lft_pre, spk_pre,
                (const int*)post[4 + 4 * (k & 1) + 2],
                (const unsigned char*)post[12], ci[4], ci[5], ci[6], ci[7],
                ci[8], ci[9], ci[10], r, post_i[2], post_i[3], ci[11], tr,
                rr);
            err = cudaGetLastError();
        }
        // 4. the trains step last
        for (int j = 0; j < n_tr && err == cudaSuccess; ++j) {
            const int* ti = tr_i + NT_I * j;
            void* const* tp = tr_p + NT_P * j;
            const int n = ti[2] * ti[3];
            const float* u = tp[6] ? (const float*)tp[6] + (size_t)k * n
                                   : nullptr;
            TrainNT nt = {ti[4], (const float*)tp[1], (const float*)tp[2],
                          nullptr, nullptr, {nullptr, nullptr, nullptr}};
            if (ti[4] >= 0) {
                void* const* tc = tr_c + NTC_P * j;
                nt.ntt = (float*)tc[0];
                nt.ntm = (const unsigned char*)tc[1];
                for (int q = 0; q < 3; ++q) nt.p[q] = (const float*)tc[2 + q];
            }
            net_train_kernel<<<(n + 255) / 256, 256, 0, s>>>(
                ti[0], (int*)tp[0], (float*)tp[8], (unsigned char*)tp[9], u,
                (const float*)tp[5], (const float*)tp[7],
                (const float*)tp[4], n, clock, nt);
            err = cudaGetLastError();
        }
    }
    delete[] st;
    delete[] P;
    delete[] ic;
    delete[] dn;
    delete[] jobs;
    delete[] job_src;
    delete[] src_of;
    return (int)err;
}

}  // extern "C"
