// K steps of an elementwise neuron model on a stencil-coupled (rows, cols)
// lattice, one device functor per model.
//
// Replaces the TPU kernel fused_model_multistep of
// spiking_neural_networks_tpu/ops/pallas_stencil.py, which traces a model's
// step(s, i, skip_nt=True) into a K-step kernel body.  Here each model of
// the table of ops/model_kernels.py has a functor that repeats its PyTorch
// step operation for operation (the models' own associations, which differ
// between models on purpose), with exp, tanh and cosh as kernel_exp,
// kernel_tanh and kernel_cosh (correctly rounded float operations only).
// Built with -fmad=false, the kernels then round exactly as their plain
// twin (ops/model_kernels.model_steps_reference, which runs the model's
// step on (rows, cols) planes with the same three functions).
//
// The two designs below are templates over the functor and live in
// model_stencil.cuh, which the sources that ops/dsl_kernels.py generates
// from the DSL's neurons (one functor each, kind MS_DSL_KIND in a library
// of their own) include too; this file keeps the functors of the table
// and the C entries.
//
// Per step and cell, in the fused association of the TPU kernel:
//   wsum = sum_o w_o                       (offset order, from 0)
//   acc  = sum_o w_o * v[r+dr_o, c+dc_o]   (offset order, from 0)
//   i    = gap * (acc - v * wsum) / max(in_deg, 1)
//   the model's step from its fields and i, then lft = clock0 + k where
//   it spiked.
// Off-grid neighbours are skipped by a bounds check, never read.
//
// The fields travel as a by-value struct of plane pointers in the order
// of ops/model_kernels.model_kernel_fields: float fields (f32), then bool
// fields (uint8 0/1), then int fields (int32), then is_spiking (uint8).
// A field is IN (the step only reads it: a parameter), ST (read and
// written: v, w, refractory_count, kss_n, ...), OUT (written only: the
// Morris-Lecar channels' gates and currents) or is_spiking.  A functor
// reads and writes them through its Cell accessor (c.f, c.set, c.b,
// c.set_b, c.n, c.set_n), which each design implements.
//
// Two designs, routed by ops/model_kernels.uses_persistent:
//
// The persistent design (model_persistent_kernel<M, CPT, EMIT>; where
// ops/model_kernels.persistent_plan holds a block's weights in shared
// memory): one cooperative launch per MS_CHUNK steps, MS_THREADS threads a
// block, one block an SM at most.  Block b owns the row-major cells
// [b cap, (b + 1) cap), CPT of them a thread (at most 4; 2 for a model
// that keeps more than 4 fields in registers).  Before the first step the
// block copies its cells' n_off weight planes into shared memory, with
// wsum and max(in_deg, 1) taken once (the same sums, so the same bits),
// and as many IN planes as the plan holds; the others are read from
// global memory every step.  The ST fields and lft stay in registers
// across the steps (RegCell); each step but the last writes v into one of
// two global planes for the neighbours' reads, then a grid.sync(); the
// carried fields, lft and is_spiking are written once, in the last step.
// What bounds it: a step reads from outside the SM only the neighbours' v
// (from L2) and the streamed IN planes, so it costs the shared-memory
// reads of the weights and parameters, the arithmetic and the barrier
// (~1.1 us on an H100).
//
// The persistent design also carries the plain Izhikevich of the stencil
// kernel (kind MS_IZH, functor Izh over the field order v, w, the 9
// parameter planes of ops/stencil_kernels.PARAM_ORDER, is_spiking; not in
// the model table, so the model gate is unchanged): the stencil kernel's
// persistent design (ops/stencil_kernels.StencilRun, where its
// persistent_plan holds the weights: the 512 x 512 main path), which
// replaces fused_izhikevich_multistep.  Its instantiations with EMIT write
// each step's pre-reset v (izhikevich_step's pre() hook, a no-op in every
// other instantiation) at k * rows * cols for the grid histories.
//
// The per-step design (model_stencil_kernel<M>; where the plan cannot hold
// the weights, as at 2048 x 2048): one thread per cell, 2-D blocks of
// 32 x 8, one launch per step, the carried fields through two global
// buffer sets.  What bounds it on an H100 is memory traffic: each step
// reads the field planes its model reads, the n_off weight planes, in_deg
// and lft, and writes the carried planes and lft.  Morris-Lecar on a
// radius-2 stencil reads 17 float planes, a bool plane, 12 weight planes,
// in_deg and lft, and writes 8 float planes, 2 bool planes and lft: 163
// bytes a cell, 683 MB a step at 2048 x 2048, at ~2.86 TB/s.  Later work:
// temporal blocking (K steps on a tile plus a K * pad halo in shared
// memory, the TPU kernel's scheme).

#include "model_stencil.cuh"

// ops/model_kernels.py KINDS, in order
enum {
    MS_LIF = 0, MS_QIF, MS_ALIF, MS_ADEX, MS_DOPA,
    MS_LEAKY_IZH, MS_BCM, MS_BCM_CHEM, MS_SIMPLE_LIF, MS_MORRIS_LECAR,
    // the plain Izhikevich of the stencil kernel's persistent design
    // (ops/stencil_kernels.py, IZH_KIND); not in the model table
    MS_IZH,
    MS_KINDS
};

// ---------------------------------------------------------------------------
// Field layouts (indices in model_kernel_fields order) and functors.  Each
// functor's step(c, i_syn) writes the carried fields but is_spiking and
// returns the spike; `codes` is its layout for model_stencil_layout.
// ---------------------------------------------------------------------------

// The refractory handler of LIF, QIF, ALIF and AdEx (base.py
// _handle_refractory_reset / _handle_adaptive): v1 is the integrated v.
template <class L, class Cell>
__device__ __forceinline__ bool refractory_reset(const Cell& c, float v1)
{
    const float rc = c.f(L::refractory_count);
    const bool in_ref = rc > 0.0f;
    const bool spike = !in_ref && v1 >= c.f(L::v_th);
    c.set(L::v, (in_ref || spike) ? c.f(L::v_reset) : v1);
    c.set(L::refractory_count,
          in_ref ? rc - 1.0f
                 : (spike ? c.f(L::tref) / c.f(L::dt) : rc));
    return spike;
}

struct Lif {
    enum { v, v_th, v_reset, v_init, refractory_count, tref, leak, integ,
           gap, e_l, g_l, tau_m, c_m, dt, is_spiking, n_fields };
    static constexpr int codes[n_fields] = {
        ST, IN, IN, F32, ST, IN, IN, IN, IN, IN, IN, IN, F32, IN, SPK};
    template <class Cell>
    __device__ static bool step(const Cell& c, float i_syn)
    {
        const float v0 = c.f(v);
        const float dv = ((c.f(leak) * (v0 - c.f(e_l)))
                          + (c.f(integ) * (i_syn / c.f(g_l))))
            * (c.f(dt) / c.f(tau_m));
        return refractory_reset<Lif>(c, v0 + dv);
    }
};

struct Qif {
    enum { v, v_th, v_reset, v_init, refractory_count, tref, alpha, v_c,
           integ, gap, tau_m, c_m, dt, is_spiking, n_fields };
    static constexpr int codes[n_fields] = {
        ST, IN, IN, F32, ST, IN, IN, IN, IN, IN, IN, F32, IN, SPK};
    template <class Cell>
    __device__ static bool step(const Cell& c, float i_syn)
    {
        const float v0 = c.f(v);
        const float dv = ((c.f(alpha) * (v0 - c.f(v_reset))
                           * (v0 - c.f(v_c)))
                          + c.f(integ) * i_syn)
            * (c.f(dt) / c.f(tau_m));
        return refractory_reset<Qif>(c, v0 + dv);
    }
};

// ALIF and AdEx: w integrates, and w += beta on a spike.
template <class L, bool EXP, class Cell>
__device__ __forceinline__ bool adaptive_step(const Cell& c, float i_syn)
{
    const float v = c.f(L::v);
    const float w = c.f(L::w);
    const float leak = c.f(L::leak) * (v - c.f(L::e_l));
    float sum = leak;
    if constexpr (EXP) {
        const float sf = c.f(L::slope_factor);
        sum = sum + (sf * kernel_exp((v - c.f(L::v_th)) / sf));
    }
    sum = sum + (c.f(L::integ) * (i_syn / c.f(L::g_l)));
    const float dv = (sum - (w / c.f(L::g_l))) * (c.f(L::dt) / c.f(L::c_m));
    const float dw = (c.f(L::alpha) * (v - c.f(L::e_l)) - w)
        * (c.f(L::dt) / c.f(L::tau_m));
    const float w1 = w + dw;
    const bool spike = refractory_reset<L>(c, v + dv);
    c.set(L::w, spike ? w1 + c.f(L::beta) : w1);
    return spike;
}

struct Alif {
    enum { v, v_th, v_reset, v_init, refractory_count, tref, alpha, beta, w,
           w_init, leak, integ, gap, e_l, g_l, tau_m, c_m, dt, is_spiking,
           n_fields };
    static constexpr int codes[n_fields] = {
        ST, IN, IN, F32, ST, IN, IN, IN, ST, F32, IN, IN, IN, IN, IN, IN,
        IN, IN, SPK};
    template <class Cell>
    __device__ static bool step(const Cell& c, float i_syn)
    {
        return adaptive_step<Alif, false>(c, i_syn);
    }
};

struct AdEx {
    enum { v, v_th, v_reset, v_init, refractory_count, tref, alpha, beta,
           slope_factor, w, w_init, leak, integ, gap, e_l, g_l, tau_m, c_m,
           dt, is_spiking, n_fields };
    static constexpr int codes[n_fields] = {
        ST, IN, IN, F32, ST, IN, IN, IN, IN, ST, F32, IN, IN, IN, IN, IN,
        IN, IN, IN, SPK};
    template <class Cell>
    __device__ static bool step(const Cell& c, float i_syn)
    {
        return adaptive_step<AdEx, true>(c, i_syn);
    }
};

// The Izhikevich-shaped step (DopaIzhikevich, BCMIzhikevich;
// with LEAKY, LeakyIzhikevich's w (v - e_l) term), then v -> c, w += d on
// a spike.
template <class L, bool LEAKY, class Cell>
__device__ __forceinline__ bool izhikevich_step(const Cell& c, float i_syn)
{
    const float v = c.f(L::v);
    const float w = c.f(L::w);
    float q = 0.04f * v * v + 5.0f * v + 140.0f;
    if constexpr (LEAKY)
        q = q - w * (v - c.f(L::e_l));
    else
        q = q - w;
    const float dv = (q + i_syn) * (c.f(L::dt) / c.f(L::c_m));
    const float dw = (c.f(L::a) * (c.f(L::b) * v - w))
        * (c.f(L::dt) / c.f(L::tau_m));
    const float v1 = v + dv;
    const float w1 = w + dw;
    c.pre(v1);
    const bool spike = v1 >= c.f(L::v_th);
    c.set(L::v, spike ? c.f(L::c) : v1);
    c.set(L::w, spike ? w1 + c.f(L::d) : w1);
    return spike;
}

struct Dopa {
    enum { v, w, a, b, c, d, v_th, tau_m, c_m, gap, dt, is_spiking,
           n_fields };
    static constexpr int codes[n_fields] = {
        ST, ST, IN, IN, IN, IN, IN, IN, IN, IN, IN, SPK};
    template <class Cell>
    __device__ static bool step(const Cell& cl, float i_syn)
    {
        return izhikevich_step<Dopa, false>(cl, i_syn);
    }
};

// The plain Izhikevich of the stencil kernel's persistent design, over its
// own field order (v, w, the 9 planes of stencil_kernels.PARAM_ORDER,
// is_spiking): izhikevich_step is the arithmetic of izhikevich_stencil.cu
// op for op, so this design, the tiled one and the per-step one give the
// same bits.
struct Izh {
    enum { v, w, a, b, c, d, v_th, gap, tau_m, c_m, dt, is_spiking,
           n_fields };
    static constexpr int codes[n_fields] = {
        ST, ST, IN, IN, IN, IN, IN, IN, IN, IN, IN, SPK};
    template <class Cell>
    __device__ static bool step(const Cell& cl, float i_syn)
    {
        return izhikevich_step<Izh, false>(cl, i_syn);
    }
};

template <>
struct ms_emits<Izh> : std::true_type {};

struct LeakyIzh {
    enum { v, v_th, v_init, a, b, c, d, w, w_init, e_l, gap, tau_m, c_m, dt,
           is_spiking, n_fields };
    static constexpr int codes[n_fields] = {
        ST, IN, F32, IN, IN, IN, IN, ST, F32, IN, IN, IN, IN, IN, SPK};
    template <class Cell>
    __device__ static bool step(const Cell& cl, float i_syn)
    {
        return izhikevich_step<LeakyIzh, true>(cl, i_syn);
    }
};

// BCMIzhikevich: the firing-rate bookkeeping (pre_update, from the
// previous step's spike flag), then the Izhikevich step.  CHEM: the
// activity over the window (chemical_normalization), else over
// window * dt.
template <bool CHEM>
struct Bcm {
    enum { v, v_th, v_init, a, b, c, d, w, w_init, gap, tau_m, c_m, dt,
           average_activity, current_activity, firing_rate_clock,
           firing_rate_window, period, num_spikes, is_spiking, n_fields };
    static constexpr int codes[n_fields] = {
        ST, IN, F32, IN, IN, IN, IN, ST, F32, IN, IN, IN, IN, ST, ST, ST,
        IN, IN, I32 | READ | CARRIED, BOOL | READ | CARRIED};
    template <class Cell>
    __device__ static bool step(const Cell& cl, float i_syn)
    {
        const int ns = cl.n(num_spikes) + (cl.b(is_spiking) ? 1 : 0);
        const float window = cl.f(firing_rate_window);
        const float clock = cl.f(firing_rate_clock) + cl.f(dt);
        const bool hit = clock >= window;
        const float denom = CHEM ? window : window * cl.f(dt);
        const float activity = (float)ns / denom;
        const float avg = cl.f(average_activity);
        const float per = cl.f(period);
        cl.set_n(num_spikes, ns);
        cl.set(firing_rate_clock, hit ? 0.0f : clock);
        cl.set(current_activity, hit ? activity : cl.f(current_activity));
        cl.set(average_activity,
               hit ? avg - avg / per + activity / per : avg);
        return izhikevich_step<Bcm, false>(cl, i_syn);
    }
};

struct SimpleLif {
    enum { v, g, e, v_th, v_reset, v_init, gap, c_m, dt, is_spiking,
           n_fields };
    static constexpr int codes[n_fields] = {
        ST, IN, IN, IN, IN, F32, IN, F32, IN, SPK};
    template <class Cell>
    __device__ static bool step(const Cell& c, float i_syn)
    {
        const float v0 = c.f(v);
        const float v1 = v0 + (c.f(g) * (v0 - c.f(e)) + i_syn) * c.f(dt);
        const bool spike = v1 >= c.f(v_th);
        c.set(v, spike ? c.f(v_reset) : v1);
        return spike;
    }
};

// MorrisLecar (morris_lecar.py): the channels from the old v, then
// v += (i - i_leak - i_ca - i_k) * (dt / c_m), then peak detection.
struct MorrisLecar {
    enum { v, v_init, v_th, gap, c_m, dt, ca_g, ca_v, ca_m_ss, ca_v_1,
           ca_v_2, ca_current, kss_g, kss_v, kss_n, kss_n_ss, kss_t_n,
           kss_phi, kss_v_3, kss_v_4, kss_current, leak_g, leak_v,
           leak_current, was_increasing, is_spiking, n_fields };
    static constexpr int codes[n_fields] = {
        ST, F32, IN, IN, IN, IN, IN, IN, OUT, IN, IN, OUT, IN, IN, ST,
        OUT, OUT, IN, IN, IN, OUT, IN, IN, OUT, BOOL | READ | CARRIED, SPK};
    template <class Cell>
    __device__ static bool step(const Cell& c, float i_syn)
    {
        const float v0 = c.f(v);
        const float dt_ = c.f(dt);
        const float m_ss = 0.5f
            * (1.0f + kernel_tanh((v0 - c.f(ca_v_1)) / c.f(ca_v_2)));
        const float i_ca = c.f(ca_g) * m_ss * (v0 - c.f(ca_v));
        const float v3 = c.f(kss_v_3);
        const float v4 = c.f(kss_v_4);
        const float n_ss = 0.5f * (1.0f + kernel_tanh((v0 - v3) / v4));
        const float t_n = 1.0f
            / (c.f(kss_phi) * kernel_cosh((v0 - v3) / (2.0f * v4)));
        const float n0 = c.f(kss_n);
        const float n = n0 + ((n_ss - n0) / t_n) * dt_;
        const float i_k = c.f(kss_g) * n * (v0 - c.f(kss_v));
        const float i_leak = c.f(leak_g) * (v0 - c.f(leak_v));
        const float dv = (i_syn - i_leak - i_ca - i_k) * (dt_ / c.f(c_m));
        const float v1 = v0 + dv;
        const bool increasing = v0 < v1;
        const bool spike = v1 > c.f(v_th) && c.b(was_increasing)
            && !increasing;
        c.set(v, v1);
        c.set(ca_m_ss, m_ss);
        c.set(ca_current, i_ca);
        c.set(kss_n, n);
        c.set(kss_n_ss, n_ss);
        c.set(kss_t_n, t_n);
        c.set(kss_current, i_k);
        c.set(leak_current, i_leak);
        c.set_b(was_increasing, increasing);
        return spike;
    }
};

extern "C" {

int model_stencil_max_offsets() { return MS_MAX_OFFSETS; }

// MS_MAX_OFFSETS, MS_MAX_FIELDS, MS_THREADS, MS_MAX_CPT and MS_CHUNK, in
// order.
void model_stencil_limits(int* out) { ms_limits(out); }

int model_stencil_layout(int kind, int* codes)
{
    switch (kind) {
    case MS_LIF: return layout<Lif>(codes);
    case MS_QIF: return layout<Qif>(codes);
    case MS_ALIF: return layout<Alif>(codes);
    case MS_ADEX: return layout<AdEx>(codes);
    case MS_DOPA: return layout<Dopa>(codes);
    case MS_LEAKY_IZH: return layout<LeakyIzh>(codes);
    case MS_BCM: return layout<Bcm<false>>(codes);
    case MS_BCM_CHEM: return layout<Bcm<true>>(codes);
    case MS_SIMPLE_LIF: return layout<SimpleLif>(codes);
    case MS_MORRIS_LECAR: return layout<MorrisLecar>(codes);
    case MS_IZH: return layout<Izh>(codes);
    default: return -1;
    }
}

// Runs n_steps steps of model `kind` from the planes `fields` (its
// layout's n_fields pointers) and `lft` on `stream`, one launch of the
// per-step design a step.  Step k writes the carried fields into buffer
// set k % 2 (buf0 / buf1: a pointer per field, null for a field that is
// not carried) and lft into lft0 / lft1, so the result is in set
// (n_steps - 1) % 2, the last step's spikes in its is_spiking plane; the
// inputs are only read and must not be set 0.  *launched (when not null)
// gains one for each kernel launched.  Returns the first CUDA error, 0 if
// none.
int model_stencil_steps(int kind, MS_STEPS_PARAMS)
{
#define MS_RUN(M) ms_steps_entry<M>(MS_STEPS_ARGS)
    switch (kind) {
    case MS_LIF: return MS_RUN(Lif);
    case MS_QIF: return MS_RUN(Qif);
    case MS_ALIF: return MS_RUN(Alif);
    case MS_ADEX: return MS_RUN(AdEx);
    case MS_DOPA: return MS_RUN(Dopa);
    case MS_LEAKY_IZH: return MS_RUN(LeakyIzh);
    case MS_BCM: return MS_RUN(Bcm<false>);
    case MS_BCM_CHEM: return MS_RUN(Bcm<true>);
    case MS_SIMPLE_LIF: return MS_RUN(SimpleLif);
    case MS_MORRIS_LECAR: return MS_RUN(MorrisLecar);
    default: return (int)cudaErrorInvalidValue;
    }
#undef MS_RUN
}

// Runs n_steps steps as model_stencil_steps does, in the persistent
// design: one cooperative launch of `blocks` blocks per MS_CHUNK steps,
// block b owning the cells [b cap, (b + 1) cap) (cap a multiple of 32, at
// most MS_MAX_CPT * MS_THREADS, blocks * cap >= rows * cols); slots[f] the
// shared plane of IN field f, -1 for one read from global memory (the
// plan of ops/model_kernels.persistent_plan).  Chunk j writes set j % 2,
// so the result is in set (chunks - 1) % 2; vbuf0 and vbuf1 are two
// (rows, cols) planes of scratch.  v_pre, when not null (kind MS_IZH
// only), receives step k's pre-reset v at k * rows * cols.  Returns the
// first CUDA error, 0 if none.
int model_stencil_persistent(int kind, MS_PERSISTENT_PARAMS)
{
#define MS_RUN(M) ms_persistent_entry<M>(MS_PERSISTENT_ARGS)
    switch (kind) {
    case MS_LIF: return MS_RUN(Lif);
    case MS_QIF: return MS_RUN(Qif);
    case MS_ALIF: return MS_RUN(Alif);
    case MS_ADEX: return MS_RUN(AdEx);
    case MS_DOPA: return MS_RUN(Dopa);
    case MS_LEAKY_IZH: return MS_RUN(LeakyIzh);
    case MS_BCM: return MS_RUN(Bcm<false>);
    case MS_BCM_CHEM: return MS_RUN(Bcm<true>);
    case MS_SIMPLE_LIF: return MS_RUN(SimpleLif);
    case MS_MORRIS_LECAR: return MS_RUN(MorrisLecar);
    case MS_IZH: return MS_RUN(Izh);
    default: return (int)cudaErrorInvalidValue;
    }
#undef MS_RUN
}

}  // extern "C"
