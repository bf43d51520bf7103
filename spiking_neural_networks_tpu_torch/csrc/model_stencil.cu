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

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <type_traits>

#include "plasticity_common.cuh"   // kernel_exp

namespace cg = cooperative_groups;

#define MS_MAX_OFFSETS 64
#define MS_MAX_FIELDS 32
#ifndef MS_THREADS
#define MS_THREADS 1024     // a persistent block's threads
#endif
#define MS_MAX_CPT 4        // cells a thread of the persistent design
#define MS_CHUNK 16         // steps a persistent launch

// ops/model_kernels.py KINDS, in order
enum {
    MS_LIF = 0, MS_QIF, MS_ALIF, MS_ADEX, MS_DOPA,
    MS_LEAKY_IZH, MS_BCM, MS_BCM_CHEM, MS_SIMPLE_LIF, MS_MORRIS_LECAR,
    // the plain Izhikevich of the stencil kernel's persistent design
    // (ops/stencil_kernels.py, IZH_KIND); not in the model table
    MS_IZH,
    MS_KINDS
};
// field codes of model_stencil_layout: the type, + CARRIED where the step
// writes the field, + READ where it reads it
enum {
    F32 = 0, BOOL = 1, I32 = 2, CARRIED = 4, READ = 8,
    IN = F32 | READ,              // a float plane the step only reads
    ST = F32 | READ | CARRIED,    // a float plane it reads and writes
    OUT = F32 | CARRIED,          // a float plane it only writes
    SPK = BOOL | CARRIED,         // is_spiking, written and not read
};

struct MsStencil {
    int n;
    int dr[MS_MAX_OFFSETS];
    int dc[MS_MAX_OFFSETS];
};

struct Planes {
    const void* p[MS_MAX_FIELDS];
};

struct Outs {
    void* p[MS_MAX_FIELDS];
};

// tanh(x) = sign(x) (1 - 2 / (exp(2|x|) + 1)): within 2e-7 of tanh; the
// same bits as its twin core.plasticity.kernel_tanh on any device.
__device__ __forceinline__ float kernel_tanh(float x)
{
    const float e = kernel_exp(2.0f * fabsf(x));
    const float t = 1.0f - 2.0f / (e + 1.0f);
    return x < 0.0f ? -t : t;
}

// cosh(x) = (exp(|x|) + 1 / exp(|x|)) / 2: within 4 ulps of cosh; the
// same bits as its twin core.plasticity.kernel_cosh on any device.
__device__ __forceinline__ float kernel_cosh(float x)
{
    const float e = kernel_exp(fabsf(x));
    return 0.5f * (e + 1.0f / e);
}

// The per-step design's accessor: a field's value at cell i, and a carried
// field's store, in global planes.
struct Cell {
    const Planes& in;
    const Outs& out;
    size_t i;
    __device__ float f(int k) const { return ((const float*)in.p[k])[i]; }
    __device__ bool b(int k) const
    {
        return ((const unsigned char*)in.p[k])[i] != 0;
    }
    __device__ int n(int k) const { return ((const int*)in.p[k])[i]; }
    __device__ void set(int k, float x) const { ((float*)out.p[k])[i] = x; }
    __device__ void set_b(int k, bool x) const
    {
        ((unsigned char*)out.p[k])[i] = x ? 1 : 0;
    }
    __device__ void set_n(int k, int x) const { ((int*)out.p[k])[i] = x; }
    // the pre-reset v of izhikevich_step: not kept by this design
    __device__ void pre(float) const {}
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

// ---------------------------------------------------------------------------
// The per-step design
// ---------------------------------------------------------------------------

template <class M>
__global__ void model_stencil_kernel(
    Planes in, Outs out, const int* __restrict__ lft_in,
    int* __restrict__ lft_out, const float* __restrict__ weights, const float* __restrict__ in_deg,
    MsStencil st, int rows, int cols, int clock)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row >= rows || col >= cols) return;
    const size_t n = (size_t)rows * cols;
    const size_t i = (size_t)row * cols + col;
    const float* vp = (const float*)in.p[M::v];

    const float v = vp[i];
    float acc = 0.0f;
    float wsum = 0.0f;
    for (int o = 0; o < st.n; ++o) {
        const float wo = weights[(size_t)o * n + i];
        wsum = wsum + wo;
        const int sr = row + st.dr[o];
        const int sc = col + st.dc[o];
        if (sr >= 0 && sr < rows && sc >= 0 && sc < cols)
            acc = acc + wo * vp[(size_t)sr * cols + sc];
    }
    const Cell c{in, out, i};
    const float cnt = fmaxf(in_deg[i], 1.0f);
    const float i_syn = c.f(M::gap) * (acc - v * wsum) / cnt;
    const bool spike = M::step(c, i_syn);
    c.set_b(M::is_spiking, spike);
    lft_out[i] = spike ? clock : lft_in[i];
}

template <class M>
static cudaError_t run_steps(
    const void* const* fields, void* const* buf0, void* const* buf1,
    const int* lft, int* lft0, int* lft1, const float* weights,
    const float* in_deg, const MsStencil& st,
    int rows, int cols, int clock0, int n_steps, int* launched,
    cudaStream_t s)
{
    Planes in;
    Outs out[2];
    for (int f = 0; f < MS_MAX_FIELDS; ++f) {
        in.p[f] = f < M::n_fields ? fields[f] : nullptr;
        out[0].p[f] = f < M::n_fields ? buf0[f] : nullptr;
        out[1].p[f] = f < M::n_fields ? buf1[f] : nullptr;
    }
    int* lft_buf[2] = {lft0, lft1};
    const dim3 block(32, 8);
    const dim3 grid((cols + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    const int* lft_src = lft;
    for (int k = 0; k < n_steps; ++k) {
        const int b = k & 1;
        model_stencil_kernel<M><<<grid, block, 0, s>>>(
            in, out[b], lft_src, lft_buf[b], weights, in_deg, st, rows, cols,
            clock0 + k);
        const cudaError_t err = lp_counted(launched);
        if (err != cudaSuccess) return err;
        // the carried fields of step k + 1 are step k's outputs
        for (int f = 0; f < M::n_fields; ++f)
            if (M::codes[f] & CARRIED) in.p[f] = out[b].p[f];
        lft_src = lft_buf[b];
    }
    return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The persistent design
// ---------------------------------------------------------------------------

// The fields of M whose codes hold all of `bits`, as a bit mask (a
// compile-time constant that device code may read).
template <class M>
__host__ __device__ constexpr unsigned ms_mask(int bits)
{
    unsigned m = 0;
    for (int f = 0; f < M::n_fields; ++f)
        if ((M::codes[f] & bits) == bits) m |= 1u << f;
    return m;
}

template <class M>
struct MsMasks {
    // read from registers: the fields a step reads and writes
    static constexpr unsigned reg = ms_mask<M>(CARRIED | READ);
    static constexpr unsigned carried = ms_mask<M>(CARRIED);
    static constexpr unsigned bools = ms_mask<M>(BOOL);
    static constexpr unsigned ints = ms_mask<M>(I32);
};

// The most cells a persistent thread of M takes: MS_MAX_CPT where it
// keeps at most 4 fields in registers, else 2 (BCMIzhikevich's 7 spilled
// at 4 cells in 64 registers).
template <class M>
constexpr int ms_max_cpt()
{
    int n = 0;
    for (unsigned m = MsMasks<M>::reg; m; m &= m - 1) ++n;
    return n <= 4 ? MS_MAX_CPT : 2;
}

// One persistent launch: up to MS_CHUNK steps from `in` (the call's
// planes; a later chunk's carried fields from the chunk before) into
// `out`, the blocks' cells [b cap, (b + 1) cap).  slot[f] is the shared
// plane of IN field f, or -1 where it streams from global memory.
struct MsP {
    Planes in;
    Outs out;
    const int* lft_in;
    int* lft_out;
    float* vbuf[2];
    float* v_pre;       // step k's pre-reset v at k * rows * cols (EMIT)
    const float* weights;
    const float* in_deg;
    int slot[MS_MAX_FIELDS];
    long long lin[MS_MAX_OFFSETS];    // dr * cols + dc of each offset
    MsStencil st;
    int rows, cols, clock0, n_steps, cap;
};

// The persistent design's accessor for one cell: the fields a step reads
// and writes from the thread's registers (fc, bc, ic: the step's start;
// fn, bn, in_: what it writes), the IN fields from the block's shared
// planes or global memory.  A functor's field indices are constants, so
// the register arrays resolve at compile time.  With EMIT, pre() keeps the
// step's pre-reset v in *vp (izhikevich_step's hook; a no-op otherwise).
template <class M, bool EMIT = false>
struct RegCell {
    const MsP& P;
    const float* sp;      // the shared IN planes
    int loc;
    size_t i;
    const float* fc;
    float* fn;
    const bool* bc;
    bool* bn;
    const int* ic;
    int* in_;
    float* vp;
    __device__ bool reg(int k) const { return (MsMasks<M>::reg >> k) & 1u; }
    __device__ float f(int k) const
    {
        if (reg(k)) return fc[k];
        const int s = P.slot[k];
        return s >= 0 ? sp[(size_t)s * P.cap + loc]
                      : ((const float*)P.in.p[k])[i];
    }
    __device__ bool b(int k) const
    {
        return reg(k) ? bc[k] : ((const unsigned char*)P.in.p[k])[i] != 0;
    }
    __device__ int n(int k) const
    {
        return reg(k) ? ic[k] : ((const int*)P.in.p[k])[i];
    }
    __device__ void set(int k, float x) const { fn[k] = x; }
    __device__ void set_b(int k, bool x) const { bn[k] = x; }
    __device__ void set_n(int k, int x) const { in_[k] = x; }
    __device__ void pre(float x) const
    {
        if constexpr (EMIT) *vp = x;
    }
};

template <class M, int CPT, bool EMIT = false>
__global__ void __launch_bounds__(MS_THREADS, 1)
model_persistent_kernel(const __grid_constant__ MsP P)
{
    extern __shared__ __align__(16) unsigned char ms_smem[];
    constexpr int NF = M::n_fields;
    constexpr unsigned REG = MsMasks<M>::reg;
    constexpr unsigned CARRY = MsMasks<M>::carried;
    constexpr unsigned BOOLS = MsMasks<M>::bools;
    constexpr unsigned INTS = MsMasks<M>::ints;
    const int cap = P.cap;
    const size_t n = (size_t)P.rows * P.cols;
    const size_t lo = (size_t)blockIdx.x * cap;
    const int cells = n - lo < (size_t)cap ? (int)(n - lo) : cap;
    float* sw = (float*)ms_smem;                      // [n_off][cap]
    float* s_wsum = sw + (size_t)P.st.n * cap;        // [cap]
    float* s_cnt = s_wsum + cap;                      // [cap]
    float* sp = s_cnt + cap;                          // [slots][cap]
    for (int loc = threadIdx.x; loc < cells; loc += MS_THREADS) {
        const size_t i = lo + loc;
        float wsum = 0.0f;
        for (int o = 0; o < P.st.n; ++o) {
            const float w = P.weights[(size_t)o * n + i];
            sw[(size_t)o * cap + loc] = w;
            wsum = wsum + w;
        }
        s_wsum[loc] = wsum;
        s_cnt[loc] = fmaxf(P.in_deg[i], 1.0f);
        for (int f = 0; f < NF; ++f)
            if (P.slot[f] >= 0)
                sp[(size_t)P.slot[f] * cap + loc] =
                    ((const float*)P.in.p[f])[i];
    }
    __syncthreads();

    // the thread's cells: their places, and the fields a step reads and
    // writes, in registers
    float fc[CPT][NF], fn[CPT][NF];
    bool bc[CPT][NF], bn[CPT][NF];
    int ic[CPT][NF], in_[CPT][NF];
    int lft[CPT];
    unsigned long long on[CPT];    // the offsets of on-grid neighbours
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        const int loc = threadIdx.x + c * MS_THREADS;
        if (loc >= cells) continue;
        const size_t i = lo + loc;
        const int row = (int)(i / P.cols);
        const int col = (int)(i % P.cols);
        on[c] = 0;
        for (int o = 0; o < P.st.n; ++o) {
            const int sr = row + P.st.dr[o];
            const int sc = col + P.st.dc[o];
            if (sr >= 0 && sr < P.rows && sc >= 0 && sc < P.cols)
                on[c] |= 1ull << o;
        }
        lft[c] = P.lft_in[i];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
            if (!((REG >> f) & 1u)) continue;
            if ((BOOLS >> f) & 1u)
                bc[c][f] = ((const unsigned char*)P.in.p[f])[i] != 0;
            else if ((INTS >> f) & 1u)
                ic[c][f] = ((const int*)P.in.p[f])[i];
            else
                fc[c][f] = ((const float*)P.in.p[f])[i];
        }
    }
    cg::grid_group grid = cg::this_grid();
    for (int k = 0; k < P.n_steps; ++k) {
        const bool last = k + 1 == P.n_steps;
        const float* vsrc = k == 0 ? (const float*)P.in.p[M::v]
                                   : P.vbuf[(k - 1) & 1];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int loc = threadIdx.x + c * MS_THREADS;
            if (loc >= cells) continue;
            const size_t i = lo + loc;
            // the on-grid neighbours' v, in offset order
            const float* vi = vsrc + i;
            const float* wo = sw + loc;
            float acc = 0.0f;
            for (int o = 0; o < P.st.n; ++o, wo += cap)
                if ((on[c] >> o) & 1ull) acc = acc + *wo * vi[P.lin[o]];
            float v_pre = 0.0f;
            const RegCell<M, EMIT> cl{P, sp, loc, i, fc[c], fn[c], bc[c],
                                      bn[c], ic[c], in_[c], &v_pre};
            const float v = fc[c][M::v];
            const float i_syn = cl.f(M::gap) * (acc - v * s_wsum[loc])
                / s_cnt[loc];
            const bool spike = M::step(cl, i_syn);
            if constexpr (EMIT) P.v_pre[(size_t)k * n + i] = v_pre;
            bn[c][M::is_spiking] = spike;
            if (spike) lft[c] = P.clock0 + k;
            if (!last) {
                P.vbuf[k & 1][i] = fn[c][M::v];
            } else {
                // the call's outputs, written once
#pragma unroll
                for (int f = 0; f < NF; ++f) {
                    if (!((CARRY >> f) & 1u)) continue;
                    if ((BOOLS >> f) & 1u)
                        ((unsigned char*)P.out.p[f])[i] = bn[c][f] ? 1 : 0;
                    else if ((INTS >> f) & 1u)
                        ((int*)P.out.p[f])[i] = in_[c][f];
                    else
                        ((float*)P.out.p[f])[i] = fn[c][f];
                }
                P.lft_out[i] = lft[c];
            }
#pragma unroll
            for (int f = 0; f < NF; ++f) {
                if (!((REG >> f) & 1u)) continue;
                if ((BOOLS >> f) & 1u)
                    bc[c][f] = bn[c][f];
                else if ((INTS >> f) & 1u)
                    ic[c][f] = in_[c][f];
                else
                    fc[c][f] = fn[c][f];
            }
        }
        if (!last) grid.sync();
    }
}

// The shared bytes a persistent block takes: the weights, wsum, cnt and
// n_slots IN planes of `cap` cells.
static size_t ms_smem_bytes(int n_off, int n_slots, int cap)
{
    return (size_t)4 * cap * (n_off + 2 + n_slots);
}

// The chunks of a persistent call: chunk j writes buffer set j % 2 from
// the call's planes (j = 0) or set (j - 1) % 2, so the result is in set
// (chunks - 1) % 2.
template <class M, int CPT, bool EMIT>
static cudaError_t run_persistent(
    const void* const* fields, void* const* buf0, void* const* buf1,
    const int* lft, int* lft0, int* lft1, float* vbuf0, float* vbuf1,
    float* v_pre, const float* weights, const float* in_deg,
    const MsStencil& st, const int* slots, int rows, int cols, int clock0,
    int n_steps, int blocks, int cap, int* launched, cudaStream_t s)
{
    auto fn = model_persistent_kernel<M, CPT, EMIT>;
    int n_slots = 0;
    for (int f = 0; f < M::n_fields; ++f) {
        if (slots[f] < -1 || slots[f] >= M::n_fields
            || (slots[f] >= 0 && M::codes[f] != IN))
            return cudaErrorInvalidValue;
        n_slots += slots[f] >= 0;
    }
    const size_t smem = ms_smem_bytes(st.n, n_slots, cap);
    // the blocks must fit on the card at once
    int dev, n_sm, optin, occ;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
            != cudaSuccess)
        return err;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
            != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &occ, fn, MS_THREADS, smem)) != cudaSuccess)
        return err;
    if (blocks > occ * n_sm) return cudaErrorCooperativeLaunchTooLarge;
    MsP P = {};
    for (int f = 0; f < MS_MAX_FIELDS; ++f) {
        P.in.p[f] = f < M::n_fields ? fields[f] : nullptr;
        P.slot[f] = f < M::n_fields ? slots[f] : -1;
    }
    P.lft_in = lft;
    P.vbuf[0] = vbuf0;
    P.vbuf[1] = vbuf1;
    P.weights = weights;
    P.in_deg = in_deg;
    P.st = st;
    for (int o = 0; o < st.n; ++o)
        P.lin[o] = (long long)st.dr[o] * cols + st.dc[o];
    P.rows = rows;
    P.cols = cols;
    P.cap = cap;
    void* const* bufs[2] = {buf0, buf1};
    int* lft_buf[2] = {lft0, lft1};
    for (int k0 = 0, j = 0; k0 < n_steps; k0 += MS_CHUNK, ++j) {
        for (int f = 0; f < MS_MAX_FIELDS; ++f)
            P.out.p[f] = f < M::n_fields ? bufs[j & 1][f] : nullptr;
        P.lft_out = lft_buf[j & 1];
        P.clock0 = clock0 + k0;
        P.n_steps = n_steps - k0 < MS_CHUNK ? n_steps - k0 : MS_CHUNK;
        P.v_pre = EMIT ? v_pre + (size_t)k0 * rows * cols : nullptr;
        void* args[] = {&P};
        err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(MS_THREADS),
                                          args, smem, s);
        if (err != cudaSuccess || (err = lp_counted(launched)) != cudaSuccess)
            return err;
        // the carried fields of the next chunk are this chunk's outputs
        for (int f = 0; f < M::n_fields; ++f)
            if (M::codes[f] & CARRIED) P.in.p[f] = P.out.p[f];
        P.lft_in = P.lft_out;
    }
    return cudaSuccess;
}

// The layout of `kind`: its field count, and codes[f] (type + CARRIED)
// for each field when `codes` is not null; -1 for an unknown kind.
template <class M>
static int layout(int* codes)
{
    if (codes)
        for (int f = 0; f < M::n_fields; ++f) codes[f] = M::codes[f];
    return M::n_fields;
}

// The persistent launches of M at `cpt` cells a thread; with v_pre (the
// plain Izhikevich only), the instantiation that emits.
template <class M, bool EMIT = false>
static cudaError_t run_persistent_cpt(
    int cpt, const void* const* fields, void* const* buf0, void* const* buf1,
    const int* lft, int* lft0, int* lft1, float* vbuf0, float* vbuf1,
    float* v_pre, const float* weights, const float* in_deg,
    const MsStencil& st, const int* slots, int rows, int cols, int clock0,
    int n_steps, int blocks, int cap, int* launched, cudaStream_t s)
{
    if constexpr (!EMIT && std::is_same<M, Izh>::value) {
        if (v_pre)
            return run_persistent_cpt<M, true>(
                cpt, fields, buf0, buf1, lft, lft0, lft1, vbuf0, vbuf1,
                v_pre, weights, in_deg, st, slots, rows, cols, clock0,
                n_steps, blocks, cap, launched, s);
    }
    if (!EMIT && v_pre) return cudaErrorInvalidValue;
#define MS_CPT(C) run_persistent<M, C, EMIT>(                                \
        fields, buf0, buf1, lft, lft0, lft1, vbuf0, vbuf1, v_pre, weights,  \
        in_deg, st, slots, rows, cols, clock0, n_steps, blocks, cap,        \
        launched, s)
    if (cpt > ms_max_cpt<M>()) return cudaErrorInvalidValue;
    if (cpt == 1) return MS_CPT(1);
    if (cpt == 2) return MS_CPT(2);
    if constexpr (ms_max_cpt<M>() >= 4) return MS_CPT(4);
    return cudaErrorInvalidValue;
#undef MS_CPT
}

extern "C" {

int model_stencil_max_offsets() { return MS_MAX_OFFSETS; }

// MS_MAX_OFFSETS, MS_MAX_FIELDS, MS_THREADS, MS_MAX_CPT and MS_CHUNK, in
// order.
void model_stencil_limits(int* out)
{
    const int v[5] = {MS_MAX_OFFSETS, MS_MAX_FIELDS, MS_THREADS, MS_MAX_CPT,
                      MS_CHUNK};
    for (int q = 0; q < 5; ++q) out[q] = v[q];
}

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

static bool ms_stencil(int kind, int n_fields, const int* dr, const int* dc,
                       int n_off, int rows, int cols, int n_steps,
                       MsStencil& st)
{
    if (n_off < 0 || n_off > MS_MAX_OFFSETS || rows <= 0 || cols <= 0
        || n_steps <= 0 || n_fields != model_stencil_layout(kind, nullptr))
        return false;
    st.n = n_off;
    for (int o = 0; o < n_off; ++o) {
        st.dr[o] = dr[o];
        st.dc[o] = dc[o];
    }
    return true;
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
int model_stencil_steps(
    int kind, const void* const* fields, int n_fields, void* const* buf0,
    void* const* buf1, const int* lft, int* lft0, int* lft1,
    const float* weights, const float* in_deg,
    const int* dr, const int* dc, int n_off, int rows, int cols, int clock0,
    int n_steps, int* launched, void* stream)
{
    MsStencil st;
    if (!ms_stencil(kind, n_fields, dr, dc, n_off, rows, cols, n_steps, st))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define MS_RUN(M) run_steps<M>(fields, buf0, buf1, lft, lft0, lft1,       \
                               weights, in_deg, st, rows, cols, clock0,    \
                               n_steps, launched, s)
    cudaError_t err;
    switch (kind) {
    case MS_LIF: err = MS_RUN(Lif); break;
    case MS_QIF: err = MS_RUN(Qif); break;
    case MS_ALIF: err = MS_RUN(Alif); break;
    case MS_ADEX: err = MS_RUN(AdEx); break;
    case MS_DOPA: err = MS_RUN(Dopa); break;
    case MS_LEAKY_IZH: err = MS_RUN(LeakyIzh); break;
    case MS_BCM: err = MS_RUN(Bcm<false>); break;
    case MS_BCM_CHEM: err = MS_RUN(Bcm<true>); break;
    case MS_SIMPLE_LIF: err = MS_RUN(SimpleLif); break;
    case MS_MORRIS_LECAR: err = MS_RUN(MorrisLecar); break;
    default: err = cudaErrorInvalidValue;
    }
#undef MS_RUN
    return (int)err;
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
int model_stencil_persistent(
    int kind, const void* const* fields, int n_fields, void* const* buf0,
    void* const* buf1, const int* lft, int* lft0, int* lft1, float* vbuf0,
    float* vbuf1, float* v_pre, const float* weights, const float* in_deg,
    const int* dr, const int* dc, int n_off, int rows, int cols, int clock0,
    int n_steps, const int* slots, int blocks, int cap, int* launched,
    void* stream)
{
    MsStencil st;
    const int cpt = (cap + MS_THREADS - 1) / MS_THREADS;
    if (!ms_stencil(kind, n_fields, dr, dc, n_off, rows, cols, n_steps, st)
        || cap <= 0 || cap % 32 != 0 || cpt > MS_MAX_CPT || blocks <= 0
        || (long long)blocks * cap < (long long)rows * cols
        || (long long)(blocks - 1) * cap >= (long long)rows * cols)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define MS_RUN(M) run_persistent_cpt<M>(cpt, fields, buf0, buf1, lft, lft0,   \
                                        lft1, vbuf0, vbuf1, v_pre, weights,  \
                                        in_deg, st, slots, rows, cols,       \
                                        clock0, n_steps, blocks, cap,        \
                                        launched, s)
    cudaError_t err;
    switch (kind) {
    case MS_LIF: err = MS_RUN(Lif); break;
    case MS_QIF: err = MS_RUN(Qif); break;
    case MS_ALIF: err = MS_RUN(Alif); break;
    case MS_ADEX: err = MS_RUN(AdEx); break;
    case MS_DOPA: err = MS_RUN(Dopa); break;
    case MS_LEAKY_IZH: err = MS_RUN(LeakyIzh); break;
    case MS_BCM: err = MS_RUN(Bcm<false>); break;
    case MS_BCM_CHEM: err = MS_RUN(Bcm<true>); break;
    case MS_SIMPLE_LIF: err = MS_RUN(SimpleLif); break;
    case MS_MORRIS_LECAR: err = MS_RUN(MorrisLecar); break;
    case MS_IZH: err = MS_RUN(Izh); break;
    default: err = cudaErrorInvalidValue;
    }
#undef MS_RUN
    return (int)err;
}

}  // extern "C"
