// Device code shared by the plasticity kernels (lattice_plasticity.cu) and
// the network kernels (network_plasticity.cu): the parameter-plane layout
// of each neuron model, phase B (the model step), kernel_exp, the STDP
// delta, the R-STDP visit, and the launchers of the STDP and R-STDP edge
// kernels and of the dopamine kernel, which live in lattice_plasticity.cu.
// Built with -fmad=false and without fast math, so the kernels round as
// their plain PyTorch twins.

#pragma once

#include <cuda_runtime.h>

#define LP_MAX_OFFSETS 64
#define LP_MAX_PARAMS 13
#define LP_NEVER (-1)

enum { MODEL_IZHIKEVICH = 0, MODEL_ALIF = 1, MODEL_LIF = 2 };
enum { KIND_PLAIN = 0, KIND_PLASTIC = 1, KIND_MOD = 2 };

struct Stencil {
    int n;
    int dr[LP_MAX_OFFSETS];
    int dc[LP_MAX_OFFSETS];
};

// Parameter planes in MODEL_PARAM_KEYS order (ops/reward_kernels.py).
struct Params {
    const float* p[LP_MAX_PARAMS];
};

struct Rule {
    float a_plus, a_minus, tau_plus, tau_minus, dt;
    float tau_c, exp_dc;
};

// Plane indices of each model's parameters.
namespace izh { enum { a, b, c, d, v_th, gap, tau_m, c_m, dt }; }
namespace alif {
enum { v_th, v_reset, tref, alpha, beta, leak, integ, gap, e_l, g_l, tau_m,
       c_m, dt };
}
namespace lif {
enum { v_th, v_reset, tref, leak, integ, gap, e_l, g_l, tau_m, dt };
}

// The plane index of the gap conductance of MODEL.
template <int MODEL>
__device__ __forceinline__ int gap_param()
{
    return MODEL == MODEL_IZHIKEVICH ? izh::gap
         : MODEL == MODEL_ALIF ? alif::gap : lif::gap;
}

// Phase B of cell i (pallas_reward.py _make_kernel): the Euler step of v
// (and w) from the synaptic input i_syn, less the receptors' rec_dv
// (chemical networks; v + dv - 0 is v + dv), then the spike handler.
// `refr` is the refractory count (ALIF, LIF; ignored for Izhikevich).
template <int MODEL>
__device__ __forceinline__ void model_step(
    const float* const* p, size_t i, float v, float w, float refr,
    float i_syn, float& v_pre, float& v_new, float& w_new, float& refr_new,
    bool& spike, float rec_dv = 0.0f)
{
    if (MODEL == MODEL_IZHIKEVICH) {
        const float dt = p[izh::dt][i];
        const float dt_cm = dt / p[izh::c_m][i];
        const float dt_tau = dt / p[izh::tau_m][i];
        const float dv = (0.04f * v * v + 5.0f * v + 140.0f - w + i_syn)
            * dt_cm;
        const float dw = (p[izh::a][i] * (p[izh::b][i] * v - w)) * dt_tau;
        v_pre = v + dv - rec_dv;
        const float w_pre = w + dw;
        spike = v_pre >= p[izh::v_th][i];
        v_new = spike ? p[izh::c][i] : v_pre;
        w_new = spike ? w_pre + p[izh::d][i] : w_pre;
        refr_new = refr;
    } else {
        // ALIF and LIF share the refractory handler; LIF has no w (its
        // plane is a zero plane that passes through).
        const bool is_alif = MODEL == MODEL_ALIF;
        const int e_l = is_alif ? alif::e_l : lif::e_l;
        const int g_l = is_alif ? alif::g_l : lif::g_l;
        const int dt_i = is_alif ? alif::dt : lif::dt;
        const int tau_m = is_alif ? alif::tau_m : lif::tau_m;
        const int leak_i = is_alif ? alif::leak : lif::leak;
        const int integ = is_alif ? alif::integ : lif::integ;
        const float dt = p[dt_i][i];
        const float dt_tau = dt / p[tau_m][i];
        const float leak = p[leak_i][i] * (v - p[e_l][i]);
        const float drive = p[integ][i] * (i_syn / p[g_l][i]);
        float dv;
        if (is_alif) {
            dv = (leak + drive - w / p[g_l][i]) * (dt / p[alif::c_m][i]);
            w_new = w + (p[alif::alpha][i] * (v - p[e_l][i]) - w) * dt_tau;
        } else {
            dv = (leak + drive) * dt_tau;
            w_new = w;
        }
        v_pre = v + dv - rec_dv;
        const bool in_ref = refr > 0.0f;
        spike = !in_ref && v_pre >= p[alif::v_th][i];   // v_th is plane 0
        v_new = (in_ref || spike) ? p[alif::v_reset][i] : v_pre;
        if (is_alif && spike) w_new = w_new + p[alif::beta][i];
        refr_new = in_ref ? refr - 1.0f
                          : (spike ? p[alif::tref][i] / dt : refr);
    }
}

// exp(x) within about an ulp, from correctly rounded float operations
// only (a Cephes-style range reduction by ln 2 in two parts, a degree-5
// polynomial, scaling by two exact powers of two): the same bits as its
// twin core.plasticity.kernel_exp on any device, where expf and the CPU's
// exp differ in the last bit for some arguments, and spiking dynamics
// carry such a bit into a spike a step early.  0 below -103.28, inf above
// 88.72; x is finite.
__device__ __forceinline__ float kernel_exp(float x)
{
    const float z = floorf(x * 1.44269504088896341f + 0.5f);
    float r = x - z * 0.693359375f;
    r = r - z * -2.12194440e-4f;
    float y = r * 1.9875691500e-4f + 1.3981999507e-3f;
    y = y * r + 8.3334519073e-3f;
    y = y * r + 4.1665795894e-2f;
    y = y * r + 1.6666665459e-1f;
    y = y * r + 5.0000001201e-1f;
    y = y * (r * r) + r + 1.0f;
    // z is out of range only where x is, and that y is overwritten below
    const int n = (int)fminf(fmaxf(z, -150.0f), 129.0f);
    const int half = n / 2;
    y = y * __int_as_float((n - half + 127) << 23)
          * __int_as_float((half + 127) << 23);
    if (x > 88.72283905206835f) y = __int_as_float(0x7f800000);
    if (x < -103.27892990343185f) y = 0.0f;
    return y;
}

// The STDP delta of one visit (pallas_reward.py _stdp_delta): one exp of
// the selected argument.  Firing times are step counts; their difference
// converts to float exactly below 2^24 steps.
__device__ __forceinline__ float stdp_delta(int t_pre, int t_post,
                                            const Rule& r)
{
    if (t_pre == LP_NEVER || t_post == LP_NEVER) return 0.0f;
    const float diff = fabsf((float)(t_pre - t_post)) * r.dt;
    const bool pre_first = t_pre < t_post;
    const float e = kernel_exp(pre_first ? -diff / r.tau_plus
                                         : -diff / r.tau_minus);
    if (pre_first) return r.a_plus * e;
    if (t_pre > t_post) return -r.a_minus * e;
    return 0.0f;
}

// One R-STDP visit (pallas_reward.py _rstdp_visit): the delta joins the
// accumulator; every second visit folds it into the trace c; the weight
// takes c * dopamine.
__device__ __forceinline__ void rstdp_visit(float& w, float& c, float& dw,
                                            int& ct, float delta, float dop,
                                            const Rule& r)
{
    dw = dw + delta;
    if (ct != 0) {
        c = c * r.exp_dc + r.tau_c * dw;
        dw = 0.0f;
        ct = 0;
    } else {
        ct = 1;
    }
    w = w + c * dop;
}

// The error of the launch just made; adds one to *launched (when not null)
// if it succeeded.  Every launch of the single-lattice and HH entries goes
// through it, so that their callers count the kernels each call launched.
static inline cudaError_t lp_counted(int* launched)
{
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess && launched) ++*launched;
    return err;
}

// Launches STDP on a stencil lattice's weights, in place on `s`: for every
// masked slot (o, r, c), w += delta(lft[pre], lft[post]) * (spk[pre] +
// spk[post]) from the post-step firing times and spikes (the edge kernel of
// kind plastic, lattice_plasticity.cu).  Returns the launch error and
// counts the launch in *launched (`lp_counted`).
cudaError_t lp_launch_stdp_edge(const int* lft, const unsigned char* spk,
                                float* weights, const unsigned char* mask,
                                const Rule& r, const Stencil& st, int rows,
                                int cols, cudaStream_t s,
                                int* launched = nullptr);

// Launches the R-STDP double visit on a stencil lattice's weights and
// traces (c, dw, counter: (n_off, rows, cols)), in place on `s`, from the
// post-step firing times, with the dopamine at *dop (the edge kernel of
// kind mod, lattice_plasticity.cu).  Returns the launch error and counts
// the launch in *launched.
cudaError_t lp_launch_rstdp_edge(const int* lft, const unsigned char* spk,
                                 float* weights, const unsigned char* mask,
                                 float* tr_c, float* tr_dw, int* tr_counter,
                                 const float* dop, const Rule& r,
                                 const Stencil& st, int rows, int cols,
                                 cudaStream_t s, int* launched = nullptr);

// Launches the dopamine of n_steps steps from *dop_in and the host
// `rewards`: dop_steps[k] = dop_steps[k - 1] * exp_dd + tau_d * rewards[k]
// (lp_dopamine_kernel, one thread, 16 rewards by value per launch).
// Returns the first launch error and counts the launches in *launched.
cudaError_t lp_launch_dopamine(const float* dop_in, const float* rewards,
                               int n_steps, float exp_dd, float tau_d,
                               float* dop_steps, cudaStream_t s,
                               int* launched = nullptr);
