// Chemical device code shared by the network kernels' chemical arm
// (network_plasticity.cu) and the HH kernel (hh_chemical.cu): receptor
// kinetics and neurotransmitter release for every kinetics the TPU
// kernels take, selected by an id that is uniform over a launch (or a
// template constant), and kernel_log / kernel_pow.  Built with
// -fmad=false and without fast math, so each function rounds as its
// plain PyTorch twin (ops/kinetics.py rec_kinetics, nt_release;
// core/plasticity.py kernel_log, kernel_pow).

#pragma once

#include "plasticity_common.cuh"

#define CHEM_TYPES 3

// ops/network_kernels.py CHEM_FAMILIES, REC_KINDS and NT_KINDS, in order
enum { FAM_IONOTROPIC = 0, FAM_DOPAGLUGABA = 1 };
enum { REC_APPROXIMATE = 0, REC_BOUNDED = 1, REC_DESTEXHE = 2,
       REC_EXP_DECAY = 3 };
enum { NT_APPROXIMATE = 0, NT_BOUNDED = 1, NT_DISCRETE = 2,
       NT_EXP_DECAY = 3, NT_DESTEXHE = 4 };

__device__ __forceinline__ float clip0(float x, float hi)
{
    return fminf(fmaxf(x, 0.0f), hi);
}

// p[i], or 0 for a parameter the kinetics does not have
__device__ __forceinline__ float opt(const float* p, size_t i)
{
    return p ? p[i] : 0.0f;
}

// A receptor slot's gating value after input t (pallas_reward.py
// _rec_kinetics_update); p0, p1 the kinetics' parameters: r_max
// (bounded), alpha and beta (Destexhe), r_max and the decay constant
// (exponential decay).
__device__ __forceinline__ float rec_kinetics(int kind, float r, float t,
                                              float p0, float p1, float dt)
{
    switch (kind) {
    case REC_APPROXIMATE: return t;
    case REC_BOUNDED: return clip0(t, p0);
    case REC_DESTEXHE: return r + (p0 * t * (1.0f - r) - p1 * r) * dt;
    default: return clip0(r + -r * kernel_exp(dt / -p1) + t, p0);
    }
}

// A neurotransmitter slot's concentration after a step (pallas_reward.py
// _nt_release) from the voltage v and the spike flag spk (0 or 1); p0 is
// t_max, p1 the clearance or decay constant, or v_p and p2 k_p (Destexhe).
__device__ __forceinline__ float nt_release(int kind, float t0, float v,
                                            float spk, float p0, float p1,
                                            float p2, float dt)
{
    switch (kind) {
    case NT_APPROXIMATE:
    case NT_BOUNDED: return clip0(t0 + dt * -p1 * t0 + spk * p0, p0);
    case NT_DISCRETE: return p0 * spk;
    case NT_EXP_DECAY:
        return clip0(t0 + -t0 * kernel_exp(dt / -p1) + spk * p0, p0);
    default: return p0 / (1.0f + kernel_exp(-(v - p1) / p2));
    }
}

// log of a positive finite x within about an ulp, from float operations
// only (a Cephes-style reduction of the mantissa to [sqrt(1/2), sqrt(2))
// from the bits, a degree-9 polynomial, ln 2 in two parts).
__device__ __forceinline__ float kernel_log(float x)
{
    const bool tiny = x < 1.17549435e-38f;
    if (tiny) x = x * 8388608.0f;                      // 2^23: exact
    const int bits = __float_as_int(x);
    int e = ((bits >> 23) & 0xff) - 126 - (tiny ? 23 : 0);
    float m = __int_as_float((bits & 0x007fffff) | 0x3f000000);  // [0.5, 1)
    if (m < 0.70710678118654752f) {
        e = e - 1;
        m = m + m - 1.0f;
    } else {
        m = m - 1.0f;
    }
    const float z = m * m;
    float y = m * 7.0376836292e-2f + -1.1514610310e-1f;
    y = y * m + 1.1676998740e-1f;
    y = y * m + -1.2420140846e-1f;
    y = y * m + 1.4249322787e-1f;
    y = y * m + -1.6668057665e-1f;
    y = y * m + 2.0000714765e-1f;
    y = y * m + -2.4999993993e-1f;
    y = y * m + 3.3333331174e-1f;
    y = y * m * z;
    const float fe = (float)e;
    y = y + fe * -2.12194440e-4f;
    y = y + -0.5f * z;
    return m + y + fe * 0.693359375f;
}

// x ** y as kernel_exp(y * kernel_log(|x|)), with pow's exact cases:
// y == 1 -> x (the DopaGluGABA NMDA gate without dopamine), y == 0 -> 1,
// x == 0 -> 0 for y > 0 and inf for y < 0, and for x < 0 the sign of an
// odd integer y, or NaN for a y that is not an integer.  x, y finite.
__device__ __forceinline__ float kernel_pow(float x, float y)
{
    if (y == 1.0f) return x;
    if (y == 0.0f) return 1.0f;
    if (x == 0.0f) return y > 0.0f ? 0.0f : __int_as_float(0x7f800000);
    const float p = kernel_exp(y * kernel_log(fabsf(x)));
    if (x > 0.0f) return p;
    if (floorf(y) != y) return __int_as_float(0x7fc00000);
    return floorf(y * 0.5f) * 2.0f != y ? -p : p;
}
