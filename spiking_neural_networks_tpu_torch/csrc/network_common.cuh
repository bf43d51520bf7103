// Device code shared by the network kernels: the per-step launches of
// network_plasticity.cu and the persistent kernel of network_persistent.cu.
// Built with -fmad=false and without fast math, like plasticity_common.cuh,
// which holds the model step, kernel_exp, the STDP delta and the R-STDP
// visit.

#pragma once

#include "plasticity_common.cuh"

#define NET_MAX_IN 8
#define NET_MAX_TAPS 64

enum { CONN_ONE2ONE = 0, CONN_RESAMPLE = 1, CONN_DENSE = 2 };
enum { TRAIN_POISSON = 0, TRAIN_RATE = 1 };
enum { REFR_DELTA_DIRAC = 0, REFR_EXP_DECAY = 1 };

// The pre row (or column) that post row r reads through a tap at offset d.
__device__ __forceinline__ int resample_index(int f, int r, int d)
{
    return (f > 0 ? r * f : r / -f) + d;
}

// A train's effect at cell j from its firing times `lft` (pallas_reward.py
// _make_kernel, the spike-train effects): the kernel's association decay *
// tdiff * tdiff, or decay * tdiff for exponential decay; v_resting where
// it never fired.
__device__ __forceinline__ float train_effect(
    const int* lft, const float* v_th, const float* v_rest, const float* k,
    const float* dt, int refractoriness, size_t j, int clock)
{
    const int t = lft[j];
    const float rest = v_rest[j];
    if (t == LP_NEVER) return rest;
    const float amp = v_th[j] - rest;
    const float tdiff = (float)(clock - t);
    const float decay = -1.0f / (k[j] / dt[j]);
    const float x = refractoriness == REFR_DELTA_DIRAC
        ? decay * tdiff * tdiff : decay * tdiff;
    return amp * kernel_exp(x) + rest;
}
