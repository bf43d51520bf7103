// The designs of the elementwise-model stencil kernel, generic over a
// device functor M: shared by csrc/model_stencil.cu (the functors of the
// models of ops/model_kernels.py's table and the plain Izhikevich) and by
// the sources ops/dsl_kernels.py generates, one functor each, from the
// DSL's neurons.
//
// A functor M holds an enum of its field indices in the order of
// ops/model_kernels.model_kernel_fields, with v, gap (gap_conductance),
// is_spiking and n_fields among them; codes[n_fields], each field's code
// below; and
//   template <class Cell> __device__ static bool step(const Cell& c,
//                                                     float i_syn)
// which reads its fields through c.f / c.b / c.n, writes every carried
// field but is_spiking through c.set / c.set_b / c.set_n, and returns the
// spike.  See csrc/model_stencil.cu for the designs' description: the
// per-step model_stencil_kernel<M> (run_steps) and the persistent
// model_persistent_kernel<M, CPT, EMIT> (run_persistent_cpt).

#pragma once

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <type_traits>

#include "plasticity_common.cuh"   // kernel_exp
#include "chem_common.cuh"         // kernel_log

namespace cg = cooperative_groups;

#define MS_MAX_OFFSETS 64
#define MS_MAX_FIELDS 32
#ifndef MS_THREADS
#define MS_THREADS 1024     // a persistent block's threads
#endif
#define MS_MAX_CPT 4        // cells a thread of the persistent design
#define MS_CHUNK 16         // steps a persistent launch
// the kind of a generated functor in its library's C entries
#define MS_DSL_KIND 64

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

// The DSL's functions on the kernel route (the generated functors of
// ops/dsl_kernels.py), each the same bits as its twin in
// core/plasticity.py: ln / log (kernel_ln), log10 (kernel_log10), sinh
// (kernel_sinh), sin / cos / tan (kernel_sin, kernel_cos, kernel_tan), ^
// (ms_pow: kernel_pow_nan), and min / max with torch's
// NaN rule (torch.minimum / torch.maximum propagate a NaN operand; fminf /
// fmaxf do not).
__device__ __forceinline__ float kernel_ln(float x)
{
    if (x > 0.0f)
        return x == __int_as_float(0x7f800000) ? x : kernel_log(x);
    return x == 0.0f ? -__int_as_float(0x7f800000)
                     : __int_as_float(0x7fc00000);
}

__device__ __forceinline__ float kernel_log10(float x)
{
    return kernel_ln(x) * 0.434294492f;
}

// sinh: below |x| = 1 the Taylor series to x^9, else
// sign(x) (e - 1 / e) / 2 with e = kernel_exp(|x|).
__device__ __forceinline__ float kernel_sinh(float x)
{
    if (fabsf(x) < 1.0f) {
        const float x2 = x * x;
        float p = x2 * 2.75573188e-06f + 0.000198412701f;
        p = p * x2 + 0.00833333377f;
        p = p * x2 + 0.166666672f;
        return x + x * (x2 * p);
    }
    const float e = kernel_exp(fabsf(x));
    const float b = 0.5f * (e - 1.0f / e);
    return x < 0.0f ? -b : b;
}

// sin, cos and tan in double, rounded once (twins kernel_sin, kernel_cos,
// kernel_tan in core/plasticity.py, within 1 ulp for |x| <= 5e7): a
// Cody-Waite reduction by pi/2 in three parts (q * P1 and q * P2 exact for
// |q| < 2^25), then fdlibm's minimax polynomials on [-pi/4, pi/4].  Past
// the exact range the remainder is clamped to [-1, 1], so the result stays
// finite; NaN and +-inf give NaN.
struct MsTrig {
    double n, s, c;   // the quadrant q mod 4, sin and cos of the remainder
};

__device__ __forceinline__ MsTrig ms_trig_parts(float x)
{
    const double d = (double)x;
    const double q = rint(d * 0.6366197723675814);
    double r = d - q * 1.570796325802803;
    r = r - q * 9.920935739593517e-10;
    r = r - q * 5.721188726109832e-18;
    r = q == 0.0 ? d : (r > 1.0 ? 1.0 : (r < -1.0 ? -1.0 : r));
    MsTrig t;
    t.n = q - 4.0 * floor(q * 0.25);
    const double z = r * r;
    double p = z * 1.58969099521155010221e-10 + -2.50507602534068634195e-08;
    p = p * z + 2.75573137070700676789e-06;
    p = p * z + -1.98412698298579493134e-04;
    p = p * z + 8.33333333332248946124e-03;
    p = p * z + -1.66666666666666324348e-01;
    t.s = r + (r * z) * p;
    p = z * -1.13596475577881948265e-11 + 2.08757232129817482790e-09;
    p = p * z + -2.75573143513906633035e-07;
    p = p * z + 2.48015872894767294178e-05;
    p = p * z + -1.38888888888741095749e-03;
    p = p * z + 4.16666666666666019037e-02;
    t.c = (1.0 - 0.5 * z) + (z * z) * p;
    return t;
}

__device__ __forceinline__ float kernel_sin(float x)
{
    const MsTrig t = ms_trig_parts(x);
    return (float)(t.n == 0.0 ? t.s : t.n == 1.0 ? t.c
                   : t.n == 2.0 ? -t.s : -t.c);
}

__device__ __forceinline__ float kernel_cos(float x)
{
    const MsTrig t = ms_trig_parts(x);
    return (float)(t.n == 0.0 ? t.c : t.n == 1.0 ? -t.s
                   : t.n == 2.0 ? -t.c : t.s);
}

__device__ __forceinline__ float kernel_tan(float x)
{
    const MsTrig t = ms_trig_parts(x);
    return (float)((t.n == 1.0 || t.n == 3.0) ? -t.c / t.s : t.s / t.c);
}

// x ** y for the DSL's ^ and r^: kernel_pow, whose operands are finite,
// and NaN where an operand is NaN (torch.pow's rule; kernel_pow of a NaN
// x gives a number), as a DSL rate at its 0/0 point makes one.
__device__ __forceinline__ float ms_pow(float x, float y)
{
    return (x != x || y != y) ? x + y : kernel_pow(x, y);
}

__device__ __forceinline__ float ms_minimum(float a, float b)
{
    return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float ms_maximum(float a, float b)
{
    return a != a ? a : (b != b ? b : fmaxf(a, b));
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

// The functors whose persistent design emits each step's pre-reset v
// (model_stencil.cu specializes it for the plain Izhikevich).
template <class M>
struct ms_emits : std::false_type {};

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

// A functor's own cap on the cells a persistent thread takes: M::max_cpt
// where it has one (a generated functor that calls sin / cos / tan, whose
// float64 registers spilled at 4 cells), else MS_MAX_CPT.
template <class M, class = void>
struct MsCptCap {
    static constexpr int value = MS_MAX_CPT;
};

template <class M>
struct MsCptCap<M, std::void_t<decltype(M::max_cpt)>> {
    static constexpr int value = M::max_cpt;
};

// The most cells a persistent thread of M takes: MS_MAX_CPT where it
// keeps at most 4 fields in registers, else 2 (BCMIzhikevich's 7 spilled
// at 4 cells in 64 registers), and at most its own cap.
template <class M>
constexpr int ms_max_cpt()
{
    int n = 0;
    for (unsigned m = MsMasks<M>::reg; m; m &= m - 1) ++n;
    const int cpt = n <= 4 ? MS_MAX_CPT : 2;
    return cpt < MsCptCap<M>::value ? cpt : MsCptCap<M>::value;
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

// The persistent launches of M at `cpt` cells a thread; with v_pre (a
// functor of ms_emits: the plain Izhikevich only), the instantiation that
// emits.
template <class M, bool EMIT = false>
static cudaError_t run_persistent_cpt(
    int cpt, const void* const* fields, void* const* buf0, void* const* buf1,
    const int* lft, int* lft0, int* lft1, float* vbuf0, float* vbuf1,
    float* v_pre, const float* weights, const float* in_deg,
    const MsStencil& st, const int* slots, int rows, int cols, int clock0,
    int n_steps, int blocks, int cap, int* launched, cudaStream_t s)
{
    if constexpr (!EMIT && ms_emits<M>::value) {
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

// MS_MAX_OFFSETS, MS_MAX_FIELDS, MS_THREADS, MS_MAX_CPT and MS_CHUNK, in
// order (the C entry model_stencil_limits).
static inline void ms_limits(int* out)
{
    const int v[5] = {MS_MAX_OFFSETS, MS_MAX_FIELDS, MS_THREADS, MS_MAX_CPT,
                      MS_CHUNK};
    for (int q = 0; q < 5; ++q) out[q] = v[q];
}

// The stencil of a call, false where the call's shape is not one the
// kernels take.
static inline bool ms_fill_stencil(const int* dr, const int* dc, int n_off,
                                   int rows, int cols, int n_steps,
                                   MsStencil& st)
{
    if (n_off < 0 || n_off > MS_MAX_OFFSETS || rows <= 0 || cols <= 0
        || n_steps <= 0)
        return false;
    st.n = n_off;
    for (int o = 0; o < n_off; ++o) {
        st.dr[o] = dr[o];
        st.dc[o] = dc[o];
    }
    return true;
}

// Whether `blocks` blocks of `cap` cells (a multiple of 32, at most
// MS_MAX_CPT * MS_THREADS) cover a rows x cols lattice, each block some.
static inline bool ms_blocks_ok(int blocks, int cap, int rows, int cols)
{
    const int cpt = (cap + MS_THREADS - 1) / MS_THREADS;
    return cap > 0 && cap % 32 == 0 && cpt <= MS_MAX_CPT && blocks > 0
        && (long long)blocks * cap >= (long long)rows * cols
        && (long long)(blocks - 1) * cap < (long long)rows * cols;
}

// The parameters of the C entries model_stencil_steps and
// model_stencil_persistent after `kind`, and the same names as arguments:
// every library of the model kernel (model_stencil.cu, each generated
// source) defines the two entries over them, so their argtypes
// (_build.bind_model_entries) are one list.
#define MS_STEPS_PARAMS                                                      \
    const void* const* fields, int n_fields, void* const* buf0,            \
        void* const* buf1, const int* lft, int* lft0, int* lft1,             \
        const float* weights, const float* in_deg, const int* dr,            \
        const int* dc, int n_off, int rows, int cols, int clock0,            \
        int n_steps, int* launched, void* stream
#define MS_STEPS_ARGS                                                        \
    fields, n_fields, buf0, buf1, lft, lft0, lft1, weights, in_deg, dr, dc, \
        n_off, rows, cols, clock0, n_steps, launched, stream
#define MS_PERSISTENT_PARAMS                                                 \
    const void* const* fields, int n_fields, void* const* buf0,            \
        void* const* buf1, const int* lft, int* lft0, int* lft1,             \
        float* vbuf0, float* vbuf1, float* v_pre, const float* weights,      \
        const float* in_deg, const int* dr, const int* dc, int n_off,        \
        int rows, int cols, int clock0, int n_steps, const int* slots,       \
        int blocks, int cap, int* launched, void* stream
#define MS_PERSISTENT_ARGS                                                   \
    fields, n_fields, buf0, buf1, lft, lft0, lft1, vbuf0, vbuf1, v_pre,     \
        weights, in_deg, dr, dc, n_off, rows, cols, clock0, n_steps, slots, \
        blocks, cap, launched, stream

// model_stencil_steps for the functor M of the call's kind: the field
// count and the stencil checked, then the per-step design (run_steps).
template <class M>
static int ms_steps_entry(MS_STEPS_PARAMS)
{
    MsStencil st;
    if (n_fields != M::n_fields
        || !ms_fill_stencil(dr, dc, n_off, rows, cols, n_steps, st))
        return (int)cudaErrorInvalidValue;
    return (int)run_steps<M>(fields, buf0, buf1, lft, lft0, lft1, weights,
                             in_deg, st, rows, cols, clock0, n_steps,
                             launched, (cudaStream_t)stream);
}

// model_stencil_persistent for the functor M of the call's kind: the
// field count, the stencil and the blocks checked, then the persistent
// design at the cells a thread that `cap` gives (run_persistent_cpt).
template <class M>
static int ms_persistent_entry(MS_PERSISTENT_PARAMS)
{
    MsStencil st;
    if (n_fields != M::n_fields
        || !ms_fill_stencil(dr, dc, n_off, rows, cols, n_steps, st)
        || !ms_blocks_ok(blocks, cap, rows, cols))
        return (int)cudaErrorInvalidValue;
    const int cpt = (cap + MS_THREADS - 1) / MS_THREADS;
    return (int)run_persistent_cpt<M>(
        cpt, fields, buf0, buf1, lft, lft0, lft1, vbuf0, vbuf1, v_pre,
        weights, in_deg, st, slots, rows, cols, clock0, n_steps, blocks, cap,
        launched, (cudaStream_t)stream);
}
