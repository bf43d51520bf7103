// The network kernels of network_plasticity.cu as one cooperative launch
// per call of up to 16 steps: grid-mode electrical networks, reward
// networks, chemical networks (the chemical arm) and flat-mode networks
// (dense graphs and dense blocks), electrical or chemical.
//
// Replaces the TPU kernel spiking_neural_networks_tpu/ops/pallas_reward.py
// :1177 _fused_chunk (call :1183) in its grid-mode plain-network form (body
// _make_kernel, built by plain_network_runner), its reward-network form
// (built by network_runner, :1863-1929; the step :863-987), its chemical
// form (_make_kernel :338, the chemical gather and release :653-832 and
// :1012-1019) and its flat form (plain_network_runner :2041, flat mode
// :2097-2166): the Izhikevich, ALIF and LIF lattices of mixed grid shapes on
// stencil or edgeless graphs, Poisson and Rate trains, one-to-one and
// resample connections, STDP, the R-STDP lattices (kind mod) and the reward
// connections; the Ionotropic and DopaGluGABA receptors with every receptor
// and neurotransmitter kinetics of chem_common.cuh, trains that release a
// neurotransmitter; (1, N) rows with dense (N, N) intra graphs and dense
// blocks, N <= NP_DENSE_MAX.  Per cell the arithmetic is
// network_plasticity.cu's, operation for operation, so the results equal
// the plain twin ops/network_kernels.network_steps_reference bit for bit;
// only the schedule and the place where values live differ.
//
// What bounds the per-step design on an H100: one launch per lattice,
// plastic lattice, updating connection, train and dense gather every step
// (7 a step for config 5, 3 for the chemical bench network, 5 for the
// Bayesian network), a few us each, so below 512 x 512 and in flat mode at
// any width the launches and the host set the rate; at 512 x 512 the
// weights, masks, parameters and a chemical cell's ~300 bytes of receptor
// state and parameters are re-read every step (~97 MB a step for config 5,
// ~205 MB for the chemical network).  This design:
//   1. One cooperative launch per call (chunks of NP_CHUNK steps).  Each
//      block owns a fixed set of 32-cell row-major tiles of every lattice
//      and train for the whole launch (adjacent lanes on adjacent cells),
//      and its warps walk them.  Per step k one phase, then one
//      grid.sync(): step k-1's edge passes and step k's cell step of every
//      lattice, then step k's train step; after the last step an
//      edge-only phase.  cnt and the dopamine of every step are taken
//      before the first phase.
//   2. Every stencil weight, connection weight and R-STDP trace is stored
//      per destination cell, so the thread that owns a cell applies step
//      k-1's STDP / R-STDP visits to its slots and uses the new weights at
//      once in step k's phase A: each weight is read once a step.  A slot
//      whose count is 0 adds delta * 0, which is +-0 without an exp
//      (stdp_zero); its store is skipped where the bits do not change.
//   3. What only a cell's owner reads (a member's weights, masks and, for a
//      mod lattice or a reward connection, its traces; a chemical
//      lattice's receptor and release parameters and its gating values
//      and modifiers; a flat lattice's dense weight columns) lives in the
//      owning block's dynamic shared memory for the whole launch where the
//      residency plan (ops/network_kernels.persistent_plan) fits it, and
//      what the steps change is written back once, after the last edge
//      pass; other members stream from global memory.  What neighbours
//      read (v, lft, the spikes, the concentrations t, the trains' firing
//      times and concentrations) stays in global planes, served from L2:
//      lattice state and concentrations double-buffered by step parity,
//      spike flags double-buffered too (a neighbour's step k-1 flag is read
//      while step k's is written, and a chemical cell releases from its own
//      step k-1 flag), a train's concentrations in two sets (its release of
//      step k writes one while the cells of step k read the other), and the
//      trains' firing times in three sets (the fused visits of step k-1
//      read the times from before the trains' step k-1, phase A of step k
//      those after it, and the train step k writes new ones, all in one
//      phase).  A Rate train's step counter is read only by its owner and is
//      updated in place.
//   4. The chemical arm (CHEM) is net_chem_cell_kernel's body per cell:
//      the per-type gather of the neighbours' step k-1 t * m and its
//      re-expansion, the one-to-one connections' (w * t) * m, the receptor
//      kinetics, the Ionotropic or DopaGluGABA currents at the pre-update
//      v, v_pre, then the release from v_pre and the previous step's spike
//      flag; a train releases after its new spike in its own step.
//   5. Flat mode (FLAT): the lattices' 32-destination tiles are numbered in
//      spec order and block b owns tile b (a flat spec has at most
//      NP_MAX_LAT * 16 tiles, fewer than the blocks), so a block's shared
//      memory holds one tile's dense weight columns: n_src x 32 floats per
//      job (an intra graph's pre-masked, as net_dense_gather_kernel's
//      masked_w does; 64 KB at N = 512).  In one phase the block stages
//      each job's sources (step k-1 v or a train's effect, and per type
//      t * m) in shared memory, takes destination j's partial k over the
//      sources i = k, k + 32, ... in index order (a multiply, then an add),
//      adds the 32 partials from 0 in segment order (the summation
//      contract with the twin's _seg_dot), and then runs the tile's cell
//      step from those sums; the column sums and per-type counts are taken
//      once per launch, before the first phase.
// The description (NetP, 15.2 KB) is a kernel parameter; each block
// copies it into its shared memory first, since its fields are read with
// indices known only at run time in every loop.  The loops over a member's
// slots and a chemical cell's fields are instantiated for resident and
// streamed members apart, so the compiler sees shared-memory stores that
// cannot alias the neighbours' global loads.  The kernel is specialised at
// compile time: the electrical grid instantiation <NP_THREADS, false,
// false> compiles the grid-mode code alone (96 registers at 640 threads);
// the chemical and flat ones take NP_THREADS_CHEM threads a block, for the
// registers of the chemical cell body.
// What bounds this design on an H100 (chip_smoke.py phases 11, 14, 19-24,
// 26 and 28; PERF.md section 6): not bytes.  Each thread walks several
// cells a phase, each a chain of dependent loads and the STDP arithmetic
// of up to 64 slots; so at 512 x 512 a step costs several times its byte
// bound, and at 64 x 64 the chain of one tile and the grid barrier (~1.1
// us) set the step.  Loads issued ahead in per-thread arrays, unrolled
// slot loops, 512-1024-thread blocks and the neighbours staged per warp in
// shared-memory halos were no faster on the card.  Where a chemical
// member streams (2 x 512^2) each thread walks ~8 cells a phase on 16
// warps an SM and this design took 157.6 us a step against the per-step
// launches' 98.1, so ops/network_kernels.uses_persistent sends such specs
// there.  In flat mode a phase runs its tile's dense jobs in turn, each
// with three block barriers and a round trip to L2 for its sources, then
// one warp's cells: 14.9 us a step at 512 + 512 against the per-step
// launches' 27.5.
// No per-step fallback: a refused cooperative launch returns its error.

#include <cooperative_groups.h>

#include "chem_common.cuh"
#include "network_common.cuh"

namespace cg = cooperative_groups;

#define NP_THREADS 640          // the electrical grid instantiation
#define NP_THREADS_CHEM 512     // the chemical and flat instantiations
#define NP_MAX_LAT 8
#define NP_MAX_TR 8
#define NP_MAX_CN 16
#define NP_CHUNK 16
#define NP_DENSE_MAX 512        // a flat lattice, train or block side
#define NP_SEG 32               // partial sums of a dense gather
#define NP_CPAR 16              // a chemical lattice's parameter fields: NT
                                // [3], kinetics [2], r2 kinetics [2],
                                // currents [9]
#define NP_JOBS (1 + NET_MAX_IN)
// strides of the flat descriptions (ops/network_kernels.py PL_I, PL_P,
// PT_I, PT_P, PC_I, PC_P)
#define PL_I (17 + 2 * LP_MAX_OFFSETS)
#define PL_P 70
#define PT_I 5
#define PT_P 21
#define PC_I (16 + 2 * NET_MAX_TAPS)
#define PC_P 9
// flat mode's scratch, after the description in a block's shared memory:
// the staged sources [4][NP_DENSE_MAX], the partial sums [4][NP_SEG][32],
// and per job of the tile its step sums [NP_JOBS][4][32] and call
// constants [NP_JOBS][4][32] (job 0 the intra graph, job 1 + q the q-th
// incoming connection)
#define NP_FLAT_FLOATS \
    (4 * NP_DENSE_MAX + 4 * NP_SEG * 32 + 2 * NP_JOBS * 4 * 32)
#define NP_FLAT_SCRATCH (4 * NP_FLAT_FLOATS)

struct PLat {
    int model, kind, rows, cols, n_off, emit;
    int res, smem_off, cap, rot;          // residency plan; warp rotation
    int n_in;
    int dense, dres, doff;                // flat: a dense intra graph and
                                          // its residency
    int cres_p, coff_p, cres_s, coff_s, ccap;   // chemical parameters and
                                          // state: residency, tiles
    int cp_planes, tile0;                 // float planes of the resident
                                          // parameters; flat: first tile
    signed char in_cn[NET_MAX_IN];        // incoming connections, plan order
    signed char cpl[NP_CPAR];             // resident plane of each chemical
                                          // parameter field, -1: none
    short dr[LP_MAX_OFFSETS], dc[LP_MAX_OFFSETS];
    const float* v_in; const float* w_in; const int* lft_in;
    const float* refr_in;
    float* v[2]; float* w[2]; int* lft[2]; float* refr[2];
    unsigned char* spk[2];
    float* v_pre;
    const float* in_deg; float* cnt;
    const float* wt_in; float* wt;        // stencil weights in, out (a
    const unsigned char* mask;            // plain lattice: wt == wt_in)
    const float* c_in; const float* dw_in; const int* ct_in;
    float* c; float* dw; int* ct;
    const float* p[LP_MAX_PARAMS];
    // the chemical arm: concentrations t in and by parity, the previous
    // step's spike flags in; gating state r, r2, inh and nmda modifiers in
    // and out; currents; masks; parameter fields
    const float* ntt_in; float* ntt[2];
    const unsigned char* spk_in;
    const float* cs_in[4]; float* cs[4];
    float* cur;
    const unsigned char* ntm; const unsigned char* recm;
    const float* cpar[NP_CPAR];
};

struct PTrain {
    int kind, refractoriness, rows, cols, rot, nt;
    const int* lft_in; int* lft[3];
    const float* v_th; const float* v_rest; const float* k; const float* dt;
    const float* chance; const float* u; const float* rate;
    const float* step_in; float* step; unsigned char* spk;
    const float* ntt_in; float* ntt[2]; const unsigned char* ntm;
    const float* ntp[3];
};

struct PConn {
    int kind, pre_is_st, pre, post, pre_plastic, post_plastic;
    int R1, C1, fr, fc, n_taps, stat, reward, updates;
    int res, smem_off, cap;
    short tr[NET_MAX_TAPS], tc[NET_MAX_TAPS];
    const float* w_in; float* w; const unsigned char* mask;
    const float* c_in; const float* dw_in; const int* ct_in;
    float* c; float* dw; int* ct;
};

struct __align__(16) NetP {
    int n_lat, n_tr, n_cn;
    int clock0, k0, n, n_all;  // the call's clock; this launch's first
                               // step and its steps; the call's steps
    int with_reward;
    int fam, rec, ntk, elec;   // the chemical arm (fam -1: none)
    int n_tiles;               // flat mode: the lattices' tiles
    Rule r, rr;
    float exp_dd, tau_d;
    float rewards[NP_CHUNK];
    const float* dop_in;      // null without the reward arm
    float* dop_steps;
    PLat lat[NP_MAX_LAT];
    PTrain tr[NP_MAX_TR];
    PConn cn[NP_MAX_CN];
};

// bytes of a block's dynamic shared memory before flat mode's scratch and
// the resident members: the copy of the description, rounded up to 16
#define NP_DESC ((int)((sizeof(NetP) + 15) / 16 * 16))
static_assert(sizeof(NetP) <= 16384 - 512,
              "the description must leave the resident members the shared "
              "memory ops/network_kernels.SMEM_BUDGET assumes");

// delta(t_pre, t_post) * +0 as stdp_delta's branches give it, without the
// exp: the sign of the selected amplitude (the exp is >= 0), +0 where a
// time is NEVER or the times are equal.
__device__ __forceinline__ float stdp_zero(int t_pre, int t_post,
                                           const Rule& r)
{
    if (t_pre == LP_NEVER || t_post == LP_NEVER) return 0.0f;
    if (t_pre < t_post) return r.a_plus * 0.0f;
    if (t_pre > t_post) return -r.a_minus * 0.0f;
    return 0.0f;
}

// The cells of a member of n cells that this thread owns: block b owns the
// 32-cell tiles [T b / nb, T (b + 1) / nb) of T = ceil(n / 32); its warp w
// (of W) the local tiles j with (j + rot) % W == w, lane l the cell
// 32 (lo + j) + l, whose resident slots sit at column 32 j + l.
struct Own {
    int lo, cnt, j0;
};

template <int W>
__device__ __forceinline__ Own owned(size_t n, int rot)
{
    const long long T = (long long)((n + 31) / 32);
    const int lo = (int)(T * blockIdx.x / gridDim.x);
    const int hi = (int)(T * (blockIdx.x + 1) / gridDim.x);
    const int w = threadIdx.x / 32;
    return {lo, hi - lo, ((w - rot) % W + W) % W};
}

// One cell's slots of a member: slot s of the weights at w[s * st], the
// traces and the mask likewise; in the block's shared memory (resident:
// [slot][32 cap] arrays of weights, then traces c, dw, counter, then mask
// bytes) or in the member's global planes.
struct Slots {
    float* w; float* c; float* dw; int* ct; const unsigned char* m;
    size_t st;
};

__device__ __forceinline__ Slots resident_slots(unsigned char* base, int cap,
                                                int n_slots, bool traces,
                                                int loc)
{
    const size_t cc = (size_t)cap * 32, S = n_slots;
    float* f = (float*)base;
    Slots s;
    s.st = cc;
    s.w = f + loc;
    s.c = traces ? f + S * cc + loc : nullptr;
    s.dw = traces ? f + 2 * S * cc + loc : nullptr;
    s.ct = traces ? (int*)base + 3 * S * cc + loc : nullptr;
    s.m = base + (traces ? 16 : 4) * S * cc + loc;
    return s;
}

// A member's slots in the layout RES says, known to the compiler: in the
// block's shared memory (RES) or in the member's global planes.
template <bool RES>
__device__ __forceinline__ Slots lat_slots_of(const PLat& L,
                                              unsigned char* sm, size_t i,
                                              int loc, size_t n)
{
    if (RES)
        return resident_slots(sm + L.smem_off, L.cap, L.n_off,
                              L.kind == KIND_MOD, loc);
    Slots s;
    s.st = n;
    s.w = L.wt + i;
    s.c = L.c ? L.c + i : nullptr;
    s.dw = L.dw ? L.dw + i : nullptr;
    s.ct = L.ct ? L.ct + i : nullptr;
    s.m = L.mask + i;
    return s;
}

template <bool RES>
__device__ __forceinline__ Slots conn_slots_of(const PConn& C,
                                               unsigned char* sm, size_t i,
                                               int loc, size_t n)
{
    if (RES)
        return resident_slots(sm + C.smem_off, C.cap, C.n_taps, C.reward,
                              loc);
    Slots s;
    s.st = n;
    s.w = C.w + i;
    s.c = C.c ? C.c + i : nullptr;
    s.dw = C.dw ? C.dw + i : nullptr;
    s.ct = C.ct ? C.ct + i : nullptr;
    s.m = C.mask + i;
    return s;
}

__device__ __forceinline__ Slots lat_slots(const PLat& L, unsigned char* sm,
                                           size_t i, int loc, size_t n)
{
    return L.res ? lat_slots_of<true>(L, sm, i, loc, n)
                 : lat_slots_of<false>(L, sm, i, loc, n);
}

__device__ __forceinline__ Slots conn_slots(const PConn& C,
                                            unsigned char* sm, size_t i,
                                            int loc, size_t n)
{
    return C.res ? conn_slots_of<true>(C, sm, i, loc, n)
                 : conn_slots_of<false>(C, sm, i, loc, n);
}

// Moves one cell's n_slots slots of a member between global planes (stride
// n) and its Slots: to the Slots (`in`), or back to the planes.  The mask
// is copied in when `mask`.
__device__ __forceinline__ void move_slots(const Slots& s, int n_slots,
                                           size_t n, size_t i, bool in,
                                           float* w, float* c, float* dw,
                                           int* ct, const float* w_src,
                                           const float* c_src,
                                           const float* dw_src,
                                           const int* ct_src,
                                           const unsigned char* m_src)
{
    for (int o = 0; o < n_slots; ++o) {
        const size_t e = (size_t)o * n + i, f = (size_t)o * s.st;
        if (in) {
            s.w[f] = w_src[e];
            if (s.c) {
                s.c[f] = c_src[e];
                s.dw[f] = dw_src[e];
                s.ct[f] = ct_src[e];
            }
            if (m_src) ((unsigned char*)s.m)[f] = m_src[e];
        } else {
            w[e] = s.w[f];
            if (c) {
                c[e] = s.c[f];
                dw[e] = s.dw[f];
                ct[e] = s.ct[f];
            }
        }
    }
}

// A train's firing times after its step s (s < 0: the call's input).
__device__ __forceinline__ const int* train_lft(const PTrain& T, int s)
{
    return s < 0 ? T.lft_in : T.lft[s % 3];
}

// A train's and a chemical lattice's concentrations after step s.
__device__ __forceinline__ const float* train_ntt(const PTrain& T, int s)
{
    return s < 0 ? T.ntt_in : T.ntt[s & 1];
}

__device__ __forceinline__ const float* lat_ntt(const PLat& L, int s)
{
    return s < 0 ? L.ntt_in : L.ntt[s & 1];
}

// -- a chemical lattice's own fields ----------------------------------------

// Parameter field f (NT [0, 3), kinetics [3, 5), r2 kinetics [5, 7),
// currents [7, 16)) is (N,) for DopaGluGABA's current planes, else (N, 3).
__device__ __forceinline__ int cpar_width(const NetP& P, int f)
{
    return f >= 7 && P.fam == FAM_DOPAGLUGABA ? 1 : 3;
}

// State s (r, r2, inh, nmda): its width and its resident plane of type q.
__device__ __forceinline__ int cs_width(int s) { return s < 2 ? 3 : 1; }
__device__ __forceinline__ int cs_plane(int s, int q)
{
    return s < 2 ? 3 * s + q : 4 + s;
}

// Field f at (cell i, type q): from the block's shared memory where the
// lattice's parameters are resident (RP: float planes [plane][32 ccap],
// then the receptor mask's 3 byte planes), else from its global plane; 0
// for a field the kinetics lacks.
template <bool RP>
__device__ __forceinline__ float cpar(const NetP& P, const PLat& L,
                                      const unsigned char* sm, int f, int q,
                                      size_t i, int loc)
{
    if (RP) {
        const int pl = L.cpl[f];
        return pl < 0 ? 0.0f : ((const float*)(sm + L.coff_p))[
            (size_t)(pl + q) * L.ccap * 32 + loc];
    }
    const float* p = L.cpar[f];
    return p ? p[(size_t)cpar_width(P, f) * i + q] : 0.0f;
}

template <bool RP>
__device__ __forceinline__ bool crecm(const PLat& L, const unsigned char* sm,
                                      int q, size_t i, int loc)
{
    if (RP) {
        const size_t cc = (size_t)L.ccap * 32;
        return sm[L.coff_p + (size_t)L.cp_planes * cc * 4 + q * cc + loc]
            != 0;
    }
    return L.recm[CHEM_TYPES * i + q] != 0;
}

// State s at (i, q): resident (RS), or read from the call's input on its
// first step and from the output after.
template <bool RS>
__device__ __forceinline__ float cs_get(const PLat& L,
                                        const unsigned char* sm, int s,
                                        int q, size_t i, int loc, int g)
{
    if (RS)
        return ((const float*)(sm + L.coff_s))[
            (size_t)cs_plane(s, q) * L.ccap * 32 + loc];
    return (g == 0 ? L.cs_in[s] : L.cs[s])[(size_t)cs_width(s) * i + q];
}

template <bool RS>
__device__ __forceinline__ void cs_set(const PLat& L, unsigned char* sm,
                                       int s, int q, size_t i, int loc,
                                       float x)
{
    if (RS)
        ((float*)(sm + L.coff_s))[(size_t)cs_plane(s, q) * L.ccap * 32
                                  + loc] = x;
    else
        L.cs[s][(size_t)cs_width(s) * i + q] = x;
}

// Before the first phase: a chemical cell's resident parameters from
// their planes, its resident state from the call's input (first launch) or
// the output the last launch wrote.  After the last phase: the resident
// state back to the output.
__device__ __forceinline__ void chem_prologue(const NetP& P, const PLat& L,
                                              unsigned char* sm, size_t i,
                                              int loc)
{
    const size_t cc = (size_t)L.ccap * 32;
    if (L.cres_p) {
        float* f = (float*)(sm + L.coff_p);
        for (int fi = 0; fi < NP_CPAR; ++fi) {
            if (L.cpl[fi] < 0) continue;
            const int w = cpar_width(P, fi);
            for (int q = 0; q < w; ++q)
                f[(size_t)(L.cpl[fi] + q) * cc + loc]
                    = L.cpar[fi][(size_t)w * i + q];
        }
        unsigned char* m = sm + L.coff_p + (size_t)L.cp_planes * cc * 4;
        for (int q = 0; q < CHEM_TYPES; ++q)
            m[q * cc + loc] = L.recm[CHEM_TYPES * i + q];
    }
    if (L.cres_s) {
        float* f = (float*)(sm + L.coff_s);
        const int n_s = P.fam == FAM_DOPAGLUGABA ? 4 : 1;
        for (int s = 0; s < n_s; ++s)
            for (int q = 0; q < cs_width(s); ++q)
                f[(size_t)cs_plane(s, q) * cc + loc]
                    = (P.k0 == 0 ? L.cs_in[s] : L.cs[s])[
                        (size_t)cs_width(s) * i + q];
    }
}

__device__ __forceinline__ void chem_writeback(const NetP& P, const PLat& L,
                                               unsigned char* sm, size_t i,
                                               int loc)
{
    if (!L.cres_s) return;
    const size_t cc = (size_t)L.ccap * 32;
    const float* f = (const float*)(sm + L.coff_s);
    const int n_s = P.fam == FAM_DOPAGLUGABA ? 4 : 1;
    for (int s = 0; s < n_s; ++s)
        for (int q = 0; q < cs_width(s); ++q)
            L.cs[s][(size_t)cs_width(s) * i + q]
                = f[(size_t)cs_plane(s, q) * cc + loc];
}

// -- the visits and phase A -------------------------------------------------

// One visit of a connection slot, from its loaded weight and traces: STDP
// w += delta * count, count = static + pre_plastic * s_pre + post_plastic
// * s_post, or on a reward connection up to two R-STDP visits of (w, c,
// dw, counter), the first where count >= 1, the second where count >= 2
// (net_conn_edge_kernel's); the slot's new values stored at e.
__device__ __forceinline__ void conn_visit(const NetP& P, const PConn& C,
                                           const Slots& S, size_t e,
                                           float& wv, float c, float dw,
                                           int ct, int t_pre, float s_pre,
                                           int t_post, float s_post,
                                           float dop)
{
    float count = (float)C.stat;
    if (C.pre_plastic) count = count + s_pre;
    if (C.post_plastic) count = count + s_post;
    if (!C.reward) {
        const float w2 = wv + (count != 0.0f
            ? stdp_delta(t_pre, t_post, P.r) * count
            : stdp_zero(t_pre, t_post, P.r));
        if (__float_as_int(w2) != __float_as_int(wv)) S.w[e] = w2;
        wv = w2;
        return;
    }
    if (count < 1.0f) return;
    const float delta = stdp_delta(t_pre, t_post, P.rr);
    rstdp_visit(wv, c, dw, ct, delta, dop, P.rr);
    if (count >= 2.0f) rstdp_visit(wv, c, dw, ct, delta, dop, P.rr);
    S.w[e] = wv;
    S.c[e] = c;
    S.dw[e] = dw;
    S.ct[e] = ct;
}

// Phase B of a cell and its writes: i_syn = gap * total / cnt, the model
// step, the step's buffer set, spike flag, firing time and emitted v.
template <int MODEL>
__device__ __forceinline__ void cell_step(const PLat& L, size_t i, size_t n,
                                          int g, int clock, float v,
                                          float w, float refr, int lft,
                                          float total)
{
    const float i_syn = L.p[gap_param<MODEL>()][i] * total / L.cnt[i];
    const bool refractory = MODEL != MODEL_IZHIKEVICH;
    float v_pre, v_new, w_new, refr_new;
    bool spike;
    model_step<MODEL>(L.p, i, v, w, refr, i_syn, v_pre, v_new, w_new,
                      refr_new, spike);
    const int b = g & 1;
    L.v[b][i] = v_new;
    L.w[b][i] = w_new;
    if (refractory) L.refr[b][i] = refr_new;
    L.lft[b][i] = spike ? clock : lft;
    L.spk[b][i] = spike ? 1 : 0;
    if (L.emit) L.v_pre[(size_t)g * n + i] = v_pre;
}

// Before the first phase, for a cell of lattice l: cnt on the call's first
// launch, then the cell's slots of the lattice's stencil graph and of its
// incoming one-to-one and resample connections: into shared memory where
// resident (from the inputs on the first launch, else from the outputs the
// last launch wrote), or copied from input to output on the first launch
// where they stream and are updated.  A chemical lattice's stencil keeps
// its mask beside the weights (its gather reads it every step).
__device__ __forceinline__ void lattice_prologue(const NetP& P, int l,
                                                 size_t i, int loc,
                                                 unsigned char* sm)
{
    const PLat& L = P.lat[l];
    const size_t n = (size_t)L.rows * L.cols;
    const bool first = P.k0 == 0;
    if (first) {
        float c = L.in_deg[i];
        for (int q = 0; q < L.n_in; ++q) {
            const PConn& C = P.cn[L.in_cn[q]];
            for (int t = 0; t < C.n_taps; ++t)   // exact in any order
                c = c + (C.mask[(size_t)t * n + i] ? 1.0f : 0.0f);
        }
        L.cnt[i] = fmaxf(c, 1.0f);
    }
    if (L.n_off) {
        const bool upd = L.kind != KIND_PLAIN;
        const Slots s = lat_slots(L, sm, i, loc, n);
        if (L.res)
            move_slots(s, L.n_off, n, i, true, nullptr, nullptr, nullptr,
                       nullptr, first ? L.wt_in : L.wt,
                       first ? L.c_in : L.c, first ? L.dw_in : L.dw,
                       first ? L.ct_in : L.ct,
                       upd || P.fam >= 0 ? L.mask : nullptr);
        else if (first && upd)
            move_slots(s, L.n_off, n, i, true, nullptr, nullptr, nullptr,
                       nullptr, L.wt_in, L.c_in, L.dw_in, L.ct_in,
                       nullptr);
    }
    for (int q = 0; q < L.n_in; ++q) {
        const PConn& C = P.cn[L.in_cn[q]];
        if (C.kind == CONN_DENSE) continue;   // flat mode's own prologue
        const Slots s = conn_slots(C, sm, i, loc, n);
        const bool mask = C.kind == CONN_ONE2ONE || C.updates;
        if (C.res)
            move_slots(s, C.n_taps, n, i, true, nullptr, nullptr, nullptr,
                       nullptr, first ? C.w_in : C.w, first ? C.c_in : C.c,
                       first ? C.dw_in : C.dw, first ? C.ct_in : C.ct,
                       mask ? C.mask : nullptr);
        else if (first && C.updates)
            move_slots(s, C.n_taps, n, i, true, nullptr, nullptr, nullptr,
                       nullptr, C.w_in, C.c_in, C.dw_in, C.ct_in, nullptr);
    }
}

// After the last edge pass: the resident slots that the steps update, back
// to the output planes.
__device__ __forceinline__ void lattice_writeback(const NetP& P, int l,
                                                  size_t i, int loc,
                                                  unsigned char* sm)
{
    const PLat& L = P.lat[l];
    const size_t n = (size_t)L.rows * L.cols;
    if (L.n_off && L.res && L.kind != KIND_PLAIN)
        move_slots(lat_slots(L, sm, i, loc, n), L.n_off, n, i, false, L.wt,
                   L.c, L.dw, L.ct, nullptr, nullptr, nullptr, nullptr,
                   nullptr);
    for (int q = 0; q < L.n_in; ++q) {
        const PConn& C = P.cn[L.in_cn[q]];
        if (C.res && C.updates)
            move_slots(conn_slots(C, sm, i, loc, n), C.n_taps, n, i, false,
                       C.w, C.c, C.dw, C.ct, nullptr, nullptr, nullptr,
                       nullptr, nullptr);
    }
}

// The stencil slots of a cell (RES: resident): the STDP or R-STDP double
// visit of step sp where `edge`, then, where `cell`, acc = sum_o w_o *
// v[r+dr, c+dc] and wsum = sum_o w_o (with CHEM, where electrical
// synapses are on), and with CHEM per type q the chemical gather sums_q +=
// w_o * (t_q m_q)[r+dr, c+dc] and gcnt_q += mask_o * m_q[r+dr, c+dc] over
// the slots on the grid, from the neighbours' concentrations t_p
// (net_chem_cell_kernel's).  Every load of a slot comes before its visit:
// the neighbour's fields do not wait for the mask, which may stream.
template <bool RES, bool CHEM = false>
__device__ __forceinline__ void stencil_pass(
    const NetP& P, const PLat& L, unsigned char* sm, size_t i, int loc,
    size_t n, int row, int col, const float* v_p, const int* lft_p,
    const unsigned char* spk_p, bool edge, bool cell, int t_post,
    float s_post, float dop, float& acc, float& wsum,
    const float* t_p = nullptr, float* sums = nullptr,
    float* gcnt = nullptr)
{
    const Slots S = lat_slots_of<RES>(L, sm, i, loc, n);
    const bool upd = edge && L.kind != KIND_PLAIN;
    const bool mod = L.kind == KIND_MOD;
    const bool elec = !CHEM || P.elec;
    for (int o = 0; o < L.n_off; ++o) {
        const int sr = row + L.dr[o];
        const int sc = col + L.dc[o];
        const bool in = sr >= 0 && sr < L.rows && sc >= 0
            && sc < L.cols;
        const size_t j = (size_t)sr * L.cols + sc;
        const size_t e = (size_t)o * S.st;
        float wv = S.w[e];
        const bool visit = upd && S.m[e];
        int t_pre = LP_NEVER;
        float s_pre = 0.0f;
        if (upd && in) {
            t_pre = lft_p[j];
            s_pre = spk_p[j] ? 1.0f : 0.0f;
        }
        const float vn = cell && elec && in ? v_p[j] : 0.0f;
        float c = 0.0f, dw = 0.0f;
        int ct = 0;
        if (upd && mod) {
            c = S.c[e];
            dw = S.dw[e];
            ct = S.ct[e];
        }
        if (visit) {
            if (!mod) {
                const float count = s_pre + s_post;
                const float w2 = wv + (count != 0.0f
                    ? stdp_delta(t_pre, t_post, P.r) * count
                    : stdp_zero(t_pre, t_post, P.r));
                if (__float_as_int(w2) != __float_as_int(wv)) S.w[e] = w2;
                wv = w2;
            } else {
                const float delta = stdp_delta(t_pre, t_post, P.rr);
                rstdp_visit(wv, c, dw, ct, delta, dop, P.rr);
                rstdp_visit(wv, c, dw, ct, delta, dop, P.rr);
                S.w[e] = wv;
                S.c[e] = c;
                S.dw[e] = dw;
                S.ct[e] = ct;
            }
        }
        if (cell && elec) {
            if (in) acc = acc + wv * vn;
            wsum = wsum + wv;
        }
        if (CHEM && cell && in) {
            const float em = S.m[e] ? 1.0f : 0.0f;
            const size_t j3 = (size_t)CHEM_TYPES * j;
            for (int q = 0; q < CHEM_TYPES; ++q) {
                const float mq = L.ntm[j3 + q] ? 1.0f : 0.0f;
                sums[q] = sums[q] + wv * (t_p[j3 + q] * mq);
                gcnt[q] = gcnt[q] + em * mq;
            }
        }
    }
}

// One incoming connection of a cell (RES: its slots resident): its
// visits of step sp where `edge`, then its term of phase A added to
// `total` where `cell` (CHEM: where electrical synapses are on), and with
// CHEM its chemical term (w * t) * m and m where its mask holds and its
// source has a neurotransmitter, added to csum and ccnt.
template <bool RES, bool CHEM = false>
__device__ __forceinline__ float conn_pass(
    const NetP& P, const PConn& C, unsigned char* sm, size_t i, int loc,
    size_t n, int row, int col, int sp, bool edge, bool cell, int clock,
    float v, int t_post, float s_post, float dop, float total,
    float* csum = nullptr, float* ccnt = nullptr)
{
    const int b = sp & 1;
    const Slots S = conn_slots_of<RES>(C, sm, i, loc, n);
    const bool upd = edge && C.updates;
    const bool elec = cell && (!CHEM || P.elec);
    const PTrain& T = P.tr[C.pre_is_st ? C.pre : 0];
    const PLat& Q = P.lat[C.pre_is_st ? 0 : C.pre];
    // the pre side: a lattice's v before step g and its firing times
    // and flags after step sp; a train's firing times before its step
    // g (for the effect) and before its step sp (for the visits)
    const float* pv_ = C.pre_is_st ? nullptr
                                   : (sp < 0 ? Q.v_in : Q.v[b]);
    const int* plft = !upd ? nullptr
        : C.pre_is_st ? train_lft(T, sp - 1) : Q.lft[b];
    const unsigned char* pspk = C.pre_is_st ? nullptr : Q.spk[b];
    const int* tlft = C.pre_is_st && elec ? train_lft(T, sp) : nullptr;
    if (C.kind == CONN_ONE2ONE) {
        float wv = S.w[0];
        const bool m = S.m[0] != 0;
        int t_pre = 0;
        float s_pre = 0.0f, c = 0.0f, dw = 0.0f, a = 0.0f;
        int ct = 0;
        if (upd) {
            t_pre = plft[i];
            if (C.pre_plastic) s_pre = pspk[i] ? 1.0f : 0.0f;
            if (C.reward) {
                c = S.c[0];
                dw = S.dw[0];
                ct = S.ct[0];
            }
        }
        if (elec)
            a = C.pre_is_st
                ? train_effect(tlft, T.v_th, T.v_rest, T.k, T.dt,
                               T.refractoriness, i, clock)
                : pv_[i] - v;
        if (upd && m)
            conn_visit(P, C, S, 0, wv, c, dw, ct, t_pre, s_pre, t_post,
                       s_post, dop);
        if (CHEM && cell && m) {
            const unsigned char* pm = C.pre_is_st
                ? (T.nt >= 0 ? T.ntm : nullptr) : Q.ntm;
            if (pm) {
                const float* pt = C.pre_is_st ? train_ntt(T, sp)
                                              : lat_ntt(Q, sp);
                const size_t i3 = (size_t)CHEM_TYPES * i;
                for (int q = 0; q < CHEM_TYPES; ++q) {
                    const float mq = pm[i3 + q] ? 1.0f : 0.0f;
                    csum[q] = csum[q] + wv * pt[i3 + q] * mq;
                    ccnt[q] = ccnt[q] + mq;
                }
            }
        }
        return elec ? total + (m ? 1.0f : 0.0f) * wv * a : total;
    }
    float tacc = 0.0f;
    for (int t = 0; t < C.n_taps; ++t) {
        const int sr = resample_index(C.fr, row, C.tr[t]);
        const int sc = resample_index(C.fc, col, C.tc[t]);
        const bool inb = sr >= 0 && sr < C.R1 && sc >= 0 && sc < C.C1;
        const size_t j = (size_t)sr * C.C1 + sc;
        const size_t e = (size_t)t * S.st;
        float wv = S.w[e];
        const bool visit = upd && S.m[e];
        int t_pre = 0;
        float s_pre = 0.0f, c = 0.0f, dw = 0.0f;
        int ct = 0;
        if (upd && inb) {
            t_pre = plft[j];
            if (C.pre_plastic) s_pre = pspk[j] ? 1.0f : 0.0f;
        }
        if (upd && C.reward) {
            c = S.c[e];
            dw = S.dw[e];
            ct = S.ct[e];
        }
        // the term's source value: a train's effect, or a - sub * v
        float a = 0.0f;
        if (elec && C.pre_is_st) {
            if (inb)
                a = train_effect(tlft, T.v_th, T.v_rest, T.k, T.dt,
                                 T.refractoriness, j, clock);
        } else if (elec) {
            const float src = inb ? pv_[j] : 0.0f;
            const float sub = inb ? 1.0f : 0.0f;
            a = src - sub * v;
        }
        if (visit)
            conn_visit(P, C, S, e, wv, c, dw, ct, t_pre, s_pre, t_post,
                       s_post, dop);
        if (elec) tacc = tacc + wv * a;
    }
    return elec ? total + tacc : total;
}

// Phase k of a cell of lattice l: the edge passes of step g - 1 (k > 0),
// fused into phase A of step g = k0 + k (k < n), then phase B.
__device__ __forceinline__ void lattice_phase(const NetP& P, int l,
                                              size_t i, int loc,
                                              unsigned char* sm, int k)
{
    const PLat& L = P.lat[l];
    const size_t n = (size_t)L.rows * L.cols;
    const int g = P.k0 + k;
    const int sp = g - 1;                 // the previous step
    const bool cell = k < P.n, edge = k > 0;
    const int b = sp & 1;                 // its buffer set (sp >= 0)
    const int row = (int)i / L.cols, col = (int)i - row * L.cols;
    const float* v_p = sp < 0 ? L.v_in : L.v[b];
    const int* lft_p = sp < 0 ? L.lft_in : L.lft[b];
    const unsigned char* spk_p = L.spk[b];
    const int clock = P.clock0 + g;

    float dop = 0.0f, s_post = 0.0f;
    int t_post = 0;
    if (edge) {
        if (P.dop_in) dop = P.with_reward ? P.dop_steps[sp] : *P.dop_in;
        t_post = lft_p[i];
        s_post = spk_p[i] ? 1.0f : 0.0f;
    }
    const float v = cell ? v_p[i] : 0.0f;

    // the stencil slots: STDP or the R-STDP double visit of step sp, then
    // acc = sum_o w_o * v[r+dr, c+dc], wsum = sum_o w_o
    float acc = 0.0f, wsum = 0.0f;
    if (L.n_off && L.res)
        stencil_pass<true>(P, L, sm, i, loc, n, row, col, v_p, lft_p, spk_p,
                           edge, cell, t_post, s_post, dop, acc, wsum);
    else if (L.n_off)
        stencil_pass<false>(P, L, sm, i, loc, n, row, col, v_p, lft_p,
                            spk_p, edge, cell, t_post, s_post, dop, acc,
                            wsum);

    // each incoming connection in plan order: its visits of step sp, then
    // its term of phase A
    float total = acc - v * wsum;
    for (int q = 0; q < L.n_in; ++q) {
        const PConn& C = P.cn[L.in_cn[q]];
        total = C.res ? conn_pass<true>(P, C, sm, i, loc, n, row, col, sp,
                                        edge, cell, clock, v, t_post, s_post,
                                        dop, total)
                      : conn_pass<false>(P, C, sm, i, loc, n, row, col, sp,
                                         edge, cell, clock, v, t_post,
                                         s_post, dop, total);
    }
    if (!cell) return;

    const float w = (sp < 0 ? L.w_in : L.w[b])[i];
    const int lft = lft_p[i];
    const float refr = L.model == MODEL_IZHIKEVICH ? 0.0f
        : (sp < 0 ? L.refr_in : L.refr[b])[i];
    switch (L.model) {
    case MODEL_IZHIKEVICH:
        cell_step<MODEL_IZHIKEVICH>(L, i, n, g, clock, v, w, 0.0f, lft,
                                    total);
        break;
    case MODEL_ALIF:
        cell_step<MODEL_ALIF>(L, i, n, g, clock, v, w, refr, lft, total);
        break;
    default:
        cell_step<MODEL_LIF>(L, i, n, g, clock, v, w, refr, lft, total);
    }
}

// -- the chemical cell -------------------------------------------------------

// Phases A' (from the summed csum, ccnt), B' and B of a chemical cell at
// step g and its writes (net_chem_cell_kernel's): t_in = csum / max(ccnt,
// 1) on valid, inserted slots; the receptor kinetics; the Ionotropic or
// DopaGluGABA currents at the pre-update v and rec_dv; the model step less
// rec_dv; the release from v_pre and the previous step's spike flag; the
// currents on the call's last step.  RP, RS: parameters, state resident.
template <int MODEL, bool RP, bool RS>
__device__ __forceinline__ void chem_cell(const NetP& P, const PLat& L,
                                          unsigned char* sm, size_t i,
                                          int loc, size_t n, int g,
                                          int clock, float v, float w,
                                          float refr, int lft, float i_syn,
                                          const float* csum,
                                          const float* ccnt)
{
    const size_t i3 = (size_t)CHEM_TYPES * i;
    float t_in[CHEM_TYPES];
    bool upd[CHEM_TYPES];
    for (int q = 0; q < CHEM_TYPES; ++q) {
        t_in[q] = csum[q] / fmaxf(ccnt[q], 1.0f);
        upd[q] = ccnt[q] > 0.0f && crecm<RP>(L, sm, q, i, loc);
    }
    const bool izh = MODEL == MODEL_IZHIKEVICH;
    const float dt = L.p[izh ? izh::dt : alif::dt][i];
    const float dt_cm = dt / L.p[izh ? izh::c_m : alif::c_m][i];
    const float ex = kernel_exp(-0.062f * v);
    float r[CHEM_TYPES], cur[CHEM_TYPES], rec_dv;
    for (int q = 0; q < CHEM_TYPES; ++q) {
        r[q] = cs_get<RS>(L, sm, 0, q, i, loc, g);
        if (upd[q])
            r[q] = rec_kinetics(P.rec, r[q], t_in[q],
                                cpar<RP>(P, L, sm, 3, q, i, loc),
                                cpar<RP>(P, L, sm, 4, q, i, loc), dt);
        cs_set<RS>(L, sm, 0, q, i, loc, r[q]);
    }
    if (P.fam == FAM_DOPAGLUGABA) {
        float r2[CHEM_TYPES];
        for (int q = 0; q < CHEM_TYPES; ++q) {
            r2[q] = cs_get<RS>(L, sm, 1, q, i, loc, g);
            if (upd[q])
                r2[q] = rec_kinetics(P.rec, r2[q], t_in[q],
                                     cpar<RP>(P, L, sm, 5, q, i, loc),
                                     cpar<RP>(P, L, sm, 6, q, i, loc), dt);
            cs_set<RS>(L, sm, 1, q, i, loc, r2[q]);
        }
        // DOPA_PLANES (fields 7-15): g_ampa, g_nmda, e_ampa, e_nmda, mg,
        // g_gaba, e_gaba, s_d1, s_d2; the modifiers are the previous
        // step's
        const float inh = cs_get<RS>(L, sm, 2, 0, i, loc, g);
        const float nmda = cs_get<RS>(L, sm, 3, 0, i, loc, g);
        const float block = 1.0f
            / (1.0f + ex * cpar<RP>(P, L, sm, 11, 0, i, loc) / 3.57f);
        float glu = inh * cpar<RP>(P, L, sm, 7, 0, i, loc) * r[0]
                * (v - cpar<RP>(P, L, sm, 9, 0, i, loc))
            + block * inh * cpar<RP>(P, L, sm, 8, 0, i, loc)
                * kernel_pow(r2[0], nmda)
                * (v - cpar<RP>(P, L, sm, 10, 0, i, loc));
        if (!crecm<RP>(L, sm, 0, i, loc)) glu = 0.0f;
        float gaba = cpar<RP>(P, L, sm, 12, 0, i, loc) * r[1]
            * (v - cpar<RP>(P, L, sm, 13, 0, i, loc));
        if (!crecm<RP>(L, sm, 1, i, loc)) gaba = 0.0f;
        const bool d = crecm<RP>(L, sm, 2, i, loc);
        cs_set<RS>(L, sm, 2, 0, i, loc,
                   d ? 1.0f - r2[2] * cpar<RP>(P, L, sm, 15, 0, i, loc)
                     : inh);
        cs_set<RS>(L, sm, 3, 0, i, loc,
                   d ? 1.0f - r[2] * cpar<RP>(P, L, sm, 14, 0, i, loc)
                     : nmda);
        cur[0] = glu;
        cur[1] = gaba;
        cur[2] = 0.0f;
        rec_dv = (glu + gaba) * dt_cm;
    } else {
        // g, e, mg per type (fields 7-9); the NMDA block at 3.75
        const float block = 1.0f
            / (1.0f + ex * cpar<RP>(P, L, sm, 9, 1, i, loc) / 3.75f);
        for (int q = 0; q < CHEM_TYPES; ++q) {
            float c = cpar<RP>(P, L, sm, 7, q, i, loc) * r[q]
                * (v - cpar<RP>(P, L, sm, 8, q, i, loc));
            if (q == 1) c = c * block;
            cur[q] = crecm<RP>(L, sm, q, i, loc) ? c : 0.0f;
        }
        rec_dv = (cur[0] + cur[1] + cur[2]) * dt_cm;
    }

    const bool refractory = MODEL != MODEL_IZHIKEVICH;
    float v_pre, v_new, w_new, refr_new;
    bool spike;
    model_step<MODEL>(L.p, i, v, w, refr, i_syn, v_pre, v_new, w_new,
                      refr_new, spike, rec_dv);
    const int b = g & 1;
    const float spk_prev =
        (g == 0 ? L.spk_in : L.spk[(g - 1) & 1])[i] ? 1.0f : 0.0f;
    const float* t_prev = lat_ntt(L, g - 1);
    const bool last = g == P.n_all - 1;
    for (int q = 0; q < CHEM_TYPES; ++q) {
        const float t = nt_release(P.ntk, t_prev[i3 + q], v_pre, spk_prev,
                                   cpar<RP>(P, L, sm, 0, q, i, loc),
                                   cpar<RP>(P, L, sm, 1, q, i, loc),
                                   cpar<RP>(P, L, sm, 2, q, i, loc), dt);
        L.ntt[b][i3 + q] = L.ntm[i3 + q] ? t : 0.0f;
        if (last) L.cur[i3 + q] = cur[q];
    }
    L.v[b][i] = v_new;
    L.w[b][i] = w_new;
    if (refractory) L.refr[b][i] = refr_new;
    L.lft[b][i] = spike ? clock : lft;
    L.spk[b][i] = spike ? 1 : 0;
    if (L.emit) L.v_pre[(size_t)g * n + i] = v_pre;
}

// csum_q, ccnt_q from the intra sums and counts: (sums / max(cnt, 1)) *
// max(cnt, 1) * (cnt > 0), and the counts.
__device__ __forceinline__ void chem_reexpand(const float* sums,
                                              const float* gcnt,
                                              float* csum, float* ccnt)
{
    for (int q = 0; q < CHEM_TYPES; ++q) {
        const float g1 = fmaxf(gcnt[q], 1.0f);
        csum[q] = sums[q] / g1 * g1 * (gcnt[q] > 0.0f ? 1.0f : 0.0f);
        ccnt[q] = gcnt[q];
    }
}

// Phase k of a cell of chemical lattice l in grid mode: step g - 1's STDP
// (a plastic lattice, the connections with a plastic endpoint) fused into
// phases A and A' of step g, then the chemical cell.
template <int MODEL, bool RP, bool RS>
__device__ __forceinline__ void chem_lattice_phase(const NetP& P, int l,
                                                   size_t i, int loc,
                                                   unsigned char* sm, int k)
{
    const PLat& L = P.lat[l];
    const size_t n = (size_t)L.rows * L.cols;
    const int g = P.k0 + k;
    const int sp = g - 1;
    const bool cell = k < P.n, edge = k > 0;
    const int b = sp & 1;
    const int row = (int)i / L.cols, col = (int)i - row * L.cols;
    const float* v_p = sp < 0 ? L.v_in : L.v[b];
    const int* lft_p = sp < 0 ? L.lft_in : L.lft[b];
    const unsigned char* spk_p = L.spk[b];
    const float* t_p = lat_ntt(L, sp);
    const int clock = P.clock0 + g;

    float s_post = 0.0f;
    int t_post = 0;
    if (edge) {
        t_post = lft_p[i];
        s_post = spk_p[i] ? 1.0f : 0.0f;
    }
    const float v = cell ? v_p[i] : 0.0f;
    float acc = 0.0f, wsum = 0.0f;
    float sums[CHEM_TYPES] = {0.0f, 0.0f, 0.0f};
    float gcnt[CHEM_TYPES] = {0.0f, 0.0f, 0.0f};
    if (L.n_off && L.res)
        stencil_pass<true, true>(P, L, sm, i, loc, n, row, col, v_p, lft_p,
                                 spk_p, edge, cell, t_post, s_post, 0.0f,
                                 acc, wsum, t_p, sums, gcnt);
    else if (L.n_off)
        stencil_pass<false, true>(P, L, sm, i, loc, n, row, col, v_p,
                                  lft_p, spk_p, edge, cell, t_post, s_post,
                                  0.0f, acc, wsum, t_p, sums, gcnt);
    float csum[CHEM_TYPES], ccnt[CHEM_TYPES];
    chem_reexpand(sums, gcnt, csum, ccnt);
    float total = acc - v * wsum;
    for (int q = 0; q < L.n_in; ++q) {
        const PConn& C = P.cn[L.in_cn[q]];
        total = C.res
            ? conn_pass<true, true>(P, C, sm, i, loc, n, row, col, sp, edge,
                                    cell, clock, v, t_post, s_post, 0.0f,
                                    total, csum, ccnt)
            : conn_pass<false, true>(P, C, sm, i, loc, n, row, col, sp,
                                     edge, cell, clock, v, t_post, s_post,
                                     0.0f, total, csum, ccnt);
    }
    if (!cell) return;
    const float i_syn = P.elec
        ? L.p[gap_param<MODEL>()][i] * total / L.cnt[i] : 0.0f;
    const float w = (sp < 0 ? L.w_in : L.w[b])[i];
    const float refr = MODEL == MODEL_IZHIKEVICH ? 0.0f
        : (sp < 0 ? L.refr_in : L.refr[b])[i];
    chem_cell<MODEL, RP, RS>(P, L, sm, i, loc, n, g, clock, v, w, refr,
                             lft_p[i], i_syn, csum, ccnt);
}

__device__ __forceinline__ void chem_dispatch(const NetP& P, int l, size_t i,
                                              int loc, unsigned char* sm,
                                              int k)
{
    const PLat& L = P.lat[l];
    const int sel = (L.cres_p ? 2 : 0) + (L.cres_s ? 1 : 0);
#define NP_CHEM_CASES(M)                                                   \
    switch (sel) {                                                         \
    case 0: chem_lattice_phase<M, false, false>(P, l, i, loc, sm, k); break; \
    case 1: chem_lattice_phase<M, false, true>(P, l, i, loc, sm, k); break; \
    case 2: chem_lattice_phase<M, true, false>(P, l, i, loc, sm, k); break; \
    default: chem_lattice_phase<M, true, true>(P, l, i, loc, sm, k);      \
    }
    if (L.model == MODEL_IZHIKEVICH) {
        NP_CHEM_CASES(MODEL_IZHIKEVICH)
    } else {
        NP_CHEM_CASES(MODEL_ALIF)
    }
#undef NP_CHEM_CASES
}

// -- flat mode ---------------------------------------------------------------

// Flat scratch (floats from the end of the description): staged sources
// (at fs), partial sums, per-job step sums and call constants.
__device__ __forceinline__ float* flat_part(float* fs)
{
    return fs + 4 * NP_DENSE_MAX;
}
__device__ __forceinline__ float* flat_sums(float* fs, bool constants)
{
    return fs + 4 * NP_DENSE_MAX + 4 * NP_SEG * 32
        + (constants ? NP_JOBS * 4 * 32 : 0);
}

// The matrix of job q (-1: lattice L's dense intra graph; else its q-th
// incoming connection, a dense block) and its source.
struct Job {
    const float* w;
    const unsigned char* mask;
    int n_src, res, off;
    bool intra, sub;
    const PTrain* T;            // a train source, or
    const PLat* Q;              // a lattice source
};

__device__ __forceinline__ Job job_of(const NetP& P, const PLat& L, int q)
{
    if (q < 0)
        return Job{L.wt_in, L.mask, L.cols, L.dres, L.doff, true, true,
                   nullptr, &L};
    const PConn& C = P.cn[L.in_cn[q]];
    return Job{C.w_in, C.mask, C.n_taps, C.res, C.smem_off, false,
               !C.pre_is_st, C.pre_is_st ? &P.tr[C.pre] : nullptr,
               C.pre_is_st ? nullptr : &P.lat[C.pre]};
}

// Before the first phase: a resident job's 32 weight columns of `tile`
// into the block's shared memory, [n_src][32] (an intra graph's masked).
template <int THREADS>
__device__ __forceinline__ void job_load(const Job& J, int tile,
                                         size_t n_post, unsigned char* sm)
{
    float* ws = (float*)(sm + J.off);
    for (int p = threadIdx.x; p < J.n_src * 32; p += THREADS) {
        const int s = p >> 5, j = p & 31;
        const size_t jj = (size_t)tile * 32 + j;
        float wv = 0.0f;
        if (jj < n_post) {
            const size_t e = (size_t)s * n_post + jj;
            wv = J.w[e];
            if (J.intra && !J.mask[e]) wv = 0.0f;
        }
        ws[p] = wv;
    }
}

// One dense job's sums for the 32 destinations of `tile` at step g
// (net_dense_gather_kernel's per block): per step (constants false) the
// electrical sum of a_i * W_ij over the sources' step g - 1 v or, from a
// train, its effects of step g, and per type the sum of (t m)_iq * W_ij;
// once per launch (constants true) the column sums of W (0 from a train)
// and per type the counts sum_i m_iq * mask_ij.  Destination j's partial
// k sums the sources i = k, k + 32, ... in order (a multiply, then an
// add); the 32 partials are added from 0 in segment order into
// flat_sums(fs, constants)[(1 + q) * 128 + row * 32 + j].
template <int THREADS>
__device__ __forceinline__ void dense_job(const NetP& P, const PLat& L,
                                          int q, int tile, bool constants,
                                          int g, float* fs,
                                          const unsigned char* sm)
{
    const Job J = job_of(P, L, q);
    const size_t n_post = (size_t)L.cols;
    const bool chem = P.fam >= 0 && (J.T ? J.T->nt >= 0 : true);
    const bool elec = P.elec != 0;
    float* stage = fs;
    float* part = flat_part(fs);
    const int sp = g - 1;
    for (int s = threadIdx.x; s < J.n_src; s += THREADS) {
        const unsigned char* m = J.T ? J.T->ntm : J.Q->ntm;
        if (constants) {
            if (chem)
                for (int qq = 0; qq < CHEM_TYPES; ++qq)
                    stage[(1 + qq) * NP_DENSE_MAX + s]
                        = m[CHEM_TYPES * s + qq] ? 1.0f : 0.0f;
            continue;
        }
        if (elec)
            stage[s] = J.T
                ? train_effect(train_lft(*J.T, sp), J.T->v_th, J.T->v_rest,
                               J.T->k, J.T->dt, J.T->refractoriness, s,
                               P.clock0 + g)
                : (sp < 0 ? J.Q->v_in : J.Q->v[sp & 1])[s];
        if (chem) {
            const float* t = J.T ? train_ntt(*J.T, sp) : lat_ntt(*J.Q, sp);
            for (int qq = 0; qq < CHEM_TYPES; ++qq) {
                const size_t e = (size_t)CHEM_TYPES * s + qq;
                stage[(1 + qq) * NP_DENSE_MAX + s]
                    = t[e] * (m[e] ? 1.0f : 0.0f);
            }
        }
    }
    __syncthreads();
    const float* ws = (const float*)(sm + J.off);
    for (int p = threadIdx.x; p < NP_SEG * 32; p += THREADS) {
        const int j = p & 31, kk = p >> 5;
        const size_t jj = (size_t)tile * 32 + j;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        if (jj < n_post) {
            for (int s = kk; s < J.n_src; s += NP_SEG) {
                const size_t e = (size_t)s * n_post + jj;
                float wv;
                if (J.res) {
                    wv = ws[s * 32 + j];
                } else {
                    wv = J.w[e];
                    if (J.intra && !J.mask[e]) wv = 0.0f;
                }
                if (constants) {
                    if (J.sub) a0 = a0 + wv;
                    if (chem) {
                        const float cm = J.mask[e] ? 1.0f : 0.0f;
                        a1 = a1 + stage[NP_DENSE_MAX + s] * cm;
                        a2 = a2 + stage[2 * NP_DENSE_MAX + s] * cm;
                        a3 = a3 + stage[3 * NP_DENSE_MAX + s] * cm;
                    }
                } else {
                    if (elec) a0 = a0 + stage[s] * wv;
                    if (chem) {
                        a1 = a1 + stage[NP_DENSE_MAX + s] * wv;
                        a2 = a2 + stage[2 * NP_DENSE_MAX + s] * wv;
                        a3 = a3 + stage[3 * NP_DENSE_MAX + s] * wv;
                    }
                }
            }
        }
        part[(0 * NP_SEG + kk) * 32 + j] = a0;
        part[(1 * NP_SEG + kk) * 32 + j] = a1;
        part[(2 * NP_SEG + kk) * 32 + j] = a2;
        part[(3 * NP_SEG + kk) * 32 + j] = a3;
    }
    __syncthreads();
    float* out = flat_sums(fs, constants) + (1 + q) * 128;
    for (int p = threadIdx.x; p < 4 * 32; p += THREADS) {
        const int row = p >> 5, j = p & 31;
        float t = 0.0f;
        for (int seg = 0; seg < NP_SEG; ++seg)
            t = t + part[(row * NP_SEG + seg) * 32 + j];
        out[row * 32 + j] = t;
    }
    __syncthreads();
}

// Before the first phase, the block's tile of flat lattice l: cnt, the
// resident one-to-one slots and chemical fields of its 32 cells (the first
// warp), the resident weight columns of its dense jobs, then each job's
// call constants.
template <int THREADS>
__device__ __forceinline__ void flat_prologue(const NetP& P, int l,
                                              int tile, float* fs,
                                              unsigned char* sm)
{
    const PLat& L = P.lat[l];
    const size_t n = (size_t)L.cols;
    const size_t i = (size_t)tile * 32 + (threadIdx.x & 31);
    if (threadIdx.x < 32 && i < n) {
        lattice_prologue(P, l, i, threadIdx.x, sm);
        if (P.fam >= 0) chem_prologue(P, L, sm, i, threadIdx.x);
    }
    for (int q = -1; q < L.n_in; ++q) {
        if (q < 0 ? !L.dense : P.cn[L.in_cn[q]].kind != CONN_DENSE)
            continue;
        const Job J = job_of(P, L, q);
        if (J.res) job_load<THREADS>(J, tile, n, sm);
    }
    __syncthreads();
    for (int q = -1; q < L.n_in; ++q) {
        if (q < 0 ? !L.dense : P.cn[L.in_cn[q]].kind != CONN_DENSE)
            continue;
        dense_job<THREADS>(P, L, q, tile, true, P.k0, fs, sm);
    }
}

// Step g's cell of flat lattice L at i (lane `loc` of the tile), from the
// dense jobs' step sums `ss` and call constants `cc` (job 0 the intra
// graph, 1 + q the q-th connection): the electrical total ((wa - v wsub) /
// d * d for a dense graph, acc - v * wsum with nothing summed for an
// edgeless one, then each connection in plan order: a dense block's wa - v
// * wsub, or the one-to-one term), with CHEM the chemical input (the
// re-expanded intra sums and counts, then each connection's), then the
// cell step.
template <int MODEL, bool CHEM, bool RP, bool RS>
__device__ __forceinline__ void flat_cell(const NetP& P, int l, size_t i,
                                          int loc, unsigned char* sm,
                                          int g, const float* ss,
                                          const float* cc)
{
    const PLat& L = P.lat[l];
    const size_t n = (size_t)L.cols;
    const int sp = g - 1;
    const int b = sp & 1;
    const int clock = P.clock0 + g;
    const float* v_p = sp < 0 ? L.v_in : L.v[b];
    const float v = v_p[i];
    float total;
    if (L.dense) {
        const float d = fmaxf(L.in_deg[i], 1.0f);
        total = (ss[loc] - v * cc[loc]) / d * d;
    } else {
        const float acc = 0.0f, wsum = 0.0f;
        total = acc - v * wsum;
    }
    float csum[CHEM_TYPES], ccnt[CHEM_TYPES];
    if (CHEM) {
        float sums[CHEM_TYPES], gcnt[CHEM_TYPES];
        for (int q = 0; q < CHEM_TYPES; ++q) {
            sums[q] = L.dense ? ss[(1 + q) * 32 + loc] : 0.0f;
            gcnt[q] = L.dense ? cc[(1 + q) * 32 + loc] : 0.0f;
        }
        chem_reexpand(sums, gcnt, csum, ccnt);
    }
    for (int q = 0; q < L.n_in; ++q) {
        const PConn& C = P.cn[L.in_cn[q]];
        if (C.kind != CONN_DENSE) {
            total = C.res
                ? conn_pass<true, CHEM>(P, C, sm, i, loc, n, 0, (int)i, sp,
                                        false, true, clock, v, 0, 0.0f,
                                        0.0f, total, csum, ccnt)
                : conn_pass<false, CHEM>(P, C, sm, i, loc, n, 0, (int)i, sp,
                                         false, true, clock, v, 0, 0.0f,
                                         0.0f, total, csum, ccnt);
            continue;
        }
        const float* js = ss + (1 + q) * 128;
        const float* jc = cc + (1 + q) * 128;
        if (!CHEM || P.elec) total = total + (js[loc] - v * jc[loc]);
        if (CHEM && (!C.pre_is_st || P.tr[C.pre].nt >= 0))
            for (int qq = 0; qq < CHEM_TYPES; ++qq) {
                csum[qq] = csum[qq] + js[(1 + qq) * 32 + loc];
                ccnt[qq] = ccnt[qq] + jc[(1 + qq) * 32 + loc];
            }
    }
    const float w = (sp < 0 ? L.w_in : L.w[b])[i];
    const int lft = (sp < 0 ? L.lft_in : L.lft[b])[i];
    const float refr = MODEL == MODEL_IZHIKEVICH ? 0.0f
        : (sp < 0 ? L.refr_in : L.refr[b])[i];
    if (!CHEM) {
        cell_step<MODEL>(L, i, n, g, clock, v, w, refr, lft, total);
        return;
    }
    const float i_syn = P.elec
        ? L.p[gap_param<MODEL>()][i] * total / L.cnt[i] : 0.0f;
    chem_cell<MODEL, RP, RS>(P, L, sm, i, loc, n, g, clock, v, w, refr, lft,
                             i_syn, csum, ccnt);
}

// Phase k < n of the block's tile of flat lattice l: every dense job into
// the tile, then the tile's cells (the first warp).
template <int THREADS, bool CHEM>
__device__ __forceinline__ void flat_phase(const NetP& P, int l, int tile,
                                           float* fs, unsigned char* sm,
                                           int k)
{
    const PLat& L = P.lat[l];
    const int g = P.k0 + k;
    for (int q = -1; q < L.n_in; ++q) {
        if (q < 0 ? !L.dense : P.cn[L.in_cn[q]].kind != CONN_DENSE)
            continue;
        dense_job<THREADS>(P, L, q, tile, false, g, fs, sm);
    }
    const size_t i = (size_t)tile * 32 + threadIdx.x;
    if (threadIdx.x >= 32 || i >= (size_t)L.cols) return;
    const float* ss = flat_sums(fs, false);
    const float* cc = flat_sums(fs, true);
    const int loc = threadIdx.x;
    if (!CHEM) {
        switch (L.model) {
        case MODEL_IZHIKEVICH:
            flat_cell<MODEL_IZHIKEVICH, false, false, false>(P, l, i, loc,
                                                             sm, g, ss, cc);
            break;
        case MODEL_ALIF:
            flat_cell<MODEL_ALIF, false, false, false>(P, l, i, loc, sm, g,
                                                       ss, cc);
            break;
        default:
            flat_cell<MODEL_LIF, false, false, false>(P, l, i, loc, sm, g,
                                                      ss, cc);
        }
        return;
    }
    const int sel = (L.cres_p ? 2 : 0) + (L.cres_s ? 1 : 0);
#define NP_FLAT_CASES(M)                                                   \
    switch (sel) {                                                         \
    case 0: flat_cell<M, true, false, false>(P, l, i, loc, sm, g, ss, cc); \
        break;                                                             \
    case 1: flat_cell<M, true, false, true>(P, l, i, loc, sm, g, ss, cc);  \
        break;                                                             \
    case 2: flat_cell<M, true, true, false>(P, l, i, loc, sm, g, ss, cc);  \
        break;                                                             \
    default: flat_cell<M, true, true, true>(P, l, i, loc, sm, g, ss, cc);  \
    }
    if (L.model == MODEL_IZHIKEVICH) {
        NP_FLAT_CASES(MODEL_IZHIKEVICH)
    } else {
        NP_FLAT_CASES(MODEL_ALIF)
    }
#undef NP_FLAT_CASES
}

// -- trains ------------------------------------------------------------------

// Step g = k0 + k of a train cell (net_train_kernel's): Poisson u_g <=
// chance, Rate step + dt >= rate; the firing times into set g % 3; with
// CHEM and a neurotransmitter, the release after the new spike, from v_th
// or v_resting, into concentration set g % 2.
template <bool CHEM>
__device__ __forceinline__ void train_phase(const NetP& P, int j, size_t i,
                                            int k)
{
    const PTrain& T = P.tr[j];
    const size_t n = (size_t)T.rows * T.cols;
    const int g = P.k0 + k;
    bool s;
    if (T.kind == TRAIN_POISSON) {
        s = T.u[(size_t)g * n + i] <= T.chance[i];
    } else {
        const float stepped = T.step[i] + T.dt[i];
        s = T.rate[i] != 0.0f && stepped >= T.rate[i];
        T.step[i] = s ? 0.0f : stepped;
    }
    T.lft[g % 3][i] = s ? P.clock0 + g : train_lft(T, g - 1)[i];
    if (k == P.n - 1) T.spk[i] = s ? 1 : 0;
    if (!CHEM || T.nt < 0) return;
    const float v = s ? T.v_th[i] : T.v_rest[i];
    const float sf = s ? 1.0f : 0.0f;
    const float* t0 = train_ntt(T, g - 1);
    for (int q = 0; q < CHEM_TYPES; ++q) {
        const size_t iq = (size_t)CHEM_TYPES * i + q;
        const float t = nt_release(T.nt, t0[iq], v, sf, T.ntp[0][iq],
                                   opt(T.ntp[1], iq), opt(T.ntp[2], iq),
                                   T.dt[i]);
        T.ntt[g & 1][iq] = T.ntm[iq] ? t : 0.0f;
    }
}

template <int THREADS, bool CHEM, bool FLAT>
__global__ void __launch_bounds__(THREADS, 1)
net_persistent_kernel(const __grid_constant__ NetP Pk)
{
    constexpr int W = THREADS / 32;
    // the description, copied into the block's shared memory: its fields
    // are read with indices known only at run time, in every loop
    extern __shared__ __align__(16) unsigned char sm_all[];
    {
        const int4* src = (const int4*)&Pk;
        int4* dst = (int4*)sm_all;
        for (int q = threadIdx.x; q < (int)(sizeof(NetP) / 16);
             q += blockDim.x)
            dst[q] = src[q];
    }
    __syncthreads();
    const NetP& P = *(const NetP*)sm_all;
    float* fs = (float*)(sm_all + NP_DESC);
    unsigned char* sm = sm_all + NP_DESC + (FLAT ? NP_FLAT_SCRATCH : 0);
    cg::grid_group grid = cg::this_grid();
    const int lane = threadIdx.x & 31;

    // the dopamine of every step of this launch, lp_dopamine_kernel's float
    // order; read from phase 1 on, after the first grid.sync()
    if (P.with_reward && blockIdx.x == 0 && threadIdx.x == 0) {
        float d = P.k0 == 0 ? *P.dop_in : P.dop_steps[P.k0 - 1];
        for (int j = 0; j < P.n; ++j) {
            d = d * P.exp_dd + P.tau_d * P.rewards[j];
            P.dop_steps[P.k0 + j] = d;
        }
    }
    // flat mode: the lattice tile this block owns, if any
    int fl = -1, ft = 0;
    if (FLAT) {
        for (int l = 0; l < P.n_lat; ++l) {
            const int t = (int)blockIdx.x - P.lat[l].tile0;
            if (t >= 0 && t < (P.lat[l].cols + 31) / 32) {
                fl = l;
                ft = t;
            }
        }
        if (fl >= 0) flat_prologue<THREADS>(P, fl, ft, fs, sm);
    } else {
        for (int l = 0; l < P.n_lat; ++l) {
            const PLat& L = P.lat[l];
            const size_t n = (size_t)L.rows * L.cols;
            const Own o = owned<W>(n, L.rot);
            for (int j = o.j0; j < o.cnt; j += W) {
                const size_t i = (size_t)(o.lo + j) * 32 + lane;
                if (i >= n) continue;
                lattice_prologue(P, l, i, j * 32 + lane, sm);
                if (CHEM) chem_prologue(P, L, sm, i, j * 32 + lane);
            }
        }
    }
    if (P.k0 == 0) {
        for (int t = 0; t < P.n_tr; ++t) {
            const PTrain& T = P.tr[t];
            if (T.kind != TRAIN_RATE) continue;
            const size_t n = (size_t)T.rows * T.cols;
            const Own o = owned<W>(n, T.rot);
            for (int j = o.j0; j < o.cnt; j += W) {
                const size_t i = (size_t)(o.lo + j) * 32 + lane;
                if (i < n) T.step[i] = T.step_in[i];
            }
        }
    }

    for (int k = 0; k <= P.n; ++k) {
        if (FLAT) {
            if (fl >= 0 && k < P.n) {
                flat_phase<THREADS, CHEM>(P, fl, ft, fs, sm, k);
            } else if (fl >= 0 && CHEM && threadIdx.x < 32) {
                const size_t i = (size_t)ft * 32 + threadIdx.x;
                if (i < (size_t)P.lat[fl].cols)
                    chem_writeback(P, P.lat[fl], sm, i, threadIdx.x);
            }
        } else {
            for (int l = 0; l < P.n_lat; ++l) {
                const PLat& L = P.lat[l];
                const size_t n = (size_t)L.rows * L.cols;
                const Own o = owned<W>(n, L.rot);
                for (int j = o.j0; j < o.cnt; j += W) {
                    const size_t i = (size_t)(o.lo + j) * 32 + lane;
                    if (i >= n) continue;
                    if (CHEM)
                        chem_dispatch(P, l, i, j * 32 + lane, sm, k);
                    else
                        lattice_phase(P, l, i, j * 32 + lane, sm, k);
                    if (k == P.n) {
                        lattice_writeback(P, l, i, j * 32 + lane, sm);
                        if (CHEM)
                            chem_writeback(P, L, sm, i, j * 32 + lane);
                    }
                }
            }
        }
        if (k == P.n) break;
        for (int t = 0; t < P.n_tr; ++t) {
            const PTrain& T = P.tr[t];
            const size_t n = (size_t)T.rows * T.cols;
            const Own o = owned<W>(n, T.rot);
            for (int j = o.j0; j < o.cnt; j += W) {
                const size_t i = (size_t)(o.lo + j) * 32 + lane;
                if (i < n) train_phase<CHEM>(P, t, i, k);
            }
        }
        grid.sync();
    }
}

// n_syncs grid barriers and nothing else, at the persistent kernel's block
// size: the cost of one grid.sync() at a given grid.
__global__ void __launch_bounds__(NP_THREADS) np_sync_kernel(int n_syncs)
{
    cg::grid_group grid = cg::this_grid();
    for (int s = 0; s < n_syncs; ++s) grid.sync();
}

// The four instantiations: variant = chem + 2 flat.
typedef void (*NpKernel)(const NetP);
static NpKernel np_kernel(int variant)
{
    switch (variant) {
    case 0: return net_persistent_kernel<NP_THREADS, false, false>;
    case 1: return net_persistent_kernel<NP_THREADS_CHEM, true, false>;
    case 2: return net_persistent_kernel<NP_THREADS_CHEM, false, true>;
    default: return net_persistent_kernel<NP_THREADS_CHEM, true, true>;
    }
}

static int np_threads(int variant)
{
    return variant == 0 ? NP_THREADS : NP_THREADS_CHEM;
}

// Bytes of a block's dynamic shared memory before the resident members.
static int np_header(int variant)
{
    return NP_DESC + (variant >= 2 ? NP_FLAT_SCRATCH : 0);
}

// Bytes a block's resident slots of a member take: cap tiles of 32 cells,
// per cell n_slots weights, with traces three more words each, and with
// masks a byte each; rounded up to 16.
static size_t member_bytes(int cap, int n_slots, bool traces, bool mask)
{
    const size_t b = (size_t)cap * 32 * n_slots
        * (4 + (traces ? 12 : 0) + (mask ? 1 : 0));
    return (b + 15) / 16 * 16;
}

// Bytes of cap tiles of 32 cells of f float planes and c byte planes.
static size_t plane_bytes(int cap, int f, int c)
{
    const size_t b = (size_t)cap * 32 * (4 * f + c);
    return (b + 15) / 16 * 16;
}

// The grid of a launch of instantiation `variant` with `smem` bytes of
// dynamic shared memory: the blocks the card holds at once, occupancy x
// SMs, and the SM count (cached per device, variant and size; the
// kernel's shared-memory limit is set to `smem`).
static cudaError_t np_grid(int variant, int smem, int* blocks, int* sms)
{
    static int last_dev[4] = {-1, -1, -1, -1}, last_smem[4] = {-1, -1, -1, -1};
    static int last_blocks[4], last_sms[4];
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev == last_dev[variant] && smem == last_smem[variant]) {
        *blocks = last_blocks[variant];
        *sms = last_sms[variant];
        return cudaSuccess;
    }
    const void* fn = (const void*)np_kernel(variant);
    int n_sm = 0, occ = 0, optin = 0;
    cudaFuncAttributes fa;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
            != cudaSuccess
        || (err = cudaFuncGetAttributes(&fa, fn)) != cudaSuccess)
        return err;
    if ((size_t)smem + fa.sharedSizeBytes > (size_t)optin)
        return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
            != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &occ, fn, np_threads(variant), smem))
            != cudaSuccess)
        return err;
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    last_dev[variant] = dev;
    last_smem[variant] = smem;
    last_blocks[variant] = occ * n_sm;
    last_sms[variant] = n_sm;
    *blocks = last_blocks[variant];
    *sms = n_sm;
    return cudaSuccess;
}

// Whether the resident ranges [lo[a], hi[a]) are apart.
static bool apart(const size_t* lo, const size_t* hi, int n)
{
    for (int a = 0; a < n; ++a)
        for (int b = a + 1; b < n; ++b)
            if (lo[a] < hi[b] && lo[b] < hi[a]) return false;
    return true;
}

extern "C" {

// NP_MAX_LAT, NP_MAX_TR, NP_MAX_CN, PL_I, PL_P, PT_I, PT_P, PC_I, PC_P,
// NP_THREADS, NP_CHUNK, NP_THREADS_CHEM, NP_FLAT_SCRATCH and NP_DESC, in
// order.
void net_persistent_limits(int* out)
{
    const int v[14] = {NP_MAX_LAT, NP_MAX_TR, NP_MAX_CN, PL_I, PL_P, PT_I,
                       PT_P, PC_I, PC_P, NP_THREADS, NP_CHUNK,
                       NP_THREADS_CHEM, NP_FLAT_SCRATCH, NP_DESC};
    for (int q = 0; q < 14; ++q) out[q] = v[q];
}

// Instantiation `variant` (0 electrical grid, 1 chemical grid, 2 flat
// electrical, 3 flat chemical): its registers per thread, local (spill
// and stack) bytes per thread, static shared bytes, largest block, the
// blocks of a launch whose resident members take `smem` bytes of a block's
// shared memory (the description's copy and flat mode's scratch come on
// top) and the SM count.  Returns the first CUDA error.
int net_persistent_info(int variant, int smem, int* out)
{
    if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes fa;
    int blocks = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaFuncGetAttributes(&fa, (const void*)np_kernel(variant)))
            != cudaSuccess
        || (err = np_grid(variant, np_header(variant) + smem, &blocks, &sms))
            != cudaSuccess)
        return (int)err;
    const int v[6] = {fa.numRegs, (int)fa.localSizeBytes,
                      (int)fa.sharedSizeBytes, fa.maxThreadsPerBlock, blocks,
                      sms};
    for (int q = 0; q < 6; ++q) out[q] = v[q];
    return 0;
}

// One cooperative launch of np_sync_kernel: `blocks` blocks of NP_THREADS
// threads taking n_syncs grid barriers.  Returns the launch error.
int net_persistent_sync_probe(int blocks, int n_syncs, void* stream)
{
    void* args[] = {&n_syncs};
    return (int)cudaLaunchCooperativeKernel(
        (void*)np_sync_kernel, dim3(blocks), dim3(NP_THREADS), args, 0,
        (cudaStream_t)stream);
}

// Runs n_steps steps of a network from clock0 on `stream`, one cooperative
// launch of net_persistent_kernel per NP_CHUNK steps: the chemical
// instantiation where chem_i[0] >= 0, the flat one where a lattice has a
// dense graph or a connection is a dense block.  Flat descriptions (host
// memory), one record per member:
//   lattice ints (PL_I): model, kind (0 plain, 1 plastic: STDP, 2 mod:
//     R-STDP), rows, cols, n_off, emit, resident, shared-memory offset,
//     cap (tiles a block holds at most), dr[LP_MAX_OFFSETS],
//     dc[LP_MAX_OFFSETS]; then dense (a (1, N) row with (N, N) weights and
//     mask), its columns resident, their offset; the chemical parameters
//     resident, their offset, the state resident, its offset, and the
//     chemical members' cap;
//   lattice pointers (PL_P): v, w, lft, refr (inputs); buffer set 0 v, w,
//     lft, refr; set 1 v, w, lft, refr; spike sets 0 and 1 (bytes); v_pre
//     (n_steps planes, or null); in_deg; cnt (scratch); stencil (or dense)
//     weights in and out (out: written, and the same as in for a plain
//     lattice); mask; a mod lattice's traces c, dw, counter in, then out;
//     the parameter planes in MODEL_PARAM_KEYS order, padded to 13; then
//     the chemical arm's (ops/network_kernels.py _persistent_chem_pointers):
//     nt$t in, concentration sets 0 and 1, the previous step's spikes
//     (bytes), rec$r, rec$r2, inh and nmda modifiers in, then out,
//     rec$current (the last step's), nt$mask, rec$mask, the NT parameters
//     [3], kinetics parameters [2], r2 kinetics parameters [2] and current
//     parameters [9] (DOPA_PLANES, or g, e, mg).  refr and its buffers are
//     null for Izhikevich; weights, mask, traces and chemical fields where
//     unused.  Step s writes set s % 2, so the result is in set
//     (n_steps - 1) % 2.
//   train ints (PT_I): kind, refractoriness, rows, cols, NT kinetics (-1:
//     none);
//   train pointers (PT_P): lft in, lft sets 0, 1, 2 (step s writes set
//     s % 3), v_th, v_resting, refractoriness k, dt, chance, uniforms
//     (n_steps planes), rate, step in, step out, spikes (the last step's);
//     chance and uniforms Poisson only, rate and step Rate only; nt$t in,
//     concentration sets 0 and 1 (step s writes set s % 2), nt$mask, NT
//     parameters [3].
//   connection ints (PC_I): kind (one-to-one, resample or dense),
//     pre_is_st, pre, post, pre_plastic, post_plastic, R1, C1, fr, fc,
//     n_taps (a dense block's source rows), static, reward, resident,
//     shared-memory offset, cap, the taps' dr[NET_MAX_TAPS] and
//     dc[NET_MAX_TAPS];
//   connection pointers (PC_P): w in, w out (the same as in without
//     updates), mask, a reward connection's traces c, dw, counter in, then
//     out.
// rule: the STDP {a_plus, a_minus, tau_plus, tau_minus, dt}; rrule (null
// without the reward arm): {the same five, tau_c, exp_dc, tau_d, exp_dd};
// chem_i: {family (-1: none), receptor kinetics, NT kinetics, electrical};
// dop_in (device, one float; null without the reward arm); with_reward:
// `rewards` (host, n_steps floats) move the dopamine and dop_steps (device,
// n_steps floats) receives each step's.  The residency plan (its
// offsets and caps in the ints above) takes `smem` bytes of shared memory
// a block for the resident members; the launches take np_header more (the
// description's copy, and flat mode's scratch).  Each resident member is
// checked to lie within `smem`, apart from the others, and to hold the
// tiles a block of this grid owns; a flat network's lattice tiles must not
// outnumber the blocks.  Returns the first CUDA error, 0 if none.
int net_persistent_steps(int n_lat, const int* lat_i, void* const* lat_p,
                         int n_tr, const int* tr_i, void* const* tr_p,
                         int n_cn, const int* cn_i, void* const* cn_p,
                         const float* rule, const float* rrule,
                         const int* chem_i, int clock0, int n_steps,
                         int with_reward, const float* rewards,
                         const float* dop_in, float* dop_steps, int smem,
                         void* stream)
{
    static const int n_params_of[3] = {9, 13, 10};
    if (n_lat <= 0 || n_lat > NP_MAX_LAT || n_tr < 0 || n_tr > NP_MAX_TR
        || n_cn < 0 || n_cn > NP_MAX_CN || n_steps <= 0 || smem < 0
        || (with_reward && (!rrule || !rewards || !dop_in || !dop_steps)))
        return (int)cudaErrorInvalidValue;
    const int fam = chem_i[0];
    const bool chem = fam >= 0;
    if (chem && (fam > FAM_DOPAGLUGABA || chem_i[1] < 0
                 || chem_i[1] > REC_EXP_DECAY || chem_i[2] < 0
                 || chem_i[2] > NT_DESTEXHE || with_reward || rrule))
        return (int)cudaErrorInvalidValue;
    bool flat = false;
    for (int l = 0; l < n_lat; ++l) flat |= lat_i[PL_I * l + 137] != 0;
    for (int q = 0; q < n_cn; ++q) flat |= cn_i[PC_I * q] == CONN_DENSE;
    const int variant = (chem ? 1 : 0) + (flat ? 2 : 0);
    const int warps = np_threads(variant) / 32;
    int blocks = 0, sms = 0;
    cudaError_t err = np_grid(variant, np_header(variant) + smem, &blocks,
                              &sms);
    if (err != cudaSuccess) return (int)err;

    NetP* P = new NetP();
    P->n_lat = n_lat;
    P->n_tr = n_tr;
    P->n_cn = n_cn;
    P->clock0 = clock0;
    P->n_all = n_steps;
    P->with_reward = with_reward;
    P->fam = fam;
    P->rec = chem_i[1];
    P->ntk = chem_i[2];
    P->elec = chem ? chem_i[3] : 1;
    P->r = Rule{rule[0], rule[1], rule[2], rule[3], rule[4], 0.0f, 0.0f};
    P->rr = rrule ? Rule{rrule[0], rrule[1], rrule[2], rrule[3], rrule[4],
                         rrule[5], rrule[6]}
                  : Rule{};
    P->exp_dd = rrule ? rrule[8] : 0.0f;
    P->tau_d = rrule ? rrule[7] : 0.0f;
    P->dop_in = dop_in;
    P->dop_steps = dop_steps;
    bool ok = true;
    int rot = 0, tiles_all = 0;
    for (int l = 0; l < n_lat && ok; ++l) {
        const int* li = lat_i + PL_I * l;
        void* const* lp = lat_p + PL_P * l;
        PLat& L = P->lat[l];
        L.model = li[0];
        L.kind = li[1];
        L.rows = li[2];
        L.cols = li[3];
        L.n_off = li[4];
        L.emit = li[5];
        L.res = li[6];
        L.smem_off = li[7];
        L.cap = li[8];
        L.dense = li[137];
        L.dres = li[138];
        L.doff = li[139];
        L.cres_p = li[140];
        L.coff_p = li[141];
        L.cres_s = li[142];
        L.coff_s = li[143];
        L.ccap = li[144];
        const long long tiles = ((long long)L.rows * L.cols + 31) / 32;
        ok = L.model >= 0 && L.model <= 2 && L.kind >= KIND_PLAIN
            && L.kind <= KIND_MOD && L.rows > 0 && L.cols > 0
            && L.n_off >= 0 && L.n_off <= LP_MAX_OFFSETS
            && (L.model == MODEL_IZHIKEVICH || (lp[3] && lp[7] && lp[11]))
            && (!L.emit || lp[14])
            && (!L.n_off || (lp[17] && lp[18] && lp[19]))
            && (L.kind != KIND_MOD || !L.n_off
                || (rrule && dop_in && lp[20] && lp[21] && lp[22] && lp[23]
                    && lp[24] && lp[25]))
            && (!L.res || (L.n_off && !flat && L.smem_off >= 0
                           && L.smem_off % 16 == 0
                           && (long long)L.cap * blocks >= tiles))
            && (!flat || (L.rows == 1 && L.cols <= NP_DENSE_MAX
                          && !L.n_off && L.kind == KIND_PLAIN))
            && (!L.dense || (flat && lp[17] && lp[19]))
            && (!L.dres || (L.dense && L.doff >= 0 && L.doff % 16 == 0))
            && (chem || (!L.cres_p && !L.cres_s))
            && ((!L.cres_p && !L.cres_s)
                || (L.ccap >= 1 && (long long)L.ccap * blocks >= tiles
                    && L.coff_p % 16 == 0 && L.coff_s % 16 == 0
                    && L.coff_p >= 0 && L.coff_s >= 0));
        for (int o = 0; o < LP_MAX_OFFSETS; ++o) {
            L.dr[o] = (short)li[9 + o];
            L.dc[o] = (short)li[9 + LP_MAX_OFFSETS + o];
        }
        L.rot = rot;
        rot = (rot + (int)((tiles + blocks - 1) / blocks)) % warps;
        L.tile0 = tiles_all;
        tiles_all += (int)tiles;
        L.v_in = (const float*)lp[0];
        L.w_in = (const float*)lp[1];
        L.lft_in = (const int*)lp[2];
        L.refr_in = (const float*)lp[3];
        for (int s = 0; s < 2; ++s) {
            L.v[s] = (float*)lp[4 + 4 * s];
            L.w[s] = (float*)lp[5 + 4 * s];
            L.lft[s] = (int*)lp[6 + 4 * s];
            L.refr[s] = (float*)lp[7 + 4 * s];
            L.spk[s] = (unsigned char*)lp[12 + s];
        }
        L.v_pre = (float*)lp[14];
        L.in_deg = (const float*)lp[15];
        L.cnt = (float*)lp[16];
        L.wt_in = (const float*)lp[17];
        L.wt = (float*)lp[18];
        L.mask = (const unsigned char*)lp[19];
        L.c_in = (const float*)lp[20];
        L.dw_in = (const float*)lp[21];
        L.ct_in = (const int*)lp[22];
        L.c = (float*)lp[23];
        L.dw = (float*)lp[24];
        L.ct = (int*)lp[25];
        ok = ok && li[5] >= 0 && lp[0] && lp[1] && lp[2] && lp[4] && lp[5]
            && lp[6] && lp[8] && lp[9] && lp[10] && lp[12] && lp[13]
            && lp[15] && lp[16];
        for (int q = 0; q < LP_MAX_PARAMS && ok; ++q) {
            L.p[q] = q < n_params_of[L.model] ? (const float*)lp[26 + q]
                                              : nullptr;
            ok = q >= n_params_of[L.model] || L.p[q];
        }
        L.ntt_in = (const float*)lp[39];
        L.ntt[0] = (float*)lp[40];
        L.ntt[1] = (float*)lp[41];
        L.spk_in = (const unsigned char*)lp[42];
        for (int s = 0; s < 4; ++s) {
            L.cs_in[s] = (const float*)lp[43 + s];
            L.cs[s] = (float*)lp[47 + s];
        }
        L.cur = (float*)lp[51];
        L.ntm = (const unsigned char*)lp[52];
        L.recm = (const unsigned char*)lp[53];
        int planes = 0;
        for (int f = 0; f < NP_CPAR; ++f) {
            L.cpar[f] = (const float*)lp[54 + f];
            L.cpl[f] = (signed char)(L.cpar[f] ? planes : -1);
            if (L.cpar[f])
                planes += f >= 7 && fam == FAM_DOPAGLUGABA ? 1 : 3;
        }
        L.cp_planes = planes;
        if (chem) {
            const bool dopa = fam == FAM_DOPAGLUGABA;
            ok = ok && L.model != MODEL_LIF && L.kind != KIND_MOD
                && L.ntt_in && L.ntt[0] && L.ntt[1] && L.spk_in
                && L.cs_in[0] && L.cs[0] && L.cur && L.ntm && L.recm
                && L.cpar[0] && L.cpar[7] && L.cpar[8] && L.cpar[9]
                && (!dopa || (L.cs_in[1] && L.cs[1] && L.cs_in[2]
                              && L.cs[2] && L.cs_in[3] && L.cs[3]));
            for (int f = 10; f < 16 && ok && dopa; ++f) ok = L.cpar[f];
        }
        L.n_in = 0;
    }
    if (flat && tiles_all > blocks) ok = false;
    P->n_tiles = tiles_all;
    for (int t = 0; t < n_tr && ok; ++t) {
        const int* ti = tr_i + PT_I * t;
        void* const* tp = tr_p + PT_P * t;
        PTrain& T = P->tr[t];
        T.kind = ti[0];
        T.refractoriness = ti[1];
        T.rows = ti[2];
        T.cols = ti[3];
        T.nt = ti[4];
        T.lft_in = (const int*)tp[0];
        for (int s = 0; s < 3; ++s) T.lft[s] = (int*)tp[1 + s];
        T.v_th = (const float*)tp[4];
        T.v_rest = (const float*)tp[5];
        T.k = (const float*)tp[6];
        T.dt = (const float*)tp[7];
        T.chance = (const float*)tp[8];
        T.u = (const float*)tp[9];
        T.rate = (const float*)tp[10];
        T.step_in = (const float*)tp[11];
        T.step = (float*)tp[12];
        T.spk = (unsigned char*)tp[13];
        T.ntt_in = (const float*)tp[14];
        T.ntt[0] = (float*)tp[15];
        T.ntt[1] = (float*)tp[16];
        T.ntm = (const unsigned char*)tp[17];
        for (int q = 0; q < 3; ++q) T.ntp[q] = (const float*)tp[18 + q];
        const long long tiles = ((long long)T.rows * T.cols + 31) / 32;
        T.rot = rot;
        rot = (rot + (int)((tiles + blocks - 1) / blocks)) % warps;
        ok = (T.kind == TRAIN_POISSON || T.kind == TRAIN_RATE)
            && (T.refractoriness == REFR_DELTA_DIRAC
                || T.refractoriness == REFR_EXP_DECAY)
            && T.rows > 0 && T.cols > 0 && T.lft_in && T.lft[0] && T.lft[1]
            && T.lft[2] && T.v_th && T.v_rest && T.k && T.dt && T.spk
            && (T.kind == TRAIN_POISSON ? T.chance && T.u
                                        : T.rate && T.step_in && T.step)
            && (!flat || (T.rows == 1 && T.cols <= NP_DENSE_MAX))
            && (T.nt < 0 || (chem && T.nt <= NT_DESTEXHE && T.ntt_in
                             && T.ntt[0] && T.ntt[1] && T.ntm && T.ntp[0]));
    }
    for (int q = 0; q < n_cn && ok; ++q) {
        const int* ci = cn_i + PC_I * q;
        void* const* cp = cn_p + PC_P * q;
        PConn& C = P->cn[q];
        C.kind = ci[0];
        C.pre_is_st = ci[1];
        C.pre = ci[2];
        C.post = ci[3];
        C.pre_plastic = ci[4];
        C.post_plastic = ci[5];
        C.R1 = ci[6];
        C.C1 = ci[7];
        C.fr = ci[8];
        C.fc = ci[9];
        C.n_taps = ci[10];
        C.stat = ci[11];
        C.reward = ci[12];
        C.res = ci[13];
        C.smem_off = ci[14];
        C.cap = ci[15];
        C.updates = C.pre_plastic || C.post_plastic || C.stat || C.reward;
        for (int t = 0; t < NET_MAX_TAPS; ++t) {
            C.tr[t] = (short)ci[16 + t];
            C.tc[t] = (short)ci[16 + NET_MAX_TAPS + t];
        }
        C.w_in = (const float*)cp[0];
        C.w = (float*)cp[1];
        C.mask = (const unsigned char*)cp[2];
        C.c_in = (const float*)cp[3];
        C.dw_in = (const float*)cp[4];
        C.ct_in = (const int*)cp[5];
        C.c = (float*)cp[6];
        C.dw = (float*)cp[7];
        C.ct = (int*)cp[8];
        const int pre_max = C.pre_is_st ? n_tr : n_lat;
        const bool dense = C.kind == CONN_DENSE;
        ok = (C.kind == CONN_ONE2ONE || C.kind == CONN_RESAMPLE || dense)
            && C.pre >= 0 && C.pre < pre_max && C.post >= 0
            && C.post < n_lat && !(C.pre_is_st && C.pre_plastic)
            && C.stat >= 0 && C.w_in && C.w && C.mask
            && (C.kind == CONN_ONE2ONE ? C.n_taps == 1
                : dense ? flat && !C.updates && C.n_taps > 0
                          && C.n_taps <= NP_DENSE_MAX
                          && C.n_taps == (C.pre_is_st
                                          ? P->tr[C.pre].cols
                                          : P->lat[C.pre].cols)
                : !chem && !flat && C.n_taps > 0
                  && C.n_taps <= NET_MAX_TAPS && C.fr && C.fc)
            && (!C.reward || (rrule && dop_in && cp[3] && cp[4] && cp[5]
                              && cp[6] && cp[7] && cp[8]))
            && P->lat[C.post].n_in < NET_MAX_IN;
        if (!ok) break;
        const PLat& post = P->lat[C.post];
        const long long tiles = ((long long)post.rows * post.cols + 31) / 32;
        ok = !C.res || (C.smem_off >= 0 && C.smem_off % 16 == 0
                        && (long long)C.cap * blocks >= tiles
                        && (!flat || C.cap == 1));
        // a one-to-one source has the post grid
        if (C.kind == CONN_ONE2ONE) {
            const int rows = C.pre_is_st ? P->tr[C.pre].rows
                                         : P->lat[C.pre].rows;
            const int cols = C.pre_is_st ? P->tr[C.pre].cols
                                         : P->lat[C.pre].cols;
            ok = ok && rows == post.rows && cols == post.cols;
        }
        PLat& pl = P->lat[C.post];
        pl.in_cn[pl.n_in++] = (signed char)q;
    }
    // the resident members' ranges: one layout for every block in grid
    // mode, one per lattice tile in flat mode (a block owns one tile)
    for (int g0 = 0; g0 < (flat ? n_lat : 1) && ok; ++g0) {
        size_t lo[NP_MAX_LAT * 4 + NP_MAX_CN], hi[NP_MAX_LAT * 4 + NP_MAX_CN];
        int m = 0;
        for (int l = 0; l < n_lat; ++l) {
            if (flat && l != g0) continue;
            const PLat& L = P->lat[l];
            const bool dopa = fam == FAM_DOPAGLUGABA;
            if (L.res) {
                lo[m] = L.smem_off;
                hi[m++] = L.smem_off + member_bytes(
                    L.cap, L.n_off, L.kind == KIND_MOD,
                    L.kind != KIND_PLAIN || chem);
            }
            if (L.dres) {
                lo[m] = L.doff;
                hi[m++] = L.doff + plane_bytes(1, L.cols, 0);
            }
            if (L.cres_p) {
                lo[m] = L.coff_p;
                hi[m++] = L.coff_p + plane_bytes(L.ccap, L.cp_planes, 3);
            }
            if (L.cres_s) {
                lo[m] = L.coff_s;
                hi[m++] = L.coff_s + plane_bytes(L.ccap, dopa ? 8 : 3, 0);
            }
        }
        for (int q = 0; q < n_cn; ++q) {
            const PConn& C = P->cn[q];
            if (!C.res || (flat && C.post != g0)) continue;
            lo[m] = C.smem_off;
            hi[m++] = C.smem_off + (C.kind == CONN_DENSE
                ? plane_bytes(1, C.n_taps, 0)
                : member_bytes(C.cap, C.n_taps, C.reward,
                               C.kind == CONN_ONE2ONE || C.updates));
        }
        for (int a = 0; a < m; ++a) ok = ok && hi[a] <= (size_t)smem;
        ok = ok && apart(lo, hi, m);
    }
    if (!ok) {
        delete P;
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const NpKernel fn = np_kernel(variant);
    for (int k0 = 0; k0 < n_steps && err == cudaSuccess; k0 += NP_CHUNK) {
        P->k0 = k0;
        P->n = n_steps - k0 < NP_CHUNK ? n_steps - k0 : NP_CHUNK;
        for (int j = 0; j < NP_CHUNK; ++j)
            P->rewards[j] = with_reward && j < P->n ? rewards[k0 + j] : 0.0f;
        void* args[] = {P};
        err = cudaLaunchCooperativeKernel(
            (void*)fn, dim3(blocks), dim3(np_threads(variant)), args,
            (size_t)(np_header(variant) + smem), s);
    }
    delete P;
    return (int)err;
}

}  // extern "C"
