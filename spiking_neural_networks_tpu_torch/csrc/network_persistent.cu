// The grid-mode electrical networks and the reward networks of
// network_plasticity.cu, one cooperative launch per call of up to 16
// steps.
//
// Replaces the TPU kernel spiking_neural_networks_tpu/ops/pallas_reward.py
// :1177 _fused_chunk (call :1183) in its grid-mode plain-network form (body
// _make_kernel, built by plain_network_runner) and its reward-network
// form (built by network_runner, :1863-1929; the step :863-987): the
// Izhikevich, ALIF and LIF lattices of mixed grid shapes on stencil or
// edgeless graphs, Poisson and Rate trains, one-to-one and resample
// connections, STDP, the R-STDP lattices (kind mod) and the reward
// connections.  Per cell the arithmetic is network_plasticity.cu's,
// operation for operation, so the results equal the plain twin
// ops/network_kernels.network_steps_reference bit for bit; only the
// schedule and the place where values live differ.
//
// What bounds the per-step design on an H100: 7 launches a step for
// config 5 and the bench's reward network (112-113 per 16-step call), a few
// us each, so below 512 x 512 the launches and the host set the rate; at
// 512 x 512 the weights are read by the cell kernel and read and written
// again by the edge kernels every step, and parameters, masks and
// connection weights are re-read, ~97 MB a step for config 5, twice the
// 50 MB L2.  This design:
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
//      mod lattice or a reward connection, its traces) lives in the owning
//      block's dynamic shared memory for the whole launch where the
//      residency plan (ops/network_kernels.persistent_plan) fits it, and
//      is written back once, after the last edge pass; other members
//      stream from global memory.  What neighbours read (v, lft, the
//      spikes, the trains' firing times) stays in global planes, served
//      from L2: lattice state double-buffered by step parity, spike flags
//      double-buffered too (a neighbour's step k-1 flag is read while step
//      k's is written), and the trains' firing times in three sets (the
//      fused visits of step k-1 read the times from before the trains'
//      step k-1, phase A of step k those after it, and the train step k
//      writes new ones, all in one phase).  A Rate train's step counter is
//      read only by its owner and is updated in place.
// The description (NetP, 12.7 KB) is a kernel parameter; each block copies
// it into its shared memory first, since its fields are read with indices
// known only at run time in every loop.  The loops over a member's slots
// are instantiated for resident and streamed slots apart, so the compiler
// sees shared-memory stores that cannot alias the neighbours' global
// loads.
// What bounds this design on an H100 (chip_smoke.py phases 11, 14, 26 and
// 28; PERF.md section 6): not bytes.  640 threads a block at 96 registers
// and one block per SM leave 20 warps an SM, and each thread walks several
// cells a phase, each a chain of dependent loads and the STDP arithmetic
// of up to 64 slots; so at 512 x 512 a step costs several times its byte
// bound, and at 64 x 64 the chain of one tile and the grid barrier (~1.1
// us) set the step.  Loads issued ahead in per-thread arrays, unrolled
// slot loops, 512-1024-thread blocks and the neighbours staged per warp in
// shared-memory halos were no faster on the card.
// No per-step fallback: a refused cooperative launch returns its error.

#include <cooperative_groups.h>

#include "network_common.cuh"

namespace cg = cooperative_groups;

#define NP_THREADS 640
#define NP_WARPS (NP_THREADS / 32)
#define NP_MAX_LAT 8
#define NP_MAX_TR 8
#define NP_MAX_CN 16
#define NP_CHUNK 16
// strides of the flat descriptions (ops/network_kernels.py PL_I, PL_P,
// PT_I, PT_P, PC_I, PC_P)
#define PL_I (9 + 2 * LP_MAX_OFFSETS)
#define PL_P 39
#define PT_I 4
#define PT_P 14
#define PC_I (16 + 2 * NET_MAX_TAPS)
#define PC_P 9

struct PLat {
    int model, kind, rows, cols, n_off, emit;
    int res, smem_off, cap, rot;          // residency plan; warp rotation
    int n_in;
    signed char in_cn[NET_MAX_IN];        // incoming connections, plan order
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
};

struct PTrain {
    int kind, refractoriness, rows, cols, rot;
    const int* lft_in; int* lft[3];
    const float* v_th; const float* v_rest; const float* k; const float* dt;
    const float* chance; const float* u; const float* rate;
    const float* step_in; float* step; unsigned char* spk;
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
    int clock0, k0, n;        // the call's clock; this launch's first
                              // step and its steps
    int with_reward;
    Rule r, rr;
    float exp_dd, tau_d;
    float rewards[NP_CHUNK];
    const float* dop_in;      // null without the reward arm
    float* dop_steps;
    PLat lat[NP_MAX_LAT];
    PTrain tr[NP_MAX_TR];
    PConn cn[NP_MAX_CN];
};

// bytes of a block's dynamic shared memory before its resident members:
// the copy of the description
#define NP_HDR ((int)sizeof(NetP))

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
// the local tiles j with (j + rot) % NP_WARPS == w, lane l the cell
// 32 (lo + j) + l, whose resident slots sit at column 32 j + l.
struct Own {
    int lo, cnt, j0;
};

__device__ __forceinline__ Own owned(size_t n, int rot)
{
    const long long T = (long long)((n + 31) / 32);
    const int lo = (int)(T * blockIdx.x / gridDim.x);
    const int hi = (int)(T * (blockIdx.x + 1) / gridDim.x);
    const int w = threadIdx.x / 32;
    return {lo, hi - lo, ((w - rot) % NP_WARPS + NP_WARPS) % NP_WARPS};
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
// incoming connections: into shared memory where resident (from the inputs
// on the first launch, else from the outputs the last launch wrote), or
// copied from input to output on the first launch where they stream and
// are updated.
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
                       first ? L.ct_in : L.ct, upd ? L.mask : nullptr);
        else if (first && upd)
            move_slots(s, L.n_off, n, i, true, nullptr, nullptr, nullptr,
                       nullptr, L.wt_in, L.c_in, L.dw_in, L.ct_in,
                       nullptr);
    }
    for (int q = 0; q < L.n_in; ++q) {
        const PConn& C = P.cn[L.in_cn[q]];
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
// v[r+dr, c+dc] and wsum = sum_o w_o.  Every load of a slot comes before
// its visit: the neighbour's fields do not wait for the mask, which may
// stream.
template <bool RES>
__device__ __forceinline__ void stencil_pass(
    const NetP& P, const PLat& L, unsigned char* sm, size_t i, int loc,
    size_t n, int row, int col, const float* v_p, const int* lft_p,
    const unsigned char* spk_p, bool edge, bool cell, int t_post,
    float s_post, float dop, float& acc, float& wsum)
{
    const Slots S = lat_slots_of<RES>(L, sm, i, loc, n);
    const bool upd = edge && L.kind != KIND_PLAIN;
    const bool mod = L.kind == KIND_MOD;
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
        const float vn = cell && in ? v_p[j] : 0.0f;
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
        if (cell) {
            if (in) acc = acc + wv * vn;
            wsum = wsum + wv;
        }
    }
}

// One incoming connection of a cell (RES: its slots resident): its
// visits of step sp where `edge`, then its term of phase A added to
// `total` where `cell`.
template <bool RES>
__device__ __forceinline__ float conn_pass(
    const NetP& P, const PConn& C, unsigned char* sm, size_t i, int loc,
    size_t n, int row, int col, int sp, bool edge, bool cell, int clock,
    float v, int t_post, float s_post, float dop, float total)
{
    const int b = sp & 1;
    const Slots S = conn_slots_of<RES>(C, sm, i, loc, n);
    const bool upd = edge && C.updates;
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
    const int* tlft = C.pre_is_st && cell ? train_lft(T, sp) : nullptr;
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
        if (cell)
            a = C.pre_is_st
                ? train_effect(tlft, T.v_th, T.v_rest, T.k, T.dt,
                               T.refractoriness, i, clock)
                : pv_[i] - v;
        if (upd && m)
            conn_visit(P, C, S, 0, wv, c, dw, ct, t_pre, s_pre, t_post,
                       s_post, dop);
        return cell ? total + (m ? 1.0f : 0.0f) * wv * a : total;
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
        if (cell && C.pre_is_st) {
            if (inb)
                a = train_effect(tlft, T.v_th, T.v_rest, T.k, T.dt,
                                 T.refractoriness, j, clock);
        } else if (cell) {
            const float src = inb ? pv_[j] : 0.0f;
            const float sub = inb ? 1.0f : 0.0f;
            a = src - sub * v;
        }
        if (visit)
            conn_visit(P, C, S, e, wv, c, dw, ct, t_pre, s_pre, t_post,
                       s_post, dop);
        if (cell) tacc = tacc + wv * a;
    }
    return cell ? total + tacc : total;
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

// Step g = k0 + k of a train cell (net_train_kernel's): Poisson u_g <=
// chance, Rate step + dt >= rate; the firing times into set g % 3.
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
}

__global__ void __launch_bounds__(NP_THREADS)
net_persistent_kernel(const __grid_constant__ NetP Pk)
{
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
    unsigned char* sm = sm_all + NP_HDR;
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
    for (int l = 0; l < P.n_lat; ++l) {
        const PLat& L = P.lat[l];
        const size_t n = (size_t)L.rows * L.cols;
        const Own o = owned(n, L.rot);
        for (int j = o.j0; j < o.cnt; j += NP_WARPS) {
            const size_t i = (size_t)(o.lo + j) * 32 + lane;
            if (i < n) lattice_prologue(P, l, i, j * 32 + lane, sm);
        }
    }
    if (P.k0 == 0) {
        for (int t = 0; t < P.n_tr; ++t) {
            const PTrain& T = P.tr[t];
            if (T.kind != TRAIN_RATE) continue;
            const size_t n = (size_t)T.rows * T.cols;
            const Own o = owned(n, T.rot);
            for (int j = o.j0; j < o.cnt; j += NP_WARPS) {
                const size_t i = (size_t)(o.lo + j) * 32 + lane;
                if (i < n) T.step[i] = T.step_in[i];
            }
        }
    }

    for (int k = 0; k <= P.n; ++k) {
        for (int l = 0; l < P.n_lat; ++l) {
            const PLat& L = P.lat[l];
            const size_t n = (size_t)L.rows * L.cols;
            const Own o = owned(n, L.rot);
            for (int j = o.j0; j < o.cnt; j += NP_WARPS) {
                const size_t i = (size_t)(o.lo + j) * 32 + lane;
                if (i >= n) continue;
                lattice_phase(P, l, i, j * 32 + lane, sm, k);
                if (k == P.n) lattice_writeback(P, l, i, j * 32 + lane, sm);
            }
        }
        if (k == P.n) break;
        for (int t = 0; t < P.n_tr; ++t) {
            const PTrain& T = P.tr[t];
            const size_t n = (size_t)T.rows * T.cols;
            const Own o = owned(n, T.rot);
            for (int j = o.j0; j < o.cnt; j += NP_WARPS) {
                const size_t i = (size_t)(o.lo + j) * 32 + lane;
                if (i < n) train_phase(P, t, i, k);
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

// Bytes a block's resident slots of a member take: cap tiles of 32 cells,
// per cell n_slots weights, with traces three more words each, and with
// masks a byte each; rounded up to 16.
static size_t member_bytes(int cap, int n_slots, bool traces, bool mask)
{
    const size_t b = (size_t)cap * 32 * n_slots
        * (4 + (traces ? 12 : 0) + (mask ? 1 : 0));
    return (b + 15) / 16 * 16;
}

// The grid of a launch with `smem` bytes of dynamic shared memory: the
// blocks the card holds at once, occupancy x SMs, and the SM count (cached
// per device and size; the kernel's shared-memory limit is set to `smem`).
static cudaError_t np_grid(int smem, int* blocks, int* sms)
{
    static int last_dev = -1, last_smem = -1, last_blocks = 0, last_sms = 0;
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev == last_dev && smem == last_smem) {
        *blocks = last_blocks;
        *sms = last_sms;
        return cudaSuccess;
    }
    int n_sm = 0, occ = 0, optin = 0;
    cudaFuncAttributes fa;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
            != cudaSuccess
        || (err = cudaFuncGetAttributes(&fa, net_persistent_kernel))
            != cudaSuccess)
        return err;
    if ((size_t)smem + fa.sharedSizeBytes > (size_t)optin)
        return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(
             net_persistent_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
            != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &occ, net_persistent_kernel, NP_THREADS, smem))
            != cudaSuccess)
        return err;
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    last_dev = dev;
    last_smem = smem;
    last_blocks = occ * n_sm;
    last_sms = n_sm;
    *blocks = last_blocks;
    *sms = n_sm;
    return cudaSuccess;
}

extern "C" {

// NP_MAX_LAT, NP_MAX_TR, NP_MAX_CN, PL_I, PL_P, PT_I, PT_P, PC_I, PC_P,
// NP_THREADS and NP_CHUNK, in order.
void net_persistent_limits(int* out)
{
    const int v[11] = {NP_MAX_LAT, NP_MAX_TR, NP_MAX_CN, PL_I, PL_P, PT_I,
                       PT_P, PC_I, PC_P, NP_THREADS, NP_CHUNK};
    for (int q = 0; q < 11; ++q) out[q] = v[q];
}

// The persistent kernel's registers per thread, local (spill and stack)
// bytes per thread, static shared bytes, largest block, the blocks of a
// launch whose resident members take `smem` bytes of a block's shared
// memory (the description's copy comes on top) and the SM count.
// Returns the first CUDA error.
int net_persistent_info(int smem, int* out)
{
    cudaFuncAttributes fa;
    int blocks = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaFuncGetAttributes(&fa, net_persistent_kernel))
            != cudaSuccess
        || (err = np_grid(NP_HDR + smem, &blocks, &sms)) != cudaSuccess)
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

// Runs n_steps steps of a grid-mode electrical or reward network from
// clock0 on `stream`, one cooperative launch of net_persistent_kernel per
// NP_CHUNK steps.  Flat descriptions (host memory), one record per member:
//   lattice ints (PL_I): model, kind (0 plain, 1 plastic: STDP, 2 mod:
//     R-STDP), rows, cols, n_off, emit, resident, shared-memory offset,
//     cap (tiles a block holds at most), dr[LP_MAX_OFFSETS],
//     dc[LP_MAX_OFFSETS];
//   lattice pointers (PL_P): v, w, lft, refr (inputs); buffer set 0 v, w,
//     lft, refr; set 1 v, w, lft, refr; spike sets 0 and 1 (bytes); v_pre
//     (n_steps planes, or null); in_deg; cnt (scratch); stencil weights in
//     and out (out: written, and the same as in for a plain lattice);
//     mask; a mod lattice's traces c, dw, counter in, then out; then the
//     parameter planes in MODEL_PARAM_KEYS order.  refr and its buffers
//     are null for Izhikevich; weights, mask and traces where unused.
//     Step s writes set s % 2, so the result is in set (n_steps - 1) % 2.
//   train ints (PT_I): kind, refractoriness, rows, cols;
//   train pointers (PT_P): lft in, lft sets 0, 1, 2 (step s writes set
//     s % 3), v_th, v_resting, refractoriness k, dt, chance, uniforms
//     (n_steps planes), rate, step in, step out, spikes (the last step's);
//     chance and uniforms Poisson only, rate and step Rate only.
//   connection ints (PC_I): kind (one-to-one or resample), pre_is_st, pre,
//     post, pre_plastic, post_plastic, R1, C1, fr, fc, n_taps, static,
//     reward, resident, shared-memory offset, cap, the taps' dr[NET_MAX_TAPS]
//     and dc[NET_MAX_TAPS];
//   connection pointers (PC_P): w in, w out (the same as in without
//     updates), mask, a reward connection's traces c, dw, counter in, then
//     out.
// rule: the STDP {a_plus, a_minus, tau_plus, tau_minus, dt}; rrule (null
// without the reward arm): {the same five, tau_c, exp_dc, tau_d, exp_dd};
// dop_in (device, one float; null without the reward arm); with_reward:
// `rewards` (host, n_steps floats) move the dopamine and dop_steps (device,
// n_steps floats) receives each step's.  The residency plan (its
// offsets and caps in the ints above) takes `smem` bytes of shared memory
// a block for the resident members; the launches take NP_HDR more (the
// description's copy).  Each resident member is checked to lie within
// `smem` and to hold the tiles a block of this grid owns.  Returns the
// first CUDA error, 0 if none.
int net_persistent_steps(int n_lat, const int* lat_i, void* const* lat_p,
                         int n_tr, const int* tr_i, void* const* tr_p,
                         int n_cn, const int* cn_i, void* const* cn_p,
                         const float* rule, const float* rrule, int clock0,
                         int n_steps, int with_reward, const float* rewards,
                         const float* dop_in, float* dop_steps, int smem,
                         void* stream)
{
    static const int n_params_of[3] = {9, 13, 10};
    if (n_lat <= 0 || n_lat > NP_MAX_LAT || n_tr < 0 || n_tr > NP_MAX_TR
        || n_cn < 0 || n_cn > NP_MAX_CN || n_steps <= 0 || smem < 0
        || (with_reward && (!rrule || !rewards || !dop_in || !dop_steps)))
        return (int)cudaErrorInvalidValue;
    int blocks = 0, sms = 0;
    cudaError_t err = np_grid(NP_HDR + smem, &blocks, &sms);
    if (err != cudaSuccess) return (int)err;

    NetP* P = new NetP();
    P->n_lat = n_lat;
    P->n_tr = n_tr;
    P->n_cn = n_cn;
    P->clock0 = clock0;
    P->with_reward = with_reward;
    P->r = Rule{rule[0], rule[1], rule[2], rule[3], rule[4], 0.0f, 0.0f};
    P->rr = rrule ? Rule{rrule[0], rrule[1], rrule[2], rrule[3], rrule[4],
                         rrule[5], rrule[6]}
                  : Rule{};
    P->exp_dd = rrule ? rrule[8] : 0.0f;
    P->tau_d = rrule ? rrule[7] : 0.0f;
    P->dop_in = dop_in;
    P->dop_steps = dop_steps;
    bool ok = true;
    int rot = 0;
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
            && (!L.res || (L.n_off && L.smem_off >= 0
                           && L.smem_off % 16 == 0
                           && (long long)L.cap * blocks >= tiles
                           && L.smem_off + member_bytes(
                                  L.cap, L.n_off, L.kind == KIND_MOD,
                                  L.kind != KIND_PLAIN) <= (size_t)smem));
        for (int o = 0; o < LP_MAX_OFFSETS; ++o) {
            L.dr[o] = (short)li[9 + o];
            L.dc[o] = (short)li[9 + LP_MAX_OFFSETS + o];
        }
        L.rot = rot;
        rot = (rot + (int)((tiles + blocks - 1) / blocks)) % NP_WARPS;
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
        L.n_in = 0;
    }
    for (int t = 0; t < n_tr && ok; ++t) {
        const int* ti = tr_i + PT_I * t;
        void* const* tp = tr_p + PT_P * t;
        PTrain& T = P->tr[t];
        T.kind = ti[0];
        T.refractoriness = ti[1];
        T.rows = ti[2];
        T.cols = ti[3];
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
        const long long tiles = ((long long)T.rows * T.cols + 31) / 32;
        T.rot = rot;
        rot = (rot + (int)((tiles + blocks - 1) / blocks)) % NP_WARPS;
        ok = (T.kind == TRAIN_POISSON || T.kind == TRAIN_RATE)
            && (T.refractoriness == REFR_DELTA_DIRAC
                || T.refractoriness == REFR_EXP_DECAY)
            && T.rows > 0 && T.cols > 0 && T.lft_in && T.lft[0] && T.lft[1]
            && T.lft[2] && T.v_th && T.v_rest && T.k && T.dt && T.spk
            && (T.kind == TRAIN_POISSON ? T.chance && T.u
                                        : T.rate && T.step_in && T.step);
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
        ok = (C.kind == CONN_ONE2ONE || C.kind == CONN_RESAMPLE)
            && C.pre >= 0 && C.pre < pre_max && C.post >= 0
            && C.post < n_lat && !(C.pre_is_st && C.pre_plastic)
            && C.stat >= 0 && C.w_in && C.w && C.mask
            && (C.kind == CONN_ONE2ONE
                ? C.n_taps == 1
                : C.n_taps > 0 && C.n_taps <= NET_MAX_TAPS && C.fr && C.fc)
            && (!C.reward || (rrule && dop_in && cp[3] && cp[4] && cp[5]
                              && cp[6] && cp[7] && cp[8]))
            && P->lat[C.post].n_in < NET_MAX_IN;
        if (!ok) break;
        const PLat& post = P->lat[C.post];
        const long long tiles = ((long long)post.rows * post.cols + 31) / 32;
        ok = !C.res || (C.smem_off >= 0 && C.smem_off % 16 == 0
                        && (long long)C.cap * blocks >= tiles
                        && C.smem_off + member_bytes(
                               C.cap, C.n_taps, C.reward,
                               C.kind == CONN_ONE2ONE || C.updates)
                           <= (size_t)smem);
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
    if (!ok) {
        delete P;
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    for (int k0 = 0; k0 < n_steps && err == cudaSuccess; k0 += NP_CHUNK) {
        P->k0 = k0;
        P->n = n_steps - k0 < NP_CHUNK ? n_steps - k0 : NP_CHUNK;
        for (int j = 0; j < NP_CHUNK; ++j)
            P->rewards[j] = with_reward && j < P->n ? rewards[k0 + j] : 0.0f;
        void* args[] = {P};
        err = cudaLaunchCooperativeKernel((void*)net_persistent_kernel,
                                          dim3(blocks), dim3(NP_THREADS),
                                          args, (size_t)(NP_HDR + smem), s);
    }
    delete P;
    return (int)err;
}

}  // extern "C"
