// K electrical Izhikevich steps on a stencil-coupled (rows, cols) lattice.
//
// Replaces the three TPU kernels of spiking_neural_networks_tpu/ops/
// pallas_stencil.py that carry the electrical Izhikevich lattice:
//   fused_izhikevich_stencil_step      (one step per launch),
//   fused_izhikevich_multistep         (K steps, whole lattice on chip),
//   fused_izhikevich_multistep_tiled   (K steps on row tiles, uniform params).
// The three compute one function and differ only in the layout their
// compiler forced; here it is one kernel with per-neuron parameter planes
// (uniform parameters are constant planes).
//
// Per step and cell (r, c), in the fused association of the TPU kernels:
//   wsum = sum_o w_o                       (offset order, from 0)
//   acc  = sum_o w_o * v[r+dr_o, c+dc_o]   (offset order, from 0)
//   i    = gap * (acc - v * wsum) / max(in_deg, 1)
//   dv   = (0.04 v v + 5 v + 140 - w + i) * (dt / c_m)
//   dw   = (a * (b v - w)) * (dt / tau_m)
//   v' = v + dv, w' = w + dw; spike = v' >= v_th -> v' = c, w' += d,
//   lft = clock0 + k.
// Off-grid neighbours are skipped by a bounds check, never read.  Build with
// -fmad=false: the kernel then rounds exactly as its plain PyTorch twin
// (ops/stencil_kernels.izhikevich_stencil_steps_reference).
//
// Design: one thread per cell, 2-D blocks of 32 x 8, one launch per step;
// izh_stencil_steps loops the K launches on the caller's stream, swapping
// two output buffer sets.  What bounds it on an H100 is memory traffic:
// each step reads n_off weight planes, 9 parameter planes, in_deg, v, w and
// lft and writes v, w, lft.  With radius 2 (12 offsets) that is 25 planes
// read and 3 written, 112 bytes per cell: 29 MB per step at 512 x 512, which
// fits in the 50 MB L2, and 470 MB per step at 2048 x 2048, which streams
// from HBM at 3.35 TB/s (140 us per step at best).  Later work: temporal blocking in shared memory (K steps on
// a tile plus a K*pad halo, the scheme of the tiled TPU kernel), so that
// the planes are read once per K steps; TMA loads; CUDA graphs for the
// launch loop.

#include <cuda_runtime.h>

#define IZH_MAX_OFFSETS 64

struct Stencil {
    int n;
    int dr[IZH_MAX_OFFSETS];
    int dc[IZH_MAX_OFFSETS];
};

struct Params {
    const float* a;
    const float* b;
    const float* c;
    const float* d;
    const float* v_th;
    const float* gap;
    const float* tau_m;
    const float* c_m;
    const float* dt;
};

__global__ void izh_stencil_step_kernel(
    const float* __restrict__ v_in, const float* __restrict__ w_in,
    const int* __restrict__ lft_in,
    float* __restrict__ v_out, float* __restrict__ w_out,
    int* __restrict__ lft_out,
    unsigned char* __restrict__ spk_out,   // null except on the last step
    float* __restrict__ v_pre_out,         // null unless emitting
    const float* __restrict__ weights, const float* __restrict__ in_deg,
    Params p, Stencil st, int rows, int cols, int clock)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (row >= rows || col >= cols) return;
    const size_t n = (size_t)rows * cols;
    const size_t i = (size_t)row * cols + col;

    const float v = v_in[i];
    const float w = w_in[i];
    float acc = 0.0f;
    float wsum = 0.0f;
    for (int o = 0; o < st.n; ++o) {
        const float wo = weights[(size_t)o * n + i];
        wsum = wsum + wo;
        const int sr = row + st.dr[o];
        const int sc = col + st.dc[o];
        if (sr >= 0 && sr < rows && sc >= 0 && sc < cols)
            acc = acc + wo * v_in[(size_t)sr * cols + sc];
    }
    const float cnt = fmaxf(in_deg[i], 1.0f);
    const float i_syn = p.gap[i] * (acc - v * wsum) / cnt;
    const float dt = p.dt[i];
    const float dt_cm = dt / p.c_m[i];
    const float dt_tau = dt / p.tau_m[i];
    const float dv = (0.04f * v * v + 5.0f * v + 140.0f - w + i_syn) * dt_cm;
    const float dw = (p.a[i] * (p.b[i] * v - w)) * dt_tau;
    const float v_pre = v + dv;
    const float w_pre = w + dw;
    const bool spike = v_pre >= p.v_th[i];

    v_out[i] = spike ? p.c[i] : v_pre;
    w_out[i] = spike ? w_pre + p.d[i] : w_pre;
    lft_out[i] = spike ? clock : lft_in[i];
    if (spk_out) spk_out[i] = spike ? 1 : 0;
    if (v_pre_out) v_pre_out[i] = v_pre;
}

extern "C" {

int izh_stencil_max_offsets() { return IZH_MAX_OFFSETS; }

// Runs n_steps steps from (v, w, lft) on `stream`.  Step k writes buffer set
// k % 2 (v_buf[k % 2], ...), so the result is in set (n_steps - 1) % 2; the
// inputs are only read.  `spikes` receives the last step's spike flags and
// `v_pre`, when not null, the pre-reset voltage of step k at k * rows * cols.
// `params` holds the 9 parameter planes in the order a, b, c, d, v_th,
// gap_conductance, tau_m, c_m, dt.  Returns the first CUDA error, 0 if none.
int izh_stencil_steps(
    const float* v, const float* w, const int* lft,
    const float* weights, const float* in_deg, const float* const* params,
    float* v_buf0, float* w_buf0, int* lft_buf0,
    float* v_buf1, float* w_buf1, int* lft_buf1,
    unsigned char* spikes, float* v_pre,
    const int* dr, const int* dc, int n_off,
    int rows, int cols, int clock0, int n_steps, void* stream)
{
    if (n_off < 0 || n_off > IZH_MAX_OFFSETS || rows <= 0 || cols <= 0
        || n_steps <= 0)
        return (int)cudaErrorInvalidValue;
    Stencil st;
    st.n = n_off;
    for (int o = 0; o < n_off; ++o) {
        st.dr[o] = dr[o];
        st.dc[o] = dc[o];
    }
    Params p = {params[0], params[1], params[2], params[3], params[4],
                params[5], params[6], params[7], params[8]};
    float* v_buf[2] = {v_buf0, v_buf1};
    float* w_buf[2] = {w_buf0, w_buf1};
    int* lft_buf[2] = {lft_buf0, lft_buf1};
    const size_t n = (size_t)rows * cols;
    const dim3 block(32, 8);
    const dim3 grid((cols + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    cudaStream_t s = (cudaStream_t)stream;

    const float* v_src = v;
    const float* w_src = w;
    const int* lft_src = lft;
    for (int k = 0; k < n_steps; ++k) {
        const int b = k & 1;
        izh_stencil_step_kernel<<<grid, block, 0, s>>>(
            v_src, w_src, lft_src, v_buf[b], w_buf[b], lft_buf[b],
            k == n_steps - 1 ? spikes : nullptr,
            v_pre ? v_pre + (size_t)k * n : nullptr,
            weights, in_deg, p, st, rows, cols, clock0 + k);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        v_src = v_buf[b];
        w_src = w_buf[b];
        lft_src = lft_buf[b];
    }
    return 0;
}

}  // extern "C"
