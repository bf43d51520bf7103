"""A replay of the stencil kernel's streamed schedule (``csrc/
izhikevich_stencil.cu``, `izh_tiled_kernel_rows`) on the CPU, for the
tests: each block of a `stencil_kernels.StreamPlan` marches down its
segment r rows an iteration through rings of the depths
`stencil_kernels.stream_rings`, each slot tagged with the row it holds, and
time level l computes the row l r behind the newest from level l - 1's
rows (those of this iteration too: a barrier parts the levels), its
row's w, lft, wsum and count carried from the iteration before.  The
copies of an iteration land while its levels read, so they are applied
at its end, and one that evicts a row read in the same iteration raises;
a read of a slot that holds another row than the one asked for raises
too.  So a ring too shallow or a level that runs ahead fails here; the
arithmetic is the twin's, cell by cell, so a sound schedule gives the
twin's bits.
"""

import numpy as np
import torch

from spiking_neural_networks_tpu_torch.ops import stencil_kernels as sk


def replay(plan, v, w, lft, weights, in_deg, params, offsets, clock0,
           n_steps, emit=False):
    """``(v, w, lft, spikes, v_pre)`` after ``n_steps`` steps of the
    streamed schedule of ``plan`` (launches of plan.kb steps, the last what
    is left), as `izhikevich_stencil_steps_reference` returns them."""
    rows, cols = v.shape
    sc = [torch.tensor(float(params[k].reshape(-1)[0]), dtype=torch.float32)
          for k in sk.PARAM_ORDER]
    v_pre = torch.full((int(n_steps), rows, cols), float("nan")) \
        if emit else None
    spikes = torch.zeros((rows, cols), dtype=torch.bool)
    state = (v.numpy(), w.numpy(), lft.numpy())
    k0 = 0
    while k0 < n_steps:
        n = min(plan.kb, n_steps - k0)
        out = (np.full((rows, cols), np.nan, np.float32),
               np.full((rows, cols), np.nan, np.float32),
               np.full((rows, cols), -7, np.int32))
        spk = np.zeros((rows, cols), bool)
        pre = np.full((n, rows, cols), np.nan, np.float32)
        for sy in range(plan.segments):
            for sx in range(plan.strips):
                _block(plan, sx, sy, state, weights.numpy(), in_deg.numpy(),
                       offsets, sc, clock0 + k0, n, out, spk, pre)
        if emit:
            v_pre[k0:k0 + n] = torch.from_numpy(pre)
        state = out
        k0 += n
    spikes = torch.from_numpy(spk)
    return (torch.from_numpy(state[0]), torch.from_numpy(state[1]),
            torch.from_numpy(state[2]), spikes, v_pre)


def _step(vv, ww, acc, wsum, cnt, sc):
    a, b, c, d, v_th, gap, tau_m, c_m, dt = sc
    vv, ww = torch.from_numpy(vv), torch.from_numpy(ww)
    i_syn = gap * (torch.from_numpy(acc) - vv * torch.from_numpy(wsum)) \
        / torch.from_numpy(cnt)
    dv = (0.04 * vv * vv + 5.0 * vv + 140.0 - ww + i_syn) * (dt / c_m)
    dw = (a * (b * vv - ww)) * (dt / tau_m)
    v_pre = vv + dv
    w_pre = ww + dw
    spike = v_pre >= v_th
    return (torch.where(spike, c, v_pre).numpy(),
            torch.where(spike, w_pre + d, w_pre).numpy(), spike.numpy(),
            v_pre.numpy())


def _block(plan, sx, sy, state, weights, in_deg, offsets, sc, clock0, n,
           out, spk, pre):
    vin, win, lin = state
    rows, cols = vin.shape
    R, pad, KB, H = plan.r, plan.pad, plan.kb, plan.halo
    x0, y0 = sx * plan.tw, sy * plan.seg
    twb, segb = min(plan.tw, cols - x0), min(plan.seg, rows - y0)
    lwb, nl = twb + 2 * H, segb + 2 * H
    DW, D0, DV = sk.stream_rings(KB, R, pad)
    n_off = len(offsets)
    c = np.arange(lwb)
    gc = x0 - H + c
    col_on = (gc >= 0) & (gc < cols)
    gcc = np.clip(gc, 0, cols - 1)
    col_in = (c >= H) & (c < H + twb)
    # rings by key: values and the row each slot holds (-1: none yet); a
    # copy lands, and a level writes, while the iteration's levels read, so
    # writes are applied at the iteration's end, and one that evicts a row
    # read in the same iteration raises
    depth = {"w": DW, "v0": D0, **{l: DV for l in range(1, KB)}}
    val = {k: np.full((d, lwb, max(n_off, 1)) if k == "w" else (d, lwb),
                      np.nan, np.float32) for k, d in depth.items()}
    tag = {k: np.full((d, lwb), -1) for k, d in depth.items()}
    carry = {}

    def write(k, u, cells, x, pending):
        pending.append((k, u, cells, x))

    def apply(pending, read):
        for k, u, cells, x in pending:
            s = u % depth[k]
            for old in set(tag[k][s, cells].tolist()) - {-1, u}:
                if (k, old) in read:
                    raise AssertionError(f"ring {k}: row {u} evicts row "
                                         f"{old}, read in the same iteration")
            val[k][s, cells] = x
            tag[k][s, cells] = u

    def fetch(k, u, cells, read):
        s = u % depth[k]
        got = tag[k][s, cells]
        if not (got == u).all():
            raise AssertionError(f"ring {k}: slot of row {u} holds "
                                 f"{set(got.tolist())}")
        read.add((k, u))
        return val[k][s, cells]

    def load_v(u, pending):
        g = y0 - H + u
        on = col_on & (0 <= g < rows)
        write("v0", u, c, np.where(on, vin[min(max(g, 0), rows - 1), gcc],
                                   np.float32(0)), pending)

    pending = []
    for i in range(R):
        load_v(i, pending)
    apply(pending, set())
    prev, cur = {}, {}
    for t in range((nl - n * pad - 1) // R + n + 1):
        pending, read = [], set()
        for i in range(R):
            u = (t + 1) * R + i
            if u < nl:
                load_v(u, pending)
            u = t * R + i
            g = y0 - H + u
            if pad <= u < nl - pad and 0 <= g < rows:
                cells = c[pad:lwb - pad][col_on[pad:lwb - pad]]
                write("w", u, cells, weights[:, g, gcc[cells]].T, pending)
                interior = col_in[cells] & (H <= u < H + segb)
                cur[(0, i)] = (
                    u, cells, win[g, gcc[cells]].copy(),
                    np.maximum(in_deg[g, gcc[cells]], np.float32(1.0)),
                    np.where(interior, lin[g, gcc[cells]], 0))
        for l in range(1, n + 1):
            level = []
            for i in range(R):
                u = t * R + i - l * R
                if not l * pad <= u < nl - l * pad:
                    continue
                g = y0 - H + u
                cells = c[l * pad:lwb - l * pad]
                on = col_on[cells] if 0 <= g < rows \
                    else np.zeros(len(cells), bool)
                lv = np.zeros(len(cells), np.float32)
                k = "v0" if l == 1 else l - 1
                if on.any():
                    dc = cells[on]
                    # the row's state from level l - 1, last iteration
                    row, src = prev[(l - 1, i)][0], prev[(l - 1, i)][1:]
                    if row != u:
                        raise AssertionError(f"level {l} took row {row}'s "
                                             f"state for row {u}")
                    pick = np.searchsorted(src[0], dc)
                    assert (src[0][pick] == dc).all()
                    ww, cnt, lf = src[1][pick], src[2][pick], src[3][pick]
                    wts = fetch("w", u, dc, read)
                    acc = np.zeros(len(dc), np.float32)
                    ws = np.zeros(len(dc), np.float32)
                    for o, (dr, dcol) in enumerate(offsets):
                        acc = acc + wts[:, o] * fetch(k, u + dr, dc + dcol,
                                                      read)
                        ws = ws + wts[:, o]
                    wsum = ws if l == 1 else src[4][pick]
                    vv = fetch(k, u, dc, read)
                    v1, w1, spike, v_pre = _step(vv, ww, acc, wsum, cnt, sc)
                    lf = np.where(spike, clock0 + l - 1, lf)
                    cur[(l, i)] = (u, dc, w1, cnt, lf, wsum)
                    lv[on] = v1
                    inner = col_in[dc] & (H <= u < H + segb)
                    gi = gcc[dc[inner]]
                    pre[l - 1, g, gi] = v_pre[inner]
                    if l == n:
                        out[0][g, gi] = v1[inner]
                        out[1][g, gi] = w1[inner]
                        out[2][g, gi] = lf[inner]
                        spk[g, gi] = spike[inner]
                if l < n:
                    write(l, u, cells, lv, level)
            # the barrier after level l: level l + 1 reads its rows
            apply(level, set())
        apply(pending, read)
        prev = {**prev, **cur}
