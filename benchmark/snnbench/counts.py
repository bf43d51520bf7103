"""The yardstick's arithmetic: the card's peaks and the least time a call's
work could take on it.

Frozen here so that a change to the program cannot move it.  The rule is
one for every kernel: a call advances `CALL_STEPS` steps, each input is
read once and each output written once per call, and the least time is the
larger of the bytes over the peak bandwidth and the float operations over
the peak float32 rate.  The benchmark fixes the 16 steps itself, so that a
new design or call length does not change the count.  The counts are those
of ``chip_smoke.py`` (``bound``, ``stencil_ops``, ``tensor_bytes`` over the
stencil and plasticity calls) written out from the shapes, but for the
neuron parameters: the configurations give each as one number, so they are
charged as scalars, where ``chip_smoke.py`` charged a plane of each.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM bytes/s and float32
# operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# the steps of one call that the counts charge a read of every input for
CALL_STEPS = 16
# float32 parameters of the Izhikevich step (a, b, c, d, v_th, gap
# conductance, tau_m, c_m, dt): a configuration gives each as one number
# for the whole lattice, so a call needs them as scalars, not as planes
IZH_PARAMS = 9


def least_seconds(n_bytes, n_ops):
    """The least time the card could take to move ``n_bytes`` and do
    ``n_ops`` float operations."""
    return max(n_bytes / PEAK_BYTES, n_ops / PEAK_OPS)


def ingrid_slots(offsets, rows, cols):
    """The (offset, cell) pairs whose neighbour lies on the grid."""
    return sum(max(0, rows - abs(dr)) * max(0, cols - abs(dc))
               for dr, dc in offsets)


def stencil_ops(offsets, rows, cols, steps=CALL_STEPS):
    """Float operations of ``steps`` electrical Izhikevich steps: per cell
    the weight sum and 23 of the model step, per on-grid slot a multiply
    and an add."""
    return steps * (rows * cols * (len(offsets) + 23)
                    + 2 * ingrid_slots(offsets, rows, cols))


def stencil_call_bytes(rows, cols, n_off):
    """Bytes of one stencil call: v, w, lft, the weights and the in-degree
    read, and the parameters as scalars; v, w, lft and the spike flags
    written."""
    n = rows * cols
    read = 4 * n * (3 + n_off + 1) + 4 * IZH_PARAMS
    written = 4 * n * 3 + n
    return read + written


def lp_ops(offsets, rows, cols, masked_slots, steps=CALL_STEPS):
    """Float operations of ``steps`` R-STDP steps, counted low: the
    stencil step and, per masked slot, the two visits (10 operations).
    The deltas' exps, whose count depends on which neurons fired, are left
    out, so the least time stays a lower bound."""
    return stencil_ops(offsets, rows, cols, steps) + steps * 10 * masked_slots


def lp_call_bytes(rows, cols, n_off):
    """Bytes of one R-STDP call: v, w, lft, the weights, the mask, the
    in-degree, the three trace planes (c, dw, counter) and the dopamine
    read, and the parameters as scalars; v, w, lft, the spike flags, the
    weights, the traces and the dopamine written."""
    n, slots = rows * cols, rows * cols * n_off
    read = (4 * n * 3 + 4 * slots + slots + 4 * n + 4 * IZH_PARAMS
            + 3 * 4 * slots + 4)
    written = 4 * n * 3 + n + 4 * slots + 3 * 4 * slots + 4
    return read + written


def stencil_call_least(rows, cols, offsets):
    """Least seconds of one `CALL_STEPS`-step stencil call."""
    return least_seconds(stencil_call_bytes(rows, cols, len(offsets)),
                         stencil_ops(offsets, rows, cols))


def lp_call_least(rows, cols, offsets, masked_slots):
    """Least seconds of one `CALL_STEPS`-step R-STDP call."""
    return least_seconds(lp_call_bytes(rows, cols, len(offsets)),
                         lp_ops(offsets, rows, cols, masked_slots))

