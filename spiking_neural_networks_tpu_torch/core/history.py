"""Lattice history readouts.

PyTorch counterpart of ``spiking_neural_networks_tpu/core/history.py``.
Each history kind is a readout of the state.  ``readout`` takes fields of
shape (N,) for one step or (T, N) for T steps at once, so one call reads a
whole run of steps; the runner copies each chunk's readouts to the host in
one transfer and hands them to ``extend``.  `rebuilt_readouts` reads them
from the pre-reset voltages a kernel emits.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class GridVoltageHistory:
    """Full (rows, cols) voltage snapshot per step."""

    kind = "grid"

    def __init__(self):
        self.history = []

    def readout(self, state, shape):
        v = state["v"]
        return v.reshape(v.shape[:-1] + tuple(shape))

    def extend(self, ys):
        self.history.extend(np.asarray(ys))

    def reset(self):
        self.history.clear()


class AverageVoltageHistory:
    """Mean voltage per step."""

    kind = "average"

    def __init__(self):
        self.history = []

    def readout(self, state, shape):
        return torch.mean(state["v"], dim=-1)

    def extend(self, ys):
        self.history.extend(np.asarray(ys).tolist())

    def reset(self):
        self.history.clear()


class EEGHistory:
    """Point-dipole EEG approximation
    ``(1 / (4 pi c d)) * sum(v - reference_voltage)`` per step."""

    kind = "eeg"

    def __init__(self, reference_voltage=0.007, distance=0.8, conductivity=251.0):
        self.history = []
        self.reference_voltage = reference_voltage
        self.distance = distance
        self.conductivity = conductivity

    def readout(self, state, shape):
        total = torch.sum(state["v"] - self.reference_voltage, dim=-1)
        return (1.0 / (4.0 * math.pi * self.conductivity * self.distance)) * total

    def extend(self, ys):
        self.history.extend(np.asarray(ys).tolist())

    def reset(self):
        self.history.clear()


class SpikeHistory:
    """Spike flags per step, with firing counts from `aggregate`."""

    kind = "spikes"

    def __init__(self):
        self.history = []

    def readout(self, state, shape):
        s = state["is_spiking"]
        return s.reshape(s.shape[:-1] + tuple(shape))

    def extend(self, ys):
        self.history.extend(np.asarray(ys))

    def reset(self):
        self.history.clear()

    def aggregate(self):
        """Firing counts per position."""
        if not self.history:
            return np.zeros((0, 0), np.int64)
        return np.sum(np.stack(self.history).astype(np.int64), axis=0)


HISTORY_KINDS = {
    "grid": GridVoltageHistory,
    "average": AverageVoltageHistory,
    "eeg": EEGHistory,
    "spikes": SpikeHistory,
}


def history_step_bytes(kind, n):
    """Bytes a history readout keeps on the device per step (f32)."""
    return 4 * n if kind in ("grid", "spikes") else 4


def resolve_history_chunk(setting, bytes_per_step, budget=64 << 20):
    """Steps per chunk for a ``history_chunk`` setting.

    None = auto: the chunk's readouts stay under ``budget`` (~64 MB) on the
    device, clamped to [1024, 65536] steps.  An explicit int is used as
    it is."""
    if setting is not None:
        return setting
    if bytes_per_step <= 0:
        return 65536
    return max(1024, min(65536, int(budget) // int(bytes_per_step)))


def rebuilt_readouts(v_pre, v_th, c, readouts, shape):
    """The readouts ``{name: history}`` of an Izhikevich lattice's steps
    from the (n, rows, cols) pre-reset planes ``v_pre`` a kernel emitted,
    with post-reset v and spikes rebuilt by the kernels' own ops (spike =
    ``v_pre >= v_th``, v = ``c`` on a spike); ``v_th`` and ``c`` are
    (rows, cols) planes."""
    n = v_pre.shape[0]
    spk = v_pre >= v_th
    fields = {"v": torch.where(spk, c, v_pre).reshape(n, -1),
              "is_spiking": spk.reshape(n, -1)}
    return {name: h.readout(fields, shape) for name, h in readouts}
