"""Peak detection for voltage traces.

A copy of ``spiking_neural_networks_tpu/analysis/peaks.py`` (NumPy): the
reference's `find_peaks` (``backend/src/neuron/hodgkin_huxley/
mod.rs:108-151``), local maxima of a series within a first-derivative
tolerance, returning the middle index of each peak plateau.
"""

from __future__ import annotations

import numpy as np


def find_peaks(voltages, tolerance=None):
    """Indices of voltage peaks.  With ``tolerance`` given, mirrors the
    reference's derivative-threshold construction; otherwise simple local
    maxima with plateau handling."""
    x = np.asarray(voltages, np.float64)
    if tolerance is not None:
        d1 = np.diff(x)
        d2 = np.diff(d1)
        optima = [i for i, v in enumerate(d1) if abs(v) <= tolerance]
        maxima = [i + 2 for i in optima if i < len(d2) - 1 and d2[i + 1] < 0]
        spans, cur = [], []
        for n, i in enumerate(maxima):
            if n > 0 and maxima[n] - maxima[n - 1] != 1:
                spans.append(cur)
                cur = []
            cur.append(i)
        if cur:
            spans.append(cur)
        return [s[len(s) // 2] for s in spans if s]
    peaks = []
    i = 1
    while i < len(x) - 1:
        if x[i - 1] < x[i]:
            j = i
            while j < len(x) - 1 and x[j + 1] == x[j]:
                j += 1
            if j < len(x) - 1 and x[j + 1] < x[i]:
                peaks.append((i + j) // 2)
            i = j + 1
        else:
            i += 1
    return peaks


def find_peaks_above_threshold(series, threshold):
    series = np.asarray(series)
    return [int(i) for i in find_peaks(series) if series[i] > threshold]
