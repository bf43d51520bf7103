"""EEG power-spectral-density analysis and earth mover's distance (the
reference's ``backend/src/eeg/``).

PyTorch counterpart of ``spiking_neural_networks_tpu/analysis/eeg.py``,
with `torch.fft`.  Inputs are taken as float32 tensors (on the device of
the first argument where it is a tensor).
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32,
                    device=x.device if device is None else device)
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def get_power_density(x, dt, total_time):
    """`get_power_density` (eeg/mod.rs:15-46): mean-subtracted FFT power
    spectrum.  Returns (frequency axis, positive-half power spectrum).

    Sxx = 2 dt^2 / (N dt) * |X|^2 over [0, N/2); faxis = arange(0, fnq,
    1/T).
    """
    x = _f32(x)
    n = x.shape[0]
    x_fft = torch.fft.fft(x - torch.mean(x))
    sxx = (2.0 * dt ** 2 / (n * dt)) * (x_fft * torch.conj(x_fft))
    sxx_positive = torch.real(sxx[: n // 2])
    df = 1.0 / total_time
    fnq = 1.0 / (2.0 * dt)
    faxis = torch.arange(0.0, fnq, df, dtype=torch.float32, device=x.device)
    return faxis, sxx_positive


def earth_moving_distance(u_values, v_values, u_weights, v_weights):
    """`earth_moving_distance` (eeg/emd/mod.rs:55-120), the scipy
    `wasserstein_distance` construction: the CDF difference integrated
    over the merged support."""
    u_values = _f32(u_values)
    dev = u_values.device
    v_values = _f32(v_values, dev)
    u_weights = _f32(u_weights, dev)
    v_weights = _f32(v_weights, dev)

    u_sorter = torch.argsort(u_values, stable=True)
    v_sorter = torch.argsort(v_values, stable=True)
    all_values = torch.sort(torch.cat([u_values, v_values])).values
    deltas = torch.diff(all_values)

    u_sorted = u_values[u_sorter]
    v_sorted = v_values[v_sorter]
    # 'right' searchsorted over the merged support minus its last element
    u_idx = torch.searchsorted(u_sorted, all_values[:-1], right=True)
    v_idx = torch.searchsorted(v_sorted, all_values[:-1], right=True)

    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    u_cum = torch.cat([zero, torch.cumsum(u_weights[u_sorter], 0)])
    v_cum = torch.cat([zero, torch.cumsum(v_weights[v_sorter], 0)])
    u_cdf = u_cum[u_idx] / u_cum[-1]
    v_cdf = v_cum[v_idx] / v_cum[-1]

    return torch.sum(torch.abs(u_cdf - v_cdf) * deltas)


def power_density_comparison(sxx1, sxx2):
    """`power_density_comparison` (eeg/mod.rs:55-74): the EMD between the
    max-scaled spectra, rescaled by the squared peak-height difference."""
    sxx1 = _f32(sxx1)
    sxx2 = _f32(sxx2, sxx1.device)
    if sxx1.shape != sxx2.shape:
        raise ValueError("series are not the same length")
    values = torch.arange(sxx1.shape[0], dtype=torch.float32,
                          device=sxx1.device)
    u_max = torch.max(sxx1)
    v_max = torch.max(sxx2)
    emd = earth_moving_distance(values, values, sxx1 / u_max, sxx2 / v_max)
    return emd * (u_max - v_max) ** 2
