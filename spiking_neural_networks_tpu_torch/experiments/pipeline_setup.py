"""Shared helpers for the experiment pipelines.

A copy of ``experiments/pipeline_setup.py`` (NumPy and the standard
library's `tomllib` only), the port's own so that its pipelines import
nothing of the JAX package or of ``experiments/``: the reference's
``interface_gpu/experiments/pipeline_setup.py`` utilities (TOML parsing
with range expansion, Hopfield weight construction, spike-train setup
functions, peak / accuracy metrics), vectorized with NumPy where the
reference loops.
"""

from __future__ import annotations

import os
import tomllib

import numpy as np


def output_path(filename):
    """Resolve ``filename`` inside the repo-root ``outputs/`` directory
    (created on demand) so generated artifacts never clutter the source
    tree.  Absolute paths pass through unchanged."""
    if os.path.isabs(filename):
        return filename
    here = os.path.abspath(__file__)
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    out = os.path.join(root, "outputs")
    os.makedirs(out, exist_ok=True)
    return os.path.join(out, filename)


def frange(x, y, step):
    while x < y + step:
        yield x
        x += step


def parse_range_or_list(data):
    result = {}
    for key, value in data.items():
        if isinstance(value, dict) and {"min", "max", "step"} <= set(value):
            result[key] = list(frange(value["min"], value["max"], value["step"]))
        else:
            result[key] = value
    return result


def parse_toml(f):
    """TOML config with {min, max, step} tables expanded into value lists."""
    toml_data = tomllib.load(f)
    return {section: parse_range_or_list(data)
            for section, data in toml_data.items()}


def generate_key_helper(current_state, key, parsed, given_key):
    if len(parsed["variables"][given_key]) != 1:
        key.append(f"{given_key}: {current_state[given_key]}")


def try_max(a):
    return max(a) if len(a) else 0


def get_weights(n, patterns, a=0, b=0, scalar=1):
    """Binary Hopfield weights over flat patterns: w += (p_i - b)(p_j - a),
    zero diagonal, scaled — one outer-product matmul per pattern."""
    w = np.zeros((n, n), np.float64)
    for pattern in patterns:
        p = np.asarray(pattern, np.float64)
        w += np.outer(p - b, p - a)
    np.fill_diagonal(w, 0.0)
    return w * scalar


def weights_ie(n, scalar, patterns, num_patterns):
    """Excitatory->inhibitory weights from summed patterns reshaped to the
    inhibitory grid."""
    w = np.zeros((n, n), np.float64)
    for pattern in patterns:
        p = np.asarray(pattern, np.float64)
        w += p[: n * n].reshape(n, n)
    return (w * scalar) / num_patterns


def check_uniqueness(patterns):
    for n1, i in enumerate(patterns):
        for n2, j in enumerate(patterns):
            if n1 != n2 and (np.array_equal(i, j) or np.array_equal(
                    np.logical_not(i).astype(int), j)):
                return True
    return False


def calculate_correlation(patterns):
    p = np.asarray(patterns, np.float64)
    return p @ p.T


def skewed_random(x, y, skew_factor=1, size=1, rng=None):
    rng = rng or np.random.default_rng()
    return x + rng.beta(skew_factor, 1, size=size) * (y - x)


def generate_setup_neuron(c_m=25, skew_factor=0.1, rng=None):
    def setup_neuron(neuron):
        neuron.current_voltage = float(
            skewed_random(-65, 30, skew_factor, rng=rng)[0])
        neuron.c_m = c_m
        return neuron
    return setup_neuron


def reset_spike_train(neuron):
    neuron.chance_of_firing = 0
    return neuron


def _maybe_flip(state, distortion, stay_unflipped, rng):
    if rng.uniform(0, 1) < distortion:
        if not stay_unflipped:
            state ^= 1
        elif state != 0:
            state = 0
    return state


def get_spike_train_setup_function(patterns, pattern_index, distortion,
                                   firing_rate, exc_n, stay_unflipped=False,
                                   rng=None):
    rng = rng or np.random.default_rng()

    def setup_spike_train(pos, neuron):
        x, y = pos
        state = int(patterns[pattern_index][x * exc_n + y] == 1)
        state = _maybe_flip(state, distortion, stay_unflipped, rng)
        neuron.chance_of_firing = firing_rate if state else 0
        return neuron
    return setup_spike_train


def get_rate_spike_train_setup_function(patterns, pattern_index, distortion,
                                        firing_rate, exc_n,
                                        stay_unflipped=False, rng=None):
    rng = rng or np.random.default_rng()

    def setup_spike_train(pos, neuron):
        x, y = pos
        state = int(patterns[pattern_index][x * exc_n + y] == 1)
        state = _maybe_flip(state, distortion, stay_unflipped, rng)
        if state:
            neuron.rate = firing_rate
            if firing_rate >= 1:
                neuron.step = float(rng.integers(0, int(firing_rate)))
        else:
            neuron.rate = 0
        return neuron
    return setup_spike_train


def get_spike_train_same_firing_rate_setup(firing_rate):
    def setup_spike_train(neuron):
        neuron.chance_of_firing = firing_rate
        return neuron
    return setup_spike_train


def get_noisy_spike_train_setup_function(noise_level, firing_rate, rng=None):
    rng = rng or np.random.default_rng()

    def setup_spike_train(neuron):
        neuron.chance_of_firing = \
            firing_rate if rng.uniform(0, 1) < noise_level else 0
        return neuron
    return setup_spike_train


def get_noisy_rate_spike_train_setup_function(noise_level, firing_rate,
                                              rng=None):
    """Rate-train variant of the noisy setup
    (interface_gpu/experiments/pipeline_setup.py:171-184; the reference
    body references an undefined `noise_level` due to a `noise_leve` typo
    in its signature and would raise NameError if called — this implements
    the evident intent)."""
    rng = rng or np.random.default_rng()

    def setup_spike_train(neuron):
        if rng.uniform(0, 1) < noise_level:
            neuron.rate = firing_rate
            if firing_rate >= 1:
                neuron.step = float(rng.integers(0, int(firing_rate)))
        else:
            neuron.rate = 0
        return neuron
    return setup_spike_train


def find_peaks(series):
    """Local maxima (strictly greater than both neighbors); plateau-aware
    like scipy.signal.find_peaks for simple plateaus.

    Vectorized: a peak is a rising nonzero diff immediately followed (in
    the nonzero-diff sequence) by a falling one; the plateau between spans
    indices a+1..b and the reported index is its midpoint — identical to
    the scalar two-pointer scan (the Python loop cost 0.42 s/trial at 49
    calls x 2500 samples in the Bayesian pipeline)."""
    x = np.asarray(series, np.float64)
    if len(x) < 3:
        return np.asarray([], np.int64)
    d = np.diff(x)
    nz = np.nonzero(d)[0]
    if nz.size < 2:
        return np.asarray([], np.int64)
    cand = (d[nz[:-1]] > 0) & (d[nz[1:]] < 0)
    a = nz[:-1][cand]
    b = nz[1:][cand]
    return ((a + 1 + b) // 2).astype(np.int64)


def find_peaks_above_threshold(series, threshold):
    series = np.asarray(series)
    idx = find_peaks(series)
    return [int(i) for i in idx[series[idx] > threshold]]


def acc(true_pattern, pred_pattern, exc_n, threshold=10):
    pred = np.asarray(pred_pattern).copy()
    pred = np.where(pred < threshold, 0, 1)
    true = np.asarray(true_pattern).reshape(exc_n, exc_n)
    return (true == pred.reshape(exc_n, exc_n)).sum() / (exc_n * exc_n)


def correlation_acc(patterns, num_patterns, desired_pattern_index, firing_data):
    coefficients = [np.corrcoef(patterns[i], firing_data)[0, 1]
                    for i in range(num_patterns)]
    return bool(desired_pattern_index == int(np.argmax(coefficients)))


def signal_to_noise(a, axis=0, ddof=0):
    a = np.asanyarray(a)
    m = a.mean(axis)
    sd = a.std(axis=axis, ddof=ddof)
    return np.where(sd == 0, 0, m / sd)


def determine_accuracy(patterns, desired_pattern_index, num_patterns, window,
                       peaks, exc_n, use_correlation_as_accuracy=True,
                       get_all_accuracies=False, firing_max=20):
    firing_counts = np.array([len([j for j in p if j >= window])
                              for p in peaks])
    if use_correlation_as_accuracy:
        coefficients = [np.corrcoef(patterns[i], firing_counts)[0, 1]
                        for i in range(num_patterns)]
        return bool(desired_pattern_index == int(np.argmax(coefficients)))
    def best_acc(pattern):
        return try_max([acc(pattern, firing_counts.copy(), exc_n, threshold=t)
                        for t in range(firing_max)])
    if get_all_accuracies:
        return [float(max(best_acc(patterns[i]),
                          best_acc(np.logical_not(patterns[i]).astype(int))))
                for i in range(num_patterns)]
    return max(best_acc(patterns[desired_pattern_index]),
               best_acc(np.logical_not(
                   patterns[desired_pattern_index]).astype(int)))


def generate_patterns(num, p_on, num_patterns, correlation_threshold,
                      rng=None):
    rng = rng or np.random.default_rng()
    while True:
        patterns = [rng.binomial(1, p_on, num) for _ in range(num_patterns)]
        if check_uniqueness(patterns):
            continue
        if calculate_correlation(np.array(patterns) / num).sum() \
                > correlation_threshold:
            continue
        return patterns
