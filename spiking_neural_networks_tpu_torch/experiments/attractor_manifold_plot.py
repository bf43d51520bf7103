"""Offline manifold plots of attractor firing data.

PyTorch package's copy of ``experiments/attractor_manifold_plot.py``, the
port of the reference's `interface/experiments/attractor_manifold_plot.py`
(206 LoC): it imports nothing of the JAX package and runs on the host only
(NumPy; matplotlib, imported when a figure is drawn).  It loads the firing-rate data JSON written by the manifold
generation pipelines (keys `"trial: T, pattern: P, distortion: D"` ->
`{"firing_rates": [...]}` plus a `"patterns"` list), embeds the firing
vectors in 3-D, and renders scatter plots colored by cued pattern — the
all-data view plus an optional high-accuracy-only bounded view that keeps
trials whose mean rate is within a band of the global mean AND whose
firing vector best-correlates with the cued pattern
(pipeline_setup.correlation_acc, the reference's accuracy test).

Differences from the reference, by design:
- the bounded-data filter compares each trial's OWN mean firing rate
  against the upper bound; the reference (line 150) compares the stale
  loop-leaked ``current_pattern`` variable instead — a bug that changes
  which trials its bounded plot keeps, deliberately not replicated;
- the reducer is UMAP when the `umap` package is importable, else a PCA
  (top-3 principal axes) — this image has no umap/plotly/seaborn;
- the matplotlib backend saves figures headlessly (`plt.show` only when a
  display is attached); the plotly backend is gated on importability;
- fitted reducers are persisted with pickle instead of joblib.

Usage:
    python -m spiking_neural_networks_tpu_torch.experiments.\
attractor_manifold_plot plot_args.toml

with a TOML like the reference's:
    [plot_args]
    firing_data = "attractor_firing_data.json"
    colors = ["red", "green", "blue"]
    plot_all_data = true
    plot_high_accuracy_only_bounded_data = true
    bounding_percent = 0.5
    backend = "matplotlib"
    save_all_data_plot = "all_data.png"
    save_bounded_plot = "bounded.png"
    [reducer_args]
    reducer_all_data = "reducer.pkl"
"""

from __future__ import annotations

import json
import pickle
import re
import sys

import numpy as np

from .pipeline_setup import correlation_acc, parse_toml

KEY_RE = re.compile(r"trial: (\d+), pattern: (\d+), distortion: (\d+\.*\d*)")


def load_firing_data(path):
    """Reference lines 28-78: rows of [trial, pattern, distortion,
    *firing_rates] parsed out of the generation pipeline's JSON."""
    with open(path) as f:
        contents = json.load(f)
    patterns = contents["patterns"]
    rows = []
    for key, value in contents.items():
        if key == "patterns":
            continue
        m = KEY_RE.search(key)
        rows.append((float(m.group(1)), float(m.group(2)),
                     float(m.group(3)),
                     np.asarray(value["firing_rates"], np.float64)))
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    trials = np.array([r[0] for r in rows])
    labels = np.array([int(r[1]) for r in rows])
    distortions = np.array([r[2] for r in rows])
    rates = np.stack([r[3] for r in rows])        # (n_rows, n_neurons)
    return patterns, trials, labels, distortions, rates


class PCAReducer:
    """Top-3 principal axes; stands in for the reference's umap.UMAP when
    umap isn't installed.  Exposes fit_transform/transform like UMAP."""

    def __init__(self, n_components=3):
        self.n_components = n_components
        self.mean_ = None
        self.components_ = None

    def fit_transform(self, x):
        x = np.asarray(x, np.float64)
        self.mean_ = x.mean(axis=0, keepdims=True)
        xc = x - self.mean_
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        comp = vt[: self.n_components]
        if comp.shape[0] < self.n_components:  # rank < 3 (tiny inputs):
            comp = np.pad(                     # pad zero axes so plots
                comp, ((0, self.n_components - comp.shape[0]), (0, 0)))
        self.components_ = comp
        return xc @ self.components_.T

    def transform(self, x):
        return (np.asarray(x, np.float64) - self.mean_) @ self.components_.T


def make_reducer():
    try:
        import umap
        return umap.UMAP(n_components=3)
    except ImportError:
        return PCAReducer(n_components=3)


def standardize(x):
    """StandardScaler().fit_transform without sklearn: zero-mean unit-var
    per feature (columns with zero variance pass through centered)."""
    x = np.asarray(x, np.float64)
    mu = x.mean(axis=0, keepdims=True)
    sd = x.std(axis=0, keepdims=True)
    return (x - mu) / np.where(sd == 0, 1.0, sd)


def scatter3(embedding, colors, title, save, backend, show):
    if backend == "plotly":
        try:
            import plotly.graph_objects as go
        except ImportError as e:
            raise ValueError(
                "plotly backend requested but plotly is not installed; "
                "use backend = 'matplotlib'") from e
        fig = go.Figure(data=[go.Scatter3d(
            x=embedding[:, 0], y=embedding[:, 1], z=embedding[:, 2],
            mode="markers",
            marker=dict(size=5, color=colors, opacity=0.8))])
        fig.update_layout(title=title)
        if show:
            fig.show()
        if save is not None:
            fig.write_html(save)
        return
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(12, 12))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(embedding[:, 0], embedding[:, 1], embedding[:, 2], c=colors)
    plt.title(title)
    if show:
        plt.show()
    if save is not None:
        fig.savefig(save)
    plt.close(fig)


def main(args_file, show=False):
    with open(args_file, "rb") as f:
        args = parse_toml(f)
    if "plot_args" not in args:
        raise ValueError("Requires plot_args table")
    pa = args["plot_args"]
    if "firing_data" not in pa:
        raise ValueError("plot_args requires firing_data argument")
    pa.setdefault("plot_all_data", True)
    pa.setdefault("plot_high_accuracy_only_bounded_data", False)
    if pa["plot_high_accuracy_only_bounded_data"]:
        pa.setdefault("bounding_percent", 0.5)
    pa.setdefault("backend", "matplotlib")
    pa.setdefault("save_all_data_plot", None)
    pa.setdefault("save_bounded_plot", None)
    if "colors" not in pa:
        raise ValueError("plot_args requires colors argument")
    ra = args.get("reducer_args", {})
    ra.setdefault("reducer_all_data", None)
    ra.setdefault("reducer_high_accuracy_only_bounded", None)

    patterns, _, labels, _, rates = load_firing_data(pa["firing_data"])
    num_patterns = len(patterns)
    pattern_colors = pa["colors"]
    print("Loaded data...")

    if pa["plot_all_data"]:
        reducer = make_reducer()
        embedding = reducer.fit_transform(standardize(rates))
        colors = [pattern_colors[p % len(pattern_colors)] for p in labels]
        scatter3(embedding, colors, "Attractor States",
                 pa["save_all_data_plot"], pa["backend"], show)
        if ra["reducer_all_data"] is not None:
            with open(ra["reducer_all_data"], "wb") as f:
                pickle.dump(reducer, f)

    if pa["plot_high_accuracy_only_bounded_data"]:
        # reference lines 142-157: drop trials whose mean rate is outside
        # the [lo*mean, hi*mean] band, then keep only trials whose rate
        # vector best-correlates with the cued pattern
        mean_rate = rates.mean()
        bound = pa["bounding_percent"]
        keep = []
        for i in range(rates.shape[0]):
            rate_i = rates[i].mean()
            if rate_i < mean_rate * bound or rate_i > mean_rate * (1 + bound):
                continue
            if correlation_acc(patterns, num_patterns, labels[i], rates[i]):
                keep.append(i)
        if not keep:
            print("bounded plot: no high-accuracy trials in band; skipped")
        else:
            keep = np.asarray(keep)
            selected_reducer = make_reducer()
            embedding = selected_reducer.fit_transform(
                standardize(rates[keep]))
            colors = [pattern_colors[p % len(pattern_colors)]
                      for p in labels[keep]]
            scatter3(embedding, colors, "Attractor States",
                     pa["save_bounded_plot"], pa["backend"], show)
            if ra["reducer_high_accuracy_only_bounded"] is not None:
                with open(ra["reducer_high_accuracy_only_bounded"],
                          "wb") as f:
                    pickle.dump(selected_reducer, f)

    print("\033[92mFinished plots\033[0m")


if __name__ == "__main__":
    main(sys.argv[1], show=sys.stdout.isatty())
