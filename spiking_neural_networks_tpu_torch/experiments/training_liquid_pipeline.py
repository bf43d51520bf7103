"""Liquid-state-machine digit classifier with unsupervised plasticity, on
the port's `lixirnet`.

PyTorch counterpart of ``experiments/training_liquid_pipeline.py``, which
implements the experiment sketched in the reference's `interface/
experiments/training_liquid_pipeline.py` (a 1-line design note in the
reference: "should train a simple mnist classifier with unsupervised
plasticity"): 8x8 digit images (scikit-learn's MNIST-style digits) are
encoded as Poisson rates into a recurrent Izhikevich liquid whose
recurrent weights adapt with unsupervised STDP during an initial
exposure phase; a linear readout (closed-form least squares — the only
supervised piece) is then fit on the liquid's spike-count responses.
The output reports test accuracy with and without the STDP exposure.
The digits are the repository's copy (`digits.load_digits`, no
scikit-learn).  The lattices run on the card (``--device cuda``, the
default) unless the caller names another device; the NumPy generator
draws stay in the JAX script's order, so one seed builds the same liquid
and presents the same digits.

Usage:
    python -m spiking_neural_networks_tpu_torch.experiments.\
training_liquid_pipeline [args.toml] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .pipeline_setup import output_path, parse_toml
from .lsm_setup import generate_liquid_weights

from .. import lixirnet as ln

DEFAULTS = dict(
    filename="training_liquid_output.json",
    digits=[0, 1, 2], train_per_class=15, test_per_class=8,
    steps_per_sample=150, stdp_exposure_per_class=10, rows=8, cols=8,
    internal_scalar=1.0, connectivity=0.3, input_weight=5.0,
    max_rate=0.15, stdp_a_plus=0.02, stdp_a_minus=0.025, seed=0,
)


def encode_rates(image, max_rate):
    """Pixel intensity (0..16) -> Poisson chance_of_firing."""
    return (np.asarray(image, np.float64) / 16.0 * max_rate).reshape(-1)


def build_liquid(p, rng, device="cuda"):
    num = p["rows"] * p["cols"]
    w = generate_liquid_weights(num, connectivity=p["connectivity"],
                                scalar=p["internal_scalar"], rng=rng)
    liquid = ln.IzhikevichNeuronLattice(0, device=device)
    liquid.populate(ln.IzhikevichNeuron(), p["rows"], p["cols"])
    p2i = liquid.position_to_index
    liquid.connect(lambda x, y: bool(w[p2i[x]][p2i[y]] != 0),
                   lambda x, y: float(w[p2i[x]][p2i[y]]))
    liquid.apply(lambda n: setattr(
        n, "current_voltage", float(rng.uniform(-65, 30))) or n)
    # gentle STDP: the default a=2.0 dwarfs the ~0.1-0.5 liquid weights and
    # drives the recurrent matrix into saturation within a few samples
    liquid.plasticity = ln.STDP(a_plus=p["stdp_a_plus"],
                                a_minus=p["stdp_a_minus"], dt=1.0)
    liquid.update_grid_history = True

    inputs = ln.PoissonLattice(1, device=device)
    inputs.populate(ln.PoissonNeuron(), p["rows"], p["cols"])

    net = ln.IzhikevichNeuronNetwork.generate_network([liquid], [inputs])
    net.connect(1, 0, lambda x, y: x == y,
                lambda x, y: float(num + 1) * p["input_weight"])
    net.set_dt(1.0)
    return net


def present(net, p, rates, rng, plasticity):
    """Run one sample: set input rates, reset liquid state, run, return the
    liquid's per-neuron spike counts."""
    num = p["rows"] * p["cols"]
    liquid = net.get_lattice(0)
    liquid.do_plasticity = plasticity
    idx = [0]

    def set_rate(pos, n):
        n.chance_of_firing = float(rates[idx[0]])
        idx[0] += 1
        return n

    net.apply_spike_train_lattice_given_position(1, set_rate)
    v0 = rng.uniform(-65, -55, num)
    k = [0]

    def reset_neuron(n):
        n.current_voltage = float(v0[k[0] % num])
        k[0] += 1
        return n

    net.apply_lattice(0, reset_neuron)
    liquid.reset_history()
    net.run_lattices(p["steps_per_sample"])
    hist = np.stack(liquid.history)
    return (hist >= 29.0).sum(axis=0).reshape(-1)


def fit_readout(features, labels, classes):
    x = np.asarray(features, np.float64)
    x = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    y = np.zeros((len(labels), len(classes)))
    for i, lab in enumerate(labels):
        y[i, classes.index(lab)] = 1.0
    coef, *_ = np.linalg.lstsq(x, y, rcond=None)
    return coef


def readout_accuracy(coef, features, labels, classes):
    x = np.asarray(features, np.float64)
    x = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    pred = np.argmax(x @ coef, axis=1)
    truth = np.array([classes.index(lab) for lab in labels])
    return float((pred == truth).mean())


def run(p, device="cuda"):
    from .digits import load_digits

    rng = np.random.default_rng(p["seed"])
    data = load_digits()
    classes = list(p["digits"])
    per_class = {c: np.where(data.target == c)[0] for c in classes}
    for c in classes:
        rng.shuffle(per_class[c])

    train_idx, test_idx, expose_idx = [], [], []
    for c in classes:
        idx = per_class[c]
        n_tr, n_te, n_ex = (p["train_per_class"], p["test_per_class"],
                            p["stdp_exposure_per_class"])
        train_idx += list(idx[:n_tr])
        test_idx += list(idx[n_tr:n_tr + n_te])
        expose_idx += list(idx[n_tr + n_te:n_tr + n_te + n_ex])

    results = {}
    for condition, exposure in (("without_stdp", False),
                                ("with_stdp", True)):
        net = build_liquid(p, np.random.default_rng(p["seed"]), device)
        if exposure:
            # unsupervised phase: free exposure to unlabeled digits with
            # STDP adapting the recurrent weights
            order = list(expose_idx)
            rng.shuffle(order)
            for i in order:
                present(net, p, encode_rates(data.images[i], p["max_rate"]),
                        rng, plasticity=True)
        train_feats = [present(net, p,
                               encode_rates(data.images[i], p["max_rate"]),
                               rng, plasticity=False) for i in train_idx]
        test_feats = [present(net, p,
                              encode_rates(data.images[i], p["max_rate"]),
                              rng, plasticity=False) for i in test_idx]
        coef = fit_readout(train_feats, [data.target[i] for i in train_idx],
                           classes)
        acc = readout_accuracy(coef, test_feats,
                               [data.target[i] for i in test_idx], classes)
        results[condition] = dict(
            test_accuracy=acc,
            mean_active_neurons=float(np.mean(
                [(f > 0).sum() for f in test_feats])))
        print(f"{condition}: test accuracy {acc:.2f}")

    results["chance"] = 1.0 / len(classes)
    results["parameters"] = p
    return results


def main(argv):
    cli = argparse.ArgumentParser(
        prog=argv[0] if argv else None,
        description="The liquid digit classifier on the port's lixirnet; "
                    "without a TOML, `DEFAULTS`.")
    cli.add_argument("toml", nargs="?", help="the pipeline's TOML")
    cli.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = cli.parse_args(list(argv)[1:])
    p = dict(DEFAULTS)
    if args.toml is not None:
        with open(args.toml, "rb") as f:
            parsed = parse_toml(f)
        p.update(parsed.get("simulation_parameters", {}))
    results = run(p, args.device)
    path = output_path(p["filename"])
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"saved {path}")
    return results


if __name__ == "__main__":
    main(sys.argv)
