"""Finds a cell's configuration, traffic mix, traffic kind, reference and
metric readers by the names in ``BENCHMARK.json``.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json``, the code of the mix's ``kind``
``traffic/kinds/<kind>.py`` (its inputs, its requests and its least time a
call), a metric's reader ``metrics/<metric>.py`` and a reference
``reference/<name>.py`` (the configuration names it; its function named as
the kind recomputes a request), all under the benchmark's directory.  A quantity split by the cells that report it
(``<metric>.<part>``, so that each part has a bound or a ``moves`` of its
own) reads with ``metrics/<metric>.py`` unless a file of the whole name is
there.  Adding a cell, a mix, a configuration or a
metric adds files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Metric(NamedTuple):
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    read: object          # read(ctx) -> float or None


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: tuple        # the cell's `Metric`s, end-to-end first
    kind: object          # the traffic kind's module
    reference: object     # the reference module
    trial: object         # the reference's function of the kind


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _applies(entry, cell):
    names = entry.get("workloads")
    return names is None or cell in names


class Catalog:
    """``BENCHMARK.json`` of ``root`` and the files it names, under
    ``bench_dir`` (the benchmark's directory; by default this one)."""

    def __init__(self, root=ROOT, bench_dir=BENCH_DIR, spec=None):
        self.root, self.bench_dir = root, bench_dir
        self.spec = spec if spec is not None else load_json(
            os.path.join(root, "BENCHMARK.json"))
        self._modules = {}

    def path(self, *parts):
        return os.path.join(self.bench_dir, *parts)

    def config(self, name):
        cfg = load_json(self.path("configs", f"{name}.json"))
        cfg.setdefault("name", name)
        return cfg

    def traffic(self, name):
        mix = load_json(self.path("traffic", f"{name}.json"))
        mix.setdefault("name", name)
        return mix

    def module(self, sub, name):
        """The module ``<sub>/<name>.py`` (``sub`` a relative directory)."""
        key = (sub, name)
        if key not in self._modules:
            tag = sub.replace("/", "_")
            self._modules[key] = _load_module(
                self.path(*sub.split("/"), f"{name}.py"),
                f"snnbench_{tag}_{name.replace('.', '_')}")
        return self._modules[key]

    def reader(self, name):
        """The ``read`` function of metric ``name``."""
        if "." in name and not os.path.exists(
                self.path("metrics", f"{name}.py")):
            return self.reader(name.rsplit(".", 1)[0])
        return self.module("metrics", name).read

    def workload(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cell(self, name):
        w = self.workload(name)
        cfg = self.config(w["config"])
        metrics = []
        for group, e2e in (("end_to_end", True), ("per_layer", False)):
            for m in self.spec[group]:
                if _applies(m, name):
                    metrics.append(Metric(
                        m["name"], m["unit"], m["better"], m["source"], e2e,
                        self.reader(m["name"])))
        traffic = self.traffic(w["traffic"])
        reference = self.module("reference", cfg["reference"])
        kind = traffic["kind"]
        trial = getattr(reference, kind, None)
        if trial is None:
            raise KeyError(f"the reference {cfg['reference']!r} has no "
                           f"function {kind!r} for the traffic kind")
        return Cell(name, int(w["chips"]), cfg, traffic, tuple(metrics),
                    self.module("traffic/kinds", kind), reference, trial)
