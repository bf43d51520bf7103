"""The comparison that decides ``correct``: the state and outputs that the
timed path produced for a sample of the window's requests, against the
reference's trial from the same inputs.

The numbers compared (each the largest over the sample):

* ``neurons_off``: the share of neurons whose final voltage or recovery
  variable ``u`` (the state's ``w``) lies more than ``band_mv`` from the
  reference's, or whose last firing time lies more than ``band_steps``
  steps from it (or which fired on one side only), the upstream CPU-GPU
  criterion (2 mV, 2 steps), held to ``u`` too;
* ``synapses_off`` (R-STDP): the share of masked edges whose weight, trace
  ``c`` or accumulator ``dw`` lies more than ``synapse_rel`` from the
  reference's, relative to the larger of the value and the plane's
  largest magnitude times ``synapse_rel``, or whose visit counter differs;
* ``dopamine_gap`` (R-STDP): the dopamine's gap relative to the
  reference's;
* ``rewards_gap`` (closed loop): the largest gap of a step's reward;
* ``rate_gap`` (closed loop): the gap of the environment's rate.

A number that is not finite fails.  The limits are the configuration's
``limits``, and the traffic mix's for its own numbers (a mix's limit of a
configuration's number replaces it).
"""

from __future__ import annotations

import math

import torch


def neurons_off(prog, ref, band_mv, band_steps):
    far = torch.zeros_like(prog["v"], dtype=torch.bool)
    for k in ("v", "w"):
        p = prog[k].float()
        far |= ((p - ref[k].float()).abs() > band_mv) | ~torch.isfinite(p)
    lp, lr = prog["lft"].long(), ref["lft"].long()
    one_side = (lp < 0) != (lr < 0)
    bad = far | one_side | ((lp - lr).abs() > band_steps)
    return float(bad.float().mean())


def _far(p, r, rel):
    p, r = p.float(), r.float()
    scale = rel * torch.clamp(r.abs(), min=float(r.abs().max()) * rel)
    return ((p - r).abs() > scale) | ~torch.isfinite(p)


def synapses_off(prog, ref, mask, rel):
    bad = (_far(prog["weights"], ref["weights"], rel)
           | _far(prog["c"], ref["c"], rel)
           | _far(prog["dw"], ref["dw"], rel)
           | (prog["counter"] != ref["counter"]))
    return float((bad & mask).sum()) / max(int(mask.sum()), 1)


def rel_gap(p, r):
    p, r = float(p), float(r)
    if not math.isfinite(p):
        return math.inf
    return abs(p - r) / max(abs(r), 1e-30)


def numbers(prog, ref, mask, cfg):
    """The compared numbers of one request: ``prog`` the program's
    snapshot, ``ref`` the reference's trial, on one device."""
    acc = cfg["accuracy"]
    out = {"neurons_off": neurons_off(prog, ref, acc["band_mv"],
                                      acc["band_steps"])}
    if "weights" in ref:
        out["synapses_off"] = synapses_off(prog, ref, mask,
                                           acc["synapse_rel"])
        out["dopamine_gap"] = rel_gap(prog["dopamine"], ref["dopamine"])
    if "rewards" in ref:
        gap = (prog["rewards"].float().to(ref["rewards"].device)
               - ref["rewards"].float()).abs()
        out["rewards_gap"] = float(gap.max()) if bool(
            torch.isfinite(gap).all()) else math.inf
        out["rate_gap"] = abs(float(prog["rate"]) - float(ref["rate"]))
    return out


def merge(rows):
    """The largest of each number over the sample's rows (NaN counts as
    infinite)."""
    out = {}
    for row in rows:
        for k, x in row.items():
            x = math.inf if x != x else x
            out[k] = max(out.get(k, -math.inf), x)
    return out


def limits_of(cell):
    """The limits of ``cell``'s compared numbers: its configuration's, and
    its traffic mix's over them."""
    return dict(cell.config["limits"], **cell.traffic.get("limits", {}))


def verdict(nums, limits):
    """``(correct, {name: {"value", "limit"}})``; a number with no limit
    is an error of the benchmark's files."""
    checks, ok = {}, True
    for k, x in nums.items():
        if k not in limits:
            raise KeyError(f"no limit for the compared number {k!r}")
        checks[k] = {"value": x, "limit": limits[k]}
        ok = ok and math.isfinite(x) and x <= limits[k]
    return ok, checks
