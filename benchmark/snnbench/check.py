"""The comparison that decides ``correct``: the state and outputs that the
timed path produced for a sample of the window's requests, against the
reference's trial from the same inputs.

What is compared is named by the configuration's ``accuracy``, by keys of
the program's snapshot and of the reference's trial; this module names
none.  Its groups (a group left out compares nothing):

* ``neurons``: {plane: band}, per-neuron planes held to an absolute band;
* ``firing``: {plane: band}, firing-time planes (negative where the neuron
  never fired) held to a band in steps;
* ``synapses``: [plane, ...], per-edge planes held to ``synapse_rel``;
* ``scalars``: [name, ...], each held to a gap relative to the
  reference's.

A key that the configuration names and either side lacks is an error of
the benchmark's files.  The numbers compared (each the largest over the
sample):

* ``neurons_off``: the share of neurons of which a ``neurons`` plane lies
  more than its band from the reference's or is not finite, or whose
  firing time lies more than its band from it (or which fired on one side
  only).  The neuron's shape is that of the named plane of fewest
  dimensions; a plane of more entries a neuron (rows, cols, k) counts the
  neuron off where any of its k entries is;
* ``synapses_off``: the share of masked edges of which a float plane lies
  more than ``synapse_rel`` from the reference's, relative to the larger
  of the value and the plane's largest magnitude times ``synapse_rel``, or
  an integer plane (by the reference's type) differs at all;
* ``<name>_gap``: a scalar's gap relative to the reference's
  (``dopamine_gap``);
* the traffic kind's own numbers, where its module has ``numbers(prog,
  ref)`` (the closed loop's ``rewards_gap`` and ``rate_gap``).

A number that is not finite fails.  The limits are the configuration's
``limits``, and the traffic mix's for its own numbers (a mix's limit of a
configuration's number replaces it); a number without a limit, or a limit
without its number, is an error of the benchmark's files.
"""

from __future__ import annotations

import math

import torch


def _pair(prog, ref, key):
    """The program's and the reference's ``key``, of one shape."""
    for side, d in (("program's snapshot", prog), ("reference's trial", ref)):
        if key not in d:
            raise KeyError(f"the configuration compares {key!r}, which the "
                           f"{side} lacks")
    p, r = prog[key], ref[key]
    if p.shape != r.shape:
        raise ValueError(f"{key!r} has the shape {tuple(p.shape)} in the "
                         f"program's snapshot, {tuple(r.shape)} in the "
                         f"reference's trial")
    return p, r


def neurons_off(prog, ref, bands, firing):
    planes = {k: _pair(prog, ref, k) for k in (*bands, *firing)}
    shape = min((r.shape for _, r in planes.values()), key=len)

    def per_neuron(k, x):
        if x.shape[:len(shape)] != shape:
            raise ValueError(f"the plane {k!r} of shape {tuple(x.shape)} is "
                             f"not one a neuron of shape {tuple(shape)}")
        return x.reshape(*shape, -1).any(-1)

    bad = torch.zeros(shape, dtype=torch.bool,
                      device=next(iter(planes.values()))[0].device)
    for k, band in bands.items():
        p, r = planes[k]
        p = p.float()
        bad |= per_neuron(k, ((p - r.float()).abs() > band)
                          | ~torch.isfinite(p))
    for k, band in firing.items():
        lp, lr = (x.long() for x in planes[k])
        bad |= per_neuron(k, ((lp < 0) != (lr < 0))
                          | ((lp - lr).abs() > band))
    return float(bad.float().mean())


def _far(p, r, rel):
    p, r = p.float(), r.float()
    scale = rel * torch.clamp(r.abs(), min=float(r.abs().max()) * rel)
    return ((p - r).abs() > scale) | ~torch.isfinite(p)


def synapses_off(prog, ref, mask, planes, rel):
    bad = torch.zeros_like(mask)
    for k in planes:
        p, r = _pair(prog, ref, k)
        bad |= _far(p, r, rel) if r.is_floating_point() else p != r
    return float((bad & mask).sum()) / max(int(mask.sum()), 1)


def rel_gap(p, r):
    p, r = float(p), float(r)
    if not math.isfinite(p):
        return math.inf
    return abs(p - r) / max(abs(r), 1e-30)


def numbers(prog, ref, mask, accuracy):
    """The compared numbers of one request that a configuration's
    ``accuracy`` names: ``prog`` the program's snapshot, ``ref`` the
    reference's trial, on one device."""
    out = {}
    bands, firing = accuracy.get("neurons", {}), accuracy.get("firing", {})
    if bands or firing:
        out["neurons_off"] = neurons_off(prog, ref, bands, firing)
    if accuracy.get("synapses"):
        out["synapses_off"] = synapses_off(prog, ref, mask,
                                           accuracy["synapses"],
                                           accuracy["synapse_rel"])
    for k in accuracy.get("scalars", ()):
        out[f"{k}_gap"] = rel_gap(*_pair(prog, ref, k))
    return out


def compare(cell, prog, ref, mask):
    """The compared numbers of one request of ``cell``: its
    configuration's, then its traffic kind's own."""
    out = numbers(prog, ref, mask, cell.config["accuracy"])
    own = getattr(cell.kind, "numbers", None)
    if own is not None:
        out.update(own(prog, ref))
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
    """``(correct, {name: {"value", "limit"}})``; a number with no limit,
    or a limit with no number, is an error of the benchmark's files."""
    missing = sorted(set(limits) - set(nums))
    if missing:
        raise KeyError(f"no compared number for the limits {missing}")
    checks, ok = {}, True
    for k, x in nums.items():
        if k not in limits:
            raise KeyError(f"no limit for the compared number {k!r}")
        checks[k] = {"value": x, "limit": limits[k]}
        ok = ok and math.isfinite(x) and x <= limits[k]
    return ok, checks
