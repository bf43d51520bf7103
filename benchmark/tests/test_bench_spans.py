"""The readers of the port's span record (`snnbench.spans`,
``metrics/run_setup_us.py``, ``wrapper_us_per_call.py``,
``host_waits_per_run.py``): on synthetic records, where the medians fall in
the larger device-only slice whatever the host slice's inflated times, and
where the span names matched by their form read as the old list of names
did and read a new kernel wrapper's calls too; None on an empty record or
a program without one; and on the record of a traced run of the tiny cells
on the CPU."""

import sys
from types import SimpleNamespace
from typing import NamedTuple, Optional

import pytest

from conftest import run_cell, tiny_catalog
from snnbench import catalog, spans

READERS = ("run_setup_us", "wrapper_us_per_call", "host_waits_per_run")


class Span(NamedTuple):
    id: int
    call: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int


class Recorder:
    """Builds a record as the port makes one: ids in the order spans open,
    each span's call the entry's id."""

    def __init__(self):
        self.spans, self.t, self.next_id = [], 0, 1

    def span(self, name, dur_us, parent=None, call=None, at=None):
        sid = self.next_id
        self.next_id += 1
        start = self.t if at is None else at
        s = Span(sid, sid if call is None else call, parent, name, start,
                 start + int(dur_us * 1000))
        self.spans.append(s)
        return s

    def run(self, entry, setup_us, call_us, calls, waits, call_name):
        """An entry call: ``setup_us`` of set-up with ``waits[0]`` in it,
        ``calls`` kernel calls of ``call_us``, then the other waits."""
        e = self.span(entry, 0)
        t = e.start_ns
        for w in waits[:1]:
            self.span(w, 5, e.id, e.id, at=t)
        t += int(setup_us * 1000)
        for _ in range(calls):
            self.span(call_name, call_us, e.id, e.id, at=t)
            t += int(call_us * 1000) + 1000
        for w in waits[1:]:
            self.span(w, 5, e.id, e.id, at=t)
            t += 5000
        self.spans[self.spans.index(e)] = e._replace(end_ns=t)
        self.t = t + 100_000
        return e

    def loop(self, setup_us, step_us, replays, steps, probe=False):
        e = self.span("loop.run", 0)
        begin = self.span("loop.begin", setup_us, e.id, e.id, at=e.start_ns)
        self.span("wait.nt_mask", 5, begin.id, e.id, at=e.start_ns)
        if probe:
            pr = self.span("loop.probe", 50, begin.id, e.id, at=e.start_ns)
            self.span("loop.step", 1, pr.id, e.id, at=e.start_ns)
        t = begin.end_ns
        for _ in range(replays):
            self.span("loop.replay", 10, e.id, e.id, at=t)
            t += 11_000
        for _ in range(steps):
            self.span("loop.step", step_us, e.id, e.id, at=t)
            t += int(step_us * 1000) + 1000
        fin = self.span("loop.finish", 20, e.id, e.id, at=t)
        self.span("wait.loop_pull", 10, fin.id, e.id, at=t)
        t = fin.end_ns
        self.spans[self.spans.index(e)] = e._replace(end_ns=t)
        self.t = t + 100_000
        return e


def read_all(monkeypatch, record):
    monkeypatch.setitem(sys.modules, spans.PROFILING,
                        SimpleNamespace(record=lambda: list(record)))
    cat = catalog.Catalog()
    return {name: cat.reader(name)(None) for name in READERS}


# The readers' span names as they were listed before the names were
# matched by their form, kept as the oracle of the form.
OLD_ENTRIES = ("lattice.run", "reward.run", "loop.run")
OLD_CALLS = ("stencil.call", "plasticity.call", "loop.replay", "loop.step")


def old_entry_calls(record):
    by_call = {}
    for s in record:
        by_call.setdefault(s.call, []).append(s)
    return [(s, sorted(by_call[s.id], key=lambda x: x.id)) for s in record
            if s.parent is None and s.name in OLD_ENTRIES]


def old_direct_calls(entry, record):
    return [s for s in record if s.parent == entry.id and s.name in OLD_CALLS]


def read_old_and_new(monkeypatch, record):
    new = read_all(monkeypatch, record)
    with monkeypatch.context() as m:
        m.setattr(spans, "entry_calls", old_entry_calls)
        m.setattr(spans, "direct_calls", old_direct_calls)
        old = read_all(m, record)
    return old, new


def card_bound(rec, name, call, requests, setup_us, call_us, waits):
    for _ in range(requests):
        rec.run(name, setup_us, call_us, 8, waits, call)


@pytest.mark.parametrize("entry,call,waits", [
    ("lattice.run", "stencil.call", ["wait.nt_mask"]),
    ("lattice.run", "stencil.call", ["wait.nt_mask",
                                     "wait.uniform_scalars"]),
    ("reward.run", "plasticity.call", ["wait.nt_mask", "wait.dopamine"])])
def test_medians_fall_in_the_device_only_slice(monkeypatch, entry, call,
                                               waits):
    rec = Recorder()
    card_bound(rec, entry, call, 1, 450.0, 22.0, waits)     # unread profile
    card_bound(rec, entry, call, 20, 400.0, 20.0, waits)    # device only
    card_bound(rec, entry, call, 5, 950.0, 47.0, waits)     # host, inflated
    got = read_all(monkeypatch, rec.spans)
    assert 400.0 <= got["run_setup_us"] <= 450.0
    assert got["wrapper_us_per_call"] == pytest.approx(20.0)
    assert got["host_waits_per_run"] == len(waits)


def test_closed_loop_reads_replays_and_eager_steps(monkeypatch):
    rec = Recorder()
    rec.loop(300.0, 40.0, 9, 6, probe=True)       # the probe's steps skipped
    for _ in range(20):
        rec.loop(120.0, 30.0, 9, 6)
    for _ in range(5):
        rec.loop(400.0, 90.0, 9, 6)
    got = read_all(monkeypatch, rec.spans)
    assert got["run_setup_us"] == pytest.approx(120.0)
    assert got["wrapper_us_per_call"] == pytest.approx(30.0)
    assert got["host_waits_per_run"] == 2


def test_probe_steps_are_not_calls(monkeypatch):
    rec = Recorder()
    rec.loop(300.0, 40.0, 0, 3, probe=True)
    got = read_all(monkeypatch, rec.spans)
    # from loop.run's start to its first eager step, past the probe's
    assert got["run_setup_us"] == pytest.approx(300.0)
    assert got["wrapper_us_per_call"] == pytest.approx(40.0)


def test_a_call_cut_by_the_bounded_record(monkeypatch):
    """The record drops its oldest closed spans first: a call's children
    before its entry span.  A call cut so reads low and leaves the median
    to the whole ones."""
    rec = Recorder()
    card_bound(rec, "lattice.run", "stencil.call", 3, 400.0, 20.0,
               ["wait.nt_mask"])
    first = rec.spans[0]
    kept = [s for s in rec.spans if s.call != first.id or s is first]
    got = read_all(monkeypatch, kept)
    assert got["host_waits_per_run"] == 1
    assert got["run_setup_us"] == pytest.approx(400.0)


def _records():
    """A record of each kind of entry call: the stencil's and the R-STDP
    lattice's, the closed loop's with its probe, and a Hodgkin-Huxley
    lattice's (``lattice.run`` with ``hh.call`` kernel calls)."""
    out = {}
    for name, entry, call, waits in (
            ("stencil", "lattice.run", "stencil.call",
             ["wait.nt_mask", "wait.uniform_scalars"]),
            ("plasticity", "reward.run", "plasticity.call",
             ["wait.nt_mask", "wait.dopamine"]),
            ("hh", "lattice.run", "hh.call", ["wait.nt_mask"])):
        rec = Recorder()
        card_bound(rec, entry, call, 1, 450.0, 22.0, waits)
        card_bound(rec, entry, call, 20, 400.0, 20.0, waits)
        card_bound(rec, entry, call, 5, 950.0, 47.0, waits)
        out[name] = rec.spans
    rec = Recorder()
    rec.loop(300.0, 40.0, 9, 6, probe=True)
    for _ in range(20):
        rec.loop(120.0, 30.0, 9, 6)
    out["loop"] = rec.spans
    return out


@pytest.mark.parametrize("kind", ["stencil", "plasticity", "loop"])
def test_the_readers_read_as_the_listed_names_did(monkeypatch, kind):
    """On records of today's entries and calls, the names matched by their
    form give every reader the value that the list of names gave."""
    old, new = read_old_and_new(monkeypatch, _records()[kind])
    assert new == old and None not in new.values()


def test_a_new_kernel_wrappers_calls_are_read(monkeypatch):
    """An HH lattice's ``hh.call`` spans, which the list of names left
    out: its set-up and its calls are read, its waits as before."""
    old, new = read_old_and_new(monkeypatch, _records()["hh"])
    assert old["run_setup_us"] is None and old["wrapper_us_per_call"] is None
    assert 400.0 <= new["run_setup_us"] <= 450.0
    assert new["wrapper_us_per_call"] == pytest.approx(20.0)
    assert new["host_waits_per_run"] == old["host_waits_per_run"] == 1


@pytest.mark.parametrize("module", [
    None, SimpleNamespace(), SimpleNamespace(record=lambda: [])])
def test_none_without_a_record(monkeypatch, module):
    """The program without spans (an earlier one), or an empty record:
    every reader returns None and the line leaves the metric out."""
    if module is None:
        monkeypatch.delitem(sys.modules, spans.PROFILING, raising=False)
    else:
        monkeypatch.setitem(sys.modules, spans.PROFILING, module)
    cat = catalog.Catalog()
    for name in READERS:
        assert cat.reader(name)(None) is None, name


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    return tiny_catalog(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,waits", [("t_lattice", 1), ("t_reward", 2),
                                        ("t_loop", 2)])
def test_a_traced_run_reports_the_span_metrics(cat, cell, waits,
                                                monkeypatch):
    """The tiny cells on the CPU (the profiled slices on the CPU's
    profiler): each traced run reports the three metrics from the port's
    record, which holds the slices' requests alone, and reads them from
    it as the listed names did."""
    from spiking_neural_networks_tpu_torch.utils import profiling
    profiling.clear()
    traced = run_cell(cat, cell, trace=True)
    assert traced["correct"]
    m = traced["metrics"]
    assert m["host_waits_per_run"]["value"] == waits
    assert m["run_setup_us"]["value"] > 0
    assert m["wrapper_us_per_call"]["value"] > 0
    entries = [s for s in profiling.record() if s.parent is None]
    # the unread profile's request, one in the device slice, two in the
    # host slice
    assert len(entries) == 4
    record = profiling.record()
    e2e = run_cell(cat, cell)
    assert not set(e2e["metrics"]) & set(READERS)
    old, new = read_old_and_new(monkeypatch, record)
    assert new == old
