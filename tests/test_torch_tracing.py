"""The port's spans (`spiking_neural_networks_tpu_torch.utils.profiling.
span`) on the CPU: off, nothing is recorded or entered; on, the spans of
the lattice, reward and closed-loop runs land in the profiler's Chrome
trace nested under their entry calls, and in the record with ids, parents
and self times that add up; the record is bounded; the probe runs with
spans on; the host waits per run are those of each route.  Small lattices
on CPU tensors with ``use_kernel=True``, so that the kernels' wrappers run
their plain twins."""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import spiking_neural_networks_tpu_torch as snt
from spiking_neural_networks_tpu_torch.utils import profiling

torch.set_num_threads(1)

ENTRIES = ("lattice.run", "reward.run", "loop.run")


def lattice(cls=snt.Lattice, n=8, radius=2.0, device="cpu"):
    lat = cls(snt.Izhikevich(), device=device)
    lat.populate(n, n, gap_conductance=10.0)
    lat.connect_stencil(radius=radius)
    lat.use_kernel = True
    return lat


def closed_loop(device="cpu"):
    agent = lattice(snt.RewardModulatedLattice, n=10, device=device)
    cue = torch.arange(agent.n, device=device) < 6

    def encoder(e, s):
        return {**s, "v": torch.where(cue, 31.0, s["v"])}

    def reward(e, s):
        return torch.clamp(0.08 - e["rate"], -0.05, 0.05)

    def update(e, s):
        return {"rate": 0.9 * e["rate"]
                + 0.1 * s["is_spiking"].to(torch.float32).mean()}

    return snt.interactable.JitEnvironment(
        agent, {"rate": torch.zeros((), device=device)}, encoder, reward,
        update)


def run_all(device="cpu"):
    """One run of each entry: a lattice of 40 steps (3 stencil calls), a
    reward lattice of 40 steps (3 plasticity calls), and two closed-loop
    calls of 20 steps (the first probes)."""
    lattice(device=device).run_lattice(40)
    lattice(snt.RewardModulatedLattice,
            device=device).run_lattice_with_reward(0.5, 40)
    env = closed_loop(device)
    env.run_with_reward(20)
    env.run_with_reward(20)


@pytest.fixture
def record():
    profiling.clear()
    yield
    profiling.clear()


def test_off_records_and_enters_nothing(record, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span that is off entered a record_function")

    monkeypatch.setattr(profiling, "_annotate", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b")    # the shared no-op
    run_all()
    assert profiling.record() == []


def _trace_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_spans_land_in_the_chrome_trace_under_their_entries(record,
                                                           tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_all()
    spans = _trace_events(prof, tmp_path)
    entries = [e for e in spans if e["name"] in ENTRIES]
    assert collections.Counter(e["name"] for e in entries) == {
        "lattice.run": 1, "reward.run": 1, "loop.run": 2}

    def entry_of(e):
        hold = [x["name"] for x in entries
                if x["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= x["ts"] + x["dur"]]
        assert len(hold) == 1, e["name"]
        return hold[0]

    under = collections.defaultdict(set)
    for e in spans:
        if e["name"] not in ENTRIES:
            under[entry_of(e)].add(e["name"])
    assert under["lattice.run"] == {"lattice.route", "wait.nt_mask",
                                    "stencil.setup", "stencil.call"}
    assert under["reward.run"] == {"wait.nt_mask", "reward.setup",
                                   "plasticity.call", "wait.dopamine"}
    assert under["loop.run"] == {"loop.begin", "wait.nt_mask", "loop.load",
                                 "loop.probe", "loop.step", "loop.flush",
                                 "loop.finish", "wait.loop_pull"}
    # the record holds the same spans as the trace
    assert collections.Counter(s.name for s in profiling.record()) \
        == collections.Counter(e["name"] for e in spans)


def test_record_ids_parents_and_self_times(record):
    with profiling.recording():
        run_all()
    spans = profiling.record()
    by_id = {s.id: s for s in spans}
    assert [s.id for s in spans] == sorted(by_id)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["lattice.run", "reward.run",
                                       "loop.run", "loop.run"]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.call == s.id
            continue
        up = by_id[s.parent]
        assert s.call == up.call and up.id < s.id
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    own = profiling.self_ns(spans)
    assert all(t >= 0 for t in own.values())
    for root in roots:
        # an entry call's self times add up to its duration
        assert sum(own[s.id] for s in spans if s.call == root.id) \
            == root.end_ns - root.start_ns
    names = {s.id: s.name for s in spans}
    assert {names[s.parent] for s in spans if s.name == "wait.nt_mask"} \
        == {"lattice.route", "reward.run", "loop.begin"}
    assert {names[s.parent] for s in spans if s.name == "stencil.call"} \
        == {"lattice.run"}


def test_record_is_bounded(record):
    n = profiling.RECORD_SPANS
    with profiling.recording():
        for _ in range(n + 10):
            with profiling.span("s"):
                pass
    spans = profiling.record()
    assert len(spans) == n
    assert spans[-1].id - spans[0].id == n - 1     # the oldest dropped


def test_spans_off_again_after_recording(record):
    with profiling.recording():
        with profiling.recording():
            with profiling.span("a"):
                pass
        with profiling.span("b"):
            pass
    with profiling.span("c"):
        pass
    assert [s.name for s in profiling.record()] == ["a", "b"]


@pytest.mark.parametrize("on", ["profiler", "recording"])
def test_probe_raises_nothing_with_spans_on(record, on):
    env = closed_loop()
    block = profile(activities=[ProfilerActivity.CPU]) if on == "profiler" \
        else profiling.recording()
    with block:
        rewards = env.run_with_reward(20)
    assert env.last_build_fused and rewards.shape == (20,)
    probes = [s for s in profiling.record() if s.name == "loop.probe"]
    assert len(probes) == 1


def test_build_compile_span(record, monkeypatch, tmp_path):
    from spiking_neural_networks_tpu_torch import _build
    monkeypatch.setattr(_build, "GENERATED_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_compile_generated", lambda todo: None)
    with profiling.recording():
        _build.build_generated(["// a source"])
    assert [s.name for s in profiling.record()] == ["build.compile"]


def _waits_per_run(run):
    with profiling.recording():
        run()
    spans = profiling.record()
    calls = {s.call for s in spans if s.parent is None}
    waits = collections.Counter(s.name for s in spans
                                if s.name.startswith("wait."))
    return len(calls), dict(waits)


def test_waits_per_run_persistent_route(record):
    # 8 x 8: the stencil kernel's persistent route, no uniform check
    assert _waits_per_run(lambda: lattice().run_lattice(40)) \
        == (1, {"wait.nt_mask": 1})


def test_waits_per_run_tiled_route(record):
    # 400 x 400 at radius 4: past the persistent plan, the tiled route
    lat = lattice(n=400, radius=4.0)
    assert _waits_per_run(lambda: lat.run_lattice(1)) \
        == (1, {"wait.nt_mask": 1, "wait.uniform_scalars": 1})


def test_waits_per_run_reward(record):
    lat = lattice(snt.RewardModulatedLattice)
    assert _waits_per_run(lambda: lat.run_lattice_with_reward(0.5, 40)) \
        == (1, {"wait.nt_mask": 1, "wait.dopamine": 1})


def test_waits_per_run_closed_loop(record):
    env = closed_loop()
    env.run_with_reward(20)                   # the probe's call
    assert _waits_per_run(lambda: env.run_with_reward(20)) \
        == (1, {"wait.nt_mask": 1, "wait.loop_pull": 1})


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA graph's capture has no "
                    "CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("on", ["profiler", "recording"])
def test_capture_raises_nothing_with_spans_on(record, on):
    """The closed loop's first call on the card probes and captures its
    CUDA graph with spans on, then replays it."""
    _needs_cuda()
    env = closed_loop("cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    block = profile(activities=acts) if on == "profiler" \
        else profiling.recording()
    with block:
        rewards = env.run_with_reward(40)
        torch.cuda.synchronize()
    assert env.last_build_env_fused and env.last_capture_error is None
    assert rewards.shape == (40,)
    names = collections.Counter(s.name for s in profiling.record())
    assert names["loop.probe"] == 1 and names["loop.capture"] == 1
    assert names["loop.replay"] == 2
    # 1 probe step, 16 captured, 8 eager
    assert names["loop.step"] == 1 + 16 + 8
