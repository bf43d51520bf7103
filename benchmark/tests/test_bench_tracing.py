"""Reading a profiled slice's Chrome trace: busy intervals, kernels by
name, idle gaps named by the host span they fall in."""

from snnbench import tracing


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    ev("user_annotation", "request", 0.0, 100.0),
    ev("user_annotation", "run", 10.0, 60.0),
    ev("user_annotation", "readout", 70.0, 30.0),
    ev("kernel", "void lp_step_kernel<0, 2, true, true>(LpStep)", 20.0, 20.0),
    ev("kernel", "void lp_step_kernel<0, 2, true, true>(LpStep)", 30.0, 20.0),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 80.0, 5.0),
    ev("cpu_op", "aten::add", 0.0, 5.0),
]


def test_device_reading():
    device, spans = tracing.events_of(EVENTS)
    kernels, busy, ops = tracing.device_reading(device)
    assert [k for k, _ in kernels] == [EVENTS[3]["name"]] * 2
    assert abs(busy - 35e-6) < 1e-12          # [20, 50] and [80, 85]
    assert ops[0][0] == "lp_step_kernel<0, 2, true, true>"
    assert abs(ops[0][1] - 40e-6) < 1e-12


def test_idle_gaps_by_host_span():
    gaps = dict(tracing.idle_gaps(*tracing.events_of(EVENTS)))
    # idle [0, 20] from request (0-10) then run; [50, 80] starts in run;
    # [85, 100] in readout
    assert abs(gaps["request"] - 20e-6) < 1e-12
    assert abs(gaps["request/run"] - 30e-6) < 1e-12
    assert abs(gaps["request/readout"] - 15e-6) < 1e-12


def test_short_names():
    assert tracing.short("void izh_tiled_kernel<4>(TileP)") \
        == "izh_tiled_kernel<4>"
    assert tracing.short("void at::native::(anonymous namespace)::cat<4>"
                         "(int, float*)") \
        == "at::native::(anonymous namespace)::cat<4>"
    assert tracing.short("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert len(tracing.short("x" * 500)) == tracing.NAME_CHARS
