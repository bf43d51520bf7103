"""The frozen count functions against the bounds that PERF.md section 6
records for the cells' shapes (µs per step, one call per 16 steps), with
the neuron parameters read as scalars, and each traffic kind's count."""

import pytest

from snnbench import catalog, counts, inputs

R2 = inputs.radius_offsets(2.0)


def per_step_us(least):
    return 1e6 * least / counts.CALL_STEPS


@pytest.mark.parametrize("shape,want", [((512, 512), 0.377),
                                        ((2048, 2048), 6.025)])
def test_stencil_bound(shape, want):
    """PERF.md section 6's 0.553 and 8.842 charged a plane of each of the
    9 uniform parameters (36 of 113 bytes a neuron a call); read as the
    configuration's scalars they leave 77 bytes a neuron."""
    least = counts.stencil_call_least(*shape, R2)
    assert round(per_step_us(least), 3) == want
    n = shape[0] * shape[1]
    assert counts.stencil_call_bytes(*shape, len(R2)) == 77 * n + 36
    # bound by the bytes, not the operations
    assert counts.stencil_call_bytes(*shape, len(R2)) / counts.PEAK_BYTES \
        > counts.stencil_ops(R2, *shape) / counts.PEAK_OPS


def test_rstdp_bound():
    """Section 6's 2.255, with the parameters as scalars (425 of its 461
    bytes a neuron a call)."""
    # every edge of the radius-2 stencil kept (the R-STDP configuration)
    slots = counts.ingrid_slots(R2, 512, 512)
    least = counts.lp_call_least(512, 512, R2, slots)
    assert round(per_step_us(least), 3) == 2.079


def test_one_rule_for_the_loop():
    """The closed loop's kernel is held to the same per-call rule: a call
    of 16 steps reads and writes each plane once."""
    slots = counts.ingrid_slots(R2, 10, 10)
    assert counts.lp_call_bytes(10, 10, len(R2)) == 425 * 100 + 8 + 36
    assert per_step_us(counts.lp_call_least(10, 10, R2, slots)) < 0.0123


@pytest.mark.parametrize("kind,least", [
    ("lattice_run", lambda g: counts.stencil_call_least(*g.shape, g.offsets)),
    ("reward_run", lambda g: counts.lp_call_least(*g.shape, g.offsets,
                                                  g.masked_slots)),
    ("closed_loop", lambda g: counts.lp_call_least(*g.shape, g.offsets,
                                                   g.masked_slots))])
def test_kinds_count_their_kernel(kind, least):
    cat = catalog.Catalog()
    cfg = cat.config("izh_rstdp")
    mix = {"rows": 10, "cols": 12, "v0": [-65.0, 30.0]}
    graph, _ = cat.module("traffic/kinds", kind).inputs(cfg, mix, 5, "cpu")
    assert cat.module("traffic/kinds", kind).call_least(cfg, mix, graph) \
        == least(graph)


def test_radius_offsets_row_major():
    assert R2 == ((-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1),
                  (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0))
