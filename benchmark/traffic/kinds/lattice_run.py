"""Traffic kind ``lattice_run``: ``run_lattice(steps)`` trials of the
configuration's lattice at the mix's ``rows`` x ``cols``, each from its own
initial voltages (uniform in the mix's ``v0``); readout the neurons that
fired and the mean voltage.  The reference's ``lattice_run`` recomputes a
trial; a call's least time is the stencil step's count."""

from snnbench import counts, inputs as _inputs, requests

Runner = requests.LatticeRun
inputs = _inputs.lattice_inputs


def call_least(cfg, traffic, graph):
    """Least seconds of one `counts.CALL_STEPS`-step call."""
    return counts.stencil_call_least(*graph.shape, graph.offsets)
