"""Traffic kind ``reward_run``: ``RewardModulatedLattice.run_lattice_with_
reward(reward, steps)`` trials at the mix's ``rows`` x ``cols`` and
``reward``, each from its own initial voltages (uniform in the mix's
``v0``), the weights and R-STDP traces as the benchmark's graph and zero
traces give them; readout the dopamine, the summed weight and the neurons
that fired.  The reference's ``reward_run`` recomputes a trial; a call's
least time is the R-STDP step's count."""

from snnbench import counts, inputs as _inputs, requests

Runner = requests.RewardRun
inputs = _inputs.lattice_inputs


def call_least(cfg, traffic, graph):
    """Least seconds of one `counts.CALL_STEPS`-step call."""
    return counts.lp_call_least(*graph.shape, graph.offsets,
                                graph.masked_slots)
