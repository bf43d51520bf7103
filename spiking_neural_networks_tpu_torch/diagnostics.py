"""Why does (or doesn't) a lattice take a CUDA kernel route?

PyTorch counterpart of ``spiking_neural_networks_tpu/diagnostics.py``.  A
lattice takes a kernel route by an automatic decision spread over the
gates of ``ops/`` (`stencil_kernels.supports`, `model_kernels.
supports_model`, `dsl_kernels.reject_reason`, `hh_kernels.supports`,
`reward_kernels.plain_stdp_lattice_spec` and `supports_lattice`), and
after a run the only signal is ``lat._last_run_fused``.  This module says
why beforehand:

    >>> import spiking_neural_networks_tpu_torch as snt
    >>> snt.why_not_fused(lat)
    ['plasticity BCM: only STDP has a kernel ...']

The verdict comes from the code that routes: `Lattice._kernel_route` and
`RewardModulatedLattice._kernel_route`, asked as if the state were on the
card.  It is ``[]`` exactly when a run on the card would take a kernel
route (``use_kernel`` None or True); otherwise the checklist below names
each blocking condition in the port's own limits, and when a gate declines
for a condition not on the checklist the last reason names the gate to
read.  Sharded lattices do not exist in the port yet.
"""

from __future__ import annotations

import copy


def _graph_reasons(lat, max_offsets, reasons):
    from .ops.graph import StencilGraph
    g = lat.graph
    if not isinstance(g, StencilGraph):
        reasons.append(
            f"connectivity is a {type(g).__name__}, not a StencilGraph: the "
            "lattice kernels are stencil programs (connect() decomposes a "
            "narrow offset support into one; dense and sparse graphs stay "
            "on the plain route)")
    elif len(g.offsets) > max_offsets:
        reasons.append(
            f"{len(g.offsets)} stencil offsets, more than the kernels' "
            f"{max_offsets} (MAX_OFFSETS)")
    elif g.shape != (lat.rows, lat.cols):
        reasons.append(f"the stencil's shape {g.shape} is not the lattice's "
                       f"{(lat.rows, lat.cols)}")


def _history_names(lat):
    return " and ".join(
        name for name, on in (("grid", lat.update_grid_history),
                              ("graph (weight)", lat.update_graph_history))
        if on)


def _reward_reasons(lat):
    from .core.plasticity import RewardModulatedSTDP
    from .ops import reward_kernels
    reasons = []
    if lat.__dict__.get("_shard") is not None:
        reasons.append("sharded: a reward lattice's blocks take the plain "
                       "step (`reward_lattice_step`), as the JAX package "
                       "keeps sharded reward lattices on XLA")
    if lat.update_grid_history or lat.update_graph_history:
        reasons.append(f"{_history_names(lat)} history recording: the "
                       "reward lattice's kernel route keeps no history")
    if reward_kernels.model_kind(lat.model) is None:
        reasons.append(
            f"model {type(lat.model).__name__} is outside the plasticity "
            "kernel's models (Izhikevich, DopaIzhikevich, ALIF, LIF)")
    if lat.chemical_synapse or not lat.electrical_synapse:
        reasons.append("the reward kernel takes electrical synapses only")
    _graph_reasons(lat, reward_kernels.MAX_OFFSETS, reasons)
    if type(lat.reward_modulator) is not RewardModulatedSTDP:
        reasons.append("custom reward modulator (only RewardModulatedSTDP "
                       "has a kernel)")
    if bool(lat.state["nt$mask"].any()):
        reasons.append("neurotransmitters inserted (chemical release has "
                       "no reward-kernel form)")
    if not reasons:
        reasons.append("declined by ops/reward_kernels.supports_lattice for "
                       "a condition not on this checklist")
    return reasons


def _hh_reasons(lat, reasons):
    from .core.plasticity import STDP
    from .ops import hh_kernels
    from .ops.receptors import IonotropicReceptors
    m = lat.model
    if hh_kernels.supports(m, lat.graph, lat.chemical_synapse,
                           lat.do_plasticity, lat.plasticity):
        reasons.append(f"{_history_names(lat)} history recording: the HH "
                       "kernel keeps no history")
        return
    if not lat.chemical_synapse:
        reasons.append("electrical HodgkinHuxley has no kernel: the HH "
                       "kernel needs chemical_synapse = True")
    if type(m.receptors) is not IonotropicReceptors:
        reasons.append(f"receptors {type(m.receptors).__name__}: the HH "
                       "kernel takes IonotropicReceptors")
    elif m.receptors.kinetics != m.rec_kinetics:
        reasons.append("the receptors' kinetics are not the model's "
                       "rec_kinetics")
    for name, kin in (("nt_kinetics", m.nt_kinetics),
                      ("rec_kinetics", m.rec_kinetics)):
        if kin not in hh_kernels.KINETICS:
            reasons.append(f"{name} {kin!r}: the HH kernel takes "
                           f"{' or '.join(hh_kernels.KINETICS)}")
    _graph_reasons(lat, hh_kernels.MAX_OFFSETS, reasons)
    if lat.do_plasticity and type(lat.plasticity) is not STDP:
        reasons.append(f"plasticity {type(lat.plasticity).__name__}: the HH "
                       "kernel takes STDP only")
    if not reasons:
        reasons.append("declined by ops/hh_kernels.supports for a condition "
                       "not on this checklist")


def _stdp_reasons(lat, reasons):
    from .core.plasticity import STDP
    from .ops import reward_kernels
    if lat.update_graph_history:
        reasons.append("graph (weight) history recording has no kernel form "
                       "with plasticity")
    if type(lat.plasticity) is not STDP:
        reasons.append(
            f"plasticity {type(lat.plasticity).__name__}: only STDP has a "
            "kernel (ops/reward_kernels.plain_stdp_lattice_spec); "
            f"{type(lat.plasticity).__name__} runs on the plain route")
        return
    mk = reward_kernels.model_kind(lat.model)
    if mk is None:
        reasons.append(
            f"model {type(lat.model).__name__} is outside the plasticity "
            "kernel's models (Izhikevich, DopaIzhikevich, ALIF, LIF)")
    if lat.chemical_synapse or not lat.electrical_synapse:
        reasons.append("the plasticity kernel takes electrical synapses "
                       "only")
    _graph_reasons(lat, reward_kernels.MAX_OFFSETS, reasons)
    if lat.update_grid_history and mk not in (None, "izhikevich"):
        reasons.append("a grid history on the plasticity kernel is emitted "
                       "for Izhikevich only")
    if not reasons:
        reasons.append("declined by ops/reward_kernels."
                       "plain_stdp_lattice_spec for a condition not on this "
                       "checklist")


def _model_reasons(lat, reasons):
    from .models.integrate_and_fire import Izhikevich
    from .ops import dsl_kernels, model_kernels, stencil_kernels
    m = lat.model
    if model_kernels.supports_model(m, lat.graph, lat.electrical_synapse,
                                    lat.chemical_synapse, lat.do_plasticity):
        reasons.append(f"{_history_names(lat)} history recording: the model "
                       "kernel emits none (only the Izhikevich stencil "
                       "kernel records a grid history)")
        return
    if dsl_kernels.is_generated(m):
        why = dsl_kernels.reject_reason(m)
        if why is not None:
            reasons.append(f"DSL neuron {type(m).__name__}: the kernel "
                           f"emitter does not take it ({why}; at most "
                           f"{dsl_kernels.MAX_FIELDS} fields of one type)")
    elif type(m) is not Izhikevich and type(m) not in model_kernels._TABLE:
        reasons.append(f"model {type(m).__name__} has no kernel (the model "
                       "kernel's table: ops/model_kernels; HodgkinHuxley "
                       "only with chemical synapses, ops/hh_kernels)")
    if not getattr(m, "ELEMENTWISE_STEP", False):
        reasons.append(f"model {type(m).__name__}'s step is not elementwise")
    if lat.chemical_synapse:
        reasons.append("chemical synapses: only the HH kernel takes them")
    elif not lat.electrical_synapse:
        reasons.append("no electrical synapse: nothing for a kernel to "
                       "gather")
    _graph_reasons(lat, min(stencil_kernels.MAX_OFFSETS,
                            model_kernels.MAX_OFFSETS), reasons)
    if not reasons:
        reasons.append("declined by ops/stencil_kernels.supports and "
                       "ops/model_kernels.supports_model for a condition "
                       "not on this checklist")


def _sharded_reasons(lat, sharded):
    """Why a sharded `Lattice` misses the sharded stencil kernel route
    (`parallel.lattice_sharding.LatticeShards.kernel_config`)."""
    from .ops import stencil_kernels
    if sharded.kernel_config(_as_auto(lat), sharded.skip_nt(lat),
                             on_card=True) is not None:
        return []
    if not stencil_kernels.supports(lat.model, lat.graph,
                                    lat.electrical_synapse,
                                    lat.chemical_synapse, lat.do_plasticity) \
            or not sharded.skip_nt(lat):
        return ["sharded: only the electrical Izhikevich stencil lattice "
                "(no plasticity, no neurotransmitter) runs the stencil "
                "kernel per row block; the others take the plain step per "
                "block"]
    if lat._history_items() or lat.update_graph_history:
        return ["sharded: the per-block kernel route keeps no history"]
    return ["sharded: the stencil reaches past one block's rows (K = 1 "
            "needs halo <= rows per block)"]


def _as_auto(lat):
    """``lat`` with ``use_kernel=None`` (a shallow copy when it is
    False): the route its gates give on the card."""
    if lat.use_kernel is not False:
        return lat
    probe = copy.copy(lat)
    probe.use_kernel = None
    return probe


def why_not_fused(lat):
    """Reasons a run of ``lat`` on the card would not take a kernel route.

    Accepts a ``Lattice`` or ``RewardModulatedLattice``.  Returns a list
    of strings, empty when a kernel route applies (a run on the card with
    ``use_kernel`` None or True, or on the CPU with True, would set
    ``_last_run_fused``); ``use_kernel=False`` is a reason of its own,
    followed by those of the gates."""
    from .core.lattice import Lattice
    from .core.reward import RewardModulatedLattice
    from .models.hodgkin_huxley import HodgkinHuxley

    off = ["use_kernel=False asks for the plain route"] \
        if getattr(lat, "use_kernel", None) is False else []
    if isinstance(lat, RewardModulatedLattice):
        if _as_auto(lat)._kernel_route(
                lat.update_grid_history or lat.update_graph_history,
                on_card=True):
            return off
        return off + _reward_reasons(lat)
    if not isinstance(lat, Lattice):
        raise TypeError(f"why_not_fused: unsupported type {type(lat)!r}; "
                        "pass a Lattice or RewardModulatedLattice (for "
                        "networks, check net._last_run_fused after a run)")
    if not lat.electrical_synapse and not lat.chemical_synapse:
        return ["no electrical and no chemical synapse: a run does nothing"]
    sharded = lat.__dict__.get("_shard")
    if sharded is not None:
        return off + _sharded_reasons(lat, sharded)
    skip_nt = not bool(lat.state["nt$mask"].any())
    if _as_auto(lat)._kernel_route(skip_nt, on_card=True) is not None:
        return off
    reasons = []
    if type(lat.model) is HodgkinHuxley:
        _hh_reasons(lat, reasons)
    elif not skip_nt:
        reasons.append("neurotransmitters inserted: only the HodgkinHuxley "
                       "chemical lattice has a kernel (ops/hh_kernels)")
    elif lat.do_plasticity:
        _stdp_reasons(lat, reasons)
    else:
        _model_reasons(lat, reasons)
    return off + reasons
