"""The network kernels: gates, spec, wrapper, plain twin and runner.

PyTorch/CUDA counterpart of the network forms of
``spiking_neural_networks_tpu/ops/pallas_reward.py`` (`_fused_chunk`, body
`_make_kernel`, built by `plain_network_runner` and, for reward networks,
`network_runner`), grid mode and flat mode:
K steps of a `LatticeNetwork` of Izhikevich, ALIF or LIF lattices with
Poisson or Rate spike trains, either on stencil (or edgeless) graphs, of
mixed grid shapes, with one-to-one or resample (pooling, upsampling,
shifted) connections (grid mode), or on dense (or edgeless) graphs with
one-to-one connections and dense blocks, every member a (1, N) row (flat
mode, below).
Each step runs, in this order,

1. phase A of every lattice from the previous step's state: the intra
   stencil sum ``acc - v * wsum``, then each incoming connection in plan
   order (one-to-one ``mask * w * (v_pre - v)``, or ``mask * w * effect``
   from a train; resample taps ``w_t * (a_t - sub_t * v)`` summed in tap
   order into their own accumulator), then ``gap * total / cnt`` with
   ``cnt = max(in_deg + sum of connection masks, 1)``; train effects from
   the trains' previous firing times, in the association
   ``decay * tdiff * tdiff``;
2. phase B, the model step of `reward_kernels.model_step`, and
   ``lft = clock0 + k`` on a spike;
3. STDP on every plastic lattice's stencil weights;
4. STDP on the weights of every connection with a plastic endpoint,
   ``w += delta * (pre_plastic * spk_pre + post_plastic * spk_post)``;
5. the trains step: Poisson ``u <= chance`` from the call's uniforms,
   Rate ``step + dt >= rate``; ``lft = clock0 + k`` on a spike.

The chemical arm (``NetSpec.chem``: a chemical network of Izhikevich or
ALIF lattices, all of one model, with Ionotropic or DopaGluGABA receptors,
any of the JAX kernel's receptor and neurotransmitter kinetics, one-to-one
connections; electrical synapses on or off) adds, per step and lattice,

A'. per neurotransmitter type q, from the previous step's concentrations
    ``t`` and presence masks ``m``: the intra sums ``sum_o w_o (t m)_q``
    and counts ``sum_o mask_o m_q`` at the neighbours, re-expanded as
    ``(sums / max(cnt, 1)) * max(cnt, 1) * (cnt > 0)``, plus each incoming
    connection's ``(w t) m`` and ``m`` where its mask holds (trains with
    neurotransmitters only); ``t_in = sums / max(cnts, 1)``, valid where
    ``cnts > 0``;
B'. the receptor kinetics on valid, inserted slots and the currents at
    the pre-update v (Ionotropic: ``g r (v - e)``, the NMDA block at 3.75;
    DopaGluGABA: the glutamate and GABA currents with the block at 3.57,
    ``nmda_r ** nmda_mod`` by `kernel_pow`, from the previous step's
    modifiers, which the dopamine slot then rewrites), ``v_pre = v + dv -
    sum(I) * (dt / c_m)``, and the neurotransmitter release from
    ``v_pre`` and the previous step's spike flag;

and each train with a neurotransmitter inserted releases after its new
spike, from ``v_th`` or ``v_resting``.

Flat mode (the JAX kernel's (1, N) row layout): a network with a
`DenseGraph` intra graph (Hopfield-style ``connect``) or a dense
connection block, every lattice, train and block side of N <=
`DENSE_N_MAX`, no stencil graph, no resample connection and no plastic
lattice.  Every lattice and train is a (1, N) row; one-to-one connections
stay elementwise.  Per destination j a dense gather is a sum over the
sources i in a fixed order (`_seg_dot`): `DENSE_SEG` = 32 partial sums, the
k-th over the sources i = k, k + 32, k + 64, ... in that order, each term a
multiply then an add, and then the partial sums added from 0 in the order
of k:

* electrical intra: ``Wm = where(mask, W, 0)``, ``wa = sum_i v_i Wm_ij``,
  ``wsub = sum_i Wm_ij``, ``d = max(in_deg_j, 1)``, ``total = (wa - v_j
  wsub) / d * d``;
* electrical dense block: ``total += sum_i a_i cw_ij - v_j sum_i sub_i
  cw_ij`` with ``a`` the source lattice's previous v (``sub`` ones) or the
  train's effect (``sub`` zeros);
* the count adds a dense block's mask column sums;
* chemical intra, per type q: ``sums_q = sum_i (t m)_iq Wm_ij``, ``gcnt_q =
  sum_i m_iq mask_ij``, re-expanded as for a stencil;
* chemical dense block: ``csum_q += sum_i (t m)_iq cw_ij``, ``ccnt_q +=
  sum_i m_iq cmask_ij``.

The JAX kernel takes these sums as matrix products on the MXU; the order
above is this port's contract between the CUDA kernels
(`net_dense_gather_kernel`: one thread per destination and partial sum)
and the twin, which therefore loops over the sources and never calls a
matrix product.  What no step changes (flat mode has no plasticity: the
weights' column sums and the counts) is taken once per call.

The reward arm (`reward_network_spec`: a `RewardModulatedLatticeNetwork`
of one grid shape, electrical, one-to-one connections) adds, per step:
the dopamine ``dop * exp_dd + tau_d * reward_k`` before the visits (with
rewards); to the connections' STDP count a ``static`` term, the endpoints
that are modulated lattices against plain ones; after the STDP, the
R-STDP double visit of every ``mod`` lattice's masked stencil slots, and
on each reward connection's masked slots one R-STDP visit where its count
``static + pre_plastic * spk_pre + post_plastic * spk_post`` is >= 1 and a
second where it is >= 2; the trains last.  The R-STDP deltas take the
reward rule's parameters, the STDP ones the lattices' rule.

On a GPU these are hand-written CUDA kernels.  Specs of `uses_persistent`
take the persistent kernel, ``csrc/network_persistent.cu``: one cooperative
launch per call of up to 16 steps, step k-1's edge passes fused into step
k's cell phase, and what only a cell's owner reads (weights, masks,
traces, a chemical cell's parameters and gating state, a flat tile's dense
weight columns) held in shared memory where `persistent_plan` fits it; an
instantiation for grid-mode electrical and reward networks, one for the
chemical arm, and two for flat mode.  A chemical spec whose plan streams a
member, and specs of more members than the persistent kernel's
description holds, take the per-step launches of
``csrc/network_plasticity.cu`` (with the intra STDP kernel of
``csrc/lattice_plasticity.cu`` and the chemical device code of
``csrc/chem_common.cuh``); the other specs reach them only through
``network_steps(..., per_step=True)``.  `network_steps` launches them for
CUDA tensors and runs the plain twin `network_steps_reference` for CPU
tensors.  A build or launch failure raises; nothing falls back.  The
Poisson uniforms of a call are drawn on the device with ``torch.rand``
from the network's generator: input data, as the TPU kernel's per-chunk
draw is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.history import rebuilt_readouts
from ..core.plasticity import (STDP, kernel_exp, kernel_pow, rstdp_visit,
                               rule_floats, rule_tensors, stdp_delta)
from ..core.structured import _resample_planes
from ..models.base import NEVER
from ..models.spike_train import PoissonSpikeTrain, RateSpikeTrain
from .graph import DenseGraph, SparseGraph, StencilGraph
from .kinetics import NT_PARAM_KEYS, REC_KIN_KEYS, nt_release, rec_kinetics
from .receptors import DopaGluGABAReceptors, IonotropicReceptors
from .reward_kernels import (KINDS, MAX_OFFSETS, MODEL_PARAM_KEYS, MODELS,
                             REFRACTORY_MODELS, STDP_KEYS, model_kind,
                             model_step, shifted)

MAX_IN = 8                # NET_MAX_IN: incoming connections per lattice
MAX_TAPS = 64             # NET_MAX_TAPS (= core.structured.ResampleBlock)
DENSE_N_MAX = 512         # NET_DENSE_MAX: a flat-mode lattice, train or
                          # dense block side (the JAX kernel's coverage)
DENSE_SEG = 32            # NET_DENSE_SEG: partial sums of a dense gather
CONN_KINDS = ("one2one", "resample", "dense")   # the CUDA source's ids
STEPS_PER_LAUNCH = 16     # K of the runner's kernel calls
TRAIN_KINDS = ("poisson", "rate")
REFRACTORINESS = ("delta_dirac", "exponential_decay")
# the chemical arm's families and kinetics, in the CUDA source's id order
CHEM_FAMILIES = ("ionotropic", "dopaglugaba")
NT_KINDS = ("approximate", "bounded", "discrete", "exponential_decay",
            "destexhe")
REC_KINDS = ("approximate", "bounded", "destexhe", "exponential_decay")
# DopaGluGABA's per-neuron (N,) current and modulation planes
DOPA_PLANES = ("rec$g_ampa", "rec$g_nmda", "rec$e_ampa", "rec$e_nmda",
               "rec$mg", "rec$g_gaba", "rec$e_gaba", "rec$s_d1", "rec$s_d2")
N_TYPES = 3
# fixed strides of the flat per-lattice/train/connection descriptions the
# C entry point reads (the NL_/NT_/NC_/NLC_/NTC_ defines of the CUDA
# source)
NL_I, NL_P = 8 + 2 * MAX_OFFSETS, 36
NT_I, NT_P = 5, 10
NC_I, NC_P = 13, 7
NLC_P, NTC_P = 32, 8
RSTDP_KEYS = STDP_KEYS + ("tau_c", "exp_dc", "tau_d", "exp_dd")
# the persistent kernel (csrc/network_persistent.cu): members it takes,
# the strides of its flat descriptions, its block sizes (the electrical
# grid instantiation; the chemical and flat ones), flat mode's scratch in
# a block's shared memory, and the shared memory of a block on an H100
# (227 KB) for resident members, less 16 KB for the copy of the kernel's
# description (15.2 KB) and its static use
NP_MAX_LAT, NP_MAX_TR, NP_MAX_CN = 8, 8, 16
PL_I, PL_P = 17 + 2 * MAX_OFFSETS, 70
PT_I, PT_P = 5, 21
PC_I, PC_P = 16 + 2 * MAX_TAPS, 9
NP_THREADS, NP_THREADS_CHEM = 640, 512
NP_FLAT_SCRATCH = 4 * (4 * DENSE_N_MAX + 4 * DENSE_SEG * 32
                       + 2 * (1 + MAX_IN) * 4 * 32)
SMEM_BUDGET = 232448 - 16384

# Calls of `network_steps` that launched the CUDA kernels, of those the
# calls of a chemical network, the calls in flat mode, the calls of the
# reward arm and the calls that took the persistent kernel.
LAUNCHES = 0
CHEM_LAUNCHES = 0
FLAT_LAUNCHES = 0
REWARD_LAUNCHES = 0
PERSISTENT_LAUNCHES = 0


def is_flat(spec):
    """Whether ``spec`` holds a dense graph or a dense block: flat mode."""
    return any(ls.graph == "dense" for ls in spec.lattices) \
        or any(cs.op[0] == "dense" for cs in spec.conns)


def uses_persistent(spec, n_blocks=132):
    """Whether `network_steps` takes the persistent kernel for ``spec`` on
    a card of ``n_blocks`` persistent blocks (one per SM): a network of at
    most `NP_MAX_LAT` lattices, `NP_MAX_TR` trains and `NP_MAX_CN`
    connections (the kernel's description is a kernel parameter of fixed
    size); in flat mode with no more lattice tiles of 32 than blocks (each
    block holds one tile's dense weight columns); a grid-mode chemical
    network only where its residency plan (`persistent_plan` at
    `SMEM_BUDGET`) holds every member in shared memory.  That last rule is
    measured (PERF.md section 6): where a chemical member streams,
    each thread walks its cells' chains of global loads on 16 warps an SM
    and the persistent kernel lost to the per-step design's full
    occupancy (2 x 512^2: 157.6 against 98.1 us a step of device time on
    an H100, the designs in turns), and where all is resident it won (2 x
    64^2: 11.4 against 20.6).  Other specs take the per-step launches of
    ``net_steps``."""
    if len(spec.lattices) > NP_MAX_LAT or len(spec.trains) > NP_MAX_TR \
            or len(spec.conns) > NP_MAX_CN:
        return False
    if is_flat(spec):
        return sum(-(-(ls.shape[0] * ls.shape[1]) // 32)
                   for ls in spec.lattices) <= n_blocks
    if spec.chem:
        members, _ = persistent_plan(spec, n_blocks, SMEM_BUDGET)
        return all(m.resident for m in members)
    return True


class Resident(NamedTuple):
    """One member of a persistent call's residency plan."""
    key: tuple                 # ("lat", i): lattice i's stencil or dense
                               # graph; ("chemp", i), ("chems", i): its
                               # chemical parameters, state; ("conn", ci)
    resident: bool             # held in shared memory for the whole call
    offset: int                # its bytes' offset in a block's shared
                               # memory (resident members)
    cap: int                   # 32-cell tiles a block owns at most
    cell_bytes: int            # bytes per cell: weights, traces, masks,
                               # chemical fields, dense weight columns
    cells: int


def chem_param_planes(chem):
    """Float planes per cell of the chemical parameters only a cell's
    owner reads: the NT parameters, the receptor kinetics (DopaGluGABA:
    twice) and the current parameters, (N, 3) each but DopaGluGABA's (N,)
    `DOPA_PLANES`; the receptor mask adds 3 bytes."""
    fam, rec, nt = chem
    planes = 3 * len(NT_PARAM_KEYS[nt]) + 3 * len(REC_KIN_KEYS[rec])
    if fam == "dopaglugaba":
        return planes + 3 * len(REC_KIN_KEYS[rec]) + len(DOPA_PLANES)
    return planes + 3 * 3


def chem_state_planes(chem):
    """Float planes per cell of the gating state the steps update in
    place: r (3), and for DopaGluGABA r2 (3) and the two modifiers."""
    return 8 if chem[0] == "dopaglugaba" else 3


def _member_layout(spec):
    """(key, bytes per cell, cells, group) of every member whose data only
    its destination cell reads.  Grid mode (group None): each lattice's
    stencil graph (traces for kind mod; the mask where the steps update it
    or the chemical gather reads it), then each chemical lattice's
    parameters, then each connection (traces for a reward connection; the
    mask where the cell phase or the visits read it), then each chemical
    lattice's state.  Flat mode (group: the lattice whose tile the block
    owns): per lattice its dense graph's weight columns (4 bytes per
    source), its chemical parameters, each incoming connection (a dense
    block's columns, a one-to-one weight and mask), its chemical state."""
    chem = spec.chem
    cp = 4 * chem_param_planes(chem) + 3 if chem else 0
    cs = 4 * chem_state_planes(chem) if chem else 0

    def conn(ci, cs_):
        if cs_.op[0] == "dense":
            pre = spec.trains[cs_.pre] if cs_.pre_is_st \
                else spec.lattices[cs_.pre]
            return 4 * pre.shape[1]
        one = cs_.op[0] == "one2one"
        slots = 1 if one else len(cs_.op[7])
        return slots * (4 + (12 if cs_.reward else 0)
                        + (1 if one or cs_.updates else 0))

    out = []
    if is_flat(spec):
        for k, ls in enumerate(spec.lattices):
            n = ls.shape[1]
            if ls.graph == "dense":
                out.append((("lat", k), 4 * n, n, k))
            if chem:
                out.append((("chemp", k), cp, n, k))
            out += [(("conn", ci), conn(ci, c), n, k)
                    for ci, c in enumerate(spec.conns) if c.post == k]
            if chem:
                out.append((("chems", k), cs, n, k))
        return out
    cells = [ls.shape[0] * ls.shape[1] for ls in spec.lattices]
    for k, ls in enumerate(spec.lattices):
        if ls.offsets:
            out.append((("lat", k), len(ls.offsets) * (
                4 + (12 if ls.kind == "mod" else 0)
                + (1 if ls.kind != "plain" or chem else 0)), cells[k], None))
    if chem:
        out += [(("chemp", k), cp, cells[k], None)
                for k in range(len(spec.lattices))]
    out += [(("conn", ci), conn(ci, c), cells[c.post], None)
            for ci, c in enumerate(spec.conns)]
    if chem:
        out += [(("chems", k), cs, cells[k], None)
                for k in range(len(spec.lattices))]
    return out


@functools.lru_cache(maxsize=64)
def persistent_plan(spec, n_blocks=132, budget=SMEM_BUDGET):
    """The persistent kernel's residency plan for ``spec`` on ``n_blocks``
    blocks (one per SM: the most cells a block can own) with ``budget``
    bytes of shared memory a block: going through the members of
    `_member_layout` in order, each is resident if its block share, cap =
    ceil(ceil(cells / 32) / n_blocks) tiles of 32 cells (1 in flat mode,
    where a block owns one lattice tile) at its bytes per cell, rounded up
    to 16, still fits the budget (in flat mode less `NP_FLAT_SCRATCH`, per
    lattice tile); the others stream from global memory.  Returns
    ``(members, smem)``: a `Resident` per member and the bytes of shared
    memory a block takes.  The CUDA source checks that each resident
    member lies within that memory, apart from the others, and holds the
    tiles a block of its grid owns."""
    flat = is_flat(spec)
    if flat:
        budget = max(budget - NP_FLAT_SCRATCH, 0)
    members, used = [], {}
    for key, per_cell, cells, group in _member_layout(spec):
        cap = 1 if flat else -(-(-(-cells // 32)) // n_blocks)
        share = -(-cap * 32 * per_cell // 16) * 16
        at = used.get(group, 0)
        fits = at + share <= budget
        members.append(Resident(key, fits, at if fits else 0, cap, per_cell,
                                cells))
        used[group] = at + (share if fits else 0)
    return tuple(members), max(used.values(), default=0)


class NetLat(NamedTuple):
    kind: str                  # 'plain' | 'plastic' (STDP) | 'mod' (R-STDP)
    model: str                 # MODEL_PARAM_KEYS key
    shape: tuple               # (rows, cols)
    offsets: tuple             # stencil offsets; () for an edgeless graph
    emit: bool = False         # emit each step's pre-reset v
    graph: str = "stencil"     # 'stencil' | 'dense' | 'none'; 'dense': a
                               # (1, N) row with (N, N) weights and mask


class NetTrain(NamedTuple):
    kind: str                  # 'poisson' | 'rate'
    refractoriness: str        # 'delta_dirac' | 'exponential_decay'
    shape: tuple
    nt: str = ""               # '' or the NT kinetics the train releases
                               # with (chemical networks)


class NetConn(NamedTuple):
    pre_is_st: bool
    pre: int                   # index into lattices, or trains if pre_is_st
    post: int                  # index into lattices
    pre_plastic: bool
    post_plastic: bool
    op: tuple                  # ("one2one",), ("dense",) or ("resample",
                               # R1, C1, R2, C2, fr, fc, taps)
    reward: bool = False       # R-STDP weights and traces (reward arm)
    static: int = 0            # endpoints that visit every step (a
                               # modulated lattice; reward networks)

    @property
    def updates(self):
        return bool(self.pre_plastic or self.post_plastic or self.static
                    or self.reward)


class NetSpec(NamedTuple):
    lattices: tuple            # NetLat, ... in plan order
    trains: tuple              # NetTrain, ...
    conns: tuple               # NetConn, ... (empty connections dropped)
    keep: tuple                # plan index of each conn
    chem: tuple = ()           # () or (family, rec kinetics, nt kinetics)
    electrical: bool = True    # electrical synapses (always, without chem)
    with_reward: bool = False  # the dopamine takes a reward each step


def chem_keys(chem):
    """The state keys a lattice's chemical arm reads, in the kernel's
    order."""
    fam, rec, nt = chem
    keys = ("nt$t", "nt$mask") + NT_PARAM_KEYS[nt] + ("rec$r", "rec$mask") \
        + tuple("rec$" + k for k in REC_KIN_KEYS[rec])
    if fam == "dopaglugaba":
        return keys + ("rec$r2",) \
            + tuple("rec$r2$" + k for k in REC_KIN_KEYS[rec]) \
            + ("rec$inh_modifier", "rec$nmda_modifier") + DOPA_PLANES
    return keys + ("rec$g", "rec$e", "rec$mg")


def chem_out_keys(chem):
    """The state keys a lattice's chemical arm writes."""
    if chem[0] == "dopaglugaba":
        return ("nt$t", "rec$r", "rec$current", "rec$r2",
                "rec$inh_modifier", "rec$nmda_modifier")
    return ("nt$t", "rec$r", "rec$current")


def _chem_shape(chem, key, n):
    """An (N,) plane or an (N, 3) per-type array."""
    planes = DOPA_PLANES + ("rec$inh_modifier", "rec$nmda_modifier")
    return (n,) if chem[0] == "dopaglugaba" and key in planes \
        else (n, N_TYPES)


# ---------------------------------------------------------------------------
# Gate
# ---------------------------------------------------------------------------


def _graph_kind(lat):
    """The kernels' intra-graph class of a lattice: "stencil", "dense" (a
    square `DenseGraph` of at most `DENSE_N_MAX` nodes), "none" (a graph of
    either class without an edge, which both layouts accept), or None
    outside the kernels' class."""
    g = lat.graph
    if isinstance(g, StencilGraph) and g.shape == (lat.rows, lat.cols) \
            and len(g.offsets) <= MAX_OFFSETS:
        return "stencil"
    if isinstance(g, SparseGraph) and g.src.numel() == 0:
        return "none"
    if isinstance(g, DenseGraph) and g.n_pre == g.n_post == lat.n:
        if not g.has_edges:
            return "none"
        if lat.n <= DENSE_N_MAX:
            return "dense"
    return None


def _train_spec(st):
    kind = {PoissonSpikeTrain: "poisson",
            RateSpikeTrain: "rate"}.get(type(st.model))
    if kind is None:
        return None
    return NetTrain(kind, st.model.refractoriness, (st.rows, st.cols))


def _chem_spec(model):
    """(family, receptor kinetics, NT kinetics) of a model whose receptor
    system and kinetics the chemical arm computes, else None."""
    fam = {IonotropicReceptors: "ionotropic",
           DopaGluGABAReceptors: "dopaglugaba"}.get(type(model.receptors))
    rec, nt = model.receptors.kinetics, model.nt_kinetics
    if fam is None or rec not in REC_KINDS or nt not in NT_KINDS:
        return None
    return (fam, rec, nt)


def plain_network_spec(net, plan, skip_nt, st_nt=()):
    """The kernel spec of a plain `LatticeNetwork` and its structured
    ``plan``, or None outside the kernels' class: Izhikevich, ALIF or LIF
    lattices on stencil (<= 64 offsets) or edgeless graphs, Poisson or
    Rate trains, one-to-one and resample connections (<= 64 taps, <= 8
    into any lattice), STDP, and lattice grid histories on Izhikevich
    lattices only (rebuilt from the emitted pre-reset v); with electrical
    synapses only, no neurotransmitter may be inserted (``skip_nt``).  A
    chemical network takes the chemical arm when every lattice has one
    model with a `_chem_spec` and a c_m (so no LIF), and its connections
    are one-to-one or dense (resampled chemical gathers stay on the plain
    route, as in the JAX gate); the trains flagged in ``st_nt`` release
    neurotransmitter with the first train's kinetics.  A `DenseGraph` with
    an edge or a dense connection block puts the network in flat mode,
    every lattice and train a (1, N) row with N <= `DENSE_N_MAX`; a stencil
    graph, a resample connection or a plastic lattice beside one sends the
    network to the plain route.  The TPU gate's 128-column and VMEM limits
    are Mosaic limits and are not copied."""
    lattices = [net.lattices[i] for i in plan["lat_ids"]]
    sts = [net.spike_train_lattices[i] for i in plan["st_ids"]]
    if not lattices or any(s.update_grid_history for s in sts):
        return None
    chem = ()
    if net.chemical_synapse:
        model0 = lattices[0].model
        chem = _chem_spec(model0)
        if chem is None or any(l.model != model0 for l in lattices):
            return None
    elif not (net.electrical_synapse and skip_nt):
        return None
    graphs = [_graph_kind(lat) for lat in lattices]
    conn_kinds = [c["op"].kind[0] if isinstance(c["op"].kind, tuple)
                  else c["op"].kind for c in plan["conns"]]
    flat = "dense" in graphs or "dense" in conn_kinds
    if None in graphs or (flat and (
            "stencil" in graphs or "resample" in conn_kinds
            or any(x.n > DENSE_N_MAX for x in lattices + sts)
            or any(lat.do_plasticity for lat in lattices))):
        return None             # mixed layouts, dense-edge STDP: plain route
    lats = []
    for lat, graph in zip(lattices, graphs):
        mk = model_kind(lat.model)
        if mk is None or lat.update_graph_history \
                or (chem and "c_m" not in MODEL_PARAM_KEYS[mk]):
            return None
        emit = bool(lat.update_grid_history)
        if emit and mk != "izhikevich":
            return None
        lats.append(NetLat("plastic" if lat.do_plasticity else "plain", mk,
                           (1, lat.n) if flat else (lat.rows, lat.cols),
                           lat.graph.offsets if graph == "stencil" else (),
                           emit, graph))
    if any(ls.kind == "plastic" for ls in lats) \
            and type(net._plasticity()) is not STDP:
        return None
    trains = [_train_spec(s) for s in sts]
    if any(ts is None for ts in trains):
        return None
    if flat:
        trains = [ts._replace(shape=(1, s.n)) for ts, s in zip(trains, sts)]
    if chem:
        nt = sts[0].model.nt_kinetics if sts else ""
        if any(st_nt) and nt not in NT_KINDS:
            return None
        trains = [ts._replace(nt=nt) if j < len(st_nt) and st_nt[j] else ts
                  for j, ts in enumerate(trains)]
    lat_index = {i: k for k, i in enumerate(plan["lat_ids"])}
    st_index = {i: k for k, i in enumerate(plan["st_ids"])}
    conns, keep = [], []
    for ci, c in enumerate(plan["conns"]):
        kind = c["op"].kind
        if kind == "empty":
            continue            # zero contribution: dropped from the spec
        pre_is_st = c["pre_is_st"]
        pre = st_index[c["pre"]] if pre_is_st else lat_index[c["pre"]]
        post = lat_index[c["post"]]
        pre_shape = trains[pre].shape if pre_is_st else lats[pre].shape
        if kind == "one2one":
            if pre_shape != lats[post].shape:
                return None
            op = ("one2one",)
        elif kind == "dense":
            if c["op"].w0.shape[0] > DENSE_N_MAX:
                return None
            op = ("dense",)
        elif isinstance(kind, tuple) and len(kind[7]) <= MAX_TAPS \
                and not chem:
            op = kind
        else:
            return None         # padded blocks: plain route
        conns.append(NetConn(pre_is_st, pre, post,
                             not pre_is_st and lats[pre].kind == "plastic",
                             lats[post].kind == "plastic", op))
        keep.append(ci)
    if any(sum(c.post == k for c in conns) > MAX_IN
           for k in range(len(lats))):
        return None
    return NetSpec(tuple(lats), tuple(trains), tuple(conns), tuple(keep),
                   chem, bool(net.electrical_synapse))


def reward_network_spec(net, plan, lat_kind, skip_nt, with_reward):
    """The kernel spec of a `RewardModulatedLatticeNetwork` and its
    structured reward ``plan`` (`core.reward_structured`), or None outside
    the reward arm's class, which is the JAX kernel's: electrical synapses
    only with no neurotransmitter inserted (``skip_nt``); every lattice of
    one shape on a stencil (<= 64 offsets) or edgeless graph, of
    Izhikevich, ALIF or LIF; Poisson or Rate trains of one model and that
    shape; one-to-one plain and reward connections only; `STDP` with
    `RewardModulatedSTDP`.  A reward lattice with ``do_modulation = False``
    (``lat_kind`` "reward") sends the network to the plain route.  The JAX
    gate's 128-column cap is a Mosaic limit and is not copied.  Connection
    ``keep`` indices run over ``plan["conns"] + plan["rconns"]``."""
    from ..core.plasticity import RewardModulatedSTDP
    all_lats = net._neuron_lattices()
    lattices = [all_lats[i] for i in plan["lat_ids"]]
    sts = [net.spike_train_lattices[i] for i in plan["st_ids"]]
    if not lattices or net.chemical_synapse or not net.electrical_synapse \
            or not skip_nt or "reward" in lat_kind \
            or type(net._plasticity()) is not STDP \
            or type(net.reward_modulator) is not RewardModulatedSTDP:
        return None
    shape = (lattices[0].rows, lattices[0].cols)
    lats = []
    for lat, kind in zip(lattices, lat_kind):
        mk, graph = model_kind(lat.model), _graph_kind(lat)
        if mk is None or (lat.rows, lat.cols) != shape \
                or graph not in ("stencil", "none"):
            return None
        lats.append(NetLat(kind, mk, shape, lat.graph.offsets
                           if graph == "stencil" else (), False, graph))
    trains = [_train_spec(s) for s in sts]
    if any(ts is None or ts.shape != shape or s.model != sts[0].model
           for ts, s in zip(trains, sts)):
        return None
    lat_index = {i: k for k, i in enumerate(plan["lat_ids"])}
    st_index = {i: k for k, i in enumerate(plan["st_ids"])}
    conns = []
    for c in plan["conns"] + plan["rconns"]:
        if c["op"].kind != "one2one":
            return None
        pre_is_st = c["pre_is_st"]
        conns.append(NetConn(
            pre_is_st, st_index[c["pre"]] if pre_is_st
            else lat_index[c["pre"]], lat_index[c["post"]],
            c["pre_plastic"], c["post_plastic"], ("one2one",),
            c["reward"], c["static"]))
    if any(sum(c.post == k for c in conns) > MAX_IN
           for k in range(len(lats))):
        return None
    return NetSpec(tuple(lats), tuple(trains), tuple(conns),
                   tuple(range(len(conns))), (), True, bool(with_reward))


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _need(name, t, dtype, shape, dev):
    if t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        got = None if t is None else (t.dtype, tuple(t.shape), t.device)
        raise ValueError(f"{name} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {dev}; got {got}")


def is_reward(spec):
    """Whether ``spec`` needs the reward arm: an R-STDP lattice, a reward
    connection or rewards."""
    return spec.with_reward or any(ls.kind == "mod" for ls in spec.lattices) \
        or any(cs.reward for cs in spec.conns)


def _check(spec, lats, trains, conns, uniforms, clock0, n_steps,
           reward=None):
    if not spec.lattices:
        raise ValueError("a network spec needs at least one lattice")
    if not (len(lats) == len(spec.lattices) and len(trains) == len(spec.trains)
            and len(conns) == len(spec.conns)
            and len(uniforms) == len(spec.trains)):
        raise ValueError("lattices, trains, connections and uniforms must "
                         "match the spec")
    dev = lats[0]["v"].device
    n_steps = int(n_steps)
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if not -2**31 <= int(clock0) <= 2**31 - n_steps:
        raise ValueError(f"clock {clock0} + {n_steps} steps overflows int32")
    f32, i32 = torch.float32, torch.int32
    for k, (ls, d) in enumerate(zip(spec.lattices, lats)):
        if ls.kind not in ("plain", "plastic", "mod") \
                or ls.model not in MODEL_PARAM_KEYS:
            raise ValueError(f"no kernel for lattice kind {ls.kind!r} and "
                             f"model {ls.model!r}")
        if len(ls.offsets) > MAX_OFFSETS:
            raise ValueError(f"the kernel takes at most {MAX_OFFSETS} "
                             f"offsets, got {len(ls.offsets)}")
        if ls.emit and ls.model != "izhikevich":
            raise ValueError("only Izhikevich lattices emit pre-reset v")
        shp, n_off = ls.shape, len(ls.offsets)
        if ls.graph == "dense":
            n = shp[1]
            if shp[0] != 1 or n > DENSE_N_MAX or n_off \
                    or ls.kind != "plain":
                raise ValueError(
                    f"lattice {k}: a dense graph needs a plain (1, N) row "
                    f"with N <= {DENSE_N_MAX} and no offsets, got {ls}")
            _need(f"lattice {k} weights", d["weights"], f32, (n, n), dev)
            _need(f"lattice {k} mask", d["mask"], torch.bool, (n, n), dev)
        missing = [p for p in MODEL_PARAM_KEYS[ls.model]
                   if p not in d["params"]]
        if missing:
            raise KeyError(f"lattice {k}: missing parameter planes {missing}")
        for name in ("v", "w", "in_deg"):
            _need(f"lattice {k} {name}", d[name], f32, shp, dev)
        for p in MODEL_PARAM_KEYS[ls.model]:
            _need(f"lattice {k} {p}", d["params"][p], f32, shp, dev)
        _need(f"lattice {k} lft", d["lft"], i32, shp, dev)
        if ls.model in REFRACTORY_MODELS:
            _need(f"lattice {k} refr", d["refr"], f32, shp, dev)
        if n_off:
            _need(f"lattice {k} weights", d["weights"], f32, (n_off, *shp),
                  dev)
            _need(f"lattice {k} mask", d["mask"], torch.bool, (n_off, *shp),
                  dev)
        if ls.kind == "mod":
            if spec.chem or ls.graph == "dense":
                raise ValueError(f"lattice {k}: R-STDP lattices are "
                                 f"electrical, on stencil or edgeless graphs")
            if n_off:
                _need_traces(f"lattice {k}", d.get("traces") or {},
                             (n_off, *shp), dev)
    for j, (ts, d, u) in enumerate(zip(spec.trains, trains, uniforms)):
        if ts.kind not in TRAIN_KINDS \
                or ts.refractoriness not in REFRACTORINESS:
            raise ValueError(f"no kernel for train {ts.kind!r} "
                             f"{ts.refractoriness!r}")
        _need(f"train {j} lft", d["lft"], i32, ts.shape, dev)
        names = ("v_th", "v_resting", "refr_k", "dt") + (
            ("chance",) if ts.kind == "poisson" else ("rate", "step"))
        for name in names:
            _need(f"train {j} {name}", d[name], f32, ts.shape, dev)
        if ts.kind == "poisson":
            _need(f"train {j} uniforms", u, f32, (n_steps, *ts.shape), dev)
    n_in = [0] * len(spec.lattices)
    for ci, (cs, d) in enumerate(zip(spec.conns, conns)):
        post = spec.lattices[cs.post].shape
        pre = spec.trains[cs.pre].shape if cs.pre_is_st \
            else spec.lattices[cs.pre].shape
        n_in[cs.post] += 1
        if cs.op[0] == "one2one":
            if pre != post:
                raise ValueError(f"connection {ci}: one-to-one needs equal "
                                 f"shapes, got {pre} and {post}")
            shp = post
        elif cs.op[0] == "resample":
            _, R1, C1, R2, C2, fr, fc, taps = cs.op
            if (R1, C1) != tuple(pre) or (R2, C2) != tuple(post) \
                    or not 0 < len(taps) <= MAX_TAPS or not fr or not fc:
                raise ValueError(f"connection {ci}: bad resample op "
                                 f"{cs.op[:7]} for {pre} -> {post}")
            shp = (len(taps), *post)
        elif cs.op[0] == "dense":
            if pre[0] != 1 or post[0] != 1 or pre[1] > DENSE_N_MAX \
                    or cs.updates:
                raise ValueError(
                    f"connection {ci}: a dense block joins (1, N) rows of "
                    f"plain lattices, N_pre <= {DENSE_N_MAX}, got {pre} -> "
                    f"{post}")
            shp = (pre[1], post[1])
        else:
            raise ValueError(f"connection {ci}: no kernel for {cs.op[0]!r}")
        if cs.pre_is_st and cs.pre_plastic:
            raise ValueError("spike trains are never plastic endpoints")
        _need(f"connection {ci} w", d["w"], f32, shp, dev)
        _need(f"connection {ci} mask", d["mask"], torch.bool, shp, dev)
        if cs.reward:
            if cs.op[0] == "dense" or spec.chem:
                raise ValueError(f"connection {ci}: a reward connection is "
                                 f"one-to-one or resample, electrical")
            _need_traces(f"connection {ci}", d, shp, dev)
    if max(n_in) > MAX_IN:
        raise ValueError(f"the kernel takes at most {MAX_IN} connections "
                         f"into a lattice, got {max(n_in)}")
    if is_reward(spec) and reward is None:
        raise ValueError("a spec with R-STDP lattices, reward connections or "
                         "rewards needs the reward arguments")
    if reward is not None:
        _need("dopamine", reward["dopamine"], f32, (), dev)
        missing = [k for k in RSTDP_KEYS[:6] + ("tau_d",)
                   if k not in reward["rule"]]
        if missing:
            raise KeyError(f"the reward rule lacks {missing}")
        if spec.with_reward and len(reward["rewards"]) != n_steps:
            raise ValueError(f"{len(reward['rewards'])} rewards for "
                             f"{n_steps} steps")
    if spec.chem:
        _check_chem(spec, lats, trains, dev)
    elif any(ts.nt for ts in spec.trains) or not spec.electrical:
        raise ValueError("trains release neurotransmitter, and electrical "
                         "synapses are off, only in a chemical spec")


def _need_traces(name, d, shape, dev):
    for key, dtype in (("c", torch.float32), ("dw", torch.float32),
                       ("counter", torch.int32)):
        _need(f"{name} trace {key}", d.get(key), dtype, shape, dev)


def _check_chem(spec, lats, trains, dev):
    fam, rec, nt = spec.chem
    if fam not in CHEM_FAMILIES or rec not in REC_KINDS \
            or nt not in NT_KINDS:
        raise ValueError(f"no chemical arm for {spec.chem}")
    for k, (ls, d) in enumerate(zip(spec.lattices, lats)):
        if "c_m" not in MODEL_PARAM_KEYS[ls.model]:
            raise ValueError(f"the chemical arm needs c_m, which model "
                             f"{ls.model!r} has not")
        n = ls.shape[0] * ls.shape[1]
        _need(f"lattice {k} spikes", d["spikes"], torch.bool, ls.shape, dev)
        for key in chem_keys(spec.chem):
            _need(f"lattice {k} {key}", d["chem"].get(key),
                  torch.bool if key.endswith("mask") else torch.float32,
                  _chem_shape(spec.chem, key, n), dev)
    for j, (ts, d) in enumerate(zip(spec.trains, trains)):
        if not ts.nt:
            continue
        if ts.nt not in NT_KINDS:
            raise ValueError(f"no release for NT kinetics {ts.nt!r}")
        n = ts.shape[0] * ts.shape[1]
        for key in ("nt$t", "nt$mask") + NT_PARAM_KEYS[ts.nt]:
            _need(f"train {j} {key}", d["chem"].get(key),
                  torch.bool if key == "nt$mask" else torch.float32,
                  (n, N_TYPES), dev)
    for ci, cs in enumerate(spec.conns):
        if cs.op[0] == "resample":
            raise ValueError(f"connection {ci}: the chemical arm takes "
                             f"one-to-one and dense connections only")


def _chem_outputs(spec, d, dev):
    """A lattice's chemical buffers: double-buffered concentrations, the
    last step's currents, and copies of the fields the steps update in
    place (each cell only its own)."""
    ntt = d["chem"]["nt$t"]
    out = dict(ntt=torch.empty((2, *ntt.shape), dtype=torch.float32,
                               device=dev),
               cur=torch.empty_like(ntt))
    out.update((k, d["chem"][k].clone()) for k in chem_out_keys(spec.chem)
               if k not in ("nt$t", "rec$current"))
    return out


def _outputs(spec, lats, trains, conns, n_steps, dev):
    """Buffers of a kernel call: double-buffered lattice state, spike
    planes, emits, and copies of what the steps update in place.  A
    chemical spec's spike planes start as the previous step's."""
    outs = []
    for ls, d in zip(spec.lattices, lats):
        shp = ls.shape
        refractory = ls.model in REFRACTORY_MODELS
        outs.append(dict(
            buf=[torch.empty((2, *shp), dtype=torch.float32, device=dev),
                 torch.empty((2, *shp), dtype=torch.float32, device=dev),
                 torch.empty((2, *shp), dtype=torch.int32, device=dev),
                 torch.empty((2, *shp), dtype=torch.float32, device=dev)
                 if refractory else None],
            spikes=d["spikes"].clone() if spec.chem
            else torch.empty(shp, dtype=torch.bool, device=dev),
            cnt=torch.empty(shp, dtype=torch.float32, device=dev),
            v_pre=torch.empty((n_steps, *shp), dtype=torch.float32,
                              device=dev) if ls.emit else None,
            weights=d["weights"].clone() if ls.kind != "plain"
            and ls.offsets else d["weights"],
            traces={k: v.clone() for k, v in d["traces"].items()}
            if ls.kind == "mod" and ls.offsets else None,
            chem=_chem_outputs(spec, d, dev) if spec.chem else None))
    touts = [dict(lft=d["lft"].clone(),
                  step=d["step"].clone() if ts.kind == "rate" else None,
                  spikes=torch.empty(ts.shape, dtype=torch.bool, device=dev),
                  ntt=d["chem"]["nt$t"].clone() if ts.nt else None)
             for ts, d in zip(spec.trains, trains)]
    couts = [d["w"].clone() if cs.updates else d["w"]
             for cs, d in zip(spec.conns, conns)]
    ctraces = [{k: d[k].clone() for k in ("c", "dw", "counter")}
               if cs.reward else None for cs, d in zip(spec.conns, conns)]
    return outs, touts, couts, ctraces


def _dense_scratch(spec, lats, conns, dev):
    """Scratch of the dense sums: per lattice and per connection the
    (8, n_post) buffer of a dense graph's or block's sums (rows 0-3 a
    step's, rows 4-7 the call's constants), and per connection the buffer
    a step writes a train's effects into before a dense block reads them;
    None where there is none."""
    def buf(n):
        return torch.empty((8, n), dtype=torch.float32, device=dev)
    return ([buf(ls.shape[1]) if ls.graph == "dense" else None
             for ls in spec.lattices],
            [buf(c["w"].shape[1]) if cs.op[0] == "dense" else None
             for cs, c in zip(spec.conns, conns)],
            [torch.empty(spec.trains[cs.pre].shape, dtype=torch.float32,
                         device=dev)
             if cs.op[0] == "dense" and cs.pre_is_st else None
             for cs in spec.conns])


def network_steps(spec, lats, trains, conns, uniforms, rule, clock0,
                  n_steps, reward=None, per_step=False):
    """Advance ``n_steps`` steps of the network of ``spec``.

    ``lats`` holds one dict per lattice: ``v``, ``w`` (a zero plane for
    LIF), ``in_deg`` and the ``params`` planes (keys
    ``MODEL_PARAM_KEYS[model]``) as (rows, cols) float32, ``lft`` int32,
    ``refr`` (ALIF and LIF) float32, and ``weights`` / ``mask`` (bool) as
    (n_off, rows, cols) for a stencil graph or (N, N) for a dense graph
    (whose lattice is a (1, N) row); a chemical spec adds
    ``spikes`` (the previous step's, bool (rows, cols)) and ``chem``, the
    state fields of `chem_keys` in the state's (N,) and (N, 3) layouts.
    ``trains`` holds one dict per
    train: ``lft`` int32 and ``v_th``, ``v_resting``, ``refr_k``, ``dt``
    and ``chance`` (Poisson) or ``rate`` and ``step`` (Rate) float32
    planes, and with ``nt`` a ``chem`` dict of ``nt$t``, ``nt$mask`` and
    the NT parameters as (N, 3).
    ``conns`` holds ``w`` and ``mask`` (bool) per connection,
    (rows, cols) one-to-one or (n_taps, rows, cols) resample, on the post
    grid, or (n_pre, n_post) for a dense block.  ``uniforms`` is an
    (n_steps, rows, cols) float32 tensor per Poisson train (None for Rate),
    ``rule`` the STDP parameter dict.

    The reward arm (`is_reward`: a ``mod`` lattice, a reward connection
    or ``spec.with_reward``) takes ``reward``, a dict of ``rule`` (the
    R-STDP parameter dict), ``dopamine`` (a 0-dim float32 tensor) and
    ``rewards`` (a host array of ``n_steps`` floats, read with
    ``spec.with_reward``); a ``mod`` lattice's dict adds ``traces`` ({c,
    dw float32, counter int32} shaped like its weights), a reward
    connection's dict ``c``, ``dw`` and ``counter`` shaped like its
    ``w``.  Per step it moves the dopamine (``dop * exp_dd + tau_d *
    reward_k``, with rewards), runs the R-STDP double visit on every
    ``mod`` lattice's masked slots, counts ``static`` visits on a
    connection, and takes up to two gated R-STDP visits on a reward
    connection's masked slots.

    On a card, a spec of `uses_persistent` takes the persistent kernel
    (counted in `PERSISTENT_LAUNCHES`) with the residency plan of
    `persistent_plan` at `SMEM_BUDGET` bytes of shared memory a block;
    ``per_step=True`` takes the per-step launches instead, to compare the
    two designs.  The results are the same bit for bit.

    Returns ``(lats, trains, conn_ws, extra)``: per lattice a dict of
    ``v``, ``w``, ``lft``, ``refr``, ``spikes`` (the last step's, bool),
    ``weights``, ``v_pre`` ((n_steps, rows, cols) with ``emit``, else
    None), ``traces`` (a ``mod`` lattice's, else None) and ``chem`` (the
    `chem_out_keys` fields, else None); per train ``lft``, ``step``,
    ``spikes`` and ``ntt`` (its ``nt$t`` with ``nt``, else None); the
    connection weights; and ``extra``, None without ``reward``, else a
    dict of ``traces`` (per connection its {c, dw, counter}, None but for
    a reward connection) and ``dopamine`` (after the last step).  The
    inputs are not modified.
    """
    global LAUNCHES, CHEM_LAUNCHES, FLAT_LAUNCHES, REWARD_LAUNCHES, \
        PERSISTENT_LAUNCHES
    _check(spec, lats, trains, conns, uniforms, clock0, n_steps, reward)
    dev = lats[0]["v"].device
    if dev.type == "cpu":
        return network_steps_reference(spec, lats, trains, conns, uniforms,
                                       rule, clock0, n_steps, reward)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    from .. import _build
    lib = _build.load()
    persistent = not per_step and uses_persistent(spec, _sm_count(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if persistent:
            rc, out = _launch_persistent(
                lib, spec, lats, trains, conns, uniforms, rule, clock0,
                n_steps, stream, reward, SMEM_BUDGET)
        else:
            rc, out = _launch(lib, spec, lats, trains, conns, uniforms, rule,
                              clock0, n_steps, stream, reward)
    if rc != 0:
        entry = "net_persistent_steps" if persistent else "net_steps"
        raise RuntimeError(f"{entry} failed with CUDA error {rc} "
                           f"({torch.cuda.get_device_name(dev)})")
    LAUNCHES += 1
    CHEM_LAUNCHES += bool(spec.chem)
    FLAT_LAUNCHES += is_flat(spec)
    REWARD_LAUNCHES += reward is not None
    PERSISTENT_LAUNCHES += persistent
    return out


def _launch(lib, spec, lats, trains, conns, uniforms, rule, clock0, n_steps,
            stream, reward=None):
    """Pack the checked inputs into the flat descriptions of ``net_steps``
    and call it on ``stream``; returns its code and the outputs."""
    dev = lats[0]["v"].device
    n_steps = int(n_steps)
    outs, touts, couts, ctraces = _outputs(spec, lats, trains, conns,
                                           n_steps, dev)
    # device tap lists of the resample connections, (dr, dc) pairs
    taps = [torch.tensor([x for t in cs.op[7] for x in t], dtype=torch.int32,
                         device=dev) if cs.op[0] == "resample" else None
            for cs in spec.conns]
    lat_sums, conn_sums, effects = _dense_scratch(spec, lats, conns, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lat_i = (ctypes.c_int * (NL_I * len(lats)))()
    lat_p = (ctypes.c_void_p * (NL_P * len(lats)))()
    for k, (ls, d, o) in enumerate(zip(spec.lattices, lats, outs)):
        keys = MODEL_PARAM_KEYS[ls.model]
        n_off = len(ls.offsets)
        dense = ls.graph == "dense"
        ints = [MODELS.index(ls.model), KINDS.index(ls.kind),
                *ls.shape, n_off, len(keys), int(ls.emit), int(dense)]
        ints += [o_[0] for o_ in ls.offsets] + [0] * (MAX_OFFSETS - n_off)
        ints += [o_[1] for o_ in ls.offsets] + [0] * (MAX_OFFSETS - n_off)
        lat_i[NL_I * k:NL_I * (k + 1)] = ints
        b = o["buf"]
        ptrs = [ptr(d["v"]), ptr(d["w"]), ptr(d["lft"]), ptr(d.get("refr")),
                *[None if x is None else x[0].data_ptr() for x in b],
                *[None if x is None else x[1].data_ptr() for x in b],
                ptr(o["spikes"]), ptr(o["v_pre"]), ptr(d["in_deg"]),
                ptr(o["cnt"]), ptr(o["weights"]) if n_off or dense else None,
                ptr(d["mask"]) if n_off or dense else None,
                *[d["params"][p].data_ptr() for p in keys]]
        lat_p[NL_P * k:NL_P * k + len(ptrs)] = ptrs
        lat_p[NL_P * k + 32] = ptr(lat_sums[k])
        if o["traces"] is not None:
            lat_p[NL_P * k + 33:NL_P * k + 36] = [
                ptr(o["traces"][key]) for key in ("c", "dw", "counter")]
    tr_i = (ctypes.c_int * max(NT_I * len(trains), 1))()
    tr_p = (ctypes.c_void_p * max(NT_P * len(trains), 1))()
    for j, (ts, d, o, u) in enumerate(zip(spec.trains, trains, touts,
                                          uniforms)):
        tr_i[NT_I * j:NT_I * (j + 1)] = [
            TRAIN_KINDS.index(ts.kind),
            REFRACTORINESS.index(ts.refractoriness), *ts.shape,
            NT_KINDS.index(ts.nt) if ts.nt else -1]
        poisson = ts.kind == "poisson"
        tr_p[NT_P * j:NT_P * (j + 1)] = [
            ptr(o["lft"]), ptr(d["v_th"]), ptr(d["v_resting"]),
            ptr(d["refr_k"]), ptr(d["dt"]),
            ptr(d["chance"]) if poisson else None,
            ptr(u) if poisson else None,
            None if poisson else ptr(d["rate"]), ptr(o["step"]),
            ptr(o["spikes"])]
    cn_i = (ctypes.c_int * max(NC_I * len(conns), 1))()
    cn_p = (ctypes.c_void_p * max(NC_P * len(conns), 1))()
    for ci, (cs, d, w, tr) in enumerate(zip(spec.conns, conns, couts,
                                            ctraces)):
        if cs.op[0] == "resample":
            _, R1, C1, _, _, fr, fc, tp = cs.op
            geo = [R1, C1, fr, fc, len(tp)]
        elif cs.op[0] == "dense":
            geo = [1, w.shape[0], 0, 0, w.shape[0]]   # n_pre source rows
        else:
            geo = [0, 0, 0, 0, 1]
        cn_i[NC_I * ci:NC_I * (ci + 1)] = [
            CONN_KINDS.index(cs.op[0]), int(cs.pre_is_st), cs.pre, cs.post,
            int(cs.pre_plastic), int(cs.post_plastic), *geo, cs.static,
            int(cs.reward)]
        # the third pointer: a resample's taps, or the effect scratch of a
        # dense block that reads a train; the fourth: a dense block's sums
        # then a reward connection's traces
        cn_p[NC_P * ci:NC_P * (ci + 1)] = [
            ptr(w), ptr(d["mask"]),
            ptr(taps[ci]) if taps[ci] is not None else ptr(effects[ci]),
            ptr(conn_sums[ci]),
            *[None if tr is None else ptr(tr[key])
              for key in ("c", "dw", "counter")]]
    chem_i, lat_c, tr_c = _chem_pointers(spec, lats, trains, outs, touts,
                                         ptr)
    r = rule_floats(rule)
    rule_vec = (ctypes.c_float * 5)(*[r[k] for k in STDP_KEYS])
    rrule = rew = dop_steps = None
    if reward is not None:
        rr = rule_floats(reward["rule"])
        rrule = (ctypes.c_float * len(RSTDP_KEYS))(
            *[rr[k] for k in RSTDP_KEYS])
        if spec.with_reward:
            rew = (ctypes.c_float * n_steps)(
                *np.asarray(reward["rewards"], np.float32).tolist())
            dop_steps = torch.empty(n_steps, dtype=torch.float32,
                                    device=dev)
    rc = lib.net_steps(len(lats), lat_i, lat_p, len(trains), tr_i, tr_p,
                       len(conns), cn_i, cn_p, rule_vec, int(clock0),
                       n_steps, chem_i, lat_c, tr_c, rrule,
                       int(spec.with_reward), rew,
                       ptr(None if reward is None else reward["dopamine"]),
                       ptr(dop_steps), stream)
    last = (n_steps - 1) % 2
    lat_out = [dict(v=o["buf"][0][last], w=o["buf"][1][last],
                    lft=o["buf"][2][last],
                    refr=o["buf"][3][last] if o["buf"][3] is not None
                    else None,
                    spikes=o["spikes"], weights=o["weights"],
                    traces=o["traces"], v_pre=o["v_pre"],
                    chem=None if o["chem"] is None else {
                        **{k: v for k, v in o["chem"].items()
                           if k.startswith("rec$")},
                        "nt$t": o["chem"]["ntt"][last],
                        "rec$current": o["chem"]["cur"]})
               for o in outs]
    tr_out = [dict(lft=o["lft"], step=o["step"], spikes=o["spikes"],
                   ntt=o["ntt"]) for o in touts]
    extra = None if reward is None else dict(
        traces=ctraces,
        dopamine=dop_steps[-1] if spec.with_reward else reward["dopamine"])
    return rc, (lat_out, tr_out, couts, extra)


@functools.lru_cache(maxsize=8)
def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=64)
def _persistent_ints(spec, n_blocks, budget):
    """The integer descriptions of ``net_persistent_steps`` for ``spec``
    and its residency plan (they depend on nothing else): per lattice
    PL_I ints, per train PT_I, per connection PC_I, the chemical ints; and
    the plan's shared memory a block."""
    members, smem = persistent_plan(spec, n_blocks, budget)
    plan = {m.key: m for m in members}
    flat = is_flat(spec)

    def res(key):
        m = plan.get(key)
        return [int(bool(m and m.resident)), m.offset if m else 0,
                m.cap if m else 0]

    lat_i = (ctypes.c_int * (PL_I * len(spec.lattices)))()
    for k, ls in enumerate(spec.lattices):
        n_off = len(ls.offsets)
        pad = [0] * (MAX_OFFSETS - n_off)
        graph = res(("lat", k))
        chem_p, chem_s = res(("chemp", k)), res(("chems", k))
        lat_i[PL_I * k:PL_I * (k + 1)] = [
            MODELS.index(ls.model), KINDS.index(ls.kind), *ls.shape, n_off,
            int(ls.emit), *([0, 0, 0] if flat else graph),
            *[o[0] for o in ls.offsets], *pad,
            *[o[1] for o in ls.offsets], *pad,
            int(ls.graph == "dense"), *(graph[:2] if flat else [0, 0]),
            *chem_p[:2], *chem_s[:2], max(chem_p[2], chem_s[2])]
    tr_i = (ctypes.c_int * max(PT_I * len(spec.trains), 1))()
    for j, ts in enumerate(spec.trains):
        tr_i[PT_I * j:PT_I * (j + 1)] = [
            TRAIN_KINDS.index(ts.kind),
            REFRACTORINESS.index(ts.refractoriness), *ts.shape,
            NT_KINDS.index(ts.nt) if ts.nt else -1]
    cn_i = (ctypes.c_int * max(PC_I * len(spec.conns), 1))()
    for ci, cs in enumerate(spec.conns):
        m = plan["conn", ci]
        if cs.op[0] == "resample":
            _, R1, C1, _, _, fr, fc, taps = cs.op
        elif cs.op[0] == "dense":
            pre = spec.trains[cs.pre] if cs.pre_is_st \
                else spec.lattices[cs.pre]
            R1, C1, fr, fc = 1, pre.shape[1], 0, 0
            taps = ((0, 0),) * pre.shape[1]    # n_taps: the source rows
        else:
            R1 = C1 = fr = fc = 0
            taps = ((0, 0),)
        pad = [0] * max(MAX_TAPS - len(taps), 0)
        cn_i[PC_I * ci:PC_I * (ci + 1)] = [
            CONN_KINDS.index(cs.op[0]), int(cs.pre_is_st), cs.pre, cs.post,
            int(cs.pre_plastic), int(cs.post_plastic), R1, C1, fr, fc,
            len(taps), cs.static, int(cs.reward), int(m.resident), m.offset,
            m.cap, *[t[0] for t in taps[:MAX_TAPS]], *pad,
            *[t[1] for t in taps[:MAX_TAPS]], *pad]
    chem_i = (ctypes.c_int * 4)(-1, 0, 0, 1)
    if spec.chem:
        fam, rec, nt = spec.chem
        chem_i[:] = [CHEM_FAMILIES.index(fam), REC_KINDS.index(rec),
                     NT_KINDS.index(nt), int(spec.electrical)]
    return lat_i, tr_i, cn_i, chem_i, smem


def _persistent_outputs(spec, lats, trains, conns, n_steps, dev):
    """Buffers of a persistent call: double-buffered lattice state, spike
    flags and concentrations, emits, the trains' firing times in three
    sets and concentrations in two, and empty planes for what the steps
    update (the kernel copies the inputs in)."""
    outs = []
    for ls, d in zip(spec.lattices, lats):
        shp = ls.shape

        def pair(dtype, shape=shp):
            return torch.empty((2, *shape), dtype=dtype, device=dev)

        upd = ls.kind != "plain" and bool(ls.offsets)
        chem = None
        if spec.chem:
            c = d["chem"]
            chem = {k: torch.empty_like(c[k]) for k in chem_out_keys(
                spec.chem) if k not in ("nt$t", "rec$current")}
            chem.update(ntt=pair(torch.float32, c["nt$t"].shape),
                        cur=torch.empty_like(c["nt$t"]))
        outs.append(dict(
            buf=[pair(torch.float32), pair(torch.float32), pair(torch.int32),
                 pair(torch.float32) if ls.model in REFRACTORY_MODELS
                 else None],
            spikes=pair(torch.bool),
            cnt=torch.empty(shp, dtype=torch.float32, device=dev),
            v_pre=torch.empty((n_steps, *shp), dtype=torch.float32,
                              device=dev) if ls.emit else None,
            weights=torch.empty_like(d["weights"]) if upd else d["weights"],
            traces={k: torch.empty_like(v) for k, v in d["traces"].items()}
            if ls.kind == "mod" and ls.offsets else None,
            chem=chem))
    touts = [dict(lft=torch.empty((3, *ts.shape), dtype=torch.int32,
                                  device=dev),
                  step=torch.empty_like(d["step"]) if ts.kind == "rate"
                  else None,
                  spikes=torch.empty(ts.shape, dtype=torch.bool, device=dev),
                  ntt=torch.empty((2, *d["chem"]["nt$t"].shape),
                                  dtype=torch.float32, device=dev)
                  if ts.nt else None)
             for ts, d in zip(spec.trains, trains)]
    couts = [torch.empty_like(d["w"]) if cs.updates else d["w"]
             for cs, d in zip(spec.conns, conns)]
    ctraces = [{k: torch.empty_like(d[k]) for k in ("c", "dw", "counter")}
               if cs.reward else None for cs, d in zip(spec.conns, conns)]
    return outs, touts, couts, ctraces


def _persistent_chem_pointers(spec, d, o, ptr, part):
    """A chemical lattice's 31 pointers after its PL_P electrical ones
    (none without chemistry): nt$t in, concentration sets 0 and 1, the
    previous step's spikes, rec$r, rec$r2, inh and nmda modifiers in, then
    out, rec$current, nt$mask, rec$mask, NT parameters [3], kinetics
    parameters [2], rec$r2 kinetics parameters [2], current parameters [9]
    (DOPA_PLANES, or g, e, mg)."""
    if not spec.chem:
        return [None] * 31
    fam, rec, nt = spec.chem
    c, oc = d["chem"], o["chem"]
    state = ("rec$r", "rec$r2", "rec$inh_modifier", "rec$nmda_modifier")

    def padded(keys, n):
        return [ptr(c[k]) for k in keys] + [None] * (n - len(keys))

    kin = ["rec$" + k for k in REC_KIN_KEYS[rec]]
    out = [ptr(c["nt$t"]), part(oc["ntt"], 0), part(oc["ntt"], 1),
           ptr(d["spikes"]), *[ptr(c.get(k)) for k in state],
           *[ptr(oc.get(k)) for k in state], ptr(oc["cur"]),
           ptr(c["nt$mask"]), ptr(c["rec$mask"]),
           *padded(NT_PARAM_KEYS[nt], 3), *padded(kin, 2)]
    if fam == "dopaglugaba":
        return out + padded([x.replace("rec$", "rec$r2$", 1) for x in kin],
                            2) + padded(DOPA_PLANES, 9)
    return out + [None, None] + padded(("rec$g", "rec$e", "rec$mg"), 9)


def _launch_persistent(lib, spec, lats, trains, conns, uniforms, rule,
                       clock0, n_steps, stream, reward, budget):
    """Pack the checked inputs into the descriptions of
    ``net_persistent_steps`` and call it on ``stream``; returns its code
    and the outputs, laid out as `_launch`'s."""
    dev = lats[0]["v"].device
    n_steps = int(n_steps)
    n_blocks = _sm_count(dev)
    lat_i, tr_i, cn_i, chem_i, smem = _persistent_ints(spec, n_blocks,
                                                       budget)
    outs, touts, couts, ctraces = _persistent_outputs(
        spec, lats, trains, conns, n_steps, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def part(t, s):     # the address of t[s], without making the view
        return None if t is None \
            else t.data_ptr() + s * t.stride(0) * t.element_size()

    lat_p = (ctypes.c_void_p * (PL_P * len(lats)))()
    for k, (ls, d, o) in enumerate(zip(spec.lattices, lats, outs)):
        b, tr_in, tr_out = o["buf"], d.get("traces"), o["traces"]
        lat_p[PL_P * k:PL_P * (k + 1)] = [
            ptr(d["v"]), ptr(d["w"]), ptr(d["lft"]), ptr(d.get("refr")),
            *[part(x, s) for s in (0, 1) for x in b],
            part(o["spikes"], 0), part(o["spikes"], 1),
            ptr(o["v_pre"]), ptr(d["in_deg"]), ptr(o["cnt"]),
            ptr(d["weights"]), ptr(o["weights"]), ptr(d["mask"]),
            *[None if tr_out is None else ptr(tr_in[key])
              for key in ("c", "dw", "counter")],
            *[None if tr_out is None else ptr(tr_out[key])
              for key in ("c", "dw", "counter")],
            *[d["params"][p].data_ptr() for p in MODEL_PARAM_KEYS[ls.model]],
            *[None] * (13 - len(MODEL_PARAM_KEYS[ls.model])),
            *_persistent_chem_pointers(spec, d, o, ptr, part)]
    tr_p = (ctypes.c_void_p * max(PT_P * len(trains), 1))()
    for j, (ts, d, o, u) in enumerate(zip(spec.trains, trains, touts,
                                          uniforms)):
        poisson = ts.kind == "poisson"
        c = d["chem"] if ts.nt else {}
        tr_p[PT_P * j:PT_P * (j + 1)] = [
            ptr(d["lft"]), *[part(o["lft"], s) for s in (0, 1, 2)],
            ptr(d["v_th"]), ptr(d["v_resting"]), ptr(d["refr_k"]),
            ptr(d["dt"]), ptr(d["chance"]) if poisson else None,
            ptr(u) if poisson else None,
            None if poisson else ptr(d["rate"]),
            None if poisson else ptr(d["step"]), ptr(o["step"]),
            ptr(o["spikes"]), ptr(c.get("nt$t")), part(o["ntt"], 0),
            part(o["ntt"], 1), ptr(c.get("nt$mask")),
            *[ptr(c[k]) for k in NT_PARAM_KEYS.get(ts.nt, ())],
            *[None] * (3 - len(NT_PARAM_KEYS.get(ts.nt, ())))]
    cn_p = (ctypes.c_void_p * max(PC_P * len(conns), 1))()
    for ci, (d, w, tr) in enumerate(zip(conns, couts, ctraces)):
        cn_p[PC_P * ci:PC_P * (ci + 1)] = [
            ptr(d["w"]), ptr(w), ptr(d["mask"]),
            *[None if tr is None else ptr(d[key])
              for key in ("c", "dw", "counter")],
            *[None if tr is None else ptr(tr[key])
              for key in ("c", "dw", "counter")]]
    r = rule_floats(rule)
    rule_vec = (ctypes.c_float * 5)(*[r[k] for k in STDP_KEYS])
    rrule = rew = dop_steps = None
    if reward is not None:
        rr = rule_floats(reward["rule"])
        rrule = (ctypes.c_float * len(RSTDP_KEYS))(
            *[rr[k] for k in RSTDP_KEYS])
        if spec.with_reward:
            rew = (ctypes.c_float * n_steps)(
                *np.asarray(reward["rewards"], np.float32).tolist())
            dop_steps = torch.empty(n_steps, dtype=torch.float32,
                                    device=dev)
    rc = lib.net_persistent_steps(
        len(lats), lat_i, lat_p, len(trains), tr_i, tr_p, len(conns), cn_i,
        cn_p, rule_vec, rrule, chem_i, int(clock0), n_steps,
        int(spec.with_reward), rew,
        ptr(None if reward is None else reward["dopamine"]), ptr(dop_steps),
        smem, stream)
    last = (n_steps - 1) % 2
    lat_out = [dict(v=o["buf"][0][last], w=o["buf"][1][last],
                    lft=o["buf"][2][last],
                    refr=None if o["buf"][3] is None else o["buf"][3][last],
                    spikes=o["spikes"][last], weights=o["weights"],
                    traces=o["traces"], v_pre=o["v_pre"],
                    chem=None if o["chem"] is None else {
                        **{k: v for k, v in o["chem"].items()
                           if k.startswith("rec$")},
                        "nt$t": o["chem"]["ntt"][last],
                        "rec$current": o["chem"]["cur"]})
               for o in outs]
    tr_out = [dict(lft=o["lft"][(n_steps - 1) % 3], step=o["step"],
                   spikes=o["spikes"],
                   ntt=None if o["ntt"] is None else o["ntt"][last])
              for o in touts]
    extra = None if reward is None else dict(
        traces=ctraces,
        dopamine=dop_steps[-1] if spec.with_reward else reward["dopamine"])
    return rc, (lat_out, tr_out, couts, extra)


def _chem_pointers(spec, lats, trains, outs, touts, ptr):
    """The chemical arm's descriptions for ``net_steps``: ints {family,
    receptor kinetics, NT kinetics, electrical} (family -1 without chem),
    per lattice NLC_P pointers {nt$t in, concentration buffer sets 0 and
    1, rec$r, rec$r2, rec$current, inh and nmda modifiers (the last five
    updated in place), nt$mask, rec$mask, NT parameters [3], kinetics
    parameters [2], rec$r2 kinetics parameters [2], the current parameters
    [9] (DOPA_PLANES, or g, e, mg)}, per train NTC_P pointers {nt$t
    (updated in place), nt$mask, NT parameters [3]}."""
    chem_i = (ctypes.c_int * 4)(-1, 0, 0, 1)
    lat_c = (ctypes.c_void_p * max(NLC_P * len(lats), 1))()
    tr_c = (ctypes.c_void_p * max(NTC_P * len(trains), 1))()
    if not spec.chem:
        return chem_i, lat_c, tr_c
    fam, rec, nt = spec.chem
    chem_i[:] = [CHEM_FAMILIES.index(fam), REC_KINDS.index(rec),
                 NT_KINDS.index(nt), int(spec.electrical)]

    def padded(keys, c, n):
        return [ptr(c[k]) for k in keys] + [None] * (n - len(keys))

    kin = ["rec$" + k for k in REC_KIN_KEYS[rec]]
    for k, (d, o) in enumerate(zip(lats, outs)):
        c, oc = d["chem"], o["chem"]
        ptrs = [ptr(c["nt$t"]), ptr(oc["ntt"][0]), ptr(oc["ntt"][1]),
                ptr(oc["rec$r"]), ptr(oc.get("rec$r2")), ptr(oc["cur"]),
                ptr(oc.get("rec$inh_modifier")),
                ptr(oc.get("rec$nmda_modifier")), ptr(c["nt$mask"]),
                ptr(c["rec$mask"]), *padded(NT_PARAM_KEYS[nt], c, 3),
                *padded(kin, c, 2)]
        if fam == "dopaglugaba":
            ptrs += padded([x.replace("rec$", "rec$r2$", 1) for x in kin],
                           c, 2) + padded(DOPA_PLANES, c, 9)
        else:
            ptrs += [None, None] + padded(("rec$g", "rec$e", "rec$mg"), c, 9)
        lat_c[NLC_P * k:NLC_P * k + len(ptrs)] = ptrs
    for j, (ts, d, o) in enumerate(zip(spec.trains, trains, touts)):
        if ts.nt:
            ptrs = [ptr(o["ntt"]), ptr(d["chem"]["nt$mask"]),
                    *padded(NT_PARAM_KEYS[ts.nt], d["chem"], 3)]
            tr_c[NTC_P * j:NTC_P * j + len(ptrs)] = ptrs
    return chem_i, lat_c, tr_c


# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------


def _taps(op, x):
    """Per-tap post-aligned planes of pre plane ``x``, zero off the pre
    grid (`core.structured._resample_planes`)."""
    return _resample_planes(op[1:], x.reshape(-1)).unbind(0)


def train_effect(ts, d, lft, clock):
    """A train's effect from its firing times ``lft``, in the kernels'
    association ``(decay * tdiff) * tdiff`` and with their exp."""
    amp = d["v_th"] - d["v_resting"]
    tdiff = (clock - lft).to(torch.float32)
    decay = -1.0 / (d["refr_k"] / d["dt"])
    x = decay * tdiff * tdiff if ts.refractoriness == "delta_dirac" \
        else decay * tdiff
    eff = amp * kernel_exp(x) + d["v_resting"]
    return torch.where(lft == NEVER, d["v_resting"], eff)


def connection_counts(spec, lats, conns):
    """``max(in_deg + sum of incoming connection masks, 1)`` per lattice."""
    cnts = []
    for k, d in enumerate(lats):
        cnt = d["in_deg"]
        for cs, c in zip(spec.conns, conns):
            if cs.post == k:
                m = c["mask"].to(torch.float32)
                cnt = cnt + (m if cs.op[0] == "one2one" else m.sum(dim=0))
        cnts.append(torch.clamp(cnt, min=1.0))
    return cnts


def _types(x, shape):
    """The three (rows, cols) type planes of an (N, 3) field."""
    return list(x.reshape(*shape, N_TYPES).unbind(-1))


def _stack_types(planes):
    return torch.stack(planes, -1).reshape(-1, N_TYPES)


def _chem_static(spec, d, shape):
    """A lattice's fixed chemical planes, per type where (N, 3)."""
    fam, rec, nt = spec.chem
    c = d["chem"]
    tp = lambda k: _types(c[k], shape)
    out = dict(ntm=tp("nt$mask"), recm=tp("rec$mask"),
               ntp=[tp(k) for k in NT_PARAM_KEYS[nt]],
               kin=[tp("rec$" + k) for k in REC_KIN_KEYS[rec]])
    out["ntm_f"] = [m.to(torch.float32) for m in out["ntm"]]
    if fam == "dopaglugaba":
        out["kin2"] = [tp("rec$r2$" + k) for k in REC_KIN_KEYS[rec]]
        out["rp"] = {k: c[k].reshape(shape) for k in DOPA_PLANES}
    else:
        out["rp"] = {k: tp(k) for k in ("rec$g", "rec$e", "rec$mg")}
    return out


def _chem_state(spec, d, shape):
    """A lattice's carried chemical fields, per type where (N, 3)."""
    c = d["chem"]
    out = dict(ntt=_types(c["nt$t"], shape), r=_types(c["rec$r"], shape),
               cur=None)
    if spec.chem[0] == "dopaglugaba":
        out.update(r2=_types(c["rec$r2"], shape),
                   inh=c["rec$inh_modifier"].reshape(shape),
                   nmda=c["rec$nmda_modifier"].reshape(shape))
    return out


def _seg_dot(xs, w):
    """The dense gathers' sum ``sum_i xs[..., i, None] * w[i]`` in the CUDA
    kernels' order: `DENSE_SEG` partial sums, the k-th over the sources i =
    k, k + DENSE_SEG, ... accumulated from 0 in that order (a multiply,
    then an add), then the partial sums added from 0 in the order of k.
    ``xs`` is (Q, n_src), ``w`` (n_src, n_post); returns (Q, n_post)."""
    n_src, n_post = w.shape
    turns = -(-n_src // DENSE_SEG)
    pad = turns * DENSE_SEG - n_src
    wp = F.pad(w, (0, 0, 0, pad)).reshape(turns, DENSE_SEG, n_post)
    xp = F.pad(xs, (0, pad)).reshape(-1, turns, DENSE_SEG)
    acc = xs.new_zeros((xp.shape[0], DENSE_SEG, n_post))
    for t in range(turns):
        new = acc + xp[:, t, :, None] * wp[t]
        if pad and t == turns - 1:
            # the last turn's segments past n_src have no term
            live = torch.arange(DENSE_SEG, device=w.device) < DENSE_SEG - pad
            new = torch.where(live[None, :, None], new, acc)
        acc = new
    total = xs.new_zeros((xp.shape[0], n_post))
    for k in range(DENSE_SEG):
        total = total + acc[:, k]
    return total


def _dense_static(spec, lats, conns, statics, tr_static):
    """What the dense gathers of a call keep fixed: per dense lattice
    (key ("lat", i)) and dense block (key ("conn", ci)) the matrix ``w``
    (an intra graph's masked), the column sums ``sub`` that multiply v (in
    `_seg_dot`'s order; zeros for a train), and with chemistry the per-type
    source counts (small integers, exact in any order)."""
    out = {}
    for i, (ls, d) in enumerate(zip(spec.lattices, lats)):
        if ls.graph != "dense":
            continue
        w = torch.where(d["mask"], d["weights"], 0.0)
        e = dict(w=w, sub=_seg_dot(w.new_ones((1, w.shape[0])), w))
        if spec.chem:
            mf = d["mask"].to(torch.float32)
            e["cnt"] = [(m.reshape(-1, 1) * mf).sum(dim=0).reshape(ls.shape)
                        for m in statics[i]["ntm_f"]]
        out["lat", i] = e
    for ci, (cs, c) in enumerate(zip(spec.conns, conns)):
        if cs.op[0] != "dense":
            continue
        w = c["w"]
        shape = spec.lattices[cs.post].shape
        e = dict(w=w, sub=w.new_zeros(shape) if cs.pre_is_st else _seg_dot(
            w.new_ones((1, w.shape[0])), w))
        src = tr_static[cs.pre] if cs.pre_is_st else statics[cs.pre]
        if spec.chem and src is not None:
            mf = c["mask"].to(torch.float32)
            e["cnt"] = [(m.reshape(-1, 1) * mf).sum(dim=0).reshape(shape)
                        for m in src["ntm_f"]]
        out["conn", ci] = e
    return out


def _dense_sums(spec, dense, v_prev, effects, ntt_prev, statics, tr,
                tr_static):
    """One step's dense gathers, one pass over each matrix: per key of
    ``dense`` a dict of ``elec`` (the electrical sum over the sources'
    previous v or effects) and ``chem`` (the three per-type sums of the
    sources' ``t * m``), each a (1, n_post) row or None."""
    out = {}
    for key, e in dense.items():
        if key[0] == "lat":
            a = v_prev[key[1]]
            t, m = ntt_prev[key[1]], statics[key[1]]
        else:
            cs = spec.conns[key[1]]
            a = effects[cs.pre] if cs.pre_is_st else v_prev[cs.pre]
            t = tr[cs.pre]["ntt"] if cs.pre_is_st else ntt_prev[cs.pre]
            m = tr_static[cs.pre] if cs.pre_is_st else statics[cs.pre]
        chem = spec.chem and m is not None
        xs = ([a.reshape(-1)] if spec.electrical else []) + (
            [(t[q] * m["ntm_f"][q]).reshape(-1) for q in range(N_TYPES)]
            if chem else [])
        if not xs:
            out[key] = dict(elec=None, chem=None)
            continue
        sums = _seg_dot(torch.stack(xs), e["w"])
        shape = (1, sums.shape[-1])
        out[key] = dict(
            elec=sums[0].reshape(shape) if spec.electrical else None,
            chem=[x.reshape(shape) for x in sums[len(xs) - N_TYPES:]]
            if chem else None)
    return out


def _electrical_total(spec, i, ls, s, d, v_prev, effects, conns, cw, dense,
                      sums):
    """Phase A of lattice ``i`` before its gap and count: the intra sum
    ``acc - v * wsum`` (a dense graph's re-expanded by its in-degree), then
    each incoming connection in plan order."""
    v = s["v"]
    if ls.graph == "dense":
        ind = torch.clamp(d["in_deg"], min=1.0)
        total = (sums["lat", i]["elec"] - v * dense["lat", i]["sub"]) \
            / ind * ind
    else:
        acc = torch.zeros_like(v)
        wsum = torch.zeros_like(v)
        for o, vs in enumerate(shifted(v, ls.offsets, 0.0)):
            acc = acc + s["weights"][o] * vs
            wsum = wsum + s["weights"][o]
        total = acc - v * wsum
    for ci, cs in enumerate(spec.conns):
        if cs.post != i:
            continue
        if cs.op[0] == "dense":
            total = total + (sums["conn", ci]["elec"]
                             - v * dense["conn", ci]["sub"])
            continue
        a_src = effects[cs.pre] if cs.pre_is_st else v_prev[cs.pre]
        if cs.op[0] == "one2one":
            m = conns[ci]["mask"].to(torch.float32)
            total = total + (m * cw[ci]) * (
                a_src if cs.pre_is_st else a_src - v)
            continue
        tacc = torch.zeros_like(v)
        subs = None if cs.pre_is_st \
            else _taps(cs.op, torch.ones_like(a_src))
        for t, a_t in enumerate(_taps(cs.op, a_src)):
            tacc = tacc + cw[ci][t] * (
                a_t if cs.pre_is_st else a_t - subs[t] * v)
        total = total + tacc
    return total


def _chem_input(spec, i, ls, s, cs_i, ntt_prev, statics, tr, tr_static,
                conns, cw, dense, dsums):
    """Phase A' of lattice ``i``: per type, ``t_in`` and its validity."""
    zeros = torch.zeros_like(s["v"])
    emask = [m.to(torch.float32) for m in s["mask"]]
    t_in, valid = [], []
    for q in range(N_TYPES):
        sums, gcnt = zeros, zeros
        if ls.graph == "dense":
            sums, gcnt = dsums["lat", i]["chem"][q], dense["lat", i]["cnt"][q]
        for o, (ts, ms) in enumerate(zip(
                shifted(ntt_prev[i][q] * cs_i["ntm_f"][q], ls.offsets, 0.0),
                shifted(cs_i["ntm_f"][q], ls.offsets, 0.0))):
            sums = sums + s["weights"][o] * ts
            gcnt = gcnt + emask[o] * ms
        g1 = torch.clamp(gcnt, min=1.0)
        csum = sums / g1 * g1 * (gcnt > 0.0).to(torch.float32)
        ccnt = gcnt
        for ci, cs in enumerate(spec.conns):
            if cs.post != i or (cs.pre_is_st
                                and not spec.trains[cs.pre].nt):
                continue
            if cs.op[0] == "dense":
                csum = csum + dsums["conn", ci]["chem"][q]
                ccnt = ccnt + dense["conn", ci]["cnt"][q]
                continue
            if cs.pre_is_st:
                t_src = tr[cs.pre]["ntt"][q]
                m_src = tr_static[cs.pre]["ntm_f"][q]
            else:
                t_src = ntt_prev[cs.pre][q]
                m_src = statics[cs.pre]["ntm_f"][q]
            mask = conns[ci]["mask"]
            csum = csum + torch.where(mask, cw[ci] * t_src * m_src, 0.0)
            ccnt = ccnt + torch.where(mask, m_src, 0.0)
        t_in.append(csum / torch.clamp(ccnt, min=1.0))
        valid.append(ccnt > 0.0)
    return t_in, valid


def _receptors(spec, cs_i, c_i, v, t_in, valid, pp, consts):
    """Phase B' of one lattice: the receptor kinetics on valid, inserted
    slots, the currents at the pre-update ``v`` and the modifiers, in
    place on ``c_i``; returns ``rec_dv``."""
    fam, rec, _ = spec.chem
    dt = pp["dt"]
    recm, rp = cs_i["recm"], cs_i["rp"]
    upd = [valid[q] & recm[q] for q in range(N_TYPES)]
    c_i["r"] = [torch.where(upd[q], rec_kinetics(
        rec, c_i["r"][q], t_in[q], [k[q] for k in cs_i["kin"]], dt),
        c_i["r"][q]) for q in range(N_TYPES)]
    r = c_i["r"]
    if fam == "dopaglugaba":
        c_i["r2"] = [torch.where(upd[q], rec_kinetics(
            rec, c_i["r2"][q], t_in[q], [k[q] for k in cs_i["kin2"]], dt),
            c_i["r2"][q]) for q in range(N_TYPES)]
        r2, inh, nmda = c_i["r2"], c_i["inh"], c_i["nmda"]
        block = 1.0 / (1.0 + kernel_exp(-0.062 * v) * rp["rec$mg"]
                       / consts["3.57"])
        glu = inh * rp["rec$g_ampa"] * r[0] * (v - rp["rec$e_ampa"]) \
            + block * inh * rp["rec$g_nmda"] * kernel_pow(r2[0], nmda) \
            * (v - rp["rec$e_nmda"])
        glu = torch.where(recm[0], glu, 0.0)
        gaba = torch.where(recm[1], rp["rec$g_gaba"] * r[1]
                           * (v - rp["rec$e_gaba"]), 0.0)
        c_i["inh"] = torch.where(recm[2], 1.0 - r2[2] * rp["rec$s_d2"], inh)
        c_i["nmda"] = torch.where(recm[2], 1.0 - r[2] * rp["rec$s_d1"],
                                  nmda)
        c_i["cur"] = [glu, gaba, torch.zeros_like(glu)]
        return (glu + gaba) * (dt / pp["c_m"])
    block = 1.0 / (1.0 + kernel_exp(-0.062 * v) * rp["rec$mg"][1]
                   / consts["3.75"])
    cur = [rp["rec$g"][q] * r[q] * (v - rp["rec$e"][q])
           for q in range(N_TYPES)]
    cur[1] = cur[1] * block
    c_i["cur"] = [torch.where(recm[q], cur[q], 0.0) for q in range(N_TYPES)]
    return (c_i["cur"][0] + c_i["cur"][1] + c_i["cur"][2]) \
        * (dt / pp["c_m"])


def network_steps_reference(spec, lats, trains, conns, uniforms, rule,
                            clock0, n_steps, reward=None):
    """The plain PyTorch twin of the CUDA kernels, on any device.

    The kernels' (and the TPU kernel's) association and order, and the
    kernels' exp and pow (`core.plasticity.kernel_exp`, `kernel_pow`), so
    the twin and the kernels agree bit for bit on any device; shifted and
    resampled reads are slices of padded planes: v, concentrations and
    masks pad with 0, lft with NEVER and spikes with 0 for the stencil;
    resample pre planes pad with 0 (lft too: the masks hide those slots).
    That is what the kernels' bounds checks do.  A dense graph's or
    block's gather is `_seg_dot`, the sum over the sources in the kernels'
    order; no matrix product is called.  Divisions by constants
    divide by 0-dim tensors: CUDA PyTorch turns a Python-scalar divisor
    into a multiply by its reciprocal.  The reward arm, per step: the
    dopamine before the visits, STDP (plastic lattices, then connections
    with ``count = static + pre_plastic * spk_pre + post_plastic *
    spk_post``), the R-STDP double visit of every ``mod`` lattice, the
    gated visits of the reward connections, then the trains.
    """
    dev = lats[0]["v"].device
    p = rule_tensors(rule, dev)
    rp = dop = None
    if reward is not None:
        rp = rule_tensors(reward["rule"], dev)
        dop = reward["dopamine"]
    traces = [{k: list(v.unbind(0)) for k, v in d["traces"].items()}
              if ls.kind == "mod" and ls.offsets else None
              for ls, d in zip(spec.lattices, lats)]
    ctr = [{k: list(c[k].unbind(0)) if cs.op[0] == "resample" else c[k]
            for k in ("c", "dw", "counter")} if cs.reward else None
           for cs, c in zip(spec.conns, conns)]
    consts = {k: torch.tensor(float(k), dtype=torch.float32, device=dev)
              for k in ("3.57", "3.75")}
    cnts = connection_counts(spec, lats, conns)
    st = [dict(v=d["v"], w=d["w"], lft=d["lft"], refr=d.get("refr"),
               weights=list(d["weights"].unbind(0)) if ls.offsets else [],
               mask=list(d["mask"].unbind(0)) if ls.offsets else [],
               spikes=d["spikes"] if spec.chem else None, v_pre=[])
          for ls, d in zip(spec.lattices, lats)]
    statics = [_chem_static(spec, d, ls.shape) if spec.chem else None
               for ls, d in zip(spec.lattices, lats)]
    chem = [_chem_state(spec, d, ls.shape) if spec.chem else None
            for ls, d in zip(spec.lattices, lats)]
    tr = [dict(lft=d["lft"], step=d.get("step"), spikes=None,
               ntt=_types(d["chem"]["nt$t"], ts.shape) if ts.nt else None)
          for ts, d in zip(spec.trains, trains)]
    tr_static = [dict(
        ntm=_types(d["chem"]["nt$mask"], ts.shape),
        ntm_f=[m.to(torch.float32)
               for m in _types(d["chem"]["nt$mask"], ts.shape)],
        ntp=[_types(d["chem"][k], ts.shape) for k in NT_PARAM_KEYS[ts.nt]])
        if ts.nt else None for ts, d in zip(spec.trains, trains)]
    cw = [list(c["w"].unbind(0)) if cs.op[0] == "resample" else c["w"]
          for cs, c in zip(spec.conns, conns)]
    dense = _dense_static(spec, lats, conns, statics, tr_static)
    for k in range(int(n_steps)):
        clock = int(clock0) + k
        if spec.with_reward:
            r_k = torch.tensor(float(np.float32(reward["rewards"][k])),
                               dtype=torch.float32, device=dev)
            dop = dop * rp["exp_dd"] + rp["tau_d"] * r_k
        effects = [train_effect(ts, d, t["lft"], clock)
                   for ts, d, t in zip(spec.trains, trains, tr)]
        v_prev = [s["v"] for s in st]
        ntt_prev = [c["ntt"] if c else None for c in chem]
        dsums = _dense_sums(spec, dense, v_prev, effects, ntt_prev, statics,
                            tr, tr_static)
        new = []
        for i, (ls, d, s) in enumerate(zip(spec.lattices, lats, st)):
            v = s["v"]
            pp = {q: d["params"][q] for q in MODEL_PARAM_KEYS[ls.model]}
            i_syn = torch.zeros_like(v)
            if spec.electrical:
                i_syn = pp["gap_conductance"] * _electrical_total(
                    spec, i, ls, s, d, v_prev, effects, conns, cw, dense,
                    dsums) / cnts[i]
            rec_dv = None
            if spec.chem:
                t_in, valid = _chem_input(spec, i, ls, s, statics[i],
                                          ntt_prev, statics, tr, tr_static,
                                          conns, cw, dense, dsums)
                rec_dv = _receptors(spec, statics[i], chem[i], v, t_in,
                                    valid, pp, consts)
            v_new, w_new, refr, spk, v_pre = model_step(
                ls.model, pp, v, s["w"], s["refr"], i_syn, rec_dv)
            if spec.chem:
                spk_prev = s["spikes"].to(torch.float32)
                cs_i = statics[i]
                chem[i]["ntt"] = [torch.where(cs_i["ntm"][q], nt_release(
                    spec.chem[2], ntt_prev[i][q], v_pre, spk_prev,
                    [x[q] for x in cs_i["ntp"]], pp["dt"]), 0.0)
                    for q in range(N_TYPES)]
            new.append((v_new, w_new, s["lft"].masked_fill(spk, clock),
                        refr, spk, v_pre))
        for s, (v_new, w_new, lft, refr, spk, v_pre) in zip(st, new):
            s.update(v=v_new, w=w_new, lft=lft, refr=refr, spikes=spk)
            s["v_pre"].append(v_pre)
        for ls, d, s in zip(spec.lattices, lats, st):
            if ls.kind != "plastic" or not ls.offsets:
                continue
            spk_f = s["spikes"].to(torch.float32)
            lft_pre = shifted(s["lft"], ls.offsets, NEVER)
            for o, sp in enumerate(shifted(spk_f, ls.offsets, 0.0)):
                delta = stdp_delta(lft_pre[o], s["lft"], p, kernel_exp)
                s["weights"][o] = torch.where(
                    d["mask"][o], s["weights"][o] + delta * (sp + spk_f),
                    s["weights"][o])
        for ci, cs in enumerate(spec.conns):
            if cs.updates and not cs.reward:
                _conn_visits(cs, conns[ci]["mask"], cw, ci, st, tr, p, None,
                             None)
        for ls, d, s, trc in zip(spec.lattices, lats, st, traces):
            if trc is None:
                continue
            lft_pre = shifted(s["lft"], ls.offsets, NEVER)
            for o in range(len(ls.offsets)):
                delta = stdp_delta(lft_pre[o], s["lft"], rp, kernel_exp)
                w1, c1, d1, t1 = rstdp_visit(
                    s["weights"][o], trc["c"][o], trc["dw"][o],
                    trc["counter"][o], delta, dop, rp)
                w2, c2, d2, t2 = rstdp_visit(w1, c1, d1, t1, delta, dop, rp)
                m = d["mask"][o]
                s["weights"][o] = torch.where(m, w2, s["weights"][o])
                for key, new_v in (("c", c2), ("dw", d2), ("counter", t2)):
                    trc[key][o] = torch.where(m, new_v, trc[key][o])
        for ci, cs in enumerate(spec.conns):
            if cs.reward:
                _conn_visits(cs, conns[ci]["mask"], cw, ci, st, tr, rp, ctr,
                             dop)
        for ts, d, t, u, ss in zip(spec.trains, trains, tr, uniforms,
                                   tr_static):
            if ts.kind == "poisson":
                spk = u[k] <= d["chance"]
            else:
                stepped = t["step"] + d["dt"]
                spk = torch.logical_and(d["rate"] != 0.0,
                                        stepped >= d["rate"])
                t["step"] = torch.where(spk, 0.0, stepped)
            t["lft"] = t["lft"].masked_fill(spk, clock)
            t["spikes"] = spk
            if ts.nt:
                # trains release after their new spike, from v_th or
                # v_resting
                v_t = torch.where(spk, d["v_th"], d["v_resting"])
                sf = spk.to(torch.float32)
                t["ntt"] = [torch.where(ss["ntm"][q], nt_release(
                    ts.nt, t["ntt"][q], v_t, sf, [x[q] for x in ss["ntp"]],
                    d["dt"]), 0.0) for q in range(N_TYPES)]
    lat_out = [dict(v=s["v"], w=s["w"], lft=s["lft"], refr=s["refr"],
                    spikes=s["spikes"],
                    weights=torch.stack(s["weights"]) if ls.offsets
                    else d["weights"],
                    v_pre=torch.stack(s["v_pre"]) if ls.emit else None,
                    traces=None if trc is None else {
                        k: torch.stack(v) for k, v in trc.items()},
                    chem=_chem_out(spec, c))
               for ls, d, s, c, trc in zip(spec.lattices, lats, st, chem,
                                           traces)]
    tr_out = [dict(lft=t["lft"], step=t["step"], spikes=t["spikes"],
                   ntt=_stack_types(t["ntt"]) if ts.nt else None)
              for ts, t in zip(spec.trains, tr)]
    conn_out = [torch.stack(w) if cs.op[0] == "resample" else w
                for cs, w in zip(spec.conns, cw)]
    if reward is None:
        return lat_out, tr_out, conn_out, None
    return lat_out, tr_out, conn_out, dict(
        traces=[None if t is None else {
            k: torch.stack(v) if cs.op[0] == "resample" else v
            for k, v in t.items()} for cs, t in zip(spec.conns, ctr)],
        dopamine=dop)


def _conn_visits(cs, mask, cw, ci, st, tr, p, ctr, dop):
    """One step's visits of connection ``ci``, tap by tap (a one-to-one
    connection is one tap), in place on ``cw`` (and ``ctr``): STDP ``w +=
    delta * count`` with ``count = static + pre_plastic * spk_pre +
    post_plastic * spk_post``, or for a reward connection (``ctr``) up to
    two R-STDP visits, the first where ``count >= 1``, the second where
    ``count >= 2``, on masked slots.  The pre lattice's post-step firing
    times, or a train's previous ones; resampled pre fields are cast to
    float32 (exact)."""
    post = st[cs.post]
    lft_pre = tr[cs.pre]["lft"] if cs.pre_is_st else st[cs.pre]["lft"]
    spk_post = post["spikes"].to(torch.float32)
    spk_pre = None if cs.pre_is_st else st[cs.pre]["spikes"].to(
        torch.float32)
    if cs.op[0] == "one2one":
        taps = [(lft_pre, spk_pre, mask)]
    else:
        taps = list(zip(_taps(cs.op, lft_pre.to(torch.float32)),
                        _taps(cs.op, spk_pre) if cs.pre_plastic
                        else [None] * len(cs.op[7]), mask.unbind(0)))
    for t, (lp, sp, m) in enumerate(taps):
        count = torch.full_like(spk_post, float(cs.static))
        if cs.pre_plastic:
            count = count + sp
        if cs.post_plastic:
            count = count + spk_post
        delta = stdp_delta(lp, post["lft"], p, kernel_exp)
        one = cs.op[0] == "one2one"
        w = cw[ci] if one else cw[ci][t]
        if ctr is None:
            w = torch.where(m, w + delta * count, w)
        else:
            tc = ctr[ci]
            c, dw, ct = ((tc[k] if one else tc[k][t])
                         for k in ("c", "dw", "counter"))
            for n_visit in (1.0, 2.0):
                w1, c1, d1, t1 = rstdp_visit(w, c, dw, ct, delta, dop, p)
                g = torch.logical_and(m, count >= n_visit)
                w, c = torch.where(g, w1, w), torch.where(g, c1, c)
                dw, ct = torch.where(g, d1, dw), torch.where(g, t1, ct)
            for k, v in (("c", c), ("dw", dw), ("counter", ct)):
                if one:
                    tc[k] = v
                else:
                    tc[k][t] = v
        if one:
            cw[ci] = w
        else:
            cw[ci][t] = w


def _chem_out(spec, c):
    """A lattice's chemical output fields in the state's layouts."""
    if c is None:
        return None
    out = {"nt$t": _stack_types(c["ntt"]), "rec$r": _stack_types(c["r"]),
           "rec$current": _stack_types(c["cur"])}
    if spec.chem[0] == "dopaglugaba":
        out.update({"rec$r2": _stack_types(c["r2"]),
                    "rec$inh_modifier": c["inh"].reshape(-1),
                    "rec$nmda_modifier": c["nmda"].reshape(-1)})
    return out


# ---------------------------------------------------------------------------
# Runner: K-step calls over a network's members
# ---------------------------------------------------------------------------


def _lattice_data(spec, ls, lat):
    st, shp = lat.state, ls.shape
    zeros = torch.zeros(shp, dtype=torch.float32, device=st["v"].device)
    return dict(v=st["v"].reshape(shp),
                w=st["w"].reshape(shp) if "w" in st else zeros,
                lft=st["last_firing_time"].reshape(shp),
                refr=st["refractory_count"].reshape(shp)
                if ls.model in REFRACTORY_MODELS else None,
                params={p: st[p].reshape(shp)
                        for p in MODEL_PARAM_KEYS[ls.model]},
                in_deg=lat.graph.in_degree().reshape(shp)
                if ls.offsets or ls.graph == "dense" else zeros,
                weights=lat.graph.weights
                if ls.offsets or ls.graph == "dense" else None,
                mask=lat.graph.mask
                if ls.offsets or ls.graph == "dense" else None,
                spikes=st["is_spiking"].reshape(shp),
                chem={k: st[k] for k in chem_keys(spec.chem)}
                if spec.chem else None)


def _train_data(ts, st):
    s, shp = st.state, ts.shape
    names = {"lft": "last_firing_time", "v_th": "v_th",
             "v_resting": "v_resting", "refr_k": "refractoriness$k",
             "dt": "dt"}
    names.update({"chance": "chance_of_firing"} if ts.kind == "poisson"
                 else {"rate": "rate", "step": "step"})
    d = {k: s[name].reshape(shp) for k, name in names.items()}
    if ts.nt:
        d["chem"] = {k: s[k] for k in ("nt$t", "nt$mask")
                     + NT_PARAM_KEYS[ts.nt]}
    return d


def member_inputs(spec, net, plan):
    """The wrapper's ``(lats, trains, conns)`` arguments: views of the
    network members' states, graphs, traces and connection weights (and a
    reward connection's traces), in the layouts `network_steps`
    documents.  ``spec.keep`` indexes ``plan["conns"]`` followed by
    ``plan["rconns"]`` (a reward network's)."""
    members = net._neuron_lattices()
    lats = []
    for ls, i in zip(spec.lattices, plan["lat_ids"]):
        d = _lattice_data(spec, ls, members[i])
        if ls.kind == "mod" and ls.offsets:
            d["traces"] = dict(members[i].trace)
        lats.append(d)
    trains = [_train_data(ts, net.spike_train_lattices[i])
              for ts, i in zip(spec.trains, plan["st_ids"])]
    entries = plan["conns"] + plan.get("rconns", [])
    conns = []
    for cs, ci in zip(spec.conns, spec.keep):
        op = entries[ci]["op"]
        shp = spec.lattices[cs.post].shape
        if cs.op[0] == "resample":
            shp = (len(cs.op[7]), *shp)
        elif cs.op[0] == "dense":
            shp = tuple(op.w0.shape)
        d = dict(w=op.w0.reshape(shp), mask=op.aux["mask"].reshape(shp))
        if cs.reward:
            d.update((k, v.reshape(shp))
                     for k, v in entries[ci]["trace0"].items())
        conns.append(d)
    return lats, trains, conns


def advance(spec, net, plan, length, rewards=None):
    """``length`` steps of the network's members through K-step wrapper
    calls.  Returns ``(states, st_states, graphs, conn_ws, ys, extra)`` in
    plan order, as the plain route does: ``conn_ws`` keeps each connection's
    operator layout (dropped empty connections pass through), ``ys`` the
    emitting lattices' history readouts keyed ("lat", id).  A reward
    network (``rewards``: a host array of ``length`` floats, read with
    ``spec.with_reward``) takes the reward arm from ``net.dopamine`` and
    ``net.reward_modulator``, and ``extra`` (None without ``rewards``) is
    a dict of ``traces`` (per lattice its trace dict, None but for a ``mod``
    lattice), ``rconns`` (per reward connection of the plan its (w,
    traces) in its operator layout) and ``dopamine`` (a float)."""
    members = net._neuron_lattices()
    lattices = [members[i] for i in plan["lat_ids"]]
    sts = [net.spike_train_lattices[i] for i in plan["st_ids"]]
    lats, trains, conns = member_inputs(spec, net, plan)
    entries = plan["conns"] + plan.get("rconns", [])
    ops = [entries[ci]["op"] for ci in spec.keep]
    rule = net._plasticity().params
    generator = net.generator()
    dev = lats[0]["v"].device
    reward = None
    if rewards is not None:
        reward = dict(rule=net.reward_modulator.params,
                      dopamine=torch.tensor(float(net.dopamine),
                                            dtype=torch.float32, device=dev))
    emits = [[] for _ in lats]
    tr_out, done = None, 0
    while done < length:
        n = min(STEPS_PER_LAUNCH, length - done)
        uniforms = [torch.rand((n, *ts.shape), generator=generator,
                               device=dev) if ts.kind == "poisson" else None
                    for ts in spec.trains]
        if reward is not None:
            reward["rewards"] = rewards[done:done + n]
        lat_out, tr_out, conn_ws, extra = network_steps(
            spec, lats, trains, conns, uniforms, rule,
            net.internal_clock + done, n, reward)
        if extra is not None:
            reward["dopamine"] = extra["dopamine"]
            for c, trc in zip(conns, extra["traces"]):
                if trc is not None:
                    c.update(trc)
        for d, o, e in zip(lats, lat_out, emits):
            d.update(v=o["v"], w=o["w"], lft=o["lft"], refr=o["refr"],
                     spikes=o["spikes"], weights=o["weights"])
            if o["traces"] is not None:
                d["traces"] = o["traces"]
            if o["v_pre"] is not None:
                e.append(o["v_pre"])
            if o["chem"] is not None:
                d["chem"].update(o["chem"])
        for d, o in zip(trains, tr_out):
            d.update(lft=o["lft"], spikes=o["spikes"])
            if o["step"] is not None:
                d["step"] = o["step"]
            if o["ntt"] is not None:
                d["chem"]["nt$t"] = o["ntt"]
        for c, w in zip(conns, conn_ws):
            c["w"] = w
        done += n
    states, graphs, ys = [], [], {}
    for ls, lat, d, e, lid in zip(spec.lattices, lattices, lats, emits,
                                  plan["lat_ids"]):
        s = dict(lat.state)
        s["v"] = d["v"].reshape(-1)
        if "w" in s:
            s["w"] = d["w"].reshape(-1)
        s["last_firing_time"] = d["lft"].reshape(-1)
        s["is_spiking"] = d["spikes"].reshape(-1)
        if ls.model in REFRACTORY_MODELS:
            s["refractory_count"] = d["refr"].reshape(-1)
        if spec.chem:
            s.update((k, d["chem"][k]) for k in chem_out_keys(spec.chem))
        states.append(s)
        graphs.append(lat.graph.replace_weights(d["weights"])
                      if ls.kind != "plain" and ls.offsets else lat.graph)
        if ls.emit:
            ys.update(rebuilt_readouts(
                torch.cat(e), d["params"]["v_th"], d["params"]["c"],
                [(("lat", lid), lat.grid_history)], (lat.rows, lat.cols)))
    st_states = []
    for st, d in zip(sts, trains):
        s = dict(st.state)
        spk = d["spikes"].reshape(-1)
        s["is_spiking"] = spk
        s["v"] = torch.where(spk, s["v_th"], s["v_resting"])
        s["last_firing_time"] = d["lft"].reshape(-1)
        if "step" in d:
            s["step"] = d["step"].reshape(-1)
        if "chem" in d:
            s["nt$t"] = d["chem"]["nt$t"]
        st_states.append(s)
    conn_ws = [c["op"].w0 for c in entries]
    for ci, op, c in zip(spec.keep, ops, conns):
        conn_ws[ci] = c["w"].reshape(op.w0.shape)
    n_plain = len(plan["conns"])
    if reward is None:
        return states, st_states, graphs, conn_ws[:n_plain], ys, None
    ctr = {ci: {k: c[k].reshape(op.w0.shape) for k in ("c", "dw", "counter")}
           for ci, op, c, cs in zip(spec.keep, ops, conns, spec.conns)
           if cs.reward}
    return states, st_states, graphs, conn_ws[:n_plain], ys, dict(
        traces=[d.get("traces") for d in lats],
        rconns=[(conn_ws[ci], ctr.get(ci, entries[ci].get("trace0")))
                for ci in range(n_plain, len(entries))],
        dopamine=float(reward["dopamine"]))
