"""`why_not_fused` of the port (`spiking_neural_networks_tpu_torch.
diagnostics`) on the scenarios of ``tests/test_diagnostics.py``, built the
same way in both packages.  Contract: the verdict is empty exactly when
the port's router (`Lattice._kernel_route` / `RewardModulatedLattice.
_kernel_route`, asked as on the card) takes a kernel route, so a run with
``use_kernel=True`` sets ``_last_run_fused``; otherwise at least one
reason names the blocking condition.  Where the port's gates differ from
the JAX package's, the test names the difference:

* the JAX kernels' 128-lane layout (``cols > 128``) is a Mosaic limit:
  the port's kernels take any width;
* the port has no sharded lattice yet (``parallel/`` is not ported);
* JAX's checklist names a plain Morris-Lecar lattice's model family as a
  reason although its run takes the JAX model kernel (``_last_run_fused``
  is ``("model",)``): the port's verdict follows its route, ``[]``.
"""

import numpy as np
import pytest
import torch

import spiking_neural_networks_tpu as snn
import spiking_neural_networks_tpu_torch as snt

torch.set_num_threads(1)


def new(pkg, cls, model):
    kw = {"device": "cpu"} if pkg is snt else {}
    return getattr(pkg, cls)(model, **kw)


def lattice(pkg, rows=8, cols=8, radius=1.5, model=None):
    lat = new(pkg, "Lattice", model or pkg.Izhikevich())
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=radius, keep_prob=0.9, seed=1)
    return lat


def stdp(pkg, rows=8, cols=8):
    lat = lattice(pkg, rows, cols)
    lat.do_plasticity = True
    return lat


def bcm(pkg):
    lat = lattice(pkg, model=pkg.BCMIzhikevich())
    lat.do_plasticity = True
    lat.plasticity = pkg.BCM()
    return lat


def graph_history(pkg):
    lat = lattice(pkg)
    lat.update_graph_history = True
    return lat


def stdp_graph_history(pkg):
    lat = stdp(pkg)
    lat.update_graph_history = True
    return lat


def dense(pkg):
    lat = new(pkg, "Lattice", pkg.Izhikevich())
    lat.populate(4, 4, gap_conductance=10.0)
    rng = np.random.default_rng(0)
    lat.connect(lambda x, y: x != y and rng.random() < 0.5)
    return lat


def reward(pkg, rows=8, cols=8):
    lat = new(pkg, "RewardModulatedLattice", pkg.Izhikevich())
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=2)
    return lat


def hh_chemical(pkg):
    hh = new(pkg, "Lattice", pkg.HodgkinHuxley())
    hh.populate(8, 8, gap_conductance=10.0)
    hh.connect_stencil(radius=1.5, keep_prob=0.9, seed=3)
    hh.state = hh.model.insert_receptor(hh.state, "AMPA")
    hh.state = hh.model.insert_neurotransmitter(hh.state, "AMPA")
    hh.electrical_synapse = False
    hh.chemical_synapse = True
    return hh


def morris_lecar_history(pkg):
    ml = new(pkg, "Lattice", pkg.MorrisLecar())
    ml.populate(8, 8, gap_conductance=10.0)
    ml.connect_stencil(radius=1.5, keep_prob=0.9, seed=4)
    ml.update_grid_history = True
    return ml


def chemical_izhikevich(pkg):
    lat = lattice(pkg)
    lat.state = lat.model.insert_receptor(lat.state, "AMPA")
    lat.state = lat.model.insert_neurotransmitter(lat.state, "AMPA")
    lat.chemical_synapse = True
    return lat


def alif_stdp(pkg):
    lat = lattice(pkg, model=pkg.AdaptiveLeakyIntegrateAndFire())
    lat.do_plasticity = True
    return lat


def test_plain_electrical_lattice_fuses():
    assert snt.why_not_fused(lattice(snt)) == []


def test_stdp_lattice_fuses():
    assert snt.why_not_fused(stdp(snt)) == []


def test_bcm_plasticity_reason():
    reasons = snt.why_not_fused(bcm(snt))
    assert any("BCM" in r for r in reasons), reasons


def test_graph_history_plain_still_fuses():
    # the plain electrical Izhikevich stencil kernel runs under a weight
    # history (the weights do not move)
    assert snt.why_not_fused(graph_history(snt)) == []


def test_graph_history_blocks_stdp_class():
    reasons = snt.why_not_fused(stdp_graph_history(snt))
    assert any("graph" in r and "history" in r for r in reasons), reasons


def test_dense_graph_reason():
    lat = dense(snt)
    assert isinstance(lat.graph, snt.DenseGraph)
    reasons = snt.why_not_fused(lat)
    assert any("StencilGraph" in r for r in reasons), reasons


def test_wide_stdp_cols_fuses_in_the_port():
    """Difference: JAX declines cols=192 (its 128-lane layout); the
    port's plasticity kernel takes any width."""
    assert any("128" in r for r in snn.why_not_fused(stdp(snn, 4, 192)))
    assert snt.why_not_fused(stdp(snt, 4, 192)) == []


def test_reward_lattice_fuses_and_wide_fuses_in_the_port():
    assert snt.why_not_fused(reward(snt)) == []
    # difference: JAX declines the 192-wide reward lattice (128 lanes)
    assert any("128" in r for r in snn.why_not_fused(reward(snn, 4, 192)))
    assert snt.why_not_fused(reward(snt, 4, 192)) == []
    hist = reward(snt)
    hist.update_grid_history = True
    reasons = snt.why_not_fused(hist)
    assert any("history" in r for r in reasons), reasons


def test_no_shard_yet():
    """JAX ``test_sharded_plain_fuses_sharded_stdp_declines`` (the name
    is from before ``parallel/`` was ported): a sharded plain 32 x 32
    lattice takes the sharded stencil kernel route, a sharded STDP one
    declines for being sharded, as do a sharded reward lattice and one
    with a history; unsharded, both fuse."""
    from spiking_neural_networks_tpu_torch.parallel import make_lattice_mesh
    mesh = make_lattice_mesh(8, devices=[torch.device("cpu")] * 8)
    assert snt.why_not_fused(lattice(snt, 32, 32)) == []
    assert snt.why_not_fused(stdp(snt, 32, 32)) == []
    lat = lattice(snt, 32, 32)
    lat.shard(mesh)
    assert snt.why_not_fused(lat) == []
    lat.use_kernel = True
    lat.run_lattice(16)
    assert lat._last_run_fused[0] == "sharded"
    lat.update_grid_history = True
    assert any("history" in r for r in snt.why_not_fused(lat))
    for x in (stdp(snt, 32, 32), reward(snt, 32, 32)):
        x.shard(mesh)
        reasons = snt.why_not_fused(x)
        assert any("sharded" in r.lower() for r in reasons), reasons


def test_hh_chemical_fuses_model_history_declines():
    assert snt.why_not_fused(hh_chemical(snt)) == []
    reasons = snt.why_not_fused(morris_lecar_history(snt))
    assert any("histor" in r for r in reasons), reasons


SCENARIOS = {
    "plain": lattice, "stdp": stdp, "bcm": bcm,
    "graph_history": graph_history, "stdp_graph_history": stdp_graph_history,
    "dense": dense, "reward": reward, "hh_chemical": hh_chemical,
    "morris_lecar_history": morris_lecar_history,
    "chemical_izhikevich": chemical_izhikevich,
    "wide_stdp": lambda pkg: stdp(pkg, 4, 192),
    "wide_reward": lambda pkg: reward(pkg, 4, 192),
    "morris_lecar": lambda pkg: lattice(pkg, model=pkg.MorrisLecar()),
    "alif_stdp": alif_stdp,
    "radius_5": lambda pkg: lattice(pkg, 12, 12, radius=5.0),
    "electrical_hh": lambda pkg: lattice(pkg, model=pkg.HodgkinHuxley()),
}
# scenarios whose verdicts differ between the packages, and why
DIFFERENT = {"wide_stdp": "JAX's 128-lane layout",
             "wide_reward": "JAX's 128-lane layout",
             "radius_5": "80 offsets: JAX's per-step stencil kernel takes "
                         "them, the port's kernels at most 64",
             "morris_lecar": "JAX's checklist reason although its run "
                             "takes its model kernel"}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engagement_matches_explanation(name):
    """The verdict's emptiness equals a run's ``_last_run_fused`` (three
    steps with ``use_kernel=True``: the kernels' twins on the CPU), and
    the JAX verdict's emptiness where the gates agree."""
    t = SCENARIOS[name](snt)
    verdict = snt.why_not_fused(t)
    t.use_kernel = True
    if hasattr(t, "run_lattice_with_reward"):
        t.run_lattice_with_reward(0.1, 3)
    else:
        t.run_lattice(3)
    assert bool(t._last_run_fused) == (verdict == []), \
        (verdict, t._last_run_fused)
    assert all(isinstance(r, str) and r for r in verdict)
    j = snn.why_not_fused(SCENARIOS[name](snn))
    if name in DIFFERENT:
        assert (j == []) != (verdict == []), DIFFERENT[name]
    else:
        assert (j == []) == (verdict == []), (j, verdict)


def test_use_kernel_false_is_a_reason():
    lat = lattice(snt)
    lat.use_kernel = False
    assert snt.why_not_fused(lat) == [
        "use_kernel=False asks for the plain route"]
    b = bcm(snt)
    b.use_kernel = False
    reasons = snt.why_not_fused(b)
    assert reasons[0].startswith("use_kernel=False")
    assert any("BCM" in r for r in reasons[1:])


def test_unknown_type_raises():
    with pytest.raises(TypeError):
        snt.why_not_fused(object())
