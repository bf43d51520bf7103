"""The plain reference against the port's kernel routes on the CPU (their
plain twins) at 16 x 16: the same inputs give the same bits."""

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from snnbench import catalog, session

SEED = 987654321012


def _drive(cell_name, cfg_name):
    cat = catalog.Catalog()
    cfg = cat.config(cfg_name)
    mix = dict(TINY[cell_name][1], v0=[-65.0, 30.0])
    snt = session.import_port(ROOT)
    kind = cat.module("traffic/kinds", mix["kind"])
    trial = getattr(cat.module("reference", cfg["reference"]), mix["kind"])
    graph, draws = kind.inputs(cfg, mix, SEED, torch.device("cpu"))
    drv = kind.Runner(snt, cfg, mix, graph, "cpu")
    out = []
    for _ in range(2):
        v0 = draws.next()
        drv.request(v0)
        assert drv.route_ok()
        out.append((drv.snapshot(), trial(cfg, mix, graph, v0)))
    return out


@pytest.mark.parametrize("cell,cfg", [("t_lattice", "izh_stencil"),
                                      ("t_reward", "izh_rstdp"),
                                      ("t_loop", "izh_rstdp")])
def test_reference_bit_equal_to_the_port(cell, cfg):
    fired = 0
    for prog, ref in _drive(cell, cfg):
        for k, want in ref.items():
            got = torch.as_tensor(prog[k]).to(want.dtype).reshape(want.shape)
            assert torch.equal(got, want), k
        fired += int((ref["lft"] >= 0).sum())
    assert fired > 0


def test_kernel_exp_matches_the_port():
    from spiking_neural_networks_tpu_torch.core.plasticity import \
        kernel_exp as port_exp
    ref = catalog.Catalog().module("reference", "izhikevich_lattice")
    x = torch.from_numpy(np.linspace(-110.0, 90.0, 200001, dtype=np.float32))
    assert torch.equal(ref.kernel_exp(x), port_exp(x))
    close = torch.exp(x.double()).float()
    ok = torch.isfinite(close) & (close > 1e-30)
    rel = ((ref.kernel_exp(x) - close).abs() / close)[ok]
    assert float(rel.max()) < 3e-7
