"""The examples of the port, each the PyTorch counterpart of the script of
the same name in ``examples/`` (the reference's ``backend/examples/`` and
``interface/examples/``), on the port's core and `lixirnet`:

* lattices: ``lattice`` (a 10 x 10 stencil lattice, its voltage history
  saved), ``eeg_psd`` (an EEG readout and its power spectrum), ``raster``
  (a spike raster), ``stdp`` (an STDP lattice under Poisson input),
  ``rstdp_lattice`` (a reward schedule through R-STDP);
* networks: ``lattice_network`` (two coupled lattices and a Poisson
  train), ``interacting_pools`` (excitatory and inhibitory pools),
  ``synaptic_pruning`` (Hopfield recall under pruning), ``bcm`` (the BCM
  rule on a trained neuron);
* closed loops: ``agent_environment`` (`interactable.JitEnvironment`,
  R-STDP toward a target rate), ``lsm_architecture`` (a host-loop
  `Environment` over a reward-modulated network);
* meshes: ``sharded_lattice`` (row blocks over the devices there are),
  ``pipelined_network`` (a chain of lattices, one stage a device);
* single neurons and discrete attractors: ``hodgkin_huxley``,
  ``morris_lecar``, ``hopfield``.

Each runs on the card unless asked for another device: ``python -m
spiking_neural_networks_tpu_torch.examples.<name> [--device cpu]``.  The
NumPy generator draws stay in the JAX scripts' order, so one seed builds
the same lattices and networks."""

import argparse


def device_main(main, argv=None):
    """An example's command line: ``main(device=...)`` with ``--device
    {cuda,cpu}`` (``cuda`` by default) parsed from ``argv``."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return main(device=p.parse_args(argv).device)
