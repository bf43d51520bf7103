#!/usr/bin/env python3
"""Runs the PyTorch port's main paths on one NVIDIA GPU and checks them.

    python3 chip_smoke.py

The main paths, through the entry points a user calls, at 512 x 512 on a
radius-2, 80%-keep stencil graph:

* the electrical Izhikevich lattice (`Lattice` -> `populate` ->
  `connect_stencil` -> `apply` -> `run_lattice`) through the stencil
  kernel's three designs: at 512^2 the persistent one
  (``csrc/model_stencil.cu``, kind Izh: one cooperative launch per
  16-step call), at 1024^2, 2048^2 and 4096^2 the tiled one
  (``csrc/izhikevich_stencil.cu``, temporal blocking: K_b steps a launch),
  and at 2048^2 with per-neuron parameters the per-step one;
* the plain `Lattice` with STDP (``do_plasticity = True``) and the
  `RewardModulatedLattice` (`run_lattice_with_reward`, `run_lattice`),
  through the plasticity kernels ``csrc/lattice_plasticity.cu``;
* the plain `LatticeNetwork` (`Lattice` / `SpikeTrainLattice` ->
  `populate` -> `connect_stencil` -> `generate_network` ->
  `connect_vectorized` -> `run_lattices`) of BASELINE configs 2 and 5 and
  of config 5's topology at 512^2 / 256^2, through the persistent network
  kernel ``csrc/network_persistent.cu`` (one cooperative launch per
  16-step call; the per-step launches of ``csrc/network_plasticity.cu``
  are held and timed beside it);
* the Hodgkin-Huxley chemical lattice with STDP of BASELINE's "HH with ion
  channels + receptor kinetics + STDP" (`Lattice(HodgkinHuxley())` ->
  `populate` -> `insert_receptor` / `insert_neurotransmitter` ->
  `connect_stencil` -> `run_lattice`) at 128^2 and 512^2, through the HH
  kernel ``csrc/hh_chemical.cu``;
* `bench.py`'s chemical `LatticeNetwork` (two Izhikevich lattices with
  DopaGluGABA receptors and bounded kinetics, a Poisson glutamate drive:
  `Lattice` -> `populate` -> `connect_stencil` -> `insert_receptor` /
  `insert_neurotransmitter` -> `generate_network` -> `connect_vectorized`
  -> `chemical_synapse = True` -> `run_lattices`) at 64^2 and 512^2, and
  its form with a dopamine source, through the chemical arm of the network
  kernels (``csrc/network_plasticity.cu``, ``csrc/chem_common.cuh``);
* the upstream Bayesian-inference network (`Lattice(DopaIzhikevich())` ->
  `populate` -> `insert_receptor` / `insert_neurotransmitter` ->
  `connect` (a Hopfield weight matrix: a `DenseGraph`) ->
  `generate_network` -> `LatticeNetwork.connect` (dense blocks both ways,
  two Poisson cue lattices one to one) -> `chemical_synapse = True` ->
  `run_lattices`) at its own size, 7 x 7 + 3 x 3, and at flat mode's full
  width, 512 + 512 neurons with (512, 512) blocks, and an electrical dense
  network of 2 x 512 neurons, through the flat-mode arm of the network
  kernels (`net_dense_gather_kernel` in ``csrc/network_plasticity.cu``);
* `bench.py`'s reward network (`RewardModulatedLattice` -> `populate` ->
  `connect` (radius 2), a plastic `Lattice`, a Poisson train ->
  `generate_network` -> `connect` / `connect_with_reward_modulation` ->
  `run_lattices_with_reward(0.5, n)`) at 32^2 and 128^2 over 3000 steps
  and at 512^2 over 1024, through the persistent network kernel
  (``csrc/network_persistent.cu``; the per-step reward arm of
  ``csrc/network_plasticity.cu`` with 6a's R-STDP edge kernel held and
  timed beside it).
* `bench.py`'s closed loop (`RewardModulatedLattice` -> `populate` ->
  `connect_stencil` -> `apply` -> `JitEnvironment(agent, env, encoder,
  reward, update)` -> `run_with_reward(n)`: a 6-neuron cue, the reward
  ``clip(0.08 - rate, -0.05, 0.05)``, the rate of the mean spike) at its
  own size, 10 x 10 over 6400 steps, and at 512^2 over 1024, and the
  unsupervised loop (`JitEnvironment.run` on the STDP `Lattice`) at 512^2
  over 1024, through CUDA graphs of 16 closed-loop steps and a flush,
  each step the callbacks and one launch of the env entry of the
  plasticity kernels (`lattice_plasticity_env_step`: the previous step's
  edge pass, then this step; reward, dopamine and clock in device memory,
  ``csrc/lattice_plasticity.cu``): 17 launches per 16 steps.
* every other elementwise model (the integrate-and-fire family,
  `DopaIzhikevich`, `MorrisLecar`: `Lattice(model)` -> `populate` ->
  `connect_stencil` -> `apply` -> `run_lattice`) at 512^2, Morris-Lecar
  over 2048 steps and the others over 512, through the model kernel's
  persistent design (``csrc/model_stencil.cu``, one cooperative launch
  per 16-step call), and Morris-Lecar at 2048^2 over 1024 steps through
  its per-step design (the route where the plan cannot hold the weights);
  and the upstream BCM network (``examples/bcm.py``) on its plain
  route;
* three neurons of the DSL (`dsl.neuron_builder(source)[name]()` ->
  `Lattice` -> `populate` -> `connect_stencil` -> `apply` -> `run_lattice`:
  the DSL Izhikevich over 2048 steps, the DSL Hodgkin-Huxley over 1024,
  `DSL_BRANCHY` over 512) at 512^2 through kernel 4's DSL arm (a functor
  generated from each neuron's step by ``ops/dsl_kernels.py`` over
  ``csrc/model_stencil.cuh``, built by nvcc at first use; the persistent
  design), and the DSL Izhikevich at 2048^2 over 256 through its per-step
  design;
* a DSL neuron that calls sin, cos and tan (`TRIG_SOURCE`: tan of its
  input current, a sin / cos drive in dv/dt) at 512^2 over 512 steps
  through kernel 4's DSL arm (``kernel_sin`` / ``kernel_cos`` /
  ``kernel_tan`` of ``csrc/model_stencil.cuh``), the persistent design;
* the upstream Bayesian-inference trial through the port's `lixirnet`
  (``python -m spiking_neural_networks_tpu_torch.experiments.\
bayesian_inference_rate_based experiments/bayesian_inf_args/smoke.toml``:
  `run_trial` builds 7 x 7 excitatory + 3 x 3 inhibitory
  `IzhikevichNeuronLattice`s, two `RateSpikeTrainLattice` cues, the d1
  dopamine path, and runs 2500 steps, then scores peaks and correlation
  accuracy), and its memory-biases-memory form (``smoke_mbm_d2.toml``:
  five lattices, two cue trains, 600 steps), through the flat-mode arm of
  the persistent network kernel (``csrc/network_persistent.cu``).
* `parallel` on the card through virtual shards (one mesh that names
  cuda:0 four times; the blocks run one after another): the main
  lattice sharded in row blocks (`make_lattice_mesh` -> `Lattice.shard`
  -> `run_lattice`) at 512^2, 4096^2 and 2048^2 with per-neuron
  parameters through the sharded composition (the stencil kernel per
  block on its rows and 32 ghost rows, refreshed every 16 steps: the
  persistent, tiled and per-step designs), the 512^2 STDP lattice
  through the plain step per block, a 4-stage chain of 512^2 lattices
  and its R-STDP form through `run_lattices_pipelined` /
  `run_lattices_with_reward_pipelined`, and the batched (dp, tp) step.

Phases, one line each:

1. device: the card's name and power limit (nvidia-smi) and PyTorch's name;
2. build: nvcc builds every kernel from ``csrc/`` at first use;
3. the stencil kernel vs its plain twin on the card, at 64^2, 130 x 100,
   256^2, 512^2 (with emission too), 700^2, 1024^2, 2048^2 (uniform and
   per-neuron parameters) and 4096^2 in the routed design, so at every
   main path's shape in its design: lft, spikes and the bits of v and w
   equal, v_pre within rtol 1e-6, atol 1e-5;
   per-step times and bounds at 512^2 (K = 1 and 16) and 2048^2 (K = 8
   and 16); then each design (persistent, tiled, per step) on 33 x 70,
   130 x 100 and 256^2 x radius 1, 2 and 3 x emit off and on, a chain of
   calls of K = 1, 2, 7, 16 and 17 on one `StencilRun` (the tiled design
   on its streamed plan at radius 2 and 3, on the 2-D tiles at radius 1),
   and the 2-D tiles in every tile of `TILE_TRIALS` and one of K_b = 3:
   bit-equal, the launches the C entry counted equal to `call_launches`;
   the registers and spills of every new instantiation, and the streamed
   plan, its blocks and its shared memory at each shape the tiled route
   takes (`STREAM_SHAPES`);
4. the stencil main paths: 512^2 for 2048 steps (128 calls of one launch
   of the persistent design, counted by the C entry and in the profiler's
   records), 64 steps with a grid history, 1024^2, 2048^2 and 4096^2 for
   256 steps (the tiled design, ceil(16 / K_b) launches a call, every call
   on the streamed plan by `STREAMED_CALLS`) and 2048^2 with per-neuron
   parameters for 64 steps (the per-step design), the tiled and the
   per-step runs held bit for bit against the twin from the same state:
   routes, finite v, neurons fired;
5. 128^2 for 1000 steps: the stencil kernel route on the card against the
   same fused route on the CPU, within the reference's CPU-vs-GPU
   criterion (2 mV, 2 steps), and against the plain route on the card,
   which sums in another association: the two may part only at a
   threshold tie;
6. neuron-updates/s of both routes at 512^2 and of the kernel route at
   1024^2, 2048^2 and 4096^2; the designs in turns at 512^2, 700^2,
   736^2, 1024^2, 2048^2 and 4096^2, the tiled route's shapes with the 2-D
   tiles beside the streamed plan (wall, events, device time, kernel
   records against the launches the C entry counted, modelled bytes), the
   persistent design with and without emission at 512^2, the streamed
   plan against the 2-D tiles (`TILES2D`) at 2048^2 for radius 1, 1.5, 3
   and 4, and each tile of `TILE_TRIALS` at 2048^2;
7. the plasticity kernels vs their plain twin on the card, the fused
   schedule and the per-step design each: every kind x model at 64^2
   (K = 16 and 7) and on 33 x 70 (K = 1, 2 and 17), 130 x 100 with
   non-uniform parameters, two stencils past the shared-memory halo,
   512^2 STDP and R-STDP of every model, STDP ALIF and LIF at 128^2 and
   256^2: integers and spikes equal, floats bit-equal, the launches the C
   entry counted as each schedule has them; at 512^2, 256^2 and 128^2
   both designs timed in turns (wall, events, profiled device time with
   every kernel record counted);
8. the plasticity main paths: STDP `Lattice` 512^2 for 2048 steps and 64
   steps with a grid history; `RewardModulatedLattice` 512^2 for 2048
   steps with reward 0.5 and 256 without (17 launches a call, counted by
   the C entry and in the profiler's records); STDP on ALIF at 512^2 (the
   per-step design, 32 a call); both `bench.py` configurations at 64^2;
9. 64^2 for 500 steps, STDP and R-STDP: the kernel route on the card
   against the same route on the CPU (2 mV, 2 steps) and against the plain
   route on the card (parting only at a threshold tie);
10. steps/s and neuron-updates/s of the kernel and plain routes, STDP and
   R-STDP, at 64^2 and 512^2, with the kernels' device time per step;
11. the network kernels vs their plain twin on the card, the persistent
   kernel and the per-step design each bit for bit: config 2's and
   config 5's topologies at 64^2 (K = 16 and 7, Poisson from shared
   uniforms), ALIF and LIF networks with Rate trains, 130 x 100 with
   non-uniform parameters, 512^2 / 256^2 with an emitted history (every
   member resident in shared memory), and the streamed form, config 5's
   topology at 1024^2 / 512^2 (its excitatory stencil streamed), over 3
   calls along a run; the persistent kernel's registers, spills, shared
   memory, grid and the cost of one grid.sync(); at 512^2 both designs
   timed in turns (wall, CUDA events, profiled device time with every
   kernel record counted) and the host time of a persistent call split
   into checks, buffers and the rest;
12. the network main paths through `run_lattices`: config 2 at 64^2 for
   5000 steps, config 5 at 64^2 / 32^2 for 15000 steps with its EEG
   history, the 512^2 / 256^2 network for 2048 steps (launch counters,
   every call through the persistent kernel, finite v, neurons fired,
   weights moved, the kernel route);
13. the config-5 topology with a Rate train at 64^2 / 32^2 for 500 steps:
   the kernel route on the card against the same route on the CPU (2 mV,
   2 steps) and against the plain route on the card (parting only at a
   threshold tie);
14. steps/s, neuron-updates/s, device time per kernel and device / wall of
   the kernel route (`use_kernel=None`) and the plain route
   (`use_kernel=False`), config 5's topology at 64^2 and 512^2; then the
   persistent and the per-step design on the same 16-step calls, in turns
   (wall, events, profiled device time, kernel records per call);
15. the HH kernel vs its plain twin on the card: 64^2 at K = 16 and 7 for
   every kinetics pair, electrical and plasticity on and off; 130 x 100
   with non-uniform parameters; 512^2; and call by call the first 768
   steps of the 128^2 main paths (both forms fire within them), each call
   on the state it received: integers, spikes and was_increasing equal,
   floats within rtol 1e-6, atol 1e-5;
16. the HH main paths through `run_lattice`: 128^2 for 2000 steps in the
   firing form and in `bench.py`'s own form (gates at 0: every neuron
   fires once, all in one step, so no weight moves), 512^2 for 512 steps
   in the firing form (route "hh", kernel calls, finite state, neurons
   fired and weights moved);
17. 64^2 for 500 steps in the firing form: the HH kernel route on the card
   against the same route on the CPU (2 mV, 2 steps) and against the
   plain route on the card;
18. steps/s and neuron-updates/s of the HH kernel and plain routes at 128^2
   and 512^2, with the kernels' device time per step and device / wall;
19. the chemical arm vs its plain twin on the card: every receptor family x
   receptor kinetics x NT kinetics (40 random cases: nmda_mod != 1,
   electrical synapses on and off, STDP, Poisson and Rate trains,
   Izhikevich, ALIF and DopaIzhikevich lattices), then the chemical main
   paths through `run_lattices`, 64^2 for 2048 steps, the dopamine form
   for 1024, 512^2 for 1536, every call of the first 1280 steps (64^2;
   256 of the dopamine form and of 512^2) held
   against the twin on the state that call received, the rest of the run
   in one call: integers and spikes equal, floats within rtol 1e-6,
   atol 1e-5 (route ("chemical", False), kernel calls, finite state,
   neurons fired, transmitter received); per-step times and the bound at
   512^2;
20. the dopamine form with a Rate train at 64^2 for 500 steps: the kernel
   route on the card against the same route on the CPU (2 mV, 2 steps);
21. steps/s, neuron-updates/s, device time per kernel and device / wall of
   the chemical kernel and plain routes at 64^2 and 512^2;
22. the flat-mode arm vs its plain twin on the card: 30 random cases over
   electrical and chemical networks, both receptor families, the receptor
   and NT kinetics, dense graphs, dense blocks and both, Poisson and Rate
   trains (also into a dense block), Izhikevich, ALIF, LIF and
   DopaIzhikevich, N = 9, 49, 60, 200 and 512; then the three flat
   main paths through `run_lattices` (the Bayesian network for
   2500 steps at 7 x 7 + 3 x 3 and for 1024 at 512 + 512, with the cues
   firing and a grid history; the electrical dense network at 2 x 512 for
   1024), every call of the first 1024 steps held against the twin on the
   state that call received, the rest of the run in one call: everything
   bit-equal (route ("flat-chemical", True) or ("flat", False),
   kernel calls, finite state, neurons fired, transmitter received, the
   grid history equal to the twin's emitted rows); per-step times and the
   bound of the 512 + 512 call; `torch.mv` on a (512, 512) matrix as the
   library call of one dense gather;
23. the Bayesian network at 7 x 7 + 3 x 3 with its cues at rate 0 for 1000
   steps: the kernel route on the card against the same route on the CPU
   (2 mV, 2 steps; bit-equal expected);
24. steps/s, neuron-updates/s, device time per kernel and device / wall of
   the flat kernel route and the plain route on the three main paths;
25. the reward arm vs its plain twin on the card: 24 random networks over
   Izhikevich, ALIF and LIF, with and without rewards, static visit
   counts 0, 1 and 2, trains into plastic and reward lattices, plastic ->
   reward and reward -> reward connections, non-uniform states, the
   persistent kernel and the per-step design each; and every call of the
   first 256 steps of the 32^2 and 128^2 main paths on the state it
   received, traces and dopamine included: bit-equal;
26. the reward main paths through `run_lattices_with_reward`: route
   ("reward", False), reward-arm calls, every one through the persistent
   kernel, weights, traces and dopamine finite and moving (the reward
   lattice first fires after ~1500 steps, so its traces move in the
   3000-step runs); a call from a firing state held bit for bit; at 512^2
   (its mod lattice streamed, the other members resident) both designs
   timed in turns, the bound and the twin;
27. 32^2 with a Rate train and the reward lattice firing from the start,
   250 steps at reward 0.005: the kernel route on the card against the
   same route on the CPU (bit-equal), then against the plain route on the
   card (the tie rule); the flat COO runner (a `LatticeNetwork` subclass
   with a connecting-graph history) on the card against the CPU (the tie
   rule: ``index_add_`` sums in another order);
28. per main-path size: wall and CUDA-event time per step, the kernels'
   device time under torch.profiler and device / wall; then both designs
   on the same 16-step calls, in turns.
29. the env entry vs its plain twin on the card, in both designs (the
   fused launches of an `EnvChain`, and its per-step form): kinds mod and
   plain with a reward, plain and plastic without, x Izhikevich, ALIF and
   LIF x 64^2 and 130 x 100, 16 chained steps with the reward computed on
   the device and a flush, non-uniform states: bit-equal, the launches
   the C entry counted 17 (16 without plasticity) and 32; per kind 6a's
   `lattice_plasticity_steps` given the run's rewards by value, bit-equal;
   on the bench loop's agent at 512^2 and 10 x 10 both designs timed in
   turns (wall, events, profiled device time with every kernel record
   counted) against the twin and the bound, each design's final state
   held against the twin's steps from the same start;
30. the closed-loop main paths through `JitEnvironment` on tier (a) (a CUDA
   graph of 16 steps and a flush replayed), each one call with PyTorch's
   host syncs turned into errors around its steps: flags, launch counts
   (17 a replay, counted by the C entry), clock, finite state, weights,
   traces and dopamine moved, rewards varying at 10 x 10; one more replay
   of each held against the twin on the state it received, and one under
   the profiler with its 17 kernel records; two calls against one; every
   replay of the first 256 steps at 64^2 held against the twin; a grid
   history
   (tier (b)) and a callback that reads a value on the host (tier (b))
   against tier (a): bit-equal;
31. the loop at 64^2 over 512 steps: tier (a) on the card against the
   kernel tier on the CPU (bit-equal), and the kernel tier against the
   plain route on the card, at a tenth of the reward and at the bench's,
   under the tie rule while the weights stay within W_TIE, then max |dv|
   every 16 steps up to the first step over DRIFT;
32. per size (10 x 10, 128^2, 512^2): wall and CUDA-event time per step
   of tiers (a), (b) and the plain route, the kernel tiers' device time
   under torch.profiler and device / wall; the host-loop `Environment`'s
   steps/s at 10 x 10;
33. the model kernel vs its plain twin on the card, each call in the
   routed design and the per-step one: every model of the table (10
   kinds) x 64^2, 130 x 100 with non-uniform parameter planes and 512^2 x
   K = 16 and 7, and Morris-Lecar at 2048^2 for one call: integers,
   bools, spikes and firing times equal, floats within rtol 1e-6, atol
   1e-5; the registers and spills of every instantiation, and each
   model's plan at 512^2;
34. the model main paths through `run_lattice`: Morris-Lecar at 512^2 for
   2048 steps, the other models for 512 (the persistent design, one
   launch a call), Morris-Lecar at 2048^2 for 1024 (the per-step design,
   16), the first 4 calls of each held against the twin (route "model",
   kernel calls, the launches the C entry counted, finite state, neurons
   fired); ``examples/bcm.py``'s network over 2000 steps on its plain
   route (the flat COO runner with BCM), card vs CPU;
35. Morris-Lecar, DopaIzhikevich and AdEx at 128^2 for 500 steps: the
   kernel route on the card against the same route on the CPU (2 mV, 2
   steps) and against the plain route on the card (a threshold tie, or
   for Morris-Lecar a peak on another step);
36. Morris-Lecar and LIF at 512^2, 700^2 and 2048^2: neuron-updates/s of
   the kernel and plain routes, the routed design's device time under
   torch.profiler over 10 calls of one `ModelRun`, device / wall, the
   bound and the twin's time; at 512^2 and 700^2 both designs in turns
   (at 2048^2 the persistent design does not apply);
37. the DSL arm's build: the four generated sources (the three DSL models
   and phase 42's trig neuron) in one round of nvcc runs, each
   instantiation's registers and spills;
38. each generated kernel, each design, against its twin on the card:
   33 x 70, 130 x 100 and 256^2 x radius 1, 2, 3, and 512^2 at radius 2
   (the main path's instantiation), chained calls of K = 1, 2, 16, 17 on
   one `ModelRun` from random states: bit-equal, the launches the C entry
   counted;
39. the DSL main paths: 1 launch a 16-step call at 512^2 (counted by the
   C entry, equal to the profiler's records), 16 at 2048^2; the twin run
   from the same start first, call by call: the state after its last
   call with v finite bit-equal with v finite and neurons fired (the DSL
   HH's v turns NaN within its run, in the twin alike: its rates are
   0 / 0 at -40 and -55 mV exactly), the final state bit-equal;
40. the DSL Izhikevich against the hand-written `Izhikevich` at 128^2 over
   1000 steps (another association: spike counts within 2%, mean v within
   1 mV);
41. times of the DSL arm at 512^2 (both designs in turns) and 2048^2,
   each timed call from the applied state;
42. the trig neuron (sin, cos, tan): its kernel against its twin, chained
   calls of K = 1, 2, 16, 17 on one `ModelRun` from a random state, at
   512^2 in both designs and 2048^2 in the per-step one: bit-equal, the
   launches the C entry counted; its main path at 512^2 over 512 steps
   (one launch a 16-step call, counted by the C entry and in the
   profiler's records), the twin run first call by call and the final
   state bit-equal, v finite, neurons fired; its times at 512^2, both
   designs in turns;
43. the Bayesian trial of ``smoke.toml`` (2500 steps) and of
   ``smoke_mbm_d2.toml`` (600) through `run_trial` on the card: route
   ("flat-chemical", True), every kernel call through the persistent
   kernel (its launch counter), every state finite, neurons fired; the
   same trial on the CPU (the same kernel route, the twin) held against
   it over its first 1000 steps as phase 23 holds the Bayesian network
   (each excitatory grid history within 2 mV; each neuron's peaks above
   20 mV, the trial's own spikes, within 2 steps); both routes' value
   dicts; the trial's first 16-step call against the twin (bit-equal),
   its bound and `torch.mv` on its (49, 49) weights;
44. the trials' times: wall seconds per trial, best of 3 after a warm-up
   (as ``bench.py:577-586`` times it), split into construction, run and
   analysis; the profiled device time per step of the run; the plain
   route's wall for one trial;
45. the host graph builder (``_native``, built by g++ at its first
   import): `ops.graph.sparse_radius_graph` at 512^2 and 2048^2 (radius
   2, keep 0.8) on its native and its NumPy branch, host seconds and
   edges; the native library must have built;
46. `why_not_fused` on one lattice of each family (the stencil at 512^2,
   at 2048^2 with per-neuron parameters, STDP, R-STDP, the HH firing
   form, Morris-Lecar, the DSL Izhikevich, the DSL HH and the trig
   neuron, at 64^2) and on four that stay plain (BCM, STDP with a graph
   history, a chemical Izhikevich lattice, a `DenseGraph`): after 16
   steps the verdict is ``[]`` exactly when the run took a kernel route;
47. checkpoints (`utils.checkpoint`): run k steps, save, run k more, load
   into the same object, run k again: bit-equal to the uninterrupted run
   (states, weights, traces, dopamine, clocks; the network generator
   restored) and the kernel route on both halves, for the 512^2 main path
   (k = 1024), the 512^2 R-STDP lattice (512), config 5 at 64^2 / 32^2
   with its Poisson train (512), `bench.py`'s reward network at 128^2
   (512) and the 2048^2 main path (256); save and load seconds and bytes;
48. BCM on a reward network's plain lattices (JAX
   ``tests/test_fuzz_runners.py``'s BCM pair, a `BCMIzhikevich` reward
   lattice and a BCM Poisson train) at 64^2 for 300 steps at reward 0.5,
   through the structured and the flat COO runner: the plain route,
   weights moved, the card against the CPU (2 mV, 2 steps, weights within
   rtol 2e-4, atol 2e-4), us/step;
49. `fitting`: JAX ``tests/test_analysis.py:133``'s fit on the card
   (Izhikevich ``a`` from a Rate train's summary, 400 iterations, n_pop
   32, n_iter 10): the fitted summary within rtol 0.1, atol 2 of the
   reference and a score below 1; one generation's scores on the card
   equal to the CPU's for the same population; seconds per generation and
   us per coupled step;
50. `utils.profiling`: `StepTimer` on the 512^2 main path (2048 steps),
   and `trace()` around one 64-step call, whose Chrome trace must hold a
   `model_persistent_kernel` record;
51. the sharded composition: `main_lattice` at 512^2 (2048 steps), 4096^2
   (64) and `hetero_lattice` at 2048^2 (64), each built once and copied,
   run unsharded (the kernel route) and sharded over 4 virtual shards of
   cuda:0 with the counts set to 0 just before the sharded run and read
   just after: route ("sharded", designs, K 16, g 32) with the
   persistent, tiled and per-step design in every block, calls and C-entry
   launches 512 / 64 / 256, the state bit-equal to the unsharded run, the
   blocks and their overlap (extended / owned rows); then a further run
   of each in turns, wall and CUDA-event us/step, and 16 steps of the
   sharded lattice on the plain route per block (``use_kernel=False``);
52. the sharded plain route: the 512^2 STDP lattice over 4 virtual shards
   for 256 steps (`lattice_step` per block, ghost rows of the state and
   weights refreshed each step) bit-equal to the unsharded plain route,
   weights moved;
53. pipelines: a 4-stage chain of 512^2 lattices (one-to-one links) for
   512 steps and its R-STDP form for 256 on [cuda:0] x 4 against
   `run_lattices` / `run_lattices_with_reward` with `use_kernel=False`
   (rtol 2e-5, atol 2e-4, firing agreement above 99%; in fact bit-equal);
54. the batched (dp, tp) step: B = 8, N = 1024 over dp = 2, tp = 2
   virtual shards for 16 steps against the unsharded step (rtol 1e-5,
   atol 1e-4), then both timed in turns;
55. one host: `parallel.initialize_multihost()` is a no-op and
   `make_hybrid_mesh()` is (1, n_local).

56. the science pipelines of ``spiking_neural_networks_tpu_torch/
   experiments/`` (the port of ``experiments/``) through lixirnet and the
   core on the card, each at its users' widths (`EXP_KERNEL`,
   `EXP_PLAIN`): the route of every run held to the route both gates give
   on the CPU; the kernel pipelines at a comparison depth with every
   chance of firing forced to 0 or 1, the plain ones at their cut depth;
57. each kernel pipeline at its users' depth (a committed reference
   TOML's first grid point, or `main`'s defaults): the network kernel's
   counts set to 0 just before it, every call through the persistent
   kernel (counted by the C entry), the first 2 calls bit-equal to the
   twin, every state finite, neurons fired, the JAX script's output keys;
   its comparison run on the CPU's twin route bit for bit (histories,
   firing times, output) and on the card's plain route (another
   association: max |dv| and the first step past 1e-3 mV printed);
58. each plain pipeline (the head-direction rings, the Tolman-Eichenbaum
   walk) against the same run on the CPU within 2 mV and 2 steps;
59. each pipeline's seconds of construction, run and analysis, wall and
   profiled device us/step, device / wall;
60. the liquid pipelines of ``spiking_neural_networks_tpu_torch/
   experiments/`` (``liquid_state_machine``, ``liquid_manifold_generation``,
   ``training_liquid_pipeline``, ``liquid_manifold_digits``) and the 16
   examples of ``spiking_neural_networks_tpu_torch/examples/``, each
   built on the card and run at its comparison depth (chances forced to 0
   or 1 where it draws): every run's route held to the one both gates
   give on the CPU;
61. each kernel path (the liquids; ``lattice``, ``eeg_psd``,
   ``lattice_network``, ``synaptic_pruning``, ``interacting_pools``,
   ``agent_environment``, ``sharded_lattice``) at its own size: launches
   of rows 2, 6a, 6b, 6b-flat and 6d counted by the C entries, the first
   two kernel calls (the closed loop: two graph replays) bit-equal to
   the twin, finite, firing; its comparison run on the CPU's twin route
   bit for bit (an average or EEG history, a sum over the lattice, within
   1e-6 of its scale), and on the card's plain route under the tie rule;
62. each plain path (``rstdp_lattice``, ``lsm_architecture``,
   ``pipelined_network``, ``stdp``, ``bcm``, ``raster``,
   ``hodgkin_huxley``, ``morris_lecar``, ``hopfield``): plain, finite,
   and its comparison run on the card against the CPU within 2 mV / 2
   steps;
63. each entry point's seconds of construction, run and analysis, wall
   and profiled device us/step, device / wall.

The kernels line marks rows 1-3 (the stencil kernel's three designs)
with the launches the sharded composition made of each in phase 51
(``composition_launches``), rows 6b and 6b-flat with the persistent
launches of each science pipeline in phase 57 (``pipeline_launches``),
and rows 2, 6a, 6b, 6b-flat and 6d with the launches of the liquids and
the examples in phase 61 (``entry_launches``).

The DSL family (phases 37-42), the support modules (45-50), the trial
(43-44), the science pipelines (56-59) and the entry points (60-63) run
first: late in a long run the profiler keeps fewer kernel
records of every family, and a counted profile of the DSL main path once
lost all in eight tries (a library loaded late is not the cause:
``tools/profiler_records.py``).  The `parallel` phases (51-55) run last:
they count C-entry launches and time with CUDA events, no profile.

Every time is printed beside the card's name and power limit.  Then a line
with the card's name and power limit as nvidia-smi gives them, a JSON line
with each kernel's launches, error, times and bound (the least time the
card could take for a call: the larger of its bytes, each input read and
each output written once, over 3.35 TB/s and its operations over 67
TFLOP/s), and last the JSON contract line.  Any failure raises, and the exit code is not 0.  Without a CUDA
device the script exits with an error before it prints any result.
"""

import ctypes
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

RTOL, ATOL = 1e-6, 1e-5
# Largest |dv| (mV) between the fused and the plain route before their first
# threshold tie; 1000 steps at up to 64 x 64 keep it below 3e-5.
DRIFT = 1e-3
UNIFORM = dict(a=0.02, b=0.2, c=-55.0, d=8.0, v_th=30.0,
               gap_conductance=10.0, tau_m=1.0, c_m=100.0, dt=0.1)
# Shapes of the phases; CASES are ((rows, cols), K, emit, uniform params).
MAIN, MAIN_STEPS, HIST_STEPS = (512, 512), 2048, 64
BIG, BIG_STEPS = (2048, 2048), 256
# the tiled design's main paths (BIG_STEPS each), and the per-step one's:
# BIG with per-neuron a, d and v_th
TILED_MAINS = ((1024, 1024), BIG, (4096, 4096))
HETERO_STEPS = 64
CMP, CMP_STEPS = (128, 128), 1000
PLAIN_TIME_STEPS = 512      # of the plain route's timed runs at 512^2
CASES = [((64, 64), 1, False, True), ((64, 64), 16, True, True),
         ((130, 100), 16, True, False), ((256, 256), 16, True, False),
         (MAIN, 1, False, True), (MAIN, 16, False, True),
         (MAIN, 16, True, True), ((700, 700), 16, True, True),
         ((1024, 1024), 16, False, True), (BIG, 8, False, True),
         (BIG, 16, False, True), (BIG, 16, False, False),
         ((4096, 4096), 16, False, True)]
# the design each main path's shape takes (phase 4), which CASES must hold
# against the twin at that shape
MAIN_DESIGNS = ({("persistent", MAIN), ("per_step", BIG)}
                | {("tiled", shape) for shape in TILED_MAINS})
# each design on these shapes and stencil radii, emit off and on, a chain
# of calls of DESIGN_KS steps on one StencilRun
DESIGN_SHAPES = ((33, 70), (130, 100), (256, 256))
DESIGN_RADII = (1.0, 2.0, 3.0)
DESIGN_KS = (1, 2, 7, 16, 17)
TURN_SHAPES_STENCIL = (MAIN, (700, 700), (736, 736), (1024, 1024), BIG,
                       (4096, 4096))
# the shapes the tiled design's route takes, whose streamed plans phase 3
# prints: the main paths and phase 51's sharded 4096^2 blocks (1024 rows
# and 32 ghost rows on one side or both)
STREAM_SHAPES = ((736, 736), (1024, 1024), BIG, (4096, 4096), (1056, 4096),
                 (1088, 4096))
# the tiled design's 2-D tiles (interior rows, interior columns, K_b) timed
# against each other at 2048^2, radius 2 (the fastest, (48, 48, 4), is
# `sk.TILE`, which a reach of 1 takes)
TILE_TRIALS = ((48, 48, 4), (28, 28, 4), (56, 56, 2), (32, 32, 4),
               (40, 40, 3), (24, 24, 4), (32, 32, 2), (16, 16, 2),
               (16, 16, 1))
# the 2-D tile timed beside the streamed plan at each stencil reach: the
# tiled design's plan there before the streamed one (at 2 the fastest of
# TILE_TRIALS, at 3 and 4 the widest that fits the shared memory)
TILES2D = {1: (48, 48, 4), 2: (48, 48, 4), 3: (32, 32, 2), 4: (16, 16, 2)}
# the TPU kernel each design replaces: the whole-lattice multistep kernel
# (persistent), the row-tiled one (tiled), the per-step one (per step)
REPLACES = {"persistent": "spiking_neural_networks_tpu/ops/"
                          "pallas_stencil.py:251",
            "tiled": "spiking_neural_networks_tpu/ops/pallas_stencil.py:482",
            "per_step": "spiking_neural_networks_tpu/ops/"
                        "pallas_stencil.py:94"}
# Plasticity phases.  PCASES are ((rows, cols), K, kind, model,
# with_reward, uniform params, emit).
SMALL, PCMP_STEPS = (64, 64), 500
PCASES = ([((64, 64), k, kind, model, rew and kind != "plastic", True, False)
           for k, rew in ((16, True), (7, False))
           for kind in ("plastic", "mod", "plain")
           for model in ("izhikevich", "alif", "lif")]
          + [((130, 100), 16, "mod", "izhikevich", True, False, True),
             ((130, 100), 16, "plastic", "alif", False, False, False),
             ((130, 100), 16, "plain", "lif", True, False, False),
             (MAIN, 16, "plastic", "izhikevich", False, True, True),
             (MAIN, 16, "mod", "izhikevich", True, True, True)])
# the fused schedule's extra cases: K of 1, 2 and 16 + 1 on a grid whose
# width is not a multiple of the 32-column tile and whose last tile row is
# partial, every model x kind x reward
SCHED_CASES = [((33, 70), k, kind, model, rew, False, False)
               for k in (1, 2, 17)
               for kind, rew in (("plastic", False), ("mod", True),
                                 ("mod", False), ("plain", True),
                                 ("plain", False))
               for model in ("izhikevich", "alif", "lif")]
# the other models at the main size, both designs timed in turns; STDP
# at 128^2 and 256^2 too
TURN_CASES = ([(MAIN, 16, kind, model, kind == "mod", True, False)
               for kind in ("plastic", "mod") for model in ("alif", "lif")]
              + [((n, n), 16, "plastic", model, False, True, False)
                 for n in (128, 256) for model in ("alif", "lif")])
TURN_SHAPES = (MAIN, (128, 128), (256, 256))
# a stencil wider than the kernel's shared-memory halo (LP_HALO_MAX 8):
# its edge pass and phase A read global memory
WIDE_OFFSETS = ((0, 1), (1, 0), (0, -10), (-9, 3), (2, 2), (12, -12))
WIDE_CASES = [((33, 70), 17, kind, "izhikevich", rew, False, True,
               WIDE_OFFSETS)
              for kind, rew in (("plastic", False), ("mod", True))]
# steps of a main path profiled for its kernel records
RECORD_STEPS = 64
# R-STDP parameters of the kernel-vs-twin cases: bounded weights, traces
# and dopamine over a call, with the trace decay exp(-dt / tau_c) = 0.82
RSTDP = dict(tau_d=2.0, tau_c=0.5, a_plus=0.02, a_minus=0.02)
# the bench's reward; and the reward of the 1000-step comparisons, where
# 0.5 would drive the dopamine to ~2000 and the weights without bound
REWARD, CMP_REWARD = 0.5, 0.005
PLASTIC_REPLACES = "spiking_neural_networks_tpu/ops/pallas_reward.py:1177"
PROFILE_STEPS = 256
# Network phases.  The network builders take (snt, rows, cols, use_kernel,
# device, seed) and set up the network before its first step.
NSMALL, NBIG = (64, 64), (512, 512)
CFG2_STEPS, CFG5_STEPS, NBIG_STEPS, NCMP_STEPS = 5000, 15000, 2048, 500
# the persistent kernel's streamed form: config 5's topology at 1024^2 /
# 512^2 (its excitatory stencil, 63 MB, does not fit the blocks' shared
# memory), a few calls along a run
NHUGE, NHUGE_CALLS = (1024, 1024), 3
NET_REPLACES = "spiking_neural_networks_tpu/ops/pallas_reward.py:1177"
# HH phases.  HCASES are ((rows, cols), K, nt kinetics, rec kinetics,
# electrical, plastic, non-uniform params); a case's seed is its index.  A
# random state far from rest can go non-finite within a call, as 512^2
# from seed 35 did on an H100: explicit Euler on the m gate is unstable
# below about -135 mV (4 exp(-(v + 65) / 18) dt > 2).
HH_KINDS = [(nt, rec) for nt in ("destexhe", "approximate")
            for rec in ("destexhe", "approximate")]
HMAIN, HBIG = (128, 128), (512, 512)
HMAIN_STEPS, HBIG_STEPS, HCMP_STEPS, HCMP_EVERY = 2000, 512, 500, 8
# the steps of a 128^2 main path held call by call against the twin: both
# forms fire within them (near steps 50-100 and 580)
# the main path's calls held against the twin: the bench.py form (it fires
# once, every neuron in one step, before step 768) and the firing form
HTWIN_STEPS = {False: 768, True: 256}
HCASES = ([((64, 64), k, nt, rec, el, pl, False) for k in (16, 7)
           for nt, rec in HH_KINDS for el in (True, False)
           for pl in (True, False)]
          + [((130, 100), 16, "destexhe", "destexhe", True, True, True),
             ((130, 100), 7, "approximate", "approximate", False, True,
              True),
             (HBIG, 16, "destexhe", "destexhe", True, True, False),
             (HMAIN, 16, "destexhe", "destexhe", True, True, False)]
          # the fused schedule at K of 1, 2 and 16 + 1
          + [((33, 70), k, nt, rec, True, True, True) for k in (1, 2, 17)
             for nt, rec in HH_KINDS[::3]])
HH_REPLACES = "spiking_neural_networks_tpu/ops/pallas_hh.py:262"
# STDP of the firing form: the bench's amplitudes (2.0) drive weights
# negative there and the lattice to -inf within ~430 steps (the JAX package
# does the same); 0.02 moves the weights and keeps the lattice finite
HH_STDP = dict(a_plus=0.02, a_minus=0.02)
# Largest |dv| (mV) between the HH kernel and plain routes before their
# first firing-time difference: mid-upstroke dynamics amplify the last
# ulps of exp and of the plain route's divisions (a multiply by the
# reciprocal on the card) to 6e-4 mV on the CPU and 9.7e-3 mV on the card
# at 64^2 over 1000 steps
HH_DRIFT = 5e-2
# Chemical network phases: bench.py's chemical network at 64^2 and 512^2
# (its lattice 0 first fires near step 1100, lattice 1 not within 2048
# steps), its dopamine form at 64^2, and the card-vs-CPU run at 64^2.
CMAIN, CBIG = (64, 64), (512, 512)
CMAIN_STEPS, CBIG_STEPS, CDOPA_STEPS, CCMP_STEPS = 2048, 1536, 1024, 500
# of each chemical main path, held call by call to the twin: the 64^2
# bench.py form past lattice 0's first firing; the dopamine form (which
# fires from the start) and the 512^2 form over their first 256 steps
CTWIN_STEPS, CTWIN_SHORT = 1280, 256
# the kernel-vs-twin cases' shapes, taken in turn
CSHAPES = [(10, 12), (64, 64), (33, 70)]
CHEM_REPLACES = "spiking_neural_networks_tpu/ops/pallas_reward.py:1177"
# Flat-mode phases: the Bayesian-inference network (an excitatory
# Hopfield-dense DopaIzhikevich lattice, an inhibitory pool, dense blocks
# both ways, two Poisson cue lattices) at the upstream size and at the flat
# mode's full width, N = 512 per lattice and block side, and the electrical
# dense network at N = 512.  (exc shape, inh shape) pairs.
BAYES, BAYES_BIG = ((7, 7), (3, 3)), ((16, 32), (16, 32))
BAYES_STEPS, BAYES_BIG_STEPS, FCMP_STEPS = 2500, 1024, 1000
FTWIN_STEPS = 256      # of each flat main path, held call by call to the twin
DENSE_N, DENSE_STEPS = 512, 1024
CUE_HERTZ = (20.0, 10.0)
FLAT_NS = (9, 49, 60, 200, 512)
FLAT_MODES = ("intra", "block", "both")
FLAT_REPLACES = "spiking_neural_networks_tpu/ops/pallas_reward.py:1177"
# Reward-network phases: bench.py's reward network (`bench.py:330-366`) at
# its two sizes over 3000 steps and at 512^2 over 1024; every call of the
# first RTWIN_STEPS of a main path held against the twin (up to
# RTWIN_MAX neurons per lattice); the random cases' shapes, taken in turn.
RMAINS = (((32, 32), 3000), ((128, 128), 3000), ((512, 512), 1024))
RTWIN_STEPS, RTWIN_MAX = 256, 128 * 128
# at most this many steps past a main path for its reward lattice to fire
RFIRE_MAX = 4096
RSHAPES = ((8, 9), (64, 64), (33, 70), (130, 100))
RCMP, RCMP_STEPS, RFLAT_STEPS = (32, 32), 250, 500
RTIMES = (((32, 32), 1024), ((128, 128), 1024), ((512, 512), 512))
REWARD_REPLACES = "spiking_neural_networks_tpu/ops/pallas_reward.py:1183"
# Closed-loop phases: bench.py's closed loop (`bench.py:387-444`) at its own
# size and at 512^2, the unsupervised loop at 512^2, one graph replay of
# each held against the twin; every replay of the first ETWIN_STEPS of the
# loop at ETWIN held against the twin, and a grid history there; the env
# entry's random cases over ENV_KINDS x models x ESHAPES, and its time at
# EBIG on the bench loop's agent over ETIME_REPS calls, each held against
# the twin.
EMAINS = (("bench", (10, 10), 6400), ("bench", (512, 512), 1024),
          ("unsup", (512, 512), 1024))
ETWIN, ETWIN_STEPS, EHIST_STEPS = (64, 64), 256, 512
ENV_KINDS = (("mod", True), ("plain", True), ("plain", False),
             ("plastic", False))
# EPROF calls under torch.profiler: a single profiled call can lose its
# first kernels' records
ESHAPES, EBIG, ETIME_REPS, EPROF = ((64, 64), (130, 100)), (512, 512), 4, 10
# phase 31 runs in calls of ECMP_CHUNK steps and holds the kernel and plain
# routes to the tie rule over the steps before either route's weights pass
# W_TIE: R-STDP at the bench's reward grows them by ~0.12 a step, and the
# gap input, scaled by the weights, carries the two associations' rounding
# apart by more than DRIFT without a tie once they pass ~50
ECMP, ECMP_STEPS, ECMP_CHUNK, W_TIE = (64, 64), 512, 8, 32.0
ETIMES = (((10, 10), 512), ((128, 128), 512), ((512, 512), 512))
EPLAIN_STEPS, EHOST_STEPS, ERNG_STEPS = 128, 256, 320
ENV_REPLACES = "spiking_neural_networks_tpu/ops/pallas_reward.py:338"
# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, FP32 op/s,
# FP64 op/s outside the tensor cores
PEAK_BYTES, PEAK_OPS, PEAK_OPS_F64 = 3.35e12, 67e12, 34e12
# its L2 cache: a step that moves more than this reads from HBM, so its
# device time must not beat PEAK_BYTES
L2_BYTES = 50e6
# profiles taken for a count of kernel records before profiled_us fails
PROF_TRIES = 8
# float operations the card needs for one exp: a range reduction (two
# multiply-adds), the special-function unit's ex2 and a scale; the port's
# kernel_exp takes more, to round as the CPU does, which the bound does not
# charge
EXP_OPS = 4
# Model-kernel phases (kernel 4, `ops/model_kernels.py`): the models of its
# table by port class name ("-chemical": with chemical_normalization), and
# the float operations of one step of each, counted from its source (a
# transcendental as EXP_OPS and its few operations around exp), for the
# bound
MODELS = ("LeakyIntegrateAndFire", "QuadraticIntegrateAndFire",
          "AdaptiveLeakyIntegrateAndFire", "AdaptiveExpLeakyIntegrateAndFire",
          "DopaIzhikevich", "LeakyIzhikevich", "BCMIzhikevich",
          "BCMIzhikevich-chemical", "SimpleLeakyIntegrateAndFire",
          "MorrisLecar")
MODEL_OPS = {"LeakyIntegrateAndFire": 15, "QuadraticIntegrateAndFire": 16,
             "AdaptiveLeakyIntegrateAndFire": 25,
             "AdaptiveExpLeakyIntegrateAndFire": 29 + EXP_OPS,
             "DopaIzhikevich": 20, "LeakyIzhikevich": 22,
             "BCMIzhikevich": 33, "BCMIzhikevich-chemical": 32,
             "SimpleLeakyIntegrateAndFire": 7, "MorrisLecar": 48 + 3 * EXP_OPS}
# The firing forms of the models that sit still at their defaults: LIF,
# ALIF and AdEx leak towards an e_l above v_th, so they fire tonically
# through their refractory windows; QIF's reset is a root of its dv, so
# with v_reset above v_th it fires as each refractory window ends;
# LeakyIzhikevich's leak term w (v - e_l) holds it below threshold at its
# default w of 30, so its firing form starts at w 0
MODEL_OVERRIDES = {"LeakyIntegrateAndFire": {"e_l": -40.0},
                   "QuadraticIntegrateAndFire": {"v_reset": -50.0},
                   "AdaptiveLeakyIntegrateAndFire": {"e_l": -20.0},
                   "AdaptiveExpLeakyIntegrateAndFire": {"e_l": -20.0},
                   "LeakyIzhikevich": {"w": 0.0}}
# phase 33's shapes (130 x 100 with non-uniform parameters) and its large
# Morris-Lecar call; the main paths (the first MHELD calls of each held
# against the twin); the card-vs-CPU and kernel-vs-plain runs; the timed
# models at (shape, kernel-route steps, plain-route steps)
MSHAPES, MBIG = ((64, 64), (130, 100), (512, 512)), (2048, 2048)
MMAIN, MMAIN_STEPS, MIF_STEPS, MHELD = (512, 512), 2048, 512, 4
MCMP, MCMP_STEPS = (128, 128), 500
MCMP_MODELS = ("MorrisLecar", "DopaIzhikevich",
               "AdaptiveExpLeakyIntegrateAndFire")
MTIME_MODELS = ("MorrisLecar", "LeakyIntegrateAndFire")
MTIMES = (((512, 512), 512, 32), ((700, 700), 256, 16),
          ((2048, 2048), 128, 8))
# the main path at MBIG (the per-step design's route)
MBIG_STEPS = 1024
BCM_STEPS = 2000
MODEL_REPLACES = "spiking_neural_networks_tpu/ops/pallas_stencil.py:792"
# DSL phases (kernel 4's DSL arm, `ops/dsl_kernels.py`): three neurons of
# the DSL, by type name, from the JAX package's tests (the DSL Izhikevich
# of `tests/test_dsl.py:12-25`, the DSL Hodgkin-Huxley of
# `tests/test_dsl_reference_suite.py:57-101`: three ion channels, gating
# variables, `^`, `continuous()`, and `DSL_BRANCHY` of
# `tests/test_pallas_model.py:38-56`: [if] / [else], a user function)
DSL_SOURCES = {
    "DSLIzhikevich": """
[neuron]
    type: DSLIzhikevich
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i) / c_m
[end]
""",
    "DSLHodgkinHuxley": """
[ion_channel]
    type: DSLNa
    vars: e = 50, g = 120
    gating_vars: m, h
    on_iteration:
        m.alpha = 0.1 * ((v + 40.) / (1. - exp(-(v + 40.) / 10.)))
        m.beta = 4. * exp(-(v + 65.) / 18.)
        h.alpha = 0.07 * exp(-(v + 65.) / 20.)
        h.beta = 1. / (exp(-(v + 35.) / 10.) + 1.)
        m.update(dt)
        h.update(dt)
        current = m.state ^ 3 * h.state * g * (v - e)
[end]

[ion_channel]
    type: DSLK
    vars: e = -77, g = 36
    gating_vars: n
    on_iteration:
        n.alpha = 0.01 * (v + 55.) / (1. - exp(-(v + 55.) / 10.))
        n.beta = 0.125 * exp(-(v + 65.) / 80.)
        n.update(dt)
        current = n.state ^ 4 * g * (v - e)
[end]

[ion_channel]
    type: DSLKLeak
    vars: e = -55, g = 0.3
    on_iteration:
        current = g * (v - e)
[end]

[neuron]
    type: DSLHodgkinHuxley
    ion_channels: na = DSLNa, k = DSLK, kleak = DSLKLeak
    vars: v_th = 0, c_m = 1
    spike_detection: continuous()
    on_iteration:
        na.update_current(v)
        k.update_current(v)
        kleak.update_current(v)
        dv/dt = (i - (na.current + k.current + kleak.current)) / c_m
[end]
""",
    "KernelBranchy": """
[neuron]
    type: KernelBranchy
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100, boost = 1.5
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        gain(x) = max(x, 0.5)
        [if] v < -60 [then]
            dv/dt = (0.04 * v * v + 5 * v + 140 - w + i * boost) / c_m
        [else]
            dv/dt = (0.04 * v * v + 5 * v + 140 - w + i * gain(boost - 1)) / c_m
        [end]
        dw/dt = (a * (b * v - w)) / tau_m
[end]
""",
}
# the kernel-vs-twin cases: shapes x stencil radii, chained calls of DSL_KS
# steps on one ModelRun, each design
DSL_SHAPES = ((33, 70), (130, 100), (256, 256))
DSL_RADII = (1.0, 2.0, 3.0)
DSL_KS = (1, 2, 16, 17)
# the main paths at DMAIN (the persistent design): steps per model; the
# DSL Izhikevich at DBIG (the per-step design) over DBIG_STEPS; the
# comparison with the hand-written Izhikevich at DCMP over DCMP_STEPS
DMAIN = (512, 512)
DMAIN_STEPS = {"DSLIzhikevich": 2048, "DSLHodgkinHuxley": 1024,
               "KernelBranchy": 512}
DBIG, DBIG_STEPS = (2048, 2048), 256
DCMP, DCMP_STEPS = (128, 128), 1000
# the parameters of each model drawn within 20% of their defaults in the
# kernel-vs-twin cases (HH keeps its defaults: its rates are stiff)
DSL_RANDOM_PARAMS = {"DSLIzhikevich": ("a", "b", "c", "d", "v_th", "c_m"),
                     "TrigNeuron": ("a", "b", "c", "d", "v_th", "c_m"),
                     "KernelBranchy": ("a", "b", "c", "d", "v_th", "c_m",
                                       "boost"),
                     "DSLHodgkinHuxley": ()}
# float operations of a generated step's kernel functions for the bound (a
# transcendental as EXP_OPS and its few operations around exp; sin / cos /
# tan as the 29 float64 operations of ms_trig_parts and the selection,
# each charged at the float64 rate, in float32 operations); every other
# operation of the emitted step counts 1
TRIG_OPS = 30 * PEAK_OPS / PEAK_OPS_F64
# the DSL HH's firing form: dt 0.01 (the DSL's default of 0.1 drives HH to
# -inf within a few steps; the JAX package's DSL HH test takes 0.01) and
# the equilibrium gates of its HH kernel tests (with the gates at 0 no
# neuron of a lattice fires)
DSL_HH_FORM = {"dt": 0.01, "na$m$state": 0.05, "na$h$state": 0.6,
               "k$n$state": 0.32}
DSL_CALL_OPS = {"kernel_exp": EXP_OPS, "kernel_tanh": EXP_OPS + 4,
                "kernel_cosh": EXP_OPS + 3, "kernel_sinh": EXP_OPS + 4,
                "kernel_ln": EXP_OPS + 1, "kernel_log10": EXP_OPS + 2,
                "ms_pow": 2 * EXP_OPS + 3, "kernel_sin": TRIG_OPS,
                "kernel_cos": TRIG_OPS, "kernel_tan": TRIG_OPS + 1}
# the trig neuron of phase 42 (tests/test_torch_dsl_kernel.py's): tan of
# the input current (scaled away from tan's poles) and a sin / cos drive
# in dv/dt; its main path at DMAIN over TRIG_STEPS, its kernel-vs-twin
# cases at DMAIN in both designs and DBIG in the per-step one
TRIG_SOURCE = """
[neuron]
    type: TrigNeuron
    vars: w = 30, a = 0.02, b = 0.2, c = -55, d = 8, v_th = 30, tau_m = 1, c_m = 100, drive = 0
    on_spike:
        v = c
        w += d
    spike_detection: v >= v_th
    on_iteration:
        drive = tan(i * 0.001)
        dw/dt = (a * (b * v - w)) / tau_m
        dv/dt = (0.04 * v * v + 5 * v + 140 - w + i + 4 * sin(v * 0.2) * cos(w * 0.1) + drive) / c_m
[end]
"""
TRIG_STEPS = 512
TRIG_CASES = ((DMAIN, False), (DMAIN, True), (DBIG, True))
# the generated sources phase 37 builds in one nvcc round
DSL_BUILD = dict(DSL_SOURCES, TrigNeuron=TRIG_SOURCE)
# the Bayesian trial (phases 43-44): the TOMLs of the upstream pipeline,
# the steps of its first trial held card against CPU, the timed trials
TRIAL_TOMLS = ("smoke.toml", "smoke_mbm_d2.toml")
TRIAL_ARGS = os.path.join("experiments", "bayesian_inf_args")
TRIAL_CMP_STEPS = 1000
TRIAL_REPS = 3
# the support modules (phases 45-50): the graph builder's sizes, the
# diagnosed lattices' size (and the dense one's), the checkpointed runs'
# k (512^2 main path, 512^2 R-STDP, config 5, the reward network at
# CKPT_REWARD, the 2048^2 main path), BCM on a reward network, the fit
# (JAX tests/test_analysis.py:133), StepTimer's steps, the traced call
NATIVE_SHAPES = (MAIN, BIG)
DIAG, DIAG_DENSE = (64, 64), (16, 16)
CKPT_K = (1024, 512, 512, 512, 256)
CKPT_REWARD = (128, 128)
BCM_REWARD, BCM_REWARD_STEPS, BCM_WINDOW = (64, 64), 300, 5.0
FIT_ITERATIONS, FIT_POP, FIT_GENERATIONS = 400, 32, 10
TIMER_STEPS, TRACE_STEPS = 2048, 64
T0 = time.perf_counter()


def say(*a):
    """Print a line; a phase's line (one that starts with "[") ends with
    the seconds since the script started."""
    if a and str(a[0]).startswith("["):
        a = a + (f"(+{time.perf_counter() - T0:.1f} s)",)
    print(*a, flush=True)


def tensor_bytes(*objs):
    """Bytes of the distinct tensors in ``objs`` (nested in dicts, lists
    and tuples; None skipped), each counted once."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            seen[(x.data_ptr(), x.numel())] = x.numel() * x.element_size()
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)

    for x in objs:
        walk(x)
    return sum(seen.values())


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``n_bytes`` and do ``n_ops`` float operations."""
    tb, to = n_bytes / PEAK_BYTES, n_ops / PEAK_OPS
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def ingrid_slots(offsets, rows, cols):
    """The (offset, cell) pairs whose neighbour lies on the grid."""
    return sum(max(0, rows - abs(dr)) * max(0, cols - abs(dc))
               for dr, dc in offsets)


def stencil_ops(offsets, rows, cols, k):
    """Float operations of ``k`` electrical Izhikevich steps: per cell
    the weight sum and 23 of the model step, per on-grid slot a multiply
    and an add."""
    return k * (rows * cols * (len(offsets) + 23)
                + 2 * ingrid_slots(offsets, rows, cols))


def both_fired_slots(lft, mask, offsets):
    """Masked slots whose two endpoints have fired before the call: the
    STDP deltas that a call needs at least (one exp each)."""
    rows, cols = lft.shape
    fired = lft >= 0
    n = 0
    for o, (dr, dc) in enumerate(offsets):
        pre = torch.zeros_like(fired)
        r0, r1 = max(0, -dr), min(rows, rows - dr)
        c0, c1 = max(0, -dc), min(cols, cols - dc)
        pre[r0:r1, c0:c1] = fired[r0 + dr:r1 + dr, c0 + dc:c1 + dc]
        n += int((pre & fired & mask[o]).sum())
    return n


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def kernel_inputs(snt, rows, cols, seed, uniform, radius=2.0):
    """Planes on the card for one kernel call, made from ``seed``."""
    rng = np.random.default_rng(seed)
    g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(radius),
                               keep_prob=0.8, seed=seed + 1, device="cuda")
    params = {k: np.full((rows, cols), v, np.float32)
              for k, v in UNIFORM.items()}
    if not uniform:
        params["a"] = rng.uniform(0.01, 0.03, (rows, cols)).astype(np.float32)
        params["d"] = rng.uniform(6, 10, (rows, cols)).astype(np.float32)
        params["v_th"] = rng.uniform(25, 35, (rows, cols)).astype(np.float32)
    lft = np.where(rng.random((rows, cols)) < 0.2, 5, -1).astype(np.int32)
    cuda = lambda x: torch.from_numpy(x).cuda()
    return dict(
        v=cuda(rng.uniform(-65, 30, (rows, cols)).astype(np.float32)),
        w=cuda(rng.uniform(20, 40, (rows, cols)).astype(np.float32)),
        lft=cuda(lft), weights=g.weights, in_deg=g.in_deg,
        params={k: cuda(p) for k, p in params.items()}, offsets=g.offsets)


def call(fn, inp, clock0, n_steps, emit):
    return fn(inp["v"], inp["w"], inp["lft"], inp["weights"], inp["in_deg"],
              inp["params"], inp["offsets"], clock0, n_steps, emit)


def event_ms(fn, reps):
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_us(fn, steps, n_top=3, launches=None, mine=None):
    """Device microseconds per step of ``fn`` (which runs ``steps``
    steps) under torch.profiler: the sum of every CUDA kernel's and copy's
    device time, and the ``n_top`` largest by name.  With ``launches``
    (the kernels ``fn`` launches; with ``mine``, those whose names hold
    one of ``mine``), ``fn`` runs once in a warm-up cycle of the profiler
    before the cycle that is kept (the first records of a profile can be
    lost), and a profile that holds another number of such kernel records
    is taken again, up to PROF_TRIES times, and then fails: a lost record
    would make the sum short."""
    from torch.profiler import ProfilerActivity, profile, schedule
    warm = launches is not None
    for _ in range(PROF_TRIES):
        kept = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)
                     if warm else None,
                     on_trace_ready=(lambda p: kept.append(p.key_averages()))
                     if warm else None) as prof:
            for _ in range(2 if warm else 1):
                fn()
                torch.cuda.synchronize()
                if warm:
                    prof.step()
        dev = [(e.self_device_time_total, e.key, e.count)
               for e in (kept[-1] if warm else prof.key_averages())
               if e.device_type == torch.autograd.DeviceType.CUDA]
        records = sum(c for _, k, c in dev
                      if not k.startswith(("Memcpy", "Memset"))
                      and (mine is None or any(m in k for m in mine)))
        if launches is None or records == launches:
            break
        say(f"[profiler] {records} kernel records of {launches} launches; "
            f"profiling again")
    check(launches is None or records == launches,
          f"the profiler kept {records} kernel records of {launches}")
    top = sorted(dev, reverse=True)[:n_top]
    return (sum(t for t, _, _ in dev) / steps,
            [(k[:40], t / steps) for t, k, _ in top])


def main_lattice(snt, rows, cols, use_kernel=None, device="cuda",
                 cls="Lattice"):
    """The bench configuration: gap 10, radius 2, keep 0.8, graph seed 7,
    v0 uniform in [-65, 30) from ``default_rng(1)``; a plain `Lattice` or
    (``cls``) a `RewardModulatedLattice`."""
    lat = getattr(snt, cls)(snt.Izhikevich(), device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    v0 = np.random.default_rng(1).uniform(-65.0, 30.0, rows * cols)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(v0, dtype=torch.float32,
                                                   device=lat.device)})
    lat.use_kernel = use_kernel
    return lat


def stdp_lattice(snt, rows, cols, use_kernel=None, device="cuda"):
    """The main lattice with STDP."""
    lat = main_lattice(snt, rows, cols, use_kernel, device)
    lat.do_plasticity = True
    return lat


def bench_stdp(snt, rows, cols, use_kernel=None, device="cuda"):
    """`bench.py`'s STDP lattice: gap 10, radius 2, keep 0.8, graph seed 5,
    v0 uniform in [-65, 25) from ``default_rng(9)``."""
    lat = snt.Lattice(snt.Izhikevich(), device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=5)
    lat.do_plasticity = True
    v0 = np.random.default_rng(9).uniform(-65, 25, rows * cols)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(v0, dtype=torch.float32,
                                                   device=lat.device)})
    lat.use_kernel = use_kernel
    return lat


def bench_rstdp(snt, rows, cols, use_kernel=None, device="cuda", v0=False):
    """`bench.py`'s R-STDP lattice: gap 10, the radius-2 predicate (equal to
    ``connect_stencil(radius=2.0)``, tests/test_torch_plasticity.py), v
    uniform at -65; with ``v0``, uniform in [-65, 30) from
    ``default_rng(0)`` instead, so that neurons fire at different times."""
    lat = snt.RewardModulatedLattice(snt.Izhikevich(), device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0)
    if v0:
        v = np.random.default_rng(0).uniform(-65, 30, rows * cols)
        lat.apply(lambda s: {**s, "v": torch.as_tensor(
            v, dtype=torch.float32, device=lat.device)})
    lat.use_kernel = use_kernel
    return lat


def run_synced(lat, n, reward=None):
    t0 = time.perf_counter()
    if reward is None:
        lat.run_lattice(n)
    else:
        lat.run_lattice_with_reward(reward, n)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def rate(shape, secs, steps):
    n = shape[0] * shape[1]
    return (f"{n * steps / secs:.4e} neuron-updates/s, "
            f"{steps / secs:.1f} steps/s ({secs / steps * 1e6:.3f} us/step)")


def tie_check(label, hk, lk, hp, lp, n, reset=None, v_th=None):
    """Across associations two routes drift apart by rounding until a
    neuron sitting at threshold fires in one route and not in the other;
    spiking dynamics then spread the one-step shift.  Require that the
    routes agree within DRIFT until that first tie, that every neuron
    leaving DRIFT there is such a tie (one route reset to ``reset``, the
    other within DRIFT of ``v_th``; Izhikevich's c and v_th by default),
    and that the divergence stays local (fewer than 1% of the neurons ever
    outside 2 mV, fired counts within 1%)."""
    from spiking_neural_networks_tpu_torch import Izhikevich
    if reset is None:
        reset, v_th = (Izhikevich.FIELDS[k] for k in ("c", "v_th"))
    d = np.abs(hk - hp)
    dvs = d.max(axis=1)
    over = np.nonzero(dvs > 1e-4)[0]
    s0 = int(np.argmax(dvs > DRIFT)) if (dvs > DRIFT).any() else None
    gaps = []                 # |v - v_th| of the route that did not fire
    if s0 is not None:
        for j in np.nonzero(d[s0] > DRIFT)[0]:
            a, b = hk[s0, j], hp[s0, j]
            other = b if a == reset else a if b == reset else None
            gaps.append(np.inf if other is None else abs(float(other) - v_th))
    ties_ok = max(gaps, default=0.0) <= DRIFT
    outside = int((d > 2.0).any(axis=0).sum())
    fk, fp = int((lk >= 0).sum()), int((lp >= 0).sum())
    say(f"{label}: max|dv| {dvs.max():.4g} mV, "
        f"max|dlft| {int(np.abs(lk - lp).max())} steps, first step with "
        f"|dv| > 1e-4: {int(over[0]) if len(over) else 'none'}, first tie "
        f"step {s0} ({len(gaps)} neurons, max |v - v_th| "
        f"{max(gaps, default=0):.3g} mV), neurons ever outside 2 mV: "
        f"{outside} of {n}, fired {fk} vs {fp}")
    check(ties_ok, "the routes parted at a step that is not a threshold tie")
    check(outside <= n // 100 and abs(fk - fp) <= n // 100,
          "the routes' divergence spread beyond 1% of the lattice")


# ---------------------------------------------------------------------------
# The stencil kernel: phases 3-6
# ---------------------------------------------------------------------------


def stencil_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import stencil_kernels as sk
    max_err, times = stencil_twin_phase(snt, sk, smi)
    launches = stencil_main_phase(snt, sk)
    stencil_cmp_phase(snt)
    turns = stencil_times_phase(snt, sk, smi)
    out = []
    for design, shape, kernel, source in (
            ("persistent", MAIN, "model_persistent_kernel<Izh, CPT>",
             "model_stencil.cu"),
            ("tiled", BIG, "izh_tiled_kernel_rows<KB, R2>",
             "izhikevich_stencil.cu"),
            ("per_step", BIG, "izh_stencil_step_kernel (per step)",
             "izhikevich_stencil.cu")):
        t = turns[shape][design]
        out.append({
            "name": f"izhikevich_stencil_steps: {kernel}", "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/" + source,
            "replaces": REPLACES[design], "launches": launches[design],
            "max_abs_err": max_err,
            "ms": t["events_us"] * sk.STEPS_PER_LAUNCH / 1e3,
            "plain_ms": times[shape + (16,)][1] * sk.STEPS_PER_LAUNCH,
            "device_ms": t["device_us"] * sk.STEPS_PER_LAUNCH / 1e3,
            "bound_ms": times[shape + (16,)][2] * sk.STEPS_PER_LAUNCH,
            "bound_by": times[shape + (16,)][3], "library_ms": None,
            "library_call": "none: no PyTorch call computes a lattice "
                            "step"})
    return out


def bits_differ(a, b):
    """Elements of ``a`` and ``b`` whose bits differ (floats by their
    int32 view, so -0.0 differs from 0.0)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def stencil_design_chain(sk, inp, design, emit, ks=DESIGN_KS, plan=None):
    """A chain of calls of ``ks`` steps on one `StencilRun` of ``design``
    against the twin on the state each call received.  Returns (max float
    error, bits that differ, calls whose counted launches differ from
    `call_launches`, neurons fired, the run)."""
    run = sk.StencilRun(inp["v"], inp["w"], inp["lft"], inp["weights"],
                        inp["in_deg"], inp["params"], inp["offsets"],
                        design=design, plan=plan)
    check(run.design == design, f"forced {design}, got {run.design}")
    v, w, lft = inp["v"], inp["w"], inp["lft"]
    err, bad, miscount, fired, clock = 0.0, 0, 0, 0, 100
    for k in ks:
        before = sk.STEP_LAUNCHES
        got = run.steps(clock, k, emit)
        torch.cuda.synchronize()
        miscount += sk.STEP_LAUNCHES - before != run.launches(k)
        want = sk.izhikevich_stencil_steps_reference(
            v, w, lft, inp["weights"], inp["in_deg"], inp["params"],
            inp["offsets"], clock, k, emit)
        for g, w_ in zip(got[:2] + ((got[4],) if emit else ()),
                         want[:2] + ((want[4],) if emit else ())):
            torch.testing.assert_close(g, w_, rtol=RTOL, atol=ATOL)
            err = max(err, (g - w_).abs().max().item())
        check(all(bool(torch.isfinite(x).all()) for x in got[:2]),
              f"{design}: non-finite kernel output")
        bad += sum(bits_differ(g, w_) for g, w_ in zip(
            got[:4] + ((got[4],) if emit else ()),
            want[:4] + ((want[4],) if emit else ())))
        fired += int(got[3].sum())
        v, w, lft = want[0], want[1], want[2]
        clock += k
    return err, bad, miscount, fired, run


def stencil_twin_phase(snt, sk, smi):
    """3. The routed design of each of `CASES` against the twin (and its
    times at 512^2 and 2048^2); each design on `DESIGN_SHAPES` x
    `DESIGN_RADII` x emit, chains of `DESIGN_KS`; the tiled design in
    every tile of `TILE_TRIALS` and one of K_b = 3; the new
    instantiations' registers.  Returns (max float error, {(rows, cols,
    K): (kernel ms, twin ms, bound ms per step, bound_by)})."""
    for name in ("izh_tiled_kernel", "model_persistent_kernelI3Izh",
                 "izh_stencil_step_kernel"):
        found = instantiation_lines(name)
        if found:
            say(f"[3 build] {name}: " + "; ".join(
                f"{e.split(name)[-1].split('EEv')[0] or e} {rep}"
                for e, rep in found))
    max_err, times = 0.0, {}
    sms = sk.model_kernels.sm_count(torch.device("cuda"))
    covered = set()
    for seed, ((rows, cols), k, emit, uniform) in enumerate(CASES):
        inp = kernel_inputs(snt, rows, cols, seed, uniform)
        run = sk.StencilRun(inp["v"], inp["w"], inp["lft"], inp["weights"],
                            inp["in_deg"], inp["params"], inp["offsets"])
        got = call(sk.izhikevich_stencil_steps, inp, 100, k, emit)
        torch.cuda.synchronize()
        want = call(sk.izhikevich_stencil_steps_reference, inp, 100, k, emit)
        torch.cuda.synchronize()
        dv = (got[0] - want[0]).abs().max().item()
        dw = (got[1] - want[1]).abs().max().item()
        dpre = (got[4] - want[4]).abs().max().item() if emit else 0.0
        lft_bad = int((got[2] != want[2]).sum())
        spk_bad = int((got[3] != want[3]).sum())
        nbits = sum(bits_differ(g, w_) for g, w_ in zip(got[:2], want[:2]))
        say(f"[3 kernel-vs-twin] {rows}x{cols} K={k} emit={emit} "
            f"uniform={uniform}, the {run.design} design: max|dv| {dv:.3g} "
            f"max|dw| {dw:.3g} max|dv_pre| {dpre:.3g} lft mismatches "
            f"{lft_bad} spike mismatches {spk_bad} float bits differing "
            f"{nbits} fired {int(got[3].sum())}")
        check(lft_bad == 0 and spk_bad == 0 and nbits == 0,
              "lft, spikes or float bits differ")
        for g, w_ in zip(got[:2] + ((got[4],) if emit else ()),
                         want[:2] + ((want[4],) if emit else ())):
            torch.testing.assert_close(g, w_, rtol=RTOL, atol=ATOL)
        check(all(bool(torch.isfinite(x).all()) for x in got[:2]),
              "non-finite kernel output")
        max_err = max(max_err, dv, dw, dpre)
        covered.add((run.design, (rows, cols)))
        if (rows, cols) in (MAIN, BIG) and uniform and not emit:
            # per step: the routed design's and the twin's ms, and the
            # bound of the call
            bnd = bound(tensor_bytes(inp, got),
                        stencil_ops(inp["offsets"], rows, cols, k))
            times[rows, cols, k] = (
                event_ms(lambda: run.steps(100, k), 20) / k,
                event_ms(lambda: call(sk.izhikevich_stencil_steps_reference,
                                      inp, 100, k, False), 3) / k,
                bnd[0] / k, bnd[1])
            say(f"[3 kernel-vs-twin] {rows}x{cols} K={k} per step: "
                f"{run.design} design {times[rows, cols, k][0] * 1e3:.3f} "
                f"us (events, calls of one StencilRun), plain twin "
                f"{times[rows, cols, k][1] * 1e3:.3f} us, bound "
                f"{times[rows, cols, k][2] * 1e3:.3f} us ({bnd[1]}); card "
                f"{smi}")
        del inp, got, want, run
    check(MAIN_DESIGNS <= covered, f"no case held "
          f"{sorted(MAIN_DESIGNS - covered)} against the twin")
    # each design on small shapes, radii 1-3, chains of calls
    for design in ("persistent", "tiled", "per_step"):
        for shape in DESIGN_SHAPES:
            err, bad, miscount, fired, n = 0.0, 0, 0, 0, 0
            for r, radius in enumerate(DESIGN_RADII):
                for emit in (False, True):
                    inp = kernel_inputs(snt, *shape, 40 + 2 * r + emit,
                                        design == "tiled", radius)
                    e, b, m, f, run = stencil_design_chain(sk, inp, design,
                                                           emit)
                    err, bad, miscount = max(err, e), bad + b, miscount + m
                    fired, n = fired + f, n + 1
            plan = run.plan
            say(f"[3 designs] {design} {shape[0]}x{shape[1]}: radius 1, 2, "
                f"3 x emit off, on ({n} runs), calls of K = "
                f"{', '.join(map(str, DESIGN_KS))} chained: bits differing "
                f"{bad}, max float error {err:.3g}, calls whose counted "
                f"launches differ from call_launches {miscount}, spikes "
                f"{fired}; plan at radius 3: {plan}")
            check(bad == 0 and miscount == 0,
                  f"{design} {shape}: bits or launch counts differ")
            max_err = max(max_err, err)
    tiles = TILE_TRIALS + ((24, 40, 3),)
    inp = kernel_inputs(snt, 130, 100, 50, True)
    for tile in tiles:
        e, b, m, f, run = stencil_design_chain(
            sk, inp, "tiled", True, plan=sk.tile_config(*tile, inp["offsets"]))
        say(f"[3 tiles] tiled 130x100 radius 2, emit, tile {tile}: "
            f"{run.plan}; bits differing {b}, max float error {e:.3g}, "
            f"launch miscounts {m}")
        check(b == 0 and m == 0, f"tile {tile}: bits or launches differ")
        check(run.plan.th == tile[0] and run.plan.kb == tile[2],
              f"tile {tile} was not taken")
        max_err = max(max_err, e)
    r2 = snt.radius_offsets(2.0)
    say(f"[3 plan] {sms} SMs, radius 2: 512^2 "
        f"{sk.persistent_plan(MAIN, 12, sms)}; 700^2 "
        f"{sk.persistent_plan((700, 700), 12, sms)}; 1024^2 "
        f"{sk.persistent_plan((1024, 1024), 12, sms)}; 2-D tile at a reach "
        f"of 1 {sk.tile_plan(snt.radius_offsets(1.0))}")
    for shape in STREAM_SHAPES:
        p = sk.stream_plan(shape, r2, sms)
        say(f"[3 streamed] {shape[0]}x{shape[1]} radius 2: {p}; "
            f"{p.strips * p.segments} blocks on {sms} SMs, dynamic shared "
            f"memory {p.smem} B a block, rings (rows) "
            f"{sk.stream_rings(p.kb, p.r, p.pad)}")
    return max_err, times


def hetero_lattice(snt, rows, cols):
    """The main lattice with per-neuron a, d and v_th (drawn from
    ``default_rng(3)``, written with `apply` after `populate`): the
    parameter planes are not uniform."""
    lat = main_lattice(snt, rows, cols)
    rng = np.random.default_rng(3)
    n = rows * cols
    draw = {"a": rng.uniform(0.01, 0.03, n), "d": rng.uniform(6, 10, n),
            "v_th": rng.uniform(25, 35, n)}
    lat.apply(lambda s: {**s, **{k: torch.as_tensor(
        x, dtype=torch.float32, device=lat.device) for k, x in draw.items()}})
    return lat


def tiles2d(sk, offsets):
    """The 2-D tiles' plan (`TILES2D`) timed beside the streamed plan for
    ``offsets``."""
    return sk.tile_config(*TILES2D[sk.stencil_pad(offsets)], offsets)


def twin_bits(sk, lat, st0, clock, n_steps):
    """Bits of v, w, lft and spikes in which ``lat``'s state after a run
    of ``n_steps`` steps from the state ``st0`` at ``clock`` differs from
    the twin's, run on the card from ``st0`` in the runner's calls of
    `STEPS_PER_LAUNCH` steps."""
    shape = (lat.rows, lat.cols)
    plane = lambda k: st0[k].reshape(shape)
    params = {k: plane(k) for k in sk.PARAM_ORDER}
    v, w, lft = plane("v"), plane("w"), plane("last_firing_time")
    g = lat.graph
    for _ in range(n_steps // sk.STEPS_PER_LAUNCH):
        v, w, lft, spk, _ = sk.izhikevich_stencil_steps_reference(
            v, w, lft, g.weights, g.in_deg, params, g.offsets, clock,
            sk.STEPS_PER_LAUNCH)
        clock += sk.STEPS_PER_LAUNCH
    got = [lat.state[k].reshape(shape)
           for k in ("v", "w", "last_firing_time", "is_spiking")]
    return sum(bits_differ(a, b) for a, b in zip(got, (v, w, lft, spk)))


def reset_stencil_counts(sk):
    sk.LAUNCHES = 0
    sk.STEP_LAUNCHES = 0
    sk.STREAMED_CALLS = 0
    for k in sk.DESIGN_CALLS:
        sk.DESIGN_CALLS[k] = 0


def stencil_main_phase(snt, sk):
    """4. The main paths through `run_lattice`, each with the counts set
    to 0 just before and read just after.  Returns the kernel launches
    the C entries counted on them, by design."""
    launches = {"persistent": 0, "tiled": 0, "per_step": 0}
    lat = main_lattice(snt, *MAIN)
    reset_stencil_counts(sk)
    lat.run_lattice(MAIN_STEPS)
    torch.cuda.synchronize()
    calls, steps = sk.LAUNCHES, sk.STEP_LAUNCHES
    designs = dict(sk.DESIGN_CALLS)
    launches["persistent"] += steps
    v = lat.state["v"]
    fired = int((lat.state["last_firing_time"] >= 0).sum())
    say(f"[4 main path] {MAIN[0]}x{MAIN[1]} run_lattice({MAIN_STEPS}): route "
        f"{lat._last_run_fused}, calls by design {designs}, kernel calls "
        f"{calls}, kernel launches counted by the C entry {steps}, v finite "
        f"{bool(torch.isfinite(v).all())}, v range [{v.min().item():.3f}, "
        f"{v.max().item():.3f}], fired {fired} of {lat.n}")
    check(lat._last_run_fused == ("kernel", False), "main path missed the kernel")
    want_calls = math.ceil(MAIN_STEPS / sk.STEPS_PER_LAUNCH)
    check(calls == want_calls and steps == want_calls
          and designs["persistent"] == want_calls,
          f"expected {want_calls} calls of one persistent launch each")
    check(bool(torch.isfinite(v).all()) and fired > 0, "bad main-path state")
    # the profiler's records of the C entry's launches
    per_run = []

    def record_run():
        """One run of the profile; the launches the C entry counted in it
        (a profile that lost records is taken again, so the last run's
        count is the kept one's)."""
        before = sk.STEP_LAUNCHES
        lat.run_lattice(RECORD_STEPS)
        per_run.append(sk.STEP_LAUNCHES - before)

    recs = kernel_records(record_run, RECORD_STEPS // sk.STEPS_PER_LAUNCH,
                          mine=("model_persistent_kernel", "izh_"))
    counted = per_run[-1]
    say(f"[4 main path] {MAIN[0]}x{MAIN[1]} run_lattice({RECORD_STEPS}) "
        f"under the profiler: {records_line(recs)}; counted by the C entry "
        f"{counted} a run")
    check(sum(recs.values()) == counted
          == RECORD_STEPS // sk.STEPS_PER_LAUNCH,
          "the profiler's records differ from the C entry's count")
    lat.update_grid_history = True
    reset_stencil_counts(sk)
    lat.run_lattice(HIST_STEPS)
    torch.cuda.synchronize()
    launches["persistent"] += sk.STEP_LAUNCHES
    hist = np.stack(lat.grid_history.history)
    say(f"[4 main path] grid history {HIST_STEPS} steps: shape {hist.shape}, "
        f"route {lat._last_run_fused}, calls by design "
        f"{dict(sk.DESIGN_CALLS)}, finite {bool(np.isfinite(hist).all())}")
    check(hist.shape == (HIST_STEPS, *MAIN) and np.isfinite(hist).all(),
          "bad grid history")
    check(lat._last_run_fused == ("kernel", True)
          and sk.DESIGN_CALLS["persistent"] == HIST_STEPS // 16,
          "history run missed the persistent design")
    del lat
    for shape in TILED_MAINS:
        big = main_lattice(snt, *shape)
        st0 = {k: x.clone() for k, x in big.state.items()}
        clock = big.internal_clock
        reset_stencil_counts(sk)
        big.run_lattice(BIG_STEPS)
        torch.cuda.synchronize()
        calls, steps = sk.LAUNCHES, sk.STEP_LAUNCHES
        designs = dict(sk.DESIGN_CALLS)
        streamed = sk.STREAMED_CALLS
        launches["tiled"] += steps
        plan = sk.tiled_plan(shape, big.graph.offsets,
                             sk.model_kernels.sm_count(torch.device("cuda")))
        bv = big.state["v"]
        bfired = int((big.state["last_firing_time"] >= 0).sum())
        nbits = twin_bits(sk, big, st0, clock, BIG_STEPS)
        say(f"[4 main path] {shape[0]}x{shape[1]} run_lattice({BIG_STEPS}): "
            f"route {big._last_run_fused}, calls by design {designs}, "
            f"of them on the streamed plan {streamed}, "
            f"kernel launches counted by the C entry {steps} "
            f"({steps / max(calls, 1):.2f} a call; plan {plan}), v finite "
            f"{bool(torch.isfinite(bv).all())}, v range "
            f"[{bv.min().item():.3f}, {bv.max().item():.3f}], fired "
            f"{bfired} of {big.n}; against the twin from the same state: "
            f"bits differing in v, w, lft, spikes {nbits}")
        n_calls = math.ceil(BIG_STEPS / sk.STEPS_PER_LAUNCH)
        check(big._last_run_fused == ("kernel", False)
              and designs["tiled"] == calls == n_calls
              and steps == n_calls * sk.call_launches(16, "tiled", plan)
              and bool(torch.isfinite(bv).all()) and bfired > 0,
              f"bad {shape} run of the tiled design")
        check(streamed == calls and isinstance(plan, sk.StreamPlan),
              f"the {shape} main path missed the streamed plan: {streamed} "
              f"of {calls} calls")
        check(nbits == 0, f"the {shape} main path differs from the twin")
        del big, st0
    het = hetero_lattice(snt, *BIG)
    st0, clock = dict(het.state), het.internal_clock
    reset_stencil_counts(sk)
    het.run_lattice(HETERO_STEPS)
    torch.cuda.synchronize()
    launches["per_step"] += sk.STEP_LAUNCHES
    calls, steps = sk.LAUNCHES, sk.STEP_LAUNCHES
    designs = dict(sk.DESIGN_CALLS)
    nbits = twin_bits(sk, het, st0, clock, HETERO_STEPS)
    hv = het.state["v"]
    hfired = int((het.state["last_firing_time"] >= 0).sum())
    say(f"[4 main path] {BIG[0]}x{BIG[1]} with per-neuron a, d, v_th, "
        f"run_lattice({HETERO_STEPS}): route {het._last_run_fused}, calls by "
        f"design {designs}, kernel launches counted by the C entry {steps}, "
        f"v finite {bool(torch.isfinite(hv).all())}, fired {hfired} of "
        f"{het.n}; against the twin from the same state: bits differing in "
        f"v, w, lft, spikes {nbits}")
    check(het._last_run_fused == ("kernel", False)
          and designs["per_step"] == calls == HETERO_STEPS // 16
          and steps == HETERO_STEPS
          and bool(torch.isfinite(hv).all()) and hfired > 0,
          "bad run of the per-step design")
    check(nbits == 0, "the per-neuron main path differs from the twin")
    del het, st0
    return launches


def stencil_cmp_phase(snt):
    """5. The kernel route on the card against (a) the same fused route on
    the CPU, under the reference's CPU-vs-GPU criterion, and (b) the plain
    route on the card, whose gather sums in another association."""
    runs = {}
    for key, device, use_kernel in (("kernel", "cuda", None),
                                    ("cpu", "cpu", True),
                                    ("plain", "cuda", False)):
        lat = main_lattice(snt, *CMP, use_kernel=use_kernel, device=device)
        lat.update_grid_history = True
        lat.run_lattice(CMP_STEPS)
        runs[key] = (np.stack(lat.grid_history.history).reshape(CMP_STEPS, -1),
                     lat.field("last_firing_time").reshape(-1).astype(np.int64),
                     lat._last_run_fused)
    check(runs["kernel"][2] == runs["cpu"][2] == ("kernel", True)
          and runs["plain"][2] is False, "wrong routes")
    hk, lk, _ = runs["kernel"]
    hc, lc, _ = runs["cpu"]
    dv_cpu, dlft_cpu = float(np.abs(hk - hc).max()), int(np.abs(lk - lc).max())
    say(f"[5 kernel-vs-cpu] {CMP[0]}x{CMP[1]} {CMP_STEPS} steps, fused route "
        f"on the card vs on the CPU: max|dv| {dv_cpu:.4g} mV, max|dlft| "
        f"{dlft_cpu} steps")
    check(dv_cpu <= 2.0 and dlft_cpu <= 2,
          "card vs CPU outside the 2 mV / 2 step criterion")
    hp, lp, _ = runs["plain"]
    tie_check(f"[5 kernel-vs-plain] {CMP[0]}x{CMP[1]} {CMP_STEPS} steps, "
              f"fused vs plain association on the card", hk, lk, hp, lp,
              CMP[0] * CMP[1])


def stencil_bytes(sk, design, plan, shape, n_off, k):
    """Bytes one K-step call of ``design`` moves by its design's own
    traffic model (not the bound): per step, the per-step design reads 25
    planes at radius 2 and writes 3; the persistent one reads its inputs
    once and sends v through a scratch plane each step (written, and read
    by the neighbours); the tiled one reads each launch's loaded tiles (v
    everywhere, w, in_deg and the weights where a cell is computed, lft in
    the interior) and writes the interiors."""
    rows, cols = shape
    n = rows * cols
    if design == "per_step":
        return k * n * 4 * (n_off + len(sk.PARAM_ORDER) + 1 + 3 + 3) + n
    if design == "persistent":
        return (n * 4 * (n_off + len(sk.PARAM_ORDER) + 1 + 3)
                + 2 * (k - 1) * n * 4 + n * 4 * 3 + n)

    def span(length, tile, grow):
        # cells of each tile's range grown by `grow` on both sides,
        # clipped to [0, length), summed over the tiles
        return sum(min(length, t + tile + grow) - max(0, t - grow)
                   for t in range(0, length, tile))

    pad = plan.halo // plan.kb if plan.kb else 0
    if isinstance(plan, sk.StreamPlan):
        # each launch reads its strips' loaded v, and once the weights, w
        # and in_deg of the cells level 1 computes, lft in the interiors,
        # and writes the interiors
        loaded = span(rows, plan.seg, plan.halo) * span(cols, plan.tw,
                                                         plan.halo)
        computed = (span(rows, plan.seg, plan.halo - pad)
                    * span(cols, plan.tw, plan.halo - pad))
        launches = -(-k // plan.kb)
        return launches * (loaded * 4 + computed * 4 * (n_off + 2)
                           + n * 4 * (1 + 3)) + n
    loaded = span(rows, plan.th, plan.halo) * span(cols, plan.tw, plan.halo)
    computed = (span(rows, plan.th, plan.halo - pad)
                * span(cols, plan.tw, plan.halo - pad))
    launches = -(-k // plan.kb)
    return launches * (loaded * 4 + computed * 4 * (n_off + 2)
                       + n * 4 * (1 + 3)) + n


def stencil_times_phase(snt, sk, smi):
    """6. Wall time per step of the main paths (median of 5 after a
    warm-up; the plain route at 512^2 over `PLAIN_TIME_STEPS`); the
    designs in turns on one `StencilRun` each at `TURN_SHAPES_STENCIL`
    (uniform parameters, radius 2: wall, events, device time under
    torch.profiler with every kernel record counted, the launches the C
    entry counted, modelled bytes), the 2-D tiles beside the streamed plan
    where the tiled design takes the shape; the persistent design with and
    without emission at 512^2; every tile of `TILE_TRIALS` at 2048^2; the
    streamed plan against the 2-D tiles at 2048^2 at the other reaches.
    Returns {shape: {design: times}}."""
    def warm(shape, use_kernel, steps):
        lat = main_lattice(snt, *shape, use_kernel=use_kernel)
        run_synced(lat, steps)
        return lat

    K = sk.STEPS_PER_LAUNCH
    kern = warm(MAIN, None, MAIN_STEPS)
    plain = warm(MAIN, False, PLAIN_TIME_STEPS)
    tk, tp = [], []
    for rep in range(5):                             # in turns
        order = [(kern, tk, MAIN_STEPS), (plain, tp, PLAIN_TIME_STEPS)]
        for lat, out, n in order if rep % 2 == 0 else order[::-1]:
            out.append(run_synced(lat, n))
    check(kern._last_run_fused == ("kernel", False)
          and plain._last_run_fused is False, "timed the wrong routes")
    walls = {MAIN: float(np.median(tk)) / MAIN_STEPS * 1e6}
    say(f"[6 times] {MAIN[0]}x{MAIN[1]} {MAIN_STEPS} steps, median of 5: "
        f"kernel route {rate(MAIN, float(np.median(tk)), MAIN_STEPS)}; "
        f"plain route {rate(MAIN, float(np.median(tp)), PLAIN_TIME_STEPS)} "
        f"over {PLAIN_TIME_STEPS} steps; card "
        f"{smi}")
    del kern, plain
    for shape in TILED_MAINS:
        big = warm(shape, None, BIG_STEPS)
        mb = float(np.median([run_synced(big, BIG_STEPS) for _ in range(5)]))
        walls[shape] = mb / BIG_STEPS * 1e6
        say(f"[6 times] {shape[0]}x{shape[1]} {BIG_STEPS} steps, median of "
            f"5: kernel route {rate(shape, mb, BIG_STEPS)}; card {smi}")
        del big
    out = {}
    sms = sk.model_kernels.sm_count(torch.device("cuda"))
    for shape in TURN_SHAPES_STENCIL:
        inp = kernel_inputs(snt, *shape, 60, True)
        runs = {}
        for design in ("persistent", "tiled", "per_step"):
            try:
                runs[design] = sk.StencilRun(
                    inp["v"], inp["w"], inp["lft"], inp["weights"],
                    inp["in_deg"], inp["params"], inp["offsets"],
                    design=design)
            except ValueError:
                pass        # the persistent plan cannot hold the weights
        if "persistent" not in runs:
            # the tiled route's shapes: the 2-D tiles beside the streamed
            # plan
            runs["tiles2d"] = sk.StencilRun(
                inp["v"], inp["w"], inp["lft"], inp["weights"],
                inp["in_deg"], inp["params"], inp["offsets"],
                plan=tiles2d(sk, inp["offsets"]))
        routed = sk.route(shape, inp["offsets"], sms,
                          lambda: sk.uniform_scalars(inp["params"]))[0]
        counted = {}
        for d, run in runs.items():
            before = sk.STEP_LAUNCHES
            run.steps(0, K)
            counted[d] = sk.STEP_LAUNCHES - before
            check(counted[d] == run.launches(K),
                  f"{d}: the C entry counted {counted[d]} launches")
        res = designs_in_turns({d: (lambda r=r: r.steps(0, K))
                                for d, r in runs.items()},
                               {d: r.launches(K) for d, r in runs.items()},
                               K)
        out[shape] = {}
        for d, (wall, ev, dev, n, top) in res.items():
            nb = stencil_bytes(sk, runs[d].design, runs[d].plan, shape,
                               len(inp["offsets"]), K)
            out[shape][d] = dict(events_us=ev, device_us=dev, wall_us=wall,
                                 bytes=nb)
        say(f"[6 designs] {shape[0]}x{shape[1]}, radius 2, in turns (the "
            f"route takes {routed}; kernel records counted in the profile "
            f"= the C entry's {counted}): {design_line(res)}; modelled "
            + ", ".join(f"{d} {o['bytes'] / K / 1e6:.2f} MB/step ("
                        f"{o['bytes'] / K / o['device_us'] / 1e6:.3f} TB/s "
                        f"at the device time)"
                        for d, o in out[shape].items())
            + f"; card {smi}")
        fastest = min(out[shape], key=lambda d: out[shape][d]["device_us"])
        say(f"[6 designs] {shape[0]}x{shape[1]}: fastest by device time "
            f"{fastest}, routed {routed}"
            + (f", main-path wall {walls[shape]:.3f} us/step, device / "
               f"wall {out[shape][routed]['device_us'] / walls[shape]:.3f}"
               if shape in walls else ""))
        del inp, runs
    # emission on the persistent design
    inp = kernel_inputs(snt, *MAIN, 61, True)
    run = sk.StencilRun(inp["v"], inp["w"], inp["lft"], inp["weights"],
                        inp["in_deg"], inp["params"], inp["offsets"])
    res = designs_in_turns({"no emit": lambda: run.steps(0, K),
                            "emit": lambda: run.steps(0, K, True)},
                           {"no emit": 1, "emit": 1}, K)
    say(f"[6 designs] {MAIN[0]}x{MAIN[1]} {run.design} design, emission "
        f"off and on, in turns: {design_line(res)}; card {smi}")
    del inp, run
    # the tiles at 2048^2
    mb = lambda plan: stencil_bytes(sk, "tiled", plan, BIG, 12, K) / K / 1e6
    inp = kernel_inputs(snt, *BIG, 62, True)
    runs = {t: sk.StencilRun(inp["v"], inp["w"], inp["lft"], inp["weights"],
                             inp["in_deg"], inp["params"], inp["offsets"],
                             plan=sk.tile_config(*t, inp["offsets"]))
            for t in TILE_TRIALS}
    res = designs_in_turns({str(t): (lambda r=r: r.steps(0, K))
                            for t, r in runs.items()},
                           {str(t): r.launches(K) for t, r in runs.items()},
                           K, reps=5)
    # the other stencils the tiled design takes, streamed plan against the
    # 2-D tiles (the route takes the 2-D tile at a reach of 1, the
    # streamed plan at 3 and 4)
    for radius in (1.0, 1.5, 3.0, 4.0):
        rin = kernel_inputs(snt, *BIG, 63, True, radius)
        rr = {"streamed": sk.StencilRun(
                  rin["v"], rin["w"], rin["lft"], rin["weights"],
                  rin["in_deg"], rin["params"], rin["offsets"],
                  plan=sk.stream_plan(BIG, rin["offsets"], sms)),
              "tiles2d": sk.StencilRun(
                  rin["v"], rin["w"], rin["lft"], rin["weights"],
                  rin["in_deg"], rin["params"], rin["offsets"],
                  plan=tiles2d(sk, rin["offsets"]))}
        check(rr["streamed"].streamed and not rr["tiles2d"].streamed,
              f"radius {radius}: the plans were not taken")
        rres = designs_in_turns({k: (lambda r=r: r.steps(0, K))
                                 for k, r in rr.items()},
                                {k: r.launches(K) for k, r in rr.items()}, K,
                                reps=5)
        say(f"[6 radii] {BIG[0]}x{BIG[1]} radius {radius}, in turns: "
            f"{design_line(rres)}; plans {rr['streamed'].plan}, "
            f"{rr['tiles2d'].plan}; card {smi}")
        del rin, rr
    say(f"[6 tiles] {BIG[0]}x{BIG[1]} tiled design, each tile of TILE_TRIALS "
        f"(rows, cols, K_b) in turns: {design_line(res)}; modelled "
        + ", ".join(f"{t} {mb(r.plan):.1f} MB/step"
                    for t, r in runs.items())
        + f"; card {smi}")
    del inp, runs
    return out


# ---------------------------------------------------------------------------
# The plasticity kernels: phases 7-10
# ---------------------------------------------------------------------------


def plasticity_inputs(snt, rk, shape, kind, model, with_reward, uniform,
                      emit, n_steps, seed, offsets=None):
    """The arguments of one wrapper call, on the card, made from ``seed``
    (a radius-2 stencil unless ``offsets`` are given)."""
    rows, cols = shape
    rng = np.random.default_rng(seed)
    g = snt.StencilGraph.build(rows, cols, offsets or snt.radius_offsets(2.0),
                               keep_prob=0.8, seed=seed + 1,
                               weight_fn=lambda dr, dc, rr, cc:
                               rng.uniform(0.5, 1.5, rr.shape),
                               device="cuda")
    cls = {"izhikevich": snt.Izhikevich,
           "alif": snt.AdaptiveLeakyIntegrateAndFire,
           "lif": snt.LeakyIntegrateAndFire}[model]
    keys = rk.MODEL_PARAM_KEYS[model]
    params = {k: np.full(shape, cls.FIELDS[k], np.float32) for k in keys}
    if not uniform:
        for k in ("v_th", "tref", "g_l", "a", "d"):
            if k in params:
                params[k] *= rng.uniform(0.9, 1.1, shape).astype(np.float32)
    izh = model == "izhikevich"
    f32 = lambda lo, hi, shp=shape: torch.from_numpy(
        rng.uniform(lo, hi, shp).astype(np.float32)).cuda()
    n_off = len(g.offsets)

    def some(frac, shp=(n_off, *shape)):
        return torch.from_numpy(rng.random(shp) < frac).cuda()

    # a tenth of the weights -0.0 (w + delta * 0 turns them +0.0), dw
    # exactly +0.0 or -0.0 in places, counters of 0, 1 and 2
    weights = g.weights.clone()
    weights[some(0.1)] = -0.0
    dw = f32(-0.1, 0.1, (n_off, *shape))
    dw[some(0.2)] = 0.0
    dw[some(0.1)] = -0.0
    return dict(
        spec=rk.LatSpec(kind, model, g.offsets, emit, with_reward),
        v=f32(-60, 50) if izh else f32(-75, -50),
        w=f32(20, 40) if izh else f32(-5, 5) if model == "alif"
        else torch.zeros(shape, device="cuda"),
        lft=torch.from_numpy(np.where(rng.random(shape) < 0.3,
                                      rng.integers(90, 100, shape),
                                      -1).astype(np.int32)).cuda(),
        refr=None if izh else torch.from_numpy(
            rng.integers(0, 4, shape).astype(np.float32)).cuda(),
        weights=weights, mask=g.mask, in_deg=g.in_deg,
        params={k: torch.from_numpy(p).cuda() for k, p in params.items()},
        traces=(f32(-0.5, 0.5, (n_off, *shape)), dw,
                torch.from_numpy(rng.integers(0, 3, (n_off, *shape))
                                 .astype(np.int32)).cuda())
        if kind == "mod" else None,
        dopamine=torch.tensor(0.3, device="cuda"),
        rule=snt.STDP().params if kind == "plastic"
        else snt.RewardModulatedSTDP(**RSTDP).params,
        rewards=np.linspace(-0.1, 0.2, n_steps).astype(np.float32)
        if with_reward else None,
        clock0=100, n_steps=n_steps)


def compare_call(got, want):
    """(max float error, integer/spike mismatches, max errors by name) of
    a kernel call against its twin."""
    names = ("v", "w", "lft", "refr", "spikes", "weights", "traces",
             "dopamine", "v_pre")
    errs, bad = {}, 0
    for name, g, w in zip(names, got, want):
        if g is None:
            continue
        for i, (gx, wx) in enumerate(zip(g if isinstance(g, tuple) else (g,),
                                         w if isinstance(w, tuple) else (w,))):
            key = ("c", "dw", "counter")[i] if name == "traces" else name
            if gx.dtype in (torch.int32, torch.bool) or key == "refr":
                bad += int((gx != wx).sum())
            else:
                check(bool(torch.isfinite(gx).all()), f"non-finite {key}")
                torch.testing.assert_close(gx, wx, rtol=RTOL, atol=ATOL,
                                           msg=key)
                errs[key] = (gx - wx).abs().max().item()
    return max(errs.values()), bad, errs


def lp_bits(got, want):
    """The outputs of a plasticity call that differ from the twin's in any
    bit (floats as their int32 bits, so +0 and -0 apart)."""
    names = ("v", "w", "lft", "refr", "spikes", "weights", "traces",
             "dopamine", "v_pre")
    bad = []
    for name, g, w in zip(names, got, want):
        if (g is None) != (w is None):
            bad.append(name)
            continue
        for x, y in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            if x is None:
                continue
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if x.shape != y.shape or not torch.equal(x, y):
                bad.append(name)
                break
    return bad


def kernel_records(fn, expect, mine=("lp_", "hh_")):
    """Records by name of the port's kernels (names holding one of
    ``mine``) in one run of ``fn`` under torch.profiler, after a warm-up
    cycle; a profile that lost records (fewer than ``expect``) is taken
    again, up to PROF_TRIES times.  Other kernels of the run (the runners'
    reductions) are left out."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(PROF_TRIES):
        kept = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.append(
                         p.key_averages())) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        recs = {e.key: e.count for e in kept[-1]
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(m in e.key for m in mine)}
        if sum(recs.values()) >= expect:
            return recs
        say(f"[profiler] {sum(recs.values())} kernel records of {expect}; "
            f"profiling again")
    return recs


def records_line(recs):
    return ", ".join(f"{k[:48]} x{n}" for k, n in sorted(recs.items()))


def designs_in_turns(calls, launches, k, reps=10, count=True):
    """Designs of one K-step call, ``calls`` = {name: fn}, in turns (a, b,
    b, a; a, b, c, c, b, a): per design (wall us per step of back-to-back
    calls to a synchronise, CUDA-event us per step, profiled device us per
    step, kernel launches per call, the largest kernels); with ``count``, the
    profile of ``reps`` calls must hold ``reps * launches[name]`` kernel
    records."""
    keys = list(calls)
    walls = {key: [] for key in calls}
    events = {key: [] for key in calls}
    for key in keys + keys[::-1]:
        fn = calls[key]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        walls[key].append((time.perf_counter() - t0) / reps / k * 1e6)
        events[key].append(event_ms(fn, reps) * 1e3 / k)
    out = {}
    for key, fn in calls.items():
        dev, top = profiled_us(lambda fn=fn: [fn() for _ in range(reps)],
                               reps * k, n_top=4,
                               launches=reps * launches[key] if count
                               else None)
        out[key] = (min(walls[key]), min(events[key]), dev, launches[key],
                    top)
    return out


def lp_changed(rk, args):
    """Values of the weights and the traces (c, dw, counter) whose bits a
    step changes, summed over the call's steps: the twin one step at a
    time."""
    a, kind, tot = dict(args), args["spec"].kind, [0, 0, 0, 0]
    for k in range(args["n_steps"]):
        out = rk.lattice_plasticity_steps_reference(**dict(
            a, n_steps=1, clock0=args["clock0"] + k,
            rewards=None if args["rewards"] is None
            else args["rewards"][k:k + 1]))
        pairs = [(a["weights"], out[5])] + (
            list(zip(a["traces"], out[6])) if kind == "mod" else [])
        for j, (x, y) in enumerate(pairs):
            tot[j] += int((x.view(torch.int32) != y.view(torch.int32)).sum())
        a.update(v=out[0], w=out[1], lft=out[2], refr=out[3],
                 weights=out[5], traces=out[6], dopamine=out[7])
    return tot


def lp_step_bytes(rk, args, changed, per_step):
    """Bytes a step of a plasticity call moves, modelled from its shapes
    (not measured): per cell the state, in_deg and parameter planes read,
    the state and spike flag written; per slot the weight, mask and traces
    read once (twice the weight in the per-step design, whose cell kernel
    reads it again), the lft and spike flags of the edge pass; the stores
    of the values ``changed`` (`lp_changed`), 4 bytes each."""
    spec = args["spec"]
    rows, cols = args["v"].shape
    cells, n_off, k = rows * cols, len(spec.offsets), args["n_steps"]
    fields = 4 if spec.model in rk.REFRACTORY_MODELS else 3
    n_par = len(rk.MODEL_PARAM_KEYS[spec.model])
    cell = cells * (4 * (fields + 1 + n_par) + 4 * fields + 1)
    edge = 0
    if spec.kind != "plain":
        edge = cells * n_off * (1 + (12 if spec.kind == "mod" else 0)) \
            + cells * 5
    weights = cells * n_off * 4 * (2 if per_step else 1)
    return cell + edge + weights + 4 * sum(changed) / k


def plasticity_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import reward_kernels as rk

    for entry, rep in instantiation_lines("lp_step_kernel"):
        say(f"[7 build] {entry}: {rep}")
    # 7. kernel vs plain twin on the card: the fused schedule (the main
    # path's) and the per-step design, each bit for bit, with the launches
    # the C entry counted
    max_err, times, bounds = 0.0, {}, {}
    for seed, (shape, k, kind, model, rew, uniform, emit, *offs) in \
            enumerate(PCASES + SCHED_CASES + WIDE_CASES + TURN_CASES):
        args = plasticity_inputs(snt, rk, shape, kind, model, rew, uniform,
                                 emit, k, seed, *offs)
        before = rk.STEP_LAUNCHES
        got = rk.lattice_plasticity_steps(**args)
        torch.cuda.synchronize()
        launched = rk.STEP_LAUNCHES - before
        before = rk.STEP_LAUNCHES
        per_step = rk.lattice_plasticity_steps(**args, _per_step=True)
        torch.cuda.synchronize()
        launched_ps = rk.STEP_LAUNCHES - before
        want = rk.lattice_plasticity_steps_reference(**args)
        torch.cuda.synchronize()
        err, bad, errs = compare_call(got, want)
        diff, diff_ps = lp_bits(got, want), lp_bits(per_step, want)
        say(f"[7 kernel-vs-twin] {shape[0]}x{shape[1]} K={k} {kind} {model} "
            f"reward={rew} uniform={uniform} emit={emit}"
            + (f" offsets {offs[0]}" if offs else "") + ": integer and spike "
            f"mismatches {bad}, max errors "
            + " ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f", outputs not bit-equal: fused {diff}, per step {diff_ps}; "
            f"launches counted {launched} fused, {launched_ps} per step; "
            f"neurons fired {int((got[2] >= 100).sum())}")
        check(bad == 0, "firing times, spikes, refractory counts or counters "
              "differ")
        check(not diff and not diff_ps, "a design is not bit-equal to the "
              "twin")
        spec = args["spec"]
        check(launched == rk.step_launches(spec, k)
              and launched_ps == rk.step_launches(spec, k, per_step=True),
              "the C entry launched another number of kernels than its "
              "schedule has")
        max_err = max(max_err, err)
        if shape in TURN_SHAPES and k == 16:
            timed = dict(args, spec=args["spec"]._replace(emit=False))
            rows, cols = shape
            offs = timed["spec"].offsets
            both = both_fired_slots(timed["lft"], timed["mask"], offs)
            # cell kernel; per masked slot the mod kind's two visits (10
            # operations) and, where both ends fired, a delta (8 + an exp);
            # the plastic kind the delta and its update (11 + an exp)
            ops = stencil_ops(offs, rows, cols, k) + k * (
                10 * int(timed["mask"].sum()) + (8 + EXP_OPS) * both
                if kind == "mod" else (11 + EXP_OPS) * both)
            case = (kind, model, shape)
            bounds[case] = bound(tensor_bytes(
                timed, rk.lattice_plasticity_steps(**timed)), ops)
            # the profile must hold the launches the C entry counted
            out = designs_in_turns(
                {"fused": lambda: rk.lattice_plasticity_steps(**timed),
                 "per_step": lambda: rk.lattice_plasticity_steps(
                     **timed, _per_step=True)},
                {"fused": launched, "per_step": launched_ps}, k)
            changed = lp_changed(rk, timed)
            rates = {key: lp_step_bytes(rk, timed, changed,
                                        key == "per_step") / (d * 1e-6)
                     for key, (_, _, d, _, _) in out.items()}
            times[case] = (out["fused"][1] / 1e3, event_ms(
                lambda: rk.lattice_plasticity_steps_reference(**timed), 3) / k,
                out["fused"][2] / 1e3, out["per_step"][1] / 1e3,
                out["per_step"][2] / 1e3)
            say(f"[7 times] {shape[0]}x{shape[1]} K={k} {kind} {model}, the "
                f"designs in turns: {design_line(out)}; modelled bytes a step "
                + ", ".join(f"{key} {lp_step_bytes(rk, timed, changed, key == 'per_step') / 1e6:.2f} MB"
                            f" ({rates[key] / 1e12:.3f} TB/s)"
                            for key in out)
                + f"; values changed per step: weights "
                f"{changed[0] / k:.0f}" + (
                    f", c {changed[1] / k:.0f}, dw {changed[2] / k:.0f}, "
                    f"counter {changed[3] / k:.0f}" if kind == "mod" else "")
                + f" of {int(timed['mask'].sum())} masked slots; plain twin "
                f"{times[case][1] * 1e3:.3f} us/step (events); bound "
                f"{bounds[case][0] * 1e3 / k:.3f} us ({bounds[case][1]}); "
                f"card {smi}")
            del timed
        del args, got, want, per_step
    say(f"[7 kernel-vs-twin] max float error over all cases {max_err:.3g} "
        f"(tolerance rtol {RTOL}, atol {ATOL}; 0 = bit-equal)")

    # 8. the main paths; per_call sums (calls, launches counted by the C
    # entry, profiled calls, the profiler's kernel records)
    launches, per_call = 0, [0, 0, 0, 0]
    lat = stdp_lattice(snt, *MAIN)
    w0 = lat.graph.weights.clone()
    rk.LAUNCHES = rk.STEP_LAUNCHES = 0
    lat.run_lattice(MAIN_STEPS)
    torch.cuda.synchronize()
    calls, steps_launched = rk.LAUNCHES, rk.STEP_LAUNCHES
    launches += calls
    v, w = lat.state["v"], lat.graph.weights
    fired = int((lat.state["last_firing_time"] >= 0).sum())
    moved = (w - w0).abs().max().item()
    recs = kernel_records(lambda: lat.run_lattice(RECORD_STEPS),
                          RECORD_STEPS // 16 * 17)
    per_call = [a + b for a, b in zip(per_call, (
        calls, steps_launched, RECORD_STEPS // 16, sum(recs.values())))]
    say(f"[8 main path] STDP {MAIN[0]}x{MAIN[1]} run_lattice({MAIN_STEPS}): "
        f"route {lat._last_run_fused}, kernel calls {calls}, kernel launches "
        f"{steps_launched} ({steps_launched / calls:.2f} a call; profiled "
        f"{RECORD_STEPS} steps: {records_line(recs)}), v finite "
        f"{bool(torch.isfinite(v).all())}, weights finite "
        f"{bool(torch.isfinite(w).all())}, max weight change {moved:.4g}, "
        f"fired {fired} of {lat.n}")
    check(lat._last_run_fused == ("stdp", False), "STDP missed the kernel")
    check(calls == math.ceil(MAIN_STEPS / rk.STEPS_PER_LAUNCH),
          "wrong number of kernel calls")
    check(steps_launched == 17 * calls
          and sum(recs.values()) == RECORD_STEPS // 16 * 17
          and all("lp_step_kernel" in key for key in recs),
          "the STDP main path did not take the fused schedule")
    check(bool(torch.isfinite(v).all()) and bool(torch.isfinite(w).all())
          and moved > 0 and fired > 0, "bad STDP main-path state")
    lat.update_grid_history = True
    rk.LAUNCHES = 0
    lat.run_lattice(HIST_STEPS)
    launches += rk.LAUNCHES
    hist = np.stack(lat.grid_history.history)
    say(f"[8 main path] STDP grid history {HIST_STEPS} steps: shape "
        f"{hist.shape}, route {lat._last_run_fused}, finite "
        f"{bool(np.isfinite(hist).all())}")
    check(lat._last_run_fused == ("stdp", True)
          and hist.shape == (HIST_STEPS, *MAIN) and np.isfinite(hist).all(),
          "bad STDP history run")
    del lat, hist
    lat = main_lattice(snt, *MAIN, cls="RewardModulatedLattice")
    w0 = lat.graph.weights.clone()
    rk.LAUNCHES = rk.STEP_LAUNCHES = 0
    lat.run_lattice_with_reward(REWARD, MAIN_STEPS)
    dop = lat.dopamine
    lat.run_lattice(HIST_STEPS * 4)
    torch.cuda.synchronize()
    calls, steps_launched = rk.LAUNCHES, rk.STEP_LAUNCHES
    launches += calls
    v, w = lat.state["v"], lat.graph.weights
    moved = (w - w0).abs().max().item()
    say(f"[8 main path] R-STDP {MAIN[0]}x{MAIN[1]} run_lattice_with_reward("
        f"{REWARD}, {MAIN_STEPS}) + run_lattice({HIST_STEPS * 4}): route "
        f"{lat._last_run_fused}, kernel calls {calls}, dopamine {dop:.6g} -> "
        f"{lat.dopamine:.6g}, v finite {bool(torch.isfinite(v).all())}, "
        f"weights finite {bool(torch.isfinite(w).all())}, max weight change "
        f"{moved:.4g}, fired {int((lat.state['last_firing_time'] >= 0).sum())}"
        f" of {lat.n}")
    check(lat._last_run_fused is True, "R-STDP missed the kernel")
    check(calls == math.ceil(MAIN_STEPS / rk.STEPS_PER_LAUNCH)
          + math.ceil(HIST_STEPS * 4 / rk.STEPS_PER_LAUNCH),
          "wrong number of kernel calls")
    check(math.isfinite(dop) and dop == lat.dopamine
          and bool(torch.isfinite(v).all()) and bool(torch.isfinite(w).all())
          and moved > 0, "bad R-STDP main-path state")
    recs = kernel_records(
        lambda: lat.run_lattice_with_reward(REWARD, RECORD_STEPS),
        RECORD_STEPS // 16 * 17)
    per_call = [a + b for a, b in zip(per_call, (
        calls, steps_launched, RECORD_STEPS // 16, sum(recs.values())))]
    say(f"[8 main path] R-STDP kernel launches {steps_launched} "
        f"({steps_launched / calls:.2f} a call; profiled "
        f"run_lattice_with_reward({REWARD}, {RECORD_STEPS}): "
        f"{records_line(recs)})")
    check(steps_launched == 17 * calls
          and sum(recs.values()) == RECORD_STEPS // 16 * 17
          and all("lp_step_kernel" in key for key in recs),
          "the R-STDP main path did not take the fused schedule")
    del lat
    # the routed spec: STDP on ALIF at the main size takes the per-step
    # design (`rk.per_step_route`), 32 launches a call
    lat = snt.Lattice(snt.AdaptiveLeakyIntegrateAndFire())
    lat.populate(*MAIN, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    lat.do_plasticity = True
    rk.LAUNCHES = rk.STEP_LAUNCHES = 0
    lat.run_lattice(RECORD_STEPS)
    torch.cuda.synchronize()
    calls, steps_launched = rk.LAUNCHES, rk.STEP_LAUNCHES
    launches += calls
    finite = bool(torch.isfinite(lat.state["v"]).all()) \
        and bool(torch.isfinite(lat.graph.weights).all())
    say(f"[8 main path] STDP ALIF {MAIN[0]}x{MAIN[1]} run_lattice("
        f"{RECORD_STEPS}): route {lat._last_run_fused}, kernel calls {calls}"
        f", kernel launches {steps_launched} ({steps_launched / calls:.2f} a "
        f"call, the per-step design), state finite {finite}")
    check(lat._last_run_fused == ("stdp", False)
          and calls == RECORD_STEPS // 16 and steps_launched == 32 * calls
          and finite, "STDP on ALIF did not take its routed design")
    del lat
    for label, build, reward in (("STDP", bench_stdp, None),
                                 ("R-STDP", bench_rstdp, REWARD)):
        lat = build(snt, *SMALL)
        run_synced(lat, MAIN_STEPS, reward)
        v = lat.state["v"]
        say(f"[8 main path] bench.py {label} {SMALL[0]}x{SMALL[1]} "
            f"{MAIN_STEPS} steps: route {lat._last_run_fused}, v finite "
            f"{bool(torch.isfinite(v).all())}, v range [{v.min().item():.3f}, "
            f"{v.max().item():.3f}], fired "
            f"{int((lat.state['last_firing_time'] >= 0).sum())} of {lat.n}")
        check(lat._last_run_fused in (("stdp", False), True)
              and bool(torch.isfinite(v).all()), f"bad bench {label} run")

    # 9. 64^2 for 500 steps: the kernel route on the card against the
    # same route on the CPU, and against the plain route on the card.  The
    # reward lattice keeps no history on the kernel route, so its runs are
    # 1000 one-step calls with v read after each.
    def stdp_run(device, use_kernel):
        lat = bench_stdp(snt, *SMALL, use_kernel=use_kernel, device=device)
        lat.update_grid_history = True
        lat.run_lattice(PCMP_STEPS)
        return np.stack(lat.grid_history.history).reshape(PCMP_STEPS, -1), lat

    def rstdp_run(device, use_kernel):
        lat = bench_rstdp(snt, *SMALL, use_kernel=use_kernel, device=device,
                          v0=True)
        vs = []
        for _ in range(PCMP_STEPS):
            lat.run_lattice_with_reward(CMP_REWARD, 1)
            vs.append(lat.state["v"].clone())
        return torch.stack(vs).cpu().numpy(), lat

    for label, run, want_tag in (("STDP", stdp_run, ("stdp", True)),
                                 ("R-STDP", rstdp_run, True)):
        (hk, kl), (hc, cl), (hp, pl) = (run(device, uk) for device, uk in (
            ("cuda", None), ("cpu", True), ("cuda", False)))
        check(kl._last_run_fused == cl._last_run_fused == want_tag
              and pl._last_run_fused is False, f"wrong {label} routes")
        lk, lc, lp = (lat.state["last_firing_time"].cpu().numpy()
                      .astype(np.int64) for lat in (kl, cl, pl))
        wk, wc = (lat.graph.weights.cpu().numpy() for lat in (kl, cl))
        dv, dl = float(np.abs(hk - hc).max()), int(np.abs(lk - lc).max())
        dw = float(np.abs(wk - wc).max())
        say(f"[9 kernel-vs-cpu] {label} {SMALL[0]}x{SMALL[1]} {PCMP_STEPS} "
            f"steps, kernel route on the card vs on the CPU: max|dv| "
            f"{dv:.4g} mV, max|dlft| {dl} steps, max|dweight| {dw:.4g}, "
            f"fired {int((lk >= 0).sum())}")
        check(dv <= 2.0 and dl <= 2 and dw <= 1e-2,
              f"{label} card vs CPU outside 2 mV / 2 steps / 1e-2")
        tie_check(f"[9 kernel-vs-plain] {label} {SMALL[0]}x{SMALL[1]} "
                  f"{PCMP_STEPS} steps, fused vs plain association on the "
                  f"card", hk, lk, hp, lp, SMALL[0] * SMALL[1])
        del kl, cl, pl

    # 10. times: wall clock to a synchronise, in turns; kernel routes
    # median of 5 of MAIN_STEPS, plain routes median of 3 of fewer steps;
    # then the kernel route's device time per step under the profiler
    for label, make, reward in (
            ("STDP", lambda s, uk: stdp_lattice(snt, *s, use_kernel=uk), None),
            ("R-STDP", lambda s, uk: main_lattice(
                snt, *s, use_kernel=uk, cls="RewardModulatedLattice"),
             REWARD)):
        kind = "plastic" if label == "STDP" else "mod"
        for shape, plain_steps in ((SMALL, 256), (MAIN, 64)):
            kern, plain = make(shape, None), make(shape, False)
            run_synced(kern, MAIN_STEPS, reward)
            run_synced(plain, plain_steps, reward)
            tk, tp = [], []
            for rep in range(5):
                tk.append(run_synced(kern, MAIN_STEPS, reward))
                if rep < 3:
                    tp.append(run_synced(plain, plain_steps, reward))
            check(kern._last_run_fused in (("stdp", False), True)
                  and plain._last_run_fused is False, "timed the wrong routes")
            mk, mp = float(np.median(tk)), float(np.median(tp))
            dev_us, top = profiled_us(
                lambda: run_synced(kern, PROFILE_STEPS, reward), PROFILE_STEPS,
                launches=PROFILE_STEPS // 16 * 17, mine=("lp_",))
            busy = dev_us * MAIN_STEPS / (mk * 1e6)
            say(f"[10 times] {label} {shape[0]}x{shape[1]}: kernel route "
                f"{rate(shape, mk, MAIN_STEPS)}, median of 5 x {MAIN_STEPS} "
                f"steps; device time {dev_us:.3f} us/step (profiled, "
                + ", ".join(f"{k} {t:.3f}" for k, t in top)
                + f"), device time / wall {busy:.3f}; plain route "
                f"{rate(shape, mp, plain_steps)}, median of 3 x "
                f"{plain_steps} steps; card {smi}")
            del kern, plain
    rmain, smain = ("mod", "izhikevich", MAIN), ("plastic", "izhikevich", MAIN)
    rstdp, stdp = times[rmain], times[smain]
    return {"name": "lattice_plasticity_steps", "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/"
                      "lattice_plasticity.cu",
            "replaces": PLASTIC_REPLACES, "launches": launches,
            "max_abs_err": max_err,
            "ms": rstdp[0] * rk.STEPS_PER_LAUNCH,
            "plain_ms": rstdp[1] * rk.STEPS_PER_LAUNCH,
            "device_ms": rstdp[2] * rk.STEPS_PER_LAUNCH,
            "per_step_ms": rstdp[3] * rk.STEPS_PER_LAUNCH,
            "per_step_device_ms": rstdp[4] * rk.STEPS_PER_LAUNCH,
            # phase 8's main paths: launches the C entry counted, and the
            # profiler's kernel records, per 16-step call
            "kernel_launches_per_call": per_call[1] / per_call[0],
            "kernel_records_per_call": per_call[3] / per_call[2],
            "bound_ms": bounds[rmain][0], "bound_by": bounds[rmain][1],
            "library_ms": None,
            "stdp_ms": stdp[0] * rk.STEPS_PER_LAUNCH,
            "stdp_plain_ms": stdp[1] * rk.STEPS_PER_LAUNCH,
            "stdp_device_ms": stdp[2] * rk.STEPS_PER_LAUNCH,
            "stdp_bound_ms": bounds[smain][0]}


# ---------------------------------------------------------------------------
# The network kernels: phases 11-14
# ---------------------------------------------------------------------------


def one_to_one_coo(n, w):
    """The COO lists `connect_vectorized` gives a one-to-one predicate."""
    idx = np.arange(n, dtype=np.int64)
    return idx, idx.copy(), np.full(n, w, np.float32)


def pool_coo(rows, cols, w):
    """The COO lists of ``(pr // 2 == qr) & (pc // 2 == qc)`` from a
    rows x cols grid to its half-size grid, in `connect_vectorized`'s
    (pre, post) order."""
    r, c = np.divmod(np.arange(rows * cols, dtype=np.int64), cols)
    return (np.arange(rows * cols, dtype=np.int64),
            (r // 2) * (cols // 2) + c // 2,
            np.full(rows * cols, w, np.float32))


def upsample_coo(rows, cols, w):
    """The COO lists of ``(pr == qr // 2) & (pc == qc // 2)`` from a
    rows x cols grid to its double-size grid, in (pre, post) order."""
    n = rows * cols
    r, c = np.divmod(np.arange(n, dtype=np.int64), cols)
    dst = np.stack([(2 * r + a) * (2 * cols) + 2 * c + b
                    for a in (0, 1) for b in (0, 1)], axis=1)
    return (np.repeat(np.arange(n, dtype=np.int64), 4), dst.reshape(-1),
            np.full(4 * n, w, np.float32))


def connect_grid(net, pre, post, coo, fn):
    """Connect ``pre`` -> ``post`` through `connect_vectorized` (an
    O(N_pre * N_post) host evaluation) up to 64^2 grids, checking that it
    gives ``coo``; above that, where the predicate would take hours, set
    the host COO lists it would give (before the network's first run)."""
    n_pre = (net.lattices.get(pre) or net.spike_train_lattices[pre]).n
    if n_pre * net.lattices[post].n <= 4096 * 4096:
        net.connect_vectorized(pre, post, fn)
        got = net.connections[(pre, post)]
        check(all(np.array_equal(a, b) for a, b in zip(got, coo)),
              "a COO helper differs from connect_vectorized")
    else:
        net.connections[(pre, post)] = coo


def poisson_train(snt, id, rows, cols, hertz, device):
    st = snt.SpikeTrainLattice(snt.PoissonSpikeTrain(), id=id, device=device)
    st.populate(rows, cols)
    st.state = st.model.init_from_firing_rate(rows * cols, hertz=hertz,
                                              dt=0.1, device=device)
    return st


def rate_train(snt, id, rows, cols, device):
    st = snt.SpikeTrainLattice(snt.RateSpikeTrain(), id=id, device=device)
    st.populate(rows, cols, rate=1.0)
    return st


def cfg2_net(snt, rows, cols, use_kernel=None, device="cuda", seed=0):
    """BASELINE config 2 (`bench.py:194-230`): an ALIF lattice (gap 10,
    radius 2, keep 0.8, graph seed 3) fed one to one, weight 5, by a
    Poisson train at 50 Hz."""
    lat = snt.Lattice(snt.AdaptiveLeakyIntegrateAndFire(), id=0,
                      device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=3)
    st = poisson_train(snt, 1, rows, cols, 50.0, device)
    net = snt.LatticeNetwork.generate_network([lat], [st])
    connect_grid(net, 1, 0, one_to_one_coo(rows * cols, 5.0),
                 lambda pr, pc, qr, qc: np.where((pr == qr) & (pc == qc),
                                                 5.0, np.nan))
    net.seed, net.use_kernel = seed, use_kernel
    return net


def cfg5_net(snt, rows, cols, use_kernel=None, device="cuda", seed=0,
             train="poisson", eeg=True):
    """BASELINE config 5 (`bench.py:233-291`): a plastic Izhikevich
    excitatory grid (gap 10, radius 2, keep 0.8, graph seed 5) with an EEG
    history, a half-size inhibitory grid (radius 1.5, graph seed 6) wired
    to it by pooling (0.5) and upsampling (-0.8) connections, and a
    Poisson train at 25 Hz feeding the excitatory grid one to one, weight
    4 (``train="rate"``: a Rate train of 1 ms instead)."""
    exc = snt.Lattice(snt.Izhikevich(), id=0, device=device)
    exc.populate(rows, cols, gap_conductance=10.0)
    exc.connect_stencil(radius=2.0, keep_prob=0.8, seed=5)
    exc.do_plasticity = True
    if eeg:
        exc.grid_history = snt.history.EEGHistory()
        exc.update_grid_history = True
    inh = snt.Lattice(snt.Izhikevich(), id=1, device=device)
    inh.populate(rows // 2, cols // 2, gap_conductance=10.0)
    inh.connect_stencil(radius=1.5, seed=6)
    st = poisson_train(snt, 2, rows, cols, 25.0, device) \
        if train == "poisson" else rate_train(snt, 2, rows, cols, device)
    net = snt.LatticeNetwork.generate_network([exc, inh], [st])
    connect_grid(net, 2, 0, one_to_one_coo(rows * cols, 4.0),
                 lambda pr, pc, qr, qc: np.where((pr == qr) & (pc == qc),
                                                 4.0, np.nan))
    connect_grid(net, 0, 1, pool_coo(rows, cols, 0.5),
                 lambda pr, pc, qr, qc: np.where(
                     (pr // 2 == qr) & (pc // 2 == qc), 0.5, np.nan))
    connect_grid(net, 1, 0, upsample_coo(rows // 2, cols // 2, -0.8),
                 lambda pr, pc, qr, qc: np.where(
                     (pr == qr // 2) & (pc == qc // 2), -0.8, np.nan))
    net.history_chunk = CFG5_STEPS
    net.seed, net.use_kernel = seed, use_kernel
    return net


def plain_if_net(snt, rows, cols, use_kernel=None, device="cuda", seed=0,
                 model="alif"):
    """Two plastic ALIF or LIF lattices (radius 2 / keep 0.8 and radius
    1.5 / keep 0.9), a Rate train feeding the first one to one (30) and
    the first feeding the second one to one (8)."""
    cls = {"alif": snt.AdaptiveLeakyIntegrateAndFire,
           "lif": snt.LeakyIntegrateAndFire}[model]
    lats = []
    for lid, (radius, keep) in enumerate(((2.0, 0.8), (1.5, 0.9))):
        lat = snt.Lattice(cls(), id=lid, device=device)
        lat.populate(rows, cols, gap_conductance=10.0)
        lat.connect_stencil(radius=radius, keep_prob=keep, seed=3 + lid)
        lat.do_plasticity = True
        lats.append(lat)
    st = rate_train(snt, 2, rows, cols, device)
    net = snt.LatticeNetwork.generate_network(lats, [st])
    for pre, post, w in ((2, 0, 30.0), (0, 1, 8.0)):
        connect_grid(net, pre, post, one_to_one_coo(rows * cols, w),
                     lambda pr, pc, qr, qc, w=w: np.where(
                         (pr == qr) & (pc == qc), w, np.nan))
    net.seed, net.use_kernel = seed, use_kernel
    return net


def perturb(net, seed, uniform=True):
    """Random v0 across the threshold and past firing times for 30% of
    the neurons (clock 3), so that a 16-step call spikes and changes
    weights; with ``uniform=False``, also non-uniform a, d, v_th, tref,
    g_l by up to 10%."""
    rng = np.random.default_rng(seed)
    for lat in net.lattices.values():
        n, dev = lat.n, lat.device
        izh = "c" in lat.state
        lo, hi = (-60.0, 50.0) if izh else (-75.0, -50.0)
        f32 = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)
        upd = {"v": f32(rng.uniform(lo, hi, n)),
               "last_firing_time": torch.as_tensor(
                   np.where(rng.random(n) < 0.3, rng.integers(0, 3, n),
                            -1).astype(np.int32), device=dev)}
        if not uniform:
            for k in ("a", "d", "v_th", "tref", "g_l"):
                if k in lat.state:
                    upd[k] = lat.state[k] * f32(rng.uniform(0.9, 1.1, n))
        lat.apply(lambda s, upd=upd: {**s, **upd})
    net.internal_clock = 3


def net_inputs(nk, net, n_steps, seed):
    """One kernel call's inputs from a network's members, with the Poisson
    uniforms drawn from ``seed``: (spec, lats, trains, conns, uniforms,
    rule)."""
    from spiking_neural_networks_tpu_torch.core.structured import (
        nt_flags, resolve_structured_plan)
    plan = resolve_structured_plan(net)
    spec = nk.plain_network_spec(net, plan, not any(nt_flags(net, plan)))
    check(spec is not None, "the network is outside the kernels' class")
    lats, trains, conns = nk.member_inputs(spec, net, plan)
    dev = lats[0]["v"].device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    uniforms = [torch.rand((n_steps, *ts.shape), generator=g, device=dev)
                if ts.kind == "poisson" else None for ts in spec.trains]
    return spec, lats, trains, conns, uniforms, net._plasticity().params


def compare_net_call(got, want, clock0):
    """(max float error, integer/spike mismatches, errors by name, neurons
    fired in the call, largest connection weight change) of a network
    kernel call against its twin."""
    errs, bad = {}, 0
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        for key in ("v", "w", "lft", "refr", "spikes", "weights", "v_pre"):
            if g[key] is None:
                continue
            if g[key].dtype in (torch.int32, torch.bool) or key == "refr":
                bad += int((g[key] != w[key]).sum())
            else:
                check(bool(torch.isfinite(g[key]).all()),
                      f"non-finite {key} of lattice {k}")
                torch.testing.assert_close(g[key], w[key], rtol=RTOL,
                                           atol=ATOL, msg=f"{key} {k}")
                errs[f"{key}{k}"] = (g[key] - w[key]).abs().max().item()
    for g, w in zip(got[1], want[1]):
        bad += int((g["lft"] != w["lft"]).sum())
        bad += int((g["spikes"] != w["spikes"]).sum())
        if g["step"] is not None:
            torch.testing.assert_close(g["step"], w["step"], rtol=RTOL,
                                       atol=ATOL)
    for c, (g, w) in enumerate(zip(got[2], want[2])):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=f"c{c}")
        errs[f"conn{c}"] = (g - w).abs().max().item()
    fired = sum(int((g["lft"] >= clock0).sum()) for g in got[0])
    return max(errs.values()), bad, errs, fired


def network_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
    max_err, times, bounds = network_twin_phase(snt, nk, smi)
    launches = network_main_phase(snt, nk)
    network_cmp_phase(snt)
    network_times_phase(snt, nk, smi)
    return {"name": "network_persistent", "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/"
                      "network_persistent.cu",
            "replaces": NET_REPLACES, "launches": launches,
            "max_abs_err": max_err,
            "ms": times["persistent"][0] * nk.STEPS_PER_LAUNCH,
            "plain_ms": times["twin"] * nk.STEPS_PER_LAUNCH,
            "device_ms": times["persistent"][1] * nk.STEPS_PER_LAUNCH,
            "per_step_ms": times["per_step"][0] * nk.STEPS_PER_LAUNCH,
            "per_step_device_ms": times["per_step"][1]
            * nk.STEPS_PER_LAUNCH,
            "bound_ms": bounds[0], "bound_by": bounds[1], "library_ms": None}


def net_outputs(out):
    """(name, tensor) pairs of a network kernel call's outputs."""
    lat, tr, cn, extra = out
    pairs = []
    for k, d in enumerate(lat):
        for key in ("v", "w", "lft", "refr", "spikes", "weights", "v_pre"):
            if d.get(key) is not None:
                pairs.append((f"{key}{k}", d[key]))
        if d.get("traces") is not None:
            pairs += [(f"{key}{k}", d["traces"][key])
                      for key in ("c", "dw", "counter")]
        if d.get("chem") is not None:
            pairs += [(f"{key}{k}", x) for key, x in sorted(d["chem"].items())]
    for j, d in enumerate(tr):
        pairs += [(f"train {key}{j}", d[key])
                  for key in ("lft", "spikes", "step", "ntt")
                  if d.get(key) is not None]
    pairs += [(f"conn{c}", w) for c, w in enumerate(cn)]
    if extra is not None:
        for c, t in enumerate(extra["traces"]):
            if t is not None:
                pairs += [(f"conn{c} {key}", t[key])
                          for key in ("c", "dw", "counter")]
        pairs.append(("dopamine", torch.as_tensor(extra["dopamine"])))
    return pairs


def bit_mismatches(got, want):
    """The outputs of a network call that differ from the twin's in any
    bit (floats as their int32 bits, so +0 and -0 apart); an output that
    one side lacks is a mismatch too."""
    gots, wants = net_outputs(got), net_outputs(want)
    names = [n for n, _ in gots]
    if names != [n for n, _ in wants]:
        return sorted(set(names) ^ {n for n, _ in wants}) or ["output order"]
    bad = []
    for (name, g), (_, w) in zip(gots, wants):
        w = w.to(g.device)
        if g.dtype == torch.float32 and w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape or not torch.equal(g, w):
            bad.append(name)
    return bad


def per_step_launches(spec, n_steps):
    """Kernel launches of one call of the per-step design (`net_steps`):
    cnt per lattice, the dense jobs' constants (one launch per 32 dense
    graphs and blocks), the dopamine per 16 rewards, then per step the
    effects of each train that feeds a dense block, the dense gathers, a
    cell kernel per lattice, an edge kernel per plastic or mod lattice
    with offsets and per updating connection, a train kernel per train."""
    jobs = sum(ls.graph == "dense" for ls in spec.lattices) \
        + sum(cs.op[0] == "dense" for cs in spec.conns)
    gathers = -(-jobs // 32)
    per = (len(spec.lattices)
           + sum(ls.kind != "plain" and bool(ls.offsets)
                 for ls in spec.lattices)
           + sum(cs.updates for cs in spec.conns) + len(spec.trains)
           + sum(cs.op[0] == "dense" and cs.pre_is_st for cs in spec.conns)
           + gathers)
    return len(spec.lattices) + gathers + (
        -(-n_steps // 16) if spec.with_reward else 0) + n_steps * per


def persistent_call(nk, args, clock, k, reward=None):
    """One call of the persistent kernel on ``args`` whatever route
    `uses_persistent` gives its spec (its launcher, at `SMEM_BUDGET`),
    checked, not counted: the comparison of the designs."""
    from spiking_neural_networks_tpu_torch import _build
    rc, out = nk._launch_persistent(
        _build.load(), *args, clock, k,
        torch.cuda.current_stream().cuda_stream, reward, nk.SMEM_BUDGET)
    check(rc == 0, f"net_persistent_steps failed with CUDA error {rc}")
    return out


# the persistent kernel's instantiations (`net_persistent_info`'s variant:
# chemical + 2 flat) and their template arguments in ptxas's entry names
NP_VARIANTS = (("electrical", "ILi640ELb0ELb0E"),
               ("chemical", "ILi512ELb1ELb0E"),
               ("flat", "ILi512ELb0ELb1E"),
               ("flat-chemical", "ILi512ELb1ELb1E"))


def persistent_info(nk, spec):
    """The persistent kernel's residency plan for ``spec`` on this card and
    its launch: (members, shared bytes a block, {regs, local, static smem,
    blocks, sms})."""
    from spiking_neural_networks_tpu_torch import _build
    members, smem = nk.persistent_plan(spec, nk._sm_count(
        torch.device("cuda")))
    out = (ctypes.c_int * 6)()
    variant = bool(spec.chem) + 2 * nk.is_flat(spec)
    rc = _build.load().net_persistent_info(variant, smem, out)
    check(rc == 0, f"net_persistent_info failed with CUDA error {rc}")
    return members, smem, dict(regs=out[0], local=out[1], static=out[2],
                               blocks=out[4], sms=out[5])


def variant_lines(nk, variants):
    """Per instantiation in ``variants`` (indices of `NP_VARIANTS`): its
    ptxas lines, registers, local (spill and stack) bytes a thread and
    grid at no resident member; fails on spills.  Returns the lines and
    the registers of each."""
    from spiking_neural_networks_tpu_torch import _build
    lines, regs = [], []
    for v in variants:
        name, tag = NP_VARIANTS[v]
        out = (ctypes.c_int * 6)()
        rc = _build.load().net_persistent_info(v, 0, out)
        check(rc == 0, f"net_persistent_info failed with CUDA error {rc}")
        ptx = " / ".join(ptxas_lines("net_persistent_kernel" + tag)) \
            or "ptxas: cached build"
        check(out[1] == 0, f"the {name} instantiation spills")
        lines.append(f"{name} instantiation: {ptx}; {out[0]} registers, "
                     f"{out[1]} local bytes a thread, blocks of {out[3]} "
                     f"threads")
        regs.append(out[0])
    return lines, regs


def plan_line(members, smem):
    return (", ".join(f"{m.key[0]} {m.key[1]} "
                      f"{'resident' if m.resident else 'streamed'} "
                      f"{m.cell_bytes * m.cells / 1e6:.2f} MB"
                      for m in members)
            + f"; {smem} B of shared memory a block")


def ptxas_lines(name):
    """ptxas's register and spill lines of the last instantiation of
    kernel ``name`` in the build log (empty when the library was cached)."""
    found = instantiation_lines(name)
    return found[-1][1].split("; ") if found else []


def instantiation_lines(name):
    """ptxas's registers and spills of every instantiation of kernel
    ``name`` in the build log, as (mangled entry, report); fails on a
    spill.  Empty when the library was cached."""
    from spiking_neural_networks_tpu_torch import _build
    lines = _build.build_log.splitlines()
    out = []
    for k, ln in enumerate(lines):
        if "Compiling entry function" in ln and name in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
            rep = [x.strip().replace("ptxas info    : ", "")
                   for x in lines[k + 1:k + 4]
                   if "spill" in x or "registers" in x]
            out.append((entry, "; ".join(rep)))
            check(all("0 bytes spill stores, 0 bytes spill loads" in x
                      for x in rep if "spill" in x), f"{entry} spills: {rep}")
    return out


def sync_us(blocks, n_syncs=1000):
    """Microseconds of one grid.sync() of a cooperative launch of
    ``blocks`` blocks at the persistent kernel's block size."""
    from spiking_neural_networks_tpu_torch import _build
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        rc = lib.net_persistent_sync_probe(blocks, n_syncs, stream)
        check(rc == 0, f"the grid.sync probe failed with CUDA error {rc}")

    return event_ms(fn, 5) * 1e3 / n_syncs


def design_times(nk, args, clock, k, reward=None, reps=10, count=True):
    """Both designs of one K-step network call on the same inputs, in
    turns (`designs_in_turns`): the persistent kernel through
    `network_steps` where the spec's route takes it, else through
    `persistent_call`, and the per-step launches.  With ``count``, the
    profile of ``reps`` calls must hold every launch's record; without,
    its device time sums the records that came back."""
    spec = args[0]
    routed = nk.uses_persistent(spec, nk._sm_count(torch.device("cuda")))
    calls = {"persistent": (lambda: nk.network_steps(*args, clock, k,
                                                     reward)) if routed
             else (lambda: persistent_call(nk, args, clock, k, reward)),
             "per_step": lambda: nk.network_steps(*args, clock, k, reward,
                                                  per_step=True)}
    launches = {"persistent": -(-k // nk.STEPS_PER_LAUNCH),
                "per_step": per_step_launches(spec, k)}
    return designs_in_turns(calls, launches, k, reps, count)


def design_line(out, counted=True):
    return "; ".join(
        f"{key}: wall {w:.3f} us/step, events {e:.3f}, device {d:.3f} "
        f"({n} kernel {'records' if counted else 'launches'} a call; "
        + ", ".join(f"{name} {t:.3f}" for name, t in top) + ")"
        for key, (w, e, d, n, top) in out.items())


def host_split(nk, args, clock, k, reward=None, reps=20):
    """Host microseconds of one persistent wrapper call with the card idle
    at its start, and of that the input checks and the output
    allocations; the rest is the ctypes packing, the C entry and the
    launch."""
    spec, lats, trains, conns, uniforms, rule = args
    dev = lats[0]["v"].device
    fns = (lambda: nk.network_steps(*args, clock, k, reward),
           lambda: nk._check(spec, lats, trains, conns, uniforms, clock, k,
                             reward),
           lambda: nk._persistent_outputs(spec, lats, trains, conns, k, dev))
    out = []
    for fn in fns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return out


def network_twin_phase(snt, nk, smi):
    """11. The network kernels vs their plain twin on the card, the
    persistent kernel and the per-step design both bit for bit: (max float
    error, {design: (kernel us, device us) per step, "twin": us per step}
    at 512^2, the bound of a 512^2 call)."""
    cases = [(cfg2_net, NSMALL, 16, "config 2"),
             (cfg2_net, NSMALL, 7, "config 2"),
             (cfg5_net, NSMALL, 16, "config 5"),
             (cfg5_net, NSMALL, 7, "config 5"),
             (lambda *a, **k: plain_if_net(*a, **k, model="alif"), NSMALL,
              16, "ALIF + Rate"),
             (lambda *a, **k: plain_if_net(*a, **k, model="lif"), NSMALL,
              16, "LIF + Rate"),
             (lambda *a, **k: cfg5_net(*a, **k, train="rate"), (130, 100),
              16, "config 5 + Rate, non-uniform"),
             (cfg5_net, NBIG, 16, "config 5 emit")]
    max_err, times = 0.0, None
    for seed, (build, shape, k, label) in enumerate(cases):
        net = build(snt, *shape, seed=seed)
        perturb(net, seed, uniform="non-uniform" not in label)
        spec, lats, trains, conns, uniforms, rule = net_inputs(nk, net, k,
                                                               seed)
        args = (spec, lats, trains, conns, uniforms, rule)
        before = nk.PERSISTENT_LAUNCHES
        got = nk.network_steps(*args, 3, k)
        torch.cuda.synchronize()
        check(nk.PERSISTENT_LAUNCHES == before + 1,
              "the call missed the persistent kernel")
        want = nk.network_steps_reference(*args, 3, k)
        torch.cuda.synchronize()
        ps = nk.network_steps(*args, 3, k, per_step=True)
        torch.cuda.synchronize()
        err, bad, errs, fired = compare_net_call(got, want, 3)
        bits = (bit_mismatches(got, want), bit_mismatches(ps, want))
        moved = max((g - c["w"]).abs().max().item()
                    for g, c in zip(got[2], conns))
        say(f"[11 kernel-vs-twin] {label} {shape[0]}x{shape[1]} K={k} "
            f"emit={any(ls.emit for ls in spec.lattices)}: persistent "
            f"kernel: integer and spike mismatches {bad}, max errors "
            + " ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f", outputs not bit-equal {bits[0]}; per-step design: outputs "
            f"not bit-equal {bits[1]}; neurons fired {fired}, max "
            f"connection weight change {moved:.4g}")
        check(bad == 0, "firing times, spikes or refractory counts differ")
        check(bits == ([], []), "a design is not bit-equal to the twin")
        check(fired > 0, "no neuron fired in the call")
        max_err = max(max_err, err)
        if shape == NBIG:
            members, smem, info = persistent_info(nk, spec)
            check(all(m.resident for m in members),
                  "config 5 at 512^2 is not all resident")
            # a lower bound of the operations: each lattice's phase A and
            # model step (connections, trains and STDP not counted)
            ops = sum(stencil_ops(ls.offsets, *ls.shape, k)
                      for ls in spec.lattices)
            bounds = bound(tensor_bytes(lats, trains, conns, uniforms, got),
                           ops)
            ptx = " / ".join(ptxas_lines("net_persistent_kernel"
                                         + NP_VARIANTS[0][1])) \
                or "ptxas: cached build"
            say(f"[11 persistent kernel] {ptx}; {info['regs']} registers, "
                f"{info['local']} local bytes a thread, {info['static']} "
                f"static shared bytes; grid {info['blocks']} blocks of "
                f"{nk.NP_THREADS} threads on {info['sms']} SMs; one "
                f"grid.sync() {sync_us(info['blocks']):.3f} us; config 5 "
                f"512^2 plan: {plan_line(members, smem)}; card {smi}")
            d = design_times(nk, args, 3, k)
            twin = event_ms(lambda: nk.network_steps_reference(*args, 3, k),
                            3) / k * 1e3
            times = {key: (v[1] / 1e3, v[2] / 1e3) for key, v in d.items()}
            times["twin"] = twin / 1e3
            host = host_split(nk, args, 3, k)
            say(f"[11 kernel-vs-twin] {label} {shape[0]}x{shape[1]} K={k} "
                f"per step, the designs in turns: {design_line(d)}; plain "
                f"twin {twin:.3f} us (events); bound "
                f"{bounds[0] * 1e3 / k:.4f} us ({bounds[1]}); host time of "
                f"a persistent call {host[0]:.1f} us, of which input checks "
                f"{host[1]:.1f} us, output buffers {host[2]:.1f} us, the "
                f"rest (ctypes packing, C entry, launch) "
                f"{host[0] - host[1] - host[2]:.1f} us; card {smi}")
        del net, lats, trains, conns, uniforms, got, want, ps, args
    # a grid-mode spec of more members than the persistent kernel's
    # description holds takes the per-step launches, chosen from the spec
    net = cfg5_net(snt, *NSMALL, seed=12)
    perturb(net, 12)
    spec, lats, trains, conns, uniforms, rule = net_inputs(nk, net, 16, 12)
    n = nk.NP_MAX_TR + 1
    args = (spec._replace(trains=spec.trains * n), lats, trains * n, conns,
            uniforms * n, rule)
    before = (nk.LAUNCHES, nk.PERSISTENT_LAUNCHES)
    got = nk.network_steps(*args, 3, 16)
    torch.cuda.synchronize()
    bad = bit_mismatches(got, nk.network_steps_reference(*args, 3, 16))
    say(f"[11 kernel-vs-twin] config 5 {NSMALL[0]}x{NSMALL[1]} with {n} "
        f"trains: kernel calls {nk.LAUNCHES - before[0]}, persistent "
        f"{nk.PERSISTENT_LAUNCHES - before[1]}; outputs not bit-equal {bad}")
    check(not nk.uses_persistent(args[0])
          and (nk.LAUNCHES, nk.PERSISTENT_LAUNCHES) == (before[0] + 1,
                                                        before[1])
          and not bad,
          "a spec beyond the persistent kernel's members missed the "
          "per-step kernels or differs from the twin")
    del net, lats, trains, conns, uniforms, got, args
    # the streamed form: config 5's topology at 1024^2 / 512^2, whose
    # excitatory stencil (63 MB) does not fit; a few calls along a run,
    # each held against the twin
    net = cfg5_net(snt, *NHUGE, seed=11, eeg=False)
    perturb(net, 11)
    for call_no in range(NHUGE_CALLS):
        args = net_inputs(nk, net, 16, call_no)
        clock = net.internal_clock
        if call_no == 0:
            members, smem, info = persistent_info(nk, args[0])
            check(not members[0].resident
                  and all(m.resident for m in members[1:]),
                  "the 1024^2 plan should stream the excitatory stencil only")
        got = nk.network_steps(*args, clock, 16)
        torch.cuda.synchronize()
        want = nk.network_steps_reference(*args, clock, 16)
        bad = bit_mismatches(got, want)
        fired = sum(int((g["lft"] >= clock).sum()) for g in got[0])
        say(f"[11 kernel-vs-twin] config 5 {NHUGE[0]}x{NHUGE[1]} / "
            f"{NHUGE[0] // 2}^2 streamed, call {call_no} at clock {clock}: "
            f"outputs not bit-equal {bad}, neurons fired {fired}"
            + (f"; plan: {plan_line(members, smem)}" if call_no == 0
               else ""))
        check(not bad and fired > 0,
              "the streamed form differs from the twin or did not fire")
        if call_no == NHUGE_CALLS - 1:
            # the profiler has kept 2 of 3 records of these long calls:
            # their device time sums what came back, uncounted
            d = design_times(nk, args, clock, 16, reps=5, count=False)
            say(f"[11 kernel-vs-twin] config 5 {NHUGE[0]}x{NHUGE[1]} "
                f"streamed per step, the designs in turns: "
                f"{design_line(d, counted=False)}; card {smi}")
        del got, want, args
        net.run_lattices(16)
    del net
    say(f"[11 kernel-vs-twin] max float error over all cases {max_err:.3g} "
        f"(tolerance rtol {RTOL}, atol {ATOL}; 0 = bit-equal)")
    return max_err, times, bounds


def network_main_phase(snt, nk):
    """12. The network main paths through `run_lattices`; returns the
    persistent kernel's launches in them."""
    launches = 0
    for label, build, shape, steps in (
            ("config 2", cfg2_net, NSMALL, CFG2_STEPS),
            ("config 5", cfg5_net, NSMALL, CFG5_STEPS),
            ("config 5 topology", cfg5_net, NBIG, NBIG_STEPS)):
        net = build(snt, *shape)
        ws0 = {lid: l.graph.weights.clone() for lid, l in net.lattices.items()
               if l.do_plasticity}
        nk.LAUNCHES = nk.PERSISTENT_LAUNCHES = 0
        secs = run_net_synced(net, steps)
        calls = nk.LAUNCHES
        launches += nk.PERSISTENT_LAUNCHES
        check(nk.PERSISTENT_LAUNCHES == calls,
              f"{label}: a call missed the persistent kernel")
        exc = net.lattices[0]
        v = exc.state["v"]
        fired = sum(int((l.state["last_firing_time"] >= 0).sum())
                    for l in net.lattices.values())
        tr_fired = sum(int((s.state["last_firing_time"] >= 0).sum())
                       for s in net.spike_train_lattices.values())
        n_all = sum(l.n for l in net.lattices.values())
        moved = max([(net.lattices[lid].graph.weights - w0).abs().max().item()
                     for lid, w0 in ws0.items()], default=None)
        eeg = exc.grid_history.history if exc.update_grid_history else None
        say(f"[12 main path] {label} {shape[0]}x{shape[1]} run_lattices("
            f"{steps}): route {net._last_run_fused}, kernel calls {calls} "
            f"(persistent {nk.PERSISTENT_LAUNCHES}), "
            f"{secs / steps * 1e6:.3f} us/step (first run), v finite "
            f"{bool(torch.isfinite(v).all())}, v range [{v.min().item():.3f}"
            f", {v.max().item():.3f}], fired {fired} of {n_all} (trains "
            f"{tr_fired}), max weight "
            f"change {'n/a (no plasticity)' if moved is None else f'{moved:.4g}'}"
            + ("" if eeg is None else
               f", EEG samples {len(eeg)}, EEG range [{min(eeg):.5g}, "
               f"{max(eeg):.5g}]"))
        check(net._last_run_fused == ("network", eeg is not None),
              f"{label} missed the network kernels")
        check(calls == math.ceil(steps / nk.STEPS_PER_LAUNCH),
              "wrong number of kernel calls")
        # config 2 as bench.py sets it stays below threshold (v rises from
        # -75 mV towards -59 mV in 5000 steps): its trains fire, and its
        # lattice must have moved
        check(all(bool(torch.isfinite(l.state["v"]).all())
                  for l in net.lattices.values())
              and (fired > 0 if build is not cfg2_net
                   else tr_fired > 0 and v.max().item() > -70.0),
              f"bad {label} state")
        check(moved is None or moved > 0, f"{label}: no weight moved")
        check(eeg is None or (len(eeg) == steps
                              and bool(np.isfinite(eeg).all())),
              f"bad {label} EEG history")
        del net
    return launches


def network_cmp_phase(snt):
    """13. 64^2 / 32^2, Rate train, 500 steps: the kernel route on the
    card against the same route on the CPU and against the plain route."""
    runs = {}
    for key, device, uk in (("kernel", "cuda", None), ("cpu", "cpu", True),
                            ("plain", "cuda", False)):
        net = cfg5_net(snt, *NSMALL, use_kernel=uk, device=device,
                       train="rate", eeg=False)
        exc = net.lattices[0]
        exc.grid_history = snt.history.GridVoltageHistory()
        exc.update_grid_history = True
        net.run_lattices(NCMP_STEPS)
        runs[key] = (np.stack(exc.grid_history.history).reshape(
                         NCMP_STEPS, -1),
                     exc.field("last_firing_time").reshape(-1)
                     .astype(np.int64),
                     net.lattices[1].field("last_firing_time").reshape(-1)
                     .astype(np.int64),
                     exc.graph.weights.cpu().numpy(), net._last_run_fused)
    check(runs["kernel"][4] == runs["cpu"][4] == ("network", True)
          and runs["plain"][4] is False, "wrong network routes")
    hk, lk, ik, wk, _ = runs["kernel"]
    hc, lc, ic, wc, _ = runs["cpu"]
    dv = float(np.abs(hk - hc).max())
    dl = max(int(np.abs(lk - lc).max()), int(np.abs(ik - ic).max()))
    dw = float(np.abs(wk - wc).max())
    say(f"[13 kernel-vs-cpu] config 5 + Rate {NSMALL[0]}x{NSMALL[1]} "
        f"{NCMP_STEPS} steps, kernel route on the card vs on the CPU: "
        f"max|dv| {dv:.4g} mV, max|dlft| {dl} steps, max|dweight| {dw:.4g}, "
        f"fired {int((lk >= 0).sum())}")
    check(dv <= 2.0 and dl <= 2 and dw <= 1e-2,
          "card vs CPU outside 2 mV / 2 steps / 1e-2")
    hp, lp, _, _, _ = runs["plain"]
    tie_check(f"[13 kernel-vs-plain] config 5 + Rate {NSMALL[0]}x"
              f"{NSMALL[1]} {NCMP_STEPS} steps, fused vs plain association "
              f"on the card", hk, lk, hp, lp, NSMALL[0] * NSMALL[1])


def network_times_phase(snt, nk, smi):
    """14. Times, stated explicitly, in turns: the main path's route
    (`use_kernel=None`: the persistent kernel) and the plain route
    (`use_kernel=False`) through `run_lattices`; then the persistent and
    the per-step design on the same 16-step calls."""
    for shape, kern_steps, plain_steps in ((NSMALL, 2048, 128),
                                           (NBIG, 2048, 32)):
        kern = cfg5_net(snt, *shape, use_kernel=None, eeg=False)
        plain = cfg5_net(snt, *shape, use_kernel=False, eeg=False)
        run_net_synced(kern, kern_steps)
        run_net_synced(plain, plain_steps)
        tk, tp = [], []
        for rep in range(5):
            tk.append(run_net_synced(kern, kern_steps))
            if rep < 3:
                tp.append(run_net_synced(plain, plain_steps))
        check(kern._last_run_fused == ("network", False)
              and plain._last_run_fused is False, "timed the wrong routes")
        mk, mp = float(np.median(tk)), float(np.median(tp))
        dev_us, top = profiled_us(lambda: run_net_synced(kern, PROFILE_STEPS),
                                  PROFILE_STEPS, n_top=8)
        n_all = sum(l.n for l in kern.lattices.values())
        busy = dev_us * kern_steps / (mk * 1e6)
        say(f"[14 times] config 5 topology {shape[0]}x{shape[1]}: kernel "
            f"route (use_kernel=None, the persistent kernel) "
            f"{net_rate(n_all, mk, kern_steps)}, median of 5 x {kern_steps} "
            f"steps; device time {dev_us:.3f} us/step (profiled: "
            + ", ".join(f"{k} {t:.3f}" for k, t in top)
            + f"), device time / wall {busy:.3f}; plain route "
            f"(use_kernel=False) {net_rate(n_all, mp, plain_steps)}, median "
            f"of 3 x {plain_steps} steps; card {smi}")
        args = net_inputs(nk, kern, nk.STEPS_PER_LAUNCH, 1)
        clock = kern.internal_clock
        d = design_times(nk, args, clock, nk.STEPS_PER_LAUNCH)
        host = host_split(nk, args, clock, nk.STEPS_PER_LAUNCH)
        say(f"[14 times] config 5 topology {shape[0]}x{shape[1]}, 16-step "
            f"calls, the designs in turns: {design_line(d)}; host time of a "
            f"persistent call {host[0]:.1f} us, of which input checks "
            f"{host[1]:.1f} us, output buffers {host[2]:.1f} us; card {smi}")
        del kern, plain, args


def run_net_synced(net, n):
    t0 = time.perf_counter()
    net.run_lattices(n)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def net_rate(n, secs, steps):
    return (f"{n * steps / secs:.4e} neuron-updates/s, "
            f"{steps / secs:.1f} steps/s ({secs / steps * 1e6:.3f} us/step)")


# ---------------------------------------------------------------------------
# The HH chemical kernel: phases 15-18
# ---------------------------------------------------------------------------


def hh_lattice(snt, rows, cols, use_kernel=None, device="cuda", firing=True):
    """`bench.py`'s HH lattice (`bench.py:158-172`): AMPA, NMDA and GABA
    receptors and neurotransmitters, gap 10, radius 2, keep 0.8, graph seed
    11, chemical synapses, STDP; its gates start at 0, and its uniform
    neurons all fire once, in one step, so that STDP's delta is 0 and no
    weight moves.  With ``firing``, the firing form of the JAX package's HH kernel tests:
    equilibrium gates (m 0.05, h 0.6, n 0.32), v0 uniform in [-65, -20)
    from ``default_rng(9)``, and STDP amplitudes `HH_STDP`."""
    lat = snt.Lattice(snt.HodgkinHuxley(), device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    s = lat.state
    for t in ("AMPA", "NMDA", "GABA"):
        s = lat.model.insert_receptor(s, t)
        s = lat.model.insert_neurotransmitter(s, t)
    lat.state = s
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=11)
    lat.chemical_synapse = True
    lat.do_plasticity = True
    lat.plasticity = snt.STDP(**HH_STDP) if firing else snt.STDP()
    if firing:
        n = rows * cols
        v0 = np.random.default_rng(9).uniform(-65, -20, n)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=lat.device)

        lat.apply(lambda st: {
            **st, "v": f32(v0), "na$m_state": f32(np.full(n, 0.05)),
            "na$h_state": f32(np.full(n, 0.6)),
            "k$n_state": f32(np.full(n, 0.32))})
    lat.use_kernel = use_kernel
    return lat


def hh_inputs(snt, hk, shape, k, nt, rec, el, pl, nonuniform, seed):
    """The arguments of one `hh_steps` call on the card, made from
    ``seed``: a state random across the HH range (v in [-70, 40), gates in
    [0, 1), random flags, concentrations and past firing times), so that
    neurons peak, fire and move weights within the call, on random
    weights; with ``nonuniform``, parameters vary by up to 10% per neuron
    and 20% of the receptor and neurotransmitter slots are missing."""
    rows, cols = shape
    n = rows * cols
    rng = np.random.default_rng(seed)
    g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(2.0),
                               keep_prob=0.8, seed=seed + 1,
                               weight_fn=lambda dr, dc, rr, cc:
                               rng.uniform(0.5, 1.5, rr.shape),
                               device="cuda")
    st = snt.HodgkinHuxley(nt, rec).init_state_host(n)

    def f(lo, hi, shp=(n,)):
        return rng.uniform(lo, hi, shp).astype(np.float32)

    st.update({"v": f(-70, 40), "na$m_state": f(0, 1),
               "na$h_state": f(0, 1), "k$n_state": f(0, 1),
               "was_increasing": rng.random(n) < 0.5,
               "is_spiking": rng.random(n) < 0.2,
               "last_firing_time": np.where(rng.random(n) < 0.3,
                                            rng.integers(90, 100, n),
                                            -1).astype(np.int32),
               "nt$t": f(0, 1, (n, 3)), "rec$r": f(0, 1, (n, 3)),
               "nt$mask": rng.random((n, 3)) < (0.8 if nonuniform else 1.1),
               "rec$mask": rng.random((n, 3)) < (0.8 if nonuniform else 1.1)})
    if nonuniform:
        for key in hk.PARAM_ORDER + hk.nt_param_keys(nt) \
                + hk.rec_param_keys(rec):
            st[key] = st[key] * f(0.9, 1.1, st[key].shape)
    return dict(state={key: torch.from_numpy(x).cuda()
                       for key, x in st.items()},
                weights=g.weights, mask=g.mask, in_deg=g.in_deg,
                offsets=g.offsets, clock0=100, n_steps=k, electrical=el,
                nt_kind=nt, rec_kind=rec,
                rule=snt.STDP().params if pl else None)


def hh_ops(args, hk):
    """Float operations one `hh_steps` call needs (`EXP_OPS` per exp): per
    cell and step the gates, currents, receptors, release and the three
    products t * m that its neighbours read; per on-grid slot the
    electrical sum and the three chemical sums and counts; per masked slot
    whose ends both fired before the call the STDP delta (a lower bound of
    the slots that need one)."""
    rows, cols = args["in_deg"].shape
    el, nt, rec = args["electrical"], args["nt_kind"], args["rec_kind"]
    offs = args["offsets"]
    per_cell = (len(offs) + 5 * el                       # wsum, i_elec
                + 3 * (6 + (7 if rec == "destexhe" else 0)) + 1
                + 9 + EXP_OPS                            # NMDA block, i_lig
                + 31 + 6 * EXP_OPS + 18 + 14 + 7         # gates, currents, v
                + 3 * (5 + EXP_OPS if nt == "destexhe" else 8) + 2
                + 3)                                     # t * m
    per_slot = 2 * el + 12
    stdp = 0
    if args["rule"] is not None:
        stdp = both_fired_slots(
            args["state"]["last_firing_time"].reshape(rows, cols),
            args["mask"], offs) * (11 + EXP_OPS)
    return args["n_steps"] * (rows * cols * per_cell
                              + ingrid_slots(offs, rows, cols) * per_slot
                              + stdp)


def hh_call_bytes(args, out, hk):
    """Bytes one `hh_steps` call must move: the fields and planes the
    kernel reads, once, and the fields it writes, once."""
    keys = (hk.STATE_KEYS + hk.PARAM_ORDER + hk.nt_param_keys(args["nt_kind"])
            + hk.rec_param_keys(args["rec_kind"]) + ("nt$mask", "rec$mask"))
    ins = [args["state"][key] for key in keys]
    outs = [out[0][key] for key in hk.STATE_KEYS + hk.CURRENT_KEYS]
    if args["rule"] is not None:
        outs.append(out[1])
    return tensor_bytes(ins, args["weights"], args["mask"],
                        args["in_deg"]) + tensor_bytes(outs)


def compare_hh(got, want, hk):
    """(max float error, integer/flag mismatches, errors by name) of an HH
    kernel call against its twin."""
    errs, bad = {}, 0
    pairs = [(key, got[0][key], want[0][key])
             for key in hk.STATE_KEYS + hk.CURRENT_KEYS]
    pairs.append(("weights", got[1], want[1]))
    for key, g, w in pairs:
        if g.dtype in (torch.int32, torch.bool):
            bad += int((g != w).sum())
        else:
            fin = torch.isfinite(g)
            check(bool(fin.all()), f"non-finite {key}: {int((~fin).sum())} "
                  f"values, at the twin's non-finite places "
                  f"{bool(torch.equal(fin, torch.isfinite(w)))}")
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=key)
            errs[key] = (g - w).abs().max().item()
    return max(errs.values()), bad, errs


def hh_bits(got, want, hk):
    """The outputs of an HH call that differ from the twin's in any bit."""
    pairs = [(key, got[0][key], want[0][key])
             for key in hk.STATE_KEYS + hk.CURRENT_KEYS]
    pairs.append(("weights", got[1], want[1]))
    bad = []
    for key, g, w in pairs:
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            bad.append(key)
    return bad


def hh_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import hh_kernels as hk
    max_err, times, bounds = hh_twin_phase(snt, hk, smi)
    launches, per_call = hh_main_phase(snt, hk)
    hh_cmp_phase(snt)
    hh_times_phase(snt, smi)
    return {"name": "hh_steps", "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/hh_chemical.cu",
            "replaces": HH_REPLACES, "launches": launches,
            "max_abs_err": max_err,
            "ms": times[0] * hk.STEPS_PER_LAUNCH,
            "plain_ms": times[1] * hk.STEPS_PER_LAUNCH,
            "device_ms": times[2] * hk.STEPS_PER_LAUNCH,
            "per_step_ms": times[3] * hk.STEPS_PER_LAUNCH,
            "per_step_device_ms": times[4] * hk.STEPS_PER_LAUNCH,
            # phase 16's main paths: launches the C entry counted, and the
            # profiler's kernel records, per 16-step call
            "kernel_launches_per_call": per_call[1] / per_call[0],
            "kernel_records_per_call": per_call[3] / per_call[2],
            "bound_ms": bounds[0], "bound_by": bounds[1], "library_ms": None}


def hh_twin_phase(snt, hk, smi):
    """15. The HH kernel vs its plain twin on the card: (max float error,
    (kernel, twin, device) ms per step at 512^2, the bound of a 512^2
    call)."""
    for entry, rep in instantiation_lines("hh_cell_kernel"):
        say(f"[15 build] {entry}: {rep}")
    max_err, times, bounds = 0.0, None, None
    for seed, (shape, k, nt, rec, el, pl, nonuniform) in enumerate(HCASES):
        args = hh_inputs(snt, hk, shape, k, nt, rec, el, pl, nonuniform,
                         seed)
        before = hk.STEP_LAUNCHES
        got = hk.hh_steps(**args)
        torch.cuda.synchronize()
        launched = hk.STEP_LAUNCHES - before
        before = hk.STEP_LAUNCHES
        per_step = hk.hh_steps(**args, _per_step=True)
        torch.cuda.synchronize()
        launched_ps = hk.STEP_LAUNCHES - before
        want = hk.hh_steps_reference(**args)
        torch.cuda.synchronize()
        err, bad, errs = compare_hh(got, want, hk)
        diff, diff_ps = hh_bits(got, want, hk), hh_bits(per_step, want, hk)
        fired = int((got[0]["last_firing_time"] >= 100).sum())
        moved = (got[1] - args["weights"]).abs().max().item()
        say(f"[15 kernel-vs-twin] {shape[0]}x{shape[1]} K={k} {nt}/{rec} "
            f"electrical={el} plastic={pl} non-uniform={nonuniform}: "
            f"integer and flag mismatches {bad}, max errors "
            + " ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f", outputs not bit-equal: fused {diff}, per step {diff_ps}; "
            f"launches counted {launched} fused, {launched_ps} per step; "
            f"neurons fired {fired}, max weight change {moved:.4g}")
        check(bad == 0, "firing times, spikes or was_increasing differ")
        check(not diff and not diff_ps, "an HH design is not bit-equal to "
              "the twin")
        check(launched == hk.step_launches(k, pl)
              and launched_ps == hk.step_launches(k, pl, per_step=True),
              "the HH entry launched another number of kernels than its "
              "schedule has")
        check(fired > 0 and (moved > 0 or not pl),
              "no neuron fired or no weight moved in the call")
        max_err = max(max_err, err)
        if shape in (HBIG, HMAIN) and pl:
            out = designs_in_turns(
                {"fused": lambda: hk.hh_steps(**args),
                 "per_step": lambda: hk.hh_steps(**args, _per_step=True)},
                {"fused": launched, "per_step": launched_ps}, k)
            b = bound(hh_call_bytes(args, got, hk), hh_ops(args, hk))
            if shape == HBIG:
                bounds = b
                times = (out["fused"][1] / 1e3, event_ms(
                    lambda: hk.hh_steps_reference(**args), 3) / k,
                    out["fused"][2] / 1e3, out["per_step"][1] / 1e3,
                    out["per_step"][2] / 1e3)
            say(f"[15 times] {shape[0]}x{shape[1]} K={k} {nt}/{rec}, the "
                f"designs in turns: {design_line(out)}; bound "
                f"{b[0] * 1e3 / k:.3f} us ({b[1]}); card {smi}")
        del args, got, want, per_step
    # the main path's own inputs: the calls of the first `HTWIN_STEPS`
    # steps of bench.py's 128^2 run, in both forms, each against the twin
    # on the state that call received
    for firing in (True, False):
        lat = hh_lattice(snt, *HMAIN, firing=firing)
        bad, err, fired, calls_fired = 0, 0.0, 0, 0
        for _ in range(HTWIN_STEPS[firing] // hk.STEPS_PER_LAUNCH):
            g, clock = lat.graph, lat.internal_clock
            want = hk.hh_steps_reference(
                lat.state, g.weights, g.mask, g.in_deg, g.offsets, clock,
                hk.STEPS_PER_LAUNCH, lat.electrical_synapse,
                lat.model.nt_kinetics, lat.model.rec_kinetics,
                lat.plasticity.params)
            lat.run_lattice(hk.STEPS_PER_LAUNCH)
            torch.cuda.synchronize()
            check(lat._last_run_fused == "hh", "the main path missed the kernel")
            e, b, _ = compare_hh((lat.state, lat.graph.weights), want, hk)
            bad, err = bad + b, max(err, e)
            n = int((lat.state["last_firing_time"] >= clock).sum())
            fired, calls_fired = fired + n, calls_fired + (n > 0)
        say(f"[15 kernel-vs-twin] main path {HMAIN[0]}x{HMAIN[1]} "
            f"{'firing' if firing else 'bench.py'} form, every call of the "
            f"first {HTWIN_STEPS[firing]} steps: integer and flag mismatches "
            f"{bad}, "
            f"max float error {err:.3g}, calls with spikes {calls_fired}, "
            f"neurons fired {fired}")
        check(bad == 0, "firing times, spikes or was_increasing differ on "
              "the main path's inputs")
        check(fired > 0, "the main path fired no neuron")
        max_err = max(max_err, err)
        del lat, want
    say(f"[15 kernel-vs-twin] max float error over all cases {max_err:.3g} "
        f"(tolerance rtol {RTOL}, atol {ATOL}; 0 = bit-equal)")
    return max_err, times, bounds


def hh_main_phase(snt, hk):
    """16. The HH main paths through `run_lattice`; returns the kernel
    calls they made, and the sums (calls, launches counted by the C entry,
    profiled calls, the profiler's kernel records)."""
    launches, per_call = 0, [0, 0, 0, 0]
    for label, shape, steps, firing in (
            ("firing form", HMAIN, HMAIN_STEPS, True),
            ("bench.py form", HMAIN, HMAIN_STEPS, False),
            ("firing form", HBIG, HBIG_STEPS, True)):
        lat = hh_lattice(snt, *shape, firing=firing)
        w0 = lat.graph.weights.clone()
        hk.LAUNCHES = hk.STEP_LAUNCHES = 0
        secs = run_synced(lat, steps)
        calls, steps_launched = hk.LAUNCHES, hk.STEP_LAUNCHES
        launches += calls
        st = lat.state
        v = st["v"]
        finite = all(bool(torch.isfinite(x).all()) for x in st.values()
                     if x.is_floating_point()) \
            and bool(torch.isfinite(lat.graph.weights).all())
        fired = int((st["last_firing_time"] >= 0).sum())
        moved = (lat.graph.weights - w0).abs().max().item()
        say(f"[16 main path] HH {label} {shape[0]}x{shape[1]} run_lattice("
            f"{steps}): route {lat._last_run_fused}, kernel calls {calls}, "
            f"{secs / steps * 1e6:.3f} us/step (first run), state finite "
            f"{finite}, v range [{v.min().item():.3f}, {v.max().item():.3f}]"
            f", fired {fired} of {lat.n}, max weight change {moved:.4g}")
        recs = kernel_records(lambda: lat.run_lattice(RECORD_STEPS),
                              RECORD_STEPS // 16 * 17)
        per_call = [a + b for a, b in zip(per_call, (
            calls, steps_launched, RECORD_STEPS // 16, sum(recs.values())))]
        say(f"[16 main path] HH {label} {shape[0]}x{shape[1]}: kernel "
            f"launches {steps_launched} ({steps_launched / calls:.2f} a "
            f"call; profiled {RECORD_STEPS} steps: {records_line(recs)})")
        check(lat._last_run_fused == "hh", f"HH {label} missed the kernel")
        check(calls == math.ceil(steps / hk.STEPS_PER_LAUNCH),
              "wrong number of kernel calls")
        check(steps_launched == 17 * calls
              and sum(recs.values()) == RECORD_STEPS // 16 * 17
              and sum(n for key, n in recs.items() if "lp_step_kernel" in key)
              == RECORD_STEPS // 16, f"HH {label} did not take the fused "
              "schedule")
        check(finite, f"non-finite HH {label} state")
        check(not firing or (fired > 0 and moved > 0),
              f"HH {label}: no neuron fired or no weight moved")
        del lat
    return launches, per_call


def hh_cmp_phase(snt):
    """17. 64^2, 500 steps, firing form, v and firing times read every
    `HCMP_EVERY` steps: the HH kernel route on the card against the same
    route on the CPU, and against the plain route on the card."""
    runs = {}
    for key, device, uk in (("kernel", "cuda", None), ("cpu", "cpu", True),
                            ("plain", "cuda", False)):
        lat = hh_lattice(snt, *SMALL, use_kernel=uk, device=device)
        vs, lfts = [], []
        for _ in range(HCMP_STEPS // HCMP_EVERY):
            lat.run_lattice(HCMP_EVERY)
            vs.append(lat.state["v"].cpu())
            lfts.append(lat.state["last_firing_time"].cpu())
        runs[key] = (torch.stack(vs).numpy(),
                     torch.stack(lfts).numpy().astype(np.int64),
                     lat.graph.weights.cpu().numpy(), lat._last_run_fused)
    check(runs["kernel"][3] == runs["cpu"][3] == "hh"
          and runs["plain"][3] is False, "wrong HH routes")
    hk, lk, wk, _ = runs["kernel"]
    hc, lc, wc, _ = runs["cpu"]
    dv, dl = float(np.abs(hk - hc).max()), int(np.abs(lk - lc).max())
    dw = float(np.abs(wk - wc).max())
    say(f"[17 kernel-vs-cpu] HH {SMALL[0]}x{SMALL[1]} {HCMP_STEPS} steps, "
        f"kernel route on the card vs on the CPU: max|dv| {dv:.4g} mV, "
        f"max|dlft| {dl} steps, max|dweight| {dw:.4g}, fired "
        f"{int((lk[-1] >= 0).sum())}")
    check(dv <= 2.0 and dl <= 2 and dw <= 1e-2,
          "HH card vs CPU outside 2 mV / 2 steps / 1e-2")
    hp, lp, wp, _ = runs["plain"]
    # Peak detection has no reset: the routes part where a neuron's peak
    # falls on another step (a tie), and until then drift by the ulps of
    # exp that mid-upstroke dynamics amplify
    d = np.abs(hk - hp)
    dvs = d.max(axis=1)
    tie = np.nonzero((lk != lp).any(axis=1))[0]
    s0 = int(tie[0]) if len(tie) else len(dvs)
    pre = float(dvs[:s0].max()) if s0 else 0.0
    outside = int((d > 2.0).any(axis=0).sum())
    fk, fp = int((lk[-1] >= 0).sum()), int((lp[-1] >= 0).sum())
    n = SMALL[0] * SMALL[1]
    say(f"[17 kernel-vs-plain] HH {SMALL[0]}x{SMALL[1]} {HCMP_STEPS} steps, "
        f"kernel vs plain route on the card: max|dv| {dvs.max():.4g} mV, "
        f"before the first firing-time difference "
        f"(step {s0 * HCMP_EVERY if len(tie) else 'none'}) {pre:.4g} mV, "
        f"max|dlft| {int(np.abs(lk - lp).max())} steps, neurons ever "
        f"outside 2 mV {outside} of {n}, fired {fk} vs {fp}, max|dweight| "
        f"{float(np.abs(wk - wp).max()):.4g}")
    check(pre <= HH_DRIFT, "the HH routes parted before a firing-time tie")
    check(outside <= n // 100 and abs(fk - fp) <= n // 100,
          "the HH routes' divergence spread beyond 1% of the lattice")


def hh_times_phase(snt, smi):
    """18. Times of the HH kernel and plain routes on `bench.py`'s own
    lattice, in turns."""
    for shape, kern_steps, plain_steps in ((HMAIN, HMAIN_STEPS, 64),
                                           (HBIG, HBIG_STEPS, 16)):
        kern = hh_lattice(snt, *shape, use_kernel=None, firing=False)
        plain = hh_lattice(snt, *shape, use_kernel=False, firing=False)
        run_synced(kern, kern_steps)
        run_synced(plain, plain_steps)
        tk, tp = [], []
        for rep in range(5):
            tk.append(run_synced(kern, kern_steps))
            if rep < 3:
                tp.append(run_synced(plain, plain_steps))
        check(kern._last_run_fused == "hh" and plain._last_run_fused is False,
              "timed the wrong HH routes")
        mk, mp = float(np.median(tk)), float(np.median(tp))
        dev_us, top = profiled_us(lambda: run_synced(kern, PROFILE_STEPS),
                                  PROFILE_STEPS,
                                  launches=PROFILE_STEPS // 16 * 17,
                                  mine=("hh_", "lp_"))
        busy = dev_us * kern_steps / (mk * 1e6)
        say(f"[18 times] HH bench.py form {shape[0]}x{shape[1]}: kernel "
            f"route (use_kernel=None) {rate(shape, mk, kern_steps)}, median "
            f"of 5 x {kern_steps} steps; device time {dev_us:.3f} us/step "
            f"(profiled: " + ", ".join(f"{k} {t:.3f}" for k, t in top)
            + f"), device time / wall {busy:.3f}; plain route "
            f"(use_kernel=False) {rate(shape, mp, plain_steps)}, median of 3 "
            f"x {plain_steps} steps; card {smi}")
        del kern, plain


# ---------------------------------------------------------------------------
# The chemical arm of the network kernels: phases 19-22
# ---------------------------------------------------------------------------


def chem_net(snt, rows, cols, use_kernel=None, device="cuda", train="poisson",
             dopamine=False):
    """`bench.py`'s chemical network (`bench.py:448-513`): two Izhikevich
    lattices with DopaGluGABA receptors and bounded kinetics (gap 10,
    radius 2, keep 0.8, graph seeds 3 and 4), Glutamate and GABA receptors,
    Glutamate released, v0 uniform in [-70, -40) from ``default_rng(7)``; a
    Poisson train at 50 Hz releasing its slot 0 ("AMPA", Glutamate on the
    receptor side) into lattice 0 one to one (3.0), lattice 0 into lattice
    1 one to one (1.5); chemical synapses only.  ``train="rate"``: a Rate
    train of 1 ms instead.  ``dopamine``: the form of the JAX package's
    DopaGluGABA kernel test, a third lattice releasing dopamine into
    lattice 1 (one to one, 1.0), whose D1 and D2 receptors (s_d1 0.5, s_d2
    0.3) make nmda_mod and inh_mod move from 1; its v0 is uniform in [-65,
    40) from ``default_rng(8)``, so a third of it fires at once."""
    rng = np.random.default_rng(7)
    n = rows * cols

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def lattice(lid):
        model = snt.Izhikevich(nt_kinetics="bounded", rec_kinetics="bounded",
                               receptors=snt.DopaGluGABAReceptors("bounded"))
        lat = snt.Lattice(model, id=lid, device=device)
        lat.populate(rows, cols, gap_conductance=10.0)
        return lat

    lats = []
    for lid in range(2):
        lat = lattice(lid)
        lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=3 + lid)
        s = lat.model.insert_receptor(lat.state, "Glutamate")
        s = lat.model.insert_receptor(s, "GABA")
        s = lat.model.insert_neurotransmitter(s, "Glutamate")
        lat.state = {**s, "v": f32(rng.uniform(-70, -40, n))}
        lats.append(lat)
    if dopamine:
        dopa = lattice(3)
        dopa.connect_stencil(radius=1.0, seed=9)
        s = dopa.model.insert_neurotransmitter(dopa.state, "Dopamine")
        dopa.state = {**s, "v": f32(np.random.default_rng(8).uniform(
            -65, 40, n))}
        lats.append(dopa)
        lats[1].state = lats[1].model.insert_receptor(
            lats[1].state, "Dopamine", s_d1=0.5, s_d2=0.3)
    st = snt.SpikeTrainLattice(
        (snt.PoissonSpikeTrain if train == "poisson" else snt.RateSpikeTrain)(
            nt_kinetics="bounded"), id=2, device=device)
    st.populate(rows, cols)
    st.state = st.model.init_from_firing_rate(n, hertz=50.0, dt=0.1,
                                              device=device) \
        if train == "poisson" else st.model.init_state(n, rate=1.0, dt=0.1,
                                                       device=device)
    st.state = st.model.insert_neurotransmitter(st.state, "AMPA")
    net = snt.LatticeNetwork.generate_network(lats, [st])
    for pre, post, w in ((2, 0, 3.0), (0, 1, 1.5)) \
            + (((3, 1, 1.0),) if dopamine else ()):
        connect_grid(net, pre, post, one_to_one_coo(n, w),
                     lambda pr, pc, qr, qc, w=w: np.where(
                         (pr == qr) & (pc == qc), w, np.nan))
    net.electrical_synapse = False
    net.chemical_synapse = True
    net.use_kernel = use_kernel
    return net


def random_chem_state(state, fam, n, rng, f, b):
    """A lattice's random chemical state across the threshold: ``f(lo, hi,
    shape)`` and ``b(p, shape)`` draw float and bool tensors on the card."""
    s = dict(state)
    for k in list(s):
        if k.startswith(("nt$", "rec$")) and s[k].is_floating_point() \
                and k not in ("nt$t", "rec$r", "rec$r2", "rec$current"):
            s[k] = s[k] * f(0.8, 1.2, tuple(s[k].shape))
    s.update({"v": f(-70, 40, (n,)), "nt$t": f(0, 1, (n, 3)),
              "rec$r": f(0, 1, (n, 3)), "nt$mask": b(0.8, (n, 3)),
              "rec$mask": b(0.8, (n, 3)), "is_spiking": b(0.3, (n,)),
              "last_firing_time": torch.as_tensor(np.where(
                  rng.random(n) < 0.3, rng.integers(0, 3, n),
                  -1).astype(np.int32), device="cuda")})
    if fam == "dopaglugaba":
        s.update({"rec$r2": f(0, 1, (n, 3)), "rec$s_d1": f(0.05, 0.2, (n,)),
                  "rec$s_d2": f(0.05, 0.2, (n,)),
                  "rec$nmda_modifier": f(0.5, 1.0, (n,)),
                  "rec$inh_modifier": f(0.5, 1.0, (n,)),
                  "rec$g_ampa": f(4, 6, (n,)), "rec$e_ampa": f(50, 70, (n,))})
    else:
        s["rec$g"] = s["rec$g"] * 5.0
    return s


def chem_case(snt, fam, rec, nt, elec, plastic, train, model, shape, seed):
    """A chemical network of three lattices of ``model`` ("izh", "alif" or
    "dopa") with ``fam`` receptors, ``rec`` / ``nt`` kinetics, made from
    ``seed``: random state across the threshold (v, concentrations, gating
    values, modifiers in [0.5, 1), previous spikes and firing times at
    clock 3), 20% of the receptor and neurotransmitter slots missing,
    parameters varied by up to 20%, random weights; a Poisson (300 Hz) or
    Rate train releasing into lattice 0, lattice 0 into lattice 1 (a third
    of the cells masked off) and an edgeless lattice 2 into lattice 1;
    with ``plastic``, STDP on lattice 1 at a+- 0.02 (the default amplitudes
    turn weights, and so receptor inputs, negative within a call, and a
    negative NMDA gate to a non-integer power is NaN)."""
    rows, cols = shape
    n = rows * cols
    rng = np.random.default_rng(seed)
    recs = snt.DopaGluGABAReceptors(rec) if fam == "dopaglugaba" \
        else snt.IonotropicReceptors(rec)
    cls = {"izh": snt.Izhikevich, "dopa": snt.DopaIzhikevich,
           "alif": snt.AdaptiveLeakyIntegrateAndFire}[model]

    def f(lo, hi, shp=(n,)):
        return torch.as_tensor(rng.uniform(lo, hi, shp).astype(np.float32),
                               device="cuda")

    def b(p, shp=(n,)):
        return torch.as_tensor(rng.random(shp) < p, device="cuda")

    lats = []
    for lid in range(3):
        lat = snt.Lattice(cls(nt_kinetics=nt, rec_kinetics=rec,
                              receptors=recs), id=lid, device="cuda")
        lat.populate(rows, cols, gap_conductance=10.0)
        if lid < 2:
            lat.connect_stencil(radius=2.0 if lid == 0 else 1.5,
                                keep_prob=0.8, seed=seed + lid,
                                weight_fn=lambda dr, dc, rr, cc:
                                rng.uniform(0.5, 1.5, rr.shape))
        lat.state = random_chem_state(lat.state, fam, n, rng, f, b)
        lat.do_plasticity = plastic and lid == 1
        lat.plasticity = snt.STDP(**HH_STDP)
        lats.append(lat)
    tm = (snt.PoissonSpikeTrain if train == "poisson"
          else snt.RateSpikeTrain)(nt_kinetics=nt)
    st = snt.SpikeTrainLattice(tm, id=5, device="cuda")
    st.populate(rows, cols)
    st.state = tm.init_from_firing_rate(n, hertz=300.0, dt=0.1,
                                        device="cuda") \
        if train == "poisson" else tm.init_state(n, rate=0.5, dt=0.1,
                                                 device="cuda")
    st.state = {**tm.insert_neurotransmitter(st.state, "AMPA"),
                "nt$t": f(0, 1, (n, 3))}
    net = snt.LatticeNetwork.generate_network(lats, [st])
    net.connect_vectorized(5, 0, lambda pr, pc, qr, qc: np.where(
        (pr == qr) & (pc == qc), 3.0, np.nan))
    net.connect_vectorized(0, 1, lambda pr, pc, qr, qc: np.where(
        (pr == qr) & (pc == qc) & ((pr + pc) % 3 > 0), 1.5, np.nan))
    net.connect_vectorized(2, 1, lambda pr, pc, qr, qc: np.where(
        (pr == qr) & (pc == qc), 1.0, np.nan))
    net.electrical_synapse = elec
    net.chemical_synapse = True
    net.internal_clock = 3
    return net


def chem_inputs(nk, net, n_steps, seed, chem=True):
    """One kernel call's inputs from a network's members: (spec, lats,
    trains, conns, uniforms, rule); with ``chem`` the network must be a
    chemical one."""
    from spiking_neural_networks_tpu_torch.core.structured import (
        nt_flags, resolve_structured_plan)
    plan = resolve_structured_plan(net)
    flags = nt_flags(net, plan)
    spec = nk.plain_network_spec(net, plan, not any(flags),
                                 flags[len(plan["lat_ids"]):])
    check(spec is not None and bool(spec.chem) == chem,
          "the network is outside the kernels' class")
    lats, trains, conns = nk.member_inputs(spec, net, plan)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    uniforms = [torch.rand((n_steps, *ts.shape), generator=g, device="cuda")
                if ts.kind == "poisson" else None for ts in spec.trains]
    return spec, lats, trains, conns, uniforms, net._plasticity().params


def flat_outputs(out):
    """(name, tensor) pairs of a network call's outputs, chemical fields
    by name."""
    lat, tr, cn = out[:3]
    pairs = []
    for k, d in enumerate(lat):
        for key, x in d.items():
            if key == "chem" and x is not None:
                pairs += [(f"{kk}{k}", y) for kk, y in sorted(x.items())]
            elif x is not None:
                pairs.append((f"{key}{k}", x))
    for j, d in enumerate(tr):
        pairs += [(f"train {key}{j}", x) for key, x in d.items()
                  if x is not None]
    return pairs + [(f"conn{c}", w) for c, w in enumerate(cn)]


def compare_chem(got, want):
    """(max float error, integer/spike mismatches, errors by name) of a
    chemical call against its twin; NaN only where the twin has it."""
    errs, bad = {}, 0
    for (name, g), (_, w) in zip(flat_outputs(got), flat_outputs(want)):
        if g.dtype in (torch.int32, torch.bool) or name.startswith("refr"):
            bad += int((g != w).sum())
            continue
        check(bool(torch.equal(torch.isnan(g), torch.isnan(w))),
              f"NaN where the twin has none: {name}")
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, equal_nan=True,
                                   msg=name)
        errs[name] = torch.nan_to_num(g - w).abs().max().item()
    return max(errs.values()), bad, errs


def chem_bytes(spec, lats, trains, conns, uniforms, outs):
    """Bytes one chemical call must move: each input that the call's
    configuration reads once, each output once.  Without electrical
    synapses no lattice's in_deg or gap_conductance plane and no train's
    refr_k is read, and a train's v_th and v_resting only for Destexhe
    release (the other kinetics ignore v)."""
    lat_in, tr_in = [], []
    for d in lats:
        d = {k: x for k, x in d.items() if spec.electrical or k != "in_deg"}
        d["params"] = {p: x for p, x in d["params"].items()
                       if spec.electrical or p != "gap_conductance"}
        lat_in.append(d)
    for ts, d in zip(spec.trains, trains):
        skip = () if spec.electrical else ("refr_k",) + (
            () if ts.nt == "destexhe" else ("v_th", "v_resting"))
        tr_in.append({k: x for k, x in d.items() if k not in skip})
    return tensor_bytes(lat_in, tr_in, conns, uniforms, outs)


def chem_ops(spec, lats, conns, k):
    """Float operations one chemical call needs (`EXP_OPS` per exp, twice
    that per pow whose exponent is not 1 at the call's start): per cell
    and step the three products t * m its neighbours read, the
    re-expansion and average per type, 4 per incoming connection and type,
    the receptors (2 per kinetics update, the currents, the block's exp),
    rec_dv, the model step (23) and the release (6 per type); per on-grid
    slot the three chemical sums and counts; with electrical synapses,
    `stencil_ops` (connections and STDP not counted)."""
    ops = 0
    n_in = [sum(cs.post == i for cs in spec.conns)
            for i in range(len(spec.lattices))]
    dopa = spec.chem[0] == "dopaglugaba"
    for i, (ls, d) in enumerate(zip(spec.lattices, lats)):
        rows, cols = ls.shape
        pows = int((d["chem"]["rec$nmda_modifier"] != 1.0).sum()) \
            if dopa else 0
        per_cell = (3 + 3 * (6 + 4 * n_in[i])
                    + 3 * 2 * (2 if dopa else 1)
                    + (19 if dopa else 13) + EXP_OPS + 3 + 23 + 3 * 6)
        ops += k * (rows * cols * per_cell + pows * (2 * EXP_OPS + 1)
                    + 12 * ingrid_slots(ls.offsets, rows, cols))
        if spec.electrical:
            ops += stencil_ops(ls.offsets, rows, cols, k)
    return ops


def chem_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
    res = chem_twin_phase(snt, nk, smi)
    chem_cmp_phase(snt)
    chem_times_phase(snt, smi)
    out = []
    for key, name, source in (
            ("persistent", "network_persistent (chemical arm)",
             "network_persistent.cu"),
            ("per_step", "network_steps (chemical arm, per step)",
             "network_plasticity.cu")):
        r = res[key]
        out.append({
            "name": name, "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/" + source,
            "replaces": CHEM_REPLACES, "launches": res["launches"][key],
            "max_abs_err": res["max_err"], "shape": r["shape"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "device_ms": r["device_ms"],
            "other_design_ms": r["other_ms"],
            "other_design_device_ms": r["other_device_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None})
    return out


def chem_twin_phase(snt, nk, smi):
    """19. The chemical arm vs its plain twin on the card: every family x
    receptor kinetics x NT kinetics on random cases, the persistent kernel
    and the per-step design each bit for bit; then the 64^2 main path, its
    dopamine form and the 512^2 main path through `run_lattices`, every
    call of their first `CTWIN_STEPS` (64^2 bench.py form) or
    `CTWIN_SHORT` steps on the state that call received, and both designs
    timed in turns on each one's first call.  Returns {"max_err",
    "launches": {design: main-path calls}, design: {"shape", "ms",
    "plain_ms", "device_ms", "other_ms", "other_device_ms", "bound"} of a
    16-step call where the route takes that design (64^2 persistent,
    512^2 per step)}."""
    import itertools
    sms = nk._sm_count(torch.device("cuda"))
    lines, regs = variant_lines(nk, (0, 1))
    for line in lines:
        say(f"[19 persistent kernel] {line}; card {smi}")
    check(regs[0] == 96, "the electrical instantiation left 96 registers")
    max_err, n_cases = 0.0, 0
    models = ("izh", "alif", "dopa")
    for seed, (fam, rec, nt) in enumerate(itertools.product(
            nk.CHEM_FAMILIES, nk.REC_KINDS, nk.NT_KINDS)):
        elec, plastic = seed % 2 == 0, seed % 3 == 0
        train = "poisson" if seed % 4 == 0 else "rate"
        model = models[seed % 3]
        if fam == "ionotropic" and model == "dopa":
            model = "izh"
        shape = CSHAPES[seed % len(CSHAPES)]
        k = 16 if seed % 2 else 7
        net = chem_case(snt, fam, rec, nt, elec, plastic, train, model, shape,
                        seed)
        args = chem_inputs(nk, net, k, seed)
        got = nk.network_steps(*args, 3, k)
        torch.cuda.synchronize()
        want = nk.network_steps_reference(*args, 3, k)
        bits = (bit_mismatches(persistent_call(nk, args, 3, k), want),
                bit_mismatches(nk.network_steps(*args, 3, k, per_step=True),
                               want))
        err, bad, _ = compare_chem(got, want)
        fired = sum(int((d["lft"] >= 3).sum()) for d in got[0])
        nmda = got[0][1]["chem"].get("rec$nmda_modifier")
        say(f"[19 kernel-vs-twin] {shape[0]}x{shape[1]} K={k} {fam} {rec}/{nt}"
            f" {model} electrical={elec} plastic={plastic} {train}: integer "
            f"and spike mismatches {bad}, max float error {err:.3g}, outputs "
            f"not bit-equal: persistent {bits[0]}, per step {bits[1]}, fired "
            f"{fired}" + ("" if nmda is None else
                          f", nmda_mod in [{nmda.min().item():.3f}, "
                          f"{nmda.max().item():.3f}]"))
        check(bad == 0, "firing times, spikes or counts differ")
        check(bits == ([], []), "a design is not bit-equal to the twin")
        check(fired > 0, "no neuron fired in the call")
        check(all(bool(torch.isfinite(x).all()) for _, x in flat_outputs(got)
                  if x.is_floating_point()), "a random case went non-finite")
        max_err, n_cases = max(max_err, err), n_cases + 1
        del net, args, got, want
    # the main paths through `run_lattices`: every call of the first
    # `held` steps held against the twin on the state that call received,
    # then the rest of the run in one call
    out = {"launches": {"persistent": 0, "per_step": 0}}
    K = nk.STEPS_PER_LAUNCH
    keys = ("v", "w", "lft", "spikes", "refr", "chem")
    for label, shape, steps, dopamine, held in (
            ("bench.py form", CMAIN, CMAIN_STEPS, False, CTWIN_STEPS),
            ("dopamine form", CMAIN, CDOPA_STEPS, True, CTWIN_SHORT),
            ("bench.py form", CBIG, CBIG_STEPS, False, CTWIN_SHORT)):
        net = chem_net(snt, *shape, dopamine=dopamine)
        bad, err, fired, nmda_moved = 0, 0.0, 0, False
        nk.LAUNCHES = nk.CHEM_LAUNCHES = nk.PERSISTENT_LAUNCHES = 0
        for call in range(steps // K):
            clock = net.internal_clock
            if call * K >= held:
                # the rest of the run in one call, not held against the twin
                net.run_lattices(steps - call * K)
                torch.cuda.synchronize()
                check(net._last_run_fused == ("chemical", False),
                      "the main path missed the chemical arm")
                fired += sum(int((l.state["last_firing_time"] >= clock).sum())
                             for l in net.lattices.values())
                nmda_moved |= any(
                    bool((l.state["rec$nmda_modifier"] != 1.0).any())
                    for l in net.lattices.values())
                break
            g = torch.Generator(device="cuda")
            g.set_state(net.generator().get_state())
            spec, lats, trains, conns, _, rule = chem_inputs(nk, net, 1, 0)
            uniforms = [torch.rand((K, *ts.shape), generator=g,
                                   device="cuda")
                        if ts.kind == "poisson" else None
                        for ts in spec.trains]
            args = (spec, lats, trains, conns, uniforms, rule)
            want = nk.network_steps_reference(*args, clock, K)
            if call == 0:
                # timed after the run: the wrapper leaves its inputs as
                # they were, and the run replaces the state's tensors
                timed = (args, clock)
            net.run_lattices(K)
            torch.cuda.synchronize()
            check(net._last_run_fused == ("chemical", False),
                  "the main path missed the chemical arm")
            got = []
            for lat in (net.lattices[i] for i in sorted(net.lattices)):
                s, shp = lat.state, (lat.rows, lat.cols)
                got.append(dict(
                    v=s["v"].reshape(shp), w=s["w"].reshape(shp),
                    lft=s["last_firing_time"].reshape(shp),
                    spikes=s["is_spiking"].reshape(shp),
                    refr=s["refractory_count"].reshape(shp)
                    if "refractory_count" in s else None,
                    chem={k: s[k] for k in nk.chem_out_keys(spec.chem)}))
            got = (got, [dict(lft=s.state["last_firing_time"].reshape(
                s.rows, s.cols), ntt=s.state["nt$t"])
                for s in net.spike_train_lattices.values()], [])
            ref = ([{k: d[k] for k in keys} for d in want[0]],
                   [dict(lft=d["lft"], ntt=d["ntt"]) for d in want[1]], [])
            e, b, _ = compare_chem(got, ref)
            bad, err = bad + b, max(err, e)
            fired += sum(int((d["lft"] >= clock).sum()) for d in got[0])
            nmda_moved |= any(bool((d["chem"]["rec$nmda_modifier"] != 1.0)
                                   .any()) for d in got[0])
        calls, pers = nk.CHEM_LAUNCHES, nk.PERSISTENT_LAUNCHES
        routed = nk.uses_persistent(spec, sms)
        out["launches"]["persistent"] += pers
        out["launches"]["per_step"] += calls - pers
        states = [l.state for l in net.lattices.values()] \
            + [s.state for s in net.spike_train_lattices.values()]
        finite = all(bool(torch.isfinite(x).all()) for st in states
                     for x in st.values() if x.is_floating_point())
        per_lat = [int((l.state["last_firing_time"] >= 0).sum())
                   for l in net.lattices.values()]
        l1 = net.lattices[1].state
        members, smem = nk.persistent_plan(spec, sms, nk.SMEM_BUDGET)
        say(f"[19 main path] chemical {label} {shape[0]}x{shape[1]}, "
            f"run_lattices over {steps} steps, every call of the first "
            f"{min(steps, held)} against the twin: route "
            f"{net._last_run_fused}, kernel calls {calls} (persistent "
            f"{pers}), integer and spike mismatches {bad}, max float error "
            f"{err:.3g}, state finite {finite}, fired per lattice {per_lat} "
            f"of {shape[0] * shape[1]}, lattice 1 max nt$t "
            f"{l1['nt$t'].max().item():.4g}, max rec$r "
            f"{l1['rec$r'].max().item():.4g}, nmda_mod range "
            f"[{l1['rec$nmda_modifier'].min().item():.4f}, "
            f"{l1['rec$nmda_modifier'].max().item():.4f}]; plan "
            f"{plan_line(members, smem)}")
        check(bad == 0, "firing times or spikes differ on the main path's "
              "inputs")
        check(calls == nk.LAUNCHES == steps // K
              and pers == (calls if routed else 0),
              "wrong number of chemical kernel calls or persistent launches")
        check(finite and fired > 0 and l1["rec$r"].max().item() > 0,
              f"chemical {label}: non-finite state, no neuron fired or "
              f"lattice 1 without transmitter")
        check(nmda_moved == dopamine, "nmda_mod moved only with dopamine")
        max_err = max(max_err, err)
        del net
        # both designs on the run's first call, in turns; the bound and
        # the twin
        args, clock = timed
        spec, lats, trains, conns, uniforms, _ = args
        got = persistent_call(nk, args, clock, K)
        call_bound = bound(chem_bytes(spec, lats, trains, conns, uniforms,
                                      got),
                           chem_ops(spec, lats, conns, K))
        d = design_times(nk, args, clock, K)
        twin = event_ms(lambda: nk.network_steps_reference(*args, clock, K),
                        3) / K * 1e3
        say(f"[19 times] chemical {label} {shape[0]}x{shape[1]}, 16-step "
            f"calls, the designs in turns "
            f"({'persistent' if routed else 'per-step'} on the route): "
            f"{design_line(d)}; plain twin {twin:.3f} us "
            f"(events); bound {call_bound[0] * 1e3 / K:.4f} us "
            f"({call_bound[1]}); card {smi}")
        key = "persistent" if routed else "per_step"
        other = "per_step" if routed else "persistent"
        if not dopamine and key not in out:
            out[key] = dict(
                shape=f"2 x {shape[0]}x{shape[1]}", ms=d[key][1] * K / 1e3,
                plain_ms=twin * K / 1e3, device_ms=d[key][2] * K / 1e3,
                other_ms=d[other][1] * K / 1e3,
                other_device_ms=d[other][2] * K / 1e3, bound=call_bound)
        del timed, args, got
    check("persistent" in out and "per_step" in out,
          "the chemical main paths did not take both designs")
    say(f"[19 kernel-vs-twin] max float error over {n_cases} random cases "
        f"and the main paths {max_err:.3g} (tolerance rtol {RTOL}, atol "
        f"{ATOL}; 0 = bit-equal)")
    out["max_err"] = max_err
    return out


def chem_cmp_phase(snt):
    """20. The dopamine form with a Rate train at 64^2, 500 steps with a
    grid history on every lattice: the kernel route on the card against
    the same route on the CPU."""
    runs = {}
    for key, device, uk in (("kernel", "cuda", None), ("cpu", "cpu", True)):
        net = chem_net(snt, *CMAIN, use_kernel=uk, device=device,
                       train="rate", dopamine=True)
        for lat in net.lattices.values():
            lat.update_grid_history = True
        net.run_lattices(CCMP_STEPS)
        runs[key] = ([np.stack(l.grid_history.history)
                      for l in net.lattices.values()],
                     [l.field("last_firing_time").astype(np.int64)
                      for l in net.lattices.values()],
                     [l.field("nt$t") for l in net.lattices.values()],
                     net._last_run_fused)
    check(runs["kernel"][3] == runs["cpu"][3] == ("chemical", True),
          "wrong chemical routes")
    dv = max(float(np.abs(a - b).max())
             for a, b in zip(runs["kernel"][0], runs["cpu"][0]))
    dl = max(int(np.abs(a - b).max())
             for a, b in zip(runs["kernel"][1], runs["cpu"][1]))
    dt = max(float(np.abs(a - b).max())
             for a, b in zip(runs["kernel"][2], runs["cpu"][2]))
    fired = [int((x >= 0).sum()) for x in runs["kernel"][1]]
    say(f"[20 kernel-vs-cpu] chemical dopamine Rate form {CMAIN[0]}x"
        f"{CMAIN[1]} "
        f"{CCMP_STEPS} steps, kernel route on the card vs on the CPU: "
        f"max|dv| {dv:.4g} mV, max|dlft| {dl} steps, max|dnt$t| {dt:.4g}, "
        f"fired per lattice {fired}")
    check(dv <= 2.0 and dl <= 2, "chemical card vs CPU outside 2 mV / 2 "
          "steps")
    check(sum(fired) > 0, "no neuron of the comparison fired")


def chem_times_phase(snt, smi):
    """21. Times of the chemical kernel and plain routes on `bench.py`'s
    chemical network, in turns."""
    for shape, kern_steps, plain_steps in ((CMAIN, CMAIN_STEPS, 64),
                                           (CBIG, CBIG_STEPS, 16)):
        kern = chem_net(snt, *shape, use_kernel=None)
        plain = chem_net(snt, *shape, use_kernel=False)
        run_net_synced(kern, kern_steps)
        run_net_synced(plain, plain_steps)
        tk, tp = [], []
        for rep in range(5):
            tk.append(run_net_synced(kern, kern_steps))
            if rep < 3:
                tp.append(run_net_synced(plain, plain_steps))
        check(kern._last_run_fused == ("chemical", False)
              and plain._last_run_fused is False,
              "timed the wrong chemical routes")
        mk, mp = float(np.median(tk)), float(np.median(tp))
        dev_us, top = profiled_us(lambda: run_net_synced(kern, PROFILE_STEPS),
                                  PROFILE_STEPS, n_top=5)
        n_all = sum(l.n for l in kern.lattices.values())
        busy = dev_us * kern_steps / (mk * 1e6)
        say(f"[21 times] chemical bench.py form {shape[0]}x{shape[1]}: "
            f"kernel route (use_kernel=None) "
            f"{net_rate(n_all, mk, kern_steps)}, median of 5 x {kern_steps} "
            f"steps; device time {dev_us:.3f} us/step (profiled: "
            + ", ".join(f"{k} {t:.3f}" for k, t in top)
            + f"), device time / wall {busy:.3f}; plain route "
            f"(use_kernel=False) {net_rate(n_all, mp, plain_steps)}, median "
            f"of 3 x {plain_steps} steps; card {smi}")
        del kern, plain


# ---------------------------------------------------------------------------
# Flat mode (dense graphs and dense blocks): phases 22-24
# ---------------------------------------------------------------------------


def bayes_net(snt, exc, inh, use_kernel=None, device="cuda", seed=5,
              hertz=CUE_HERTZ, history=True):
    """The Bayesian-inference network of the upstream science pipeline
    (`bench.py:553-589`; the JAX package's kernel test builds it through
    its lixirnet surface): lattice 1, ``exc`` `DopaIzhikevich` neurons
    (c_m 25) with Hopfield-dense intra weights (normal, |w| < 0.8 and the
    diagonal dropped) through `Lattice.connect`, releasing glutamate, a
    grid history, v0 uniform in [-65, -45) with a third at 40 mV; lattice
    0, the ``inh`` pool (v0 0) releasing GABA; both with Glutamate (r_max
    10), GABA and Dopamine (s_d1 0, s_d2 0.5) receptors and bounded
    kinetics; inh -> exc all to all (0.5), exc -> inh where (row_pre +
    col_post) is even (1.0), both through `LatticeNetwork.connect`; two
    Poisson cue lattices of the exc shape, one releasing glutamate (one to
    one, 5.0) and one dopamine (2.0), at ``hertz``; dt 1 ms; chemical
    synapses only."""
    rng = np.random.default_rng(seed)
    rows, cols = exc
    num = rows * cols
    w = rng.normal(0.0, 1.0, (num, num))
    w[np.abs(w) < 0.8] = 0.0
    np.fill_diagonal(w, 0.0)
    v0 = rng.uniform(-65.0, -45.0, num)
    v0[rng.permutation(num)[:num // 3]] = 40.0

    def lattice(lid, shape, releases, **fields):
        model = snt.DopaIzhikevich(
            nt_kinetics="bounded", rec_kinetics="bounded",
            receptors=snt.DopaGluGABAReceptors("bounded"))
        lat = snt.Lattice(model, id=lid, device=device)
        lat.populate(*shape, **fields)
        s = model.insert_receptor(lat.state, "Glutamate",
                                  **{"r_max": 10.0, "r2$r_max": 10.0})
        s = model.insert_receptor(s, "GABA")
        s = model.insert_receptor(s, "Dopamine", s_d1=0.0, s_d2=0.5)
        lat.state = model.insert_neurotransmitter(s, releases,
                                                  clearance_constant=0.001)
        return lat

    inh_lat = lattice(0, inh, "GABA", v=0.0)
    exc_lat = lattice(1, exc, "Glutamate", c_m=25.0,
                      v=v0.astype(np.float32))

    def index(pos):
        return pos[0] * cols + pos[1]

    exc_lat.connect(lambda x, y: bool(w[index(x)][index(y)] != 0),
                    lambda x, y: float(w[index(x)][index(y)]))
    exc_lat.update_grid_history = history
    cues = []
    for sid, slot in ((2, 0), (3, 2)):
        st = snt.SpikeTrainLattice(snt.PoissonSpikeTrain(
            nt_kinetics="bounded"), id=sid, device=device)
        st.populate(rows, cols)
        st.state = st.model.insert_neurotransmitter(
            st.state, st.model.type_names[slot], clearance_constant=0.001)
        cues.append(st)
    net = snt.LatticeNetwork.generate_network([inh_lat, exc_lat], cues)
    net.connect(0, 1, lambda x, y: True, lambda x, y: 0.5)
    net.connect(1, 0, lambda x, y: (x[0] + y[1]) % 2 == 0, lambda x, y: 1.0)
    net.connect(2, 1, lambda x, y: x == y, lambda x, y: 5.0)
    net.connect(3, 1, lambda x, y: x == y, lambda x, y: 2.0)
    net.set_dt(1.0)
    for st, hz in zip(cues, hertz):
        st.state["chance_of_firing"] = torch.full_like(
            st.state["chance_of_firing"],
            st.model.rate_to_chance(hz, 1.0) if hz else 0.0)
    net.electrical_synapse = False
    net.chemical_synapse = True
    net.use_kernel = use_kernel
    return net


def dense_net(snt, n, use_kernel=None, device="cuda", seed=5):
    """The electrical dense network of the JAX package's flat-mode kernel
    test at width ``n``, in a form that fires: two (1, n) Izhikevich
    lattices (gap 10) with random dense intra graphs (30% of the pairs,
    weights in [0.2, 1)), v0 uniform in [-70, -40) with a third at 40 mV, a
    Rate train of 1 ms into lattice 0 one to one (100) and a random dense
    block (10% of the pairs, 20) from lattice 0 into lattice 1."""
    rng = np.random.default_rng(seed)
    lats = []
    for lid in range(2):
        lat = snt.Lattice(snt.Izhikevich(), id=lid, device=device)
        lat.populate(1, n, gap_conductance=10.0)
        mask = rng.random((n, n)) < 0.3
        np.fill_diagonal(mask, False)
        w = rng.uniform(0.2, 1.0, (n, n)).astype(np.float32)
        lat.set_graph(snt.DenseGraph(
            torch.as_tensor(np.where(mask, w, 0.0).astype(np.float32),
                            device=device),
            torch.as_tensor(mask, device=device)))
        v = rng.uniform(-70, -40, n).astype(np.float32)
        v[rng.permutation(n)[:n // 3]] = 40.0
        lat.state = {**lat.state, "v": torch.as_tensor(v, device=device)}
        lats.append(lat)
    st = rate_train(snt, 2, 1, n, device)
    net = snt.LatticeNetwork.generate_network(lats, [st])
    net.connections[(2, 0)] = one_to_one_coo(n, 100.0)
    src, dst = np.nonzero(rng.random((n, n)) < 0.1)
    net.connections[(0, 1)] = (src.astype(np.int64), dst.astype(np.int64),
                               np.full(len(src), 20.0, np.float32))
    net.use_kernel = use_kernel
    return net


def flat_case(snt, chem, fam, rec, nt, elec, mode, train, model, n, seed):
    """A random flat-mode network of three (1, N) lattices of ``model``
    ("izh", "alif", "dopa", and without chemistry "lif"), widths n, n1, n1
    (n1 = n in mode "intra", else 3n/4, so that the blocks are not
    square), made from ``seed``: v across the threshold, 30% with a past
    firing time at clock 3, and with ``chem`` the random chemical state of
    the chemical cases; lattices 0 and 1 on random dense graphs (30% of
    the pairs, weights everywhere, so the mask matters) in modes "intra"
    and "both", edgeless otherwise; random dense blocks (20% of the pairs)
    0 -> 1 and 1 -> 0 in modes "block" and "both", and in "both" one from
    the train into lattice 1; else 0 -> 1 one to one; the edgeless
    lattice 2 into lattice 1 and the Poisson (300 Hz) or Rate train into
    lattice 0 one to one.  Chemical weights are positive (a negative
    receptor input turns the NMDA gate's power into NaN)."""
    rng = np.random.default_rng(seed)
    n1 = n if mode == "intra" else max(3 * n // 4, 4)
    recs = snt.DopaGluGABAReceptors(rec) if fam == "dopaglugaba" \
        else snt.IonotropicReceptors(rec)
    cls = {"izh": snt.Izhikevich, "dopa": snt.DopaIzhikevich,
           "alif": snt.AdaptiveLeakyIntegrateAndFire,
           "lif": snt.LeakyIntegrateAndFire}[model]

    def f(lo, hi, shp):
        return torch.as_tensor(rng.uniform(lo, hi, shp).astype(np.float32),
                               device="cuda")

    def b(p, shp):
        return torch.as_tensor(rng.random(shp) < p, device="cuda")

    def lft(m):
        return torch.as_tensor(np.where(
            rng.random(m) < 0.3, rng.integers(0, 3, m),
            -1).astype(np.int32), device="cuda")

    lats = []
    for lid, m in enumerate((n, n1, n1)):
        lat = snt.Lattice(cls(nt_kinetics=nt, rec_kinetics=rec,
                              receptors=recs) if chem else cls(),
                          id=lid, device="cuda")
        lat.populate(1, m, gap_conductance=10.0)
        if lid < 2 and mode != "block":
            mask = rng.random((m, m)) < 0.3
            w = rng.uniform(0.5, 1.5, (m, m)) if chem \
                else rng.normal(0.0, 1.0, (m, m))
            lat.set_graph(snt.DenseGraph(
                torch.as_tensor(w.astype(np.float32), device="cuda"),
                torch.as_tensor(mask, device="cuda")))
        if chem:
            lat.state = random_chem_state(lat.state, fam, m, rng, f, b)
        else:
            lo, hi = (-70, 40) if model == "izh" else (-75, -48)
            lat.state = {**lat.state, "v": f(lo, hi, (m,)),
                         "last_firing_time": lft(m)}
        lats.append(lat)
    tm = (snt.PoissonSpikeTrain if train == "poisson"
          else snt.RateSpikeTrain)(nt_kinetics=nt)
    st = snt.SpikeTrainLattice(tm, id=5, device="cuda")
    st.populate(1, n)
    st.state = tm.init_from_firing_rate(n, hertz=300.0, dt=0.1,
                                        device="cuda") \
        if train == "poisson" else tm.init_state(n, rate=0.5, dt=0.1,
                                                 device="cuda")
    st.state = {**st.state, "last_firing_time": lft(n)}
    if chem:
        st.state = {**tm.insert_neurotransmitter(st.state, "AMPA"),
                    "nt$t": f(0, 1, (n, 3))}
    net = snt.LatticeNetwork.generate_network(lats, [st])

    def block(n_pre, n_post, lo, hi):
        src, dst = np.nonzero(rng.random((n_pre, n_post)) < 0.2)
        return (src.astype(np.int64), dst.astype(np.int64),
                rng.uniform(lo, hi, len(src)).astype(np.float32))

    net.connections[(5, 0)] = one_to_one_coo(n, 3.0)
    net.connections[(2, 1)] = one_to_one_coo(n1, 1.0)
    if mode == "intra":
        net.connections[(0, 1)] = one_to_one_coo(n, 1.5)
    else:
        net.connections[(0, 1)] = block(n, n1, 0.5, 1.5)
        net.connections[(1, 0)] = block(n1, n, 0.5, 1.5)
        if mode == "both":
            net.connections[(5, 1)] = block(n, n1, 1.0, 3.0)
    net.electrical_synapse = elec or not chem
    net.chemical_synapse = chem
    net.internal_clock = 3
    return net


def net_state_as_outputs(net, spec, chem_keys):
    """The members' states after a run, in the layout of a kernel call's
    outputs (the spec's shapes), for `compare_chem`."""
    lats = []
    for ls, lat in zip(spec.lattices,
                       (net.lattices[i] for i in sorted(net.lattices))):
        s, shp = lat.state, ls.shape
        lats.append(dict(
            v=s["v"].reshape(shp), w=s["w"].reshape(shp),
            lft=s["last_firing_time"].reshape(shp),
            spikes=s["is_spiking"].reshape(shp),
            chem={k: s[k] for k in chem_keys} if chem_keys else None))
    trains = [dict(lft=st.state["last_firing_time"].reshape(ts.shape),
                   ntt=st.state["nt$t"] if ts.nt else None)
              for ts, st in zip(spec.trains, (
                  net.spike_train_lattices[i]
                  for i in sorted(net.spike_train_lattices)))]
    return lats, trains, []


def flat_ops(spec, lats, conns, k):
    """Float operations one flat-mode call of ``k`` steps needs (`EXP_OPS`
    per exp).  Per entry of a dense graph or block and step, a multiply
    and an add for each sum that changes with the state: 2 for the
    electrical sum and 6 for the three chemical sums.  What the state does
    not change is taken once per call: the column sum of the weights that
    the electrical term subtracts (1 per entry; a train subtracts nothing)
    and the three chemical counts (6 per entry).  Per cell and step the
    model step (23), with electrical synapses the re-expansion, gap and
    count (6), with chemistry what `chem_ops` counts per cell."""
    def per_entry(train, nt):
        return (((2 * k + (0 if train else 1)) if spec.electrical else 0)
                + ((6 * k + 6) if spec.chem and nt else 0))

    ops = 0
    dopa = bool(spec.chem) and spec.chem[0] == "dopaglugaba"
    for i, (ls, d) in enumerate(zip(spec.lattices, lats)):
        n = ls.shape[1]
        n_in = sum(cs.post == i for cs in spec.conns)
        per_cell = 23 + (6 + 2 * n_in if spec.electrical else 0)
        if spec.chem:
            per_cell += (3 + 3 * (6 + 4 * n_in) + 3 * 2 * (2 if dopa else 1)
                         + (19 if dopa else 13) + EXP_OPS + 3 + 3 * 6)
        entries = n * n if ls.graph == "dense" else 0
        ops += k * n * per_cell + entries * per_entry(False, True)
    for cs, c in zip(spec.conns, conns):
        if cs.op[0] != "dense":
            continue
        nt = not cs.pre_is_st or bool(spec.trains[cs.pre].nt)
        ops += c["w"].numel() * per_entry(cs.pre_is_st, nt)
    return ops


def flat_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
    max_err, times, bounds, launches, lib_ms = flat_twin_phase(snt, nk, smi)
    flat_cmp_phase(snt)
    flat_times_phase(snt, smi)
    K = nk.STEPS_PER_LAUNCH
    return {"name": "network_persistent (flat-mode arm)", "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/"
                      "network_persistent.cu",
            "replaces": FLAT_REPLACES, "launches": launches,
            "max_abs_err": max_err,
            "ms": times["persistent"][1] * K / 1e3,
            "plain_ms": times["twin"] * K / 1e3,
            "device_ms": times["persistent"][2] * K / 1e3,
            "other_design_ms": times["per_step"][1] * K / 1e3,
            "other_design_device_ms": times["per_step"][2] * K / 1e3,
            "bound_ms": bounds[0], "bound_by": bounds[1],
            "library_ms": lib_ms,
            "library_call": f"torch.mv on one ({DENSE_N}, {DENSE_N}) float32 "
                            f"matrix: one dense gather of one step"}


def flat_twin_phase(snt, nk, smi):
    """22. The flat-mode arm vs its plain twin on the card: random cases
    over electrical and chemical networks, both receptor families, the
    kinetics, dense graphs, dense blocks and both, Poisson and Rate trains,
    N in `FLAT_NS`; then the three main paths through `run_lattices`, every
    call of their first `FTWIN_STEPS` steps on the state that call
    received, and both designs timed in turns on each one's first call.
    Returns (max float error, {design: design_times' tuple, "twin": us per
    step} of the N = 512 Bayesian network, that call's bound, the main
    paths' flat-mode kernel calls, the ms of one `torch.mv` on a (512,
    512) matrix)."""
    import itertools
    sms = nk._sm_count(torch.device("cuda"))
    lines, _ = variant_lines(nk, (2, 3))
    for line in lines:
        say(f"[22 persistent kernel] {line}; card {smi}")
    max_err, n_cases = 0.0, 0
    kinetics = list(itertools.product(nk.REC_KINDS, nk.NT_KINDS))
    for seed, (n, mode, chem) in enumerate(itertools.product(
            FLAT_NS, FLAT_MODES, (False, True))):
        fam = nk.CHEM_FAMILIES[(seed // 2) % 2]
        rec, nt = kinetics[(seed * 7) % len(kinetics)]
        train = "poisson" if seed % 4 < 2 else "rate"
        elec = seed % 3 > 0
        model = (("izh", "dopa", "alif") if chem
                 else ("izh", "lif", "alif"))[seed % 3]
        if fam == "ionotropic" and model == "dopa":
            model = "izh"
        k = 16 if seed % 2 else 7
        net = flat_case(snt, chem, fam, rec, nt, elec, mode, train, model, n,
                        seed)
        args = chem_inputs(nk, net, k, seed, chem)
        check(nk.is_flat(args[0]), "a random case is not in flat mode")
        check(nk.uses_persistent(args[0], sms),
              "a flat case missed the persistent kernel's route")
        before = nk.PERSISTENT_LAUNCHES
        got = nk.network_steps(*args, 3, k)
        torch.cuda.synchronize()
        want = nk.network_steps_reference(*args, 3, k)
        per_step = bit_mismatches(
            nk.network_steps(*args, 3, k, per_step=True), want)
        err, bad, _ = compare_chem(got, want)
        bits = (bit_mismatches(got, want), per_step)
        fired = sum(int((d["lft"] >= 3).sum()) for d in got[0])
        what = f"{fam} {rec}/{nt} electrical={elec}" if chem \
            else "electrical only"
        say(f"[22 kernel-vs-twin] N={n} mode={mode} K={k} {model} {what} "
            f"{train}: integer and spike mismatches {bad}, max float error "
            f"{err:.3g}, outputs not bit-equal: persistent {bits[0]}, per "
            f"step {bits[1]}, fired {fired}")
        check(bad == 0, "firing times, spikes or counts differ")
        check(bits == ([], []) and nk.PERSISTENT_LAUNCHES == before + 1,
              "a design is not bit-equal to the twin, or the call missed "
              "the persistent kernel")
        check(err == 0.0, "the flat arm is not bit-equal to its twin")
        check(fired > 0, "no neuron fired in the call")
        check(all(bool(torch.isfinite(x).all()) for _, x in flat_outputs(got)
                  if x.is_floating_point()), "a random case went non-finite")
        max_err, n_cases = max(max_err, err), n_cases + 1
        del net, args, got, want
    # the main paths through `run_lattices`: every call of the first
    # `FTWIN_STEPS` steps held against the twin on the state that call
    # received, then the rest of the run in one call
    times = bounds = None
    launches = 0
    K = nk.STEPS_PER_LAUNCH
    paths = (
        (f"Bayesian network {BAYES[0][0]}x{BAYES[0][1]} + "
         f"{BAYES[1][0]}x{BAYES[1][1]}", lambda: bayes_net(snt, *BAYES),
         BAYES_STEPS, ("flat-chemical", True)),
        (f"Bayesian network {BAYES_BIG[0][0]}x{BAYES_BIG[0][1]} + "
         f"{BAYES_BIG[1][0]}x{BAYES_BIG[1][1]}",
         lambda: bayes_net(snt, *BAYES_BIG), BAYES_BIG_STEPS,
         ("flat-chemical", True)),
        (f"electrical dense network N={DENSE_N}",
         lambda: dense_net(snt, DENSE_N), DENSE_STEPS, ("flat", False)))
    for label, build, steps, route in paths:
        t0 = time.perf_counter()
        net = build()
        built = time.perf_counter() - t0
        chem = route[0] == "flat-chemical"
        bad, err, fired, herr, timed = 0, 0.0, 0, 0.0, None
        nk.LAUNCHES = nk.CHEM_LAUNCHES = nk.FLAT_LAUNCHES = 0
        nk.PERSISTENT_LAUNCHES = 0
        done = 0
        while done < steps:
            n = min(K, steps - done)
            clock = net.internal_clock
            if done >= FTWIN_STEPS:
                # the rest of the run in one call, not held against the twin
                net.run_lattices(steps - done)
                torch.cuda.synchronize()
                check(net._last_run_fused == route,
                      f"the main path took {net._last_run_fused}, not {route}")
                fired += sum(int((l.state["last_firing_time"] >= clock).sum())
                             for l in net.lattices.values())
                break
            g = torch.Generator(device="cuda")
            g.set_state(net.generator().get_state())
            spec, lats, trains, conns, _, rule = chem_inputs(nk, net, 1, 0,
                                                             chem)
            uniforms = [torch.rand((n, *ts.shape), generator=g, device="cuda")
                        if ts.kind == "poisson" else None
                        for ts in spec.trains]
            args = (spec, lats, trains, conns, uniforms, rule)
            want = nk.network_steps_reference(*args, clock, n)
            if done == 0:
                timed = (args, clock)
            net.run_lattices(n)
            torch.cuda.synchronize()
            check(net._last_run_fused == route,
                  f"the main path took {net._last_run_fused}, not {route}")
            keys = nk.chem_out_keys(spec.chem) if chem else ()
            got = net_state_as_outputs(net, spec, keys)
            ref = ([dict(v=d["v"], w=d["w"], lft=d["lft"], spikes=d["spikes"],
                         chem=d["chem"]) for d in want[0]],
                   [dict(lft=d["lft"], ntt=d["ntt"]) for d in want[1]], [])
            e, b, _ = compare_chem(got, ref)
            bad, err = bad + b, max(err, e)
            fired += sum(int((d["lft"] >= clock).sum()) for d in got[0])
            for ls, d, lat in zip(spec.lattices, want[0], (
                    net.lattices[i] for i in sorted(net.lattices))):
                if not ls.emit:
                    continue
                # the grid history, rebuilt from the emitted (1, N) rows in
                # the lattice's own (rows, cols)
                st = lat.state
                v_pre = d["v_pre"].reshape(n, -1)
                hist = torch.where(v_pre >= st["v_th"], st["c"], v_pre)
                rec = torch.from_numpy(np.stack(
                    lat.grid_history.history[-n:])).cuda()
                herr = max(herr, (rec.reshape(n, -1) - hist).abs().max()
                           .item())
            done += n
        calls = nk.FLAT_LAUNCHES
        launches += calls
        members = list(net.lattices.values()) \
            + list(net.spike_train_lattices.values())
        finite = all(bool(torch.isfinite(x).all()) for m in members
                     for x in m.state.values() if x.is_floating_point())
        per_lat = {i: int((l.state["last_firing_time"] >= 0).sum())
                   for i, l in net.lattices.items()}
        cue = {i: int((s.state["last_firing_time"] >= 0).sum())
               for i, s in net.spike_train_lattices.items()}
        extra = ""
        if chem:
            inh, exc = net.lattices[0].state, net.lattices[1].state
            extra = (f", exc max nt$t {exc['nt$t'].max().item():.4g}, inh "
                     f"max rec$r {inh['rec$r'].max().item():.4g}, exc "
                     f"inh_mod range [{exc['rec$inh_modifier'].min().item():.4f}"
                     f", {exc['rec$inh_modifier'].max().item():.4f}], history "
                     f"{len(net.lattices[1].grid_history.history)} steps, max "
                     f"history error {herr:.3g}")
            check(exc["nt$t"].max().item() > 0
                  and inh["rec$r"].max().item() > 0,
                  f"{label}: no transmitter released or received")
            check(len(net.lattices[1].grid_history.history) == steps
                  and herr == 0.0, f"{label}: the grid history differs")
        say(f"[22 main path] {label} (built in {built:.1f} s), "
            f"run_lattices over {steps} steps, every call of the first "
            f"{min(steps, FTWIN_STEPS)} against the twin: route "
            f"{net._last_run_fused}, kernel calls {calls}, integer and spike "
            f"mismatches {bad}, max float error {err:.3g}, state finite "
            f"{finite}, fired per lattice {per_lat}, per train {cue}, spikes "
            f"{fired}{extra}")
        check(bad == 0 and err == 0.0, "the main path differs from the twin")
        check(calls == nk.LAUNCHES == -(-steps // K)
              and nk.CHEM_LAUNCHES == (calls if chem else 0)
              and nk.PERSISTENT_LAUNCHES == calls,
              "wrong number of flat-mode kernel calls or persistent "
              "launches")
        check(finite and fired > 0, f"{label}: non-finite state or no spike")
        # one 16-step call on the state the run started from: both designs
        # in turns, the twin and the bound
        args, clock = timed
        spec, lats, trains, conns, uniforms, _ = args
        members, smem = nk.persistent_plan(spec, sms, nk.SMEM_BUDGET)
        call_bound = bound(chem_bytes(spec, lats, trains, conns, uniforms,
                                      nk.network_steps(*args, clock, K)),
                           flat_ops(spec, lats, conns, K))
        d = design_times(nk, args, clock, K)
        twin = event_ms(lambda: nk.network_steps_reference(
            *args, clock, K), 2) / K * 1e3
        say(f"[22 times] main path {label}, 16-step calls, the designs in "
            f"turns: {design_line(d)}; plain twin {twin:.3f} us (events); "
            f"bound {call_bound[0] * 1e3 / K:.4f} us ({call_bound[1]}); "
            f"plan {plan_line(members, smem)}; card {smi}")
        if chem and net.lattices[1].n == DENSE_N:
            # the full-width call
            times = {key: v for key, v in d.items()}
            times["twin"] = twin
            bounds = call_bound
        del net, timed
    wm = torch.randn((DENSE_N, DENSE_N), device="cuda")
    vec = torch.randn(DENSE_N, device="cuda")
    lib_ms = event_ms(lambda: torch.mv(wm, vec), 200)
    say(f"[22 library] torch.mv on a ({DENSE_N}, {DENSE_N}) float32 matrix "
        f"(one dense gather of one step): {lib_ms * 1e3:.3f} us per call "
        f"(events, 200 calls back to back); card {smi}")
    say(f"[22 kernel-vs-twin] max float error over {n_cases} random cases "
        f"and the main paths {max_err:.3g} (0 = bit-equal)")
    return max_err, times, bounds, launches, lib_ms


def flat_cmp_phase(snt):
    """23. The upstream-size Bayesian network with its cues at rate 0 for
    1000 steps: the kernel route on the card against the same route (the
    twin) on the CPU."""
    runs = {}
    for key, device, uk in (("kernel", "cuda", None), ("cpu", "cpu", True)):
        net = bayes_net(snt, *BAYES, use_kernel=uk, device=device,
                        hertz=(0.0, 0.0))
        net.run_lattices(FCMP_STEPS)
        lats = [net.lattices[i] for i in sorted(net.lattices)]
        runs[key] = (np.stack(net.lattices[1].grid_history.history),
                     [l.field("last_firing_time").astype(np.int64)
                      for l in lats],
                     [l.field(k) for l in lats
                      for k in ("nt$t", "rec$r", "rec$r2", "rec$current")],
                     net._last_run_fused)
    check(runs["kernel"][3] == runs["cpu"][3] == ("flat-chemical", True),
          "wrong flat-mode routes")
    dv = float(np.abs(runs["kernel"][0] - runs["cpu"][0]).max())
    dl = max(int(np.abs(a - b).max())
             for a, b in zip(runs["kernel"][1], runs["cpu"][1]))
    dc = max(float(np.abs(a - b).max())
             for a, b in zip(runs["kernel"][2], runs["cpu"][2]))
    fired = [int((x >= 0).sum()) for x in runs["kernel"][1]]
    say(f"[23 kernel-vs-cpu] Bayesian network {BAYES[0][0]}x{BAYES[0][1]} + "
        f"{BAYES[1][0]}x{BAYES[1][1]}, cues at rate 0, {FCMP_STEPS} steps, "
        f"kernel route on the card vs on the CPU: max|dv| {dv:.4g} mV over "
        f"the exc history, max|dlft| {dl} steps, max chemical field "
        f"difference {dc:.4g}, fired per lattice {fired}")
    check(dv <= 2.0 and dl <= 2, "flat card vs CPU outside 2 mV / 2 steps")
    check(sum(fired) > 0, "no neuron of the comparison fired")


def flat_times_phase(snt, smi):
    """24. Times of the flat kernel route and the plain route on the three
    main paths, in turns: wall per step (median of 5 after a warm-up) and
    the kernels' device time per step."""
    for label, build, kern_steps, plain_steps, route in (
            ("Bayesian 7x7 + 3x3", lambda uk: bayes_net(
                snt, *BAYES, use_kernel=uk), 1024, 128,
             ("flat-chemical", True)),
            (f"Bayesian N={DENSE_N} + N={DENSE_N}", lambda uk: bayes_net(
                snt, *BAYES_BIG, use_kernel=uk), 1024, 64,
             ("flat-chemical", True)),
            (f"electrical dense N={DENSE_N}", lambda uk: dense_net(
                snt, DENSE_N, use_kernel=uk), 1024, 128, ("flat", False))):
        kern, plain = build(None), build(False)
        run_net_synced(kern, kern_steps)
        run_net_synced(plain, plain_steps)
        tk, tp = [], []
        for rep in range(5):
            tk.append(run_net_synced(kern, kern_steps))
            if rep < 3:
                tp.append(run_net_synced(plain, plain_steps))
        check(kern._last_run_fused == route
              and plain._last_run_fused is False,
              "timed the wrong flat-mode routes")
        mk, mp = float(np.median(tk)), float(np.median(tp))
        dev_us, top = profiled_us(lambda: run_net_synced(kern, PROFILE_STEPS),
                                  PROFILE_STEPS, n_top=5)
        n_all = sum(l.n for l in kern.lattices.values())
        busy = dev_us * kern_steps / (mk * 1e6)
        say(f"[24 times] {label}: kernel route (use_kernel=None) "
            f"{net_rate(n_all, mk, kern_steps)}, median of 5 x {kern_steps} "
            f"steps; device time {dev_us:.3f} us/step (profiled: "
            + ", ".join(f"{k} {t:.3f}" for k, t in top)
            + f"), device time / wall {busy:.3f}; plain route "
            f"(use_kernel=False) {net_rate(n_all, mp, plain_steps)}, median "
            f"of 3 x {plain_steps} steps; card {smi}")
        del kern, plain


# ---------------------------------------------------------------------------
# Reward networks (the reward arm): phases 25-28
# ---------------------------------------------------------------------------


def reward_main_net(snt, rows, cols, use_kernel=None, device="cuda",
                    train="poisson", seed=0, fire=False):
    """`bench.py:330-366`'s reward network: a `RewardModulatedLattice`
    (gap 10) on ``connect(hypot <= 2 and x != y)`` (a 12-offset stencil),
    a plastic `Lattice` (gap 10, radius 2, keep 0.8, graph seed 4, v0
    uniform in [-65, 25) from ``default_rng(seed)``), a Poisson train at
    40 Hz (``train="rate"``: a Rate train of 1 ms), ``connect(2, 1, a ==
    b, 5.0)`` and ``connect_with_reward_modulation(1, 0, a == b, 1.0)``.
    Up to 32^2 the predicates run on the host as a user calls them; above,
    where they would take hours, `connect_stencil(radius=2.0)` (equal to
    the predicate, checked at 32^2) and the host lists they give are set
    before the first run.  With ``fire``, the reward lattice's v0 is
    uniform in [-65, 30) too, so that it fires from the start (its default
    rest state first fires after ~1500 steps)."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    rlat = snt.RewardModulatedLattice(snt.Izhikevich(), id=0, device=device)
    rlat.populate(rows, cols, gap_conductance=10.0)
    if n <= 32 * 32:
        rlat.connect(lambda x, y: np.hypot(x[0] - y[0], x[1] - y[1]) <= 2
                     and x != y)
        g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(2.0),
                                   device=device)
        check(rlat.graph.offsets == g.offsets
              and torch.equal(rlat.graph.weights, g.weights),
              "the radius-2 predicate is not connect_stencil(radius=2)")
    else:
        rlat.connect_stencil(radius=2.0)
    plain = snt.Lattice(snt.Izhikevich(), id=1, device=device)
    plain.populate(rows, cols, gap_conductance=10.0)
    plain.connect_stencil(radius=2.0, keep_prob=0.8, seed=4)
    plain.do_plasticity = True
    v0 = rng.uniform(-65.0, 25.0, n)
    plain.apply(lambda s: {**s, "v": torch.as_tensor(
        v0, dtype=torch.float32, device=plain.device)})
    if fire:
        v1 = rng.uniform(-65.0, 30.0, n)
        rlat.apply(lambda s: {**s, "v": torch.as_tensor(
            v1, dtype=torch.float32, device=rlat.device)})
    st = poisson_train(snt, 2, rows, cols, 40.0, device) \
        if train == "poisson" else rate_train(snt, 2, rows, cols, device)
    net = snt.RewardModulatedLatticeNetwork.generate_network([rlat, plain],
                                                             [st])
    one = lambda a, b: a == b
    if n <= 32 * 32:
        net.connect(2, 1, one, lambda a, b: 5.0)
        net.connect_with_reward_modulation(1, 0, one, lambda a, b: 1.0)
        check(all(np.array_equal(a, b) for a, b in zip(
            net.connections[(2, 1)], one_to_one_coo(n, 5.0))),
              "a COO helper differs from connect")
    else:
        net.connections[(2, 1)] = one_to_one_coo(n, 5.0)
        src, dst, w = one_to_one_coo(n, 1.0)
        net.reward_connections[(1, 0)] = (
            src, dst, w, np.zeros(n, np.float32), np.zeros(n, np.float32),
            np.zeros(n, np.int32))
        net._conn_version += 1
    net.seed, net.use_kernel = seed, use_kernel
    return net


def reward_case(snt, model, shape, seed, train, statics):
    """A random network of the reward arm's class on the card: reward
    lattices 0 and 3, a plastic lattice 1, a plain lattice 2, a train 4;
    plain connections train -> 1 and 1 -> 2, and with ``statics`` 2 -> 0
    and 0 -> 2 (one static visit each); reward connections 1 -> 0
    (plastic -> reward), 0 -> 3 (reward -> reward, two static visits),
    train -> 3 and 2 -> 1; random weights, v across the threshold, past
    firing times for 30% of the neurons (clock 3), random traces, the
    bounded R-STDP of `RSTDP`."""
    rng = np.random.default_rng(seed)
    rows, cols = shape
    n = rows * cols
    cls = getattr(snt, model)
    lats = []
    for lid, kind, radius, keep in ((0, "reward", 2.0, 0.8),
                                    (1, "plastic", 1.5, 0.9),
                                    (2, "plain", 1.0, 1.0),
                                    (3, "reward", 1.5, 0.7)):
        lat = (snt.RewardModulatedLattice if kind == "reward"
               else snt.Lattice)(cls(), id=lid, device="cuda")
        lat.populate(rows, cols, gap_conductance=10.0)
        lat.connect_stencil(radius=radius, keep_prob=keep, seed=seed + lid)
        lat.do_plasticity = kind == "plastic"
        lats.append(lat)
    st = poisson_train(snt, 4, rows, cols, 200.0, "cuda") \
        if train == "poisson" else rate_train(snt, 4, rows, cols, "cuda")
    net = snt.RewardModulatedLatticeNetwork.generate_network(lats, [st])
    idx = np.arange(n, dtype=np.int64)
    w = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    net.connections = {(4, 1): (idx, idx, w(10, 30)),
                       (1, 2): (idx, idx, w(1, 8))}
    if statics:
        net.connections.update({(2, 0): (idx, idx, w(0.5, 2)),
                                (0, 2): (idx, idx, w(0.5, 2))})
    rc = lambda lo, hi: (idx, idx, w(lo, hi),
                         rng.normal(0, 0.5, n).astype(np.float32),
                         rng.normal(0, 0.5, n).astype(np.float32),
                         rng.integers(0, 2, n).astype(np.int32))
    net.reward_connections = {(1, 0): rc(0.5, 2), (0, 3): rc(0.5, 2),
                              (4, 3): rc(1, 5), (2, 1): rc(0.5, 2)}
    izh = model == "Izhikevich"
    for lat in net._neuron_lattices().values():
        f32 = lambda x: torch.as_tensor(x.astype(np.float32), device="cuda")
        lft = np.where(rng.random(n) < 0.3, rng.integers(0, 3, n), -1)
        lat.apply(lambda s, lft=lft: {
            **s, "v": f32(rng.uniform(-70, 35, n) if izh
                          else rng.uniform(-75, -45, n)),
            "last_firing_time": torch.as_tensor(lft.astype(np.int32),
                                                device="cuda")})
        if isinstance(lat, snt.RewardModulatedLattice):
            sh = tuple(lat.graph.weights.shape)
            lat.trace = dict(
                c=f32(rng.normal(0, 0.5, sh)), dw=f32(rng.normal(0, 0.5, sh)),
                counter=torch.as_tensor(rng.integers(0, 2, sh).astype(
                    np.int32), device="cuda"))
    net.reward_modulator.params.update(RSTDP)
    net.dopamine = float(rng.uniform(0.1, 0.5))
    net.internal_clock = 3
    net._conn_version += 1
    return net


def reward_inputs(nk, net, with_reward, n_steps, uniforms_from=None):
    """One call's inputs from a reward network's members: (spec, lats,
    trains, conns, uniforms, rule, reward); the Poisson uniforms drawn
    as `network_kernels.advance` draws them, from a copy of
    ``uniforms_from`` (a generator) or from a fresh seed."""
    from spiking_neural_networks_tpu_torch.core.reward_structured import (
        resolve_reward_plan)
    plan = resolve_reward_plan(net)
    lattices = net._neuron_lattices()
    kinds = tuple("mod" if i in net.reward_modulated_lattices
                  else "plastic" if lattices[i].do_plasticity else "plain"
                  for i in plan["lat_ids"])
    spec = nk.reward_network_spec(net, plan, kinds, True, with_reward)
    check(spec is not None, "the network is outside the reward arm's class")
    lats, trains, conns = nk.member_inputs(spec, net, plan)
    g = torch.Generator(device="cuda")
    if uniforms_from is None:
        g.manual_seed(net.seed)
    else:
        g.set_state(uniforms_from.get_state())
    uniforms = [torch.rand((n_steps, *ts.shape), generator=g, device="cuda")
                if ts.kind == "poisson" else None for ts in spec.trains]
    rng = np.random.default_rng(net.seed)
    reward = dict(rule=net.reward_modulator.params,
                  dopamine=torch.tensor(net.dopamine, dtype=torch.float32,
                                        device="cuda"),
                  rewards=rng.uniform(-0.5, 1.0, n_steps).astype(np.float32))
    return (spec, lats, trains, conns, uniforms,
            net._plasticity().params, reward)


def reward_outputs(out):
    """(name, tensor) pairs of a reward-arm call's outputs."""
    lat, tr, cn, extra = out
    pairs = []
    for k, d in enumerate(lat):
        for key in ("v", "w", "lft", "refr", "spikes", "weights"):
            if d.get(key) is not None:
                pairs.append((f"{key}{k}", d[key]))
        if d.get("traces") is not None:
            pairs += [(f"{key}{k}", d["traces"][key])
                      for key in ("c", "dw", "counter")]
    for j, d in enumerate(tr):
        pairs += [(f"train {key}{j}", d[key]) for key in ("lft", "spikes",
                                                          "step")
                  if d.get(key) is not None]
    pairs += [(f"conn{c}", w) for c, w in enumerate(cn)]
    for c, t in enumerate(extra["traces"]):
        if t is not None:
            pairs += [(f"conn{c} {key}", t[key])
                      for key in ("c", "dw", "counter")]
    return pairs + [("dopamine", torch.as_tensor(extra["dopamine"]))]


def compare_reward(got, want):
    """(max float error, integer/spike mismatches) of a reward-arm call
    against its twin, name by name."""
    gp, wp = reward_outputs(got), reward_outputs(want)
    check([n for n, _ in gp] == [n for n, _ in wp],
          "the outputs of the kernel and the twin differ in kind")
    err, bad = 0.0, 0
    for (name, g), (_, w) in zip(gp, wp):
        w = w.to(g.device)
        if g.dtype in (torch.int32, torch.bool) or name.startswith("refr"):
            bad += int((g != w).sum())
            continue
        check(bool(torch.isfinite(g).all()), f"non-finite {name}")
        err = max(err, (g - w).abs().max().item() if g.numel() else 0.0)
    return err, bad


def reward_state(net, spec):
    """A reward network's members after a run, in the layout of a
    reward-arm call's outputs (plan order; connection weights and traces
    from the plan's device copies, the dopamine as a tensor)."""
    from spiking_neural_networks_tpu_torch.core.reward_structured import (
        resolve_reward_plan)
    plan = resolve_reward_plan(net)
    lattices = net._neuron_lattices()
    lat = []
    for ls, i in zip(spec.lattices, plan["lat_ids"]):
        s, shp = lattices[i].state, ls.shape
        lat.append(dict(
            v=s["v"].reshape(shp), w=s["w"].reshape(shp),
            lft=s["last_firing_time"].reshape(shp),
            spikes=s["is_spiking"].reshape(shp),
            refr=s["refractory_count"].reshape(shp)
            if "refractory_count" in s else None,
            weights=lattices[i].graph.weights,
            traces=lattices[i].trace if ls.kind == "mod" else None))
    trains = []
    for ts, i in zip(spec.trains, plan["st_ids"]):
        s = net.spike_train_lattices[i].state
        trains.append({k: s[key].reshape(ts.shape) for k, key in (
            ("lft", "last_firing_time"), ("spikes", "is_spiking"),
            ("step", "step")) if key in s})
    entries = plan["conns"] + plan["rconns"]
    shp = spec.lattices[0].shape
    conns = [entries[ci]["op"].w0.reshape(shp) for ci in spec.keep]
    traces = [{k: v.reshape(shp) for k, v in entries[ci]["trace0"].items()}
              if cs.reward else None for cs, ci in zip(spec.conns, spec.keep)]
    return lat, trains, conns, dict(traces=traces, dopamine=torch.tensor(
        net.dopamine, dtype=torch.float32))


def reward_bytes(args, out):
    """Bytes one reward-arm call must move: each input once (the rewards
    as the call's n_steps floats), each output once."""
    spec, lats, trains, conns, uniforms, _, reward = args
    return tensor_bytes(lats, trains, conns, uniforms, reward["dopamine"],
                        out) + 4 * len(reward["rewards"])


def reward_ops(spec, lats, k):
    """A lower bound of the float operations of one call: each lattice's
    phase A and model step (`stencil_ops`), and per masked slot of a mod
    lattice the two R-STDP visits (7 operations each); connections,
    trains, STDP and the deltas' exps not counted."""
    ops = 0
    for ls, d in zip(spec.lattices, lats):
        ops += stencil_ops(ls.offsets, *ls.shape, k)
        if ls.kind == "mod" and ls.offsets:
            ops += k * 14 * int(d["mask"].sum())
    return ops


def reward_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
    max_err, n_cases = reward_twin_phase(snt, nk)
    err, launches, times, bounds = reward_main_phase(snt, nk, smi)
    reward_cmp_phase(snt)
    reward_times_phase(snt, nk, smi)
    K = nk.STEPS_PER_LAUNCH
    return {"name": "network_persistent (reward arm)", "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/"
                      "network_persistent.cu",
            "replaces": REWARD_REPLACES, "launches": launches,
            "max_abs_err": max(max_err, err),
            "ms": times["persistent"][0] * K,
            "plain_ms": times["twin"] * K,
            "device_ms": times["persistent"][1] * K,
            "per_step_ms": times["per_step"][0] * K,
            "per_step_device_ms": times["per_step"][1] * K,
            "bound_ms": bounds[0], "bound_by": bounds[1],
            "library_ms": None,
            "library_call": "none: no PyTorch call computes a network step"}


def reward_twin_phase(snt, nk):
    """25. The reward arm vs its plain twin on the card: `RCASES` random
    networks over Izhikevich, ALIF and LIF, with and without rewards,
    static visit counts 0, 1 and 2, trains into plastic and reward
    lattices, plastic -> reward and reward -> reward connections, at
    non-uniform states.  Returns (max float error, cases)."""
    import itertools
    max_err, n_cases = 0.0, 0
    models = ("Izhikevich", "AdaptiveLeakyIntegrateAndFire",
              "LeakyIntegrateAndFire")
    for seed, (shape, model, with_reward) in enumerate(itertools.product(
            RSHAPES, models, (True, False))):
        train = "poisson" if seed % 3 else "rate"
        statics = seed % 4 != 3
        k = 16 if seed % 2 else 7
        net = reward_case(snt, model, shape, seed, train, statics)
        args = reward_inputs(nk, net, with_reward, k)
        spec = args[0]
        got = nk.network_steps(*args[:6], 3, k, args[6])
        torch.cuda.synchronize()
        want = nk.network_steps_reference(*args[:6], 3, k, args[6])
        ps = nk.network_steps(*args[:6], 3, k, args[6], per_step=True)
        err, bad = compare_reward(got, want)
        bits = (bit_mismatches(got, want), bit_mismatches(ps, want))
        fired = sum(int((d["lft"] >= 3).sum()) for d in got[0])
        moved = max((g - c["w"]).abs().max().item()
                    for g, c in zip(got[2], args[3]))
        say(f"[25 kernel-vs-twin] {model} {shape[0]}x{shape[1]} K={k} "
            f"{train} rewards={with_reward} static counts "
            f"{[cs.static for cs in spec.conns]}: integer and spike "
            f"mismatches {bad}, max float error {err:.3g}, outputs not "
            f"bit-equal: persistent {bits[0]}, per-step {bits[1]}; fired "
            f"{fired}, max connection weight change {moved:.4g}, dopamine "
            f"{float(got[3]['dopamine']):.5g}")
        check(bad == 0, "firing times, spikes or counters differ")
        check(err == 0.0 and bits == ([], []),
              "the reward arm is not bit-equal to its twin")
        check(fired > 0 and moved > 0, "no spike or no weight change")
        max_err, n_cases = max(max_err, err), n_cases + 1
        del net, args, got, want, ps
    say(f"[25 kernel-vs-twin] max float error over {n_cases} random cases "
        f"{max_err:.3g} (0 = bit-equal)")
    return max_err, n_cases


def reward_main_phase(snt, nk, smi):
    """25-26. The main path, `bench.py`'s reward network through
    `run_lattices_with_reward`, at `RMAINS`: every call of the first
    `RTWIN_STEPS` steps held against the twin on the state that call
    received (traces and dopamine included), then the rest of the run in
    one call; route, call counts, weights, traces and dopamine; then one
    call from a firing state held against the twin, and timed at full
    width.  Returns (max float error, kernel calls, (kernel, twin, device)
    ms per step of the full-width call, its bound)."""
    K = nk.STEPS_PER_LAUNCH
    max_err, launches, times, bounds = 0.0, 0, None, None
    for shape, steps in RMAINS:
        t0 = time.perf_counter()
        net = reward_main_net(snt, *shape)
        built = time.perf_counter() - t0
        w1 = net.lattices[1].graph.weights.clone()
        bad, err, held = 0, 0.0, 0
        nk.LAUNCHES = nk.REWARD_LAUNCHES = nk.PERSISTENT_LAUNCHES = 0
        done = 0
        while done < steps:
            clock = net.internal_clock
            if done >= RTWIN_STEPS or shape[0] * shape[1] > RTWIN_MAX:
                net.run_lattices_with_reward(REWARD, steps - done)
                torch.cuda.synchronize()
                break
            args = reward_inputs(nk, net, True, K, net.generator())
            reward = dict(args[6], rewards=np.full(K, REWARD, np.float32))
            args = args[:6] + (reward,)
            want = nk.network_steps_reference(*args[:6], clock, K, reward)
            net.run_lattices_with_reward(REWARD, K)
            torch.cuda.synchronize()
            e, b = compare_reward(reward_state(net, args[0]), want)
            bad, err, held = bad + b, max(err, e), held + 1
            done += K
        route = net._last_run_fused
        calls = nk.REWARD_LAUNCHES
        launches += nk.PERSISTENT_LAUNCHES
        check(nk.PERSISTENT_LAUNCHES == calls,
              "a reward-arm call missed the persistent kernel")
        lat0, lat1 = net.reward_modulated_lattices[0], net.lattices[1]
        members = [lat0, lat1] + list(net.spike_train_lattices.values())
        finite = all(bool(torch.isfinite(x).all()) for m in members
                     for x in m.state.values() if x.is_floating_point()) \
            and all(bool(torch.isfinite(x).all()) for x in
                    (lat0.graph.weights, lat1.graph.weights,
                     lat0.trace["c"], lat0.trace["dw"]))
        fired = [int((l.state["last_firing_time"] >= 0).sum())
                 for l in (lat0, lat1)]
        rc = net.reward_connections[(1, 0)]
        dw1 = (lat1.graph.weights - w1).abs().max().item()
        c0 = lat0.trace["c"].abs().max().item()
        say(f"[26 main path] reward network {shape[0]}x{shape[1]} (built in "
            f"{built:.1f} s), run_lattices_with_reward({REWARD}) over {steps} "
            f"steps: route {route}, reward-arm calls {calls}, every call of "
            f"the first {held * K} held against the twin: integer and spike "
            f"mismatches {bad}, max float error {err:.3g}; state finite "
            f"{finite}, dopamine {net.dopamine:.6g}, fired per lattice "
            f"{fired} of {shape[0] * shape[1]}, plastic weight change "
            f"{dw1:.4g}, reward lattice weights "
            f"[{lat0.graph.weights.min().item():.4g}, "
            f"{lat0.graph.weights.max().item():.4g}], max |c| {c0:.4g}, "
            f"reward connection w [{rc[2].min():.4g}, {rc[2].max():.4g}], "
            f"max |c| {np.abs(rc[3]).max():.4g}; card {smi}")
        check(route == ("reward", False), f"the main path took {route}")
        check(calls == nk.LAUNCHES == -(-steps // K),
              "wrong number of reward-arm calls")
        check(bad == 0 and err == 0.0, "the main path differs from the twin")
        check(finite and math.isfinite(net.dopamine),
              "the main path went non-finite")
        check(dw1 > 0 and fired[1] > 0, "the plastic lattice did not learn")
        # the reward lattice first fires after ~1500 steps from its rest
        # state: its traces move only in the 3000-step runs
        check(fired[0] == 0 or c0 > 0, "the reward lattice fired, but its "
              "traces did not move")
        check(steps < 3000 or (fired[0] > 0 and np.abs(rc[3]).max() > 0),
              "the reward lattice or connection never learned")
        max_err = max(max_err, err)
        # one call from a state where the reward lattice has fired, so that
        # the R-STDP edge kernel and the gated reward-connection visits are
        # held to the twin with deltas that are not 0: the state a 3000-step
        # run left; a shorter run (512^2 over 1024 steps) goes on until the
        # traces of the reward lattice and connection have moved
        more = 0
        while more < RFIRE_MAX and not (
                lat0.trace["c"].abs().max().item() > 0
                and np.abs(net.reward_connections[(1, 0)][3]).max() > 0):
            net.run_lattices_with_reward(REWARD, 16 * K)
            more += 16 * K
        args = reward_inputs(nk, net, True, K, net.generator())
        args = args[:6] + (dict(args[6], rewards=np.full(K, REWARD,
                                                         np.float32)),)
        clock = net.internal_clock
        kernel = lambda: nk.network_steps(*args[:6], clock, K, args[6])
        twin = lambda: nk.network_steps_reference(*args[:6], clock, K,
                                                  args[6])
        got = kernel()
        torch.cuda.synchronize()
        want = twin()
        e, b = compare_reward(got, want)
        bits = bit_mismatches(got, want)
        spec = args[0]
        dmod = max((g["weights"] - d["weights"]).abs().max().item()
                   for ls, g, d in zip(spec.lattices, got[0], args[1])
                   if ls.kind == "mod")
        drc = max((g - d["w"]).abs().max().item()
                  for cs, g, d in zip(spec.conns, got[2], args[3])
                  if cs.reward)
        say(f"[26 kernel-vs-twin] main path {shape[0]}x{shape[1]} K={K}, one "
            f"call from a firing state (run on {more} steps past the main "
            f"path, clock {clock}, dopamine "
            f"{float(args[6]['dopamine']):.6g}): integer and spike "
            f"mismatches {b}, max float error {e:.3g}, outputs not bit-equal "
            f"{bits}, max weight change of the reward lattice {dmod:.4g} and "
            f"of the reward connection {drc:.4g}")
        check(b == 0 and e == 0.0 and not bits,
              "the firing-state call differs from the twin")
        check(dmod > 0 and drc > 0, "the firing-state call moved no R-STDP "
              "weight")
        max_err = max(max_err, e)
        if shape == RMAINS[-1][0]:
            members, smem, info = persistent_info(nk, spec)
            check([m.resident for m in members]
                  == [ls.kind != "mod" for ls in spec.lattices]
                  + [True] * len(spec.conns),
                  "the 512^2 reward plan should stream the mod lattice only")
            bounds = bound(reward_bytes(args, got),
                           reward_ops(args[0], args[1], K))
            d = design_times(nk, args[:6], clock, K, args[6])
            twin_us = event_ms(twin, 2) / K * 1e3
            times = {key: (v[1] / 1e3, v[2] / 1e3) for key, v in d.items()}
            times["twin"] = twin_us / 1e3
            say(f"[26 kernel-vs-twin] main path {shape[0]}x{shape[1]} K={K} "
                f"per step, the call above, the designs in turns: "
                f"{design_line(d)}; plain twin {twin_us:.3f} us (events); "
                f"bound {bounds[0] * 1e3 / K:.4f} us ({bounds[1]}); library "
                f"call: none; plan: {plan_line(members, smem)}; grid "
                f"{info['blocks']} blocks; card {smi}")
        del net, args, got, want
    return max_err, launches, times, bounds


def reward_cmp_phase(snt):
    """27. 32^2, a Rate train, the reward lattice firing from the start
    (v0 uniform), 250 steps at `CMP_REWARD`: the kernel route on the card
    against the same route on the CPU (bit-equal expected), then against
    the plain route on the card, step by step (the tie rule); then the
    flat COO runner (a `LatticeNetwork` subclass with a connecting-graph
    history) on the card against the CPU."""
    runs = {}
    for key, device, uk in (("kernel", "cuda", None), ("cpu", "cpu", True)):
        net = reward_main_net(snt, *RCMP, use_kernel=uk, device=device,
                              train="rate", fire=True)
        net.run_lattices_with_reward(CMP_REWARD, RCMP_STEPS)
        lat0, lat1 = net.reward_modulated_lattices[0], net.lattices[1]
        runs[key] = ([x.cpu() for x in (
            lat0.state["v"], lat1.state["v"], lat0.graph.weights,
            lat1.graph.weights, lat0.trace["c"], lat0.trace["dw"])],
            [x.cpu() for x in (lat0.state["last_firing_time"],
                               lat1.state["last_firing_time"],
                               lat0.trace["counter"])],
            net.dopamine, net.reward_connections[(1, 0)],
            net._last_run_fused)
    check(runs["kernel"][4] == runs["cpu"][4] == ("reward", False),
          "wrong reward routes")
    dv = max((a - b).abs().max().item()
             for a, b in zip(runs["kernel"][0], runs["cpu"][0]))
    di = sum(int((a != b).sum())
             for a, b in zip(runs["kernel"][1], runs["cpu"][1]))
    dr = max(float(np.abs(a - b).max())
             for a, b in zip(runs["kernel"][3][2:5], runs["cpu"][3][2:5]))
    fired = [int((x >= 0).sum()) for x in runs["kernel"][1][:2]]
    say(f"[27 kernel-vs-cpu] reward network + Rate {RCMP[0]}x{RCMP[1]} "
        f"{RCMP_STEPS} steps at reward {CMP_REWARD}, kernel route on the "
        f"card vs on the CPU: max|dv| (and weights, traces) {dv:.4g}, "
        f"integer mismatches {di}, max reward-connection difference "
        f"{dr:.4g}, dopamine {runs['kernel'][2]:.6g} vs "
        f"{runs['cpu'][2]:.6g}, fired per lattice {fired}")
    check(dv == 0.0 and di == 0 and dr == 0.0
          and runs["kernel"][2] == runs["cpu"][2],
          "the reward arm on the card differs from the CPU")
    check(min(fired) > 0, "a lattice of the comparison never fired")
    hist = {}
    for key, uk in (("kernel", None), ("plain", False)):
        net = reward_main_net(snt, *RCMP, use_kernel=uk, train="rate",
                              fire=True)
        vs = []
        for _ in range(RCMP_STEPS):
            net.update_and_apply_reward(CMP_REWARD)
            vs.append(torch.cat([net.reward_modulated_lattices[0].state["v"],
                                 net.lattices[1].state["v"]]))
        check(net._last_run_fused == (("reward", False) if uk is not False
                                      else False), "wrong reward routes")
        hist[key] = (torch.stack(vs).cpu().numpy(), torch.cat([
            net.reward_modulated_lattices[0].state["last_firing_time"],
            net.lattices[1].state["last_firing_time"]]).cpu().numpy()
            .astype(np.int64))
    tie_check(f"[27 kernel-vs-plain] reward network + Rate {RCMP[0]}x"
              f"{RCMP[1]} {RCMP_STEPS} steps, one step per call, fused vs "
              f"plain association on the card", *hist["kernel"],
              *hist["plain"], 2 * RCMP[0] * RCMP[1])
    flat = {}

    class FlatNet(snt.LatticeNetwork):
        """A subclass: the flat COO runner."""

    for key, device in (("card", "cuda"), ("host", "cpu")):
        net = reward_flat_net(snt, FlatNet, *RCMP, device)
        net.run_lattices(RFLAT_STEPS)
        exc = net.lattices[0]
        flat[key] = (np.stack(exc.grid_history.history).reshape(
            RFLAT_STEPS, -1), exc.field("last_firing_time").reshape(-1)
            .astype(np.int64), np.stack(net.connecting_graph_history))
    dh = float(np.abs(flat["card"][2] - flat["host"][2]).max())
    say(f"[27 flat runner] LatticeNetwork subclass, {RCMP[0]}x{RCMP[1]}, "
        f"{RFLAT_STEPS} steps with a connecting-graph history of "
        f"{flat['card'][2].shape[1]} edges: max weight-history difference "
        f"card vs CPU {dh:.4g}")
    tie_check(f"[27 flat runner] card vs CPU (index_add_ and products in "
              f"another order)", flat["card"][0], flat["card"][1],
              flat["host"][0], flat["host"][1], RCMP[0] * RCMP[1])
    check(dh <= 1e-3, "the flat runner's weights part beyond 1e-3")


def reward_flat_net(snt, cls, rows, cols, device):
    """A plastic Izhikevich lattice (radius 2, keep 0.8, v0 uniform in
    [-65, 30), STDP a+- 0.02) with a grid history, a quiet lattice it
    drives one to one, and a Rate train driving it one to one, as
    subclass ``cls`` with a connecting-graph history: the flat COO runner
    with ``index_add_`` gathers."""
    rng = np.random.default_rng(3)
    exc = snt.Lattice(snt.Izhikevich(), id=0, device=device)
    exc.populate(rows, cols, gap_conductance=10.0)
    exc.connect_stencil(radius=2.0, keep_prob=0.8, seed=5)
    exc.do_plasticity = True
    exc.plasticity = snt.STDP(a_plus=0.02, a_minus=0.02)
    v0 = rng.uniform(-65.0, 30.0, rows * cols)
    exc.apply(lambda s: {**s, "v": torch.as_tensor(
        v0, dtype=torch.float32, device=exc.device)})
    exc.grid_history = snt.history.GridVoltageHistory()
    exc.update_grid_history = True
    quiet = snt.Lattice(snt.Izhikevich(), id=1, device=device)
    quiet.populate(rows, cols, gap_conductance=10.0)
    quiet.connect_stencil(radius=1.0, seed=6)
    st = rate_train(snt, 2, rows, cols, device)
    net = cls.generate_network([exc, quiet], [st])
    net.connections[(2, 0)] = one_to_one_coo(rows * cols, 5.0)
    net.connections[(0, 1)] = one_to_one_coo(rows * cols, 2.0)
    net.update_connecting_graph_history = True
    net.dense_gather = False       # index_add_: float atomics on the card
    return net


def reward_times_phase(snt, nk, smi):
    """28. Per main-path size: wall time per step (median of 3 runs after
    a warm-up), CUDA-event time per step over one run, the kernels'
    device time under torch.profiler and device / wall; then the
    persistent and the per-step design on the same 16-step calls, in
    turns."""
    K = nk.STEPS_PER_LAUNCH
    for shape, steps in RTIMES:
        net = reward_main_net(snt, *shape)
        run = lambda n: net.run_lattices_with_reward(REWARD, n)
        run(steps)
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(steps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        check(net._last_run_fused == ("reward", False),
              "timed the wrong reward route")
        ev = event_ms(lambda: run(steps), 1) / steps
        dev_us, top = profiled_us(lambda: run(PROFILE_STEPS), PROFILE_STEPS,
                                  n_top=6)
        wall = float(np.median(walls))
        n_all = 2 * shape[0] * shape[1]
        say(f"[28 times] reward network {shape[0]}x{shape[1]}, kernel route "
            f"(use_kernel=None, the persistent kernel): "
            f"{net_rate(n_all, wall, steps)}, median of 3 x {steps} steps; "
            f"CUDA events {ev * 1e3:.3f} us/step; device time {dev_us:.3f} "
            f"us/step (profiled: "
            + ", ".join(f"{k} {t:.3f}" for k, t in top)
            + f"), device time / wall {dev_us * steps / (wall * 1e6):.3f}; "
            f"card {smi}")
        args = reward_inputs(nk, net, True, K, net.generator())
        reward = dict(args[6], rewards=np.full(K, REWARD, np.float32))
        clock = net.internal_clock
        d = design_times(nk, args[:6], clock, K, reward)
        host = host_split(nk, args[:6], clock, K, reward)
        say(f"[28 times] reward network {shape[0]}x{shape[1]}, 16-step "
            f"calls, the designs in turns: {design_line(d)}; host time of a "
            f"persistent call {host[0]:.1f} us, of which input checks "
            f"{host[1]:.1f} us, output buffers {host[2]:.1f} us; card {smi}")
        del net, args


# ---------------------------------------------------------------------------
# The closed loop: phases 29-32
# ---------------------------------------------------------------------------


def bench_env(snt, rows, cols, use_kernel=None, device="cuda",
              reward=None, encoder=None):
    """`bench.py`'s closed loop (`bench_closed_loop`): a
    `RewardModulatedLattice(Izhikevich())`, gap 10, radius 2, keep 1.0,
    graph seed 5, v uniform in [-65, 30) from ``default_rng(0)``, a cue
    holding the first 6 neurons (row-major) at 31 mV (or the callback
    ``encoder``), the reward ``clip(0.08 - rate, -0.05, 0.05)`` (or the
    callback ``reward``) and the rate update 0.9 / 0.1 of the mean
    spike."""
    from spiking_neural_networks_tpu_torch.convert import env_from
    from spiking_neural_networks_tpu_torch.interactable import JitEnvironment
    lat = snt.RewardModulatedLattice(snt.Izhikevich(), device=device)
    lat.populate(rows, cols, gap_conductance=10.0)
    lat.connect_stencil(radius=2.0, keep_prob=1.0, seed=5)
    v0 = np.random.default_rng(0).uniform(-65, 30, rows * cols)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(
        v0, dtype=torch.float32, device=lat.device)})
    lat.use_kernel = use_kernel
    env = JitEnvironment(lat, env_from({"rate": np.float32(0.0)}, device),
                         encoder or env_encoder, reward or env_reward,
                         env_update)
    return lat, env


def env_encoder(e, s):
    v = s["v"]
    cue = torch.arange(v.shape[0], device=v.device) < 6
    return {**s, "v": torch.where(cue, 31.0, v)}


def env_reward(e, s):
    return torch.clamp(0.08 - e["rate"], -0.05, 0.05)


def env_reward_cmp(e, s):
    """The bench loop's reward at a tenth (within +-0.005), as the other
    R-STDP comparisons take 0.005: the weights stay within ~12 at 64^2
    over 1000 steps, where the bench's reward grows them to ~58 by step
    600."""
    return 0.1 * env_reward(e, s)


def env_update(e, s):
    return {"rate": 0.9 * e["rate"]
            + 0.1 * s["is_spiking"].to(torch.float32).mean()}


def unsup_env(snt, rows, cols, use_kernel=None, device="cuda"):
    """The unsupervised loop: the main STDP `Lattice` (radius 2, keep 0.8)
    with the bench loop's cue and rate update, no reward."""
    from spiking_neural_networks_tpu_torch.convert import env_from
    from spiking_neural_networks_tpu_torch.interactable import JitEnvironment
    lat = stdp_lattice(snt, rows, cols, use_kernel, device)
    env = JitEnvironment(lat, env_from({"rate": np.float32(0.0)}, device),
                         env_encoder, None, env_update)
    return lat, env


def env_buffers(a, rk=None, per_step=False):
    """Fresh buffers of one closed loop from `plasticity_inputs`'
    arguments: two plane sets, spikes, weights, traces, dopamine, clock;
    with ``rk``, the `EnvChain` of the kernel's launches (``per_step``:
    the design that flushes after every step)."""
    src = tuple(None if x is None else x.clone()
                for x in (a["v"], a["w"], a["lft"], a["refr"]))
    b = dict(src=src, dst=tuple(None if x is None else torch.zeros_like(x)
                                for x in src),
             spikes=torch.zeros_like(a["v"], dtype=torch.bool),
             weights=a["weights"].clone(),
             traces=None if a["traces"] is None
             else tuple(t.clone() for t in a["traces"]),
             dopamine=a["dopamine"].clone(),
             clock=torch.tensor([a["clock0"]], dtype=torch.int32,
                                device=a["v"].device), chain=None)
    if rk is not None:
        b["chain"] = rk.EnvChain(b["dopamine"], b["clock"],
                                 tuple(a["v"].shape), per_step)
    return b


def env_launchers(make, a, b):
    """The launches of ``make`` (`env_step_launcher` or its twin) on the
    buffers ``b`` from each plane set into the other (the kernel's sharing
    ``b``'s chain)."""
    kw = {} if b["chain"] is None else dict(chain=b["chain"])
    return [make(a["spec"], b[s], b[d], b["spikes"], b["weights"], a["mask"],
                 a["in_deg"], a["params"], b["traces"], b["dopamine"],
                 a["rule"], b["clock"], **kw)
            for s, d in (("src", "dst"), ("dst", "src"))]


def env_chain(launch, b, n):
    """``n`` steps of the two ``launch``es on buffers ``b``, each reward
    computed on the device from the state the step receives, then a flush
    of the kernel's chain; returns the final planes and the rewards."""
    planes, rewards = [b["src"], b["dst"]], []
    for k in range(n):
        p = k % 2
        reward = (0.05 - 0.001 * planes[p][0].mean()
                  + 0.1 * b["spikes"].to(torch.float32).mean()).reshape(())
        rewards.append(reward)
        launch[p](reward)
    if b["chain"] is not None:
        b["chain"].flush()
    return planes[n % 2], torch.stack(rewards)


def env_tensors(b):
    """Every tensor of the buffers ``b`` but the chain's."""
    return ([x for k in ("src", "dst") for x in b[k] if x is not None]
            + [b["spikes"], b["weights"], b["dopamine"], b["clock"]]
            + list(b["traces"] or ()))


def bench_inputs(snt, rk, shape):
    """`plasticity_inputs`' arguments from the agent of `bench_env` at
    ``shape``: its state, graph, traces, dopamine, rule and clock."""
    lat, _ = bench_env(snt, *shape)
    st, g = lat.state, lat.graph
    plane = lambda k: st[k].reshape(shape)
    return dict(
        spec=rk.LatSpec("mod", "izhikevich", g.offsets, with_reward=True),
        v=plane("v"), w=plane("w"), lft=plane("last_firing_time"),
        refr=None, weights=g.weights, mask=g.mask, in_deg=g.in_deg,
        params={k: plane(k) for k in rk.MODEL_PARAM_KEYS["izhikevich"]},
        traces=tuple(lat.trace[k] for k in ("c", "dw", "counter")),
        dopamine=torch.tensor(float(lat.dopamine), device="cuda"),
        rule=lat.reward_modulator.params, clock0=lat.internal_clock)


def env_outputs(planes, b, rewards):
    """The named outputs of an env chain (None where the kind has none)."""
    v, w, lft, refr = planes
    c, dw, counter = b["traces"] or (None, None, None)
    return dict(v=v, w=w, lft=lft, refr=refr, spikes=b["spikes"],
                weights=b["weights"], c=c, dw=dw, counter=counter,
                dopamine=b["dopamine"], clock=b["clock"], rewards=rewards)


def compare_exact(got, want):
    """(max float error, integer/spike mismatches) over the names of
    ``want`` that are not None in both dicts."""
    err, bad = 0.0, 0
    for k, w in want.items():
        g = got.get(k)
        if g is None or w is None:
            continue
        if g.is_floating_point() and k != "refr":
            check(bool(torch.isfinite(g).all()), f"non-finite {k}")
            err = max(err, (g - w).abs().max().item())
        else:
            bad += int((g != w).sum())
    return err, bad


def env_step_bytes(spec, a, k):
    """Bytes of ``k`` closed-loop steps, each input read and each output
    written once per step (v, w, lft, refr, spikes in and out; weights and
    traces in and out with plasticity; reward, dopamine and clock), the
    per-call constants (parameter planes, in-degree, mask) once."""
    n = a["v"].numel()
    state = 4 * n * (3 + (a["refr"] is not None)) + n
    plastic = tensor_bytes(a["weights"]) if spec.kind != "plain" else 0
    if spec.kind == "mod":
        plastic += tensor_bytes(*a["traces"])
    per_step = 2 * (state + plastic) + 3 * 4
    consts = tensor_bytes(a["params"], a["in_deg"]) + (
        a["mask"].numel() if spec.kind != "plain" else 0)
    return k * per_step + consts


def env_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import reward_kernels as rk
    max_err, times, bounds = env_twin_phase(snt, rk, smi)
    err, launches = env_main_phase(snt, rk, smi)
    env_cmp_phase(snt)
    env_times_phase(snt, rk, smi)
    return {"name": "lattice_plasticity_env_step (closed loop)",
            "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/"
                      "lattice_plasticity.cu",
            "replaces": ENV_REPLACES, "launches": launches,
            "max_abs_err": max(max_err, err),
            "ms": times[0], "plain_ms": times[1],
            "bound_ms": bounds[0], "bound_by": bounds[1],
            "library_ms": None,
            "library_call": "none: no PyTorch call computes a lattice step"}


def env_twin_phase(snt, rk, smi):
    """29. The env entry vs its twin on the card, in both designs (the
    fused launches of an `EnvChain` and its per-step form): `ENV_KINDS` x
    models x `ESHAPES`, 16 chained steps each with the reward computed on
    the device, non-uniform states, then a flush: bit-equal, and the
    launches the C entry counted as each design has them; per kind one
    case where 6a's `lattice_plasticity_steps`, given the env run's
    rewards by value, equals the env entry; then at 512^2 and 10 x 10 on
    the bench loop's agent both designs timed in turns (wall, events,
    profiled device time with every kernel record counted), each design's
    final state held against the twin's steps from the same start over
    the same steps.  Returns (max float error, (ms, twin ms) per 16 steps
    at 512^2, bound)."""
    import itertools
    K = rk.STEPS_PER_LAUNCH
    max_err, n_cases, by_value = 0.0, 0, set()
    for seed, (shape, (kind, rew), model) in enumerate(itertools.product(
            ESHAPES, ENV_KINDS, rk.MODELS)):
        a = plasticity_inputs(snt, rk, shape, kind, model, rew, False, False,
                              K, 700 + seed)
        plastic = kind != "plain"
        outs, counted = [], []
        for make, per_step in ((rk.env_step_launcher, False),
                               (rk.env_step_launcher, True),
                               (rk.env_step_launcher_reference, None)):
            b = env_buffers(a, rk if per_step is not None else None,
                            bool(per_step))
            planes, rewards = env_chain(env_launchers(make, a, b), b, K)
            torch.cuda.synchronize()
            outs.append(env_outputs(planes, b, rewards))
            if b["chain"] is not None:
                counted.append(b["chain"].launched)
        got = outs[0]
        errs = [compare_exact(o, outs[2]) for o in outs[:2]]
        err = max(e for e, _ in errs)
        bad = sum(x for _, x in errs)
        fired = int((got["lft"] >= a["clock0"]).sum())
        want_launches = [K + plastic, 2 * K]
        line = (f"[29 kernel-vs-twin] {shape[0]}x{shape[1]} {kind} {model} "
                f"reward={rew}, {K} chained steps and a flush, rewards from "
                f"the device, fused and per-step designs: integer and spike "
                f"mismatches {bad}, max float error {err:.3g}, launches "
                f"{counted} (want {want_launches}), fired {fired}, clock "
                f"{int(got['clock'])}")
        check(bad == 0 and err == 0.0, "the env entry is not bit-equal to "
              "its twin")
        check(counted == want_launches, "wrong env launch counts")
        check(fired > 0 and int(got["clock"]) == a["clock0"] + K,
              "no neuron fired, or the clock did not advance")
        if (kind, rew) not in by_value:
            # 6a's by-value entry from the same start, given these rewards
            by_value.add((kind, rew))
            six = rk.lattice_plasticity_steps(**dict(
                a, rewards=got["rewards"].cpu().numpy() if rew else None))
            torch.cuda.synchronize()
            names = ("v", "w", "lft", "refr", "spikes", "weights")
            want = dict(zip(names, six[:6]), dopamine=six[7])
            if six[6] is not None:
                want.update(zip(("c", "dw", "counter"), six[6]))
            e6, b6 = compare_exact(got, want)
            line += (f"; 6a's lattice_plasticity_steps given these rewards "
                     f"by value: mismatches {b6}, max float error {e6:.3g}")
            check(b6 == 0 and e6 == 0.0, "the env entry differs from 6a by "
                  "value")
        say(line)
        max_err, n_cases = max(max_err, err), n_cases + 1
    times, bounds, terr = {}, None, 0.0
    for shape in (EBIG, (10, 10)):
        res, err = env_designs(snt, rk, shape, smi)
        terr = max(terr, err)
        if shape == EBIG:
            times, bounds = res
    say(f"[29 kernel-vs-twin] max float error over {n_cases} random cases "
        f"x 2 designs {max_err:.3g}, over the timed calls {terr:.3g} (0 = "
        f"bit-equal)")
    return max(max_err, terr), times, bounds


def env_designs(snt, rk, shape, smi):
    """Both designs of the env entry on the bench loop's agent at
    ``shape`` (reward 0.05, at its clip), 16 steps and a flush a call, in
    turns (`designs_in_turns`: wall, events, profiled device time with
    every kernel record counted: 17 and 32 a call); the launches the C
    entry counted; then each design's state after its calls held against
    the twin's steps over as many calls from the same start.  Returns
    (((ms, twin ms) per call, bound), max float error)."""
    K = rk.STEPS_PER_LAUNCH
    a = bench_inputs(snt, rk, shape)
    reward = torch.tensor(0.05, device="cuda")
    bufs = {d: env_buffers(a, rk, d == "per_step")
            for d in ("fused", "per_step")}
    calls = {}
    n_calls = {d: 0 for d in bufs}

    def call_of(d):
        b = bufs[d]
        fns = env_launchers(rk.env_step_launcher, a, b)

        def fn():
            n_calls[d] += 1
            for k in range(K):
                fns[k % 2](reward)
            b["chain"].flush()
        return fn

    for d in bufs:
        calls[d] = call_of(d)
    launches = {"fused": K + 1, "per_step": 2 * K}
    out = designs_in_turns(calls, launches, K, reps=ETIME_REPS // 2)
    counted = {d: bufs[d]["chain"].launched for d in bufs}
    err, bad = 0.0, 0
    for d in bufs:
        bt = env_buffers(a)
        twin = env_launchers(rk.env_step_launcher_reference, a, bt)
        for _ in range(n_calls[d]):
            for k in range(K):
                twin[k % 2](reward)
        e, bb = compare_exact(env_outputs(bufs[d]["src"], bufs[d], None),
                              env_outputs(bt["src"], bt, None))
        err, bad = max(err, e), bad + bb
    fired = int((bufs["fused"]["src"][2] >= 0).sum())
    twin_ms = event_ms(lambda: [twin[k % 2](reward) for k in range(K)], 2)
    spec = a["spec"]
    bnd = bound(env_step_bytes(spec, a, K), stencil_ops(
        spec.offsets, *shape, K) + K * 14 * int(a["mask"].sum()))
    say(f"[29 times] env entry, bench loop agent {shape[0]}x{shape[1]}, "
        f"reward 0.05, calls of {K} steps and a flush, the designs in "
        f"turns: {design_line(out)}; launches counted by the C entry "
        + ", ".join(f"{d} {counted[d]} in {n_calls[d]} calls "
                    f"({counted[d] / n_calls[d]:.2f} a call)" for d in bufs)
        + f"; each design's state after its calls against the twin's steps "
        f"from the same start: integer and spike mismatches {bad}, max "
        f"float error {err:.3g}, fired {fired}; plain twin "
        f"{twin_ms * 1e3 / K:.3f} us/step; bound {bnd[0] * 1e3 / K:.4f} "
        f"us/step ({bnd[1]}); library call: none; card {smi}")
    check(bad == 0 and err == 0.0 and fired > 0, "a timed design is not "
          "bit-equal to the twin, or nothing fired")
    check(all(counted[d] == n_calls[d] * launches[d] for d in bufs),
          "the C entry counted other launches than the design has")
    return ((out["fused"][1] * K / 1e3, twin_ms), bnd), err


def env_call(env, n, with_reward=True):
    """One call of ``n`` steps as `JitEnvironment.run_with_reward` /
    `run` makes it without a history (one chunk), with PyTorch's host
    syncs turned into errors around the steps: the prologue (gate, probe,
    capture) may wait for the card, the steps may not; the final pull
    does."""
    plan = env._begin(n, with_reward, None)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        env._advance(plan)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    return env._finish(plan)


def agent_snapshot(lat, env):
    """Host copies of an agent's state, weights, traces, dopamine and clock
    and the env's rate."""
    host = lambda x: x.to("cpu", copy=True)
    snap = {f"state.{k}": host(x) for k, x in lat.state.items()}
    snap["weights"] = host(lat.graph.weights)
    for k, x in (getattr(lat, "trace", None) or {}).items():
        snap[f"trace.{k}"] = host(x)
    snap["dopamine"] = torch.tensor(getattr(lat, "dopamine", 0.0))
    snap["clock"] = torch.tensor(lat.internal_clock)
    snap["rate"] = host(env.state["rate"])
    return snap


def hold_replays(rk, env, n, with_reward):
    """One call of ``n`` steps (a multiple of K) of ``env`` on tier (a),
    each graph replay held against the twin (the callbacks and
    `env_step_launcher_reference`) run from the state the replay received.
    Returns (max float error, integer and spike mismatches)."""
    K = rk.STEPS_PER_LAUNCH
    plan = env._begin(n, with_reward, None)
    loop = plan.loop
    check(plan.graph, f"no graph to hold: {env.last_capture_error}")
    params = {k: loop.other[k].view(loop.shape)
              for k in rk.MODEL_PARAM_KEYS[loop.spec.model]}
    twin = [rk.env_step_launcher_reference(
        loop.spec, loop.planes[p], loop.planes[1 - p], loop.spikes,
        loop.weights, loop.mask, loop.in_deg, params, loop.traces,
        loop.dopamine, loop.rule, loop.clock)
        for p in (0, 1)]
    kernel = loop.launch
    plan.rewards = torch.empty(n, device="cuda")
    err, bad = 0.0, 0
    for j in range(n // K):
        start = [b.clone() for b in loop.state_buffers()]
        loop.graph.replay()
        plan.rewards[j * K:(j + 1) * K].copy_(loop.rew)
        got = [b.clone() for b in loop.state_buffers()]
        for b, x in zip(loop.state_buffers(), start):
            b.copy_(x)
        loop.launch = twin
        try:
            for k in range(K):
                loop.step(loop.rew[k])
        finally:
            loop.launch = kernel
        e, bb = compare_exact(dict(enumerate(got)),
                              dict(enumerate(loop.state_buffers())))
        err, bad = max(err, e), bad + bb
        for b, x in zip(loop.state_buffers(), got):
            b.copy_(x)
    env._finish(plan)
    return err, bad


def env_main_phase(snt, rk, smi):
    """30. The main paths through `JitEnvironment` on tier (a): `bench.py`'s
    closed loop at 10 x 10 over 6400 steps and at 512^2 over 1024, the
    unsupervised loop at 512^2 over 1024, each one call with host syncs
    turned into errors around its steps (route flags, launch counters,
    finite state, rewards varying, dopamine, weights and traces moved,
    the clock), then one graph replay more of each held against the twin
    on the state it received; two calls against one at 10 x 10; every
    replay of the first `ETWIN_STEPS` steps at 64^2 held against the
    twin; a grid history at 64^2 (tier (b)) against tier (a).
    Returns (max float error, env-entry launches)."""
    K = rk.STEPS_PER_LAUNCH
    launches, max_err, first = 0, 0.0, None
    for label, shape, steps in EMAINS:
        sup = label == "bench"
        lat, env = (bench_env if sup else unsup_env)(snt, *shape)
        w0 = lat.graph.weights.clone()
        rk.ENV_LAUNCHES = rk.LAUNCHES = 0
        t0 = time.perf_counter()
        rewards = env_call(env, steps, sup)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        calls, six = rk.ENV_LAUNCHES, rk.LAUNCHES
        launches += calls
        floats = [x for x in lat.state.values() if x.is_floating_point()]
        floats += [lat.graph.weights] + ([lat.trace["c"], lat.trace["dw"]]
                                         if sup else [])
        finite = all(bool(torch.isfinite(x).all()) for x in floats)
        fired = int((lat.state["last_firing_time"] >= 0).sum())
        dw = (lat.graph.weights - w0).abs().max().item()
        c = lat.trace["c"].abs().max().item() if sup else 0.0
        spread = float(np.ptp(rewards)) if sup else 0.0
        say(f"[30 main path] {label} loop {shape[0]}x{shape[1]} "
            f"{'run_with_reward' if sup else 'run'}({steps}), one call with "
            f"host syncs as errors around its steps: env-fused "
            f"{env.last_build_env_fused}, fused {env.last_build_fused}, "
            f"env-entry kernel launches {calls} (17 a replay of 16 steps, "
            f"and the probe's warm-up step and flush), 6a calls {six}, "
            f"clock "
            f"{lat.internal_clock}, {secs:.3f} s; state finite {finite}, "
            f"fired {fired} of {shape[0] * shape[1]}, max weight change "
            f"{dw:.4g}"
            + (f", max |c| {c:.4g}, dopamine {lat.dopamine:.6g}, rewards in "
               f"[{rewards.min():.4g}, {rewards.max():.4g}]" if sup else "")
            + f", rate {float(env.state['rate']):.4g}; card {smi}")
        check(env.last_build_env_fused and env.last_build_fused,
              "the main path did not take tier (a)")
        # 16 fused launches and a flush a replay, and the probe's warm-up
        # step and flush before the capture, on a snapshot of the buffers
        check(calls == steps // K * (K + 1) + 2 and six == 0,
              "wrong launch counts")
        check(lat.internal_clock == steps, "the clock did not advance")
        check(finite and math.isfinite(lat.dopamine if sup else 0.0),
              "the main path went non-finite")
        check(fired > 0 and dw > 0, "no neuron fired or no weight moved")
        check(not sup or (c > 0 and lat.dopamine != 0.0),
              "traces or dopamine did not move")
        # the rate is the mean spike: the 6-neuron cue moves it (and the
        # reward off its clip at 0.05) only at the bench's own size
        check(shape != EMAINS[0][1] or spread > 0, "the rewards never moved")
        if first is None:
            first = (agent_snapshot(lat, env), rewards)
        err, bad = hold_replays(rk, env, K, sup)
        say(f"[30 main path] {label} loop {shape[0]}x{shape[1]}, the graph "
            f"replay of steps {steps}-{steps + K - 1} held against the twin "
            f"(callbacks and env entry) on the state it received: integer "
            f"and spike mismatches {bad}, max float error {err:.3g}")
        check(bad == 0 and err == 0.0, "a replay differs from the twin")
        max_err = max(max_err, err)
        # a call of one replay, counted by the C entry at the capture and
        # in the profiler's records of the replay
        rk.ENV_LAUNCHES, n_calls = 0, [0]

        def one_replay():
            n_calls[0] += 1
            env_call(env, K, sup)

        recs = kernel_records(one_replay, K + 1, mine=("lp_",))
        say(f"[30 main path] {label} loop {shape[0]}x{shape[1]}, a call of "
            f"one replay under the profiler: {sum(recs.values())} kernel "
            f"records ({records_line(recs)}), the C entry's count "
            f"{rk.ENV_LAUNCHES / n_calls[0]:.2f} a replay")
        check(sum(recs.values()) == K + 1
              and rk.ENV_LAUNCHES == n_calls[0] * (K + 1),
              "the replay's kernel records differ from the counted launches")
        del lat, env
    # two calls equal one call
    lat, env = bench_env(snt, *EMAINS[0][1])
    half = EMAINS[0][2] // 2
    rewards = np.concatenate([env.run_with_reward(half),
                              env.run_with_reward(half)])
    snap = agent_snapshot(lat, env)
    diff = sum(int((snap[k] != first[0][k]).sum()) for k in snap)
    say(f"[30 main path] bench loop {EMAINS[0][1][0]}x{EMAINS[0][1][1]} in "
        f"two calls of {half}: {diff} values differ from one call of "
        f"{2 * half}, rewards equal {np.array_equal(rewards, first[1])}")
    check(diff == 0 and np.array_equal(rewards, first[1]),
          "two calls differ from one")
    # every replay of the first steps, held against the twin
    lat, env = bench_env(snt, *ETWIN)
    err, bad = hold_replays(rk, env, ETWIN_STEPS, True)
    fired = int((lat.state["last_firing_time"] >= 0).sum())
    say(f"[30 main path] bench loop {ETWIN[0]}x{ETWIN[1]}, each of the "
        f"{ETWIN_STEPS // K} graph replays of the first {ETWIN_STEPS} steps "
        f"held against the twin (callbacks and env entry) on the state it "
        f"received: integer and spike mismatches {bad}, max float error "
        f"{err:.3g}; fired {fired}, dopamine {lat.dopamine:.6g}")
    check(bad == 0 and err == 0.0, "a replay differs from the twin")
    max_err = max(max_err, err)
    # a grid history: tier (b), one kernel step per callback round
    runs = {}
    for hist in (True, False):
        lat, env = bench_env(snt, *ETWIN)
        lat.update_grid_history = hist
        rk.ENV_LAUNCHES = 0
        rewards = env.run_with_reward(EHIST_STEPS)
        runs[hist] = (agent_snapshot(lat, env), rewards, env, lat,
                      rk.ENV_LAUNCHES)
    snap, rewards, env, lat, calls = runs[True]
    launches += calls
    hist = np.stack(lat.grid_history.history)
    diff = sum(int((snap[k] != runs[False][0][k]).sum()) for k in snap)
    last = np.array_equal(hist[-1].reshape(-1),
                          lat.state["v"].cpu().numpy())
    say(f"[30 main path] bench loop {ETWIN[0]}x{ETWIN[1]} with a grid "
        f"history over {EHIST_STEPS} steps: fused {env.last_build_fused}, "
        f"env-fused {env.last_build_env_fused}, env-entry launches {calls}, "
        f"history {hist.shape}, last row = final v {last}; against tier (a) "
        f"without the history: {diff} values differ, rewards equal "
        f"{np.array_equal(rewards, runs[False][1])}")
    check(env.last_build_fused and not env.last_build_env_fused,
          "the history run did not take tier (b)")
    check(runs[False][2].last_build_env_fused, "no tier (a) at 64^2")
    check(calls == EHIST_STEPS + 1 and hist.shape == (EHIST_STEPS, *ETWIN)
          and last, "wrong history")
    check(diff == 0 and np.array_equal(rewards, runs[False][1]),
          "tiers (a) and (b) differ")
    # a callback that waits for the card fails the probe: tier (b)
    def syncing(e, s):
        return env_reward(e, s) if bool(e["rate"] >= 0.0) else e["rate"]

    lat, env = bench_env(snt, *ETWIN, reward=syncing)
    rewards = env.run_with_reward(EHIST_STEPS)
    snap = agent_snapshot(lat, env)
    diff = sum(int((snap[k] != runs[False][0][k]).sum()) for k in snap)
    say(f"[30 main path] bench loop {ETWIN[0]}x{ETWIN[1]} with a reward "
        f"callback that reads a value on the host: fused "
        f"{env.last_build_fused}, env-fused {env.last_build_env_fused}; "
        f"{diff} values differ from tier (a) with the bench's callback")
    check(env.last_build_fused and not env.last_build_env_fused
          and diff == 0 and np.array_equal(rewards, runs[False][1]),
          "a syncing callback did not take tier (b), or differs")
    # a random cue (the upstream example's encoder draws one): from the
    # default generator, which a CUDA graph registers, the same draws on
    # tiers (a) and (b); from a generator of the callback's own, which it
    # does not, tier (b)
    gen = torch.Generator(device="cuda")

    def cue(u, s):
        return {**s, "v": torch.where(u < 0.06, 31.0, s["v"])}

    encoders = (("default", lambda e, s: cue(torch.rand(
        s["v"].shape[0], device=s["v"].device), s)),
        ("own", lambda e, s: cue(torch.rand(
            s["v"].shape[0], device=s["v"].device, generator=gen), s)))
    for name, encoder in encoders:
        out = {}
        for graph in (True, False):
            torch.manual_seed(5)
            gen.manual_seed(7)
            lat, env = bench_env(snt, *EMAINS[0][1], encoder=encoder)
            if not graph:              # tier (b): an EEG history
                lat.grid_history = snt.history.EEGHistory()
                lat.update_grid_history = True
            rewards = env.run_with_reward(ERNG_STEPS)
            out[graph] = (agent_snapshot(lat, env), rewards,
                          env.last_build_env_fused, env.last_capture_error)
        diff = sum(int((out[True][0][k] != out[False][0][k]).sum())
                   for k in out[True][0])
        say(f"[30 main path] bench loop {EMAINS[0][1][0]}x"
            f"{EMAINS[0][1][1]}, {ERNG_STEPS} steps, a random cue from the "
            f"{name} generator: env-fused {out[True][2]} (capture error "
            f"{out[True][3]}), {diff} values differ from tier (b) (an EEG "
            f"history)")
        if name == "default":
            check(out[True][2] and diff == 0
                  and np.array_equal(out[True][1], out[False][1]),
                  "the default generator's cue differs between the tiers")
        else:
            check(not out[True][2], "a generator the graph does not know "
                  "was captured")
    return max_err, launches


def env_cmp_phase(snt):
    """31. The bench loop at 64^2 over 512 steps: tier (a) on the card
    against the kernel tier on the CPU (the twin; bit-equal expected),
    then the kernel route (tier (b), a grid history for per-step v)
    against the plain route on the card, in calls of ECMP_CHUNK steps, at
    a tenth of the reward and at the bench's own: under the tie rule over
    the steps before either route's weights pass W_TIE, and past them the
    max |dv| every 16 steps up to the first step over DRIFT."""
    runs = {}
    for key, device, uk in (("card", "cuda", None), ("cpu", "cpu", True)):
        lat, env = bench_env(snt, *ECMP, use_kernel=uk, device=device)
        rewards = env.run_with_reward(ECMP_STEPS)
        check(env.last_build_fused
              and env.last_build_env_fused is (device == "cuda"),
              f"wrong tier on the {key}")
        runs[key] = (agent_snapshot(lat, env), rewards)
    a, b = runs["card"][0], runs["cpu"][0]
    dv = max((a[k] - b[k]).abs().max().item() for k in a
             if a[k].is_floating_point())
    di = sum(int((a[k] != b[k]).sum()) for k in a
             if not a[k].is_floating_point())
    dlft = int((a["state.last_firing_time"]
                - b["state.last_firing_time"]).abs().max())
    dr = float(np.abs(runs["card"][1] - runs["cpu"][1]).max())
    say(f"[31 kernel-vs-cpu] bench loop {ECMP[0]}x{ECMP[1]} {ECMP_STEPS} "
        f"steps, tier (a) on the card vs on the CPU: max float difference "
        f"(v, w, weights, traces, dopamine, rate) {dv:.4g}, integer and "
        f"spike mismatches {di}, max|dlft| {dlft}, max reward difference "
        f"{dr:.4g}, fired {int((a['state.last_firing_time'] >= 0).sum())}")
    check(dv == 0.0 and di == 0 or (dv <= 2.0 and dlft <= 2),
          "the card parts from the CPU beyond 2 mV / 2 steps")
    n = ECMP[0] * ECMP[1]
    for label, reward in (("a tenth of the reward", env_reward_cmp),
                          ("the bench's reward", env_reward)):
        runs = {}
        for key, uk in (("kernel", None), ("plain", False)):
            lat, env = bench_env(snt, *ECMP, use_kernel=uk, reward=reward)
            lat.update_grid_history = True
            wmax, lft = [], []
            for _ in range(ECMP_STEPS // ECMP_CHUNK):
                env.run_with_reward(ECMP_CHUNK)
                wmax.append(lat.graph.weights.abs().max().item())
                lft.append(lat.state["last_firing_time"].cpu().numpy()
                           .astype(np.int64))
            check(env.last_build_fused is (uk is not False), "wrong routes")
            runs[key] = (np.stack(lat.grid_history.history).reshape(
                ECMP_STEPS, -1), np.array(wmax), lft)
        (hk, wk, lk), (hp, wp, lp) = runs["kernel"], runs["plain"]
        w = np.maximum(wk, wp)
        m = int(np.argmax(w > W_TIE)) if (w > W_TIE).any() else len(w)
        check(m > 0, f"the weights passed {W_TIE} in the first call")
        cut = m * ECMP_CHUNK
        tie_check(f"[31 kernel-vs-plain] bench loop {ECMP[0]}x{ECMP[1]} at "
                  f"{label}, steps 0-{cut - 1} of {ECMP_STEPS} (max |w| "
                  f"{w[m - 1]:.4g} <= {W_TIE}), kernel tier vs plain route "
                  f"on the card", hk[:cut], lk[m - 1], hp[:cut], lp[m - 1], n)
        if cut < ECMP_STEPS:
            dvs = np.abs(hk - hp).max(axis=1)
            over = np.nonzero(dvs[cut:] > DRIFT)[0]
            end = cut + int(over[0]) if len(over) else ECMP_STEPS - 1
            outside = int((np.abs(hk - hp) > 2.0).any(axis=0).sum())
            say(f"[31 kernel-vs-plain] bench loop {ECMP[0]}x{ECMP[1]} at "
                f"{label}, from step {cut} (max |w| {w[m]:.4g} at step "
                f"{cut + ECMP_CHUNK - 1}, {w[-1]:.4g} at the end): max |dv| "
                f"every 16 steps up to "
                + (f"the first step over DRIFT ({end})" if len(over)
                   else f"the last step ({end}; none over DRIFT)") + ": "
                + ", ".join(f"{k} {dvs[k]:.3g}"
                            for k in list(range(cut, end, 16)) + [end])
                + f"; neurons ever outside 2 mV over all {ECMP_STEPS} "
                f"steps {outside} of {n}")


def env_times_phase(snt, rk, smi):
    """32. Per size: wall (median of 3) and CUDA-event time per step of
    tier (a), tier (b) (an EEG history: one scalar readout per step) and
    the plain route, the kernel tiers' device time
    under torch.profiler and device / wall; the same of tier (a) for the
    unsupervised loop at 512^2; the host-loop `Environment`'s steps/s at
    10 x 10."""
    from spiking_neural_networks_tpu_torch.interactable import Environment
    rows = [("bench", shape, steps, (("tier (a)", None, True),
                                     ("tier (b) (EEG history)", None,
                                      False),
                                     ("plain route", False, True)))
            for shape, steps in ETIMES]
    rows.append(("unsup", EMAINS[2][1], EMAINS[2][2],
                 (("tier (a)", None, True),)))
    for loop, shape, steps, modes in rows:
        parts = []
        for label, uk, graph in modes:
            n = steps if uk is not False else min(steps, EPLAIN_STEPS)
            lat, env = (bench_env if loop == "bench" else unsup_env)(
                snt, *shape, use_kernel=uk)
            if not graph:              # tier (b): an EEG history
                lat.grid_history = snt.history.EEGHistory()
                lat.update_grid_history = True
            run = (lambda: env.run_with_reward(n)) if loop == "bench" \
                else (lambda: env.run(n))
            run()
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            kernel = uk is not False
            check(env.last_build_fused is kernel
                  and env.last_build_env_fused is (kernel and graph),
                  f"timed the wrong tier for {label}")
            wall = float(np.median(walls)) / n
            ev = event_ms(run, 1) / n
            part = (f"{label} wall {wall * 1e6:.3f} us/step, events "
                    f"{ev * 1e3:.3f}")
            if kernel:
                dev_us, top = profiled_us(run, n, n_top=6)
                part += (f", device {dev_us:.3f} ("
                         + ", ".join(f"{k} {t:.3f}" for k, t in top)
                         + f"), device / wall {dev_us / (wall * 1e6):.3f}")
            parts.append(part)
            del lat, env
        say(f"[32 times] {loop} loop {shape[0]}x{shape[1]} over "
            f"{steps} steps (plain route {min(steps, EPLAIN_STEPS)}): "
            + "; ".join(parts) + f"; card {smi}")

    class HostState:
        def __init__(self):
            self.rate = 0.0

        def update_state(self, agent):
            spiking = float(agent.state["is_spiking"].to(torch.float32)
                            .mean())
            self.rate = 0.9 * self.rate + 0.1 * spiking

    def encoder(state, agent):
        agent.apply(lambda s: env_encoder(None, s))

    def reward(state, agent):
        return float(np.clip(0.08 - state.rate, -0.05, 0.05))

    lat, _ = bench_env(snt, *EMAINS[0][1])
    host = Environment(lat, HostState(), encoder, reward)
    host.run_with_reward(16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host.run_with_reward(EHOST_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    say(f"[32 times] host-loop Environment, bench loop "
        f"{EMAINS[0][1][0]}x{EMAINS[0][1][1]}, {EHOST_STEPS} steps "
        f"(a 6a call and a host pull per step): {EHOST_STEPS / secs:.1f} "
        f"steps/s ({secs / EHOST_STEPS * 1e6:.3f} us/step), route "
        f"{lat._last_run_fused}; card {smi}")


# ---------------------------------------------------------------------------
# The model kernel (kernel 4): phases 33-36
# ---------------------------------------------------------------------------


def model_of(snt, name):
    """A fresh model of ``MODELS``' label ``name``."""
    if name == "BCMIzhikevich-chemical":
        return snt.BCMIzhikevich(chemical_normalization=True)
    return getattr(snt, name)()


def model_lattice(snt, name, rows, cols, use_kernel=None, device="cuda"):
    """The JAX package's model-kernel test lattice at a size
    (``tests/test_pallas_model.py:60-70``): gap 10, radius 2, keep 0.8,
    graph seed 7, v0 uniform in [-65, 30) from ``default_rng(1)``;
    `MODEL_OVERRIDES` give a model its firing form."""
    lat = snt.Lattice(model_of(snt, name), device=device)
    lat.populate(rows, cols, gap_conductance=10.0,
                 **MODEL_OVERRIDES.get(name, {}))
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    v0 = np.random.default_rng(1).uniform(-65.0, 30.0, rows * cols)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(v0, dtype=torch.float32,
                                                   device=lat.device)})
    lat.use_kernel = use_kernel
    return lat


def model_inputs(snt, mk, model, shape, seed, uniform):
    """The planes of one `model_steps` call on the card, made from
    ``seed``: the model's defaults, v uniform in [-80, 40), random spikes,
    refractory counts, BCM counts and windows of 5 steps; with ``uniform``
    False every float parameter plane within 20% of its default."""
    rows, cols = shape
    rng = np.random.default_rng(seed)
    fields, carry = mk.model_kernel_fields(model)
    g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(2.0),
                               keep_prob=0.8, seed=seed + 1,
                               weight_fn=lambda dr, dc, rr, cc:
                               rng.uniform(0.5, 1.5, rr.shape),
                               device="cuda")
    st = model.init_state_host(rows * cols)
    planes = {k: st[k].reshape(shape) for k, _ in fields}
    if not uniform:
        for k, dt in fields:
            if dt == torch.float32 and k not in carry and k != "v_init":
                planes[k] = (planes[k] * rng.uniform(0.8, 1.2, shape)
                             ).astype(np.float32)
    planes["v"] = rng.uniform(-80.0, 40.0, shape).astype(np.float32)
    planes["is_spiking"] = rng.random(shape) < 0.3
    if "was_increasing" in planes:
        planes["was_increasing"] = rng.random(shape) < 0.5
    if "refractory_count" in planes:
        planes["refractory_count"] = np.where(
            rng.random(shape) < 0.3, rng.integers(1, 5, shape), 0
        ).astype(np.float32)
    if "num_spikes" in planes:
        planes["num_spikes"] = rng.integers(0, 40, shape).astype(np.int32)
        planes["firing_rate_window"] = np.full(shape, 0.5, np.float32)
    lft = np.where(rng.random(shape) < 0.2, 5, -1).astype(np.int32)
    cuda = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    return dict(model=model, planes={k: cuda(p) for k, p in planes.items()},
                lft=cuda(lft), weights=g.weights, in_deg=g.in_deg,
                offsets=g.offsets)


def model_call(fn, inp, clock0, n_steps):
    return fn(inp["model"], inp["planes"], inp["lft"], inp["weights"],
              inp["in_deg"], inp["offsets"], clock0, n_steps)


def compare_model(got, want):
    """(max float error, integer / bool / spike / lft mismatches) of two
    `model_steps` results."""
    err, bad = 0.0, 0
    for k, w in want[0].items():
        g = got[0][k]
        if w.dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
            err = max(err, (g - w).abs().max().item())
        else:
            bad += int((g != w).sum())
    bad += int((got[1] != want[1]).sum()) + int((got[2] != want[2]).sum())
    return err, bad


def model_bytes(mk, inp, out):
    """Bytes a call must move: each plane the step reads
    (`model_read_fields`), lft, the weights and in_deg read once, each
    output written once."""
    reads = mk.model_read_fields(inp["model"])
    return tensor_bytes([inp["planes"][k] for k in reads], inp["lft"],
                        inp["weights"], inp["in_deg"], out)


def model_ops(name, offsets, rows, cols, k):
    """Float operations of ``k`` steps: per cell the weight sum, the input
    current (5) and the model's step (`MODEL_OPS`), per on-grid slot a
    multiply and an add."""
    return k * (rows * cols * (len(offsets) + 5 + MODEL_OPS[name])
                + 2 * ingrid_slots(offsets, rows, cols))


def model_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import model_kernels as mk
    max_err = model_twin_phase(snt, mk)
    err, launches = model_main_phase(snt, mk)
    model_cmp_phase(snt)
    times = model_times_phase(snt, mk, smi)
    out = []
    for design, shape, kernel in (
            ("persistent", MMAIN, "model_persistent_kernel<M, CPT>"),
            ("per_step", MBIG, "model_stencil_kernel<M> (per step)")):
        t = times["MorrisLecar", shape]
        out.append({
            "name": f"model_steps: {kernel}", "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/"
                      "model_stencil.cu",
            "replaces": MODEL_REPLACES, "launches": launches[design],
            "max_abs_err": max(max_err, err),
            "ms": t["kernel_ms"], "plain_ms": t["twin_ms"],
            "device_ms": t["device_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None,
            "library_call": "none: no PyTorch call computes a lattice "
                            "step"})
    return out


def model_twin_phase(snt, mk):
    """33. The model kernel vs its plain twin on the card: every model of
    the table x `MSHAPES` (130 x 100 with non-uniform parameter planes) x
    K = 16 and 7, and Morris-Lecar at `MBIG` for one 16-step call.
    Returns the max float error."""
    import itertools
    import re
    from spiking_neural_networks_tpu_torch import _build
    # ptxas's report of each instantiation (when this process built them)
    log = _build.build_log.split("== model_stencil.cu")[-1].split("\n== ")[0]
    kernels = re.findall(r"model_stencil_kernelI(\w+?)Ev.*?\n\s*(\d+) bytes "
                         r"stack frame, (\d+) bytes spill stores.*?Used (\d+) "
                         r"registers", log, re.S)
    if _build.build_log:
        say("[33 build] model_stencil_kernel<M>: " + ", ".join(
            f"{m.lstrip('0123456789')} {r} registers, stack {st} B, spills "
            f"{sp} B" for m, st, sp, r in kernels))
        check(len(kernels) == len(MODELS) and all(sp == "0" for _, _, sp, _
                                                  in kernels),
              "a model kernel is missing from ptxas's report or spills")
        # the stencil kernel's kind (I3Izh) is listed in phase 3
        found = [(e, rep) for e, rep in
                 instantiation_lines("model_persistent_kernel")
                 if "I3Izh" not in e]
        say("[33 build] model_persistent_kernel<M, cells a thread>: "
            + "; ".join(f"{e[28:].split('EEv')[0]} {rep}"
                        for e, rep in found))
        check(len(found) == 3 * len(MODELS) - 2,
              "a persistent instantiation is missing from ptxas's report")
    sms = mk.sm_count(torch.device("cuda"))
    for name in MODELS:
        model = model_of(snt, name)
        plan = mk.persistent_plan(model, MMAIN, 12, sms)
        say(f"[33 plan] {name} {MMAIN[0]}x{MMAIN[1]}, radius 2, {sms} SMs: "
            + ("no plan: the per-step design" if plan is None else
               f"{plan.blocks} blocks of {plan.cap} cells "
               f"({-(-plan.cap // mk.THREADS)} a thread), "
               f"{plan.smem} B of shared memory a block: the 12 weight "
               f"planes, wsum, max(in_deg, 1) and "
               f"{len(plan.resident)} parameter planes "
               f"{list(plan.resident)}; streamed {list(plan.streamed)}"))
    max_err = 0.0
    cases = list(itertools.product(MSHAPES, (16, 7)))
    for m, name in enumerate(MODELS):
        err, bad, fired = 0.0, 0, 0
        for c, (shape, k) in enumerate(cases + ([(MBIG, 16)]
                                                if name == "MorrisLecar"
                                                else [])):
            inp = model_inputs(snt, mk, model_of(snt, name), shape,
                               m * 10 + c, shape != (130, 100))
            want = model_call(mk.model_steps_reference, inp, 100, k)
            torch.cuda.synchronize()
            for per_step in (False, True):
                got = mk.model_steps(inp["model"], inp["planes"], inp["lft"],
                                     inp["weights"], inp["in_deg"],
                                     inp["offsets"], 100, k, per_step)
                torch.cuda.synchronize()
                e, b = compare_model(got, want)
                check(all(bool(torch.isfinite(x).all())
                          for x in got[0].values() if x.is_floating_point()),
                      f"{name}: non-finite output")
                err, bad = max(err, e), bad + b
            fired += int((got[1] >= 100).sum())
            del inp, got, want
        n = len(cases) + (name == "MorrisLecar")
        say(f"[33 kernel-vs-twin] {name}: {n} calls ("
            + ", ".join(f"{r}x{c}" for r, c in MSHAPES)
            + (f", {MBIG[0]}x{MBIG[1]}" if name == "MorrisLecar" else "")
            + f"; K 16 and 7; 130x100 with non-uniform parameters), each in "
            f"the routed design and the per-step one: integer, bool, spike "
            f"and lft mismatches {bad}, max float error {err:.3g}, neurons "
            f"fired in the calls {fired}")
        check(bad == 0, f"{name}: integers, bools, spikes or lft differ")
        check(fired > 0, f"{name}: no neuron fired in its calls")
        max_err = max(max_err, err)
    say(f"[33 kernel-vs-twin] max float error over {len(MODELS)} models "
        f"{max_err:.3g} (tolerance rtol {RTOL}, atol {ATOL}; 0 = "
        f"bit-equal)")
    return max_err


def model_main_phase(snt, mk):
    """34. The main paths through `run_lattice`: Morris-Lecar at `MMAIN`
    for `MMAIN_STEPS` steps, every other model of the table (the
    integrate-and-fire family and `DopaIzhikevich`) at `MMAIN` for
    `MIF_STEPS`; the first `MHELD` calls of each held against the twin on
    the state that call received, then the rest in one call (route, kernel
    calls, finite state, neurons fired); then ``examples/bcm.py``'s
    network over `BCM_STEPS` steps on its plain route, card vs CPU.
    Returns (max float error, kernel calls)."""
    K = mk.STEPS_PER_LAUNCH
    max_err, launches = 0.0, {"persistent": 0, "per_step": 0}
    runs = [("MorrisLecar", MMAIN_STEPS, MMAIN)] + [
        (n, MIF_STEPS, MMAIN) for n in MODELS
        if n not in ("MorrisLecar", "BCMIzhikevich-chemical")] + [
        ("MorrisLecar", MBIG_STEPS, MBIG)]
    sms = mk.sm_count(torch.device("cuda"))
    for name, steps, size in runs:
        lat = model_lattice(snt, name, *size)
        shape = (lat.rows, lat.cols)
        fields, _ = mk.model_kernel_fields(lat.model)
        g = lat.graph
        err, bad = 0.0, 0
        persistent = mk.uses_persistent(lat.model, shape, len(g.offsets),
                                        sms)
        mk.LAUNCHES = mk.STEP_LAUNCHES = 0
        for _ in range(MHELD):
            st = lat.state
            want = mk.model_steps_reference(
                lat.model, {k: st[k].reshape(shape) for k, _ in fields},
                st["last_firing_time"].reshape(shape), g.weights, g.in_deg,
                g.offsets, lat.internal_clock, K)
            lat.run_lattice(K)
            torch.cuda.synchronize()
            got = ({k: lat.state[k].reshape(shape) for k in want[0]},
                   lat.state["last_firing_time"].reshape(shape),
                   lat.state["is_spiking"].reshape(shape))
            e, b = compare_model(got, want)
            err, bad = max(err, e), bad + b
        lat.run_lattice(steps - MHELD * K)
        torch.cuda.synchronize()
        calls, kernel_launches = mk.LAUNCHES, mk.STEP_LAUNCHES
        launches["persistent" if persistent else "per_step"] += \
            kernel_launches
        finite = all(bool(torch.isfinite(x).all())
                     for x in lat.state.values() if x.is_floating_point())
        lft = lat.state["last_firing_time"]
        fired = int((lft >= 0).sum())
        late = int((lft >= steps // 2).sum())
        v = lat.state["v"]
        form = MODEL_OVERRIDES.get(name)
        say(f"[34 main path] {name} {shape[0]}x{shape[1]} run_lattice("
            f"{steps}){f' {form}' if form else ''}: route "
            f"{lat._last_run_fused}, "
            f"{'persistent' if persistent else 'per-step'} design, kernel "
            f"calls {calls}, kernel launches {kernel_launches} (counted by "
            f"the C entry), "
            f"the first {MHELD} held against the twin: mismatches {bad}, max "
            f"float error {err:.3g}; state finite {finite}, v range "
            f"[{v.min().item():.3f}, {v.max().item():.3f}], fired {fired} of "
            f"{lat.n}, fired in the second half {late}, last firing step "
            f"{int(lft.max())}")
        check(lat._last_run_fused == "model", f"{name}: the main path took "
              f"{lat._last_run_fused}")
        check(calls == -(-steps // K), f"{name}: wrong number of kernel calls")
        check(kernel_launches == calls * mk.call_launches(K, persistent),
              f"{name}: the C entry counted other launches than the design "
              f"has")
        check(bad == 0, f"{name}: the main path differs from the twin")
        check(finite and fired > 0, f"{name}: bad main-path state")
        check(late > 0, f"{name}: no neuron fired in the second half")
        max_err = max(max_err, err)
        del lat
    # examples/bcm.py's network: the BCM rule has no kernel in either
    # package; its plain route (the flat COO runner) on the card and on
    # the CPU
    hist = {}
    for device in ("cuda", "cpu"):
        net = bcm_net(snt, device)
        net.run_lattices(BCM_STEPS)
        post = net.lattices[1].state
        hist[device] = (np.asarray(net.connecting_graph_history),
                        int(post["num_spikes"][0]),
                        int((net.spike_train_lattices[0].state["num_spikes"]
                             ).sum()), net._last_run_fused)
    hc, hcpu = hist["cuda"], hist["cpu"]
    w = hc[0].reshape(len(hc[0]), -1)
    dw = float((np.abs(w - hcpu[0].reshape(w.shape))
                / np.maximum(np.abs(w), 1.0)).max())
    # the steps whose change exceeds two visits' decay: the activity term
    # of the rule acted there
    decay = 2 * 0.1 * 0.1 * np.abs(w[:-1]) * (1 + 1e-3) + 1e-6
    full = np.nonzero((np.abs(np.diff(w, axis=0)) > decay).any(axis=1))[0]
    say(f"[34 main path] examples/bcm.py network (activity windows of 5 "
        f"steps), {BCM_STEPS} steps, plain route (flat COO runner, BCM): "
        f"route {hc[3]}, weight history {hc[0].shape}, weights "
        f"{[f'{x:.6g}' for x in w[0]]} -> {[f'{x:.6g}' for x in w[-1]]}, "
        f"steps where the activity term acted {len(full)} (first "
        f"{full[0] + 1 if len(full) else None}), card vs CPU max|dw|/"
        f"max(|w|, 1) {dw:.3g}, post spikes {hc[1]} vs {hcpu[1]}, train "
        f"spikes {hc[2]}")
    check(hc[3] is False and np.isfinite(hc[0]).all(), "bad BCM run")
    check(dw <= 1e-5 and hc[1] == hcpu[1] and hc[2] == hcpu[2],
          "the BCM network differs between the card and the CPU")
    check(len(full) > 0 and hc[1] > 0,
          "the BCM rule's activity term never acted")
    return max_err, launches


def bcm_net(snt, device):
    """``examples/bcm.py``'s network in the port: two BCM Poisson trains
    into one `BCMIzhikevich` neuron (c_m 50, gap 5) with BCM plasticity and
    Gaussian weights (mean 1.5, std 0.1, clipped to [1, 2]), the
    connecting-graph history on; the trains' chances at 1 and 0 (certain
    draws, so that the card and the CPU agree), and every activity window
    5 steps (0.5, as ``tests/test_torch_bcm.py`` sets it), so that the
    windows close and the whole rule runs."""
    rng = np.random.default_rng(0)
    st = snt.SpikeTrainLattice(snt.BCMPoissonSpikeTrain(), id=0,
                               device=device)
    st.populate(2, 1)
    st.apply(lambda s: {**s, "chance_of_firing": torch.tensor(
        [1.0, 0.0], device=st.device), "firing_rate_window": torch.full(
            (2,), 0.5, device=st.device)})
    post = snt.Lattice(snt.BCMIzhikevich(), id=1, device=device)
    post.populate(1, 1, c_m=50.0, gap_conductance=5.0,
                  firing_rate_window=0.5)
    post.plasticity = snt.BCM()
    post.do_plasticity = True
    net = snt.LatticeNetwork.generate_network([post], [st], device=device)
    w0 = np.clip(rng.normal(1.5, 0.1, (2, 1)), 1.0, 2.0)
    net.connect(0, 1, lambda x, y: True, lambda x, y: float(w0[x[0], 0]))
    net.update_connecting_graph_history = True
    return net


def model_tie_check(snt, label, name, hk, lk, hp, lp, n):
    """The tie rule between the kernel and the plain route: Morris-Lecar's
    peak detection has no reset, so the routes may part where a peak falls
    on another step, within DRIFT until then; a model with a reset parts
    at a threshold tie (`tie_check`)."""
    if name != "MorrisLecar":
        fields = model_of(snt, name).FIELDS
        reset = fields["c"] if "c" in fields else fields["v_reset"]
        tie_check(label, hk, lk, hp, lp, n, reset, fields["v_th"])
        return
    d = np.abs(hk - hp)
    dvs = d.max(axis=1)
    tie = np.nonzero((lk != lp).any(axis=1))[0]
    s0 = int(tie[0]) if len(tie) else len(dvs)
    pre = float(dvs[:s0].max()) if s0 else 0.0
    outside = int((d > 2.0).any(axis=0).sum())
    fk, fp = int((lk[-1] >= 0).sum()), int((lp[-1] >= 0).sum())
    say(f"{label}: max|dv| {dvs.max():.4g} mV, before the first "
        f"firing-time difference (step {s0 if len(tie) else 'none'}) "
        f"{pre:.4g} mV, max|dlft| {int(np.abs(lk - lp).max())} steps, "
        f"neurons ever outside 2 mV {outside} of {n}, fired {fk} vs {fp}")
    check(pre <= DRIFT, "the routes parted before a peak on another step")
    check(outside <= n // 100 and abs(fk - fp) <= n // 100,
          "the routes' divergence spread beyond 1% of the lattice")


def model_cmp_phase(snt):
    """35. `MCMP` for `MCMP_STEPS` steps, v and firing times read every
    step, for `MCMP_MODELS`: the kernel route on the card against the same
    route on the CPU (2 mV, 2 steps; bit-equal expected), and against the
    plain route on the card, which gathers in another association and
    takes torch's exp / tanh / cosh (the tie rule)."""
    for name in MCMP_MODELS:
        runs = {}
        for key, device, uk in (("kernel", "cuda", None),
                                ("cpu", "cpu", True),
                                ("plain", "cuda", False)):
            lat = model_lattice(snt, name, *MCMP, use_kernel=uk,
                                device=device)
            vs, lfts = [], []
            for _ in range(MCMP_STEPS):
                lat.run_lattice(1)
                vs.append(lat.state["v"])
                lfts.append(lat.state["last_firing_time"])
            runs[key] = (torch.stack(vs).cpu().numpy(),
                         torch.stack(lfts).cpu().numpy().astype(np.int64),
                         lat._last_run_fused)
        check(runs["kernel"][2] == runs["cpu"][2] == "model"
              and runs["plain"][2] is False, f"{name}: wrong routes")
        hk, lk, _ = runs["kernel"]
        hc, lc, _ = runs["cpu"]
        dv, dl = float(np.abs(hk - hc).max()), int(np.abs(lk - lc).max())
        say(f"[35 kernel-vs-cpu] {name} {MCMP[0]}x{MCMP[1]} {MCMP_STEPS} "
            f"steps, kernel route on the card vs on the CPU: max|dv| "
            f"{dv:.4g} mV, max|dlft| {dl} steps, fired "
            f"{int((lk[-1] >= 0).sum())}")
        check(dv <= 2.0 and dl <= 2, f"{name}: card vs CPU outside 2 mV / "
              f"2 steps")
        hp, lp, _ = runs["plain"]
        model_tie_check(snt, f"[35 kernel-vs-plain] {name} {MCMP[0]}x"
                        f"{MCMP[1]} {MCMP_STEPS} steps, kernel vs plain "
                        f"route on the card", name, hk, lk, hp, lp,
                        MCMP[0] * MCMP[1])


def model_times_phase(snt, mk, smi):
    """36. For `MTIME_MODELS` at `MTIMES`: wall time per step of the
    kernel route (median of 5 after a warm-up) and of the plain route
    (median of 3); the routed design's calls on one `ModelRun` (the
    runner's lean path): CUDA-event time, device time under torch.profiler
    over `EPROF` calls with every kernel record counted, device / wall,
    the bound and the twin's time; where the persistent design is routed,
    both designs in turns (`designs_in_turns`), else the per-step design
    alone (the plan cannot hold the weights).  Returns them by (model,
    shape), per 16-step call."""
    K = mk.STEPS_PER_LAUNCH
    sms = mk.sm_count(torch.device("cuda"))
    out = {}
    for name in MTIME_MODELS:
        for shape, steps, plain_steps in MTIMES:
            kern = model_lattice(snt, name, *shape)
            plain = model_lattice(snt, name, *shape, use_kernel=False)
            run_synced(kern, steps)
            run_synced(plain, plain_steps)
            tk, tp = [], []
            for rep in range(5):
                tk.append(run_synced(kern, steps))
                if rep < 3:
                    tp.append(run_synced(plain, plain_steps))
            check(kern._last_run_fused == "model"
                  and plain._last_run_fused is False,
                  "timed the wrong model routes")
            fields, _ = mk.model_kernel_fields(kern.model)
            g, st = kern.graph, kern.state
            inp = dict(model=kern.model, planes={
                k: st[k].reshape(shape) for k, _ in fields},
                lft=st["last_firing_time"].reshape(shape), weights=g.weights,
                in_deg=g.in_deg, offsets=g.offsets)
            persistent = mk.uses_persistent(kern.model, shape,
                                            len(g.offsets), sms)
            runs = {d: mk.ModelRun(kern.model, inp["planes"], inp["lft"],
                                   g.weights, g.in_deg, g.offsets,
                                   per_step=d == "per_step")
                    for d in (("persistent", "per_step") if persistent
                              else ("per_step",))}
            routed = "persistent" if persistent else "per_step"
            kernel = lambda: runs[routed].steps(0, K)
            n_bytes = model_bytes(mk, inp, kernel())
            bnd = bound(n_bytes, model_ops(name, g.offsets, *shape, K))
            kernel_ms = event_ms(kernel, 20)
            twin_ms = event_ms(lambda: model_call(
                mk.model_steps_reference, inp, 0, K), 3)
            n_launch = mk.call_launches(K, persistent)
            dev_us, top = profiled_us(lambda: [kernel()
                                               for _ in range(EPROF)],
                                      EPROF * K, launches=EPROF * n_launch)
            # each step moves what the call must move (nothing stays on
            # chip between steps)
            dev_rate = n_bytes / (dev_us * 1e-6)
            check(n_bytes <= L2_BYTES or persistent
                  or dev_rate <= PEAK_BYTES,
                  f"{name} {shape}: the profiled device time moves "
                  f"{dev_rate:.4g} B/s, more than HBM's peak")
            mkw, mpw = float(np.median(tk)), float(np.median(tp))
            wall_us = mkw / steps * 1e6
            out[name, shape] = dict(kernel_ms=kernel_ms, twin_ms=twin_ms,
                                    device_ms=dev_us * K / 1e3, bound=bnd)
            say(f"[36 times] {name} {shape[0]}x{shape[1]}: kernel route "
                f"(use_kernel=None, the {routed} design) "
                f"{rate(shape, mkw, steps)}, median of 5 x {steps} steps; "
                f"device time {dev_us:.3f} us/step (profiled, {EPROF} calls, "
                f"{EPROF * n_launch} kernel records: "
                + ", ".join(f"{k} {t:.3f}" for k, t in top)
                + f"), {dev_rate / 1e12:.3f} TB/s at {n_bytes / 1e6:.2f} MB a "
                f"call; device time / wall {dev_us / wall_us:.3f}; kernel "
                f"calls back to back {kernel_ms * 1e3 / K:.3f} us/step "
                f"(events); bound {bnd[0] * 1e3 / K:.4f} us/step ({bnd[1]}); "
                f"plain twin {twin_ms * 1e3 / K:.3f} us/step (events); plain "
                f"route (use_kernel=False) {rate(shape, mpw, plain_steps)}, "
                f"median of 3 x {plain_steps} steps; library call: none; "
                f"card {smi}")
            if persistent:
                turns = designs_in_turns(
                    {d: (lambda d=d: runs[d].steps(0, K)) for d in runs},
                    {d: mk.call_launches(K, d == "persistent")
                     for d in runs}, K)
                say(f"[36 times] {name} {shape[0]}x{shape[1]}, the designs "
                    f"in turns on one ModelRun each: {design_line(turns)}; "
                    f"card {smi}")
            else:
                say(f"[36 times] {name} {shape[0]}x{shape[1]}: the "
                    f"persistent design does not apply (its plan cannot hold "
                    f"a block's weights); the per-step design alone")
            del kern, plain, inp, runs
    return out


# ---------------------------------------------------------------------------
# Kernel 4's DSL arm: phases 37-41
# ---------------------------------------------------------------------------


def dsl_model(snt, name):
    """A fresh port model of `DSL_BUILD`'s neuron ``name``, through the
    user's entry point."""
    return snt.dsl.neuron_builder(DSL_BUILD[name])[name]()


def dsl_lattice(snt, name, rows, cols, use_kernel=None, device="cuda",
                seed=1):
    """The main path's lattice: `Lattice` -> `populate` (gap 10; the DSL
    HH in `DSL_HH_FORM`) -> `connect_stencil` (radius 2, keep
    0.8, graph seed 7) -> `apply` (v0 uniform in [-65, 30) from
    ``default_rng(seed)``)."""
    lat = snt.Lattice(dsl_model(snt, name), device=device)
    lat.populate(rows, cols, gap_conductance=10.0,
                 **(DSL_HH_FORM if name == "DSLHodgkinHuxley" else {}))
    lat.connect_stencil(radius=2.0, keep_prob=0.8, seed=7)
    v0 = np.random.default_rng(seed).uniform(-65.0, 30.0, rows * cols)
    lat.apply(lambda s: {**s, "v": torch.as_tensor(v0, dtype=torch.float32,
                                                   device=lat.device)})
    lat.use_kernel = use_kernel
    return lat


def dsl_inputs(snt, mk, model, name, shape, radius, seed):
    """The planes of one chain of calls on the card, made from ``seed``: v
    uniform in [-65, 30), the parameters of `DSL_RANDOM_PARAMS` within 20%
    of their defaults, HH in `DSL_HH_FORM`, random spikes,
    was_increasing and firing times, weights uniform in [0.5, 1.5)."""
    rows, cols = shape
    rng = np.random.default_rng(seed)
    fields, _ = mk.model_kernel_fields(model)
    g = snt.StencilGraph.build(rows, cols, snt.radius_offsets(radius),
                               keep_prob=0.8, seed=seed + 1,
                               weight_fn=lambda dr, dc, rr, cc:
                               rng.uniform(0.5, 1.5, rr.shape),
                               device="cuda")
    st = model.init_state_host(
        rows * cols, **(DSL_HH_FORM if name == "DSLHodgkinHuxley" else {}))
    planes = {k: st[k].reshape(shape) for k, _ in fields}
    for k in DSL_RANDOM_PARAMS[name]:
        planes[k] = (planes[k] * rng.uniform(0.8, 1.2, shape)
                     ).astype(np.float32)
    planes["v"] = rng.uniform(-65.0, 30.0, shape).astype(np.float32)
    planes["is_spiking"] = rng.random(shape) < 0.3
    if "was_increasing" in planes:
        planes["was_increasing"] = rng.random(shape) < 0.5
    lft = np.where(rng.random(shape) < 0.2, 5, -1).astype(np.int32)
    cuda = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    return dict(model=model, planes={k: cuda(p) for k, p in planes.items()},
                lft=cuda(lft), weights=g.weights, in_deg=g.in_deg,
                offsets=g.offsets)


def bit_diff(got, want):
    """(float elements whose bits differ, other mismatches, max float
    error) of two `model_steps` results; a NaN on both sides counts as
    equal."""
    fl, other, err = 0, 0, 0.0
    for k, w in want[0].items():
        g = got[0][k]
        if w.dtype == torch.float32:
            both_nan = torch.isnan(g) & torch.isnan(w)
            fl += int(((g.view(torch.int32) != w.view(torch.int32))
                       & ~both_nan).sum())
            d = torch.where(both_nan, 0.0, (g - w).abs())
            err = max(err, float(torch.nan_to_num(d, nan=np.inf).max()))
        else:
            other += int((g != w).sum())
    other += int((got[1] != want[1]).sum()) + int((got[2] != want[2]).sum())
    return fl, other, err


def dsl_ops(dk, model, offsets, rows, cols, k):
    """Float operations of ``k`` steps: per cell the weight sum, the input
    current (5) and the emitted step's operations (`DSL_CALL_OPS` for its
    functions), per on-grid slot a multiply and an add."""
    ops = sum(n * DSL_CALL_OPS.get(op, 1)
              for op, n in dk.layout(model).ops.items())
    return k * (rows * cols * (len(offsets) + 5 + ops)
                + 2 * ingrid_slots(offsets, rows, cols))


def dsl_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import (dsl_kernels as dk,
                                                       model_kernels as mk)
    dsl_build_phase(snt, dk, mk)
    twin_err, twin_calls = dsl_twin_phase(snt, mk)
    launches, finite_steps = dsl_main_phase(snt, mk)
    dsl_cmp_phase(snt)
    times = dsl_times_phase(snt, dk, mk, smi, finite_steps)
    out = []
    for design, name, shape in (("persistent", "DSLIzhikevich", DMAIN),
                                ("per_step", "DSLIzhikevich", DBIG)):
        t = times[name, shape]
        kernel = ("model_persistent_kernel<Dsl, CPT>" if design ==
                  "persistent" else "model_stencil_kernel<Dsl> (per step)")
        out.append({
            "name": f"model_steps, DSL arm: {kernel}", "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/_build/dsl/"
                      + os.path.basename(t["library"])[:-3] + ".cu "
                      "(generated by ops/dsl_kernels.py, over "
                      "csrc/model_stencil.cuh)",
            "replaces": MODEL_REPLACES, "launches": launches[design],
            "max_abs_err": twin_err, "ms": t["kernel_ms"],
            "plain_ms": t["twin_ms"], "device_ms": t["device_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None,
            "library_call": "none: no PyTorch call computes a lattice "
                            "step"})
    return out


def dsl_build_phase(snt, dk, mk):
    """37. The generated sources of `DSL_BUILD` (the three DSL models and
    phase 42's trig neuron) in one round of nvcc runs started together:
    the seconds, each library, and every instantiation's registers and
    spills (none expected)."""
    from spiking_neural_networks_tpu_torch import _build
    models = {n: dsl_model(snt, n) for n in DSL_BUILD}
    t0 = time.perf_counter()
    paths = dk.build(list(models.values()))
    wall = time.perf_counter() - t0
    say(f"[37 build] {len(paths)} generated sources, nvcc started together: "
        f"{wall:.2f} s ({'built' if _build.generated_seconds else 'cached'})"
        f"; " + ", ".join(f"{n} -> {os.path.basename(p)}"
                          for n, p in zip(models, paths)))
    for (name, model), path in zip(models.items(), paths):
        log = _build.generated_logs.get(os.path.basename(path), "")
        lines = log.splitlines()
        found = []
        for k, ln in enumerate(lines):
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln.strip()
                rep = [x.strip().replace("ptxas info    : ", "")
                       for x in lines[k + 1:k + 4]
                       if "spill" in x or "registers" in x]
                found.append((entry, "; ".join(rep)))
        lay = dk.layout(model)
        reg = sum(1 for c in lay.codes
                  if c & dk.READ and c & dk.CARRIED)
        say(f"[37 build] {name}: {len(lay.fields)} fields ({reg} in "
            f"registers, max {mk.max_cpt(model)} cells a thread), carried "
            f"{list(lay.carry)}; " + "; ".join(
                f"{e.split('EE')[0][-40:]}: {r}" for e, r in found))
        if log:
            cpts = 3 if mk.max_cpt(model) == 4 else 2
            check(len(found) == 1 + cpts,
                  f"{name}: {len(found)} instantiations in ptxas's report")
            check(all("0 bytes spill stores, 0 bytes spill loads" in r
                      for _, r in found), f"{name}: an instantiation spills")


def dsl_twin_phase(snt, mk):
    """38. For each model, each design: `DSL_SHAPES` x `DSL_RADII` and the
    main path's `DMAIN` at radius 2 (the persistent design's
    instantiation the main path takes), a chain of calls of `DSL_KS` steps
    on one ModelRun from a random state, held against the twin on the
    card call by call: floats bit-equal, ints, bools and lft equal, the C
    entry's launches `call_launches`.  Returns (max float error, calls)."""
    calls, max_err = 0, 0.0
    cases = [(sh, r) for sh in DSL_SHAPES for r in DSL_RADII] + [(DMAIN, 2.0)]
    for m, name in enumerate(DSL_SOURCES):
        bad_f, bad_o, fired, n_calls, main_cpt = 0, 0, 0, 0, None
        nonfinite = 0
        for c, (shape, radius) in enumerate(cases):
            inp = dsl_inputs(snt, mk, dsl_model(snt, name), name, shape,
                             radius, 100 * m + c)
            wants, tp, tl, clock = [], dict(inp["planes"]), inp["lft"], 10
            for k in DSL_KS:
                want = mk.model_steps_reference(
                    inp["model"], tp, tl, inp["weights"], inp["in_deg"],
                    inp["offsets"], clock, k)
                wants.append((clock, k, want))
                tp = dict(tp, **want[0])
                tl, clock = want[1], clock + k
                fired += int((want[1] >= clock - k).sum())
            nonfinite += int((~torch.isfinite(tp["v"])).sum())
            for per_step in (False, True):
                run = mk.ModelRun(inp["model"], inp["planes"], inp["lft"],
                                  inp["weights"], inp["in_deg"],
                                  inp["offsets"], per_step=per_step)
                if shape == DMAIN and not per_step:
                    check(run.plan is not None, f"{name}: the main path's "
                          f"shape is not on the persistent design")
                    main_cpt = -(-run.plan.cap // mk.THREADS)
                for clock, k, want in wants:
                    before = mk.STEP_LAUNCHES
                    got = run.steps(clock, k)
                    torch.cuda.synchronize()
                    check(mk.STEP_LAUNCHES - before == mk.call_launches(
                        k, run.plan is not None),
                          f"{name}: the C entry counted other launches")
                    f, o, e = bit_diff(got, want)
                    bad_f, bad_o, n_calls = bad_f + f, bad_o + o, n_calls + 1
                    max_err = max(max_err, e)
            del inp, wants
        calls += n_calls
        say(f"[38 kernel-vs-twin] {name}: {n_calls} calls (("
            + ", ".join(f"{r}x{c}" for r, c in DSL_SHAPES)
            + f" x radius {', '.join(f'{r:g}' for r in DSL_RADII)}) and "
            f"{DMAIN[0]}x{DMAIN[1]} radius 2 (persistent: {main_cpt} cells a "
            f"thread, as the main path) x K "
            f"{', '.join(map(str, DSL_KS))} chained on one ModelRun, each "
            f"design): float elements not bit-equal {bad_f}, integer / bool "
            f"/ spike / lft mismatches {bad_o}, neurons fired in the calls "
            f"{fired}, non-finite v at the chains' ends {nonfinite}")
        check(bad_f == 0 and bad_o == 0, f"{name}: the kernel differs from "
              f"its twin")
        check(fired > 0, f"{name}: no neuron fired in its calls")
    return max_err, calls


def twin_until_nonfinite(mk, model, planes, lft, g, steps):
    """The twin run of ``steps`` steps from ``planes`` / ``lft`` on the
    card in calls of `STEPS_PER_LAUNCH`: ``(final, n1, at_n1)``, ``final``
    its ``(carried, lft, spikes)`` after the last call, ``n1`` the steps
    after which v was last finite at a call's end (``steps`` where it
    stays finite), ``at_n1`` the state then (None where ``n1`` is 0)."""
    K = mk.STEPS_PER_LAUNCH
    tp, tl, clock = dict(planes), lft, 0
    n1, at_n1, out = 0, None, None
    while clock < steps:
        n = min(K, steps - clock)
        out = mk.model_steps_reference(model, tp, tl, g.weights, g.in_deg,
                                       g.offsets, clock, n)
        tp, tl = dict(tp, **out[0]), out[1]
        clock += n
        if n1 == clock - n and bool(torch.isfinite(out[0]["v"]).all()):
            n1, at_n1 = clock, out
    return out, n1, at_n1


def dsl_main_phase(snt, mk):
    """39. The main paths through the user's entry points: each model at
    `DMAIN` for `DMAIN_STEPS` (the persistent design, one launch a 16-step
    call, counted by the C entry and in the profiler's records), the DSL
    Izhikevich at `DBIG` for `DBIG_STEPS` (the per-step design).  The twin
    runs first from the same start, call by call, and gives ``n1``, the
    steps after which its v was last finite at a call's end.  The DSL HH
    source's m and n rates are 0 / 0 at v = -40 and -55 mV exactly (the
    JAX package's too): at 512^2 a cell lands there within the run and its
    NaN spreads through the gap junctions.  So where ``n1`` falls short of
    the run, the main path runs as ``run_lattice(n1)`` then
    ``run_lattice(steps - n1)`` (the same 16-step calls), and the state
    after ``n1`` steps is held bit for bit against the twin's with v
    finite and neurons fired; the final state is held bit for bit too (a
    NaN on both sides counts as equal).  Returns the kernel launches per
    design and ``n1`` per run."""
    K = mk.STEPS_PER_LAUNCH
    sms = mk.sm_count(torch.device("cuda"))
    launches = {"persistent": 0, "per_step": 0}
    finite_steps = {}
    runs = [(n, DMAIN, s) for n, s in DMAIN_STEPS.items()] \
        + [("DSLIzhikevich", DBIG, DBIG_STEPS)]
    for name, size, steps in runs:
        lat = dsl_lattice(snt, name, *size)
        shape = (lat.rows, lat.cols)
        fields, _ = mk.model_kernel_fields(lat.model)
        st, g = lat.state, lat.graph
        planes = {k: st[k].reshape(shape).clone() for k, _ in fields}
        lft0 = st["last_firing_time"].reshape(shape).clone()
        want, n1, want1 = twin_until_nonfinite(mk, lat.model, planes, lft0,
                                               g, steps)
        finite_steps[name, size] = n1
        check(n1 > 0, f"{name}: the twin's v is not finite after its first "
              f"call")
        plan = mk.persistent_plan(lat.model, shape, len(g.offsets), sms)
        persistent = mk.uses_persistent(lat.model, shape, len(g.offsets),
                                        sms)
        state = lambda: ({k: lat.state[k].reshape(shape) for k in want[0]},
                         lat.state["last_firing_time"].reshape(shape),
                         lat.state["is_spiking"].reshape(shape))
        mk.LAUNCHES = mk.STEP_LAUNCHES = 0
        t0 = time.perf_counter()
        lat.run_lattice(n1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got1 = state()
        bad1_f, bad1_o, _ = bit_diff(got1, want1)
        v1, lft1 = got1[0]["v"], got1[1]
        finite1 = bool(torch.isfinite(v1).all())
        fired1, late1 = int((lft1 >= 0).sum()), int((lft1 >= n1 // 2).sum())
        if n1 < steps:
            t0 = time.perf_counter()
            lat.run_lattice(steps - n1)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        calls, kernel_launches = mk.LAUNCHES, mk.STEP_LAUNCHES
        launches["persistent" if persistent else "per_step"] += \
            kernel_launches
        bad_f, bad_o, _ = bit_diff(state(), want)
        v, lft = lat.state["v"], lat.state["last_firing_time"]
        nonfinite = int((~torch.isfinite(v)).sum())
        fired, late = int((lft >= 0).sum()), int((lft >= steps // 2).sum())
        recs = kernel_records(lambda: lat.run_lattice(4 * K), 4 * (
            1 if persistent else K), mine=("model_",))
        cpt = -(-plan.cap // mk.THREADS) if persistent else None
        split = (f" as run_lattice({n1}) + run_lattice({steps - n1})"
                 if n1 < steps else "")
        design = (f"persistent design ({cpt} cells a thread)" if persistent
                  else "per-step design")
        say(f"[39 main path] {name} {shape[0]}x{shape[1]} run_lattice("
            f"{steps}){split}: route {lat._last_run_fused}, {design}, "
            f"kernel calls {calls}, kernel launches {kernel_launches} "
            f"(counted by the C entry; {kernel_launches / calls:.2f} a "
            f"call), profiler records of 4 more calls {records_line(recs)}; "
            f"the twin's v finite at a call's end through step {n1} of "
            f"{steps}; the state after step {n1} against the twin's: float "
            f"elements not bit-equal {bad1_f}, other mismatches {bad1_o}, v "
            f"finite {finite1}, range [{v1.min().item():.3f}, "
            f"{v1.max().item():.3f}], fired {fired1} of {lat.n}, from step "
            f"{n1 // 2} {late1}; the final state against the twin's: float "
            f"elements not bit-equal {bad_f}, other mismatches {bad_o}, "
            f"non-finite v {nonfinite} (the twin's "
            f"{int((~torch.isfinite(want[0]['v'])).sum())}), fired {fired}, "
            f"from step {steps // 2} {late}; wall {wall:.3f} s")
        check(lat._last_run_fused == "model", f"{name}: the main path took "
              f"{lat._last_run_fused}")
        check(calls == -(-steps // K), f"{name}: wrong number of kernel calls")
        check(kernel_launches == calls * mk.call_launches(K, persistent),
              f"{name}: the C entry counted other launches than the design "
              f"has")
        check(sum(recs.values()) == 4 * mk.call_launches(K, persistent),
              f"{name}: the profiler's records differ from the launches")
        check(bad1_f == 0 and bad1_o == 0 and bad_f == 0 and bad_o == 0,
              f"{name}: the main path differs from the twin")
        check(finite1 and fired1 > 0, f"{name}: v not finite or no neuron "
              f"fired in the finite part of the main path")
        del lat, want, want1, got1, planes
    return launches, finite_steps


def dsl_cmp_phase(snt):
    """40. The DSL Izhikevich against the hand-written `Izhikevich` at
    `DCMP` over `DCMP_STEPS`, both on their kernel routes on the card (the
    model kernel's DSL arm and the stencil kernel): another association,
    so held statistically (ROADMAP queue 3 item 4): the tie report, the
    spike counts within 2%, the mean v at the end within 1 mV."""
    runs = {}
    for key, make in (("dsl", lambda: dsl_lattice(snt, "DSLIzhikevich",
                                                  *DCMP)),
                      ("hand", lambda: main_lattice(snt, *DCMP))):
        lat = make()
        vs, lfts, spikes = [], [], 0
        for _ in range(DCMP_STEPS):
            lat.run_lattice(1)
            vs.append(lat.state["v"])
            lfts.append(lat.state["last_firing_time"])
            spikes += int(lat.state["is_spiking"].sum())
        runs[key] = (torch.stack(vs).cpu().numpy(),
                     torch.stack(lfts).cpu().numpy().astype(np.int64),
                     lat._last_run_fused, spikes)
    hk, lk, rk, sk_ = runs["dsl"]
    hp, lp, rp, sp = runs["hand"]
    d = np.abs(hk - hp)
    dvs = d.max(axis=1)
    s0 = int(np.argmax(dvs > DRIFT)) if (dvs > DRIFT).any() else None
    outside = int((d > 2.0).any(axis=0).sum())
    n = DCMP[0] * DCMP[1]
    dmean = abs(float(hk[-1].mean()) - float(hp[-1].mean()))
    say(f"[40 dsl-vs-hand-written] DSLIzhikevich (route {rk}) vs Izhikevich "
        f"(route {rp}) {DCMP[0]}x{DCMP[1]} {DCMP_STEPS} steps on the card: "
        f"first step with |dv| > {DRIFT}: {s0}, max|dv| before it "
        f"{float(dvs[:s0].max()) if s0 else float(dvs.max()):.4g} mV, "
        f"neurons ever outside 2 mV {outside} of {n}, spikes {sk_} vs {sp}, "
        f"fired {int((lk[-1] >= 0).sum())} vs {int((lp[-1] >= 0).sum())}, "
        f"final mean v {hk[-1].mean():.4f} vs {hp[-1].mean():.4f} mV")
    check(rk == "model" and rp == ("kernel", False), "wrong routes")
    check(abs(sk_ - sp) <= 0.02 * max(sp, 1), "the spike counts differ by "
          "more than 2%")
    check(dmean <= 1.0, "the mean v differs by more than 1 mV")


def from_start(run, k):
    """A `ModelRun`'s call of ``k`` steps as ``fn()``, for timing: each
    call runs the first ``k`` steps from the planes the run was built on
    (its state set back to them first), so a timed call never reaches a
    step past the main path's last finite v."""
    def fn():
        run.sets.cur = None
        return run.steps(0, k)
    return fn


def dsl_times_phase(snt, dk, mk, smi, finite_steps):
    """41. Each model at `DMAIN` (512 steps a timed run) and the DSL
    Izhikevich at `DBIG` (64), every timed run from the state `apply` made:
    the run's wall time per step (at most the ``finite_steps`` the main
    path's twin kept v finite, the state set back before each run), and
    the routed design's calls on one `ModelRun` (`from_start`; CUDA
    events; device time under torch.profiler over `EPROF` calls with every
    kernel record counted), device / wall, bytes, the bound and the twin's
    time; at `DMAIN` both designs in turns.  Returns them by (model,
    shape), per 16-step call."""
    K = mk.STEPS_PER_LAUNCH
    sms = mk.sm_count(torch.device("cuda"))
    out = {}
    for name, shape in [(n, DMAIN) for n in DSL_SOURCES] \
            + [("DSLIzhikevich", DBIG)]:
        lat = dsl_lattice(snt, name, *shape)
        steps = min(512 if shape == DMAIN else 64, finite_steps[name, shape])
        fresh = dict(lat.state)

        def from_fresh():
            lat.reset_timing()
            lat.apply(lambda s: dict(fresh))
            return run_synced(lat, steps)
        from_fresh()
        wall = min(from_fresh() for _ in range(3))
        check(lat._last_run_fused == "model", "timed the wrong route")
        check(bool(torch.isfinite(lat.state["v"]).all()),
              f"{name}: timed a run whose v is not finite")
        fields, _ = mk.model_kernel_fields(lat.model)
        g, st = lat.graph, fresh
        inp = dict(model=lat.model, planes={
            k: st[k].reshape(shape) for k, _ in fields},
            lft=st["last_firing_time"].reshape(shape), weights=g.weights,
            in_deg=g.in_deg, offsets=g.offsets)
        persistent = mk.uses_persistent(lat.model, shape, len(g.offsets),
                                        sms)
        runs = {d: mk.ModelRun(lat.model, inp["planes"], inp["lft"],
                               g.weights, g.in_deg, g.offsets,
                               per_step=d == "per_step")
                for d in (("persistent", "per_step") if persistent
                          else ("per_step",))}
        routed = "persistent" if persistent else "per_step"
        kernel = from_start(runs[routed], K)
        n_bytes = tensor_bytes([inp["planes"][k] for k in
                                mk.model_read_fields(lat.model)],
                               inp["lft"], g.weights, g.in_deg, kernel())
        bnd = bound(n_bytes, dsl_ops(dk, lat.model, g.offsets, *shape, K))
        kernel_ms = event_ms(kernel, 20)
        twin_ms = event_ms(lambda: mk.model_steps_reference(
            lat.model, inp["planes"], inp["lft"], g.weights, g.in_deg,
            g.offsets, 0, K), 2)
        n_launch = mk.call_launches(K, persistent)
        dev_us, top = profiled_us(lambda: [kernel() for _ in range(EPROF)],
                                  EPROF * K, launches=EPROF * n_launch)
        wall_us = wall / steps * 1e6
        out[name, shape] = dict(kernel_ms=kernel_ms, twin_ms=twin_ms,
                                device_ms=dev_us * K / 1e3, bound=bnd,
                                library=dk.build([lat.model])[0])
        say(f"[41 times] {name} {shape[0]}x{shape[1]}: kernel route "
            f"(the {routed} design) {rate(shape, wall, steps)}, best of 3 x "
            f"{steps} steps from the applied state; kernel calls back to back "
            f"{kernel_ms * 1e3 / K:.3f} us/step (events); device time "
            f"{dev_us:.3f} us/step (profiled, {EPROF} calls, "
            f"{EPROF * n_launch} kernel records: "
            + ", ".join(f"{k} {t:.3f}" for k, t in top)
            + f"); device time / wall {dev_us / wall_us:.3f}; "
            f"{n_bytes / 1e6:.2f} MB a call; bound {bnd[0] * 1e3 / K:.4f} "
            f"us/step ({bnd[1]}); plain twin {twin_ms * 1e3 / K:.3f} us/step "
            f"(events); library call: none; card {smi}")
        if persistent:
            turns = designs_in_turns(
                {d: from_start(runs[d], K) for d in runs},
                {d: mk.call_launches(K, d == "persistent") for d in runs}, K)
            say(f"[41 times] {name} {shape[0]}x{shape[1]}, the designs in "
                f"turns on one ModelRun each: {design_line(turns)}; card "
                f"{smi}")
        del lat, inp, runs
    return out


# ---------------------------------------------------------------------------
# sin / cos / tan on kernel 4's DSL arm: phase 42
# ---------------------------------------------------------------------------


def trig_phases(snt, smi):
    from spiking_neural_networks_tpu_torch.ops import (dsl_kernels as dk,
                                                       model_kernels as mk)
    max_err = trig_twin_phase(snt, mk)
    launches = trig_main_phase(snt, mk)
    t = trig_times_phase(snt, dk, mk, smi)
    return {
        "name": "model_steps, DSL arm, sin / cos / tan: "
                "model_persistent_kernel<Dsl, CPT>", "route": "cuda",
        "source": "spiking_neural_networks_tpu_torch/_build/dsl/"
                  + os.path.basename(t["library"])[:-3] + ".cu (generated "
                  "by ops/dsl_kernels.py, over csrc/model_stencil.cuh: "
                  "kernel_sin / kernel_cos / kernel_tan)",
        "replaces": MODEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": t["kernel_ms"],
        "plain_ms": t["twin_ms"], "device_ms": t["device_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
        "library_ms": None,
        "library_call": "none: no PyTorch call computes a lattice step"}


def trig_twin_phase(snt, mk):
    """42. The trig neuron's kernel against its twin on the card: a chain
    of calls of `DSL_KS` steps on one `ModelRun` from a random state, in
    each case of `TRIG_CASES` (512^2 in both designs, 2048^2 in the
    per-step one), call by call: floats bit-equal, the rest equal, the C
    entry's launches `call_launches`.  Returns the max float error."""
    name = "TrigNeuron"
    max_err = 0.0
    for c, (shape, per_step) in enumerate(TRIG_CASES):
        inp = dsl_inputs(snt, mk, dsl_model(snt, name), name, shape, 2.0,
                         700 + c)
        run = mk.ModelRun(inp["model"], inp["planes"], inp["lft"],
                          inp["weights"], inp["in_deg"], inp["offsets"],
                          per_step=per_step)
        check((run.plan is None) == per_step, f"{name} {shape}: the "
              f"case is not on the {'per-step' if per_step else 'persistent'}"
              f" design")
        tp, tl, clock = dict(inp["planes"]), inp["lft"], 10
        bad_f = bad_o = fired = 0
        for k in DSL_KS:
            want = mk.model_steps_reference(
                inp["model"], tp, tl, inp["weights"], inp["in_deg"],
                inp["offsets"], clock, k)
            before = mk.STEP_LAUNCHES
            got = run.steps(clock, k)
            torch.cuda.synchronize()
            check(mk.STEP_LAUNCHES - before
                  == mk.call_launches(k, run.plan is not None),
                  f"{name}: the C entry counted other launches")
            f, o, e = bit_diff(got, want)
            bad_f, bad_o, max_err = bad_f + f, bad_o + o, max(max_err, e)
            fired += int((want[1] >= clock).sum())
            tp = dict(tp, **want[0])
            tl, clock = want[1], clock + k
        finite = bool(torch.isfinite(tp["v"]).all())
        drive = tp["drive"]
        design = "per step" if per_step else (
            f"persistent, {-(-run.plan.cap // mk.THREADS)} cells a thread")
        say(f"[42 kernel-vs-twin] {name} {shape[0]}x{shape[1]} radius 2 "
            f"({design}), K {', '.join(map(str, DSL_KS))} chained on one "
            f"ModelRun: float elements not bit-equal {bad_f}, other "
            f"mismatches {bad_o}, neurons fired {fired}, v finite {finite}, "
            f"drive = tan(i / 1000) in [{drive.min().item():.4f}, "
            f"{drive.max().item():.4f}]")
        check(bad_f == 0 and bad_o == 0, f"{name}: the kernel differs from "
              f"its twin")
        check(fired > 0 and finite, f"{name}: no neuron fired or v not "
              f"finite")
        del inp, run, tp, tl
    return max_err


def trig_main_phase(snt, mk):
    """42. The trig neuron's main path: `Lattice` -> `populate` ->
    `connect_stencil` -> `apply` -> `run_lattice(TRIG_STEPS)` at `DMAIN`,
    its counts set to 0 just before: route "model", the persistent
    design, one launch a 16-step call counted by the C entry (and in the
    profiler's records of 4 more calls); the twin runs the same steps
    first, call by call on the card, and the final state is held bit for
    bit.  Returns the kernel launches of the run."""
    K = mk.STEPS_PER_LAUNCH
    name = "TrigNeuron"
    lat = dsl_lattice(snt, name, *DMAIN)
    shape = (lat.rows, lat.cols)
    fields, _ = mk.model_kernel_fields(lat.model)
    st, g = lat.state, lat.graph
    planes = {k: st[k].reshape(shape).clone() for k, _ in fields}
    lft0 = st["last_firing_time"].reshape(shape).clone()
    want, n1, _ = twin_until_nonfinite(mk, lat.model, planes, lft0, g,
                                       TRIG_STEPS)
    persistent = mk.uses_persistent(lat.model, shape, len(g.offsets),
                                    mk.sm_count(torch.device("cuda")))
    mk.LAUNCHES = mk.STEP_LAUNCHES = 0
    t0 = time.perf_counter()
    lat.run_lattice(TRIG_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls, launches = mk.LAUNCHES, mk.STEP_LAUNCHES
    got = ({k: lat.state[k].reshape(shape) for k in want[0]},
           lat.state["last_firing_time"].reshape(shape),
           lat.state["is_spiking"].reshape(shape))
    bad_f, bad_o, _ = bit_diff(got, want)
    v, lft = lat.state["v"], lat.state["last_firing_time"]
    fired = int((lft >= 0).sum())
    late = int((lft >= TRIG_STEPS // 2).sum())
    recs = kernel_records(lambda: lat.run_lattice(4 * K), 4,
                          mine=("model_",))
    say(f"[42 main path] {name} {shape[0]}x{shape[1]} run_lattice("
        f"{TRIG_STEPS}): route {lat._last_run_fused}, "
        f"{'persistent' if persistent else 'per-step'} design, kernel "
        f"calls {calls}, kernel launches {launches} (counted by the C "
        f"entry; {launches / max(calls, 1):.2f} a call), profiler records "
        f"of 4 more calls {records_line(recs)}; the twin's v finite through "
        f"step {n1}; the final state against the twin's: float elements "
        f"not bit-equal {bad_f}, other mismatches {bad_o}; v range "
        f"[{v.min().item():.3f}, {v.max().item():.3f}], fired {fired} of "
        f"{lat.n}, from step {TRIG_STEPS // 2} {late}; wall {wall:.3f} s")
    check(lat._last_run_fused == "model" and persistent,
          f"{name}: the main path took {lat._last_run_fused}")
    check(calls == -(-TRIG_STEPS // K) and launches == calls,
          f"{name}: not one launch a 16-step call")
    check(sum(recs.values()) == 4, f"{name}: the profiler's records differ "
          f"from the launches")
    check(bad_f == 0 and bad_o == 0, f"{name}: the main path differs from "
          f"the twin")
    check(n1 == TRIG_STEPS and bool(torch.isfinite(v).all()) and late > 0,
          f"{name}: v not finite or no neuron fired late in the run")
    return launches


def trig_times_phase(snt, dk, mk, smi):
    """42. The trig neuron at `DMAIN` from its applied state: the main
    path's wall per step (best of 3 x 512 steps), calls of one `ModelRun`
    (CUDA events; device time under torch.profiler over `EPROF` calls,
    every kernel record counted), device / wall, bytes, the bound and the
    twin's time; both designs in turns."""
    K = mk.STEPS_PER_LAUNCH
    name = "TrigNeuron"
    lat = dsl_lattice(snt, name, *DMAIN)
    shape = (lat.rows, lat.cols)
    fresh = dict(lat.state)

    def from_fresh():
        lat.reset_timing()
        lat.apply(lambda s: dict(fresh))
        return run_synced(lat, TRIG_STEPS)
    from_fresh()
    wall = min(from_fresh() for _ in range(3))
    check(lat._last_run_fused == "model", "timed the wrong route")
    fields, _ = mk.model_kernel_fields(lat.model)
    g = lat.graph
    planes = {k: fresh[k].reshape(shape) for k, _ in fields}
    lft = fresh["last_firing_time"].reshape(shape)
    runs = {d: mk.ModelRun(lat.model, planes, lft, g.weights, g.in_deg,
                           g.offsets, per_step=d == "per_step")
            for d in ("persistent", "per_step")}
    check(runs["persistent"].plan is not None, "no persistent plan at 512^2")
    kernel = from_start(runs["persistent"], K)
    n_bytes = tensor_bytes([planes[k] for k in mk.model_read_fields(
        lat.model)], lft, g.weights, g.in_deg, kernel())
    bnd = bound(n_bytes, dsl_ops(dk, lat.model, g.offsets, *shape, K))
    kernel_ms = event_ms(kernel, 20)
    twin_ms = event_ms(lambda: mk.model_steps_reference(
        lat.model, planes, lft, g.weights, g.in_deg, g.offsets, 0, K), 2)
    dev_us, top = profiled_us(lambda: [kernel() for _ in range(EPROF)],
                              EPROF * K, launches=EPROF)
    wall_us = wall / TRIG_STEPS * 1e6
    say(f"[42 times] {name} {shape[0]}x{shape[1]}: kernel route (the "
        f"persistent design) {rate(shape, wall, TRIG_STEPS)}, best of 3 x "
        f"{TRIG_STEPS} steps from the applied state; kernel calls back to "
        f"back {kernel_ms * 1e3 / K:.3f} us/step (events); device time "
        f"{dev_us:.3f} us/step (profiled, {EPROF} calls, {EPROF} kernel "
        f"records: " + ", ".join(f"{k} {t:.3f}" for k, t in top)
        + f"); device time / wall {dev_us / wall_us:.3f}; "
        f"{n_bytes / 1e6:.2f} MB a call; bound {bnd[0] * 1e3 / K:.4f} "
        f"us/step ({bnd[1]}); plain twin {twin_ms * 1e3 / K:.3f} us/step "
        f"(events); library call: none; card {smi}")
    turns = designs_in_turns({d: from_start(runs[d], K) for d in runs},
                             {d: mk.call_launches(K, d == "persistent")
                              for d in runs}, K)
    say(f"[42 times] {name} {shape[0]}x{shape[1]}, the designs in turns on "
        f"one ModelRun each: {design_line(turns)}; card {smi}")
    out = dict(kernel_ms=kernel_ms, twin_ms=twin_ms,
               device_ms=dev_us * K / 1e3, bound=bnd,
               library=dk.build([lat.model])[0])
    del lat, runs
    return out


# ---------------------------------------------------------------------------
# The Bayesian-inference trial through lixirnet: phases 43-44
# ---------------------------------------------------------------------------


class TrialProbe:
    """Around `run_trial` calls: keeps each network that the port's
    `lixirnet` builds (`IzhikevichNeuronNetwork.generate_network`), sets
    its ``use_kernel``, and times its `run_lattices` between two
    synchronisations (so a trial splits into construction, run and
    analysis); with ``capture``, also keeps the first kernel call's
    inputs at the run's start.  Restores the class on exit."""

    def __init__(self, ln, nk, use_kernel=None, capture=False):
        self.cls, self.nk = ln.IzhikevichNeuronNetwork, nk
        self.use_kernel, self.capture = use_kernel, capture
        self.nets, self.runs, self.args = [], [], None

    def __enter__(self):
        cls, probe = self.cls, self
        self.saved = (cls.__dict__["generate_network"],
                      cls.__dict__["run_lattices"])
        generate, run = cls.generate_network.__func__, cls.run_lattices

        def generate_network(c, *a, **k):
            net = generate(c, *a, **k)
            net.inner.use_kernel = probe.use_kernel
            probe.nets.append(net)
            return net

        def run_lattices(net, n):
            if probe.capture and probe.args is None:
                probe.args = (cloned(chem_inputs(probe.nk, net.inner, 1, 0,
                                                 True)),
                              net.inner.internal_clock)
            if net.inner.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(net, n)
            if net.inner.device.type == "cuda":
                torch.cuda.synchronize()
            probe.runs.append((t0, time.perf_counter()))

        cls.generate_network = classmethod(generate_network)
        cls.run_lattices = run_lattices
        return self

    def __exit__(self, *exc):
        self.cls.generate_network, self.cls.run_lattices = self.saved

    def trial(self, bt, inputs, device):
        """One `run_trial` on ``device``: (its value dict and the two
        pattern indices as a string, the network, seconds of construction,
        run and analysis)."""
        t0 = time.perf_counter()
        value, pattern1, pattern2 = bt.run_trial(*inputs(), device=device)
        value = f"{value} (patterns {pattern1}, {pattern2})"
        if device == "cuda":
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        t1, t2 = self.runs[-1]
        return value, self.nets[-1], (t1 - t0, t2 - t1, t3 - t2)


def cloned(x):
    """``x`` with every tensor in it (nested in dicts, lists and tuples)
    copied."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: cloned(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(cloned(v) for v in x)
    return x


def trial_inputs(bt, toml):
    """``fn()`` giving `run_trial`'s arguments for the first trial of the
    pipeline's ``toml`` as its `main` makes them (`bt.trial_inputs`)."""
    here = os.path.dirname(os.path.abspath(__file__))

    def fn():
        with open(os.path.join(here, TRIAL_ARGS, toml), "rb") as f:
            parsed = bt.parse_toml(f)
        bt.fill_defaults(parsed)
        cs, _, patterns, bayes, rng = next(bt.trial_inputs(parsed))
        return parsed["simulation_parameters"], cs, patterns, bayes, rng
    return fn


def exc_ids(bt, net):
    return [i for i in (bt.E1, bt.E2) if i in net.inner.lattices]


def trial_phases(snt, smi):
    from spiking_neural_networks_tpu_torch import lixirnet as ln
    from spiking_neural_networks_tpu_torch.experiments import (
        bayesian_inference_rate_based as bt)
    from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
    check(bt.ln is ln, "the trial pipeline does not use the port's lixirnet")
    launches, args = trial_main_phase(bt, ln, nk)
    entry = trial_call_entry(nk, args, launches, smi)
    trial_times_phase(bt, ln, nk, smi)
    return entry


def trial_main_phase(bt, ln, nk):
    """43. Each TOML's first trial through `run_trial` on the card, the
    network kernel's counts set to 0 just before it: the route, every
    call through the persistent kernel, every state finite, neurons
    fired; then the same trial on the CPU, on the same kernel route (the
    twin), held against it over its first `TRIAL_CMP_STEPS` steps: each
    excitatory grid history within 2 mV, each neuron's peaks above 20 mV
    (the trial's own spikes, `pipeline_setup.find_peaks_above_threshold`)
    within 2 steps; both routes' value dicts.  Returns the persistent
    launches of the card's trials and the first trial's first call."""
    from spiking_neural_networks_tpu_torch.experiments.pipeline_setup \
        import find_peaks_above_threshold
    K = nk.STEPS_PER_LAUNCH
    total, first = 0, None
    for toml in TRIAL_TOMLS:
        inputs = trial_inputs(bt, toml)
        steps = inputs()[0]["iterations1"]
        with TrialProbe(ln, nk, capture=first is None) as probe:
            nk.LAUNCHES = nk.CHEM_LAUNCHES = nk.FLAT_LAUNCHES = 0
            nk.PERSISTENT_LAUNCHES = 0
            value, net, split = probe.trial(bt, inputs, "cuda")
            calls = (nk.LAUNCHES, nk.CHEM_LAUNCHES, nk.FLAT_LAUNCHES,
                     nk.PERSISTENT_LAUNCHES)
            if first is None:
                first = probe.args
        total += calls[3]
        inner = net.inner
        members = list(inner.lattices.values()) \
            + list(inner.spike_train_lattices.values())
        finite = all(bool(torch.isfinite(x).all()) for m in members
                     for x in m.state.values() if x.is_floating_point())
        fired = {i: int((l.state["last_firing_time"] >= 0).sum())
                 for i, l in sorted(inner.lattices.items())}
        cues = {i: int((s.state["last_firing_time"] >= 0).sum())
                for i, s in sorted(inner.spike_train_lattices.items())}
        with TrialProbe(ln, nk, use_kernel=True) as cpu_probe:
            cpu_value, cpu_net, _ = cpu_probe.trial(bt, inputs, "cpu")
        n = min(TRIAL_CMP_STEPS, steps)
        dv, dpeak, npeaks = 0.0, 0, 0
        for i in exc_ids(bt, net):
            hk = np.stack(net.get_lattice(i).history)[:n].reshape(n, -1)
            hc = np.stack(cpu_net.get_lattice(i).history)[:n].reshape(n, -1)
            dv = max(dv, float(np.abs(hk - hc).max()))
            for j in range(hk.shape[1]):
                pk = find_peaks_above_threshold(hk[:, j], 20)
                pc = find_peaks_above_threshold(hc[:, j], 20)
                check(len(pk) == len(pc), f"{toml}: neuron {j} of lattice "
                      f"{i} spikes {len(pk)} times on the card, {len(pc)} "
                      f"on the CPU in the first {n} steps")
                npeaks += len(pk)
                dpeak = max([dpeak] + [abs(a - b) for a, b in zip(pk, pc)])
        say(f"[43 main path] {toml}: run_trial on the card, "
            f"{len(inner.lattices)} lattices {sorted(inner.lattices)}, "
            f"{len(inner.spike_train_lattices)} trains, "
            f"{len(inner.connections)} connections, {steps} steps: route "
            f"{inner._last_run_fused}, kernel calls {calls[0]} (chemical "
            f"{calls[1]}, flat {calls[2]}, persistent {calls[3]}), state "
            f"finite {finite}, fired per lattice {fired}, per train {cues}; "
            f"construction {split[0]:.3f} s, run {split[1]:.3f} s, analysis "
            f"{split[2]:.3f} s; value (card) {value}")
        say(f"[43 kernel-vs-cpu] {toml}: the same trial on the CPU (route "
            f"{cpu_net.inner._last_run_fused}), its first {n} steps: max|dv| "
            f"{dv:.4g} mV over the excitatory histories, {npeaks} peaks "
            f"above 20 mV on each side, max |dpeak| {dpeak} steps; value "
            f"(CPU) {cpu_value}; the value dicts "
            f"{'equal' if value == cpu_value else 'differ'}")
        check(inner._last_run_fused == ("flat-chemical", True),
              f"{toml}: the trial took {inner._last_run_fused}")
        check(calls[0] >= -(-steps // K) and calls[0] == calls[1] == calls[2]
              == calls[3], f"{toml}: a kernel call missed the persistent "
              f"flat kernel")
        check(finite and sum(fired.values()) > 0, f"{toml}: non-finite "
              f"state or no neuron fired")
        check(dv <= 2.0 and dpeak <= 2, f"{toml}: card vs CPU outside 2 mV / "
              f"2 steps")
        check(cpu_net.inner._last_run_fused == ("flat-chemical", True),
              f"{toml}: the CPU trial took another route")
        del net, cpu_net, probe, cpu_probe
    return total, first


def trial_times_phase(bt, ln, nk, smi):
    """44. Each TOML's first trial on the card: wall seconds per trial,
    best of `TRIAL_REPS` after a warm-up (`bench.py:577-586`), with its
    split into construction, run and analysis; the device time per step
    of the run under torch.profiler (the last trial's network, run on
    for `PROFILE_STEPS`); the plain route's (``use_kernel=False``) wall
    for one trial."""
    for toml in TRIAL_TOMLS:
        inputs = trial_inputs(bt, toml)
        steps = inputs()[0]["iterations1"]
        with TrialProbe(ln, nk) as probe:
            probe.trial(bt, inputs, "cuda")
            timed = [probe.trial(bt, inputs, "cuda")
                     for _ in range(TRIAL_REPS)]
        best = min(timed, key=lambda t: sum(t[2]))
        walls = [sum(t[2]) for t in timed]
        net = best[1]
        check(net.inner._last_run_fused == ("flat-chemical", True),
              "timed the wrong route")
        dev_us, top = profiled_us(
            lambda: run_net_synced(net.inner, PROFILE_STEPS), PROFILE_STEPS,
            n_top=4)
        with TrialProbe(ln, nk, use_kernel=False) as plain:
            pv, pnet, psplit = plain.trial(bt, inputs, "cuda")
        check(pnet.inner._last_run_fused is False, "the plain trial took a "
              "kernel route")
        c, r, a = best[2]
        say(f"[44 times] {toml}: trial wall {sum(best[2]):.4f} s (best of "
            f"{TRIAL_REPS} after a warm-up: "
            + ", ".join(f"{w:.4f}" for w in walls)
            + f"): construction {c:.4f} s, run {r:.4f} s ({r / steps * 1e6:.3f}"
            f" us/step over {steps} steps), analysis {a:.4f} s; the run's "
            f"device time {dev_us:.3f} us/step (profiled, {PROFILE_STEPS} "
            f"steps: " + ", ".join(f"{k} {t:.3f}" for k, t in top)
            + f"), device / run wall {dev_us / (r / steps * 1e6):.3f}; plain "
            f"route (use_kernel=False) one trial {sum(psplit):.3f} s "
            f"(construction {psplit[0]:.3f}, run {psplit[1]:.3f}, analysis "
            f"{psplit[2]:.3f}), value {pv}; card {smi}")
        del net, pnet, timed, best


def trial_call_entry(nk, args, launches, smi):
    """43. The smoke trial's first 16-step call, on the state its run
    started from: the persistent kernel against the twin (bit-equal), the
    designs in turns, the twin's time, the bound, and `torch.mv` on the
    excitatory lattice's (49, 49) weights (one dense gather of one step)
    as the library call.  Returns the kernel's entry of the JSON line."""
    (spec, lats, trains, conns, uniforms, rule), clock = args
    K = nk.STEPS_PER_LAUNCH
    call = (spec, lats, trains, conns, uniforms, rule)
    want = nk.network_steps_reference(*call, clock, K)
    got = nk.network_steps(*call, clock, K)
    torch.cuda.synchronize()
    err, bad, _ = compare_chem(got, want)
    bits = bit_mismatches(got, want)
    call_bound = bound(chem_bytes(spec, lats, trains, conns, uniforms, got),
                       flat_ops(spec, lats, conns, K))
    d = design_times(nk, call, clock, K)
    twin = event_ms(lambda: nk.network_steps_reference(*call, clock, K), 2)
    n_exc = max(ls.shape[1] for ls in spec.lattices)
    wm = torch.randn((n_exc, n_exc), device="cuda")
    vec = torch.randn(n_exc, device="cuda")
    lib_ms = event_ms(lambda: torch.mv(wm, vec), 200)
    say(f"[43 kernel-vs-twin] smoke.toml's first 16-step call: integer and "
        f"spike mismatches {bad}, max float error {err:.3g}, outputs not "
        f"bit-equal {bits}; the designs in turns: {design_line(d)}; plain "
        f"twin {twin * 1e3 / K:.3f} us/step (events); bound "
        f"{call_bound[0] * 1e3 / K:.4f} us/step ({call_bound[1]}); "
        f"torch.mv ({n_exc}, {n_exc}) {lib_ms * 1e3:.3f} us; card {smi}")
    check(bad == 0 and err == 0.0 and bits == [],
          "the trial's call differs from the twin")
    return {"name": "network_persistent (flat-mode arm): the lixirnet "
                    "Bayesian trial", "route": "cuda",
            "source": "spiking_neural_networks_tpu_torch/csrc/"
                      "network_persistent.cu",
            "replaces": FLAT_REPLACES, "launches": launches,
            "max_abs_err": err, "ms": d["persistent"][1] * K / 1e3,
            "plain_ms": twin, "device_ms": d["persistent"][2] * K / 1e3,
            "other_design_ms": d["per_step"][1] * K / 1e3,
            "bound_ms": call_bound[0], "bound_by": call_bound[1],
            "library_ms": lib_ms,
            "library_call": f"torch.mv on the ({n_exc}, {n_exc}) excitatory "
                            f"weights: one dense gather of one step"}


# ---------------------------------------------------------------------------
# The support modules (phases 45-50): the host graph builder, the kernel
# route diagnosis, checkpoints, BCM on a reward network, fitting, profiling
# ---------------------------------------------------------------------------


def support_phases(snt, smi):
    """Phases 45-50; no kernel of their own (an empty list)."""
    native_phase(snt, smi)
    diagnostics_phase(snt)
    checkpoint_phase(snt, smi)
    bcm_reward_phase(snt, smi)
    fitting_phase(snt, smi)
    profiling_phase(snt, smi)
    return []


def native_phase(snt, smi):
    """45. `sparse_radius_graph` on the native branch (g++ built the
    library at its first import) and on the NumPy branch, host seconds."""
    from spiking_neural_networks_tpu_torch import _native
    from spiking_neural_networks_tpu_torch.ops import graph as tg
    check(_native.available, "the native graph library did not build: "
          "sparse_radius_graph would take the NumPy branch")
    for rows, cols in NATIVE_SHAPES:
        secs, edges = {}, {}
        for branch in ("native", "numpy"):
            _native.available = branch == "native"
            try:
                t0 = time.perf_counter()
                g = tg.sparse_radius_graph(rows, cols, 2.0, keep_prob=0.8,
                                           seed=5, device="cuda")
                torch.cuda.synchronize()
                secs[branch] = time.perf_counter() - t0
            finally:
                _native.available = True
            edges[branch] = g.src.numel()
            slots = ingrid_slots(snt.radius_offsets(2.0), rows, cols)
            check(g.weights.is_cuda
                  and int(g.in_deg.double().sum()) == edges[branch]
                  and 0.78 < edges[branch] / slots < 0.82,
                  f"sparse_radius_graph's {branch} branch at {rows}x{cols}")
        say(f"[45 native] {rows}x{cols} radius 2 keep 0.8: native "
            f"{secs['native']:.3f} s host, {edges['native']} edges; NumPy "
            f"{secs['numpy']:.3f} s, {edges['numpy']} edges | {smi}")


def diag_cases(snt):
    """(label, builder) of one lattice of each family the smoke runs, and
    four that must stay on the plain route."""
    from spiking_neural_networks_tpu_torch.ops.graph import DenseGraph

    def bcm():
        lat = model_lattice(snt, "BCMIzhikevich", *DIAG)
        lat.plasticity, lat.do_plasticity = snt.BCM(), True
        return lat

    def stdp_graph_history():
        lat = stdp_lattice(snt, *DIAG)
        lat.update_graph_history = True
        return lat

    def chemical():
        lat = main_lattice(snt, *DIAG)
        s = lat.model.insert_receptor(lat.state, "AMPA")
        lat.state = lat.model.insert_neurotransmitter(s, "AMPA")
        lat.chemical_synapse = True
        return lat

    def dense():
        lat = snt.Lattice(snt.Izhikevich(), device="cuda")
        lat.populate(*DIAG_DENSE, gap_conductance=10.0)
        rng = np.random.default_rng(0)
        lat.connect(lambda x, y: x != y and rng.random() < 0.3)
        check(isinstance(lat.graph, DenseGraph), "connect() kept no "
              "DenseGraph")
        return lat

    return [("stencil", lambda: main_lattice(snt, *MAIN)),
            ("stencil per-neuron", lambda: hetero_lattice(snt, *BIG)),
            ("STDP", lambda: stdp_lattice(snt, *DIAG)),
            ("R-STDP", lambda: bench_rstdp(snt, *DIAG, v0=True)),
            ("HH firing form", lambda: hh_lattice(snt, *DIAG)),
            ("Morris-Lecar", lambda: model_lattice(snt, "MorrisLecar",
                                                   *DIAG)),
            ("DSL Izhikevich", lambda: dsl_lattice(snt, "DSLIzhikevich",
                                                   *DIAG)),
            ("DSL HH", lambda: dsl_lattice(snt, "DSLHodgkinHuxley", *DIAG)),
            ("trig neuron", lambda: dsl_lattice(snt, "TrigNeuron", *DIAG)),
            ("BCM (plain)", bcm),
            ("STDP + graph history (plain)", stdp_graph_history),
            ("chemical Izhikevich (plain)", chemical),
            ("DenseGraph (plain)", dense)]


def diagnostics_phase(snt):
    """46. `why_not_fused` against the route a 16-step run takes."""
    for label, build in diag_cases(snt):
        lat = build()
        verdict = snt.why_not_fused(lat)
        if hasattr(lat, "run_lattice_with_reward"):
            lat.run_lattice_with_reward(0.5, 16)
        else:
            lat.run_lattice(16)
        torch.cuda.synchronize()
        fused = lat._last_run_fused
        check((verdict == []) == bool(fused),
              f"why_not_fused({label}) = {verdict}, but the run's route "
              f"was {fused!r}")
        check(label.endswith("(plain)") == (verdict != []),
              f"{label}: verdict {verdict}")
        say(f"[46 diagnostics] {label} {lat.rows}x{lat.cols}: route "
            f"{fused!r}, why_not_fused {verdict}")


def net_snapshot(net):
    """Every state tensor, weight, trace, host connection, dopamine and
    clock of a network, copied."""
    out = {"clock": net.internal_clock,
           "dopamine": float(getattr(net, "dopamine", 0.0))}
    for i, lat in net._neuron_lattices().items():
        out[f"lat{i}"] = {k: v.clone() for k, v in lat.state.items()}
        out[f"w{i}"] = lat.graph.weights.clone()
        out[f"clock{i}"] = lat.internal_clock
        if getattr(lat, "trace", None) is not None:
            out[f"trace{i}"] = {k: v.clone() for k, v in lat.trace.items()}
            out[f"dopamine{i}"] = float(lat.dopamine)
    for i, st in net.spike_train_lattices.items():
        out[f"st{i}"] = {k: v.clone() for k, v in st.state.items()}
    for key, c in net.connections.items():
        out[f"conn{key}"] = tuple(np.array(x) for x in c)
    for key, c in getattr(net, "reward_connections", {}).items():
        out[f"rconn{key}"] = tuple(np.array(x) for x in c)
    return out


def lat_snapshot(lat):
    out = {"clock": lat.internal_clock, "w": lat.graph.weights.clone(),
           "state": {k: v.clone() for k, v in lat.state.items()}}
    if getattr(lat, "trace", None) is not None:
        out["trace"] = {k: v.clone() for k, v in lat.trace.items()}
        out["dopamine"] = float(lat.dopamine)
    return out


def snapshots_differ(got, want, path=""):
    """The paths at which two snapshots differ (bit for bit; NaN = NaN)."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return [path + " keys"]
        return sum((snapshots_differ(got[k], want[k], f"{path}/{k}")
                    for k in want), [])
    if isinstance(want, tuple):
        return sum((snapshots_differ(g, w, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))), [])
    if isinstance(want, torch.Tensor):
        same = want.dtype == got.dtype and want.shape == got.shape and bool(
            (bits_differ(got, want) == 0) if want.dtype == torch.float32
            else torch.equal(got, want))
        return [] if same else [path]
    if isinstance(want, np.ndarray):
        return [] if np.array_equal(got, want, equal_nan=True) \
            and got.dtype == want.dtype else [path]
    return [] if got == want else [path]


def resume_case(label, obj, run, snap, k, route_ok, load, save, folder):
    """Run ``k`` steps, save, run ``k`` more (``want``), load into the
    same object and run ``k`` again (``got``): bit-equal, and the kernel
    route on both halves."""
    run(k)
    path = os.path.join(folder, "".join(c if c.isalnum() else "_"
                                        for c in label) + ".npz")
    t0 = time.perf_counter()
    save(obj, path)
    save_s = time.perf_counter() - t0
    run(k)
    torch.cuda.synchronize()
    routes = [obj._last_run_fused]
    want = snap(obj)
    t0 = time.perf_counter()
    load(obj, path)
    load_s = time.perf_counter() - t0
    run(k)
    torch.cuda.synchronize()
    routes.append(obj._last_run_fused)
    differ = snapshots_differ(snap(obj), want)
    check(not differ, f"[47 checkpoint] {label}: the resumed run differs "
          f"at {differ[:5]}")
    check(all(route_ok(r) for r in routes),
          f"[47 checkpoint] {label}: routes {routes}")
    say(f"[47 checkpoint] {label}: {k} + save + {k} = load + {k}, bit-equal "
        f"(states, weights, traces, dopamine, clocks); routes {routes}; save "
        f"{save_s:.3f} s, load {load_s:.3f} s, {os.path.getsize(path)} "
        f"bytes")


def checkpoint_phase(snt, smi):
    """47. A run resumed from a checkpoint into the same object is
    bit-equal to the uninterrupted run: the 512^2 main path (row 2), the
    512^2 R-STDP lattice (6a), config 5 (6b, the network generator
    restored) and `bench.py`'s reward network at 128^2 (6c); save and load
    times and bytes at 512^2 and 2048^2."""
    import tempfile
    from spiking_neural_networks_tpu_torch.utils import checkpoint as ck
    with tempfile.TemporaryDirectory() as folder:
        lat = main_lattice(snt, *MAIN)
        resume_case(f"main path {MAIN[0]}^2", lat, lat.run_lattice,
                    lat_snapshot, CKPT_K[0], lambda r: r == ("kernel", False),
                    ck.load_lattice, ck.save_lattice, folder)
        rl = bench_rstdp(snt, *MAIN, v0=True)
        resume_case(f"R-STDP {MAIN[0]}^2", rl,
                    lambda k: rl.run_lattice_with_reward(0.5, k),
                    lat_snapshot, CKPT_K[1], lambda r: r is True,
                    ck.load_lattice, ck.save_lattice, folder)
        net = cfg5_net(snt, *NSMALL)
        resume_case(f"config 5 {NSMALL[0]}^2/{NSMALL[0] // 2}^2", net,
                    net.run_lattices, net_snapshot, CKPT_K[2],
                    lambda r: bool(r) and r[0] == "network",
                    ck.load_network, ck.save_network, folder)
        check(net._generator is not None, "config 5 has no generator")
        rnet = reward_main_net(snt, *CKPT_REWARD)
        resume_case(f"reward network {CKPT_REWARD[0]}^2", rnet,
                    lambda k: rnet.run_lattices_with_reward(0.5, k),
                    net_snapshot, CKPT_K[3], lambda r: r == ("reward", False),
                    ck.load_network, ck.save_network, folder)
        big = main_lattice(snt, *BIG)
        resume_case(f"main path {BIG[0]}^2", big, big.run_lattice,
                    lat_snapshot, CKPT_K[4], lambda r: r == ("kernel", False),
                    ck.load_lattice, ck.save_lattice, folder)
    say(f"[47 checkpoint] host seconds beside {smi}")


def bcm_reward_net(snt, rows, cols, structured, device="cuda"):
    """JAX ``tests/test_fuzz_runners.py:149-165``'s BCM pair (two plastic
    `BCMIzhikevich` lattices with BCM, radius 1.5, keep 0.9, 1 -> 2 one to
    one at 2.0) with a `BCMIzhikevich` `RewardModulatedLattice` (0) fed by
    lattice 2 through a reward connection and a `BCMPoissonSpikeTrain` (3)
    into lattice 1 (3.0), as ``tests/test_torch_bcm.py`` builds it, with
    activity windows of `BCM_WINDOW` (50 steps: they close six times in
    the run; at 5 steps, the test's, the rule sends weights to -1e8 and v
    to -1e13 by step 300); the train's chances are 1 and 0 in turn, so
    that the card's and the CPU's draws agree."""
    rng = np.random.default_rng(77)
    n = rows * cols

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    net = snt.RewardModulatedLatticeNetwork(device)
    rlat = snt.RewardModulatedLattice(snt.BCMIzhikevich(), id=0,
                                      device=device)
    rlat.populate(rows, cols, gap_conductance=10.0,
                  firing_rate_window=BCM_WINDOW)
    rlat.connect_stencil(radius=1.5, keep_prob=0.9, seed=69)
    v0 = rng.uniform(-65.0, 30.0, n)
    rlat.apply(lambda s: {**s, "v": f32(v0)})
    net.add_lattice(rlat)
    for k in (1, 2):
        lat = snt.Lattice(snt.BCMIzhikevich(), id=k, device=device)
        lat.populate(rows, cols, gap_conductance=10.0,
                     firing_rate_window=BCM_WINDOW)
        lat.connect_stencil(radius=1.5, keep_prob=0.9, seed=70 + k)
        v0 = rng.uniform(-65.0, 30.0, n)
        v0[rng.permutation(n)[:4]] = 40.0
        lat.apply(lambda s, v0=v0: {**s, "v": f32(v0)})
        lat.do_plasticity, lat.plasticity = True, snt.BCM()
        net.add_lattice(lat)
    st = snt.SpikeTrainLattice(snt.BCMPoissonSpikeTrain(), id=3,
                               device=device)
    st.populate(rows, cols)
    chance = np.tile([1.0, 0.0], n)[:n]
    st.apply(lambda s: {**s, "chance_of_firing": f32(chance),
                        "firing_rate_window": f32(np.full(n, BCM_WINDOW))})
    net.add_spike_train_lattice(st)
    one = one_to_one_coo(n, 1.0)
    net.connections[(1, 2)] = one_to_one_coo(n, 2.0)
    net.connections[(3, 1)] = one_to_one_coo(n, 3.0)
    net.reward_connections[(2, 0)] = one + (
        np.zeros(n, np.float32), np.zeros(n, np.float32),
        np.zeros(n, np.int32))
    net._conn_version += 1
    net.structured = structured
    return net


def bcm_reward_phase(snt, smi):
    """48. BCM on a reward network's plain lattices at 64^2, reward 0.5,
    through the structured and the flat COO runner (the plain route: the
    reward arm takes STDP only): weights moved; the card against the CPU
    (v within 2 mV, last firing times within 2 steps, weights within rtol
    2e-4, atol 2e-4); us/step."""
    for structured in (True, False):
        nets = {dev: bcm_reward_net(snt, *BCM_REWARD, structured, dev)
                for dev in ("cuda", "cpu")}
        w0 = {k: nets["cuda"].lattices[k].graph.weights.clone()
              for k in (1, 2)}
        for dev, net in nets.items():
            t0 = time.perf_counter()
            net.run_lattices_with_reward(0.5, BCM_REWARD_STEPS)
            if dev == "cuda":
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
        card, cpu = nets["cuda"], nets["cpu"]
        check(card._last_run_fused is False and cpu._last_run_fused is False,
              "a BCM reward network left the plain route")
        check(all(not torch.equal(card.lattices[k].graph.weights, w0[k])
                  for k in (1, 2)), "BCM moved no intra-lattice weight")
        dv = dl = dw = 0.0
        for i, lat in card._neuron_lattices().items():
            ref = cpu._neuron_lattices()[i]
            dv = max(dv, float((lat.state["v"].cpu() - ref.state["v"])
                               .abs().max()))
            dl = max(dl, float((lat.state["last_firing_time"].cpu()
                                - ref.state["last_firing_time"]).abs()
                               .max()))
            w, wr = lat.graph.weights.cpu(), ref.graph.weights
            check(torch.allclose(w, wr, rtol=2e-4, atol=2e-4),
                  f"BCM reward network: weights of lattice {i} card vs CPU")
            dw = max(dw, float((w - wr).abs().max()))
        check(dv <= 2.0 and dl <= 2, f"BCM reward network card vs CPU: "
              f"max|dv| {dv}, max|dlft| {dl}")
        say(f"[48 bcm reward network] {'structured' if structured else 'flat'}"
            f" {BCM_REWARD[0]}x{BCM_REWARD[1]} x 3 lattices + train, "
            f"{BCM_REWARD_STEPS} steps at reward 0.5: route False, weights "
            f"moved; card vs CPU max|dv| {dv:.3g} mV, max|dlft| {dl:.0f}, "
            f"max|dw| {dw:.3g}; {secs / BCM_REWARD_STEPS * 1e6:.1f} us/step "
            f"| {smi}")


def fitting_phase(snt, smi):
    """49. JAX ``tests/test_analysis.py:133``'s fit on the card: recover
    Izhikevich ``a`` = 0.05 from a Rate train's summary (400 iterations,
    n_pop 32, n_iter 10); one generation's population scores equal to the
    CPU's for the same decoded population; seconds per generation and us
    per coupled step."""
    from spiking_neural_networks_tpu_torch import fitting as fit
    from spiking_neural_networks_tpu_torch.fitting import fitting as ff
    model, st_model = snt.Izhikevich(), snt.RateSpikeTrain()
    st_state = st_model.init_state(1, device="cuda", rate=2.0, v_th=30.0)
    ref_state = model.init_state(1, device="cuda", a=0.05,
                                 gap_conductance=10.0)
    ref = fit.get_reference_summary(model, ref_state, st_model, st_state,
                                    FIT_ITERATIONS, device="cuda")
    settings = fit.FittingSettings(
        neuron_model=model, st_model=st_model, spike_train_states=[st_state],
        reference_summaries=[ref[0]], scaling_factors=[(800.0, 10.0)],
        iterations=FIT_ITERATIONS,
        converter=lambda p: {"a": p[0], "gap_conductance": 10.0})
    ga = fit.GeneticAlgorithmParameters(bounds=[(0.01, 0.12)], n_bits=8,
                                        n_iter=FIT_GENERATIONS,
                                        n_pop=FIT_POP, r_mut=0.08)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, score, scores = fit.fit_neuron_to_neuron(settings, ga, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fitted = fit.get_reference_summary(
        model, model.init_state(1, device="cuda", a=float(best[0]),
                                gap_conductance=10.0),
        st_model, st_state, FIT_ITERATIONS, device="cuda")
    check(len(scores) == FIT_GENERATIONS and score < 1.0
          and torch.allclose(fitted.cpu(), ref.cpu(), rtol=0.1, atol=2.0),
          f"the fit on the card: a {best}, score {score}, summary "
          f"{fitted.tolist()} against {ref.tolist()}")
    # one generation on the card and on the CPU, the same population
    decoded = fit.decode_population(torch.randint(
        0, 2, (FIT_POP, 8), generator=gen, device="cuda",
        dtype=torch.int32), ga.bounds, 8)
    per_dev = {}
    template_cuda = {k: v[0] for k, v in model.init_state(
        1, device="cuda", gap_conductance=10.0).items()}
    for dev in ("cuda", "cpu"):
        trains = [{k: v.to(dev) for k, v in st_state.items()}]
        template = {k: v[0] for k, v in model.init_state(
            1, device=dev, gap_conductance=10.0).items()}
        t0 = time.perf_counter()
        per_dev[dev] = ff.population_scores(
            settings, trains, template, [ref[0].to(dev)], [(800.0, 10.0)],
            decoded.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
    check(torch.equal(per_dev["cuda"].cpu(), per_dev["cpu"]),
          "a generation's scores differ between the card and the CPU")
    dev_us, top = profiled_us(lambda: ff.population_scores(
        settings, [st_state], template_cuda, [ref[0]], [(800.0, 10.0)],
        decoded), FIT_ITERATIONS)
    say(f"[49 fitting] a = {float(best[0]):.4f} (true 0.05), score "
        f"{score:.3g}, summary {fitted[0].tolist()} vs {ref[0].tolist()}; "
        f"{FIT_GENERATIONS} generations of {FIT_POP} x {FIT_ITERATIONS} "
        f"steps in {secs:.2f} s ({secs / FIT_GENERATIONS:.3f} s a "
        f"generation); one generation {gen_s:.3f} s = "
        f"{gen_s / FIT_ITERATIONS * 1e6:.1f} us per coupled step of the "
        f"({FIT_POP}, 2) batch, device {dev_us:.1f} us (device / wall "
        f"{dev_us / (gen_s / FIT_ITERATIONS * 1e6):.3f}; top {top}); card = "
        f"CPU scores for one generation | {smi}")


def fresh_trace(folder):
    """`utils.profiling.trace` around `run_lattice(TRACE_STEPS)` of the
    main lattice (after one untraced run) in a new Python process on the
    card; returns the Chrome trace's path."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys\n"
            f"sys.path.insert(0, {here!r})\n"
            "import chip_smoke as cs\n"
            "import spiking_neural_networks_tpu_torch as snt\n"
            "from spiking_neural_networks_tpu_torch.utils.profiling import "
            "trace\n"
            "lat = cs.main_lattice(snt, *cs.MAIN)\n"
            "lat.run_lattice(cs.TRACE_STEPS)\n"
            f"with trace({folder!r}) as tr:\n"
            "    lat.run_lattice(cs.TRACE_STEPS)\n"
            "print(tr.path)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"the traced process failed: "
          f"{proc.stderr[-2000:]}")
    return proc.stdout.strip().splitlines()[-1]


def profiling_phase(snt, smi):
    """50. `StepTimer` on the 512^2 main path, and `trace` around one
    64-step call: the Chrome trace holds the persistent kernel's records
    (late in a long process the profiler can keep no kernel record at all,
    so after two such traces the next are taken in a fresh process)."""
    from spiking_neural_networks_tpu_torch.utils.profiling import (StepTimer,
                                                                   trace)
    import tempfile
    lat = main_lattice(snt, *MAIN)
    r = StepTimer(lat).measure(TIMER_STEPS)
    check(lat._last_run_fused == ("kernel", False), "StepTimer's route")
    say(f"[50 profiling] StepTimer {MAIN[0]}^2 x {TIMER_STEPS}: "
        f"{r['neuron_updates_per_sec']:.4e} neuron-updates/s, "
        f"{r['step_time_us']:.3f} us/step | {smi}")
    with tempfile.TemporaryDirectory() as folder:
        where = "this process"
        for attempt in range(PROF_TRIES):
            if attempt < 2:
                with trace(folder) as tr:
                    lat.run_lattice(TRACE_STEPS)
                path = tr.path
            else:
                path, where = fresh_trace(folder), "a fresh process"
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            recs = sum(1 for e in events if e.get("cat") == "kernel"
                       and "model_persistent_kernel" in e.get("name", ""))
            if recs:
                break
            say(f"[profiler] the trace kept no kernel record; tracing again")
        size = os.path.getsize(path)
    check(recs >= 1, "the trace holds no model_persistent_kernel record")
    say(f"[50 profiling] trace() around run_lattice({TRACE_STEPS}) in "
        f"{where}: {recs} model_persistent_kernel records, {len(events)} "
        f"events, {size} bytes")


# ---------------------------------------------------------------------------
# The parallel package: phases 51-55
# ---------------------------------------------------------------------------

# (shape, steps, per-neuron parameters, the design each block takes): the
# sharded composition's three forms over SHARDS virtual shards
SHARDS = 4
SHARD_MAINS = ((MAIN, MAIN_STEPS, False, "persistent"),
               ((4096, 4096), 64, False, "tiled"),
               (BIG, HETERO_STEPS, True, "per_step"))
SHARD_PLAIN_STEPS = 256
# steps of phase 51's plain-route timing (the per-block twin's
# counterpart: `lattice_step` per block), after one step that rebuilds
# the blocks with the plain route's ghost rows
SHARD_TWIN_STEPS = 16
PIPE_STAGES, PIPE_STEPS, PIPE_REWARD_STEPS = 4, 512, 256
BATCH, BATCH_N, BATCH_STEPS = 8, 1024, 16


def timed_run(run, n):
    """``run()`` (``n`` steps) timed on the host clock and by CUDA events:
    (wall us/step, event us/step)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / n * 1e6,
            start.elapsed_time(end) / n * 1e3)


def state_bits(a, b, keys=None):
    """Elements differing bit for bit over the state leaves ``keys`` (all
    by default) of two lattices."""
    return sum(bits_differ(a.state[k], b.state[k])
               for k in (keys or a.state))


def parallel_phases(snt, smi):
    """51-55: `parallel` on one card through virtual shards.  Returns the
    stencil kernel launches the C entry counted on the sharded main paths
    (phase 51), by design."""
    from spiking_neural_networks_tpu_torch.ops import stencil_kernels as sk
    launches = sharded_main_phase(snt, sk, smi)
    sharded_plain_phase(snt, smi)
    pipeline_phase(snt, smi)
    batched_phase(snt, smi)
    multihost_phase(snt)
    return launches


def sharded_main_phase(snt, sk, smi):
    """51. The sharded composition: each of `SHARD_MAINS` built once and
    copied, run unsharded through the stencil kernel route and sharded
    over `SHARDS` virtual shards of cuda:0 (one `StencilRun` call per
    block per K steps, ghost rows refreshed between calls), the sharded
    run with the counts set to 0 just before it and read just after, held
    bit for bit against the unsharded one."""
    import copy
    from spiking_neural_networks_tpu_torch.parallel import make_lattice_mesh
    mesh = make_lattice_mesh(SHARDS, devices=[torch.device("cuda", 0)]
                             * SHARDS)
    launches = {"persistent": 0, "tiled": 0, "per_step": 0}
    for shape, steps, hetero, design in SHARD_MAINS:
        ref = (hetero_lattice if hetero else main_lattice)(snt, *shape)
        lat = copy.deepcopy(ref)
        # the tiled blocks on the 2-D tiles too, timed in turns below
        tiles_run = copy.deepcopy(ref) if design == "tiled" else None
        ref.run_lattice(steps)
        check(ref._last_run_fused == ("kernel", False),
              f"{shape}: the unsharded run missed the kernel route")
        lat.shard(mesh)
        reset_stencil_counts(sk)
        lat.run_lattice(steps)
        torch.cuda.synchronize()
        calls, counted = sk.LAUNCHES, sk.STEP_LAUNCHES
        designs, streamed = dict(sk.DESIGN_CALLS), sk.STREAMED_CALLS
        launches[design] += counted
        tag, block_designs, k_steps, ghost = lat._last_run_fused
        blocks = lat.blocks
        overlap = [(b.ext[1] - b.ext[0]) / (b.rows[1] - b.rows[0])
                   for b in blocks]
        nbits = state_bits(ref, lat)
        first = {k: x.clone() for k, x in lat.state.items()}
        fired = int((lat.state["last_firing_time"] >= 0).sum())
        # timed runs from the checked state, in turns: unsharded, sharded,
        # sharded, unsharded
        turns = [timed_run(lambda x=x: x.run_lattice(steps), steps)
                 for x in (ref, lat, lat, ref)]
        wall_u, ev_u = ((a + b) / 2 for a, b in zip(turns[0], turns[3]))
        wall_s, ev_s = ((a + b) / 2 for a, b in zip(turns[1], turns[2]))
        lat.use_kernel = False
        lat.run_lattice(1)
        wall_p, ev_p = timed_run(lambda: lat.run_lattice(SHARD_TWIN_STEPS),
                                 SHARD_TWIN_STEPS)
        check(lat._last_run_fused is False, "use_kernel=False took a kernel")
        say(f"[51 sharded] {shape[0]}x{shape[1]}"
            f"{' per-neuron a, d, v_th' if hetero else ''} run_lattice"
            f"({steps}) over {SHARDS} virtual shards of cuda:0: route "
            f"{(tag, block_designs, k_steps, ghost)}, blocks "
            f"{[(b.rows, b.ext) for b in blocks]}, overlap "
            f"{[round(x, 4) for x in overlap]}, calls by design {designs}, "
            f"kernel calls {calls}, kernel launches counted by the C entry "
            f"{counted}; bits differing from the unsharded kernel route "
            f"{nbits}, fired {fired} of {lat.n}; us/step wall / CUDA events "
            f"(a further run of each, in turns): sharded {wall_s:.2f} / "
            f"{ev_s:.2f}, unsharded {wall_u:.2f} / {ev_u:.2f}; the plain "
            f"route per block (use_kernel=False, {SHARD_TWIN_STEPS} steps) "
            f"{wall_p:.2f} / {ev_p:.2f} ({smi})")
        n_calls = SHARDS * math.ceil(steps / k_steps)
        plan = sk.tiled_plan((blocks[0].ext[1] - blocks[0].ext[0], shape[1]),
                             lat.graph.offsets,
                             sk.model_kernels.sm_count(torch.device("cuda"))) \
            if design == "tiled" else None
        per_call = sk.call_launches(k_steps, design, plan)
        if design == "tiled":
            check(streamed == calls,
                  f"{shape}: {streamed} of {calls} sharded calls took the "
                  f"streamed plan")
            # the same sharded run on the 2-D tiles (the tiled plan
            # replaced while its blocks build their runs), in turns
            real = sk.tiled_plan
            sk.tiled_plan = lambda shape, offsets, n_sm: tiles2d(sk, offsets)
            try:
                tiles_run.shard(mesh)
                tiles_run.run_lattice(steps)
            finally:
                sk.tiled_plan = real
            check(sum(bits_differ(first[k], tiles_run.state[k])
                      for k in first) == 0,
                  f"{shape}: the sharded 2-D tiles differ")
            # the blocks keep their runs (and plans) while their state is
            # the one the run left; lat, back from the plain route's timing,
            # builds streamed ones on a first untimed run
            lat.use_kernel = None
            lat.run_lattice(steps)
            runs = [lambda: lat.run_lattice(steps),
                    lambda: tiles_run.run_lattice(steps)]
            t = [timed_run(runs[j], steps) for j in (0, 1, 1, 0)]
            say(f"[51 sharded] {shape[0]}x{shape[1]} over {SHARDS} shards, "
                f"the tiled blocks in turns, us/step wall / CUDA events: "
                f"streamed plan ({plan}) {(t[0][0] + t[3][0]) / 2:.2f} / "
                f"{(t[0][1] + t[3][1]) / 2:.2f}, 2-D tiles "
                f"({tiles2d(sk, lat.graph.offsets)}) "
                f"{(t[1][0] + t[2][0]) / 2:.2f} / "
                f"{(t[1][1] + t[2][1]) / 2:.2f} ({smi})")
            del tiles_run
        check(tag == "sharded" and set(block_designs) == {design}
              and (k_steps, ghost) == (16, 32),
              f"{shape}: the sharded run took {lat._last_run_fused}")
        check(calls == designs[design] == n_calls
              and counted == n_calls * per_call,
              f"{shape}: {calls} calls / {counted} launches, expected "
              f"{n_calls} / {n_calls * per_call}")
        check(nbits == 0 and fired > 0
              and bool(torch.isfinite(lat.state["v"]).all()),
              f"{shape}: the sharded run differs from the unsharded one")
        del ref, lat
        torch.cuda.empty_cache()
    return launches


def sharded_plain_phase(snt, smi):
    """52. The sharded plain route: the 512^2 STDP lattice over
    `SHARDS` virtual shards (`lattice_step` per block, a ghost refresh of
    the state and weights each step) against the unsharded plain route."""
    import copy
    from spiking_neural_networks_tpu_torch.parallel import make_lattice_mesh
    ref = stdp_lattice(snt, *MAIN, use_kernel=False)
    lat = copy.deepcopy(ref)
    lat.use_kernel = None
    w0 = ref.graph.weights.clone()
    wall_u, ev_u = timed_run(lambda: ref.run_lattice(SHARD_PLAIN_STEPS),
                             SHARD_PLAIN_STEPS)
    lat.shard(make_lattice_mesh(SHARDS, devices=[torch.device("cuda", 0)]
                                * SHARDS))
    wall_s, ev_s = timed_run(lambda: lat.run_lattice(SHARD_PLAIN_STEPS),
                             SHARD_PLAIN_STEPS)
    nbits = state_bits(ref, lat)
    wbits = bits_differ(ref.graph.weights, lat.graph.weights)
    moved = int((lat.graph.weights != w0).sum())
    say(f"[52 sharded plain] {MAIN[0]}x{MAIN[1]} STDP run_lattice"
        f"({SHARD_PLAIN_STEPS}) over {SHARDS} virtual shards: route "
        f"{lat._last_run_fused}, ghost rows "
        f"{[b.ext for b in lat.blocks]}, bits differing from the unsharded "
        f"plain route: state {nbits}, weights {wbits}; weights moved "
        f"{moved}; us/step wall / CUDA events: sharded {wall_s:.1f} / "
        f"{ev_s:.1f}, unsharded {wall_u:.1f} / {ev_u:.1f} ({smi})")
    check(lat._last_run_fused is False and nbits == 0 and wbits == 0
          and moved > 0, "the sharded plain route differs from the "
                         "unsharded one")


def pipe_chain(snt, reward, seed=3):
    """A chain of `PIPE_STAGES` 512^2 lattices (radius 2, keep 0.9, gap
    10, v0 uniform in [-65, 30) with 1% at 40 mV from ``default_rng(seed)``)
    linked one to one (weight 3; the host COO lists of ``a == b``), plain,
    or with ``reward`` reward lattices, half the neurons with a past firing
    time of 2, and reward-modulated links."""
    rows, cols = MAIN
    n = rows * cols
    rng = np.random.default_rng(seed)
    net = snt.RewardModulatedLatticeNetwork() if reward \
        else snt.LatticeNetwork()
    for k in range(PIPE_STAGES):
        lat = (snt.RewardModulatedLattice if reward else snt.Lattice)(
            snt.Izhikevich(), id=k, device="cuda")
        lat.populate(rows, cols, gap_conductance=10.0)
        lat.connect_stencil(radius=2.0, keep_prob=0.9, seed=seed + k)
        v0 = rng.uniform(-65.0, 30.0, n)
        v0[rng.permutation(n)[:n // 100]] = 40.0
        upd = {"v": torch.as_tensor(v0, dtype=torch.float32, device="cuda")}
        if reward:
            lft = np.full(n, -1, np.int32)
            lft[::2] = 2
            upd["last_firing_time"] = torch.as_tensor(lft, device="cuda")
        lat.apply(lambda s: {**s, **upd})
        lat.use_kernel = False
        (net.add_reward_modulated_lattice if reward else net.add_lattice)(lat)
    for k in range(PIPE_STAGES - 1):
        src, dst, w = one_to_one_coo(n, 3.0 if not reward else 2.0)
        if reward:
            z = np.zeros(n, np.float32)
            net.reward_connections[(k, k + 1)] = (src, dst, w, z, z.copy(),
                                                  np.zeros(n, np.int32))
        else:
            net.connections[(k, k + 1)] = (src, dst, w)
    net.use_kernel = False
    return net


def pipeline_phase(snt, smi):
    """53. A `PIPE_STAGES`-stage chain of 512^2 lattices through the
    pipeline on [cuda:0] * 4 (512 steps), and its R-STDP form (256 steps),
    each against `run_lattices` / `run_lattices_with_reward` with
    ``use_kernel=False`` on the card (rtol 2e-5, atol 2e-4, firing
    agreement above 99%)."""
    import copy
    from spiking_neural_networks_tpu_torch.parallel import make_pipeline_mesh
    mesh = make_pipeline_mesh(PIPE_STAGES,
                              devices=[torch.device("cuda", 0)] * PIPE_STAGES)
    for reward, steps in ((False, PIPE_STEPS), (True, PIPE_REWARD_STEPS)):
        ref = pipe_chain(snt, reward)
        net = copy.deepcopy(ref)
        if reward:
            wall_u, ev_u = timed_run(
                lambda: ref.run_lattices_with_reward(0.005, steps), steps)
            wall_p, ev_p = timed_run(
                lambda: net.run_lattices_with_reward_pipelined(
                    0.005, steps, mesh=mesh), steps)
            lats = lambda x: [x.reward_modulated_lattices[k]
                              for k in range(PIPE_STAGES)]
        else:
            wall_u, ev_u = timed_run(lambda: ref.run_lattices(steps), steps)
            wall_p, ev_p = timed_run(
                lambda: net.run_lattices_pipelined(steps, mesh=mesh), steps)
            lats = lambda x: [x.lattices[k] for k in range(PIPE_STAGES)]
        dv, agree, fired, nbits = 0.0, 1.0, 0, 0
        for a, b in zip(lats(ref), lats(net)):
            torch.testing.assert_close(b.state["v"], a.state["v"], rtol=2e-5,
                                       atol=2e-4)
            dv = max(dv, (a.state["v"] - b.state["v"]).abs().max().item())
            fa = a.state["last_firing_time"] >= 0
            fb = b.state["last_firing_time"] >= 0
            agree = min(agree, (fa == fb).float().mean().item())
            fired += int(fa.sum())
            nbits += state_bits(a, b) + bits_differ(a.graph.weights,
                                                    b.graph.weights)
        say(f"[53 pipeline] {PIPE_STAGES} stages of {MAIN[0]}x{MAIN[1]}"
            f"{' R-STDP (reward 0.005)' if reward else ''}, {steps} steps on "
            f"[cuda:0] x {PIPE_STAGES}: max|dv| {dv:.3g} mV against the "
            f"structured plain route, firing agreement {agree:.6f}, fired "
            f"{fired}, bits differing {nbits}"
            f"{f', dopamine {net.dopamine:.6g} vs {ref.dopamine:.6g}' if reward else ''}"
            f"; us/step wall / CUDA events: pipeline {wall_p:.1f} / "
            f"{ev_p:.1f}, structured {wall_u:.1f} / {ev_u:.1f} ({smi})")
        check(agree > 0.99 and fired > 0 and net.internal_clock == steps,
              "the pipeline differs from the structured runner")
        if reward:
            check(abs(net.dopamine - ref.dopamine)
                  <= 1e-5 * abs(ref.dopamine), "the dopamine differs")
        del ref, net


def batched_phase(snt, smi):
    """54. The batched (dp, tp) step: B = 8, N = 1024 over dp = 2, tp = 2
    virtual shards for 16 steps against the unsharded step (a (1, 1) mesh;
    the column products sum in another order: rtol 1e-5, atol 1e-4); then
    a further run of each, in turns, timed."""
    from spiking_neural_networks_tpu_torch.parallel import sharding
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-65, 30, (BATCH, BATCH_N)).astype(np.float32)
    v0[:, ::5] = 40.0
    lft = np.full((BATCH, BATCH_N), -1, np.int32)
    lft[:, 1::3] = 5
    mask = rng.random((BATCH, BATCH_N, BATCH_N)) < 0.05
    w = (rng.uniform(0.5, 1.5, mask.shape) * mask).astype(np.float32)
    cuda = torch.device("cuda", 0)
    runs = {}
    for name, mesh in (
            ("sharded", sharding.make_mesh(4, dp=2, devices=[cuda] * 4)),
            ("whole", sharding.make_mesh(1, devices=[cuda]))):
        st = sharding.batched_state(snt.Izhikevich(), BATCH, BATCH_N,
                                    device="cuda", gap_conductance=10.0)
        st["v"] = torch.as_tensor(v0, device="cuda")
        st["last_firing_time"] = torch.as_tensor(lft, device="cuda")
        st, tw, tmask = sharding.shard_batched_inputs(
            mesh, st, torch.as_tensor(w, device="cuda"),
            torch.as_tensor(mask, device="cuda"))
        step, rule = sharding.make_sharded_training_step(mesh,
                                                         snt.Izhikevich())

        def run(st=st, tw=tw, tmask=tmask, step=step, rule=rule):
            s, ww = st, tw
            for clock in range(BATCH_STEPS):
                s, ww, spk = step(s, ww, tmask, clock, rule.params)
            return s, ww, spk
        runs[name] = run
    out = {name: run() for name, run in runs.items()}
    (ss, ws, spk), (su, wu, _) = out["sharded"], out["whole"]
    vs, vu, ws, wu = ss["v"].whole(), su["v"].whole(), ws.whole(), wu.whole()
    turns = [timed_run(runs[n], BATCH_STEPS)
             for n in ("sharded", "whole", "whole", "sharded")]
    wall_s, ev_s = ((a + b) / 2 for a, b in zip(turns[0], turns[3]))
    wall_u, ev_u = ((a + b) / 2 for a, b in zip(turns[1], turns[2]))
    dv, dw = (vs - vu).abs().max().item(), (ws - wu).abs().max().item()
    moved = int((ws != torch.as_tensor(w, device="cuda")).sum())
    say(f"[54 batched] B={BATCH} N={BATCH_N} dp=2 tp=2 virtual shards, "
        f"{BATCH_STEPS} steps: max|dv| {dv:.3g}, max|dw| {dw:.3g} against "
        f"the unsharded step, weights moved {moved}, last step's spikes "
        f"{int(spk.whole().sum())}; us/step wall / CUDA events (a further "
        f"run of each, in turns): sharded {wall_s:.1f} / {ev_s:.1f}, "
        f"unsharded {wall_u:.1f} / {ev_u:.1f} ({smi})")
    torch.testing.assert_close(vs, vu, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ws, wu, rtol=1e-5, atol=1e-4)
    check(moved > 0, "the batched step moved no weight")


def multihost_phase(snt):
    """55. One host: `initialize` is a no-op without a coordinator, and the
    hybrid mesh is (1, n_local)."""
    import torch.distributed as dist
    from spiking_neural_networks_tpu_torch.parallel import (
        initialize_multihost, make_hybrid_mesh)
    initialize_multihost()
    mesh = make_hybrid_mesh()
    n_local = torch.cuda.device_count()
    say(f"[55 multihost] initialize(): process group "
        f"{dist.is_initialized()}; make_hybrid_mesh(): {mesh.shape}")
    check(not dist.is_initialized()
          and mesh.shape == {"dp": 1, "tp": n_local},
          "one host: initialize must be a no-op and the mesh (1, n_local)")


# ---------------------------------------------------------------------------
# The science pipelines of `experiments/` through lixirnet and the core:
# phases 56-59
# ---------------------------------------------------------------------------

EXP_TWIN_CALLS = 2      # of each kernel pipeline's main run, held to the twin
# steps profiled on a kernel / the plain route: a plain step of a ring
# network launches ~700 kernels, and a profile of many thousands of records
# leaves the profiler losing records in the phases after this family
EXP_PROFILE = (256, 4)


class NetProbe:
    """Around a pipeline's entry point: patches the port's core
    `LatticeNetwork.run_lattices` to keep each network the pipeline runs,
    set its ``use_kernel``, record each run's route and time each run
    between two synchronisations; and `network_kernels.network_steps` to
    hold the first ``twin_calls`` kernel calls on the card against the
    twin (`network_steps_reference` on copies of the same inputs, uniforms
    included).  Restores both on exit."""

    def __init__(self, use_kernel=None, twin_calls=0):
        self.use_kernel, self.twin_left = use_kernel, twin_calls
        self.nets, self.runs, self.routes = [], [], []
        self.twin_calls, self.twin_bits = 0, []

    def __enter__(self):
        from spiking_neural_networks_tpu_torch.core import network as cn
        from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
        self.cn, self.nk = cn, nk
        self.saved = (cn.LatticeNetwork.run_lattices, nk.network_steps)
        run, steps = self.saved
        probe = self

        def run_lattices(net, n):
            if not any(net is x for x in probe.nets):
                probe.nets.append(net)
            net.use_kernel = probe.use_kernel
            cuda = on_card(net)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(net, n)
            if cuda:
                torch.cuda.synchronize()
            probe.runs.append((t0, time.perf_counter(), int(n)))
            probe.routes.append(net._last_run_fused)

        def network_steps(spec, lats, trains, conns, uniforms, rule, clock0,
                          n_steps, reward=None, **kw):
            args = (spec, lats, trains, conns, uniforms, rule)
            if probe.twin_left <= 0 or not lats[0]["v"].is_cuda:
                return steps(*args, clock0, n_steps, reward, **kw)
            want = nk.network_steps_reference(*cloned(args), clock0, n_steps,
                                              cloned(reward))
            got = steps(*args, clock0, n_steps, reward, **kw)
            probe.twin_bits += bit_mismatches(got, want)
            probe.twin_calls += 1
            probe.twin_left -= 1
            return got

        cn.LatticeNetwork.run_lattices = run_lattices
        nk.network_steps = network_steps
        return self

    def __exit__(self, *exc):
        self.cn.LatticeNetwork.run_lattices, self.nk.network_steps = \
            self.saved

    def call(self, fn):
        """``fn()`` with its seconds of construction (up to the first run),
        run (the runs between their synchronisations) and analysis (the
        rest); returns (output, split, steps run).  An entry point with no
        run (a model's step loop, the discrete attractor) counts whole as
        run."""
        self.runs.clear()
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        if not self.runs:
            return out, (0.0, t3 - t0, 0.0), 0
        run = sum(b - a for a, b, _ in self.runs)
        built = self.runs[0][0] - t0
        return out, (built, run, t3 - t0 - built - run), \
            sum(n for _, _, n in self.runs)


def on_card(net):
    return next(iter(net.lattices.values())).state["v"].is_cuda


def exp_toml(folder, name):
    from spiking_neural_networks_tpu_torch.experiments.pipeline_setup \
        import parse_toml
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "experiments", folder, name), "rb") as f:
        return parse_toml(f)


def exp_schizophrenia(mod, device, cmp, forced):
    """`gmax_with_recall_cue.toml`'s first grid point and first trial as
    `main` makes them: 2000 + 3000 steps (cmp: 100 + 50)."""
    parsed = exp_toml("schizophrenia_pipeline_args",
                      "gmax_with_recall_cue.toml")
    mod.fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    if cmp:
        sp.update(iterations1=100, iterations2=50, first_window=50,
                  second_window=40)
    if forced:
        sp["cue_firing_rate"] = 1.0
    rng = np.random.default_rng(sp["seed"])
    patterns = mod.generate_patterns(sp["exc_n"] ** 2, 0.5,
                                     sp["num_patterns"],
                                     sp["correlation_threshold"], rng=rng)
    cs = {k: parsed["variables"][k][0] for k in mod.KEYS}
    with np.errstate(divide="ignore", invalid="ignore"):
        value, p1, p2 = mod.run_trial(sp, cs, patterns, rng, device=device)
    return dict(value, patterns=[p1, p2])


def exp_dopamine(mod, device, cmp, forced):
    """`d1_exc_glu_clearance.toml`'s first grid point as `run_grid` runs
    it: off 5000, on 1000, off 5000 steps (cmp: 80, 40, 80)."""
    parsed = exp_toml("dopamine_liquid_args", "d1_exc_glu_clearance.toml")
    mod.fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    cs = {k: v[0] for k, v in parsed["variables"].items()}
    if cmp:
        sp.update(off_phase=80, on_phase=40, settling_period=30)
    if forced:
        cs.update(cue_firing_rate=1.0, dopamine_firing_rate=1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return mod._run_grid_point(sp, cs, np.random.default_rng(0), device)


def exp_bayes(mod, device, cmp, forced):
    """The defaults' first trial as `main` makes it: 1500 steps (cmp:
    120)."""
    p = dict(mod.DEFAULTS["simulation_parameters"])
    if cmp:
        p["iterations"] = 120
    if forced:
        p.update(main_firing_rate=1.0, bayesian_firing_rate=1.0)
    rng = np.random.default_rng(p["seed"])
    patterns = mod.generate_patterns(p["exc_n"] ** 2, p["p_on"],
                                     p["num_patterns"],
                                     p["correlation_threshold"], rng=rng)
    index = int(rng.integers(0, p["num_patterns"]))
    accuracy, counts = mod.run_trial(p, patterns, index, rng, p["d2"],
                                     device=device)
    return dict(pattern_index=index, accuracy=bool(accuracy),
                total_spikes=int(counts.sum()), firing_counts=counts.tolist())


def exp_attractor(mod, device, cmp, forced):
    """`main` at its defaults (3 patterns x 3 trials x 800 steps); cmp:
    one trial of 120 steps."""
    if not cmp:
        mod.main(device=device)
        with open(mod.output_path("attractor_manifold_output.json")) as f:
            return json.load(f)
    rng = np.random.default_rng(0)
    patterns = mod.generate_patterns(49, 0.5, 3, 10.0, rng=rng)
    w = mod.get_weights(49, patterns, a=0.5, b=0.5, scalar=2.0 / 3)
    w_ie = mod.weights_ie(3, 0.5, patterns, 3)
    traj = mod.run_trial(w, w_ie, patterns, 0, 7, 3, rng, iterations=120,
                         cue_firing_rate=1.0 if forced else 0.01,
                         device=device)
    return dict(trajectory=traj.tolist())


def exp_grid_ec(mod, device, cmp, forced):
    return mod.main(iterations=120 if cmp else 3000, device=device)


def exp_grid(mod, device, cmp, forced):
    center, d = mod.main(iterations=120 if cmp else 2000, device=device)
    return dict(center=list(center), distance=float(d))


def exp_heuristic(mod, device, cmp, forced):
    """`main` with 4 search iterations (8 evaluations of the objective, a
    6 x 6 lattice and its Poisson drive over 400 steps); cmp: one
    evaluation of 120 steps."""
    if not cmp:
        return mod.main(search_iterations=4, device=device)
    return dict(score=mod.firing_rate_objective(
        dict(drive_rate=1.0 if forced else 0.1, drive_weight=1.5),
        iterations=120, device=device))


def exp_liquid(mod, device, cmp, forced):
    """`glu_clearance.toml`'s first grid point: off 5000, on 1000, off
    5000 steps (cmp: 60, 30, 60)."""
    parsed = exp_toml("isolated_liquid_args", "glu_clearance.toml")
    mod.fill_defaults(parsed)
    sp = parsed["simulation_parameters"]
    cs = {k: v[0] for k, v in parsed["variables"].items()}
    if cmp:
        sp.update(off_phase=60, on_phase=30, settling_period=20)
    if forced:
        cs["cue_firing_rate"] = 1.0
    with np.errstate(divide="ignore", invalid="ignore"):
        return mod.run_trial(sp, cs, np.random.default_rng(sp["seed"]),
                             device)


def exp_no_turning(mod, device, cmp, forced):
    return mod.main(iterations=60 if cmp else 3000,
                    cue_iterations=60 if cmp else 2000, device=device)


def exp_tem(mod, device, cmp, forced):
    """`main` at its widths (12 positions, 4 objects, 40 steps a visit),
    its walk cut from 60 visits to 1 an environment."""
    return mod.main(n_pos=12, n_obj=4, walk_steps=1, steps_per_visit=40,
                    device=device)


def exp_hd_dopa(mod, device, cmp, forced):
    return mod.main(iterations=100, device=device)


def exp_hd(mod, device, cmp, forced):
    return mod.main(iterations=200, device=device)


def exp_basin(mod, device, cmp, forced):
    return mod.main(iterations=100, cue_iterations=100, device=device)


def exp_hd_attractor(mod, device, cmp, forced):
    return dict(positions=mod.main(iterations=200, device=device))


# (module, runner, the route both gates give every run at these widths
# (tests/test_torch_experiments_*.py), the kernels-line row, the output's
# keys)
EXP_KERNEL = (
    ("schizophrenia_simulation", exp_schizophrenia, "flat-chemical",
     "6b-flat", {"first_acc", "second_acc", "first_snr", "second_snr",
                 "peaks", "patterns"}),
    ("dopamine_liquid_interaction", exp_dopamine, "flat-chemical", "6b-flat",
     {"return_to_baseline", "voltages", "first_snr", "second_snr",
      "during_disturbance", "peaks"}),
    ("bayesian_inference_pipeline", exp_bayes, "flat-chemical", "6b-flat",
     {"pattern_index", "accuracy", "total_spikes", "firing_counts"}),
    ("attractor_manifold", exp_attractor, "flat-chemical", "6b-flat",
     {"embedding", "labels", "within", "between", "explained_variance",
      "patterns"}),
    ("grid_cell_electrochemical", exp_grid_ec, "flat-chemical", "6b-flat",
     {"center", "target", "toroidal_distance", "total_spikes"}),
    ("grid_cell_model", exp_grid, "flat", "6b-flat", {"center", "distance"}),
    ("heuristic_parameter_search", exp_heuristic, "network", "6b",
     {"target", "best_params", "best_score", "n_evaluations", "trace"}),
    ("isolated_liquid_pipeline", exp_liquid, "flat-chemical", "6b-flat",
     {"return_to_baseline", "voltages", "first_snr", "second_snr",
      "during_disturbance"}),
    ("hd_electrochemical_model_no_turning", exp_no_turning, "flat-chemical",
     "6b-flat", {"angle", "cued_theta", "held_theta", "drift", "peaks"}),
)
EXP_PLAIN = (
    ("tolman_eichenbaum", exp_tem, False, None,
     {"env0_accuracy", "env1_accuracy", "chance", "n_positions",
      "n_objects", "walk_steps", "seed"}),
    ("hd_electrochemical_model_dopaminergic", exp_hd_dopa, False, None,
     {"peaks", "thetas", "parameters"}),
    ("hd_electrochemical_model", exp_hd, False, None,
     {"peaks", "thetas", "parameters"}),
    ("hd_with_basin", exp_basin, False, None,
     {"basin", "cue_angle", "cued_theta", "final_theta",
      "dist_to_basin_start", "dist_to_basin_end", "peaks"}),
    ("hd_attractor", exp_hd_attractor, False, None, {"positions"}),
)


def exp_histories(probe):
    """Every grid history of the probe's networks, in order: a list of
    (T, N) float64 arrays."""
    out = []
    for net in probe.nets:
        for i in sorted(net.lattices):
            lat = net.lattices[i]
            if lat.update_grid_history and lat.grid_history.history:
                h = np.stack([np.asarray(x) for x in
                              lat.grid_history.history])
                out.append(h.reshape(len(h), -1).astype(np.float64))
    return out


def exp_lfts(probe):
    return [l.state["last_firing_time"].cpu().numpy().astype(np.int64)
            for net in probe.nets for _, l in sorted(net.lattices.items())]


def exp_finite(probe):
    return all(bool(torch.isfinite(x).all()) for net in probe.nets
               for m in list(net.lattices.values())
               + list(net.spike_train_lattices.values())
               for x in m.state.values() if x.is_floating_point())


def exp_route_names(probe):
    return [r[0] if r else False for r in probe.routes]


def experiment_phases(snt, smi):
    """Phases 56-59.  Returns the launches of the persistent network
    kernel per kernel pipeline, by kernels-line row ("6b", "6b-flat")."""
    import importlib
    import tempfile
    from spiking_neural_networks_tpu_torch import lixirnet as ln
    from spiking_neural_networks_tpu_torch.ops import network_kernels as nk
    mods = {name: importlib.import_module(
        f"spiking_neural_networks_tpu_torch.experiments.{name}")
        for name, *_ in EXP_KERNEL + EXP_PLAIN}
    for name, mod in mods.items():
        check(getattr(mod, "ln", ln) is ln,
              f"{name} does not use the port's lixirnet")
    with tempfile.TemporaryDirectory() as out_dir:
        saved = {name: mod.output_path for name, mod in mods.items()
                 if hasattr(mod, "output_path")}
        for name in saved:
            mods[name].output_path = (
                lambda n: os.path.join(out_dir, os.path.basename(n)))
        try:
            cases = exp_routes_phase(mods)
            launches = exp_kernel_phase(nk, mods, cases)
            exp_plain_phase(mods, cases)
            exp_times_phase(mods, cases, smi)
        finally:
            for name, path in saved.items():
                mods[name].output_path = path
    return launches


def exp_routes_phase(mods):
    """56. Each pipeline's networks built on the card and run: the kernel
    pipelines at their comparison depth with every chance of firing forced
    to 0 or 1 (`exp_*`, ``cmp``), the plain ones at their cut depth; each
    run's route printed and held to the route both gates give on the CPU
    (`EXP_KERNEL`, `EXP_PLAIN`).  Returns each pipeline's probe and
    output."""
    cases = {}
    for name, fn, route, row, _ in EXP_KERNEL + EXP_PLAIN:
        kernel = row is not None
        with NetProbe() as probe:
            out, split, steps = probe.call(
                lambda: fn(mods[name], "cuda", kernel, kernel))
        routes = exp_route_names(probe)
        say(f"[56 routes] {name}: {len(probe.nets)} networks, "
            f"{len(routes)} runs, {steps} steps on the card: routes "
            f"{sorted(set(map(str, routes)))} (both gates on the CPU: "
            f"{route}); construction {split[0]:.3f} s, run {split[1]:.3f} s,"
            f" analysis {split[2]:.3f} s")
        check(routes and all(r == route for r in routes),
              f"{name}: the runs took {routes}, not {route}")
        cases[name] = dict(probe=probe, out=out, split=split, steps=steps)
    return cases


def exp_kernel_phase(nk, mods, cases):
    """57. Each kernel pipeline at its users' depth on the card, the
    network kernel's counts set to 0 just before it and read just after:
    every run on its route, every call through the persistent kernel (the
    C entry's count), the first `EXP_TWIN_CALLS` calls bit-equal to the
    twin, every state finite, neurons fired, the output's keys the JAX
    script's.  Then its comparison run (chances 0 or 1) on the CPU's twin
    route (``use_kernel=True``): every grid history, firing time and the
    output equal to the card's (phase 56) bit for bit; and on the card's
    plain route (``use_kernel=False``), which sums in another order:
    max |dv|, the first step past `DRIFT`, the outputs.  Returns the
    persistent launches by row and pipeline."""
    K = nk.STEPS_PER_LAUNCH
    launches = {"6b": {}, "6b-flat": {}}
    for name, fn, route, row, keys in EXP_KERNEL:
        mod = mods[name]
        with NetProbe(twin_calls=EXP_TWIN_CALLS) as probe:
            nk.LAUNCHES = nk.CHEM_LAUNCHES = nk.FLAT_LAUNCHES = 0
            nk.PERSISTENT_LAUNCHES = 0
            out, split, steps = probe.call(
                lambda: fn(mod, "cuda", False, False))
            calls = (nk.LAUNCHES, nk.FLAT_LAUNCHES, nk.PERSISTENT_LAUNCHES)
        routes = exp_route_names(probe)
        min_calls = sum(-(-n // K) for _, _, n in probe.runs)
        fired = sum(int((l.state["last_firing_time"] >= 0).sum())
                    for net in probe.nets for l in net.lattices.values())
        finite = exp_finite(probe)
        say(f"[57 main path] {name}: {len(probe.nets)} networks, "
            f"{len(routes)} runs, {steps} steps: routes "
            f"{sorted(set(map(str, routes)))}, kernel calls {calls[0]} "
            f"(flat {calls[1]}, persistent launches counted by the C entry "
            f"{calls[2]}), the first {probe.twin_calls} against the twin: "
            f"outputs not bit-equal {probe.twin_bits}; state finite "
            f"{finite}, neurons fired {fired}; output keys "
            f"{sorted(out)}; construction {split[0]:.3f} s, run "
            f"{split[1]:.3f} s, analysis {split[2]:.3f} s")
        check(all(r == route for r in routes), f"{name}: took {routes}")
        check(calls[0] >= min_calls and calls[2] == calls[0]
              and calls[1] == (calls[0] if row == "6b-flat" else 0),
              f"{name}: a kernel call missed the persistent kernel")
        check(probe.twin_calls == EXP_TWIN_CALLS and probe.twin_bits == [],
              f"{name}: the kernel differs from its twin")
        check(finite and fired > 0, f"{name}: non-finite state or no spike")
        check(set(out) == keys, f"{name}: output keys {sorted(out)}")
        launches[row][name] = calls[2]

        card = cases[name]
        with NetProbe(use_kernel=True) as cpu:
            cpu_out, _, _ = cpu.call(lambda: fn(mod, "cpu", True, True))
        hk, hc = exp_histories(card["probe"]), exp_histories(cpu)
        dv = max(float(np.abs(a - b).max()) for a, b in zip(hk, hc))
        lft = all(np.array_equal(a, b) for a, b in
                  zip(exp_lfts(card["probe"]), exp_lfts(cpu)))
        with NetProbe(use_kernel=False) as plain:
            plain_out, _, _ = plain.call(lambda: fn(mod, "cuda", True, True))
        hp = exp_histories(plain)
        d = [np.abs(a - b).max(axis=1) for a, b in zip(hk, hp)]
        parted = [int(np.argmax(x > DRIFT)) if (x > DRIFT).any() else None
                  for x in d]
        outside = sum(int((np.abs(a - b) > 2.0).any(axis=0).sum())
                      for a, b in zip(hk, hp))
        say(f"[57 kernel-vs-cpu] {name}: {card['steps']} steps, chances 0 "
            f"or 1, against the CPU's twin route "
            f"{sorted(set(map(str, exp_route_names(cpu))))}: max|dv| {dv:.4g}"
            f" mV over {len(hk)} grid histories, firing times equal {lft}, "
            f"outputs equal {cpu_out == card['out']}")
        say(f"[57 kernel-vs-plain] {name}: the same run on the card's plain "
            f"route (use_kernel=False, routes "
            f"{sorted(set(map(str, exp_route_names(plain))))}): max|dv| "
            f"{max(float(x.max()) for x in d):.4g} mV, first step past "
            f"{DRIFT} mV per history {parted}, neurons ever outside 2 mV "
            f"{outside}, state finite {exp_finite(plain)}, outputs equal "
            f"{plain_out == card['out']}")
        check(len(hk) == len(hc) == len(hp) > 0 and dv == 0.0 and lft
              and cpu_out == card["out"],
              f"{name}: the card's kernel route differs from the CPU's")
        check(exp_route_names(plain) == [False] * len(plain.routes)
              and exp_finite(plain), f"{name}: the plain route failed")
        del cpu, plain
    return launches


def exp_plain_phase(mods, cases):
    """58. Each plain pipeline's run (phase 56, its cut depth) against the
    same run on the CPU: the output's keys the JAX script's, every state
    finite, neurons fired, every grid history within 2 mV and every firing
    time within 2 steps (the reference's criterion, `BASELINE.md`,
    `gpu_accuracy.rs:35-37`; the Rate trains draw nothing)."""
    for name, fn, _, _, keys in EXP_PLAIN:
        card = cases[name]
        with NetProbe() as cpu:
            cpu_out, _, _ = cpu.call(lambda: fn(mods[name], "cpu", False,
                                                False))
        hk, hc = exp_histories(card["probe"]), exp_histories(cpu)
        dv = max(float(np.abs(a - b).max()) for a, b in zip(hk, hc))
        dl = max(int(np.abs(a - b).max(initial=0)) for a, b in
                 zip(exp_lfts(card["probe"]), exp_lfts(cpu)))
        fired = sum(int((a >= 0).sum()) for a in exp_lfts(card["probe"]))
        finite = exp_finite(card["probe"])
        say(f"[58 plain path] {name}: {len(card['probe'].nets)} networks, "
            f"{card['steps']} steps on the card (route plain), state finite "
            f"{finite}, neurons fired {fired}, output keys {sorted(card['out'])}"
            f"; against the CPU: max|dv| {dv:.4g} mV over {len(hk)} grid "
            f"histories, max |dlft| {dl} steps, outputs equal "
            f"{cpu_out == card['out']}")
        check(set(card["out"]) == keys, f"{name}: output keys")
        check(finite and fired > 0, f"{name}: non-finite state or no spike")
        check(len(hk) == len(hc) > 0 and dv <= 2.0 and dl <= 2,
              f"{name}: card vs CPU outside 2 mV / 2 steps")


def exp_times_phase(mods, cases, smi):
    """59. Each pipeline's main run (for a kernel pipeline, phase 57's
    again without the twin's calls; for a plain one, phase 56's): seconds
    of construction, run and analysis, wall us/step of its runs; then its
    last network run on for `EXP_PROFILE` steps: device us/step under
    torch.profiler (on a kernel route with a warm-up cycle and retries
    until every persistent launch has its record), the wall of the same
    steps unprofiled, device / wall."""
    K = 16
    for name, fn, _, row, _ in EXP_KERNEL + EXP_PLAIN:
        case = cases[name]
        if row:
            with NetProbe() as probe:
                _, split, n_run = probe.call(
                    lambda: fn(mods[name], "cuda", False, False))
            case = dict(probe=probe, split=split, steps=n_run)
        net = case["probe"].nets[-1]
        net.use_kernel = None
        c, r, a = case["split"]
        steps = EXP_PROFILE[0] if row else EXP_PROFILE[1]
        launches = -(-steps // K) if row else None
        wall = run_net_synced(net, steps)
        dev_us, top = profiled_us(lambda: run_net_synced(net, steps), steps,
                                  n_top=3, launches=launches,
                                  mine=("net_persistent",) if row else None)
        wall_us = wall / steps * 1e6
        say(f"[59 times] {name}: {c + r + a:.4f} s (construction {c:.4f} s, "
            f"run {r:.4f} s = {r / case['steps'] * 1e6:.3f} us/step over "
            f"{case['steps']} steps, analysis {a:.4f} s); {steps} more "
            f"steps ({'route ' + str(net._last_run_fused)}): wall "
            f"{wall_us:.3f} us/step, device {dev_us:.3f} us/step (profiled: "
            + ", ".join(f"{k} {t:.3f}" for k, t in top)
            + f"), device / wall {dev_us / wall_us:.3f}; card {smi}")


# ---------------------------------------------------------------------------
# The last entry points: the liquid pipelines of `experiments/` and the
# examples, through lixirnet and the core: phases 60-63
# ---------------------------------------------------------------------------

ENTRY_TWIN_CALLS = 2    # of each kernel path's main run, held to the twin
# the steps of a comparison run (the CPU's twin route, the card's plain
# route) where an entry point takes no depth of its own: every
# `run_lattice` / `run_lattices` call is cut to it
ENTRY_CAP = 500
# further steps profiled, kernel / plain route: few records, since the
# profiler loses more records in the phases after a family that profiles
# much (the stencil main path's count check follows this family)
ENTRY_PROFILE = (64, 2)
# rows whose output is a mean over a lattice taken in the device's order
# (torch's CUDA mean multiplies by 1/N where the CPU's divides): the
# average-voltage traces, the closed loop's rate trajectory
REDUCED_OUTPUTS = {10, 12}


def reduced_gap(card, cpu):
    """The largest difference of two outputs of `REDUCED_OUTPUTS` (dicts
    of arrays or lists of floats), over the CPU's scale."""
    pairs = [(card[k], cpu[k]) for k in cpu] if isinstance(cpu, dict) \
        else [(card, cpu)]
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max()
                     / max(1.0, float(np.abs(np.asarray(b)).max())))
               for a, b in pairs)


def entry_tag(route):
    """A route of the port by kernel family: ``"stencil"``, ``"stdp"``,
    ``"model"``, ``"hh"``, ``"reward"`` (an R-STDP lattice or network on
    its kernel), a network's mode (``"network"``, ``"flat"``, ...), the
    closed loop's tiers ``"6d-a"`` / ``"6d-b"``, or False (plain)."""
    if route is True:
        return "reward"
    if not route:
        return False
    head = route[0] if isinstance(route, tuple) else route
    if head == "env":
        return "6d-a" if route[2] else "6d-b" if route[1] else False
    return {"kernel": "stencil"}.get(head, head)


def force_chances(net):
    """Every spike train's chance of firing of ``net`` raised to 1 where it
    is above 0, so that the draws fire alike on every device."""
    for st in net.spike_train_lattices.values():
        c = st.state.get("chance_of_firing")
        if c is not None:
            st.state = {**st.state,
                        "chance_of_firing": (c > 0).to(c.dtype)}


def tree_bits(got, want):
    """Elements of two nested outputs (tuples, lists, dicts, tensors,
    None) whose bits differ; a shape or structure mismatch counts -1."""
    if isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape:
            return -1
        return bits_differ(got, want.to(got.device))
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return -1
        return sum(tree_bits(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return -1
        return sum(tree_bits(g, w) for g, w in zip(got, want))
    return 0 if (got is None) == (want is None) else -1


def stencil_inputs(run):
    """The (v, w, lft) a `StencilRun`'s next call reads."""
    s = run.sets
    if s.cur is None:
        planes, lft = s.state
        return planes["v"], planes["w"], lft
    return s.bufs["v"][s.cur], s.bufs["w"][s.cur], s.lft_buf[s.cur]


class EntryProbe(NetProbe):
    """`NetProbe`, and around the entries a script reaches without a
    network too: `Lattice.run_lattice`, `RewardModulatedLattice.
    run_lattice_with_reward`, `RewardModulatedLatticeNetwork.
    run_lattices_with_reward` (a host-loop `Environment` step) and
    `JitEnvironment.run_with_reward`: each keeps its object, sets
    ``use_kernel``, is timed between two synchronisations and records its
    route (`entry_tag`); ``cap`` cuts every lattice or network run to that
    many steps; ``force`` raises every train's chance to 0 or 1 before a
    run (`force_chances`).  The first ``twin_calls`` calls of the stencil
    kernel (`StencilRun.steps`) and of the plasticity kernel
    (`lattice_plasticity_steps`) on the card are held against their twins
    on copies of the same inputs.  ``more(n)`` runs ``n`` further steps of
    the last object run."""

    def __init__(self, use_kernel=None, twin_calls=0, cap=None, force=False):
        super().__init__(use_kernel, twin_calls)
        self.cap, self.force = cap, force
        self.objs, self.more = [], None
        self.lat_twin_left = twin_calls
        self.lat_twin_calls, self.lat_twin_bits = 0, 0

    def __enter__(self):
        super().__enter__()
        from spiking_neural_networks_tpu_torch.core import (
            lattice as cl, reward as cr, reward_network as crn)
        from spiking_neural_networks_tpu_torch import interactable as ci
        from spiking_neural_networks_tpu_torch.ops import (
            reward_kernels as rk, stencil_kernels as sk)
        self.targets = [
            (cl.Lattice, "run_lattice"),
            (cr.RewardModulatedLattice, "run_lattice_with_reward"),
            (crn.RewardModulatedLatticeNetwork, "run_lattices_with_reward"),
            (ci.JitEnvironment, "run_with_reward"),
            (sk.StencilRun, "steps"), (rk, "lattice_plasticity_steps"),
            (self.cn.LatticeNetwork, "run_lattices"),
            (self.cn.LatticeNetwork, "run_lattices_pipelined")]
        self.saved_entries = [getattr(o, n) for o, n in self.targets]
        (lat_run, rew_run, rnet_run, env_run, st_steps, lp_steps,
         net_run, pipe_run) = self.saved_entries
        probe = self

        def timed(obj, fn, n, route):
            if not any(obj is x for x in probe.objs):
                probe.objs.append(obj)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            probe.runs.append((t0, time.perf_counter(), int(n)))
            probe.routes.append(route())
            return out

        def cut(n):
            return n if probe.cap is None else min(int(n), probe.cap)

        def run_lattice(lat, n):
            lat.use_kernel = probe.use_kernel
            n = cut(n)
            probe.more = lambda k: lat_run(lat, k)
            return timed(lat, lambda: lat_run(lat, n), n,
                         lambda: lat._last_run_fused)

        def run_reward(lat, reward, n=1):
            lat.use_kernel = probe.use_kernel
            probe.more = lambda k: rew_run(
                lat, np.resize(np.asarray(reward, np.float32), k), k)
            return timed(lat, lambda: rew_run(lat, reward, n), n,
                         lambda: "reward" if lat._last_run_fused else False)

        def run_reward_net(net, reward, n=1):
            net.use_kernel = probe.use_kernel
            if probe.force:
                force_chances(net)
            probe.more = lambda k: rnet_run(net, reward, k)
            return timed(net, lambda: rnet_run(net, reward, n), n,
                         lambda: net._last_run_fused)

        def run_env(env, n):
            env.agent.use_kernel = probe.use_kernel
            probe.more = lambda k: env_run(env, k)
            return timed(env, lambda: env_run(env, n), n,
                         lambda: ("env", env.last_build_fused,
                                  env.last_build_env_fused))

        def run_net(net, n):
            if probe.force:
                force_chances(net)
            probe.more = lambda k: net_run(net, k)
            return net_run(net, cut(n))

        def run_pipelined(net, n, *a, **k):
            probe.more = lambda j: pipe_run(net, j, *a, **k)
            n = cut(n)
            return timed(net, lambda: pipe_run(net, n, *a, **k), n,
                         lambda: False)

        def stencil_steps(run, clock0, n, emit=False):
            if probe.lat_twin_left <= 0 or run.sets.lib is None:
                return st_steps(run, clock0, n, emit)
            v, w, lft = (x.clone() for x in stencil_inputs(run))
            want = sk.izhikevich_stencil_steps_reference(
                v, w, lft, run.sets.weights, run.sets.in_deg, run.params,
                run.sets.offsets, clock0, n, emit)
            got = st_steps(run, clock0, n, emit)
            probe.lat_twin_bits += abs(tree_bits(got, want))
            probe.lat_twin_calls += 1
            probe.lat_twin_left -= 1
            return got

        def plasticity_steps(spec, *a, **k):
            if probe.lat_twin_left <= 0 or not a[0].is_cuda:
                return lp_steps(spec, *a, **k)
            ref = dict(k)
            ref.pop("_per_step", None), ref.pop("_own", None)
            want = rk.lattice_plasticity_steps_reference(
                spec, *cloned(a[:-2]), a[-2], a[-1], **ref)
            got = lp_steps(spec, *a, **k)
            probe.lat_twin_bits += abs(tree_bits(got, want))
            probe.lat_twin_calls += 1
            probe.lat_twin_left -= 1
            return got

        for (o, n), fn in zip(self.targets, (
                run_lattice, run_reward, run_reward_net, run_env,
                stencil_steps, plasticity_steps, run_net, run_pipelined)):
            setattr(o, n, fn)
        return self

    def __exit__(self, *exc):
        for (o, n), fn in zip(self.targets, self.saved_entries):
            setattr(o, n, fn)
        super().__exit__(*exc)

    def tags(self):
        return [entry_tag(r) for r in self.routes]

    def histories(self, reduced=False):
        """Every voltage history of the lattices and networks run, in
        order: (T, N) float64 arrays; with ``reduced``, only the average
        and EEG histories (sums over a lattice, (T, 1)), else only the
        others."""
        out = []
        for obj in self.objs + self.nets:
            lats = getattr(obj, "lattices", None)
            lats = [lats[i] for i in sorted(lats)] if lats is not None \
                else [getattr(obj, "agent", obj)]
            for lat in lats:
                h = getattr(lat, "grid_history", None)
                if getattr(lat, "update_grid_history", False) and h.history \
                        and (h.kind in ("average", "eeg")) == reduced:
                    a = np.asarray(np.stack([np.asarray(x) for x in
                                             h.history]), np.float64)
                    out.append(a.reshape(len(a), -1))
        return out

    def states(self):
        """Every lattice's last firing times and v, in order."""
        out = []
        for obj in self.objs + self.nets:
            lats = getattr(obj, "lattices", None)
            lats = [lats[i] for i in sorted(lats)] if lats is not None \
                else [getattr(obj, "agent", obj)]
            for lat in lats:
                out.append((lat.state["last_firing_time"].cpu().numpy()
                            .astype(np.int64),
                            lat.state["v"].cpu().numpy().astype(np.float64)))
        return out

    def finite(self):
        tensors = []
        for obj in self.objs + self.nets:
            lats = getattr(obj, "lattices", None)
            lats = list(lats.values()) + list(
                obj.spike_train_lattices.values()) if lats is not None \
                else [getattr(obj, "agent", obj)]
            tensors += [x for lat in lats for x in lat.state.values()
                        if x.is_floating_point()]
        return all(bool(torch.isfinite(x).all()) for x in tensors)

    def fired(self):
        return sum(int((lft >= 0).sum()) for lft, _ in self.states())


def entry_toml(folder, name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "experiments", folder, name)


def ent_lsm(m, device, cmp):
    """`main`: 4 conditions x 800 steps (cmp: 100)."""
    return list(m.main(iterations=100 if cmp else 800, device=device))


def ent_lmg(m, device, cmp):
    """`main` (300 on + 500 off; cmp 60 + 40) and `run_grid`'s first grid
    point of ``input_table_test.toml`` (off 5000, on 1000, off 5000; cmp
    60, 40, 60)."""
    snr, var = m.main(on_phase=60 if cmp else 300,
                      off_phase=40 if cmp else 500, device=device)
    from spiking_neural_networks_tpu_torch.experiments.pipeline_setup \
        import parse_toml
    with open(entry_toml("liquid_custom_manifold_args",
                         "input_table_test.toml"), "rb") as f:
        parsed = m.fill_defaults(parse_toml(f))
    sp = parsed["simulation_parameters"]
    if cmp:
        sp.update(off_phase=60, on_phase=40, settling_period=20)
    cs = {k: v[0] for k, v in parsed["variables"].items()}
    with np.errstate(divide="ignore", invalid="ignore"):
        point = m._run_custom_point(sp, cs, np.random.default_rng(0), device)
    return dict(snr=snr, var=[float(x) for x in var], point=point)


def ent_tl(m, device, cmp):
    """``smoke.toml`` through `main` (cmp: `run` with 2 train, 1 test and
    1 exposure sample a class, 40 steps a sample)."""
    if not cmp:
        return m.main(["prog", entry_toml("liquid_mnist_args", "smoke.toml"),
                       "--device", device])
    p = dict(m.DEFAULTS, digits=[0, 1], train_per_class=2, test_per_class=1,
             stdp_exposure_per_class=1, steps_per_sample=40)
    return m.run(p, device)


def ent_lmd(m, device, cmp):
    """``reference_test.toml`` through `main`, its stratified sample cut to
    2 digits (off 2000, on 1000, off 2000 each); cmp: `run_digit` on the
    first digit at 60, 40, 60."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if not cmp:
            return m.main(["prog", entry_toml("liquid_mnist_args",
                                              "reference_test.toml"),
                           "--device", device], max_digits=2)
        from spiking_neural_networks_tpu_torch.experiments import digits
        from spiking_neural_networks_tpu_torch.experiments.pipeline_setup \
            import parse_toml
        with open(entry_toml("liquid_mnist_args", "reference_test.toml"),
                  "rb") as f:
            parsed = m.fill_defaults(parse_toml(f))
        sp = dict(parsed["simulation_parameters"], off_phase=60, on_phase=40)
        return m.run_digit(sp, dict(parsed["variables"]),
                           digits.load_digits().data[0],
                           np.random.default_rng(0), device=device)


def ent_main(**kw):
    """An example's `main` with ``kw`` (cmp: ``kw`` too)."""
    return lambda m, device, cmp: m.main(device=device, **kw)


def ent_two(full, cut):
    """An example's `main` with ``full`` (cmp: ``cut``)."""
    return lambda m, device, cmp: m.main(device=device,
                                         **(cut if cmp else full))


def ent_pruning(m, device, cmp):
    """`main`: 3 trials x 5 connectivities x 1500 steps (cmp: one trial
    each at 100 steps)."""
    if not cmp:
        return m.main(device=device)
    steps, m.ITERATIONS = m.ITERATIONS, 100
    try:
        return m.main(trials=1, device=device)
    finally:
        m.ITERATIONS = steps


def ent_sharded(m, device, cmp):
    """`main` at 256^2 x 500 steps (cmp: 32^2, 200 steps): the single
    run, then the sharded run over the devices there are."""
    build = m.build
    if cmp:
        m.build = functools.partial(build, rows=32, cols=32)
    try:
        return m.main(device=device)
    finally:
        m.build = build


# (row, module, runner, the routes both gates give on the CPU (and the
# port on the card: "6d-a" for the closed loop's CUDA graphs), the
# kernels-line row whose launches it adds, the comparison's ``cap`` and
# ``force``)
ENTRY_KERNEL = (
    (2, "experiments.liquid_state_machine", ent_lsm, {"flat"}, "6b-flat",
     None, True),
    (3, "experiments.liquid_manifold_generation", ent_lmg,
     {"flat", "flat-chemical"}, "6b-flat", None, True),
    (4, "experiments.training_liquid_pipeline", ent_tl, {"flat", False},
     "6b-flat", None, True),
    (5, "experiments.liquid_manifold_digits", ent_lmd, {"flat-chemical"},
     "6b-flat", None, True),
    (6, "examples.lattice", ent_main(), {"stencil"}, "2", ENTRY_CAP, False),
    (7, "examples.eeg_psd", ent_main(), {"stencil"}, "2", ENTRY_CAP, False),
    (8, "examples.lattice_network", ent_main(), {"network"}, "6b", 250,
     True),
    (9, "examples.synaptic_pruning", ent_pruning, {"flat"}, "6b-flat", None,
     True),
    (10, "examples.interacting_pools", ent_two({}, dict(iterations=300)),
     {"flat"}, "6b-flat", None, False),
    (12, "examples.agent_environment", ent_two({}, dict(iterations=160)),
     {"6d-a"}, "6d", None, False),
    (14, "examples.sharded_lattice", ent_sharded, {"stdp", False}, "6a",
     200, False),
)
# the same for the plain paths: every run plain in both gates (rows 11
# and 13 too: a dense all-to-all graph; the readout's histories); the
# main run's cut (``cap`` of its runs), after the comparison run's
ENTRY_PLAIN = (
    (11, "examples.rstdp_lattice", ent_main(), {False}, None, None, False,
     None),
    (13, "examples.lsm_architecture",
     ent_main(iterations=200, period=100), {False}, None, None, True,
     None),
    (15, "examples.pipelined_network", ent_main(), {False}, None, 250, False,
     250),
    (16, "examples.stdp", ent_main(), {False}, None, ENTRY_CAP, True,
     1000),
    (17, "examples.bcm", ent_two(dict(iterations=1000),
                                 dict(iterations=500)), {False}, None, None,
     True, None),
    (18, "examples.raster", ent_main(), {False}, None, None, False, None),
    (19, "examples.hodgkin_huxley", ent_main(), set(), None, None, False,
     None),
    (20, "examples.morris_lecar", ent_main(iterations=2000), set(), None,
     None, False, None),
    (21, "examples.hopfield", ent_main(), set(), None, None, False, None),
)
# the steps of the entry points that run no lattice: their comparison
# run (phase 60) is their main run
LOOP_STEPS = {19: 5000, 20: 2000, 21: 30}


def entry_phases(snt, smi):
    """Phases 60-63.  Returns the kernel launches of this family's main
    runs by kernels-line row ("2", "6a", "6b", "6b-flat", "6d")."""
    import importlib
    import tempfile
    mods = {name: importlib.import_module(
        f"spiking_neural_networks_tpu_torch.{name}")
        for _, name, *_ in ENTRY_KERNEL + ENTRY_PLAIN}
    with tempfile.TemporaryDirectory() as out_dir:
        saved = {name: mod.output_path for name, mod in mods.items()
                 if hasattr(mod, "output_path")}
        for name in saved:
            mods[name].output_path = (
                lambda n: os.path.join(out_dir, os.path.basename(n)))
        try:
            cases = entry_routes_phase(mods)
            launches = entry_kernel_phase(mods, cases)
            entry_plain_phase(mods, cases)
            entry_times_phase(mods, cases, smi)
        finally:
            for name, path in saved.items():
                mods[name].output_path = path
    return launches


def entry_routes_phase(mods):
    """60. Each row's lattices and networks built on the card and run at
    its comparison depth (`ENTRY_KERNEL`, `ENTRY_PLAIN`: chances forced to
    0 or 1 where the row says so, runs cut to its ``cap``): each run's
    route printed and held to the route both gates give on the CPU
    (`tests/test_torch_liquids.py`, `tests/test_torch_examples.py`; a
    model's step loop and the discrete attractor run no lattice).
    Returns each row's probe and output."""
    cases = {}
    for row, name, fn, want, _, cap, force, *_ in ENTRY_KERNEL + ENTRY_PLAIN:
        with EntryProbe(cap=cap, force=force) as probe:
            out, split, steps = probe.call(
                lambda: fn(mods[name], "cuda", True))
        tags = probe.tags()
        say(f"[60 routes] row {row} {name}: {len(probe.objs + probe.nets)} "
            f"lattices / networks / loops, {len(tags)} runs, {steps} steps "
            f"on the card: routes {sorted(set(map(str, tags)))} (the "
            f"gates': {sorted(map(str, want))}); construction "
            f"{split[0]:.3f} s, run {split[1]:.3f} s, analysis "
            f"{split[2]:.3f} s")
        check(set(tags) == want and (tags or row in LOOP_STEPS),
              f"row {row}: the runs took {sorted(set(map(str, tags)))}")
        cases[name] = dict(probe=probe, out=out, split=split)
    return cases


def entry_counts():
    from spiking_neural_networks_tpu_torch.ops import (
        network_kernels as nk, reward_kernels as rk, stencil_kernels as sk)
    return dict(stencil=sk.STEP_LAUNCHES, designs=dict(sk.DESIGN_CALLS),
                persistent=nk.PERSISTENT_LAUNCHES, flat=nk.FLAT_LAUNCHES,
                calls=nk.LAUNCHES, plastic=rk.STEP_LAUNCHES,
                env=rk.ENV_LAUNCHES)


def reset_entry_counts():
    from spiking_neural_networks_tpu_torch.ops import (
        network_kernels as nk, reward_kernels as rk, stencil_kernels as sk)
    reset_stencil_counts(sk)
    nk.LAUNCHES = nk.CHEM_LAUNCHES = nk.FLAT_LAUNCHES = 0
    nk.PERSISTENT_LAUNCHES = 0
    rk.LAUNCHES = rk.STEP_LAUNCHES = rk.ENV_LAUNCHES = 0


def entry_hold_env(m):
    """Two graph replays of the agent's closed loop (`hold_replays`), each
    against the twin from the state it received: (max float error,
    integer and spike mismatches)."""
    import spiking_neural_networks_tpu_torch as snt
    from spiking_neural_networks_tpu_torch.ops import reward_kernels as rk
    agent = snt.RewardModulatedLattice(snt.Izhikevich(), device="cuda")
    agent.populate(10, 10, gap_conductance=10.0)
    agent.connect(lambda x, y: np.hypot(x[0] - y[0], x[1] - y[1]) <= 2
                  and x != y, lambda x, y: 2.0)
    v0 = np.random.default_rng(0).uniform(-65, 30, 100)
    agent.apply(lambda s: {**s, "v": torch.as_tensor(
        v0, dtype=torch.float32, device="cuda")})
    env = m.JitEnvironment(
        agent, m.env_from({"rate": 0.0, "target": m.TARGET_RATE,
                           "key": 3.0}, "cuda"),
        m.encoder_fn, m.reward_fn,
        lambda e, s: m.encoder_key_fn(m.update_fn(e, s), s))
    return hold_replays(rk, env, ENTRY_TWIN_CALLS * rk.STEPS_PER_LAUNCH,
                        True)


def entry_kernel_phase(mods, cases):
    """61. Each kernel path at its own size on the card, the kernels'
    counts set to 0 just before it and read just after: every run on its
    route, launches counted by the C entries, the first
    `ENTRY_TWIN_CALLS` calls of each kernel bit-equal to the twin (the
    closed loop: two graph replays, each against the twin), every state
    finite, neurons fired.  Then its comparison run (phase 60) on the
    CPU's twin route (``use_kernel=True``): every history, firing time, v
    and the output equal to the card's bit for bit; and on the card's
    plain route (``use_kernel=False``), another summation order: max
    |dv|, the first step past `DRIFT`, neurons outside 2 mV.  Returns the
    launches by kernels-line row."""
    launches = {"2": 0, "6a": 0, "6b": 0, "6b-flat": 0, "6d": 0}
    for row, name, fn, want, key, cap, force in ENTRY_KERNEL:
        m = mods[name]
        with EntryProbe(twin_calls=ENTRY_TWIN_CALLS) as probe:
            reset_entry_counts()
            out, split, steps = probe.call(lambda: fn(m, "cuda", False))
            n = entry_counts()
        tags = probe.tags()
        K = 16
        runs = [(t, s) for t, (_, _, s) in zip(tags, probe.runs)]
        kern_calls = sum(-(-s // K) for t, s in runs if t)
        finite, fired = probe.finite(), probe.fired()
        twin = (probe.twin_calls + probe.lat_twin_calls,
                probe.twin_bits, probe.lat_twin_bits)
        if key == "6d":
            err, bad = entry_hold_env(m)
            twin = (ENTRY_TWIN_CALLS, [] if err == 0.0 and bad == 0
                    else ["replay"], 0)
        say(f"[61 main path] row {row} {name}: {steps} steps, routes "
            f"{sorted(set(map(str, tags)))}, launches counted by the C "
            f"entries {n}, the first {twin[0]} kernel calls against the "
            f"twin: outputs not bit-equal {twin[1]}, elements {twin[2]}; "
            f"state finite {finite}, neurons fired {fired}; construction "
            f"{split[0]:.3f} s, run {split[1]:.3f} s, analysis "
            f"{split[2]:.3f} s")
        check(set(tags) == want,
              f"row {row}: took {sorted(set(map(str, tags)))}")
        got = {"2": n["stencil"], "6a": n["plastic"], "6d": n["env"],
               "6b": n["persistent"], "6b-flat": n["persistent"]}[key]
        if key in ("6b", "6b-flat"):
            check(n["persistent"] == n["calls"] >= kern_calls
                  and n["flat"] == (n["calls"] if key == "6b-flat" else 0),
                  f"row {row}: a network call missed the persistent kernel")
        if key == "2":
            check(n["designs"]["persistent"] == sum(n["designs"].values())
                  == kern_calls and got == kern_calls,
                  f"row {row}: stencil calls {n['designs']}, launches {got}")
        if key == "6a":
            # the single run's calls, k + 1 launches a call of k steps;
            # the sharded run is plain per block
            check(got == sum(s // K * (K + 1) + (s % K + 1 if s % K else 0)
                             for t, s in runs if t == "stdp"),
                  f"row {row}: 6a launches {got}")
        check(got > 0, f"row {row}: no launch of row {key}")
        check(twin[0] == ENTRY_TWIN_CALLS and twin[1] == [] and twin[2] == 0,
              f"row {row}: the kernel differs from its twin")
        check(finite and fired > 0, f"row {row}: non-finite state or no "
              f"spike")
        launches[key] += got
        cases[name].update(main=probe, split=split, steps=steps, main_out=out)

        card = cases[name]["probe"]
        with EntryProbe(use_kernel=True, cap=cap, force=force) as cpu:
            cpu_out, _, _ = cpu.call(lambda: fn(m, "cpu", True))
        hk, hc = card.histories(), cpu.histories()
        sk_, sc = card.states(), cpu.states()
        dv = max([float(np.abs(a - b).max()) for a, b in zip(hk, hc)]
                 + [float(np.abs(a[1] - b[1]).max()) for a, b in
                    zip(sk_, sc)])
        # an average or EEG history is a sum over the lattice: its order
        # is the device's reduction, not the kernel's
        rk_, rc = card.histories(True), cpu.histories(True)
        red = max([float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                   for a, b in zip(rk_, rc)], default=0.0)
        lft = all(np.array_equal(a[0], b[0]) for a, b in zip(sk_, sc))
        card_out = cases[name]["out"]
        if row in REDUCED_OUTPUTS:
            gap = reduced_gap(card_out, cpu_out)
            same_out = gap <= 1e-6
        else:
            same_out = repr(cpu_out) == repr(card_out)
        with EntryProbe(use_kernel=False, cap=cap, force=force) as plain:
            plain.call(lambda: fn(m, "cuda", True))
        hp = plain.histories()
        d = [np.abs(a - b).max(axis=1) for a, b in zip(hk, hp)]
        parted = [int(np.argmax(x > DRIFT)) if (x > DRIFT).any() else None
                  for x in d]
        outside = sum(int((np.abs(a - b) > 2.0).any(axis=0).sum())
                      for a, b in zip(hk, hp))
        vd = max([float(x.max()) for x in d]
                 + [float(np.abs(a[1] - b[1]).max())
                    for a, b in zip(sk_, plain.states())])
        say(f"[61 kernel-vs-cpu] row {row} {name}: the comparison run "
            f"against the CPU's twin route "
            f"{sorted(set(map(str, cpu.tags())))}: max|dv| {dv:.4g} mV over "
            f"{len(hk)} histories and {len(sk_)} final states, firing times "
            f"equal {lft}, outputs equal {same_out}"
            + (f" (means in the device's order: within {gap:.3g} of their "
               f"scale)" if row in REDUCED_OUTPUTS else "")
            + (f"; {len(rk_)} average / EEG histories (sums in the device's "
               f"order) within {red:.3g} of their scale" if rk_ else ""))
        say(f"[61 kernel-vs-plain] row {row} {name}: the card's plain route "
            f"{sorted(set(map(str, plain.tags())))}: max|dv| {vd:.4g} mV, "
            f"first step past {DRIFT} mV per history {parted}, neurons ever "
            f"outside 2 mV {outside}, state finite {plain.finite()}")
        check(len(sk_) == len(sc) > 0 and len(hk) == len(hc) and dv == 0.0
              and len(rk_) == len(rc) and red <= 1e-6 and lft and same_out,
              f"row {row}: the card's kernel route differs from the CPU's")
        check(set(plain.tags()) == {False} and plain.finite(),
              f"row {row}: the plain route failed")
        del cpu, plain
    return launches


def entry_plain_phase(mods, cases):
    """62. Each plain path (`ENTRY_PLAIN`) on the card at its own size, or
    its cut: every run plain, every state finite, neurons fired, the
    output of the JAX script's kind; then its comparison run (phase 60)
    on the CPU (trains forced to 0 or 1 where it has any): every history
    and v, and a model's voltage trace, within 2 mV, every firing time
    within 2 steps (`BASELINE.md`, `gpu_accuracy.rs:35-37`)."""
    for row, name, fn, want, _, cap, force, main_cap in ENTRY_PLAIN:
        m = mods[name]
        card, card_out = cases[name]["probe"], cases[name]["out"]
        if row in LOOP_STEPS:
            probe, out = card, card_out
            split, steps = cases[name]["split"], LOOP_STEPS[row]
        else:
            with EntryProbe(cap=main_cap) as probe:
                out, split, steps = probe.call(lambda: fn(m, "cuda", False))
        tags, finite, fired = probe.tags(), probe.finite(), probe.fired()
        cases[name].update(main=probe, split=split, main_out=out,
                           steps=steps)
        with EntryProbe(cap=cap, force=force) as cpu:
            cpu_out, _, _ = cpu.call(lambda: fn(m, "cpu", True))
        hk, hc = card.histories(), cpu.histories()
        sk_, sc = card.states(), cpu.states()
        dv = max([float(np.abs(a - b).max()) for a, b in zip(hk, hc)]
                 + [float(np.abs(a[1] - b[1]).max()) for a, b in
                    zip(sk_, sc)], default=0.0)
        dl = max([int(np.abs(a[0] - b[0]).max(initial=0))
                  for a, b in zip(sk_, sc)], default=0)
        if row in (19, 20):
            dv = max(dv, float(np.abs(card_out - cpu_out).max()))
        say(f"[62 plain path] row {row} {name}: {steps} steps on the card, "
            f"routes {sorted(set(map(str, tags)))}, state finite {finite}, "
            f"neurons fired {fired}, output {type(out).__name__}; the "
            f"comparison run card vs CPU: max|dv| {dv:.4g} mV over "
            f"{len(hk)} histories, {len(sk_)} final states"
            + (" and the voltage trace" if row in (19, 20) else "")
            + f", max |dlft| {dl} steps")
        check(set(tags) == want, f"row {row}: a plain path took {tags}")
        check(finite and (fired > 0 or row in LOOP_STEPS),
              f"row {row}: non-finite state or no spike")
        check(len(hk) == len(hc) and len(sk_) == len(sc) and dv <= 2.0
              and dl <= 2, f"row {row}: card vs CPU outside 2 mV / 2 steps")


def loop_more(row):
    """``more(n)``: ``n`` steps of the model a step loop runs (rows 19,
    20) or sweeps of the discrete attractor (row 21), on the card."""
    import spiking_neural_networks_tpu_torch as snt
    if row == 21:
        from spiking_neural_networks_tpu_torch import attractors as at
        p = at.generate_random_patterns(10, 10, 3, 0.5, seed=4)
        lat = at.DiscreteNeuronLattice(
            10, 10, at.generate_hopfield_network(p), device="cuda")
        lat.input_pattern_into_discrete_grid(at.distort_pattern(p[0], 0.2,
                                                                seed=5))
        return lat.iterate
    model, i = (snt.HodgkinHuxley(), [0.0, 10.0, 25.0, 50.0]) if row == 19 \
        else (snt.MorrisLecar(), [100.0])
    inputs = torch.tensor(i, device="cuda")
    state = [model.init_state(len(i), device="cuda")]

    def more(n):
        for _ in range(n):
            state[0], _ = model.step(state[0], inputs)
    return more


# the profiler's kernel records that the C entry's count of a further run
# must equal (a profile late in a long process can lose records), by
# kernels-line row
ENTRY_RECORDS = {"2": ("stencil", ("model_persistent_kernel",)),
                 "6b": ("persistent", ("net_persistent",)),
                 "6b-flat": ("persistent", ("net_persistent",))}


def entry_times_phase(mods, cases, smi):
    """63. Each row's main run (phases 61, 62): seconds of construction,
    run and analysis, wall us/step of its runs; then the last object run
    on for `ENTRY_PROFILE` steps: device us/step under torch.profiler (on
    the stencil or persistent network kernel with a warm-up cycle and
    retries until every launch the C entry counts has its record), the
    wall of the same steps unprofiled, device / wall."""
    for row, name, _, _, key, *_ in sorted(ENTRY_KERNEL + ENTRY_PLAIN):
        case = cases[name]
        probe = case["main"]
        c, r, a = case["split"]
        kernel = bool(probe.tags() and probe.tags()[-1])
        line = (f"[63 times] row {row} {name}: {c + r + a:.4f} s "
                f"(construction {c:.4f} s, run {r:.4f} s"
                + (f" = {r / case['steps'] * 1e6:.3f} us/step over "
                   f"{case['steps']} steps" if case["steps"] else "")
                + f", analysis {a:.4f} s)")
        more_n = probe.more or loop_more(row)
        steps = ENTRY_PROFILE[0] if kernel else ENTRY_PROFILE[1]
        probe.use_kernel = None

        def more():
            more_n(steps)
            torch.cuda.synchronize()

        counted, mine = ENTRY_RECORDS.get(key, (None, None)) if kernel \
            else (None, None)
        before = entry_counts()
        t0 = time.perf_counter()
        more()
        wall = (time.perf_counter() - t0) / steps * 1e6
        launches = entry_counts()[counted] - before[counted] if counted \
            else None
        dev_us, top = profiled_us(more, steps, n_top=3, launches=launches,
                                  mine=mine)
        say(line + f"; {steps} more steps: wall {wall:.3f} us/step, device "
            f"{dev_us:.3f} us/step (profiled: "
            + ", ".join(f"{k} {t:.3f}" for k, t in top)
            + f"), device / wall {dev_us / wall:.3f}; card {smi}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import spiking_neural_networks_tpu_torch as snt
    check(os.path.dirname(os.path.abspath(snt.__file__))
          == os.path.join(here, "spiking_neural_networks_tpu_torch"),
          f"imported the package from {snt.__file__}, not from the checkout "
          f"beside this script")
    from spiking_neural_networks_tpu_torch import _build
    from spiking_neural_networks_tpu_torch.ops import (
        hh_kernels as hk, model_kernels as mk, network_kernels as nk,
        reward_kernels as rk, stencil_kernels as sk)

    # 1. device
    smi = card()
    name = torch.cuda.get_device_name(0)
    say(f"[1 device] nvidia-smi: {smi} | torch: {name} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.load()
    load_s = time.perf_counter() - t0
    izh = (ctypes.c_int * 4)()
    lib.izh_stencil_limits(izh)
    check(list(izh) == [sk.MAX_OFFSETS, sk.TILE_THREADS, sk.TILE_MAX_CPT,
                        sk.STREAM_THREADS]
          and lib.lp_max_offsets() == rk.MAX_OFFSETS
          and lib.hh_max_offsets() == hk.MAX_OFFSETS
          and lib.model_stencil_max_offsets() == mk.MAX_OFFSETS,
          "MAX_OFFSETS differs between a CUDA source and its wrapper")
    limits = (ctypes.c_int * 13)()
    lib.net_limits(limits)
    check(list(limits) == [nk.MAX_IN, rk.MAX_OFFSETS, nk.MAX_TAPS, nk.NL_I,
                           nk.NL_P, nk.NT_I, nk.NT_P, nk.NC_I, nk.NC_P,
                           nk.NLC_P, nk.NTC_P, nk.DENSE_N_MAX, nk.DENSE_SEG],
          f"the network kernels' limits {list(limits)} differ from their "
          f"wrapper's")
    plimits = (ctypes.c_int * 14)()
    lib.net_persistent_limits(plimits)
    check(list(plimits[:13]) == [nk.NP_MAX_LAT, nk.NP_MAX_TR, nk.NP_MAX_CN,
                                 nk.PL_I, nk.PL_P, nk.PT_I, nk.PT_P, nk.PC_I,
                                 nk.PC_P, nk.NP_THREADS, nk.STEPS_PER_LAUNCH,
                                 nk.NP_THREADS_CHEM, nk.NP_FLAT_SCRATCH]
          and plimits[13] <= 232448 - nk.SMEM_BUDGET,
          f"the persistent kernel's limits {list(plimits)} differ from its "
          f"wrapper's")
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    nvcc = "cached" if _build.build_seconds is None \
        else f"{_build.build_seconds:.2f} s"
    say(f"[2 build] nvcc {nvcc} for {len(_build.SOURCES)} sources, load "
        f"{load_s:.2f} s, {os.path.basename(_build.library_path())}; "
        f"ptxas: {' / '.join(ptxas)}")

    kernels, pipelines, entries = [], None, None
    # the DSL family first: late in a long run the profiler keeps fewer
    # kernel records of every family (it once kept none of the DSL main
    # path's in eight tries)
    for phases in (dsl_phases, trig_phases, support_phases, trial_phases,
                   experiment_phases, entry_phases, stencil_phases,
                   plasticity_phases,
                   network_phases, hh_phases, chem_phases, flat_phases,
                   reward_phases, env_phases, model_phases):
        t0 = time.perf_counter()
        out = phases(snt, smi)
        if phases is experiment_phases:
            pipelines = out
        elif phases is entry_phases:
            entries = out
        else:
            kernels += out if isinstance(out, list) else [out]
        say(f"[{phases.__name__}] {time.perf_counter() - t0:.1f} s")
    # rows 1-3 also launch through the sharded composition (phase 51)
    t0 = time.perf_counter()
    sharded = parallel_phases(snt, smi)
    say(f"[parallel_phases] {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        for design in sharded:
            if k["name"].startswith("izhikevich_stencil_steps") \
                    and k["replaces"] == REPLACES[design]:
                k["composition_launches"] = sharded[design]
                k["composition"] = ("spiking_neural_networks_tpu/core/"
                                    "lattice.py:536-624 (sharded)")
    # rows 6b and 6b-flat also launch through the science pipelines (57)
    for row, entry_name in (("6b", "network_persistent"),
                            ("6b-flat", "network_persistent (flat-mode arm)")):
        entry = next(k for k in kernels if k["name"] == entry_name)
        entry["pipeline_launches"] = pipelines[row]
        entry["pipelines"] = ("spiking_neural_networks_tpu_torch/"
                              "experiments/ (phase 57)")
    # rows 2, 6a, 6b, 6b-flat and 6d also launch through the liquid
    # pipelines and the examples (phase 61)
    for row, pick in (
            ("2", lambda k: k["name"].startswith("izhikevich_stencil_steps")
             and k["replaces"] == REPLACES["persistent"]),
            ("6a", lambda k: k["name"] == "lattice_plasticity_steps"),
            ("6b", lambda k: k["name"] == "network_persistent"),
            ("6b-flat", lambda k: k["name"]
             == "network_persistent (flat-mode arm)"),
            ("6d", lambda k: k["name"]
             == "lattice_plasticity_env_step (closed loop)")):
        entry = next(k for k in kernels if pick(k))
        entry["entry_launches"] = entries[row]
        entry["entries"] = ("spiking_neural_networks_tpu_torch/experiments/ "
                            "liquids and examples/ (phase 61)")
    check(all(k["launches"] > 0 for k in kernels), "a kernel never launched")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
