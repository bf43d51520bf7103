"""The science pipelines of the port, written against its `lixirnet` and
core, each the PyTorch counterpart of the script of the same name in
``experiments/``:

* working memory and inference: ``bayesian_inference_rate_based`` (the
  Bayesian-inference trial), ``bayesian_inference_pipeline`` (Hopfield
  recall with a dopamine cue), ``schizophrenia_simulation`` (the
  NMDA-hypofunction working-memory sweep), ``attractor_manifold`` (recall
  trajectories and their PCA embedding), ``tolman_eichenbaum`` (structure
  and sensory bindings on a ring world);
* liquids: ``isolated_liquid_pipeline`` (disturbance decay of a liquid),
  ``dopamine_liquid_interaction`` (D1 / D2 on a liquid),
  ``liquid_state_machine`` (the separation property),
  ``liquid_manifold_generation`` (on / off phases and their PCA manifold;
  the custom-manifold TOML grid), ``training_liquid_pipeline`` (a digit
  classifier with an STDP exposure), ``liquid_manifold_digits`` (per-digit
  manifold data);
* space: ``grid_cell_model`` and ``grid_cell_electrochemical`` (toroidal
  grid-cell sheets), ``hd_attractor``, ``hd_electrochemical_model``,
  ``hd_electrochemical_model_dopaminergic``,
  ``hd_electrochemical_model_no_turning`` and ``hd_with_basin`` (head-
  direction rings);
* ``heuristic_parameter_search`` (an epsilon-greedy search over a
  lattice's firing rate);

and their shared helpers (``pipeline_setup``, ``lsm_setup``), the offline
plot of attractor firing data (``attractor_manifold_plot``, NumPy and
matplotlib on the host) and the 8x8 digits (``digits``: ``load_digits``
and scikit-learn's stratified ``train_test_split`` with NumPy alone, over
``data/digits.csv.gz``, the UCI handwritten-digits test set as
scikit-learn ships it, BSD-3; ``data/README.md``).  Each pipeline runs on
the card unless asked for another device: ``python -m
spiking_neural_networks_tpu_torch.experiments.<name> [args] [--device
cpu]``."""
