"""PyTorch counterpart of ``spiking_neural_networks_tpu/core/``."""
