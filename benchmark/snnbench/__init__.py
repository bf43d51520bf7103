"""The benchmark of the PyTorch and CUDA port ``spiking_neural_networks_tpu_torch``.

Everything here is the yardstick: the catalog that finds a cell's files by
name (`catalog`), the inputs drawn from the seed (`inputs`), the drivers
of the port's lattice entries that the traffic kinds build on
(`requests`), the count of bytes
and operations and the card's peaks (`counts`), the profiled slice and its
reading (`tracing`), the comparison that decides ``correct`` (`check`) and
one run (`session`).  The plain reference lives in ``benchmark/reference/``
and imports nothing of the port.
"""
