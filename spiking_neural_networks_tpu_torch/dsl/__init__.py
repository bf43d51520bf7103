"""The `.nb` model-definition language: `neuron_builder` compiles its
blocks into the port's model classes (``builder.py``), from the parser's
AST (``parser.py``).  A generated neuron on an electrical stencil lattice
runs on the model kernel through a CUDA functor generated from its step
(``ops/dsl_kernels.py``)."""

from . import builder, parser
from .builder import neuron_builder, neuron_builder_from_file

__all__ = ["neuron_builder", "neuron_builder_from_file", "parser", "builder"]
