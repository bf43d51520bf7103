"""Sharding and pipelines across devices: row blocks of one lattice
(`lattice_sharding`), meshes across processes (`multihost`), chains of
lattices one stage per device (`pipeline`) and batched lattices over a
(dp, tp) mesh (`sharding`)."""

from . import sharding
from .mesh import Mesh
from .lattice_sharding import (make_lattice_mesh, shard_lattice,
                               shard_network, shard_state, shard_graph,
                               unshard_lattice)
from .multihost import initialize as initialize_multihost, make_hybrid_mesh
from .pipeline import (make_pipeline_mesh, run_pipelined,
                       run_pipelined_with_reward)
