"""What the core layer knows of a sharded lattice.

`parallel.lattice_sharding` keeps a sharded lattice's blocks in a
`LatticeShards` under the lattice's ``_shard`` attribute.  The core layer
reads them only through the descriptors below and that object's methods
(``run_lattice_chunk``, ``run_reward``, ``run_train_chunk``,
``network_steps``, ``reward_network_steps``), so it imports nothing of
`parallel` when it loads; the ``shard`` entry points import it lazily.
"""

from __future__ import annotations


def shard_of(x):
    """``x``'s `LatticeShards`, or None where it is not sharded."""
    return x.__dict__.get("_shard")


def first_shard(members):
    """The `LatticeShards` of the first sharded member, or None."""
    return next((sh for sh in map(shard_of, members) if sh is not None),
                None)


def sharded_field(name):
    """A lattice attribute (``state``, ``graph``, ``trace``) that reads
    the assembled view and re-shards on assignment while the lattice is
    sharded, and is a plain attribute otherwise."""
    def get(self):
        sh = shard_of(self)
        return self.__dict__.get("_" + name) if sh is None else sh.view(name)

    def put(self, value):
        sh = shard_of(self)
        if sh is None:
            self.__dict__["_" + name] = value
        else:
            sh.set(name, value)
    return property(get, put)


def block_info(lat):
    """``lat.blocks``: the `BlockInfo` of each block of a sharded lattice,
    None where it is not sharded."""
    sh = shard_of(lat)
    return None if sh is None else sh.info(lat)
