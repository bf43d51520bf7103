"""Checkpoint and resume for lattices and networks.

PyTorch counterpart of ``spiking_neural_networks_tpu/utils/checkpoint.py``,
in its file format: one ``.npz`` of NumPy arrays (``state/``, ``graph/``,
``trace/``; in a network ``lat{i}/``, ``st{i}/``, ``rlat{i}/``,
``conn{pre}_{post}/`` and ``rconn{pre}_{post}/``) and a ``__meta__`` JSON
header.  A checkpoint the JAX package wrote loads here, and one written
here loads in the JAX package.

Random state: the JAX package saves its PRNG key as ``__key__``, which a
`torch.Generator` cannot take; the port ignores it (a resumed Poisson
train then draws from its ``seed`` afresh).  The port saves the state of
each `torch.Generator` it holds (a spike-train lattice's, a network's)
under ``__generator__`` keys of its own, with the seed and the
generator's device type in the header; the JAX loader ignores them.  A
generator state is restored on a device of the same type (a CUDA state
into a CUDA generator); elsewhere, or where none was saved, the generator
is made afresh from the seed at its first use.

Loading writes into an existing, populated object, which may have run
already: graphs are rebuilt through the port's constructors (so the
in-degree is recomputed), tensors go to the object's device, and a
network's ``_conn_version`` is bumped so that its cached plans (the
structured and reward plans and their device copies of connection
weights and traces) are rebuilt.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.graph import DenseGraph, SparseGraph, StencilGraph

GENERATOR_KEY = "__generator__"


def _npz_path(path):
    """np.savez appends '.npz' to extensionless paths; normalize so that
    save and load agree on the filename."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _flatten(prefix, mapping, out):
    for k, v in mapping.items():
        out[f"{prefix}{k}"] = _host(v)


def _unflatten(prefix, data, device):
    return {k[len(prefix):]: torch.from_numpy(np.array(data[k])).to(device)
            for k in data.files if k.startswith(prefix)}


def _graph_arrays(graph, prefix, out, meta):
    if isinstance(graph, DenseGraph):
        meta[prefix] = {"kind": "dense"}
        out[f"{prefix}weights"] = _host(graph.weights)
        out[f"{prefix}mask"] = _host(graph.mask)
    elif isinstance(graph, SparseGraph):
        meta[prefix] = {"kind": "sparse", "n_pre": graph.n_pre,
                        "n_post": graph.n_post}
        out[f"{prefix}src"] = _host(graph.src)
        out[f"{prefix}dst"] = _host(graph.dst)
        out[f"{prefix}weights"] = _host(graph.weights)
    elif isinstance(graph, StencilGraph):
        meta[prefix] = {"kind": "stencil",
                        "offsets": [list(o) for o in graph.offsets]}
        out[f"{prefix}weights"] = _host(graph.weights)
        out[f"{prefix}mask"] = _host(graph.mask)
    elif graph is None:
        meta[prefix] = {"kind": "none"}
    else:
        raise TypeError(f"cannot checkpoint graph {type(graph)}")


def _load_graph(prefix, data, meta, device):
    info = meta[prefix]

    def arr(name, dtype):
        return torch.from_numpy(np.asarray(data[prefix + name], dtype)) \
            .to(device)

    if info["kind"] == "dense":
        return DenseGraph(arr("weights", np.float32), arr("mask", bool))
    if info["kind"] == "sparse":
        return SparseGraph(arr("src", np.int64), arr("dst", np.int64),
                           arr("weights", np.float32), info["n_pre"],
                           info["n_post"])
    if info["kind"] == "stencil":
        return StencilGraph([tuple(o) for o in info["offsets"]],
                            arr("weights", np.float32), arr("mask", bool))
    return None


def _save_generator(obj, prefix, out, meta):
    """The seed and, where the object made one, its generator's state."""
    if not hasattr(obj, "seed"):
        return
    gen = getattr(obj, "_generator", None)
    info = {"seed": int(obj.seed)}
    if gen is not None:
        out[prefix + GENERATOR_KEY] = gen.get_state().numpy()
        info["device_type"] = gen.device.type
    meta[prefix + GENERATOR_KEY] = info


def _load_generator(obj, prefix, data, meta, device):
    if not hasattr(obj, "seed"):
        return
    obj._generator = None
    info = meta.get(prefix + GENERATOR_KEY)
    if info is None:            # a JAX file: its key is not a generator
        return
    obj.seed = info["seed"]
    if prefix + GENERATOR_KEY in data.files \
            and info.get("device_type") == torch.device(device).type:
        gen = torch.Generator(device=device)
        gen.set_state(torch.from_numpy(np.array(data[prefix
                                                     + GENERATOR_KEY])))
        obj._generator = gen


def _write(path, out, meta):
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                    dtype=np.uint8)
    np.savez_compressed(_npz_path(path), **out)


def save_lattice(lattice, path):
    """Checkpoint any single-lattice object (`Lattice`,
    `SpikeTrainLattice`, `RewardModulatedLattice`)."""
    out, meta = {}, {"rows": lattice.rows, "cols": lattice.cols,
                     "internal_clock": lattice.internal_clock,
                     "id": lattice.id}
    _flatten("state/", lattice.state, out)
    if getattr(lattice, "graph", None) is not None:
        _graph_arrays(lattice.graph, "graph/", out, meta)
    if getattr(lattice, "trace", None) is not None:
        _flatten("trace/", lattice.trace, out)
        meta["dopamine"] = float(lattice.dopamine)
    _save_generator(lattice, "", out, meta)
    _write(path, out, meta)


def load_lattice(lattice, path):
    """Restore a checkpoint into an existing lattice object (populated with
    the same model), on its device.  A JAX ``__key__`` is ignored."""
    data = np.load(_npz_path(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    dev = lattice.device
    lattice.rows, lattice.cols = meta["rows"], meta["cols"]
    lattice.internal_clock = meta["internal_clock"]
    lattice.id = meta["id"]
    lattice.state = _unflatten("state/", data, dev)
    if "graph/" in meta:
        lattice.graph = _load_graph("graph/", data, meta, dev)
    if any(k.startswith("trace/") for k in data.files):
        lattice.trace = _unflatten("trace/", data, dev)
        lattice.dopamine = meta["dopamine"]
    _load_generator(lattice, "", data, meta, dev)
    return lattice


def save_network(network, path):
    """Checkpoint a `LatticeNetwork` or `RewardModulatedLatticeNetwork`:
    every member's state and graph, the reward lattices' traces and
    dopamine, the host connections, the clocks and the generators."""
    out = {}
    meta = {"internal_clock": network.internal_clock,
            "electrical_synapse": network.electrical_synapse,
            "chemical_synapse": network.chemical_synapse,
            "lattices": {}, "spike_train_lattices": {}, "connections": [],
            "reward_lattices": {}, "reward_connections": []}
    for i, lat in getattr(network, "reward_modulated_lattices", {}).items():
        p = f"rlat{i}/"
        meta["reward_lattices"][str(i)] = {
            "rows": lat.rows, "cols": lat.cols,
            "internal_clock": lat.internal_clock,
            "dopamine": float(lat.dopamine)}
        _flatten(p + "state/", lat.state, out)
        _graph_arrays(lat.graph, p + "graph/", out, meta)
        _flatten(p + "trace/", lat.trace, out)
    for (pre, post), rconn in getattr(network,
                                      "reward_connections", {}).items():
        key = f"rconn{pre}_{post}/"
        meta["reward_connections"].append([pre, post, key])
        for name, arr in zip(("src", "dst", "w", "c", "dw", "counter"),
                             rconn):
            out[key + name] = _host(arr)
    if hasattr(network, "dopamine"):
        meta["dopamine"] = float(network.dopamine)
    for i, lat in network.lattices.items():
        p = f"lat{i}/"
        meta["lattices"][str(i)] = {"rows": lat.rows, "cols": lat.cols,
                                    "internal_clock": lat.internal_clock}
        _flatten(p + "state/", lat.state, out)
        _graph_arrays(lat.graph, p + "graph/", out, meta)
    for i, st in network.spike_train_lattices.items():
        p = f"st{i}/"
        meta["spike_train_lattices"][str(i)] = {
            "rows": st.rows, "cols": st.cols,
            "internal_clock": st.internal_clock}
        _flatten(p + "state/", st.state, out)
        _save_generator(st, p, out, meta)
    for (pre, post), (src, dst, w) in network.connections.items():
        key = f"conn{pre}_{post}/"
        meta["connections"].append([pre, post, key])
        out[key + "src"] = _host(src)
        out[key + "dst"] = _host(dst)
        out[key + "w"] = _host(w)
    # the network's generator drives its Poisson trains: without it a
    # resumed run cannot reproduce the original trajectory
    _save_generator(network, "", out, meta)
    _write(path, out, meta)


def load_network(network, path):
    """Restore a checkpoint into an existing network with the same members
    (ids, models, shapes), each on its own device.  A JAX ``__key__`` is
    ignored."""
    data = np.load(_npz_path(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    network.internal_clock = meta["internal_clock"]
    network.electrical_synapse = meta["electrical_synapse"]
    network.chemical_synapse = meta["chemical_synapse"]
    for i_str, info in meta["lattices"].items():
        lat = network.lattices[int(i_str)]
        p = f"lat{i_str}/"
        lat.rows, lat.cols = info["rows"], info["cols"]
        lat.internal_clock = info["internal_clock"]
        lat.state = _unflatten(p + "state/", data, lat.device)
        lat.graph = _load_graph(p + "graph/", data, meta, lat.device)
    for i_str, info in meta["spike_train_lattices"].items():
        st = network.spike_train_lattices[int(i_str)]
        p = f"st{i_str}/"
        st.rows, st.cols = info["rows"], info["cols"]
        st.internal_clock = info["internal_clock"]
        st.state = _unflatten(p + "state/", data, st.device)
        _load_generator(st, p, data, meta, st.device)
    for pre, post, key in meta["connections"]:
        network.connections[(pre, post)] = (
            np.asarray(data[key + "src"], np.int64),
            np.asarray(data[key + "dst"], np.int64),
            np.asarray(data[key + "w"], np.float32))
    for i_str, info in meta.get("reward_lattices", {}).items():
        lat = network.reward_modulated_lattices[int(i_str)]
        p = f"rlat{i_str}/"
        lat.rows, lat.cols = info["rows"], info["cols"]
        lat.internal_clock = info["internal_clock"]
        lat.dopamine = info["dopamine"]
        lat.state = _unflatten(p + "state/", data, lat.device)
        lat.graph = _load_graph(p + "graph/", data, meta, lat.device)
        lat.trace = _unflatten(p + "trace/", data, lat.device)
    for pre, post, key in meta.get("reward_connections", []):
        network.reward_connections[(pre, post)] = tuple(
            np.asarray(data[key + name], dt) for name, dt in (
                ("src", np.int64), ("dst", np.int64), ("w", np.float32),
                ("c", np.float32), ("dw", np.float32),
                ("counter", np.int32)))
    if "dopamine" in meta:
        network.dopamine = meta["dopamine"]
    _load_generator(network, "", data, meta, network.device or "cpu")
    network._conn_version += 1
    return network
