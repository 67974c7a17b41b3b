"""``.npz`` checkpoints of parameter trees, numpy alone.

The port's copy of ``canonswap_tpu/runtime/checkpoint.py``'s ``save_npz`` /
``load_npz``: one file of the tree's leaves, their paths joined with '/'
(``transfer/params/res3d_0/Conv_0/kernel``), so a file either package
writes loads in the other.  The port writes the core's tree through
``runtime/weights.py::to_jax``.  The orbax form (sharded training state) is
the JAX package's alone.
"""

from __future__ import annotations

import os

import numpy as np


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat: dict) -> dict:
    root: dict = {}
    for path, arr in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return root


def save_npz(path: str, tree: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten(tree))


def load_npz(path: str) -> dict:
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})
