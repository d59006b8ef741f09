"""Read network weights exported for the port.

The JAX package stores weights as a pickled JAX tree inside an hdf5 run
file, which only unpickles where JAX and the JAX package import. The
port reads instead the ``.npz`` that ``tools/export_torch_weights.py``
writes from such a run file: named float32 arrays plus a JSON ``meta``
entry, read with numpy alone (no pickle).
"""
from __future__ import annotations

import json

import numpy as np

from ..convert import srn_from_arrays
from ..models.srn import SceneRepresentationNetwork

META_KEY = "meta"


def load_arrays(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, meta) of an exported ``.npz``."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != META_KEY}
        meta = json.loads(str(z[META_KEY]))
    return arrays, meta


def load_weights(path: str) -> SceneRepresentationNetwork:
    """The SRN of an exported ``.npz``, on the CPU."""
    arrays, meta = load_arrays(path)
    return srn_from_arrays(arrays, meta)
