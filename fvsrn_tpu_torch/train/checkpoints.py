"""Network weights on disk for the port: the ``.npz`` run file.

The JAX package stores weights as a pickled JAX tree inside an hdf5 run
file, which only unpickles where JAX and the JAX package import. The
port reads instead the ``.npz`` that ``tools/export_torch_weights.py``
writes from such a run file, and writes the same layout at the end of a
training run (``save_run``): named float32 arrays keyed by their path in
the network (``input.fourier_matrix``, ``layers.{i}.weight``,
``latent.static_grid``, the keyframed grids and latent vectors) plus a
JSON ``meta`` entry with the static
fields, read back with numpy alone (no pickle). A run file's ``meta``
also holds the run's options and its per-epoch loss history.
"""
from __future__ import annotations

import json
import os

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


def network_meta(network: SceneRepresentationNetwork) -> dict:
    """The static fields ``srn_from_arrays`` needs besides the arrays
    (``use_time_direct`` and ``time_dependent`` only where set, as
    ``tools/export_torch_weights.py`` writes them)."""
    meta = {
        "layers": [{"activation": l.activation,
                    "activation_param": float(l.activation_param)}
                   for l in network.layers],
        "output_mode": network.output_mode,
        "has_direction": bool(network.input.has_direction),
        "disable_direction_in_fourier": bool(
            network.input.disable_direction_in_fourier),
    }
    meta.update({k: True for k, v in (
        ("use_time_direct", network.input.use_time_direct),
        ("time_dependent", network.latent.time_dependent)) if v})
    return meta


def save_run(path: str, network: SceneRepresentationNetwork,
             options: dict, history: list) -> None:
    """Write ``network`` with the run's ``options`` (str/int/float/bool
    values) and per-epoch loss ``history`` to ``path`` (the ``.npz``
    layout above, written at exactly ``path``)."""
    arrays = {name: p.detach().cpu().numpy().astype(np.float32)
              for name, p in network.named_parameters()}
    meta = dict(network_meta(network),
                options={k: v for k, v in options.items()
                         if isinstance(v, (str, int, float, bool))},
                history=[float(v) for v in history])
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{META_KEY: np.asarray(json.dumps(meta, sort_keys=True))},
                 **arrays)
    os.replace(tmp, path)
