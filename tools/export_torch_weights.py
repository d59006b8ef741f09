"""Export a JAX run checkpoint's network to the ``.npz`` the PyTorch port
reads (``fvsrn_tpu_torch.train.checkpoints.load_weights``).

The hdf5 run file holds a pickled JAX tree that only loads where ``jax``
and ``fvsrn_tpu`` import; the ``.npz`` holds the same leaves as named
float32 arrays (keys are pytree paths such as ``layers.0.weight``) plus
a JSON ``meta`` entry with the static fields.

    python tools/export_torch_weights.py [run.hdf5] [out.npz]

defaults: assets/flagship_mlobb.hdf5 -> assets/flagship_mlobb_torch.npz
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_IN = os.path.join(ROOT, "assets", "flagship_mlobb.hdf5")
DEFAULT_OUT = os.path.join(ROOT, "assets", "flagship_mlobb_torch.npz")


def _key_name(path) -> str:
    parts = []
    for k in path:
        parts.append(str(k.name) if hasattr(k, "name") else str(k.idx))
    return ".".join(parts)


def network_arrays(net) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, meta) of a ``fvsrn_tpu`` SceneRepresentationNetwork."""
    import jax
    leaves, _ = jax.tree_util.tree_flatten_with_path(net)
    arrays = {_key_name(p): np.asarray(v, np.float32) for p, v in leaves}
    meta = {
        "layers": [{"activation": l.activation,
                    "activation_param": float(l.activation_param)}
                   for l in net.layers],
        "output_mode": net.output_mode,
        "has_direction": bool(net.input.has_direction),
        "disable_direction_in_fourier": bool(
            net.input.disable_direction_in_fourier),
    }
    # time inputs and keyframed latents, written only where set (a
    # missing key reads False), so static networks keep their files
    meta.update({k: True for k, v in (
        ("use_time_direct", net.input.use_time_direct),
        ("time_dependent", net.latent.time_dependent)) if v})
    return arrays, meta


def save_network(net, dst: str) -> dict[str, np.ndarray]:
    """Write a ``fvsrn_tpu`` network to ``dst`` in the port's ``.npz``
    layout; returns its arrays."""
    arrays, meta = network_arrays(net)
    np.savez(dst, meta=np.asarray(json.dumps(meta, sort_keys=True)),
             **arrays)
    return arrays


def export(src: str = DEFAULT_IN, dst: str = DEFAULT_OUT,
           epoch=None) -> dict[str, np.ndarray]:
    sys.path.insert(0, ROOT)
    from fvsrn_tpu.train.checkpoints import RunCheckpoint
    with RunCheckpoint(src, "r") as ck:
        net = ck.load_weights(epoch)
    return save_network(net, dst)


if __name__ == "__main__":
    args = sys.argv[1:]
    out = export(*(args[:2] if args else ()))
    for k, v in out.items():
        print(f"{k:24s} {tuple(v.shape)}")
