"""Network-architecture sweep (reference:
applications/volnet/eval_network_configs.py, eval_NetworkConfigsGrid.py,
collect_possible_layers.py — layer/channel grids at comparable parameter
budgets, with and without volumetric features).

The port of ``fvsrn_tpu/eval/eval_network_configs.py``: the same entries, trained on the
device (``--device``, the card by default).

Usage: python -m fvsrn_tpu_torch.eval.eval_network_configs [--epochs N] ...
"""
from .sweep import sweep_main

LAYERS = ["32:32", "32:32:32", "48:48:48", "64:64", "64:64:64"]
GRIDS = [(0, 0), (8, 16), (16, 32)]   # (channels, resolution)


def configs(args):
    out = []
    for layers in LAYERS:
        for ch, res in GRIDS:
            name = layers.replace(":", "x") + (f"_g{ch}c{res}" if ch
                                               else "")
            out.append((name, {
                "layers": layers,
                "volumetric_features_channels": ch,
                "volumetric_features_resolution": res,
            }))
    return out


def main(argv=None):
    return sweep_main(configs, __doc__, argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
