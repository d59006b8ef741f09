"""Fourier-feature ablation (reference:
applications/volnet/eval_Fourier.py and eval_Fourier_Grid.py — sweeps
the fourier feature count and scale with and without a latent grid).

The port of ``fvsrn_tpu/eval/eval_fourier.py``: the same entries, trained on the
device (``--device``, the card by default).

Usage: python -m fvsrn_tpu_torch.eval.eval_fourier [--grid] [--epochs N] ...
"""
from .sweep import sweep_main

COUNTS = [0, 4, 8, 14, 22]
STDS = [0.2, 1.0, 5.0]


def configs(args):
    out = [(f"nf{n}", {"fouriercount": n}) for n in COUNTS]
    out += [(f"std{s}", {"fouriercount": 14, "fourierstd": s})
            for s in STDS if s != 1.0]
    if getattr(args, "grid", False):
        # eval_Fourier_Grid.py: the same sweep with a latent grid
        out = [(f"{n}_grid", {**o, "volumetric_features_channels": 8,
                              "volumetric_features_resolution": 16})
               for n, o in out]
    return out


def main(argv=None):
    import argparse
    import sys
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--grid", action="store_true")
    ns, rest = pre.parse_known_args(argv)

    def cfg(args):
        args.grid = ns.grid
        return configs(args)

    return sweep_main(cfg, __doc__, rest)


if __name__ == "__main__":
    import sys
    sys.exit(main())
