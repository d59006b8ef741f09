"""Activation-function ablation (reference:
applications/volnet/eval_ActivationFunctions.py — trains the same SRN
with each activation and compares reconstruction quality).

The port of ``fvsrn_tpu/eval/eval_activation_functions.py``: the same entries, trained on the
device (``--device``, the card by default).

Usage: python -m fvsrn_tpu_torch.eval.eval_activation_functions
       [--scene S] [--epochs N] [--csv out.csv]
"""
from .sweep import sweep_main

ACTIVATIONS = ["ReLU", "Sine:30", "Snake:1", "SnakeAlt:2", "Sigmoid",
               "Softplus"]


def configs(args):
    return [(a.replace(":", ""), {"activation": a,
                                  # sigmoid-clamped head trains stably
                                  # across all activations
                                  "outputmode": "density"})
            for a in ACTIVATIONS]


def main(argv=None):
    return sweep_main(configs, __doc__, argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
