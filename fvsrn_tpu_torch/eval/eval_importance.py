"""Importance-sampling ablation (reference:
applications/volnet/eval_Importance.py and eval_ImportanceGrid.py —
uniform vs density-importance-weighted world sampling, with and without
adaptive rebuilds).

The port of ``fvsrn_tpu/eval/eval_importance.py``: the same entries, trained on the
device (``--device``, the card by default).

Usage: python -m fvsrn_tpu_torch.eval.eval_importance [--epochs N] ...
"""
from .sweep import sweep_main


def configs(args):
    return [
        ("uniform", {"importance": 0.0}),
        ("imp25", {"importance": 0.25}),
        ("imp50", {"importance": 0.5}),
        ("imp50_rebuild", {"importance": 0.5, "rebuild_dataset": 10}),
    ]


def main(argv=None):
    return sweep_main(configs, __doc__, argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
