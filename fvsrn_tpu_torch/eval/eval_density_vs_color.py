"""Density-SRN vs color-SRN world training (reference:
applications/volnet/eval_world_DensityVsColor.py and the Grid /
NoImportance / WithResampling variants — predict density + TF at render
time vs predicting TF-mapped rgbo directly).

The port of ``fvsrn_tpu/eval/eval_density_vs_color.py``: the same entries, trained on the
device (``--device``, the card by default).

Usage: python -m fvsrn_tpu_torch.eval.eval_density_vs_color [--epochs N] ...
"""
from .sweep import sweep_main


def configs(args):
    grid = {"volumetric_features_channels": 8,
            "volumetric_features_resolution": 16}
    return [
        ("density", {"outputmode": "density:direct", **grid}),
        ("rgbo", {"outputmode": "rgbo", **grid}),
        ("rgbo_exp", {"outputmode": "rgbo:exp", **grid}),
        # the reference's resampling ablation: adaptive dataset rebuild
        ("density_resampled", {"outputmode": "density:direct",
                               "rebuild_dataset": 10, **grid}),
    ]


def main(argv=None):
    return sweep_main(configs, __doc__, argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
