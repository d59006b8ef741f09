"""Screen-space vs world-space training comparison (reference:
applications/volnet/eval_ScreenVsWorld.py and the _Grid/_GridNeRF
variants — the same network trained with the rendering loss vs the
world sampling loss, scored on a common world metric).

The port of ``fvsrn_tpu/eval/eval_screen_vs_world.py``: the same entries, trained on the
device (``--device``, the card by default).

Usage: python -m fvsrn_tpu_torch.eval.eval_screen_vs_world [--epochs N] ...
"""
from .sweep import sweep_main


def configs(args):
    grid = {"volumetric_features_channels": 8,
            "volumetric_features_resolution": 16}
    return [
        ("world", {"mode": "world", **grid}),
        ("screen", {"mode": "screen", "screen_cameras": 8,
                    "screen_size": 32, "outputmode": "density",
                    **grid}),
        ("world_nogrid", {"mode": "world"}),
    ]


def main(argv=None):
    return sweep_main(configs, __doc__, argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
