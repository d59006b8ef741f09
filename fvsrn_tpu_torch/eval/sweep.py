"""The sweep harness's options, after ``fvsrn_tpu/eval/sweep.py``: the
training CLI's defaults as the one source of every eval script's run
options. (The sweep loop itself is not ported yet.)"""
from __future__ import annotations


def default_options(scene: str, output: str) -> dict:
    """The training CLI's defaults for ``scene``, writing ``output``
    (``train.main.init_parser``, as the JAX package takes them)."""
    from ..train.main import init_parser
    return vars(init_parser().parse_args([scene, output]))
