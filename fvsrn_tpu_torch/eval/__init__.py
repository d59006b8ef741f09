"""The paper's evaluation scripts on the port (the counterparts of
``fvsrn_tpu/eval``): the sweep loop (``sweep``) and its six scripts,
``eval_volumetric_features``, ``eval_compression_teaser`` and
``eval_gradient_networks``."""
