"""The paper's evaluation scripts on the port (the counterparts of
``fvsrn_tpu/eval``): ``eval_gradient_networks``."""
