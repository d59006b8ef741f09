"""Data parallelism on ``torch.distributed``: process groups and their
devices (``mesh``), data-parallel training steps and sharded renders
(``train_step``). Counterpart of ``fvsrn_tpu/parallel``."""
