"""Training: the step, optimizers, checkpoints, the trainer and the CLI
(counterpart of ``sinnerf_tpu/train``)."""
