"""Named spans at the training path's phase boundaries, in the profiler's
timeline.

``span(name)`` opens ``torch.profiler.record_function("sinnerf." + name)``
while a profiler runs (``--profile``, or a benchmark's traced run), so each
phase shares a clock with the card's kernels in the trace; with none
running it returns one shared no-op context, at the cost of the check
alone.  The spans of the train path (all opened on the trainer's thread):

``step``              ``train/step.py::train_step``, its whole body
``step.losses``       the ``compute_losses`` call, with inside it:
``step.render``       its ``render_rays`` call
``step.vit``          its ViT block, both ``vit_cls`` calls, and inside it
``step.vit.refresh``  the refresh call on the real patch
``step.disc``         its adversarial block: D's calls and the GAN losses
``step.backward``     ``total.backward()``
``step.optimizer``    ``grad_hook``, the optimizers' steps, D's ``u``, the ViT cache
``sampler``           one group of ``SinNeRFTrainer._epoch_batches``
``sampler.read``      the group's one read of the card (``data/sampler.py``)
``log.start``         ``_run_epoch``'s metric reduce and host copy of a log step
``log.wait``          ``_flush_pending_log``'s wait for that copy
``log.write``         its TensorBoard writes
``epoch.sync``        ``_run_epoch``'s closing synchronise
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "sinnerf."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the running profiler's timeline,
    or a no-op when no profiler runs."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
