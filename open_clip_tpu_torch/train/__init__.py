"""Training: schedules, optimizer, train step, epoch loop and the CLI
(counterpart of ``open_clip_tpu/train``)."""
