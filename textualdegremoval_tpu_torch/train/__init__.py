"""Training of the port: schedules, the AdamW step, checkpoints, mixup
(counterpart of textualdegremoval_tpu/train)."""
