"""``readers.train_device_idle`` in the bf16 training cells.  Moves ``train_step_s.bf16``."""

from benchmark.readers import train_device_idle as read  # noqa: F401
