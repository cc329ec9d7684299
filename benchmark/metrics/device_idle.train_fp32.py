"""``readers.train_device_idle`` in the fp32 training cells.  Moves ``train_step_s.fp32``."""

from benchmark.readers import train_device_idle as read  # noqa: F401
