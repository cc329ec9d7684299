"""``readers.train_forward_ms`` in the fp32 training cells.  Moves ``train_step_s.fp32``."""

from benchmark.readers import train_forward_ms as read  # noqa: F401
