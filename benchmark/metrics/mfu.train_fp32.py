"""``readers.train_mfu`` in the fp32 training cells.  Moves ``train_step_s.fp32``."""

from benchmark.readers import train_mfu as read  # noqa: F401
