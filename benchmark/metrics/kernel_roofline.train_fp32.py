"""``readers.train_kernel_roofline`` in the fp32 training cells.  Moves ``train_step_s.fp32``."""

from benchmark.readers import train_kernel_roofline as read  # noqa: F401
