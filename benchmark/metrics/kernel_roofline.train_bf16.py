"""``readers.train_kernel_roofline`` in the bf16 training cells.  Moves ``train_step_s.bf16``."""

from benchmark.readers import train_kernel_roofline as read  # noqa: F401
