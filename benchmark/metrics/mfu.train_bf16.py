"""``readers.train_mfu`` in the bf16 training cells.  Moves ``train_step_s.bf16``."""

from benchmark.readers import train_mfu as read  # noqa: F401
