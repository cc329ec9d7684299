"""``readers.train_backward_ms`` in the bf16 training cells.  Moves ``train_step_s.bf16``."""

from benchmark.readers import train_backward_ms as read  # noqa: F401
