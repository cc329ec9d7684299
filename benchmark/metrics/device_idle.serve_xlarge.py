"""``readers.device_idle`` in the xlarge serving cells.  Moves ``separate_rtf.xlarge``."""

from benchmark.readers import device_idle as read  # noqa: F401
