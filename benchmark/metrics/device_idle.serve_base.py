"""``readers.device_idle`` in the base serving cells.  Moves ``separate_rtf.base``."""

from benchmark.readers import device_idle as read  # noqa: F401
