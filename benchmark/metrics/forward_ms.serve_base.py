"""``readers.forward_ms`` in the base serving cells.  Moves ``separate_rtf.base``."""

from benchmark.readers import forward_ms as read  # noqa: F401
