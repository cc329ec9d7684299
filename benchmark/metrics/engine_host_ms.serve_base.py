"""``readers.engine_host_ms`` in the base serving cells.  Moves ``separate_rtf.base``."""

from benchmark.readers import engine_host_ms as read  # noqa: F401
