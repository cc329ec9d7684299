"""``readers.engine_host_ms`` in the xlarge serving cells.  Moves ``separate_rtf.xlarge``."""

from benchmark.readers import engine_host_ms as read  # noqa: F401
