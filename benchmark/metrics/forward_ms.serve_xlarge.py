"""``readers.forward_ms`` in the xlarge serving cells.  Moves ``separate_rtf.xlarge``."""

from benchmark.readers import forward_ms as read  # noqa: F401
