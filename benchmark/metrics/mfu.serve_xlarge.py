"""``readers.mfu`` in the xlarge serving cells.  Moves ``separate_rtf.xlarge``."""

from benchmark.readers import mfu as read  # noqa: F401
