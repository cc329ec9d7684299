"""``readers.mfu`` in the base serving cells.  Moves ``separate_rtf.base``."""

from benchmark.readers import mfu as read  # noqa: F401
