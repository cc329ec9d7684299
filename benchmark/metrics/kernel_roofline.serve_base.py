"""``readers.kernel_roofline`` in the base serving cells.  Moves ``separate_rtf.base``."""

from benchmark.readers import kernel_roofline as read  # noqa: F401
