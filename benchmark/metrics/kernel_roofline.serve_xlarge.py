"""``readers.kernel_roofline`` in the xlarge serving cells.  Moves ``separate_rtf.xlarge``."""

from benchmark.readers import kernel_roofline as read  # noqa: F401
