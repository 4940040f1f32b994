"""B5's share of its bytes bound over every call of the profiled pass,
percent (``harness/roofline.py``)."""

from benchmark.harness.readers import kernel_share


def read(record):
    return kernel_share(record, "B5")
