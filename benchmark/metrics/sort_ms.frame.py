"""Device ms a pass inside the lane sorter's range (L5s: S1, the sort,
S2); nothing where the pass did not sort."""

from benchmark.harness.readers import range_ms


def read(record):
    return range_ms(record, "L5s lane sorter")
