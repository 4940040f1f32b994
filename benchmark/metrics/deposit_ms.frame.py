"""Device ms a pass inside the film deposit's range (L4, kernel B2)."""

from benchmark.harness.readers import range_ms


def read(record):
    return range_ms(record, "L4 deposit")
