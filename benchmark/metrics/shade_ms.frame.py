"""Device ms a pass inside the shading and background ranges (L3)."""

from benchmark.harness.readers import range_ms


def read(record):
    return range_ms(record, "L3 shade_hit", "L3 background")
