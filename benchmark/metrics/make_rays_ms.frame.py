"""Device ms a pass inside the camera rays' range (L1)."""

from benchmark.harness.readers import range_ms


def read(record):
    return range_ms(record, "L1 make_rays")
