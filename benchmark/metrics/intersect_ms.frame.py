"""Device ms a pass inside ``Scene.intersect``'s range (L2), its
kernels included."""

from benchmark.harness.readers import range_ms


def read(record):
    return range_ms(record, "L2 intersect")
