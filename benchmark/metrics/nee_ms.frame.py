"""Device ms a pass inside the light sampling range (L3n:
``sample_direct``, its shadow ray's ``Scene.intersect`` included, whose
operations ``intersect_ms.frame`` counts too); nothing where the pass
sampled no light."""

from benchmark.harness.readers import range_ms


def read(record):
    return range_ms(record, "L3n sample_direct")
