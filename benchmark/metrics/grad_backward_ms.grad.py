"""Ms of a step's ``backward()`` (L6: the recomputed bounces, the rows'
``index_add_``), between CUDA events taken with the device caught up."""


def read(record):
    return record.get("parts_ms", {}).get("grad backward")
