"""Persistent steps (``LanePool.step`` calls) in the profiled pass."""


def read(record):
    return record.get("steps") or None
