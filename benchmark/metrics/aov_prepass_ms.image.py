"""Ms of the image's AOV pre-pass (post-process), between CUDA events
taken with the device caught up (``harness/device.py``)."""


def read(record):
    return record.get("parts_ms", {}).get("AOV pre-pass")
