"""Ms of a step's forward: ``render_image`` and the loss (L6), between
CUDA events taken with the device caught up (``harness/device.py``)."""


def read(record):
    return record.get("parts_ms", {}).get("grad forward")
