"""Ms of a step's apply: Adam's step and the next step's
``Scene.replace`` (B1's groups rebuilt on the host; L6), between CUDA
events taken with the device caught up (``harness/device.py``)."""


def read(record):
    return record.get("parts_ms", {}).get("grad apply")
