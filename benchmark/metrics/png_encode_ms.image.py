"""Ms of the image's ``png_encode`` (post-process, host zlib), between
CUDA events taken with the device caught up (``harness/device.py``)."""


def read(record):
    return record.get("parts_ms", {}).get("png_encode")
