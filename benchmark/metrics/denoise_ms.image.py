"""Ms of the image's denoiser (post-process), between CUDA events taken
with the device caught up (``harness/device.py``)."""


def read(record):
    return record.get("parts_ms", {}).get("denoiser")
