"""The device's idle share of an image: 1 - the profiled image's device
seconds / an unprofiled image's wall seconds."""


def read(record):
    if not record.get("kernel_s") or not record.get("image_s"):
        return None
    return 1.0 - record["kernel_s"] / record["image_s"]
