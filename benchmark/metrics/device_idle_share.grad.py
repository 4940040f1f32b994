"""The device's idle share of a gradient step: 1 - the profiled step's
device seconds / an unprofiled step's wall seconds."""


def read(record):
    if not record.get("kernel_s") or not record.get("step_s"):
        return None
    return 1.0 - record["kernel_s"] / record["step_s"]
