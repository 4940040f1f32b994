"""The device's idle share of a pass: 1 - the profiled pass's device
seconds / an unprofiled pass's wall seconds (the profiler slows the host,
not the kernels)."""


def read(record):
    if not record.get("kernel_s") or not record.get("pass_s"):
        return None
    return 1.0 - record["kernel_s"] / record["pass_s"]
