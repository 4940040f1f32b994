"""Seconds of the image's render pass (``render_pass_persistent``; the
driver loop), between CUDA events taken with the device caught up."""


def read(record):
    ms = record.get("parts_ms", {}).get("render pass")
    return None if ms is None else ms / 1e3
