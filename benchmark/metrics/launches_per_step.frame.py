"""Device operations launched a persistent step in the profiled pass."""


def read(record):
    if not record.get("launches") or not record.get("steps"):
        return None
    return record["launches"] / record["steps"]
