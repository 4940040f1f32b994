"""Device operations launched in the profiled gradient step."""


def read(record):
    if not record.get("launches") or not record.get("steps"):
        return None
    return record["launches"] / record["steps"]
