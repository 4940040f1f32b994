from . import profiling  # noqa: F401
