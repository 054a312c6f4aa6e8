from . import base, tracer  # noqa: F401
