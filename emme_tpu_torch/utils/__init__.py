from . import timer, provenance  # noqa: F401
