from .detectors import build_network  # noqa: F401
