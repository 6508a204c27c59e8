"""The port's infrastructure: the live metrics surface
(``MetricsHttpServer``, the counterpart of the JAX package's
``infrastructure/ui.py`` scrape endpoint).  The agent runtime and its
websocket UI are not ported yet (ROADMAP)."""

from .ui import MetricsHttpServer

__all__ = ["MetricsHttpServer"]
