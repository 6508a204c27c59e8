"""The port's infrastructure: the live metrics surface
(``MetricsHttpServer``, the counterpart of the JAX package's
``infrastructure/ui.py`` scrape endpoint) and the retry policies of the
HA fleet's scrapes and forwards (``retry.RetryPolicy``).  The agent
runtime and its websocket UI are not ported yet (ROADMAP)."""

from .ui import MetricsHttpServer

__all__ = ["MetricsHttpServer"]
