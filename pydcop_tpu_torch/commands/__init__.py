"""Command-line layer: the ``solve`` verb and the problem generators."""
