"""Command-line layer (only the problem generators are ported so far)."""
