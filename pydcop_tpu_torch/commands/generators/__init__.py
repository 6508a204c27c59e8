"""Benchmark problem generators."""
