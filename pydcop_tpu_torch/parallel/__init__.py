"""Padding of device problems to explicit dimensions (the serving buckets)."""
