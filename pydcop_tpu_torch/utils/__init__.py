"""Small helpers shared by the port's host-side modules."""
