"""Compilation of a DCOP to padded arrays, and the device kernels over them."""
