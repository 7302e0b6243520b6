"""Grouped matmul: Hopper kernels (``cuda``), plain versions (``ref``), dispatcher (``ops``)."""
