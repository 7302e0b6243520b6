"""Fused imagination step: Hopper kernel (``cuda``), plain version (``ref``), dispatcher (``ops``)."""
