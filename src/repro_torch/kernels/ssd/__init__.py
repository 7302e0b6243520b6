"""Mamba-2 SSD scan: Hopper kernel (``cuda``), plain version (``ref``), dispatcher (``ops``)."""
