"""Flash attention: Hopper kernel (``cuda``), plain version (``ref``), dispatcher (``ops``)."""
