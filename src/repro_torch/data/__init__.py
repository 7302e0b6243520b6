"""Data pipeline for world-model pre-training (port of ``repro/data``)."""
