"""Test helpers shared by ``tests/test_torch_*.py``."""
