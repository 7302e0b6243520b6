"""Servers and workers of the paper's Fig. 1a: parameter and data servers, the ring buffer, the collection and model-learning workers."""
