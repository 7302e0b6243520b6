"""Hand-written Hopper kernels, one family per TPU kernel of ``repro.kernels``."""
