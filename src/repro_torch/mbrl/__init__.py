"""The MBRL algorithm's pieces: policy, dynamics ensemble, early stop."""
