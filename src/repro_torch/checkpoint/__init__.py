"""Snapshots of tensor trees in the reference's on-disk layout."""
from repro_torch.checkpoint.io import (LeafCodec, latest_step, load_pytree,
                                       restore, save_pytree)
