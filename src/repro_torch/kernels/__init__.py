"""Hand-written Hopper kernels, one family per TPU kernel of ``repro.kernels``."""

# every launch counter of ``kernels/*/ops.py``, by the name a run reports
LAUNCH_COUNTERS = ("flash_attention", "gmm_equal", "gmm_equal_bwd",
                   "gmm_ragged", "gmm_ragged_bwd", "gmm_ragged_dw",
                   "imag_fused", "ssd_chunked")


def launch_counts() -> dict:
    """This process's kernel launches so far, one entry per name of
    ``LAUNCH_COUNTERS``. Each ``ops`` module counts its own launches in a
    plain int, so the counts are per process: a spawned worker reports
    them to its parent itself."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gmm import ops as gmm
    from repro_torch.kernels.imag import ops as imag
    from repro_torch.kernels.ssd import ops as ssd
    return {"flash_attention": fa.launches,
            "gmm_equal": gmm.equal_launches,
            "gmm_equal_bwd": gmm.equal_bwd_launches,
            "gmm_ragged": gmm.ragged_launches,
            "gmm_ragged_bwd": gmm.ragged_bwd_launches,
            "gmm_ragged_dw": gmm.ragged_dw_launches,
            "imag_fused": imag.launches,
            "ssd_chunked": ssd.launches}
