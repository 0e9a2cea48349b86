"""Factorization substrates the paper selects k for (NMF / NMFk slice)."""
from .batching import batched_lanes, bucket_batch, next_pow2, round_up_multiple  # noqa: F401
from .nmf import (  # noqa: F401
    NMFResult,
    mu_step,
    nmf,
    nmf_batched,
    nmf_init,
    reconstruction_error,
)
from .nmfk import (  # noqa: F401
    NMFkScore,
    make_nmfk_evaluator,
    nmfk_score,
    nmfk_score_batched,
)
from .planes import NMFkBatchPlane  # noqa: F401
from .synthetic import nmf_data  # noqa: F401
