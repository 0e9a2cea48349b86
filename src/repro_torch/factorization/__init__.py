"""Factorization & clustering substrates the paper selects k for: NMF / NMFk, K-Means,
RESCAL / RESCALk, and the distributed-within-k NMF and RESCAL fits."""
from .batching import (  # noqa: F401
    WarmStartCache,
    batched_lanes,
    bucket_batch,
    next_pow2,
    round_up_multiple,
)
from .distributed import (  # noqa: F401
    distributed_nmf,
    distributed_rescal,
    local_groups,
)
from .kmeans import KMeansResult, kmeans, kmeans_batched, kmeans_multi_restart  # noqa: F401
from .nmf import (  # noqa: F401
    NMFResult,
    mu_step,
    nmf,
    nmf_batched,
    nmf_chunked,
    nmf_init,
    reconstruction_error,
)
from .nmfk import (  # noqa: F401
    NMFkScore,
    make_nmfk_evaluator,
    nmfk_score,
    nmfk_score_batched,
)
from .planes import KMeansBatchPlane, NMFkBatchPlane, NMFkElasticPlane  # noqa: F401
from .rescal import (  # noqa: F401
    RESCALResult,
    make_rescalk_evaluator,
    rescal,
    rescalk_score,
)
from .synthetic import blob_data, nmf_data, rescal_data  # noqa: F401
