"""Binary Bleed core: the paper's contribution as a composable library.

The search layer is the reference's pure-Python driver; ``scoring`` is the
PyTorch counterpart of the silhouette and Davies-Bouldin scorers. There is no jit cache to
persist, so the reference's ``compile_cache`` has no counterpart here.
"""
from .api import (  # noqa: F401
    ElasticWavefrontScheduler,
    EvalPlane,
    LaneRefillPolicy,
    Mode,
    ScalarEvalPlane,
    ScheduleTrace,
    SearchResult,
    SearchSpace,
    SimulatedScheduler,
    ThreadPoolScheduler,
    WavefrontScheduler,
    as_eval_plane,
    binary_bleed_recursive,
    binary_bleed_search,
    binary_bleed_worklist,
    grid_search,
    make_space,
    standard_search,
)
from .evalplane import Wave  # noqa: F401
from .chunking import chunk_block, chunk_skip_mod, plan_worklists, rebalance  # noqa: F401
from .coordinator import Bounds, FileCoordinator, InProcessCoordinator  # noqa: F401
from .scheduler import ResourceEvent  # noqa: F401
from .scoring import (  # noqa: F401
    cluster_dist_sums,
    davies_bouldin_score,
    davies_bouldin_score_masked,
    laplacian_score,
    pairwise_sq_dists,
    silhouette_samples_masked,
    silhouette_score,
    silhouette_score_masked,
    square_wave_score,
)
from .traversal import traversal_sort  # noqa: F401
