"""K-Means + Davies-Bouldin minimization with Early Stop (paper §IV-A), on the port.

The PyTorch/CUDA twin of ``examples/kmeans_earlystop.py``: Gaussian blobs
(std 0.5 + noise), the DB index as the score (LOWER is better ->
minimization mode), Early Stop pruning the upper k range once the score
blows past the stop bound. Runs on the card by default, where the distances
are the hand-written pairwise kernels; ``--device cpu`` runs their plain
versions.

    PYTHONPATH=src python examples/torch_kmeans_earlystop.py [--device cpu]

The port's draws are its own (a ``torch.Generator`` per seed), not the
reference's bits, so the visited scores differ from the JAX example's.
"""
import argparse

from repro_torch.core import binary_bleed_search, davies_bouldin_score
from repro_torch.device import resolve
from repro_torch.factorization import blob_data, kmeans

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

x, _ = blob_data(n=300, d=6, k_true=7, std=0.5, spread=8.0, seed=1, device=resolve(args.device))


def evaluate(k: int, should_abort=None) -> float:
    res = kmeans(x, int(k), seed=1)
    return float(davies_bouldin_score(x, res.labels, int(k)))


result = binary_bleed_search(
    evaluate,
    k_range=(2, 24),
    select_threshold=0.6,   # DB <= 0.6 selects (good separation)
    stop_threshold=1.6,     # DB >= 1.6 can never recover -> prune upward
    mode="minimize",
    num_resources=2,
)
print(f"k_optimal={result.k_optimal} (true 7), visited "
      f"{result.n_visited}/{result.n_candidates} k values: {sorted(result.visited_ks)}")
for v in sorted(result.visits, key=lambda v: v.k):
    print(f"  k={v.k:2d} DB={v.score:.3f}"
          + ("  <- selects" if v.pruned_lower else "")
          + ("  <- stops" if v.pruned_upper else ""))
