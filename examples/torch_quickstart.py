"""Quickstart on the port: Binary Bleed in 30 lines.

The PyTorch/CUDA twin of ``examples/quickstart.py``: find the optimal NMF
rank k for a synthetic dataset with a planted k=5, comparing Binary Bleed
against the standard exhaustive grid search. Runs on the card by default,
where every MU sweep and silhouette is a hand-written kernel;
``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's draws are its own (a ``torch.Generator`` per seed), not the
reference's bits, so the visited scores differ from the JAX example's.
"""
import argparse

from repro_torch.core import binary_bleed_search, grid_search
from repro_torch.device import resolve
from repro_torch.factorization import make_nmfk_evaluator, nmf_data

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

# 1. a dataset with 5 latent components
v, _, _ = nmf_data(n=96, m=104, k_true=5, seed=0, device=resolve(args.device))

# 2. the scorer: NMFk silhouette stability (perturbation ensemble)
evaluate = make_nmfk_evaluator(v, seed=0, n_perturbs=4, nmf_iters=100)

# 3. Binary Bleed over K = {2..16} with select threshold 0.9
result = binary_bleed_search(
    evaluate,
    k_range=(2, 16),
    select_threshold=0.9,
    stop_threshold=0.2,  # Early Stop (paper §III-C)
    num_resources=1,     # serial Algorithm 1; >1 = parallel resources
)
baseline = grid_search(evaluate, (2, 16), select_threshold=0.9)

print(f"Binary Bleed : k_optimal={result.k_optimal} "
      f"visited {result.n_visited}/{result.n_candidates} "
      f"({100 * result.visit_fraction:.0f}% of K) -> {sorted(result.visited_ks)}")
print(f"Grid search  : k_optimal={baseline.k_optimal} "
      f"visited {baseline.n_visited}/{baseline.n_candidates} (100% of K)")
assert result.k_optimal == baseline.k_optimal == 5
