"""Distributed + parallel Binary Bleed on the port — the paper end to end.

The PyTorch/CUDA twin of ``examples/distributed_ksearch.py``. Four
"resources" (worker threads) search K = {2..20} concurrently: Algorithm 2
deals k values round-robin, each resource walks its pre-order worklist,
and threshold crossings broadcast prune bounds through the shared
coordinator. Each k evaluation also runs a distributed NMF fit over the
resource's own process group (the paper's pyDNMFk mode; one-rank groups in
one process here). The journal makes the search restartable: kill this
script mid-run and re-run it with the same ``--journal`` — completed k
values are never re-fit. Runs on the card by default (NCCL groups);
``--device cpu`` runs the plain versions of the kernels on gloo groups.

    PYTHONPATH=src python examples/torch_distributed_ksearch.py [--device cpu] [--journal DIR]

The port's draws are its own, not the reference's bits, so the visited
scores differ from the JAX example's; both select the planted k = 6.
"""
import argparse
import tempfile

from repro_torch.launch.ksearch import main

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--journal", default=None, help="journal directory (default: a new temporary one)")
args = ap.parse_args()

journal = args.journal or tempfile.mkdtemp(prefix="bleed_journal_")
out = main([
    "--n", "128", "--m", "144",
    "--k-true", "6",
    "--k-min", "2", "--k-max", "20",
    "--resources", "4",
    "--threshold", "0.9",
    "--early-stop",
    "--order", "pre",
    "--nmf-iters", "100",
    "--n-perturbs", "4",
    "--distributed-fit",
    "--journal", journal,
    "--device", args.device,
    "--quiet",
])
print(f"k_optimal={out['k_optimal']}: visited {out['n_visited']}/{out['n_candidates']} k values "
      f"({100 * out['visit_fraction']:.0f}%) on {out['resources']} resources; journal: {journal}")
assert out["k_optimal"] == 6
