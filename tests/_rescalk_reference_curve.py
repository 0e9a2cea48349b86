"""RESCALk score curves of chip_smoke.py's ``rescalk_1000`` X on the CPU: the
port's and the JAX reference's, on the same X.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_rescalk_reference_curve.py [--which port|reference|both]

X is ``repro_torch``'s ``rescal_data`` drawn on the CPU (1000 entities, 4
relations, k_true 4, noise 0.003, seed 0), the X that ``chip_smoke.py``
moves to the card; the reference gets it as a numpy array. Each side runs
its own Binary Bleed search (k 2..11, select 0.8, stop 0.25, P 3, 150
sweeps, serial) with its own draws (the port's seed 0, the reference's
``PRNGKey(0)``), then scores every k it did not visit. Prints one JSON line
per side: ``k_optimal``, the visited ks and the whole curve. The port's
side takes seconds, the reference's minutes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import RESCAL_DATA, RESCAL_EPS, RESCAL_ITERS, RESCAL_P, RESCAL_SEARCH  # noqa: E402


def curve(which: str, x) -> dict:
    import numpy as np

    if which == "port":
        from repro_torch.core import binary_bleed_search
        from repro_torch.factorization.rescal import make_rescalk_evaluator

        evaluate = make_rescalk_evaluator(x, seed=0, n_perturbs=RESCAL_P, iters=RESCAL_ITERS, epsilon=RESCAL_EPS)
    else:
        import jax

        from repro.core import binary_bleed_search
        from repro.factorization.rescal import make_rescalk_evaluator

        evaluate = make_rescalk_evaluator(np.asarray(x), jax.random.PRNGKey(0), n_perturbs=RESCAL_P,
                                          iters=RESCAL_ITERS)
    scores = {}

    def scored(k, should_abort=None):
        scores[k] = evaluate(k)
        return scores[k]

    t0 = time.perf_counter()
    res = binary_bleed_search(scored, **RESCAL_SEARCH, num_resources=1)
    search_s = time.perf_counter() - t0
    lo, hi = RESCAL_SEARCH["k_range"]
    for k in range(lo, hi + 1):
        if k not in scores:
            scored(k)
    return {"which": which, "k_optimal": res.k_optimal, "visited": sorted(res.visited_ks),
            "search_cpu_s": search_s, "curve": {k: scores[k] for k in sorted(scores)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--which", choices=("port", "reference", "both"), default="both")
    args = ap.parse_args(argv)
    from repro_torch.factorization.synthetic import rescal_data

    x = rescal_data(**RESCAL_DATA, device="cpu")[0]
    for which in (("port", "reference") if args.which == "both" else (args.which,)):
        print(json.dumps(curve(which, x)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
