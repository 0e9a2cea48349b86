"""End-to-end LM training on a reduced assigned architecture, on the port
(the twin of ``examples/train_lm.py``).

Trains 200 steps of the reduced granite-MoE config (real MoE routing,
gradient accumulation over 4 microbatches, AdamW, async checkpoints every
50 steps) and asserts that the loss drops by more than 0.3 nats. Runs on
the card by default; ``--device cpu`` runs the plain PyTorch path.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch.train import main


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="lm_ckpt_") as ckpt:
        out = main([
            "--arch", args.arch,
            "--steps", str(args.steps),
            "--batch", "16", "--seq", "64",
            "--microbatches", "4",
            "--lr", "1e-3",
            "--ckpt", ckpt, "--ckpt-every", "50",
            "--device", args.device,
        ])
    drop = out["losses"][0] - out["final_loss"]
    print(f"\nloss dropped {drop:.3f} nats over {args.steps} steps")
    if not drop > 0.3:
        raise AssertionError(f"expected clear learning progress, the loss dropped {drop:.3f} nats")
    return out


if __name__ == "__main__":
    run()
