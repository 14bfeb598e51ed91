"""Train olmo-1b's smoke config for a few hundred steps on PyTorch (the
twin of examples/train_small.py over ``repro_torch``); --full-100m, the
JAX example's flag, trains the published olmo-1b config instead.

    PYTHONPATH=src python examples/train_small_torch.py [--steps 200] \
        [--device cpu]

This drives repro_torch.launch.train (checkpointing, preemption handling,
straggler detection, remat included) on CUDA unless ``--device cpu`` is
given.  Checkpoints go to build/train_small_torch in the checkout unless
--ckpt-dir says otherwise.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-100m", action="store_true",
                    help="the published olmo-1b config; the default is "
                    "the smoke config")
    ap.add_argument("--ckpt-dir", default=str(
        Path(__file__).resolve().parent.parent / "build" /
        "train_small_torch"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    argv = ["--arch", "olmo-1b", "--steps", str(args.steps),
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
            "--batch", "8", "--seq-len", "128", "--lr", "3e-3",
            "--device", args.device]
    if not args.full_100m:
        argv.append("--smoke")
    return train_main(argv)


if __name__ == "__main__":
    sys.exit(main())
