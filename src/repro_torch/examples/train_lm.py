"""End-to-end driver: train a ~100M-parameter llama-family model for a few
hundred steps on the synthetic pipeline, with checkpoints and auto-resume
(the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 4

A reduced run of ``repro_torch.launch.train`` (the same code path): width
512, 12 layers of the llama3.2 family, sequences of 512, batches of 8.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt_demo"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return train_main([
        "--arch", "llama3.2-1b",
        "--d-model", "512",
        "--layers", "12",
        "--seq", "512",
        "--batch", "8",
        "--steps", str(args.steps),
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--log-every", "20",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
