"""Pose fitting sample: recover a rotation from rendered images (PyTorch
port).

Counterpart of samples/pose.py (the reference's samples/torch/pose.py:120-249):
two phases (random search, then gradient descent) recover a cube's pose
from colour renders; the gradient phase relies on antialias position
gradients.

Usage: python samples/torch/pose.py [--max-iter 300] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch


def main():
    ap = argparse.ArgumentParser(description="Pose fit example")
    ap.add_argument("--max-iter", type=int, default=300)
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch sees no CUDA device "
                         "(pass --device cpu to run on the CPU)")

    from nvdiffrast_tpu_torch.models.fit_pose import PoseFitModel

    model = PoseFitModel(resolution=args.resolution, device=args.device)
    err = model.fit(max_iter=args.max_iter, log_interval=args.log_interval)
    print(f"final pose angle error: {err:.4f} degrees")


if __name__ == "__main__":
    main()
