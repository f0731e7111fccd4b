"""Cube fitting sample: vertex position + colour optimisation (PyTorch
port).

Counterpart of samples/cube.py (the reference's samples/torch/cube.py:40-158):
fit cube geometry and vertex colours from low-resolution renders;
antialias position gradients are what make convergence possible at
4-16 px.

Usage: python samples/torch/cube.py [--resolution 16] [--discontinuous]
       [--max-iter 1000] [--log-interval 100] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch


def main():
    ap = argparse.ArgumentParser(description="Cube fit example")
    ap.add_argument("--discontinuous", action="store_true",
                    help="use the split-vertex (discontinuous) cube")
    ap.add_argument("--resolution", type=int, default=16,
                    help="rendering resolution (reference uses 4-16)")
    ap.add_argument("--max-iter", type=int, default=1000)
    ap.add_argument("--log-interval", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch sees no CUDA device "
                         "(pass --device cpu to run on the CPU)")

    from nvdiffrast_tpu_torch.models.fit_cube import CubeFitModel

    model = CubeFitModel(resolution=args.resolution, discontinuous=args.discontinuous,
                         lr=args.lr, device=args.device)
    err = model.fit(max_iter=args.max_iter, log_interval=args.log_interval)
    print(f"final geometric error: {err:.6f}")


if __name__ == "__main__":
    main()
