"""Smoke test: rasterize one triangle and save tri.png (PyTorch port).

Counterpart of samples/triangle.py, the reference's install check
(samples/torch/triangle.py:17-30): "Running this should be the first
step to verify that you have everything set up correctly". On the card
it builds the port's kernels at first use.

Usage: python samples/torch/triangle.py [--outdir .] [--res 256]
       [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.utils.image import save_image


def render(res, device):
    """The triangle's interpolated vertex colours [res, res, 3] as numpy."""
    pos = torch.tensor([[[-0.8, -0.8, 0, 1], [0.8, -0.8, 0, 1], [-0.8, 0.8, 0, 1]]],
                       dtype=torch.float32, device=device)
    col = torch.tensor([[[1, 0, 0], [0, 1, 0], [0, 0, 1]]], dtype=torch.float32,
                       device=device)
    tri = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=device)
    rast, _ = dr.rasterize(dr.RasterizeCudaContext(), pos, tri, resolution=(res, res))
    out, _ = dr.interpolate(col, rast, tri)
    return out[0].cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch sees no CUDA device "
                         "(pass --device cpu to run on the CPU)")

    img = render(args.res, args.device)
    print(f"Saving to '{args.outdir}/tri.png'.")
    save_image(os.path.join(args.outdir, "tri.png"), img)


if __name__ == "__main__":
    main()
