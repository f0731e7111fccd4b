"""Earth texture-fitting sample: learn a texture, with or without mips
(PyTorch port).

Counterpart of samples/earth.py (the reference's samples/torch/earth.py:43-173):
learn a sphere texture from renders; `--mip` enables trilinear sampling
with uv derivatives (interpolate diff_attrs='all' -> texture
linear-mipmap-linear), which is what removes aliasing in the learned
texture. The reference's earth.npz is not in the repository, so the
target texture is procedural (``primitives.checkerboard_texture``); the
optimisation and the texture-PSNR metric are the reference's.

Usage: python samples/torch/earth.py [--mip | --no-mip] [--max-iter 1000]
       [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch


def main():
    ap = argparse.ArgumentParser(description="Earth texture fit example")
    mip = ap.add_mutually_exclusive_group()
    mip.add_argument("--mip", dest="mip", action="store_true", default=True)
    mip.add_argument("--no-mip", dest="mip", action="store_false")
    ap.add_argument("--max-iter", type=int, default=1000)
    ap.add_argument("--log-interval", type=int, default=100)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--max-mip-level", type=int, default=9)
    ap.add_argument("--tex-res", type=str, default="128x256",
                    help="texture HxW; the reference's atlas is 1536x2048 "
                         "(samples/torch/earth.py:73)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch sees no CUDA device "
                         "(pass --device cpu to run on the CPU)")

    from nvdiffrast_tpu_torch.models.fit_earth import EarthFitModel

    th, tw = (int(x) for x in args.tex_res.split("x"))
    model = EarthFitModel(res=args.res, enable_mip=args.mip, max_mip_level=args.max_mip_level,
                          tex_res=(th, tw), device=args.device)
    psnr = model.fit(max_iter=args.max_iter, log_interval=args.log_interval)
    print(f"final texture PSNR: {psnr:.2f} dB (mip={'on' if args.mip else 'off'})")


if __name__ == "__main__":
    main()
