"""Environment-map + Phong BRDF fitting sample (cube-map texturing;
PyTorch port).

Counterpart of samples/envphong.py (the reference's
samples/torch/envphong.py:113-227): fit a cube-map environment and Phong
parameters from renders of a shiny sphere, with per-pixel reflection
vectors (diff_attrs='all') and seamless trilinear cube-map sampling.

Usage: python samples/torch/envphong.py [--max-iter 1000]
       [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch


def main():
    ap = argparse.ArgumentParser(description="Environment phong fit example")
    ap.add_argument("--max-iter", type=int, default=1000)
    ap.add_argument("--log-interval", type=int, default=100)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--env-res", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch sees no CUDA device "
                         "(pass --device cpu to run on the CPU)")

    from nvdiffrast_tpu_torch.models.fit_envphong import EnvPhongFitModel

    model = EnvPhongFitModel(res=args.res, env_res=args.env_res, device=args.device)
    model.fit(max_iter=args.max_iter, log_interval=args.log_interval)
    env_rmse, img_rmse, exp_rel_err = model.metrics()
    print(f"final env RMSE: {env_rmse:.6f}, phong RGB RMSE: {img_rmse:.6f}, "
          f"exponent relative error: {exp_rel_err:.6f}")


if __name__ == "__main__":
    main()
