"""Fit each COLMAP image's mono-depth scale and offset, as the repository's
root ``make_depth_scale.py`` does for the JAX package:

    python -m gaussian_splatting_torch.make_depth_scale --base_dir <scene> --depths_dir <dir>

Writes ``<scene>/sparse/0/depth_params.json``, which training with
``-d <dir>`` reads.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from gaussian_splatting_torch.data.depth_scale import make_depth_scales


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base_dir", required=True)
    parser.add_argument("--depths_dir", required=True)
    parser.add_argument("--model_type", default="bin", choices=["bin", "txt"])
    parser.add_argument("--jobs", type=int, default=8)
    args = parser.parse_args(argv)
    params = make_depth_scales(
        args.base_dir, args.depths_dir, model_ext=args.model_type, jobs=args.jobs
    )
    print(f"wrote depth_params.json for {len(params)} images")
    return params


if __name__ == "__main__":
    main()
