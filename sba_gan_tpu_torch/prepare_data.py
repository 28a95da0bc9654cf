"""Build the multi-resolution pack of the gen-2 CLI (the JAX package's
``prepare_data.py``): the flags ``--out --n_worker --img_path --txt_path
--dataset`` and ``--sizes``, over :func:`data.multires.build_multires`.

Usage:
    python -m sba_gan_tpu_torch.prepare_data --out data/pack \\
        --img_path data/birds/images --txt_path data/birds/text \\
        --dataset birds --n_worker 4
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from sba_gan_tpu_torch.data.multires import DEFAULT_SIZES, build_multires


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Build a multi-resolution pack")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--n_worker", type=int, default=4)
    p.add_argument("--img_path", type=str, required=True)
    p.add_argument("--txt_path", type=str, required=True)
    p.add_argument("--dataset", default="birds", choices=["birds", "coco"])
    p.add_argument("--sizes", type=int, nargs="+", default=list(DEFAULT_SIZES))
    args = p.parse_args(argv)
    total = build_multires(args.img_path, args.txt_path, args.out,
                           sizes=tuple(args.sizes), n_worker=args.n_worker,
                           dataset=args.dataset)
    print(f"Total samples: {total}")
    return total


if __name__ == "__main__":
    main()
