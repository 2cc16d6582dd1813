"""CLI entry point:
``python -m sdag_tpu_torch.pipeline.cli [config.json] [--device cpu]``.

Same invocation shape as the JAX package's CLI and the reference
(``python -m src.pipeline.main [config.json]``).  The device defaults to
CUDA and the run raises when CUDA is missing; ``--device cpu`` runs the
plain PyTorch path.

Under torchrun (``torchrun --nproc-per-node N -m
sdag_tpu_torch.pipeline.cli cfg.json``, or ``python -m
torch.distributed.run``) each rank joins the process group (NCCL on CUDA,
gloo on the CPU), runs on ``cuda:LOCAL_RANK`` unless ``--device`` names a
device, serves the config's meshes, and rank 0 alone writes the results;
the group is destroyed at exit.  Without torchrun's environment no group
is made and the run is one process on one device.
"""

from __future__ import annotations

import argparse
import sys

import torch.distributed as dist

from sdag_tpu_torch.config import make_config
from sdag_tpu_torch.core.mesh import maybe_init_distributed, rank_device
from sdag_tpu_torch.pipeline.orchestrator import run_experiment


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="sdag_tpu_torch.pipeline.cli")
    parser.add_argument("config", nargs="?", default=None,
                        help="JSON config overrides")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda, cuda:LOCAL_RANK "
                             "under torchrun)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    dev = rank_device(args.device)
    maybe_init_distributed(dev)
    try:
        run_experiment(make_config(args.config), device=dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
