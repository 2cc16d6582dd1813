"""CLI entry point:
``python -m sdag_tpu_torch.pipeline.cli [config.json] [--device cpu]``.

Same invocation shape as the JAX package's CLI and the reference
(``python -m src.pipeline.main [config.json]``).  The device defaults to
CUDA and the run raises when CUDA is missing; ``--device cpu`` runs the
plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

from sdag_tpu_torch.config import make_config
from sdag_tpu_torch.pipeline.orchestrator import run_experiment


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="sdag_tpu_torch.pipeline.cli")
    parser.add_argument("config", nargs="?", default=None,
                        help="JSON config overrides")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    run_experiment(make_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
