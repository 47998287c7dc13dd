"""CLI: python -m dealii_asm_tpu_torch config.json [...] [--device cuda]

Runs each JSON config through the port's ``run_config`` (one table row each)
and prints the org-mode convergence table, like ``python -m dealii_asm_tpu``.
A config with "n devices" N > 1 runs under torchrun, one process per
device (``torchrun --nproc-per-node N -m dealii_asm_tpu_torch cfg.json``);
rank 0 logs and prints the table.
"""

import argparse
import json
import sys

from .models.poisson import run_config
from .utils.table import ConvergenceTable


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dealii_asm_tpu_torch")
    ap.add_argument("configs", nargs="+", help="JSON config files")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    table = ConvergenceTable()
    for path in args.configs:
        with open(path) as f:
            params = json.load(f)
        run_config(params, table, device=args.device)
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        table.print()
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
