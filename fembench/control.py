"""The control of the benchmark's comparison, and sound readings beside it.

    python3 -m fembench.control --workload <cell> --seeds <n> [<n> ...]
                                [--program]

The control is the plain reference put in the program's place and computed
one precision below what the configuration states: the outer CG and its
operator in float32 (stated: float64) and the V-cycle in float32 with TF32
matrix products (stated: float32 with TF32 off).  For each seed it solves
the sampled right-hand sides of a run, applies its V-cycle to them, and
hands both to the same comparison as a run's answers
(``check.Judge``); every line printed is one seed's compared
numbers beside the cell's limits.  The comparison has to find the control
wrong.  ``--program`` reads the program's own answers instead, at the same
right-hand sides, without a timed window: the sound readings the limits
are set above.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, harness


class ControlAnswers:
    """The reference in float32 with TF32 products, in the program's place
    (its answers in the reference's own numbering)."""

    points = None  # no program: no numbering to match

    def __init__(self, cell: dict, device):
        config = cell["config"]
        self.ref = harness.reference(cell)
        self.tol = float(config["solver"]["rel tolerance"])
        with _tf32():
            self.outer, self.V = self.ref.build(config, device=device,
                                                outer_dtype=torch.float32,
                                                level_dtype=torch.float32)

    def __call__(self, rhs, sample) -> tuple:
        kept, vcycles = {}, {}
        with _tf32():
            for k in sample:
                b = rhs(k).to(torch.float32)
                x, it, conv, res = self.ref.cg(self.outer.vmult, b,
                                               self.V.vmult, self.tol)
                kept[k] = harness.Kept(x.double().cpu(), res[0], res[-1],
                                       it, conv)
                vcycles[k] = self.V.vmult(b).cpu()
        return kept, vcycles


class _tf32:
    """TF32 matrix products on, for the control's float32 reference."""

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.was


class ProgramAnswers:
    """The program, set up as a run sets it up; its answers without a
    timed window."""

    def __init__(self, cell: dict, device):
        self.prog = harness.set_up(cell["config"], device)
        self.points = self.prog.points

    def __call__(self, rhs, sample) -> tuple:
        kept, vcycles = {}, {}
        for k in sample:
            b = rhs(k)
            r = self.prog.solve(b)
            kept[k] = harness.Kept(r.x.cpu(), r.residuals[0], r.residuals[-1],
                                   r.n_iterations, r.converged)
            vcycles[k] = self.prog.M(b).cpu()
        return kept, vcycles


def readings(cell: dict, seeds, program: bool, device):
    """One dict of compared numbers per seed; the answers' source and the
    float64 judge are built once."""
    answers = (ProgramAnswers if program else ControlAnswers)(cell, device)
    nb = harness.numbering(cell, answers.points)
    if nb.mismatch is not None:
        raise SystemExit(f"fembench.control: {nb.mismatch}")
    judge = check.Judge(cell, device, nb.perm)
    for seed in seeds:
        rhs = harness.right_hand_sides(cell, seed, nb, device)
        sample = harness.sample_of(seed, rhs.count, harness.SAMPLE)
        kept, vcycles = answers(rhs, sample)
        yield {"seed": seed, "numbers": judge.numbers(rhs, kept, vcycles),
               "iterations": [kept[k].iterations for k in sorted(kept)],
               "converged": [kept[k].converged for k in sorted(kept)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fembench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    limits = cell["workload"]["limits"]
    for r in readings(cell, args.seeds, args.program, "cuda"):
        r["limits"] = limits
        r["wrong"] = [n for n, v in r["numbers"].items() if v > limits[n]]
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
