"""Readings that the limits of a cell are set from (``perfbench/limits``),
on the card at the cell's own size, many seeds in one process:

    python3 -m perfbench.calibrate --workload <cell> --seeds 11,12,13 [--seconds 3] [--faults]

For each seed, the ``calibrate`` of the cell's traffic kind
(``perfbench/kinds/<kind>.py``) gives the program's numbers, the control's
(the reference in fp8 put in the program's place, against the fp32
reference) and, with ``--faults``, the numbers of each fault the kind
plants in the program (its ``FAULTS``). One JSON line a seed on standard
output, and with ``--out`` the same lines appended to that file. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench import manifest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    kind = manifest.kind(cell["mix"]["kind"])
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = kind.FAULTS if args.faults else ()
    for seed, res in kind.calibrate(cell, seeds, args.seconds, faults, "cuda"):
        line = json.dumps({"workload": args.workload, "seed": seed, **res})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
