#!/usr/bin/env python3
"""Two designs of the exact Hungarian solver timed in turns on one CUDA card,
on the m train step's own matching costs: the kernel the port launches
(``dfine_tpu_torch/csrc/hungarian_lap.cu``) and an earlier source of it
with the first design's C interface, ``hungarian_lap(cost, row_valid, V,
out, P, G, Q, stream)`` (no step count)::

    git show <commit>:dfine_tpu_torch/csrc/hungarian_lap.cu > dfine_tpu_torch/_build/first.cu
    python3 chip_hungarian_ab.py dfine_tpu_torch/_build/first.cu

From the root of a checkout, on the card only. It runs ``chip_smoke.py``'s
build and m train phases, takes one more step's [S, B, G, Q] costs and
[B, G] mask, holds the two solvers' assignments equal there, and times
each (CUDA events, 50 calls) on those costs and on the same costs with no
pending row, in the order earlier, kernel, kernel, earlier. Prints one JSON
line (both builds' ptxas lines, every turn, the means), then the card's
name and power limit; exits 1 if the assignments differ.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import chip_smoke as cs


def earlier_solver(path: str):
    """The solver built from ``path`` (``chip_smoke.build_source``): a call
    ``solve(costs [S, B, G, Q], valid [B, G]) -> [S, B, G] int32``, with the
    build's ptxas lines as ``solve.ptxas``."""
    import torch

    lib, ptxas = cs.build_source(path, "hungarian_lap_earlier")
    fn = lib.hungarian_lap
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def solve(costs, valid):
        s, b, g, q = costs.shape
        out = torch.empty((s, b, g), dtype=torch.int32, device=costs.device)
        if fn(costs.data_ptr(), valid.data_ptr(), b, out.data_ptr(), s * b, g, q,
              torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"the solver of {path}: launch failed")
        return out
    solve.ptxas = ptxas
    return solve


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="the earlier hungarian_lap.cu")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_hungarian_ab: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from dfine_tpu_torch.ops.kernels import hungarian_lap

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    cs.phase_build(res)
    cs.phase_train(res)
    state, step, batch, gen = res["train_run"]
    calls = []
    with cs.captured_matching(calls):
        step(state, batch, gen)
    cs.sync()
    costs, valid = calls[0]
    no_pending = cs._no_pending(costs, valid)
    earlier = earlier_solver(args.source)
    equal = (torch.equal(earlier(costs, valid), hungarian_lap(costs, valid))
             and torch.equal(earlier(no_pending, valid), hungarian_lap(no_pending, valid)))
    turns = {"earlier": [], "kernel": [], "earlier_no_pending": [], "kernel_no_pending": []}
    for who in ("earlier", "kernel", "kernel", "earlier"):
        solve = earlier if who == "earlier" else hungarian_lap
        turns[who].append(cs.timings("", lambda: solve(costs, valid), 50)["ms"])
        turns[f"{who}_no_pending"].append(cs.timings("", lambda: solve(no_pending, valid),
                                                     50)["ms"])
    cs.emit({"hungarian_ab": f"m@640 train step's costs {list(costs.shape)}",
             "earlier_source": args.source, "earlier_ptxas": earlier.ptxas,
             "equal_assignments": equal, "ms_in_turns": turns,
             **{f"{k}_ms": sum(v) / len(v) for k, v in turns.items()}})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
