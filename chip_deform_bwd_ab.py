#!/usr/bin/env python3
"""Two designs of the deformable-attention backward kernel timed in turns on
one CUDA card: the kernel the port launches
(``dfine_tpu_torch/csrc/ms_deform_attn_bwd.cu``) and an earlier source of it
with the same C interface, ``ms_deform_attn_bwd(value, loc, att, g_out,
grad_att, grad_loc, idx, contrib, B, S, Q, H, D, P, value_is_bf16,
payload_is_bf16, n_levels, level_info, stream)``::

    git show <commit>:dfine_tpu_torch/csrc/ms_deform_attn_bwd.cu > dfine_tpu_torch/_build/earlier_bwd.cu
    python3 chip_deform_bwd_ab.py dfine_tpu_torch/_build/earlier_bwd.cu

From the root of a checkout, on the card only. It builds both sources the
same way (``chip_smoke.build_source``), then, at m@640 (levels
(80, 80), (40, 40), (20, 20), points (3, 6, 3)), B = 8, 8 heads, bf16 value,
locations in [-0.15, 1.15]: Q = 300 at head dim 32 and 64 with the f32 and
the bf16 payload, and the train step's Q = 500 at head dim 32 and 64 with
the f32 payload. In each case it holds the two outputs equal (idx equal,
contrib bit-equal, grad_att and grad_loc within GRAD_REL_TOL of their
largest value) and times each (device ms by the profiler, CUDA events where
it sees none; 100 calls) in the order earlier, kernel, kernel, earlier,
beside the bound of the case's data (``chip_smoke._bwd_bound``) and the
time of one ``zero_`` of the outputs' bytes (``write_floor_ms``). Prints one
JSON line (both builds' ptxas lines, every turn, the means, the shares of
the bound), then the card's name and power limit; exits 1 if any output
differs.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys

import numpy as np

import chip_smoke as cs

TURNS = ("earlier", "kernel", "kernel", "earlier")
# (name, head dim, payload, queries)
CASES = (("d32_float32_payload", 32, "float32", cs.QUERIES),
         ("d32_bfloat16_payload", 32, "bfloat16", cs.QUERIES),
         ("d64_float32_payload", 64, "float32", cs.QUERIES),
         ("d64_bfloat16_payload", 64, "bfloat16", cs.QUERIES),
         ("q500_d32_float32_payload", 32, "float32", cs.TRAIN_QUERIES),
         ("q500_d64_float32_payload", 64, "float32", cs.TRAIN_QUERIES))
CALLS = 100


def in_turns(time_one, order=TURNS) -> dict:
    """``time_one(who)`` (ms) for each entry of ``order``, in that order:
    {who: [ms, ...]} in the order taken."""
    out = {}
    for who in order:
        out.setdefault(who, []).append(time_one(who))
    return out


def means(turns: dict) -> dict:
    """{who: the mean of who's turns}."""
    return {who: sum(ms) / len(ms) for who, ms in turns.items()}


def output_bytes(out) -> int:
    """The bytes of one backward's outputs (grad_att, grad_loc, and every
    level's idx and contrib)."""
    grad_att, grad_loc, idx, contrib = out
    return sum(t.numel() * t.element_size() for t in (grad_att, grad_loc, *idx, *contrib))


def write_floor_ms(nbytes: int) -> float:
    """Device ms of one ``zero_`` of ``nbytes`` on the card: what writing
    the kernel's outputs alone takes there."""
    import torch

    buf = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    return cs.timings("", buf.zero_, CALLS)["ms"]


@contextlib.contextmanager
def launching(fn):
    """The port's wrapper ``ms_deform_attn_bwd`` with its C entry replaced
    by ``fn`` (the same argument list)."""
    from dfine_tpu_torch.ops.kernels import deform_attn as kda

    port = kda._bwd_lib
    kda._bwd_lib = lambda: fn
    try:
        yield
    finally:
        kda._bwd_lib = port


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="the earlier ms_deform_attn_bwd.cu")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_deform_bwd_ab: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from dfine_tpu_torch.ops.kernels import _build
    from dfine_tpu_torch.ops.kernels import deform_attn as kda

    port = kda._bwd_lib()  # the binding's argument list
    fns, ptxas = {}, {}
    for who, path in (("earlier", args.source),
                      ("kernel", _build.CSRC_DIR / "ms_deform_attn_bwd.cu")):
        lib, ptxas[who] = cs.build_source(path, f"ms_deform_attn_bwd_{who}")
        fns[who] = lib.ms_deform_attn_bwd
        fns[who].argtypes, fns[who].restype = port.argtypes, port.restype
    dev = torch.device("cuda")
    cases = {}
    for name, d, payload_name, q in CASES:
        payload = getattr(torch, payload_name)
        v, l, a = cs._deform_inputs(dev, cs.GRAD_BATCH, d, cs.M_SHAPES, cs.M_POINTS,
                                    torch.bfloat16, seed=11, q=q)
        g = torch.from_numpy(np.random.default_rng(12).normal(
            size=(cs.GRAD_BATCH, q, cs.HEADS * d)).astype(np.float32)).to(dev)

        def call():
            return kda.ms_deform_attn_bwd(v, cs.M_SHAPES, l, a, g, cs.M_POINTS, payload)

        outs = {}
        for who, fn in fns.items():
            with launching(fn):
                outs[who] = call()
        cs.sync()
        check = cs.bwd_compared(outs["kernel"], outs["earlier"])
        del outs

        def time_one(who):
            with launching(fns[who]):
                return cs.timings("", call, CALLS)["ms"]

        turns = in_turns(time_one)
        bound_ms, bound_by = cs._bwd_bound(v, l, a, payload)
        out_bytes = output_bytes(call())
        mean = means(turns)
        cases[name] = {"head_dim": d, "payload": payload_name, "queries": q, **check,
                       "equal": cs.bwd_equal(check), "ms_in_turns": turns,
                       **{f"{who}_ms": ms for who, ms in mean.items()},
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "write_floor_ms": write_floor_ms(out_bytes), "output_bytes": out_bytes,
                       **{f"{who}_share_of_bound": bound_ms / ms for who, ms in mean.items()}}
        del v, l, a, g
    equal = all(c["equal"] for c in cases.values())
    cs.emit({"deform_bwd_ab": f"m@640, B = {cs.GRAD_BATCH}, {cs.HEADS} heads, bf16 value",
             "earlier_source": args.source, "earlier_ptxas": ptxas["earlier"],
             "kernel_ptxas": ptxas["kernel"],
             "turns": list(TURNS), "calls_a_turn": CALLS, "tol_rel": cs.GRAD_REL_TOL,
             "equal_outputs": equal, "cases": cases})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
