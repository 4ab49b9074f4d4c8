"""One run of one cell of ``BENCHMARK.json``:

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's result as the last line of
standard output (one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``check``: each number compared with the reference beside its limit), and
the same numbers as the last lines of standard error. Exits non-zero,
printing no result, without a CUDA card (or fewer than the cell asks for),
or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run at a fixed path inside the checkout
CACHE = CHECKOUT / "perfbench" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dfine_tpu")


def forbidden_modules():
    """Modules in ``sys.modules`` whose top-level name (before the first
    dot) is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(cell, rec, traced: bool, device_info) -> dict:
    from perfbench import judge, manifest

    metrics = {}
    for m in cell["per_layer"] if traced else cell["end_to_end"]:
        value = manifest.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, check = judge.verdict(rec["numbers"], cell["limits"])
    out = {"correct": bool(correct and rec["failed"] == 0), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device_info}
    if traced and "profile" in rec:
        out["device"]["busy_s"] = rec["profile"]["busy_s"]
        out["device"]["window_s"] = rec["profile"]["window_s"]
        out["breakdown"] = {"device_ops": rec["profile"]["device_ops"],
                            "idle_gaps": rec["profile"]["idle_gaps"]}
    out["check"] = check
    return out


def run(argv=None, device=None, root: Path = CHECKOUT) -> dict:
    """The run's result. ``device`` None looks for the cards the cell asks
    for and fails without them; a test passes ``"cpu"`` to drive the rest
    of a run where there is no card."""
    args = parse(argv)
    from perfbench import manifest

    cell = manifest.cell(args.workload, root)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"perfbench: the cell needs {cell['chips']} CUDA card(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    rec = manifest.kind(cell["mix"]["kind"]).run(cell, args.seed, args.seconds,
                                                 bool(args.trace), device, T_START)
    on_card = torch.device(device).type == "cuda"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell["chips"], "memory_peak_bytes": rec["memory_peak_bytes"],
            "power_limit": power_limit() if on_card else None}
    return result(cell, rec, bool(args.trace), info)


def main(argv=None) -> int:
    out = run(argv)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    from perfbench import judge

    judge.print_check(out["check"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
