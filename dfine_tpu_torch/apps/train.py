"""Train D-FINE on a YOLO-format dataset:

    python -m dfine_tpu_torch.apps.train [config.yaml] [key.path=value ...]

The config defaults to ``config.yaml`` of the working directory; every
other argument is a dotted override (``model_name=s train.epochs=5``).
Training runs on the card (the first CUDA device) and raises without one;
``train.device`` is the JAX package's key and is not read here.

Data parallelism, as the JAX package's users run it:

* ``train.dp.enabled=true`` on a host with more than one card: one rank
  per card, ``min(train.dp.n_devices, cards)`` of them, spawned here and
  meeting on a free local port. With one card it trains alone (the log says
  DP is off).
* ``train.dp.multihost.enabled=true``: each host runs the command with its
  own ``train.dp.multihost.process_id`` (of ``num_processes``), all with the
  same ``coordinator_address``; with ``dp.enabled`` a host with several
  cards spawns a rank per card, else the process is one rank.

``main(argv, device)``: ``device="cpu"`` runs on the CPU, where ``n_devices``
is taken as the number of ranks to spawn.
"""

from __future__ import annotations

import socket
import sys
from typing import List, Optional

import torch

from dfine_tpu_torch.config import cli_config
from dfine_tpu_torch.device import resolve_device
from dfine_tpu_torch.parallel import dp as par
from dfine_tpu_torch.train.trainer import Trainer


def local_ranks(cfg, device=None) -> int:
    """The ranks this host runs: one per local device under ``dp.enabled``."""
    dp = cfg.train.get("dp") or {}
    if not dp.get("enabled"):
        return 1
    n = int(dp.get("n_devices") or 1)
    if resolve_device(device).type == "cuda":
        n = min(n, torch.cuda.device_count())
    return max(1, n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cfg, device=None) -> None:
    """Train in this process; raise the run's failure after its final eval."""
    trainer = Trainer(cfg, device=device)
    try:
        trainer.train()
    finally:
        par.shutdown()
    if trainer.failure is not None:  # the final eval ran; the run still failed
        raise trainer.failure


def _rank(local_rank: int, argv: List[str], device: str, n_local: int, address: str) -> None:
    cfg = cli_config(argv)
    mh = cfg.train.dp.get("multihost") or {}
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
    if mh.get("enabled"):
        par.init_multihost(str(mh["coordinator_address"]), int(mh["num_processes"]),
                           int(mh["process_id"]), local_rank, n_local, dev)
    else:
        par.init_multihost(address, 1, 0, local_rank, n_local, dev)
    run(cfg, dev)


def main(argv: Optional[List[str]] = None, device=None) -> None:
    from dfine_tpu_torch.apps import train as app  # _rank by its module's name, for spawn

    argv = list(argv if argv is not None else sys.argv[1:])
    cfg = cli_config(argv)
    n_local = local_ranks(cfg, device)
    if n_local == 1:
        run(cfg, device)
        return
    torch.multiprocessing.start_processes(
        app._rank, args=(argv, str(resolve_device(device)), n_local,
                         f"localhost:{_free_port()}"), nprocs=n_local, start_method="spawn")


if __name__ == "__main__":
    main()
