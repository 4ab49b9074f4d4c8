"""Data parallelism over a ``torch.distributed`` process group (port of
``dfine_tpu/parallel/dp.py``).

The JAX package is single-controller: one program over a 1-axis device
mesh, the train step under ``shard_map`` with ``axis_name="dp"``, its
gradients, BatchNorm statistics and loss normalizers riding ``psum`` /
``pmean``. Here each rank is a process with its own device, joined in one
process group; the train step built with ``axis_name="dp"`` makes the same
reductions as collectives over that group (``train/train_step.py``,
``train/criterion.py``, SyncBN in ``models/layers.py``). Every rank builds
the same seeded global batch and keeps its rows (``shard_batch``); every
rank holds the same parameters (``replicate`` once, then identical updates
from identical averaged gradients).

``make_mesh`` has no counterpart: the process group is the mesh. Its size
is the world size (``process_count``), its axis the group itself, and
``init_multihost`` forms it.

The backend: NCCL where every rank has a GPU of its own, gloo on the CPU
and where ranks share a GPU (NCCL refuses two ranks on one device; gloo
carries ``all_reduce`` and ``broadcast`` of CUDA tensors through the host).
The choice is made before ``init_process_group``, from the ranks' device
UUIDs exchanged through the rendezvous store, and logged.
"""

from __future__ import annotations

import logging
import pickle
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

AXIS = "dp"
# rank r's CDN generator is seeded seed + r * RANK_SEED_STRIDE: rank 0 draws
# what one process draws, the others their own streams
RANK_SEED_STRIDE = 1_000_003
TIMEOUT = timedelta(minutes=30)

_LOG = logging.getLogger("dfine_tpu_torch")


def _is_multi() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _is_multi() else 1


def process_index() -> int:
    return dist.get_rank() if _is_multi() else 0


def is_main_process() -> bool:
    return process_index() == 0


def backend() -> Optional[str]:
    """The process group's backend, or None outside one."""
    return dist.get_backend() if _is_multi() else None


def device_uuid(device: Union[str, torch.device]) -> str:
    """A GPU's UUID, or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(dev).uuid)


def choose_backend(uuids: Sequence[str]) -> str:
    """NCCL when every rank has a GPU of its own, else gloo."""
    own_gpus = "cpu" not in uuids and len(set(uuids)) == len(uuids)
    return "nccl" if own_gpus else "gloo"


def init_multihost(coordinator_address: str, num_processes: int, process_id: int,
                   local_rank: int = 0, local_ranks: int = 1,
                   device: Optional[Union[str, torch.device]] = None) -> str:
    """Join the process group. ``num_processes`` hosts (JAX's processes) run
    ``local_ranks`` ranks each, one a local device; this rank is ``process_id
    * local_ranks + local_rank`` of ``num_processes * local_ranks``.
    ``coordinator_address`` ("host:port") is the TCP rendezvous, served by
    rank 0. ``device``: this rank's device (default: the current CUDA
    device). Returns the backend chosen."""
    host, port = coordinator_address.rsplit(":", 1)
    rank, world = process_id * local_ranks + local_rank, num_processes * local_ranks
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=TIMEOUT)
    store.set(f"dfine/uuid/{rank}", device_uuid(dev))
    uuids = [store.get(f"dfine/uuid/{r}").decode() for r in range(world)]
    chosen = choose_backend(uuids)
    kw = {"device_id": dev} if chosen == "nccl" else {}
    dist.init_process_group(chosen, store=store, rank=rank, world_size=world, timeout=TIMEOUT,
                            **kw)
    why = ("CPU ranks" if "cpu" in uuids else "a GPU per rank" if chosen == "nccl"
           else "ranks share a GPU")
    _LOG.info(f"process group: rank {rank} of {world} on {dev}, backend {chosen} ({why})")
    return chosen


def shutdown() -> None:
    if _is_multi():
        dist.destroy_process_group()


def barrier(name: str) -> None:
    """Every rank waits here until all have arrived (``name`` is for the
    debug log). All ranks must call in the same order."""
    if process_count() == 1:
        return
    _LOG.debug(f"barrier {name}")
    dist.barrier()


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current GPU
    under NCCL, the CPU under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_scalar(value: float, src: int = 0) -> float:
    """Every process returns ``src``'s value (the early-stop flag)."""
    if process_count() == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=_comm_device())
    dist.broadcast(t, src)
    return float(t.item())


def gather_objects(local: list) -> list:
    """All-gather lists of picklable objects: every process returns the
    concatenation of all processes' lists, ordered by process index. The
    pickles travel as padded uint8 tensors (gloo carries only all_reduce
    and broadcast of CUDA tensors, so under gloo they stay on the CPU)."""
    if process_count() == 1:
        return list(local)
    barrier("gather_objects")
    dev = _comm_device()
    payload = torch.frombuffer(bytearray(pickle.dumps(list(local))), dtype=torch.uint8)
    n = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(n) for _ in range(process_count())]
    dist.all_gather(sizes, n)
    max_n = int(max(int(s.item()) for s in sizes))
    padded = torch.zeros(max_n, dtype=torch.uint8, device=dev)
    padded[: payload.numel()] = payload.to(dev)
    blobs = [torch.zeros_like(padded) for _ in range(process_count())]
    dist.all_gather(blobs, padded)
    out: list = []
    for blob, size in zip(blobs, sizes):
        out.extend(pickle.loads(blob[: int(size.item())].cpu().numpy().tobytes()))
    return out


def gather_predictions(preds: Sequence[Any]) -> list:
    """Eval predictions of every process, flattened into one list ordered
    by process index (each element of ``preds`` a prediction or a list)."""
    out: list = []
    for p in preds:
        out.extend(p if isinstance(p, list) else [p])
    return gather_objects(out)


def shard_batch(batch: Any) -> Any:
    """This rank's rows of the global batch (every leaf split on its first
    dim): every process builds the same seeded global batch and keeps rows
    [pid * per, (pid + 1) * per)."""
    pc, pid = process_count(), process_index()

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if x.shape[0] % pc:
            raise ValueError(f"the global batch of {x.shape[0]} rows does not divide by the "
                             f"{pc} processes")
        per = x.shape[0] // pc
        return x[pid * per: (pid + 1) * per]

    return rows(batch) if pc > 1 else batch


def _coalesced(tensors: List[torch.Tensor], op: Callable[[torch.Tensor], None]) -> None:
    """Apply the in-place collective ``op`` to ``tensors`` as one flat
    buffer per dtype, and copy the result back."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        torch._foreach_copy_(group, [f.view_as(t) for f, t in
                                     zip(flat.split([t.numel() for t in group]), group)])


@torch.no_grad()
def replicate(*modules: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers, broadcast to every rank (in place)."""
    if process_count() == 1:
        return
    tensors = [t for m in modules for t in m.state_dict(keep_vars=True).values()]
    _coalesced([t.data if isinstance(t, torch.nn.Parameter) else t for t in tensors],
               lambda flat: dist.broadcast(flat, 0))


def unreplicate(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The (replicated) state of ``module`` as CPU tensors."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


@torch.no_grad()
def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """In place: each tensor's mean over the ranks."""
    if not _is_multi() or not tensors:
        return
    world = process_count()

    def op(flat):
        dist.all_reduce(flat)
        flat.div_(world)

    _coalesced(tensors, op)


@torch.no_grad()
def all_reduce_grads_(params: Sequence[torch.nn.Parameter]) -> None:
    """Each parameter's gradient averaged over the ranks. A parameter that
    has no gradient on a rank (the DN branch without GT, an unused head)
    enters as zeros; one that has none on any rank (frozen, or unused
    everywhere) keeps none. One flat all-reduce carries the gradients and,
    ahead of them, a presence flag per parameter."""
    if not _is_multi():
        return
    params = list(params)
    dev = params[0].device
    flags = torch.tensor([p.grad is not None for p in params], dtype=torch.float32, device=dev)
    grads = [p.grad.float() if p.grad is not None else torch.zeros(p.shape, device=dev)
             for p in params]
    flat = torch.cat([flags] + [g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat[len(params):].div_(process_count())
    present = flat[: len(params)].gt(0).tolist()
    for p, here, g in zip(params, present, flat[len(params):].split([p.numel() for p in params])):
        p.grad = g.view_as(p).to(p.dtype) if here else None


@torch.no_grad()
def all_reduce_flat_(flat: torch.Tensor) -> None:
    """In place: the flat optimizer's gradient buffer (every parameter's
    ``.grad`` a view into it, zeros where autograd did not write) averaged
    over the ranks, one all-reduce and one division."""
    if not _is_multi():
        return
    dist.all_reduce(flat)
    flat.div_(process_count())


def rank_generator(seed: int, device: Union[str, torch.device]) -> torch.Generator:
    """This rank's CDN generator: seed + rank * RANK_SEED_STRIDE (JAX folds
    the replica index into the step's key)."""
    return torch.Generator(device=device).manual_seed(int(seed) + RANK_SEED_STRIDE
                                                      * process_index())


def make_dp_train_step(step_fn: Callable, axis: str = AXIS) -> Callable:
    """The data-parallel step: ``step_fn`` built by ``make_train_step(...,
    axis_name=axis)``, called on every rank with the same replicated state
    and that rank's rows of the global batch (``shard_batch``) and its own
    CDN generator (``rank_generator``); it returns the same state and the
    metrics averaged over the ranks on every rank."""
    if getattr(step_fn, "axis_name", None) != axis:
        raise ValueError(f"the step was not built with axis_name={axis!r}")

    def step(state, batch, generator: Optional[torch.Generator] = None, dn_noise=None):
        return step_fn(state, batch, generator=generator, dn_noise=dn_noise)

    step.axis_name = axis
    return step
