"""Data-parallel processes (port of ``lightning_asr_tpu/parallel/distributed.py``
and of the multi-process part of its ``train.py``): one process a card, all
in one ``torch.distributed`` process group.

The reference trains with Lightning's DDP over NCCL across ``gpus ×
num_nodes`` processes; the JAX package forms one runtime over its hosts
(``jax.distributed.initialize``) and shards each batch over a ``data`` mesh
axis.  Here each process is a rank of a global batch (``parallel/mesh.py``):

  * ``launcher_env`` reads a launcher's variables (``torchrun`` sets
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``).  ``spawn_local_ranks`` starts ranks
    1..N-1 of a one-host run itself, the caller being rank 0, as Lightning's
    DDP launcher does.
  * ``init`` forms the group.  The backend rule: NCCL when every rank of the
    host has a card of its own (local world <= visible cards), gloo when
    ranks share a card (rank r on card r mod cards) and on the CPU.  It is
    decided before the group forms and logged; no failure is retried on
    another backend.
  * a rank on CUDA is pinned to its card (``torch.cuda.set_device``), which
    ``utils/device.py::resolve_device`` follows.
  * the collectives are ``all_reduce`` (a sum) and ``broadcast`` on tensors
    of the rank's device, so one code path runs on NCCL, on gloo over CUDA
    tensors and on gloo on the CPU.  The group has a timeout: a collective
    that hangs fails the run.  ``all_reduce_sum`` carries a gradient (its
    backward is the same all-reduce); ``torch.distributed.nn``'s is
    deprecated.  ``all_gather_object`` gathers picklable objects (the SSL
    pseudo-label pool) the same way: each rank's bytes summed into a
    zero-filled buffer.
  * ``launch`` is the entry points' start (``train``, ``train_ssl``,
    ``train_ssl_double``): a launcher's ranks join their group, a run
    started alone starts its own local ranks, and a rank that fails ends
    the others.
  * with tensor parallelism (``init(..., tp=T)``, ``parallel/tp.py``) the
    W ranks form a (W / T) x T layout, row-major as the JAX package's
    ``make_mesh(shape=(dp, tp), axis_names=("data", "model"))``: rank r has
    data index r // T and model index r % T.  The T ranks of one data index
    (a *model group*) hold the same rows and split the conv trunk's
    channels; the W / T ranks of one model index (a *data group*) hold the
    same slice of the model and split the rows.  Every rank creates every
    group, in the same order.  Each collective names its group: ``"world"``
    (the default), ``"data"`` or ``"model"``; a subgroup of one rank is no
    collective at all.

With no group every helper is the one-process computation: rank 0 of 1, a
barrier and a broadcast do nothing.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import socket
import subprocess
import sys
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
GROUPS = ("world", "data", "model")
DEFAULT_TIMEOUT_S = 1800.0
_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


@dataclass(frozen=True)
class Rank:
    rank: int
    world: int
    backend: str
    device: torch.device
    tp: int = 1                     # ranks of a model group
    data_group: Any = None          # this rank's data group (None: the world)
    model_group: Any = None         # this rank's model group (None: tp == 1)


_RANK: Optional[Rank] = None


def launcher_env(environ=None) -> Optional[Dict[str, str]]:
    """The launcher's variables (with ``LOCAL_WORLD_SIZE``, which defaults
    to ``WORLD_SIZE``: one host), or None when none of them is set; raises
    when only some are."""
    environ = os.environ if environ is None else environ
    present = [v for v in LAUNCH_VARS if v in environ]
    if not present:
        return None
    missing = [v for v in LAUNCH_VARS if v not in environ]
    if missing:
        raise RuntimeError(f"the launcher's environment is incomplete: {missing} missing "
                           f"beside {present}")
    env = {v: environ[v] for v in LAUNCH_VARS}
    env["LOCAL_WORLD_SIZE"] = environ.get("LOCAL_WORLD_SIZE", environ["WORLD_SIZE"])
    return env


def backend_for(device_type: str, local_world: int, cards: int) -> str:
    """The backend rule: ``nccl`` when each of the host's ``local_world``
    ranks has a card of its own, ``gloo`` when they share cards, and on the
    CPU."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"data parallelism runs on cuda or cpu, not {device_type!r}")
    if cards < 1:
        raise RuntimeError("CUDA was requested but no card is visible; pass --device cpu "
                           "to run on the CPU")
    return "nccl" if local_world <= cards else "gloo"


def init(env: Dict[str, str], device_type: str = "cuda",
         timeout_s: float = DEFAULT_TIMEOUT_S, tp: int = 1) -> Rank:
    """Join the process group that ``env`` (``launcher_env``) describes and
    pin this rank to its card; with ``tp`` > 1 form the data and model
    groups of the (world / tp) x tp layout.  Returns the rank."""
    global _RANK
    if _RANK is not None:
        raise RuntimeError(f"this process is already rank {_RANK.rank} of {_RANK.world}")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if tp < 1 or world % tp:
        raise ValueError(f"a world of {world} ranks does not split into model groups of tp={tp}")
    local_rank, local_world = int(env["LOCAL_RANK"]), int(env.get("LOCAL_WORLD_SIZE", world))
    cards = 0
    device = torch.device("cpu")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but torch.cuda.is_available() is False; "
                               "pass --device cpu to run on the CPU")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
    backend = backend_for(device_type, local_world, cards)
    if not {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}[backend]():
        raise RuntimeError(f"the {backend} backend is not available in this torch build")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    logger.info("rank %d of %d (local %d of %d) on %s over %s: %s", rank, world, local_rank,
                local_world, device, backend,
                "a card each" if backend == "nccl" else
                ("ranks share a card" if device_type == "cuda" else "the CPU"))
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            world_size=world, rank=rank, timeout=timeout)
    data_group = model_group = None
    if tp > 1:
        dp = world // tp
        for m in range(tp):                          # every rank creates every group
            group = dist.new_group([d * tp + m for d in range(dp)], timeout=timeout)
            if m == rank % tp:
                data_group = group
        for d in range(dp):
            group = dist.new_group([d * tp + m for m in range(tp)], timeout=timeout)
            if d == rank // tp:
                model_group = group
        logger.info("rank %d: data index %d of %d, model index %d of %d", rank, rank // tp, dp,
                    rank % tp, tp)
    _RANK = Rank(rank, world, backend, device, tp, data_group, model_group)
    return _RANK


def shutdown(wait: bool = True) -> None:
    """Leave the process group; with ``wait`` after a barrier, so that no
    rank leaves while another still reduces (a failed rank leaves at once)."""
    global _RANK
    if _RANK is None:
        return
    try:
        if wait:
            barrier()
    finally:
        dist.destroy_process_group()
        _RANK = None


def current() -> Optional[Rank]:
    return _RANK


def rank() -> int:
    return 0 if _RANK is None else _RANK.rank


def world() -> int:
    return 1 if _RANK is None else _RANK.world


def is_primary() -> bool:
    return rank() == 0


def model_size() -> int:
    """Ranks of this rank's model group (tp)."""
    return 1 if _RANK is None else _RANK.tp


def model_index() -> int:
    return rank() % model_size()


def data_size() -> int:
    """Ranks of this rank's data group (dp = world / tp)."""
    return world() // model_size()


def data_index() -> int:
    return rank() // model_size()


def group_size(group: str) -> int:
    return {"world": world, "data": data_size, "model": model_size}[group]()


def group_index(group: str) -> int:
    """This rank's place in ``group`` (its members in rank order)."""
    return {"world": rank, "data": data_index, "model": model_index}[group]()


def _handle(group: str):
    """(the process group for ``group``, None for the default group; whether
    a collective runs: always on the default group, as without model
    groups, and on a subgroup of more than one rank)."""
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {group!r}")
    if _RANK is None:
        return None, False
    if group == "world" or (group == "data" and _RANK.tp == 1):
        return None, True
    if group_size(group) == 1:
        return None, False
    return (_RANK.data_group if group == "data" else _RANK.model_group), True


def all_reduce_(tensor: torch.Tensor, group: str = "world") -> torch.Tensor:
    """Sum ``tensor`` over the ranks of ``group``, in place."""
    handle, many = _handle(group)
    if many:
        dist.all_reduce(tensor, group=handle)
    return tensor


def barrier() -> None:
    """Return once every rank has reached this call (an all-reduce read on
    the host)."""
    if _RANK is not None:
        one = torch.ones(1, device=_RANK.device)
        dist.all_reduce(one)
        one.item()


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x, each rank holding y; the gradient of x is Σ_ranks of
    the gradients of y (every rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: str = "world") -> torch.Tensor:
    """Σ over the ranks of ``group`` of x, differentiable."""
    return _AllReduceSum.apply(x, group)


def _tensors(tree) -> List[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    return []


def broadcast_(tree, src: int = 0, group: str = "world"):
    """Every tensor of ``tree`` (tensors in dicts, tuples, dataclasses) set to
    the one of global rank ``src`` (a member of ``group``), in place: one
    broadcast of a flat buffer a dtype."""
    handle, many = _handle(group)
    if not many:
        return tree
    unique = {id(t): t for t in _tensors(tree)}
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in unique.values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.detach().reshape(-1).to(_RANK.device) for t in ts])
        dist.broadcast(flat, src, group=handle)
        offset = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[offset: offset + t.numel()].view(t.shape))
                offset += t.numel()
    return tree


def broadcast_str(text: str, src: int = 0) -> str:
    """Rank ``src``'s ``text`` on every rank."""
    if _RANK is None:
        return text
    data = torch.tensor(list(text.encode()), dtype=torch.uint8, device=_RANK.device)
    size = torch.tensor([data.numel()], dtype=torch.int64, device=_RANK.device)
    dist.broadcast(size, src)
    if _RANK.rank != src:
        data = torch.zeros(int(size.item()), dtype=torch.uint8, device=_RANK.device)
    dist.broadcast(data, src)
    return bytes(data.cpu().tolist()).decode()


def all_gather_object(obj, group: str = "data") -> list:
    """Every member's ``obj`` of ``group``, in the group's rank order
    (``[obj]`` without a group): pickled, each rank's bytes written into a
    zero-filled buffer at its offset, the buffer summed over the group as
    bytes (the sizes first), so it runs on NCCL and on gloo, under the
    group's timeout."""
    handle, many = _handle(group)
    if not many:
        return [obj]
    data = pickle.dumps(obj)
    index, dev = group_index(group), _RANK.device
    sizes = torch.zeros(group_size(group), dtype=torch.int64, device=dev)
    sizes[index] = len(data)
    dist.all_reduce(sizes, group=handle)
    sizes = sizes.tolist()
    buf = torch.zeros(sum(sizes), dtype=torch.uint8, device=dev)
    start = sum(sizes[:index])
    buf[start: start + len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    dist.all_reduce(buf, group=handle)
    raw, out, offset = buf.cpu().numpy().tobytes(), [], 0
    for size in sizes:
        out.append(pickle.loads(raw[offset: offset + size]))
        offset += size
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local_ranks(module: str, argv: List[str], n: int):
    """Start ranks 1..n-1 of a one-host run as ``python -m module *argv``;
    returns (rank 0's environment for ``init``, the started processes)."""
    env0 = {"RANK": "0", "WORLD_SIZE": str(n), "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": str(n),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    path = os.pathsep.join(p for p in (str(_PACKAGE_ROOT), os.environ.get("PYTHONPATH")) if p)
    procs = []
    for r in range(1, n):
        env = {**os.environ, **env0, "RANK": str(r), "LOCAL_RANK": str(r), "PYTHONPATH": path}
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=env))
    logger.info("started ranks 1..%d of %d on this host (rendezvous 127.0.0.1:%s)", n - 1, n,
                env0["MASTER_PORT"])
    return env0, procs


def join_ranks(procs, failed: bool = False) -> None:
    """Wait for the processes of ``spawn_local_ranks``; raises if one
    failed.  With ``failed`` (rank 0 failed) they are ended first."""
    if failed:
        for p in procs:
            p.kill()
    codes = [p.wait() for p in procs]
    bad = {r + 1: c for r, c in enumerate(codes) if c}
    if bad and not failed:
        raise RuntimeError(f"ranks exited with an error: {bad}")


def local_processes(device_type: str, n_devices) -> int:
    """Processes a run started alone takes: ``n_devices``, or with null one
    a visible card (one on the CPU)."""
    if n_devices is not None:
        return int(n_devices)
    return torch.cuda.device_count() if device_type == "cuda" else 1


def launch(module: str, argv: List[str], train_cfg, device: Optional[str],
           body: Callable[[torch.device], Any], tp: int = 1, one_host: bool = False):
    """Run ``body(device)`` as this process's rank of a run of ``python -m
    module *argv`` and return its result.  Under a launcher the rank joins
    the group of its environment; started alone, the run takes
    ``train.n_devices`` local processes (``local_processes``) and starts
    ranks 1..N-1 itself, this process being rank 0; with one process there
    is no group.  With ranks ``device`` must be cpu or cuda (each rank takes
    its own card).  ``tp`` forms the model groups; ``one_host`` refuses
    ``train.num_nodes`` > 1 and a launcher's world beyond this host.
    ``train.dist_timeout_s`` is the group's timeout.  A rank that fails ends
    the ranks it started; the group is left before returning."""
    device_type = torch.device(device or "cuda").type
    num_nodes = int(train_cfg.get("num_nodes", 1) or 1)
    env = launcher_env()
    if one_host and (num_nodes > 1 or (env is not None
                                       and env["LOCAL_WORLD_SIZE"] != env["WORLD_SIZE"])):
        raise RuntimeError(f"{module} trains on one host, as the JAX package's entry point "
                           f"does: train.num_nodes={num_nodes}"
                           + ("" if env is None else f", a launcher's world of "
                              f"{env['WORLD_SIZE']} with {env['LOCAL_WORLD_SIZE']} here"))
    n = 1
    if env is None:
        if num_nodes > 1:
            raise RuntimeError(f"train.num_nodes={num_nodes} needs a launcher on every node: "
                               f"torchrun --nnodes={num_nodes} --nproc_per_node=<cards a node> "
                               f"--rdzv-endpoint=<host:port> -m {module} ...")
        n = local_processes(device_type, train_cfg.get("n_devices"))
        if n % tp:
            raise ValueError(f"train.n_devices={n} does not divide by train.tp={tp}: the "
                             "processes form (n_devices / tp) model groups of tp ranks")
    if (env is not None or n > 1) and device not in (None, "cpu", "cuda"):
        raise ValueError(f"--device {device}: each data-parallel rank takes its own card; "
                         "pass cuda or cpu")
    if env is None and device_type == "cuda":
        resolve_device(device)                   # raises without a card
    procs = []
    if n > 1:
        env, procs = spawn_local_ranks(module, argv, n)
    if env is not None:
        try:
            init(env, device_type, float(train_cfg.get("dist_timeout_s", DEFAULT_TIMEOUT_S)),
                 tp=tp)
        except BaseException:
            join_ranks(procs, failed=True)
            raise
    try:
        out = body(resolve_device(device if env is None else device_type))
    except BaseException:
        shutdown(wait=False)
        join_ranks(procs, failed=True)
        raise
    shutdown()
    join_ranks(procs)
    return out
