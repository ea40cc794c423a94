"""Process start and the host-side collectives of a multi-process run.

Counterpart of `lwdetr_tpu/parallel/dist.py`, with `torch.distributed` in
place of `jax.distributed`: one process a card, each on the card of its
local rank (`cuda:LOCAL_RANK`, wrapping when local ranks share a card).

The launch is resolved in the JAX package's order (`resolve_launch`, a pure
function of the environment):

1. explicit arguments, or COORDINATOR_ADDRESS + NUM_PROCESSES + PROCESS_ID
   (`tcp://` rendezvous at the coordinator's host:port);
2. a detected multi-process launch (`multiprocess_env_detected`): torchrun's
   WORLD_SIZE > 1 (RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), SLURM's
   SLURM_NTASKS > 1 (SLURM_PROCID, SLURM_LOCALID; MASTER_ADDR / MASTER_PORT,
   else the launch node's address and port 29500), or LWDETR_DIST=1 with one
   of those sets;
3. else one process, with no process group.

The JAX package also counts a multi-worker TPU slice as a launch; the port
runs on no TPU and reads none of those variables. A launch that is detected
but cannot be resolved raises: each process training alone would write the
same files. The backend is `gloo` for the CPU, `nccl` when every local rank
has a card of its own, and `gloo` when local ranks share a card (NCCL refuses
two ranks on one device; gloo reduces CUDA tensors through the host). The
processes on a host are counted from LOCAL_WORLD_SIZE (torchrun, or an
explicit launch) or SLURM's tasks-per-node list; where neither says, the
backend is `nccl`, which refuses a shared card aloud rather than move every
gradient through the host unseen. Host flags (the stop request) reduce on a
`gloo` group of their own, so that polling one never waits on a card.
"""
from __future__ import annotations

import builtins
import os
import re
from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Launch:
    """A resolved multi-process launch."""

    rank: int
    world: int
    local_rank: int
    local_world: Optional[int]  # processes on this host, None where the launch does not say
    init_method: str


def multiprocess_env_detected(env: Mapping[str, str]) -> bool:
    """True when the environment carries a multi-process launch: LWDETR_DIST=1,
    SLURM_NTASKS > 1 or WORLD_SIZE > 1 (the JAX package's rule without its TPU
    signals)."""
    if env.get("LWDETR_DIST") == "1":
        return True
    if int(env.get("SLURM_NTASKS", "1") or 1) > 1:
        return True
    return int(env.get("WORLD_SIZE", "1") or 1) > 1


def _int(env: Mapping[str, str], key: str, default: Optional[int]) -> Optional[int]:
    value = env.get(key, "")
    return int(value) if value.strip().isdigit() else default


def tasks_on_node(spec: str, node: int) -> Optional[int]:
    """Node `node`'s entry of a SLURM tasks-per-node list ("2(x3),1" is 2, 2, 2
    and 1), or None when `spec` does not parse or has no such node."""
    counts: List[int] = []
    for part in spec.split(","):
        m = re.fullmatch(r"(\d+)(?:\(x(\d+)\))?", part.strip())
        if m is None:
            return None
        counts += [int(m.group(1))] * int(m.group(2) or 1)
    return counts[node] if 0 <= node < len(counts) else None


def resolve_launch(env: Mapping[str, str], coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> Optional[Launch]:
    """The launch that `env` and the arguments describe, or None for one process."""
    if coordinator is None and "COORDINATOR_ADDRESS" in env:
        coordinator = env["COORDINATOR_ADDRESS"]
    if num_processes is None and "NUM_PROCESSES" in env:
        num_processes = int(env["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in env:
        process_id = int(env["PROCESS_ID"])
    if coordinator and num_processes and num_processes > 1:
        if process_id is None:
            raise ValueError("an explicit launch needs the process id (PROCESS_ID)")
        local = _int(env, "LOCAL_RANK", process_id)
        return Launch(process_id, num_processes, local, _int(env, "LOCAL_WORLD_SIZE", None),
                      f"tcp://{coordinator}")
    if not multiprocess_env_detected(env):
        return None
    if int(env.get("WORLD_SIZE", "1") or 1) > 1:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = _int(env, "LOCAL_RANK", rank)
        local_world = _int(env, "LOCAL_WORLD_SIZE", None)
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
    elif int(env.get("SLURM_NTASKS", "1") or 1) > 1:
        world, rank = int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
        local = _int(env, "SLURM_LOCALID", rank)
        # the step's layout (srun), else the job's; both are set on every node
        spec = env.get("SLURM_STEP_TASKS_PER_NODE") or env.get("SLURM_TASKS_PER_NODE", "")
        local_world = tasks_on_node(spec, _int(env, "SLURM_NODEID", 0))
        addr = env.get("MASTER_ADDR") or env.get("SLURM_LAUNCH_NODE_IPADDR")
        port = env.get("MASTER_PORT", "29500")
    else:
        raise ValueError("LWDETR_DIST=1 but neither WORLD_SIZE nor SLURM_NTASKS names more "
                         "than one process; set COORDINATOR_ADDRESS, NUM_PROCESSES and "
                         "PROCESS_ID to launch explicitly")
    if not addr or not port:
        raise ValueError("a multi-process launch needs MASTER_ADDR and MASTER_PORT")
    return Launch(rank, world, local, local_world, f"tcp://{addr}:{port}")


def choose_backend(device_type: str, local_world: Optional[int], n_cards: int) -> str:
    """`gloo` on the CPU or when the host's processes (`local_world`) outnumber
    its cards, else `nccl`, also where the host's count is unknown."""
    if device_type != "cuda" or (local_world is not None and local_world > n_cards):
        return "gloo"
    return "nccl"


def local_device(device: str = "cuda", local_rank: Optional[int] = None) -> torch.device:
    """The device of this process: the CPU, or the card of its local rank
    (wrapping when local ranks share cards); `cuda:N` is taken as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = _int(os.environ, "LOCAL_RANK", _int(os.environ, "SLURM_LOCALID", 0))
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device("cuda", local_rank % n)


def init_distributed(device: str = "cuda", coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Starts the process group of a multi-process launch (nothing for one
    process) and makes the local card current; returns (rank, world)."""
    launch = resolve_launch(os.environ, coordinator, num_processes, process_id)
    if launch is None:
        return 0, 1
    dev = local_device(device, launch.local_rank)
    n_cards = 0
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        n_cards = torch.cuda.device_count()
    backend = choose_backend(dev.type, launch.local_world, n_cards)
    dist.init_process_group(backend, init_method=launch.init_method, world_size=launch.world,
                            rank=launch.rank)
    global _host_group
    _host_group = dist.new_group(backend="gloo")
    return launch.rank, launch.world


_host_group = None  # every process, on gloo: host flags never wait on a card


def shutdown() -> None:
    """Ends the process group, if one was started."""
    global _host_group
    if is_initialized():
        dist.destroy_process_group()
    _host_group = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes in the group, 1 when none is up."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def collective_device() -> torch.device:
    """Where a host value goes for a collective: the current card under NCCL,
    which reduces nothing on the CPU, else the CPU."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def setup_print_for_distributed(force: bool = False) -> None:
    """`print` on rank 0 only; elsewhere only `print(..., force=True)`."""
    if is_main_process() or force:
        return
    builtin_print = builtins.print

    def quiet_print(*args, **kwargs):
        if kwargs.pop("force", False):
            builtin_print(*args, **kwargs)

    builtins.print = quiet_print


def all_gather_objects(obj: Any) -> List[Any]:
    """`obj` of every process, in rank order ([obj] for one process)."""
    if world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def merge_evaluators(evaluator):
    """Every process's detections merged into `evaluator` (the reference's
    datasets/coco_eval.py:181-200): each process ends with all of them."""
    for i, exported in enumerate(all_gather_objects(evaluator.export())):
        if i != rank():
            evaluator.merge(exported)
    return evaluator


def all_gather_into(full: torch.Tensor, shard: torch.Tensor) -> None:
    """Writes every process's `shard`, in rank order, into the 1-D `full`
    (world x shard.numel() elements). NCCL gathers on the card; gloo gathers
    CUDA tensors through the host."""
    if backend() == "nccl":
        dist.all_gather_into_tensor(full, shard.clone())  # `shard` may be a view into `full`
        return
    host = shard.detach().cpu()
    pieces = [torch.empty_like(host) for _ in range(world_size())]
    dist.all_gather(pieces, host)
    full.copy_(torch.cat(pieces).to(full.device))


def any_process(flag: bool) -> bool:
    """True when `flag` is true on any process. Reduced on the host group, so a
    flag polled every step does not wait for the work queued on the card."""
    if world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, group=_host_group)
    return bool(t.item())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the processes, in place (`t` for one process)."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t
