"""Multi-process runtime (port of ``gpudrive_lab_tpu/parallel/distributed.py``).

New capability versus the reference, which has no distributed anything
(SURVEY.md §2.3): world-parallel simulation and learning across processes.
Each rank compiles and feeds only the worlds of its own block, so scene
bytes stay with their rank; only the learner's reductions cross between
ranks (the gradients' all-reduce and a few scalars per minibatch).

Usage in each process, e.g. under ``torchrun --nproc-per-node N``::

    from gpudrive_lab_torch.parallel import distributed as dist
    group = dist.initialize()  # NCCL, this rank on card LOCAL_RANK
    paths = dist.shard_scene_paths(all_paths, worlds_per_device=64,
                                   rank=group.rank, world_size=group.size)
    env = GPUDriveTorchEnv(cfg, paths, device=group.device)
    ppo = PPO(policy, ..., group=group)   # after replicate(policy, group)

The backend is named by the caller or follows the device: NCCL for CUDA
tensors, gloo for the CPU.  NCCL refuses two ranks on one card ("Duplicate
GPU detected"); ranks that share a card name gloo, which takes CUDA
tensors for the all-reduce and the broadcast.

``run_ranks`` starts n ranks of a function in fresh processes on one host
(the dryrun, the scaling harness and their tests use it).
"""

from __future__ import annotations

import os
import time
import traceback

import torch

from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.parallel.mesh import WorldGroup, tree_map

# The process count when torchrun's WORLD_SIZE is not set (the JAX
# package's GPUDRIVE_TPU_NUM_PROCESSES).
NUM_PROCESSES_ENV = "GPUDRIVE_TORCH_NUM_PROCESSES"


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device=None) -> WorldGroup:
    """Join the process group and return this rank's ``WorldGroup`` on
    ``device`` (CUDA unless the caller names another).

    ``world_size`` defaults to torchrun's ``WORLD_SIZE``, then to
    ``GPUDRIVE_TORCH_NUM_PROCESSES``, then 1; ``rank`` to ``RANK``;
    ``init_method`` to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).  With
    one process it starts nothing and returns a group of one.  With more,
    a CUDA device without an index is this rank's own card, ``cuda:`` its
    ``LOCAL_RANK`` (else its rank), made the current device before the
    group starts; a rank without a card of its own raises (ranks that share
    a card name it, and gloo).  ``backend`` defaults to "nccl" for a CUDA
    device and "gloo" otherwise."""
    import torch.distributed as dist

    device = resolve_device(device)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE")
                         or os.environ.get(NUM_PROCESSES_ENV, "1"))
    if world_size <= 1:
        return WorldGroup(0, 1, device)
    if rank is None:
        if "RANK" not in os.environ:
            raise ValueError(f"world_size={world_size} needs a rank: pass "
                             "rank= or set RANK")
        rank = int(os.environ["RANK"])
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            if local >= torch.cuda.device_count():
                raise ValueError(
                    f"rank {rank} (local rank {local}) has no card of its "
                    f"own: the host has {torch.cuda.device_count()}; pass "
                    "device= (ranks that share a card need backend='gloo')")
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method or "env://", world_size=world_size,
            rank=rank)
    return global_group(device)


def global_group(device=None) -> WorldGroup:
    """The default process group as a ``WorldGroup`` on ``device`` (CUDA
    unless the caller names another; without an index, the current card);
    a group of one when no process group was started."""
    import torch.distributed as dist

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return WorldGroup(0, 1, device)
    return WorldGroup(dist.get_rank(), dist.get_world_size(), device)


def shutdown() -> None:
    """Leave the process group, if one was started."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def shard_scene_paths(all_paths: list[str], worlds_per_device: int,
                      rank: int, world_size: int) -> list[str]:
    """The scene paths rank ``rank`` of ``world_size`` (one device each)
    compiles: the contiguous block of ``worlds_per_device`` paths starting
    at ``rank * worlds_per_device``, wrapping around a short list, so the
    concatenation over ranks in rank order is the global world order."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    start = rank * worlds_per_device
    return [all_paths[(start + j) % len(all_paths)]
            for j in range(worlds_per_device)]


def gather_worlds(tree, group: WorldGroup):
    """Every rank's [W/n, ...] block of each tensor of ``tree`` assembled
    in rank order into [W, ...] on every rank (the counterpart of
    ``host_local_to_global``), for checks and metrics; under gloo through
    the host."""
    return tree_map(lambda x: torch.cat(group.all_gather(x)), tree)


def rank_generator(seed: int, group: WorldGroup) -> torch.Generator:
    """A generator on the group's device for this rank's action draws,
    seeded from (seed, rank): rank r draws from ``seed + (r << 32)``, so
    rank 0 draws what one process seeded with ``seed`` draws.  A
    sub-batch's draw is not a slice of the whole batch's, so ranks sample
    other actions than one process over all the worlds."""
    return torch.Generator(device=group.device).manual_seed(
        seed + (group.rank << 32))


def scaling_efficiency(per_device_sps: float,
                       single_device_sps: float) -> float:
    """Per-device world-steps/s at n ranks over the single rank's."""
    return per_device_sps / max(single_device_sps, 1e-9)


def rank_devices(device, n: int) -> list[torch.device]:
    """The devices of ``n`` ranks on this host: card r for rank r when
    ``device`` is CUDA without an index and the host has ``n`` cards,
    otherwise every rank on ``device`` (an index-less CUDA device read as
    the current card).  Ranks share a device where the list repeats one."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return [device] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", r) for r in range(n)]
    return [torch.device("cuda", torch.cuda.current_device())] * n


def rank_backend(backend: str | None, devices: list[torch.device]) -> str:
    """``backend``, or NCCL for CUDA ranks and gloo for the CPU when the
    caller names none.  Raises where NCCL would get ranks that share a card,
    which it refuses ("Duplicate GPU detected")."""
    backend = backend or ("nccl" if devices[0].type == "cuda" else "gloo")
    if backend == "nccl" and len(set(devices)) < len(devices):
        raise ValueError(f"ranks share {devices[0]}: NCCL refuses two ranks "
                         "on one card; name backend='gloo'")
    return backend


def _rank_entry(target, rank: int, spec: dict, out: str) -> None:
    try:
        result = {"value": target(rank, spec)}
    except Exception:  # reported to the parent, which raises it
        result = {"error": traceback.format_exc()}
    torch.save(result, out)


def run_ranks(target, n: int, spec: dict, timeout: float) -> list:
    """``target(rank, spec)`` in ``n`` processes started with ``spawn``
    (this process may hold CUDA), ``spec["init_method"]`` a fresh
    ``file://`` rendezvous for ``initialize``; returns each rank's return
    value in rank order.  ``target`` is a module-level function.  Raises
    RuntimeError naming each rank that raised, exited without a result or
    still ran after ``timeout`` seconds; once one rank has raised, the
    others (likely waiting on it in a collective) are killed."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        spec = {**spec, "init_method": "file://" + os.path.join(tmp,
                                                                "pg_init")}
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(n)]
        procs = [ctx.Process(target=_rank_entry,
                             args=(target, r, spec, outs[r]))
                 for r in range(n)]
        results = [None] * n
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            while time.perf_counter() - t0 < timeout:
                for r, p in enumerate(procs):
                    if (results[r] is None and not p.is_alive()
                            and os.path.exists(outs[r])):
                        results[r] = torch.load(outs[r], weights_only=False)
                if not any(p.is_alive() for p in procs) or any(
                        x is not None and "error" in x for x in results):
                    break
                time.sleep(0.1)
        finally:
            killed = [p.is_alive() for p in procs]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        for r in range(n):
            if results[r] is None and os.path.exists(outs[r]):
                results[r] = torch.load(outs[r], weights_only=False)
    failed = any(x is not None and "error" in x for x in results)
    faults = []
    for r, (p, x) in enumerate(zip(procs, results)):
        if x is not None and "error" in x:
            faults.append(f"rank {r} failed:\n{x['error']}")
        elif killed[r]:
            faults.append(f"rank {r} killed: " + (
                "another rank failed" if failed
                else f"still running after {timeout} s"))
        elif x is None:
            faults.append(f"rank {r} exited with {p.exitcode} and no result")
    if faults:
        raise RuntimeError("\n".join(faults))
    return [x["value"] for x in results]
