"""World-parallel layout across processes (port of
``gpudrive_lab_tpu/parallel/mesh.py``).

Worlds are the data-parallel axis: every ``Scene``/``SimState``/rollout
tensor leads with [W, ...].  In the JAX package those arrays are sharded
over a 1-D "world" device mesh, the policy and optimizer state are
replicated, and XLA's partitioner inserts the gradient all-reduce.  Torch
has no partitioner.  The port runs one process per rank over
``torch.distributed``: rank r holds the contiguous block
[r W/n, (r+1) W/n) of the worlds (``shard_worlds``), the policy starts
replicated from rank 0 (``replicate``), and the learners
(``ppo/ppo.py``, ``ppo/ppo_rnn.py``) do the cross-rank reductions
themselves through a ``WorldGroup``, so that every rank applies the update
one process over all the worlds would.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

WORLD_AXIS = "world"


@dataclasses.dataclass(frozen=True)
class WorldGroup:
    """This process's place among ``size`` ranks: its ``rank``, the
    torch.distributed process ``group`` (None: the default group) and the
    ``device`` its tensors live on.  A group of one rank reduces nothing.

    Collectives follow the backend: NCCL takes CUDA tensors only; gloo
    takes CUDA tensors for ``all_reduce`` and ``broadcast`` and is given
    host tensors for ``all_gather``, which the methods copy through the
    host explicitly."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None

    def block(self, n: int) -> slice:
        """This rank's contiguous block of an axis of ``n`` worlds."""
        if n % self.size:
            raise ValueError(f"{n} worlds do not split into {self.size} "
                             f"equal blocks along the {WORLD_AXIS!r} axis")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def _gather_on_host(self) -> bool:
        import torch.distributed as dist

        return dist.get_backend(self.group) == "gloo"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        if self.size > 1:
            import torch.distributed as dist

            dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of rank ``src`` (a rank of this group), in place."""
        if self.size > 1:
            import torch.distributed as dist

            dist.broadcast(t, dist.get_global_rank(self.group, src)
                           if self.group is not None else src,
                           group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (the same shape on every rank), in rank
        order, on ``t``'s device."""
        if self.size == 1:
            return [t]
        import torch.distributed as dist

        x = t.cpu() if self._gather_on_host() else t
        dtype = x.dtype
        if dtype == torch.bool:
            x = x.to(torch.uint8)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x.contiguous(), group=self.group)
        return [o.to(device=t.device, dtype=dtype) for o in out]

    def all_gather_ints(self, values: list[int]) -> list[list[int]]:
        """Every rank's list of host ints (the same length on every
        rank), in rank order."""
        t = torch.tensor(values, dtype=torch.int64)
        if self.size > 1 and not self._gather_on_host():
            t = t.to(self.device)
        return [o.tolist() for o in self.all_gather(t)]


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a tensor dataclass (``Scene``,
    ``SimState``, ...), dict, tuple, NamedTuple or list, nested; other
    leaves (None, numbers, generators) unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def shard_worlds(tree, group: WorldGroup):
    """This rank's contiguous [W/n] block of every [W, ...] tensor of
    ``tree`` (a copy, so the whole batch can be freed)."""
    return tree_map(lambda x: x[group.block(x.shape[0])].clone(), tree)


@torch.no_grad()
def replicate(module_or_tensors, group: WorldGroup):
    """Rank 0's values on every rank, in place: the parameters and buffers
    of an ``nn.Module``, or every tensor of a tree.  Returns the
    argument."""
    if isinstance(module_or_tensors, torch.nn.Module):
        for t in list(module_or_tensors.parameters()) + list(
                module_or_tensors.buffers()):
            group.broadcast(t.data)
    else:
        tree_map(group.broadcast, module_or_tensors)
    return module_or_tensors
