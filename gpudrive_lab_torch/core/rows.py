"""Row bookkeeping shared by the sensors (lidar, BEV, camera).

A sensor computes only the rows of created agents (``agents.valid``) and
leaves the others zero, as the JAX functions do by masking.  The rows are
taken in groups sized to a memory budget, and a group's entity axis stops
at the last valid entity of its worlds.  The group boundaries are host
integers, read from the device once per call.
"""

from __future__ import annotations

import torch


class Rows:
    """The created agents' flat rows (w * A + a), sorted, on the device
    (``idx``) and on the host (``host``), with each world's live extent of
    roads and agents: one past its last valid entity."""

    def __init__(self, scene):
        A = scene.agents.valid.shape[1]
        self.A = A
        self.idx = scene.agents.valid.reshape(-1).nonzero().squeeze(1)
        self.host = self.idx.tolist()
        self.road_ext = _live_extent(scene.roads.valid)
        self.agent_ext = _live_extent(scene.agents.valid)

    def __len__(self) -> int:
        return len(self.host)

    def groups(self, per_group: int, world_group: int | None = None):
        """Slices of the rows: ``world_group`` worlds at a time, else
        ``per_group`` rows at a time."""
        n = len(self.host)
        if not world_group:
            return [slice(i, min(i + per_group, n))
                    for i in range(0, n, per_group)]
        out, start = [], 0
        for i in range(1, n + 1):
            if i == n or (self.host[i] // self.A) // world_group != \
                    (self.host[start] // self.A) // world_group:
                out.append(slice(start, i))
                start = i
        return out

    def extents(self, g: slice) -> tuple[int, int]:
        """(roads, agents) a group must see: the largest live extent over
        the worlds of its rows (at least one road)."""
        w0 = self.host[g.start] // self.A
        w1 = self.host[g.stop - 1] // self.A + 1
        return max(1, max(self.road_ext[w0:w1])), max(self.agent_ext[w0:w1])

    def split(self, g: slice):
        """(rows, worlds, agent indices) of a group, on the device."""
        r = self.idx[g]
        return r, r // self.A, r % self.A


def _live_extent(valid: torch.Tensor) -> list[int]:
    ar = torch.arange(1, valid.shape[1] + 1, device=valid.device)
    return (valid * ar).amax(dim=1).tolist()
