"""Expert-trajectory view (port of
``gpudrive_lab_tpu/datatypes/trajectory.py``; reference:
gpudrive/datatypes/trajectory.py).

The reference slices the exported 1456-float blob; the Scene already holds
the structured tensors, so ``LogTrajectory`` is built from the Scene or
from a packed blob, and packs back into one."""

from __future__ import annotations

import dataclasses

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.types import Scene

T = C.TRAJECTORY_LEN


@dataclasses.dataclass
class LogTrajectory:
    pos_xy: torch.Tensor  # [W, A, T, 2]
    vel_xy: torch.Tensor  # [W, A, T, 2]
    yaw: torch.Tensor  # [W, A, T, 1]
    valids: torch.Tensor  # [W, A, T, 1]
    inferred_actions: torch.Tensor  # [W, A, T, 10]

    @classmethod
    def from_scene(cls, scene: Scene) -> "LogTrajectory":
        ag = scene.agents
        return cls(
            pos_xy=ag.traj_pos,
            vel_xy=ag.traj_vel,
            yaw=ag.traj_yaw[..., None],
            valids=ag.traj_valid[..., None],
            inferred_actions=ag.traj_inv_actions,
        )

    @classmethod
    def from_blob(cls, blob, num_worlds: int, max_agents: int):
        """Slice the packed 1456-float export layout
        (reference: datatypes/trajectory.py:21-66; src/types.hpp:348-371)."""
        b = blob.reshape(num_worlds, max_agents, -1)
        W, A = num_worlds, max_agents
        return cls(
            pos_xy=b[..., : 2 * T].reshape(W, A, T, 2),
            vel_xy=b[..., 2 * T : 4 * T].reshape(W, A, T, 2),
            yaw=b[..., 4 * T : 5 * T].reshape(W, A, T, 1),
            valids=b[..., 5 * T : 6 * T].reshape(W, A, T, 1),
            inferred_actions=b[..., 6 * T : 16 * T].reshape(W, A, T, 10),
        )

    def pack(self) -> torch.Tensor:
        """Inverse of from_blob: the [W, A, 1456] export blob."""
        W, A = self.pos_xy.shape[:2]
        return torch.cat(
            [
                self.pos_xy.reshape(W, A, -1),
                self.vel_xy.reshape(W, A, -1),
                self.yaw.reshape(W, A, -1),
                self.valids.reshape(W, A, -1),
                self.inferred_actions.reshape(W, A, -1),
            ],
            dim=-1,
        )
