"""Info, metadata and response-type views (port of
``gpudrive_lab_tpu/datatypes/info.py``; reference:
gpudrive/datatypes/{info,metadata,control}.py)."""

from __future__ import annotations

import dataclasses

import torch

from gpudrive_lab_torch.core.types import Scene, SimState


@dataclasses.dataclass
class Info:
    """Columns of the info export: off_road, collided (vehicle and
    non-vehicle summed), goal, agent type
    (reference: datatypes/info.py:5-33)."""

    off_road: torch.Tensor
    collided: torch.Tensor
    goal_achieved: torch.Tensor
    agent_type: torch.Tensor

    @classmethod
    def from_state(cls, scene: Scene, state: SimState) -> "Info":
        return cls(
            off_road=state.collided_road,
            collided=state.collided_vehicle + state.collided_non_vehicle,
            goal_achieved=state.reached_goal,
            agent_type=torch.where(scene.agents.valid, scene.agents.etype, 0),
        )

    @classmethod
    def from_array(cls, arr) -> "Info":
        """From the packed [W, A, 5] export layout."""
        return cls(
            off_road=arr[..., 0],
            collided=arr[..., 1] + arr[..., 2],
            goal_achieved=arr[..., 3],
            agent_type=arr[..., 4],
        )


@dataclasses.dataclass
class Metadata:
    """isSdc / isObjectOfInterest / isTrackToPredict / difficulty
    (reference: datatypes/metadata.py:8-38)."""

    is_sdc: torch.Tensor
    is_objects_of_interest: torch.Tensor
    is_track_to_predict: torch.Tensor
    difficulty: torch.Tensor

    @classmethod
    def from_scene(cls, scene: Scene) -> "Metadata":
        m = scene.agents.metadata
        return cls(
            is_sdc=m[..., 0],
            is_objects_of_interest=m[..., 1],
            is_track_to_predict=m[..., 2],
            difficulty=m[..., 3],
        )


@dataclasses.dataclass
class ResponseType:
    """Moving / static masks (reference: datatypes/control.py:5-29)."""

    static: torch.Tensor
    moving: torch.Tensor

    @classmethod
    def from_scene(cls, scene: Scene) -> "ResponseType":
        static = scene.agents.static & scene.agents.valid
        return cls(static=static, moving=scene.agents.valid & ~static)
