"""Named, normalizable views over observation tensors (port of
``gpudrive_lab_tpu/datatypes/observation.py``; reference:
gpudrive/datatypes/observation.py).

The views wrap the tensors the observation collectors return
(``core/observations.py``, ``core/lidar.py``, ``core/bev.py``): the same
columns and normalization constants as the reference's views over its
exports.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from gpudrive_lab_torch import constants as C

AGENT_SCALE = C.VEHICLE_LENGTH_SCALE


def _minmax(x, lo, hi):
    return 2.0 * ((x - lo) / (hi - lo)) - 1.0


def one_hot(t: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer classes in [0, n) (``jax.nn.one_hot``)."""
    return F.one_hot(t.long(), n).to(torch.float32)


@dataclasses.dataclass
class LocalEgoState:
    """View over self_observation rows [.., 8]
    (reference: datatypes/observation.py:13-91)."""

    speed: torch.Tensor
    vehicle_length: torch.Tensor
    vehicle_width: torch.Tensor
    vehicle_height: torch.Tensor
    rel_goal_x: torch.Tensor
    rel_goal_y: torch.Tensor
    is_collided: torch.Tensor
    id: torch.Tensor

    @classmethod
    def from_array(cls, arr, mask=None):
        if mask is not None:
            arr = arr[mask]
        return cls(
            speed=arr[..., 0],
            vehicle_length=arr[..., 1] * AGENT_SCALE,
            vehicle_width=arr[..., 2] * AGENT_SCALE,
            vehicle_height=arr[..., 3],
            rel_goal_x=arr[..., 4],
            rel_goal_y=arr[..., 5],
            is_collided=arr[..., 6],
            id=arr[..., 7],
        )

    def normalize(self):
        self.speed = self.speed / C.MAX_SPEED
        self.vehicle_length = self.vehicle_length / C.MAX_VEH_LEN
        self.vehicle_width = self.vehicle_width / C.MAX_VEH_WIDTH
        self.vehicle_height = self.vehicle_height / C.MAX_VEH_HEIGHT
        self.rel_goal_x = _minmax(
            self.rel_goal_x, C.MIN_REL_GOAL_COORD, C.MAX_REL_GOAL_COORD
        )
        self.rel_goal_y = _minmax(
            self.rel_goal_y, C.MIN_REL_GOAL_COORD, C.MAX_REL_GOAL_COORD
        )
        return self

    @property
    def shape(self):
        return self.speed.shape


@dataclasses.dataclass
class GlobalEgoState:
    """View over absolute_self_observation rows [.., 14]
    (reference: datatypes/observation.py:94-155)."""

    pos_x: torch.Tensor
    pos_y: torch.Tensor
    pos_z: torch.Tensor
    rotation_as_quaternion: torch.Tensor
    rotation_angle: torch.Tensor
    goal_x: torch.Tensor
    goal_y: torch.Tensor
    vehicle_length: torch.Tensor
    vehicle_width: torch.Tensor
    vehicle_height: torch.Tensor
    id: torch.Tensor

    @classmethod
    def from_array(cls, arr):
        return cls(
            pos_x=arr[..., 0],
            pos_y=arr[..., 1],
            pos_z=arr[..., 2],
            rotation_as_quaternion=arr[..., 3:7],
            rotation_angle=arr[..., 7],
            goal_x=arr[..., 8],
            goal_y=arr[..., 9],
            vehicle_length=arr[..., 10] * AGENT_SCALE,
            vehicle_width=arr[..., 11] * AGENT_SCALE,
            vehicle_height=arr[..., 12],
            id=arr[..., 13],
        )

    def restore_mean(self, mean_x, mean_y):
        self.pos_x = self.pos_x + torch.as_tensor(mean_x).reshape(-1, 1)
        self.pos_y = self.pos_y + torch.as_tensor(mean_y).reshape(-1, 1)
        return self

    @property
    def shape(self):
        return self.pos_x.shape


@dataclasses.dataclass
class PartnerObs:
    """View over partner_observations rows [.., A-1, 9]
    (reference: datatypes/observation.py:158-283)."""

    speed: torch.Tensor
    rel_pos_x: torch.Tensor
    rel_pos_y: torch.Tensor
    orientation: torch.Tensor
    vehicle_length: torch.Tensor
    vehicle_width: torch.Tensor
    vehicle_height: torch.Tensor
    agent_type: torch.Tensor
    ids: torch.Tensor

    @classmethod
    def from_array(cls, arr):
        return cls(
            speed=arr[..., 0],
            rel_pos_x=arr[..., 1],
            rel_pos_y=arr[..., 2],
            orientation=arr[..., 3],
            vehicle_length=arr[..., 4] * AGENT_SCALE,
            vehicle_width=arr[..., 5] * AGENT_SCALE,
            vehicle_height=arr[..., 6],
            agent_type=arr[..., 7].to(torch.int32),
            ids=arr[..., 8],
        )

    def normalize(self):
        self.speed = self.speed / C.MAX_SPEED
        self.rel_pos_x = _minmax(
            self.rel_pos_x, C.MIN_REL_GOAL_COORD, C.MAX_REL_GOAL_COORD
        )
        self.rel_pos_y = _minmax(
            self.rel_pos_y, C.MIN_REL_GOAL_COORD, C.MAX_REL_GOAL_COORD
        )
        self.orientation = self.orientation / C.MAX_ORIENTATION_RAD
        self.vehicle_length = self.vehicle_length / C.MAX_VEH_LEN
        self.vehicle_width = self.vehicle_width / C.MAX_VEH_WIDTH
        self.vehicle_height = self.vehicle_height / C.MAX_VEH_HEIGHT
        return self

    def one_hot_encode_agent_types(self):
        """Map {Vehicle, Pedestrian, Cyclist} -> classes 1..3, one-hot(4)
        (reference: datatypes/observation.py:366-387)."""
        t = self.agent_type
        t = torch.where(t == C.ET_VEHICLE, 1, t)
        t = torch.where(t == C.ET_PEDESTRIAN, 2, t)
        t = torch.where(t == C.ET_CYCLIST, 3, t)
        self.agent_type = one_hot(t.clamp(0, 3), 4)
        return self

    @property
    def shape(self):
        return self.speed.shape


@dataclasses.dataclass
class LidarObs:
    """View over lidar samples [.., 3, S, 4]
    (reference: datatypes/observation.py:286-318)."""

    agent_samples: torch.Tensor
    road_edge_samples: torch.Tensor
    road_line_samples: torch.Tensor

    @classmethod
    def from_array(cls, arr):
        return cls(
            agent_samples=arr[..., 0, :, :],
            road_edge_samples=arr[..., 1, :, :],
            road_line_samples=arr[..., 2, :, :],
        )


@dataclasses.dataclass
class BevObs:
    """View over the BEV grid [.., RES, RES, 1]
    (reference: datatypes/observation.py:321-357)."""

    bev_segmentation_map: torch.Tensor

    @classmethod
    def from_array(cls, arr):
        return cls(bev_segmentation_map=arr)

    def one_hot_encode_bev_map(self):
        t = self.bev_segmentation_map[..., 0].to(torch.int32)
        self.bev_segmentation_map = one_hot(
            t.clamp(0, C.NUM_ENTITY_TYPES - 1), C.NUM_ENTITY_TYPES
        )
        return self
