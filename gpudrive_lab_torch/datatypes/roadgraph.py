"""Road-graph views (port of ``gpudrive_lab_tpu/datatypes/roadgraph.py``;
reference: gpudrive/datatypes/roadgraph.py)."""

from __future__ import annotations

import dataclasses
import enum

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.datatypes.observation import _minmax, one_hot


class MapElementIds(enum.IntEnum):
    """Waymax-aligned map element ids (reference:
    gpudrive/datatypes/roadgraph.py:10-39)."""

    LANE_UNDEFINED = 0
    LANE_FREEWAY = 1
    LANE_SURFACE_STREET = 2
    LANE_BIKE_LANE = 3
    ROAD_LINE_UNKNOWN = 5
    ROAD_LINE_BROKEN_SINGLE_WHITE = 6
    ROAD_LINE_SOLID_SINGLE_WHITE = 7
    ROAD_LINE_SOLID_DOUBLE_WHITE = 8
    ROAD_LINE_BROKEN_SINGLE_YELLOW = 9
    ROAD_LINE_BROKEN_DOUBLE_YELLOW = 10
    ROAD_LINE_SOLID_SINGLE_YELLOW = 11
    ROAD_LINE_SOLID_DOUBLE_YELLOW = 12
    ROAD_LINE_PASSING_DOUBLE_YELLOW = 13
    ROAD_EDGE_UNKNOWN = 14
    ROAD_EDGE_BOUNDARY = 15
    ROAD_EDGE_MEDIAN = 16
    STOP_SIGN = 17
    CROSSWALK = 18
    SPEED_BUMP = 19
    DRIVEWAY = 20
    UNKNOWN = -1


def _columns(arr):
    return dict(
        x=arr[..., 0],
        y=arr[..., 1],
        segment_length=arr[..., 2],
        segment_width=arr[..., 3],
        segment_height=arr[..., 4],
        orientation=arr[..., 5],
        type=arr[..., 6].to(torch.int32),
        id=arr[..., 7],
        map_type=arr[..., 8],
    )


@dataclasses.dataclass
class LocalRoadGraphPoints:
    """View over agent_roadmap rows [.., K, 9]
    (reference: datatypes/roadgraph.py:262-368)."""

    x: torch.Tensor
    y: torch.Tensor
    segment_length: torch.Tensor
    segment_width: torch.Tensor
    segment_height: torch.Tensor
    orientation: torch.Tensor
    type: torch.Tensor
    id: torch.Tensor
    map_type: torch.Tensor

    @classmethod
    def from_array(cls, arr):
        return cls(**_columns(arr))

    def normalize(self):
        self.x = _minmax(self.x, C.MIN_RG_COORD, C.MAX_RG_COORD)
        self.y = _minmax(self.y, C.MIN_RG_COORD, C.MAX_RG_COORD)
        self.segment_length = (
            self.segment_length / C.MAX_ROAD_LINE_SEGMENT_LEN
        )
        self.segment_width = self.segment_width / C.MAX_ROAD_SCALE
        self.segment_height = self.segment_height / C.MAX_ROAD_SCALE
        self.orientation = self.orientation / C.MAX_ORIENTATION_RAD
        return self

    def one_hot_encode_road_point_types(self):
        self.type = one_hot(self.type.clamp(0, 6), 7)
        return self

    @property
    def shape(self):
        return self.x.shape


@dataclasses.dataclass
class GlobalRoadGraphPoints:
    """View over the world-frame map_observation rows [W, R, 9]
    (reference: datatypes/roadgraph.py:42-259)."""

    x: torch.Tensor
    y: torch.Tensor
    segment_length: torch.Tensor
    segment_width: torch.Tensor
    segment_height: torch.Tensor
    orientation: torch.Tensor
    type: torch.Tensor
    id: torch.Tensor
    map_type: torch.Tensor

    @classmethod
    def from_array(cls, arr):
        return cls(**_columns(arr))

    def restore_mean(self, mean_x, mean_y):
        self.x = self.x + torch.as_tensor(mean_x).reshape(-1, 1)
        self.y = self.y + torch.as_tensor(mean_y).reshape(-1, 1)
        return self

    def restore_xy(self):
        """Segment midpoints -> segment starts, as used for VBD
        (reference: datatypes/roadgraph.py:200-259): shift each midpoint
        back along its orientation by the segment length."""
        dx = self.segment_length * torch.cos(self.orientation)
        dy = self.segment_length * torch.sin(self.orientation)
        self.x = self.x - dx
        self.y = self.y - dy
        return self
