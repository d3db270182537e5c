"""Simulation constants of the plain reference: a frozen copy of the
port's ``constants.py`` (reference: src/consts.hpp:11-66).
"""

import math

# World capacity (reference: src/consts.hpp:11-13)
MAX_AGENTS = 128
MAX_ROAD_ENTITIES = 10_000
MAX_AGENT_MAP_OBS = 200  # top-K road observations per agent

# Inverse-bicycle uses velocity-estimated yaw (reference: src/consts.hpp:15)
USE_ESTIMATED_YAW = True

# An agent whose goal is closer than this to its start is static
# (reference: src/consts.hpp:17)
STATIC_THRESHOLD = 0.2

# Vehicle bounding boxes are shrunk by this factor to absorb dataset noise
# (reference: src/consts.hpp:25)
VEHICLE_LENGTH_SCALE = 0.7

# Episode horizon (reference: src/consts.hpp:34)
EPISODE_LEN = 91
TRAJECTORY_LEN = 91

# Lidar configuration (reference: src/consts.hpp:37-46)
NUM_LIDAR_SAMPLES = 50
LIDAR_CAR_OFFSET = 0.5
LIDAR_ROAD_EDGE_OFFSET = 0.1
LIDAR_ROAD_LINE_OFFSET = -0.1
LIDAR_DISTANCE = 200.0
LIDAR_ANGLE = math.pi / 3  # 120 degree cone

# BEV rasterization (reference: src/consts.hpp:49)
BEV_RESOLUTION = 200

# Physics delta (reference: src/consts.hpp:52). NOTE the dynamics models use a
# hardcoded dt=0.1 (src/dynamics.hpp:14,58,87,119); DELTA_T is only the
# (unused here) physics-engine step.
DELTA_T = 0.04
DYNAMICS_DT = 0.1

# Where done/removed agents are teleported (reference: src/consts.hpp:64)
PADDING_POSITION = (-11000.0, -11000.0)
PADDING_Z = 3.4028235e38  # FLT_MAX

# Scene-compiler caps (reference: src/init.hpp:8-12)
MAX_OBJECTS = 515
MAX_ROADS = 956
MAX_POSITIONS = 91
MAX_GEOMETRY = 1746

# Action tensor is a 10-float union (reference: src/types.hpp:109-145)
ACTION_DIM = 10

# Entity types (reference: src/types.hpp:24-38; order is load-bearing:
# {reducible road types, non-reducible road types, agent types, other})
ET_NONE = 0
ET_ROAD_EDGE = 1
ET_ROAD_LINE = 2
ET_ROAD_LANE = 3
ET_CROSSWALK = 4
ET_SPEED_BUMP = 5
ET_STOP_SIGN = 6
ET_VEHICLE = 7
ET_PEDESTRIAN = 8
ET_CYCLIST = 9
ET_PADDING = 10
NUM_ENTITY_TYPES = 11

# Waymax-aligned map element ids (reference: src/types.hpp:40-65)
MAP_TYPE_UNKNOWN = -1
MAP_TYPE_NUM_TYPES = 21

# Trajectory export blob: 91x{pos2} || 91x{vel2} || 91x{heading} || 91x{valid}
# || 91x{invAction10} = 1456 floats (reference: src/types.hpp:348-371)
TRAJECTORY_EXPORT_SIZE = (2 + 2 + 1 + 1 + ACTION_DIM) * TRAJECTORY_LEN

# Observation-normalization bounds (reference: gpudrive/env/constants.py)
MAX_SPEED = 100.0
MAX_VEH_LEN = 30.0
MAX_VEH_WIDTH = 15.0
MAX_VEH_HEIGHT = 10.0
MIN_REL_GOAL_COORD = -1000.0
MAX_REL_GOAL_COORD = 1000.0
MIN_REL_AGENT_POS = -1000.0
MAX_REL_AGENT_POS = 1000.0
MAX_ORIENTATION_RAD = 2.0 * math.pi
MIN_RG_COORD = -1000.0
MAX_RG_COORD = 1000.0
MAX_ROAD_LINE_SEGMENT_LEN = 100.0
MAX_ROAD_SCALE = 100.0

EGO_FEAT_DIM = 6
PARTNER_FEAT_DIM = 6
ROAD_GRAPH_FEAT_DIM = 13
