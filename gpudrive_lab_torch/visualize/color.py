"""Color palette for simulator rendering (port of
``gpudrive_lab_tpu/visualize/color.py``; reference:
gpudrive/visualize/color.py)."""

from gpudrive_lab_torch import constants as C

ROAD_GRAPH_COLORS = {
    C.ET_NONE: "#d9d9d9",
    C.ET_ROAD_EDGE: "#111111",
    C.ET_ROAD_LINE: "#bdbdbd",
    C.ET_ROAD_LANE: "#e6e6e6",
    C.ET_CROSSWALK: "#8da0cb",
    C.ET_SPEED_BUMP: "#fc8d62",
    C.ET_STOP_SIGN: "#d53e4f",
}

AGENT_COLOR_BY_STATE = {
    "ok": "#2b83ba",
    "collided": "#d7191c",
    "goal_achieved": "#1a9641",
    "expert": "#808080",
    "static": "#bababa",
}

POLICY_COLORS = [
    "#2b83ba", "#d7191c", "#1a9641", "#ff7f00", "#984ea3", "#a65628",
]
