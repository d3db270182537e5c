"""The large map's seeded generator and its scene JSON."""

import json

import numpy as np

from gdbench.scenes import large_map
from gdbench.reference import compiler, env_obs

SPEC = dict(W=2, A=32, R=12800, n_active=24, side=400.0, map_seed=0,
            segments_per_polyline=64)
ENV = json.loads((__import__("conftest").BENCH_DIR / "configs" /
                  "gpudrive_sim.json").read_text())["env"]


def test_the_same_seed_gives_the_same_map():
    a = large_map.generate(2, 32, 1280, 24, 400.0, 7)
    b = large_map.generate(2, 32, 1280, 24, 400.0, 7)
    c = large_map.generate(2, 32, 1280, 24, 400.0, 8)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["mid"], c["mid"])
    # agents within the radius of the centre of traffic, on the roads
    act = a["agents"][..., 6] > 0
    assert act.sum(1).tolist() == [24, 24]


def test_scene_json_compiles_to_a_full_road_bucket(tmp_path):
    paths = large_map.scene_paths(SPEC, tmp_path)
    assert paths == large_map.scene_paths(SPEC, tmp_path)  # found again
    world = json.loads(open(paths[0]).read())
    assert len(world["objects"]) == 24
    assert world["roads"][0]["type"] == "stop_sign"
    assert len(world["roads"]) <= 956  # the reader's road cap
    scene = compiler.build_scene(paths, env_obs.params_from_env(ENV),
                                 max_agents="auto", device="cpu")
    assert scene.num_roads.tolist() == [10000, 10000]
    assert scene.roads.valid.shape == (2, 10240)
    assert scene.agents.controlled.sum(1).tolist() == [24, 24]
    assert scene.rtiles is not None
