"""The port's WOMD data utilities (gpudrive_lab_torch/data_utils) against
the JAX package's on the same seeded inputs: scenario_to_dict on seeded
synthetic scenarios and on hand-made edge cases, a TFRecord shard through
process_waymo_files (JSON byte for byte), the TFRecord framing,
post_processing and detect_behavior; the port's vendored proto (its own
descriptor, imported beside the JAX package's, on the official wire
numbers); and the port's ingest chain from a shard to an expert replay."""

import copy
import json
import os
import re
import shutil
import struct
import sys
import types

import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.data_utils import detect_behavior as jdb
from gpudrive_lab_tpu.data_utils import post_processing as jpp
from gpudrive_lab_tpu.data_utils import process_waymo_files as jpwf
from gpudrive_lab_tpu.data_utils import tfrecord as jtf
from gpudrive_lab_tpu.data_utils import waymo_converter as jwc
from gpudrive_lab_tpu.data_utils.waymo_protos import scenario_lite_pb2 as jpb
from gpudrive_lab_torch import native
from gpudrive_lab_torch.data_utils import detect_behavior as tdb
from gpudrive_lab_torch.data_utils import post_processing as tpp
from gpudrive_lab_torch.data_utils import process_waymo_files as tpwf
from gpudrive_lab_torch.data_utils import synthetic_womd as sw
from gpudrive_lab_torch.data_utils import tfrecord as ttf
from gpudrive_lab_torch.data_utils import waymo_converter as twc
from gpudrive_lab_torch.data_utils.waymo_protos import scenario_lite_pb2 as tpb
from torch_parity import ROOT, assert_jax_native, jax_params

PROTO = os.path.join(ROOT, "gpudrive_lab_torch", "data_utils", "waymo_protos",
                     "scenario_lite.proto")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scenario_to_dict_equals_jax(seed):
    """Seeded synthetic scenarios (U-turns, reversing, parked vehicles,
    pedestrians, cyclists, late-valid tracks, every map feature, one
    traffic-light scene in eight): the same dicts, None where filtered."""
    n_filtered = 0
    for i, sc in enumerate(sw.synthetic_scenarios(8, seed=seed,
                                                  num_tracks=24)):
        got = twc.scenario_to_dict(sc, f"tfrecord-s_{i}.json")
        want = jwc.scenario_to_dict(sc, f"tfrecord-s_{i}.json")
        assert got == want, i
        n_filtered += got is None
    assert n_filtered == 1


def _edge_case(name):
    desc = sw.describe(0, seed=5, num_tracks=6, num_lanes=2, points=11)
    if name == "overpass":
        # a road-edge vertex 5 m above one of the first edge's (at x =
        # 40 m), 5 cm away from it in xy
        desc["features"].append(
            (99, "road_edge", 1, [(40.0, -0.45 + 0.5 * np.sin(40.0 / 7.0),
                                   5.0), (40.0, 10.0, 5.0)]))
    elif name == "never_valid":
        for s in desc["tracks"][1]["states"]:
            s["valid"] = False
    elif name == "spawn_overlap":
        # two vehicles, valid throughout, 0.5 m apart at every step
        a, b = desc["tracks"][0], desc["tracks"][3]
        a["object_type"] = b["object_type"] = 1
        for sa in a["states"]:
            sa["valid"] = True
        b["states"] = [dict(sa, center_x=sa["center_x"] + 0.5)
                       for sa in a["states"]]
    elif name == "no_map":
        desc["features"] = []
    return sw.as_namespace(desc)


@pytest.mark.parametrize("name", ["overpass", "never_valid",
                                  "spawn_overlap", "no_map"])
def test_scenario_to_dict_edge_cases_equal_jax(name):
    sc = _edge_case(name)
    got = twc.scenario_to_dict(sc, "tfrecord-e_0.json")
    assert got == jwc.scenario_to_dict(sc, "tfrecord-e_0.json")
    if name == "overpass":
        assert got is None
    if name == "spawn_overlap":
        flags = {o["id"]: o["mark_as_expert"] for o in got["objects"]}
        assert flags[100] and flags[103]


def _shard(path, n, seed, pb2):
    return ttf.write_tfrecord(path, [
        s.SerializeToString()
        for s in sw.synthetic_scenarios(n, seed=seed, num_tracks=16,
                                        pb2=pb2)])


def test_process_tfrecord_json_byte_for_byte(tmp_path):
    """One shard, serialized once: the port (its vendored proto) and the
    JAX package (its own) write the same files, byte for byte, and the
    plain-object form of the same scenarios converts to the same JSON."""
    shard = tmp_path / "training.tfrecord-00003-of-00010"
    assert _shard(str(shard), 9, 7, tpb) == 9
    outs = {}
    for name, mod in (("port", tpwf), ("jax", jpwf)):
        out = tmp_path / name
        out.mkdir()
        assert mod.process_tfrecord((str(shard), str(out))) == (
            str(shard), 8, 1)
        outs[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]) == 8
    for i, sc in enumerate(sw.synthetic_scenarios(9, seed=7, num_tracks=16)):
        name = f"tfrecord-00003-of-00010_{i}.json"
        d = twc.scenario_to_dict(sc, name)
        assert (d is None) == (name not in outs["port"])
        if d is not None:
            assert json.dumps(d).encode() == outs["port"][name]


def test_tfrecord_framing_equals_jax(tmp_path):
    rng = np.random.default_rng(11)
    payloads = [rng.bytes(int(n)) for n in rng.integers(0, 3000, 12)]
    payloads.append(b"")
    for p in payloads[:4]:
        assert ttf.crc32c(p) == jtf.crc32c(p)
        assert ttf.masked_crc32c(p) == jtf.masked_crc32c(p)
    a, b = tmp_path / "port.tfrecord", tmp_path / "jax.tfrecord"
    assert ttf.write_tfrecord(str(a), payloads) == len(payloads)
    jtf.write_tfrecord(str(b), payloads)
    assert a.read_bytes() == b.read_bytes()
    assert list(ttf.read_tfrecord(str(b))) == list(jtf.read_tfrecord(str(a)))
    assert list(ttf.read_tfrecord(str(a))) == payloads
    # a flipped payload byte: both refuse it the same way
    raw = bytearray(a.read_bytes())
    raw[20] ^= 0xFF
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(raw))
    errors = []
    for mod in (ttf, jtf):
        with pytest.raises(IOError) as e:
            list(mod.read_tfrecord(str(bad)))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert list(ttf.read_tfrecord(str(bad), verify=False)) == list(
        jtf.read_tfrecord(str(bad), verify=False))


def _dataset_dir(root):
    """Good, corrupt and incomplete scene files at the top and in a
    ``group_*`` subdirectory (the hub download's layout)."""
    good = {"name": "a", "objects": [{"position": [], "type": "vehicle"}],
            "roads": [{"geometry": [{"x": 1, "y": 2}]}], "tl_states": {}}
    bad_geom = copy.deepcopy(good)
    bad_geom["roads"][0]["geometry"] = [{"x": 1}]
    root.mkdir()
    (root / "tfrecord_good.json").write_text(json.dumps(good))
    (root / "tfrecord_broken.json").write_text("{broken")
    (root / "tfrecord_missing.json").write_text(json.dumps({"name": "x"}))
    (root / "tfrecord_geom.json").write_text(json.dumps(bad_geom))
    g = root / "group_0"
    g.mkdir()
    (g / "tfrecord_g1.json").write_text(json.dumps(good))
    (g / "tfrecord_g2.json").write_text("[]")
    return sorted(str(p) for p in root.rglob("*.json"))


def test_post_processing_equals_jax(tmp_path):
    files = _dataset_dir(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    for f in files:
        assert tpp.is_valid_json_structure(f) == jpp.is_valid_json_structure(f)
    got = tpp.process_directory(str(tmp_path / "port"), num_workers=2)
    want = jpp.process_directory(str(tmp_path / "jax"), num_workers=2)
    assert got == want == (2, 4)

    def left(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*"))

    assert left(tmp_path / "port") == left(tmp_path / "jax") == [
        "tfrecord_g1.json", "tfrecord_good.json"]


def test_detect_behavior_equals_jax(tmp_path):
    """The two checks on seeded headings and velocities, and the directory
    scan on synthetic scenes with U-turns and reversing."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = int(rng.integers(2, 91))
        h = np.cumsum(rng.normal(0, 0.2, n))
        v = rng.normal(0, 4, (n, 2))
        valid = rng.random(n) > 0.1
        assert tdb.check_uturn(h, valid) == jdb.check_uturn(h, valid)
        for k in (3, 10):
            assert tdb.check_reversing(h, v, valid, k) == jdb.check_reversing(
                h, v, valid, k)
    for i, sc in enumerate(sw.synthetic_scenarios(8, seed=4, num_tracks=24)):
        d = twc.scenario_to_dict(sc, f"tfrecord-b_{i}.json")
        if d is not None:
            (tmp_path / d["name"]).write_text(json.dumps(d))
    for f in sorted(tmp_path.iterdir()):
        assert tdb.process_scene((str(f), 10)) == jdb.process_scene(
            (str(f), 10))
    got = tdb.process_directory(str(tmp_path), 10, num_workers=2)
    want = jdb.process_directory(str(tmp_path), 10, num_workers=2)
    assert sorted(got.pop("flagged_scenes")) == sorted(
        want.pop("flagged_scenes"))
    assert got == want
    assert got["total_uturns"] > 0 and got["total_reversing"] > 0


def _wire_varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _wire_field(num, wire_type, payload):
    return _wire_varint((num << 3) | wire_type) + payload


def _wire_len(num, payload):
    return _wire_field(num, 2, _wire_varint(len(payload)) + payload)


def _wire_double(num, v):
    return _wire_field(num, 1, struct.pack("<d", v))


def test_vendored_proto_matches_official_wire_numbers():
    """The port's vendored Scenario, imported in the same process as the
    JAX package's, parses a payload hand-encoded with the official WOMD
    field numbers (the model of tests/test_data_utils.py)."""
    assert tpb.DESCRIPTOR.package == "gpudrive_lab_torch.waymo_lite"
    assert jpb.DESCRIPTOR.package == "gpudrive_lab_tpu.waymo_lite"
    assert tpb.DESCRIPTOR.name != jpb.DESCRIPTOR.name
    state = (
        _wire_double(2, 12.5)            # center_x
        + _wire_field(5, 5, struct.pack("<f", 4.5))   # length
        + _wire_field(8, 5, struct.pack("<f", 0.25))  # heading
        + _wire_field(10, 5, struct.pack("<f", -1.5))  # velocity_y
        + _wire_field(11, 0, b"\x01")    # valid
    )
    track = (
        _wire_field(1, 0, _wire_varint(7))   # id
        + _wire_field(2, 0, _wire_varint(1))  # object_type = vehicle
        + _wire_len(3, state)
    )
    point = _wire_double(1, 1.0) + _wire_double(2, 2.0) + _wire_double(3, 3.0)
    road_edge = _wire_field(1, 0, b"\x01") + _wire_len(2, point)
    lane = _wire_field(2, 0, b"\x02") + _wire_len(8, point)
    stop = _wire_field(1, 0, _wire_varint(43)) + _wire_len(2, point)
    feature = _wire_field(1, 0, _wire_varint(42)) + _wire_len(5, road_edge)
    feature2 = _wire_field(1, 0, _wire_varint(43)) + _wire_len(3, lane)
    feature3 = _wire_field(1, 0, _wire_varint(44)) + _wire_len(7, stop)
    feature4 = _wire_field(1, 0, _wire_varint(45)) + _wire_len(8, _wire_len(
        1, point))
    lane_state = (
        _wire_field(1, 0, _wire_varint(11)) + _wire_field(2, 0, b"\x03")
    )
    dms = _wire_len(1, lane_state)
    ttp = _wire_field(1, 0, b"\x00") + _wire_field(2, 0, b"\x01")
    payload = (
        _wire_double(1, 0.0)                     # timestamps_seconds
        + _wire_field(2, 0, _wire_varint(10))    # current_time_index
        + _wire_len(3, track)                    # tracks
        + _wire_len(4, dms)                      # dynamic_map_states
        + _wire_len(5, b"wire-check")            # scenario_id
        + _wire_len(6, feature)                  # map_features
        + _wire_len(6, feature2)
        + _wire_len(6, feature3)
        + _wire_len(6, feature4)
        + _wire_field(7, 0, _wire_varint(0))     # sdc_track_index
        + _wire_field(8, 0, _wire_varint(7))     # objects_of_interest
        + _wire_len(10, ttp)                     # tracks_to_predict
    )
    sc = tpb.Scenario()
    sc.ParseFromString(payload)
    assert sc.scenario_id == "wire-check"
    assert sc.current_time_index == 10
    assert sc.sdc_track_index == 0
    assert list(sc.objects_of_interest) == [7]
    assert len(sc.tracks) == 1 and sc.tracks[0].id == 7
    assert sc.tracks[0].object_type == 1
    s0 = sc.tracks[0].states[0]
    assert (s0.center_x, s0.length, s0.heading, s0.velocity_y) == (
        12.5, 4.5, 0.25, -1.5)
    assert s0.valid
    kinds = [f.WhichOneof("feature_data") for f in sc.map_features]
    assert kinds == ["road_edge", "lane", "stop_sign", "crosswalk"]
    assert sc.map_features[0].id == 42
    assert sc.map_features[0].road_edge.polyline[0].z == 3.0
    assert sc.map_features[1].lane.type == 2
    assert list(sc.map_features[2].stop_sign.lane) == [43]
    assert sc.map_features[2].stop_sign.position.y == 2.0
    assert sc.map_features[3].crosswalk.polygon[0].x == 1.0
    assert sc.dynamic_map_states[0].lane_states[0].lane == 11
    assert sc.dynamic_map_states[0].lane_states[0].state == 3
    assert sc.tracks_to_predict[0].difficulty == 1
    # the JAX package's copy reads the same bytes to the same message
    jsc = jpb.Scenario()
    jsc.ParseFromString(payload)
    assert jsc.SerializeToString() == sc.SerializeToString()


def test_proto_text_matches_descriptor():
    """Every field of scenario_lite.proto, message by message, has the
    name, number and repetition of the descriptor that scenario_lite_pb2.py
    registers, and the JAX package's descriptor has the same fields."""
    text = open(PROTO).read()
    assert "package gpudrive_lab_torch.waymo_lite;" in text
    for msg, body in re.findall(r"message (\w+) \{(.*?)\n\}", text, re.S):
        fields = re.findall(r"(optional|repeated)?\s*(\w+) (\w+) = (\d+);",
                            body)
        desc = tpb.DESCRIPTOR.message_types_by_name[msg]
        jdesc = jpb.DESCRIPTOR.message_types_by_name[msg]
        assert len(fields) == len(desc.fields) == len(jdesc.fields), msg
        for label, _type, name, num in fields:
            f = desc.fields_by_name[name]
            assert f.number == int(num), (msg, name)
            assert f.is_repeated == (label == "repeated"), (msg, name)
            assert jdesc.fields_by_name[name].number == f.number


def test_scenario_pb2_prefers_official(monkeypatch):
    """The official waymo_open_dataset protos first, then the port's own
    vendored subset (never the JAX package's)."""
    assert tpwf._scenario_pb2() is tpb
    fake = types.ModuleType("waymo_open_dataset.protos.scenario_pb2")
    pkg = types.ModuleType("waymo_open_dataset")
    protos = types.ModuleType("waymo_open_dataset.protos")
    protos.scenario_pb2 = fake
    pkg.protos = protos
    monkeypatch.setitem(sys.modules, "waymo_open_dataset", pkg)
    monkeypatch.setitem(sys.modules, "waymo_open_dataset.protos", protos)
    monkeypatch.setitem(sys.modules,
                        "waymo_open_dataset.protos.scenario_pb2", fake)
    assert tpwf._scenario_pb2() is fake


def test_ingest_chain_to_expert_replay(tmp_path):
    """Synthetic scenarios -> TFRecord -> the port's converter -> post-
    processing validation -> behavior tags -> the native compiler (the JAX
    package's native scene, bit for bit) -> 91 expert steps: every valid
    vehicle of the logs reaches its goal region or stays valid, no
    declined scene."""
    from gpudrive_lab_tpu.scene.compiler import build_scene as jbuild
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv

    shard = tmp_path / "training.tfrecord-00000-of-00001"
    _shard(str(shard), 8, 9, tpb)
    out = tmp_path / "json"
    out.mkdir()
    assert tpwf.process_tfrecord((str(shard), str(out)))[1:] == (7, 1)
    assert tpp.process_directory(str(out), num_workers=2) == (7, 0)
    tags = tdb.process_directory(str(out), 10, num_workers=2)
    assert tags["total_agents"] > 0
    paths = sorted(str(p) for p in out.iterdir())
    assert_jax_native()
    native.reset_fallbacks()
    env = GPUDriveTorchEnv(EnvConfig(), paths, device="cpu")
    assert native.fallbacks() == 0
    jscene = jbuild(paths, jax_params(env.params))
    np.testing.assert_array_equal(env.scene.agents.traj_pos.numpy(),
                                  np.asarray(jscene.agents.traj_pos))
    np.testing.assert_array_equal(env.scene.roads.pos.numpy(),
                                  np.asarray(jscene.roads.pos))
    expert = env.get_expert_actions()[0]
    env.reset()
    for t in range(env.episode_len):
        env.step_dynamics(expert[:, :, t])
    obs = env.get_obs()
    assert torch.isfinite(obs).all()
    assert int(env.scene.num_agents.sum()) > 0
