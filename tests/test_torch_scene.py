"""Scene compiler parity: the port's build_scene is bitwise equal to the JAX
package's, field by field, road tiles included."""

import dataclasses

import numpy as np
import pytest

from gpudrive_lab_tpu.scene.compiler import build_scene as jax_build_scene
from gpudrive_lab_torch.core.types import DynamicsModel, Params
from gpudrive_lab_torch.scene.compiler import build_scene
from gpudrive_lab_torch.scene.loader import reduce_polyline
from gpudrive_lab_tpu.scene.loader import reduce_polyline as jax_reduce
from torch_parity import (
    POOL_SCENES,
    SYNTHETIC_SCENE,
    jax_params,
    python_scene_compiler,
)

PARAM_SETS = {
    "classic": Params(polyline_reduction_threshold=0.1,
                      ignore_non_vehicles=True, use_tile_collision=True),
    "bicycle": Params(dynamics_model=DynamicsModel.INVERTIBLE_BICYCLE,
                      polyline_reduction_threshold=0.5,
                      max_num_controlled_agents=3, use_tile_collision=True),
    "delta": Params(dynamics_model=DynamicsModel.DELTA_LOCAL,
                    init_only_valid_agents=False, use_tile_collision=True),
}


def _leaves(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            out[prefix + f.name] = None
        elif dataclasses.is_dataclass(v):
            out.update(_leaves(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = np.asarray(
                v.numpy() if hasattr(v, "numpy") else v
            )
    return out


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
@pytest.mark.parametrize("max_agents", [None, "auto"])
def test_build_scene_bitwise(name, max_agents):
    params = PARAM_SETS[name]
    paths = [SYNTHETIC_SCENE] + POOL_SCENES[:8]
    with python_scene_compiler():
        scene = build_scene(paths, params, max_agents=max_agents,
                            device="cpu")
        jscene = jax_build_scene(paths, jax_params(params),
                                 max_agents=max_agents)
    got, want = _leaves(scene), _leaves(jscene)
    assert sorted(got) == sorted(want)
    assert scene.rtiles is not None
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
            continue
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_road_bucket_and_tile_switch():
    """256-road bucketing, and road tiles built at the 2048 bucket without
    being asked for."""
    params = Params(polyline_reduction_threshold=0.1)
    small = build_scene(POOL_SCENES[:2], params, device="cpu")
    assert small.max_roads == 256 and small.rtiles is None
    with pytest.warns(UserWarning):
        big = build_scene(POOL_SCENES[:2], params, max_roads=2000,
                          device="cpu")
    assert big.max_roads == 2048
    assert big.rtiles.feat.shape == (2, 8, 8, 256)


def test_reduce_polyline_matches():
    rng = np.random.default_rng(0)
    pts = np.cumsum(rng.normal(0, 1, (40, 2)), axis=0).astype(np.float32)
    for thr in (0.0, 0.1, 0.5, 2.0):
        np.testing.assert_array_equal(reduce_polyline(pts, thr),
                                      jax_reduce(pts, thr))
