"""The scene dataset loader and scene selection (gpudrive_lab_torch/env/
dataset.py) against the JAX package's: the same path lists, exactly, for
every selection discipline, with and without replacement, shuffled, with
scene_nums, a dataset_size below and above the file count and a directory
with fewer files than a batch, each for two seeds."""

import os

import pytest

from gpudrive_lab_tpu.env import config as jconfig
from gpudrive_lab_tpu.env import dataset as jdataset
from gpudrive_lab_torch.env import config as tconfig
from gpudrive_lab_torch.env import dataset as tdataset
from torch_parity import POOL_SCENES, ROOT

POOL = os.path.dirname(POOL_SCENES[0])  # 512 tfrecord-*.json scenes
ONE_FILE = os.path.join(ROOT, "tests", "data")  # one tfrecord*.json
SEEDS = (0, 7)


def _batches(loader_cls, n_batches, passes=2, **kw):
    """Path batches of ``passes`` iterations over the loader, each of at
    most ``n_batches`` batches (a pass without replacement ends where the
    loader stops)."""
    loader = loader_cls(**kw)
    out = []
    for _ in range(passes):
        it = iter(loader)
        for _ in range(n_batches):
            try:
                out.append(next(it))
            except StopIteration:
                out.append("stop")
                break
    return out, len(loader), loader.dataset_size


@pytest.fixture(scope="module")
def three_files(tmp_path_factory):
    """A directory of 3 pool scenes (fewer than a batch) and a file
    without the tfrecord prefix, which the loader must skip."""
    d = tmp_path_factory.mktemp("three")
    for p in POOL_SCENES[:3]:
        os.symlink(p, d / os.path.basename(p))
    os.symlink(POOL_SCENES[3], d / "other.json")
    return str(d)


CASES = {
    "replacement": dict(batch_size=8, dataset_size=1000,
                        sample_with_replacement=True),
    "no-replacement": dict(batch_size=100, dataset_size=1000),
    "shuffle": dict(batch_size=64, dataset_size=1000, shuffle=True),
    "shuffle-replacement": dict(batch_size=16, dataset_size=300,
                                shuffle=True, sample_with_replacement=True),
    "scene-nums": dict(batch_size=3, dataset_size=1000,
                       scene_nums=[5, 17, 3, 400, 511, 17, 0]),
    "size-below-files": dict(batch_size=7, dataset_size=40),
    "size-above-files": dict(batch_size=128, dataset_size=5000,
                             sample_with_replacement=True),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_batches_match_jax(case, seed):
    kw = dict(CASES[case], root=POOL, seed=seed)
    got = _batches(tdataset.SceneDataLoader, 6, **kw)
    want = _batches(jdataset.SceneDataLoader, 6, **kw)
    assert got == want
    assert got[0] and got[0][0] != "stop"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("replacement", [False, True])
@pytest.mark.parametrize("root", ["one-file", "three-files"])
def test_loader_repeats_short_directories_as_jax(root, replacement, seed,
                                                 three_files):
    """Fewer files than a batch: the files repeat to fill it."""
    kw = dict(root=ONE_FILE if root == "one-file" else three_files,
              batch_size=5, dataset_size=1000,
              sample_with_replacement=replacement, seed=seed)
    got = _batches(tdataset.SceneDataLoader, 3, **kw)
    assert got == _batches(jdataset.SceneDataLoader, 3, **kw)
    assert all(len(b) == 5 for b in got[0] if b != "stop")
    assert not any("other.json" in p for b in got[0] if b != "stop"
                   for p in b)


def test_loader_refuses_as_jax(tmp_path):
    for mod in (tdataset, jdataset):
        with pytest.raises(FileNotFoundError):
            mod.SceneDataLoader(root=str(tmp_path / "missing"),
                                batch_size=1, dataset_size=1)
        with pytest.raises(ValueError, match="tfrecord"):
            mod.SceneDataLoader(root=str(tmp_path), batch_size=1,
                                dataset_size=1)
        with pytest.raises(ValueError, match="out of bounds"):
            mod.SceneDataLoader(root=POOL, batch_size=1, dataset_size=10,
                                scene_nums=[10])


DISCIPLINES = {
    "FIRST_N": dict(num_scenes=37),
    "RANDOM_N": dict(num_scenes=50),
    "PAD_N": dict(num_scenes=700),
    "EXACT_N": dict(num_scenes=512),
    "K_UNIQUE_N": dict(num_scenes=90, k_unique_scenes=7),
    "RANGE_N": dict(num_scenes=20, start_idx=300),
    "CUSTOM_N": dict(custom_idx=[9, 3, 500, 3]),
}


@pytest.mark.parametrize("seed", SEEDS + (None,))
@pytest.mark.parametrize("discipline", sorted(DISCIPLINES))
def test_select_scenes_matches_jax(discipline, seed):
    def select(mod):
        return mod.select_scenes(mod.SceneConfig(
            batch_size=8, dataset_size=1000, path=POOL, seed=seed,
            discipline=mod.SelectionDiscipline[discipline],
            **DISCIPLINES[discipline]))

    got = select(_Both(tconfig, tdataset))
    want = select(_Both(jconfig, jdataset))
    assert got == want and got


class _Both:
    """One package's config and dataset modules as one namespace."""

    def __init__(self, config, dataset):
        self.SceneConfig = config.SceneConfig
        self.SelectionDiscipline = config.SelectionDiscipline
        self.select_scenes = dataset.select_scenes


def test_selection_enums_match_jax():
    assert ([(d.name, d.value) for d in tconfig.SelectionDiscipline]
            == [(d.name, d.value) for d in jconfig.SelectionDiscipline])
