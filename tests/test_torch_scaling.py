"""The scaling harness (``parallel/scaling.py``) against ``bench_scaling.py``,
the JAX script it ports:

  * its command line at the JAX flags runs 2 gloo ranks on the CPU and
    prints bench_scaling.py's lines, whose keys are read from the JAX
    script's source (one per count on stderr, the summary last on stdout),
    the summary labelled not valid where ranks share a device;
  * its timed program (the synthetic worlds, each rank's block, the
    perturbed actions, the reward accumulator) against the JAX script's
    jitted body over the same worlds for a few steps;
  * the default counts, and the summary's ``valid`` and ``invalid_reason``
    for each placement of the ranks.
"""

import ast
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core import step as jstep
from gpudrive_lab_tpu.core.types import Params as JaxParams
from gpudrive_lab_tpu.scene.synthetic import synthetic_scene as jax_synthetic
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.parallel import scaling
from gpudrive_lab_torch.parallel.mesh import WorldGroup
from torch_parity import ROOT, assert_states_match

TIMEOUT = 120  # seconds a count's ranks may run


def _bench_scaling_keys():
    """(per-count keys, summary keys, keys added to the summary later) of
    the dict literals bench_scaling.py prints."""
    with open(os.path.join(ROOT, "bench_scaling.py")) as f:
        tree = ast.parse(f.read())
    dicts = [{k.value for k in n.keys} for n in ast.walk(tree)
             if isinstance(n, ast.Dict) and n.keys
             and all(isinstance(k, ast.Constant) for k in n.keys)]
    added = {n.targets[0].slice.value for n in ast.walk(tree)
             if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Subscript)
             and isinstance(n.targets[0].value, ast.Name)
             and n.targets[0].value.id == "out"}
    return (next(d for d in dicts if "world_steps_per_sec" in d),
            next(d for d in dicts if "metric" in d), added)


def test_the_cli_prints_bench_scalings_lines(monkeypatch, capsys):
    per_count_keys, summary_keys, added = _bench_scaling_keys()
    assert added == {"invalid_reason"}
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(scaling, "measure_scaling", functools.partial(
        scaling.measure_scaling, timeout=TIMEOUT))
    assert scaling.main(["--platform", "cpu", "--max-devices", "2",
                         "--worlds-per-device", "2", "--steps", "2"]) == 0
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in err.splitlines() if x.startswith("{")]
    assert [set(x) for x in lines] == [per_count_keys] * 2
    assert [x["devices"] for x in lines] == [1, 2]
    assert [x["worlds"] for x in lines] == [2, 4]
    assert all(isinstance(x["world_steps_per_sec"], int)
               and x["world_steps_per_sec"] > 0 for x in lines)

    summary = json.loads(out.strip().splitlines()[-1])
    assert set(summary) == summary_keys | added
    assert summary["metric"] == "scaling_efficiency"
    assert summary["unit"] == "SPS(2 dev) / (2 x SPS(1))"
    # two ranks on the CPU share its cores
    assert summary["valid"] is False
    assert summary["invalid_reason"] == scaling.SHARED_LABEL
    assert list(summary["per_device_counts"]) == ["1", "2"]
    assert summary["per_device_counts"]["1"] == 1.0
    assert summary["per_device_counts"]["2"] == round(summary["value"], 3)
    # value = round(eff, 4) and vs_baseline = round(eff / 0.85, 4), as in
    # bench_scaling.py, so they agree to within the two roundings
    assert summary["vs_baseline"] == pytest.approx(
        summary["value"] / 0.85, abs=0.5e-4 / 0.85 + 0.5e-4)
    # the efficiency is the per-count lines' (rounded to integers)
    sps = [x["world_steps_per_sec"] for x in lines]
    assert summary["value"] == pytest.approx(sps[1] / (2 * sps[0]),
                                             rel=2 / min(sps))


@pytest.mark.parametrize("rep", [0, 2])
def test_the_timed_program_matches_the_jax_script(rep):
    """Two ranks' blocks of 2 synthetic worlds, stepped in this process,
    against the JAX script's body over the 4 worlds for its 30 steps: the
    states each step (flags exact, floats within 1e-3) and the
    accumulator.  Then rank 0 alone to the episode's end: the rewards
    come with the goals after step 80 (at step 85 agents stand exactly
    at the 2 m goal threshold, where positions an ulp apart decide the
    flag), and the accumulator is the sum of their reward[0, 0]."""
    k, wpr, steps = 2, 2, 30
    jparams = JaxParams()
    jscene = jax_synthetic(num_worlds=k * wpr, num_agents=8, num_roads=16)

    @jax.jit
    def body(scene, s, acts, acc):
        s2 = jstep.step(scene, s, acts, jparams)
        return s2, acc + s2.reward[0, 0]

    js = jax.jit(jstep.reset, static_argnames="params")(jscene, None,
                                                       jparams)
    jacts = jnp.zeros((k * wpr, 128, 10)).at[0, 0, 0].set(1e-6 * (rep + 1))
    jacc = jnp.float32(0)
    ranks = []
    for r in range(k):
        group = WorldGroup(r, k, torch.device("cpu"))
        scene, params = scaling.workload_scene("synthetic", group, wpr, ROOT)
        acts0 = torch.zeros((wpr, scene.max_agents, 10))
        acts = scaling.rep_actions(acts0, rep, r)
        np.testing.assert_array_equal(
            acts.numpy(), np.asarray(jacts)[group.block(k * wpr)])
        ranks.append([scene, params, stepmod.reset(scene, None, params),
                      acts, torch.zeros(())])
    for t in range(steps):
        js, jacc = body(jscene, js, jacts, jacc)
        for rank in ranks:
            scene, params, s, acts, acc = rank
            rank[2], rank[4] = scaling.body(scene, s, acts, acc, params)
        for r, rank in enumerate(ranks):
            blk = WorldGroup(r, k).block(k * wpr)
            jblock = jax.tree_util.tree_map(lambda x: x[blk], js)
            assert_states_match(jblock, rank[2], where=f"rank {r} step {t}")
            np.testing.assert_allclose(np.asarray(jblock.reward),
                                       rank[2].reward.numpy(), rtol=0,
                                       atol=1e-3)
    np.testing.assert_allclose(float(ranks[0][4]), float(jacc), rtol=0,
                               atol=1e-3)
    scene, params, s, acts, acc = ranks[0]
    total = float(acc)
    for _ in range(steps, 91):
        s, acc = scaling.body(scene, s, acts, acc, params)
        total += float(s.reward[0, 0])
    assert float(acc) == total > 0


@pytest.mark.parametrize("max_devices,device,cards,want", [
    (8, "cpu", 0, [1, 2, 4, 8]),      # the JAX default on its 8 host devices
    (2, "cpu", 0, [1, 2]),
    (6, "cuda:0", 1, [1, 2, 4]),      # ranks share the named card
    (8, "gpu", 4, [1, 2, 4]),         # a card per rank: the host's cards
    (4, None, 1, [1]),
])
def test_default_counts(monkeypatch, max_devices, device, cards, want):
    if cards:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert scaling.default_counts(max_devices, device) == want


@pytest.mark.parametrize("counts,device,cards,label", [
    ((1, 2), None, 4, None),                       # a card per rank
    ((1,), None, 1, scaling.ONE_COUNT_LABEL),       # defaults on one card
    ((1, 2), "cuda:0", 4, scaling.SHARED_LABEL),   # ranks share a card
    ((1, 2), "cpu", 0, scaling.SHARED_LABEL),
    ((1,), "cpu", 0, scaling.SHARED_LABEL),
])
def test_summary_is_valid_only_for_a_card_per_rank_at_two_counts(
        monkeypatch, counts, device, cards, label):
    """A run is scaling evidence only where it timed more than one count
    with a card per rank; otherwise the summary says why not."""
    if cards:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(scaling.dist, "run_ranks",
                        lambda target, k, spec, timeout: [0.5] * k)
    result = scaling.measure_scaling(counts, device, 8, 30,
                                     backend="gloo" if device else None)
    assert result["valid"] is (label is None)
    assert result["label"] == label
    out = scaling.summary(result)
    assert out["value"] == 1.0 and out["valid"] is (label is None)
    assert out.get("invalid_reason") == label
    assert out["unit"] == f"SPS({counts[-1]} dev) / ({counts[-1]} x SPS(1))"
