"""The port's package boundary: it never imports JAX or the JAX package, and
its entry points run on CUDA unless told otherwise, raising without it."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from torch_parity import POOL_SCENES, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gpudrive_lab_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import gpudrive_lab_torch
mods = [m.name for m in pkgutil.walk_packages(
    gpudrive_lab_torch.__path__, "gpudrive_lab_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in {forbidden!r})
print(len(mods), bad)
assert not bad, bad
"""


def test_importing_every_module_loads_no_jax():
    code = _IMPORT_ALL.format(forbidden=set(FORBIDDEN))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 109  # every module was imported


def test_walk_covers_the_dataset_slice():
    """The modules of the dataset-driven path are among those imported."""
    import pkgutil

    import gpudrive_lab_torch

    mods = {m.name for m in pkgutil.walk_packages(
        gpudrive_lab_torch.__path__, "gpudrive_lab_torch.")}
    for name in ("env.dataset", "env.env_vec", "scene.prefetch",
                 "agents.core", "agents.sim_agent", "agents.random_actor",
                 "agents.policy_actor", "utils.evaluation",
                 "utils.multi_policy_rollout", "env.wrappers.sb3_wrapper",
                 "env.wrappers.sb3_learner", "env.wrappers.marl_wrapper"):
        assert "gpudrive_lab_torch." + name in mods, name


def test_walk_covers_the_rnn_and_il_slice():
    """The modules of the recurrent PPO and behavior-cloning paths are
    among those imported."""
    import pkgutil

    import gpudrive_lab_torch

    mods = {m.name for m in pkgutil.walk_packages(
        gpudrive_lab_torch.__path__, "gpudrive_lab_torch.")}
    for name in ("ppo.ppo_rnn", "ppo.train_rnn", "il.networks", "il.dataset",
                 "il.data_generation", "il.train", "il.linear_probing",
                 "il.analysis"):
        assert "gpudrive_lab_torch." + name in mods, name


def test_walk_covers_the_vbd_slice():
    """The VBD modules are among those imported."""
    import pkgutil

    import gpudrive_lab_torch

    mods = {m.name for m in pkgutil.walk_packages(
        gpudrive_lab_torch.__path__, "gpudrive_lab_torch.")}
    for name in ("model", "model_official", "data_utils", "convert",
                 "integration", "guidance_metrics", "ilq", "guidance"):
        assert "gpudrive_lab_torch.vbd." + name in mods, name


def test_walk_covers_the_compute_dtype_helpers():
    """flax's compute-dtype semantics, shared by the late-fusion policy and
    the VBD model, are among the modules imported."""
    import pkgutil

    import gpudrive_lab_torch

    mods = {m.name for m in pkgutil.walk_packages(
        gpudrive_lab_torch.__path__, "gpudrive_lab_torch.")}
    assert "gpudrive_lab_torch.networks.flax_dtype" in mods


def test_walk_covers_the_periphery_slice():
    """The visualizer, the checkpoint and training utilities and the small
    leftovers are among the modules imported."""
    import pkgutil

    import gpudrive_lab_torch

    mods = {m.name for m in pkgutil.walk_packages(
        gpudrive_lab_torch.__path__, "gpudrive_lab_torch.")}
    for name in ("visualize", "visualize.color", "visualize.utils",
                 "visualize.core", "visualize.video", "utils.checkpoint",
                 "utils.config", "utils.dashboard", "utils.generate_sweep",
                 "scene.synthetic", "networks.basic_ffn",
                 "networks.perm_eq_late_fusion"):
        assert "gpudrive_lab_torch." + name in mods, name


def test_walk_covers_the_collision_and_parallel_slice():
    """The grid and the world-parallel modules are among those imported,
    and importing them starts no process group."""
    import pkgutil

    import gpudrive_lab_torch

    mods = {m.name for m in pkgutil.walk_packages(
        gpudrive_lab_torch.__path__, "gpudrive_lab_torch.")}
    for name in ("scene.grid", "parallel", "parallel.mesh",
                 "parallel.distributed", "parallel.dryrun",
                 "parallel.scaling"):
        assert "gpudrive_lab_torch." + name in mods, name
    code = ("import torch.distributed as d\n"
            "import gpudrive_lab_torch.parallel.dryrun\n"
            "import gpudrive_lab_torch.parallel.scaling\n"
            "print(d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split() == ["False"], (
        out.stdout + out.stderr)


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_names_jax():
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "chip_phases.py"),
             os.path.join(ROOT, "scripts", "cpu_gemm_precision.py")]
    for top in ("gpudrive_lab_torch", os.path.join("examples", "torch")):
        for d, _, files in os.walk(os.path.join(ROOT, top)):
            paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert sum("examples" in p for p in paths) == 9
    for p in paths:
        bad = set(_imported_roots(p)) & set(FORBIDDEN)
        assert not bad, (p, bad)


def test_walk_covers_the_ingest_slice():
    """The native scene compiler and the WOMD data utilities are among the
    modules imported."""
    import pkgutil

    import gpudrive_lab_torch

    mods = {m.name for m in pkgutil.walk_packages(
        gpudrive_lab_torch.__path__, "gpudrive_lab_torch.")}
    for name in ("native", "data_utils.tfrecord", "data_utils.waymo_converter",
                 "data_utils.process_waymo_files",
                 "data_utils.post_processing", "data_utils.detect_behavior",
                 "data_utils.download", "data_utils.synthetic_womd",
                 "data_utils.waymo_protos.scenario_lite_pb2"):
        assert "gpudrive_lab_torch." + name in mods, name


def test_walk_covers_the_entry_points():
    """The ports of the entry points outside the JAX package (bench.py,
    __graft_entry__.py, the scripts) are among the modules imported."""
    import pkgutil

    import gpudrive_lab_torch

    mods = {m.name for m in pkgutil.walk_packages(
        gpudrive_lab_torch.__path__, "gpudrive_lab_torch.")}
    for name in ("bench", "bench_sb3", "entry", "scene.pool",
                 "utils.eval_checkpoint"):
        assert "gpudrive_lab_torch." + name in mods, name


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a device argument every entry point asks for CUDA; with no
    CUDA present it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from gpudrive_lab_torch.core.types import Params
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.networks.late_fusion import LateFusionPolicy
    from gpudrive_lab_torch.scene.compiler import build_scene

    with pytest.raises(RuntimeError, match="CUDA"):
        build_scene(POOL_SCENES[:1], Params())
    with pytest.raises(RuntimeError, match="CUDA"):
        GPUDriveTorchEnv(EnvConfig(), POOL_SCENES[:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        LateFusionPolicy()
    from gpudrive_lab_torch.vbd.model import VBDConfig, VBDModel

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        with pytest.raises(RuntimeError, match="CUDA"):
            VBDModel(VBDConfig(hidden_dim=16, num_heads=2, dtype=dtype))
    from gpudrive_lab_torch import bench, bench_sb3, entry
    from gpudrive_lab_torch.scene import pool
    from gpudrive_lab_torch.utils import eval_checkpoint

    for main, argv in ((bench.main, []), (bench.main, ["--train"]),
                       (bench_sb3.main, []),
                       (eval_checkpoint.main, ["--checkpoint", "policy.pt"]),
                       (pool.main, ["--out", str(tmp_path), "--num", "1"]),
                       (entry.main, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert not any(tmp_path.iterdir())  # the pool raised before writing
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pool.validate_pool(POOL_SCENES[:1])
    # and the CPU is used only when asked for
    scene = build_scene(POOL_SCENES[:1], Params(), device="cpu")
    assert scene.device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without CUDA,
    and also when it stands alone in a directory."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    src = os.path.join(ROOT, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(src).read())
    for path in (src, str(alone)):
        out = subprocess.run([sys.executable, path], cwd=os.path.dirname(path),
                             capture_output=True, text=True, timeout=120,
                             env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
