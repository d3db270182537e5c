"""What "the port does all that the JAX package does" means, pinned on the
source text of both packages (no import of either).

  * Every ``.py`` file of ``gpudrive_lab_tpu/`` has its counterpart at the
    same path under ``gpudrive_lab_torch/``, but for two renames and two
    files that need no port (``MODULE_RENAMES``, ``MODULE_EXEMPT``).
  * Every public top-level name of a JAX module (a function, class or
    assignment not starting with ``_``) is bound at the top level of its
    counterpart (defined or imported), but for the names of
    ``NAME_EXEMPT``, each with its reason: JAX or TPU machinery with no
    meaning under PyTorch, or a feature the port carries under another
    name (the name it has there is given and checked).
  * Every ``.py`` file at the repository's root or under ``scripts/`` that
    imports ``jax`` or the JAX package (the system's entry points outside
    the package) is mapped to its port module in ``ENTRY_POINTS``, which
    binds the script's public names, or exempt with its reason in
    ``ENTRY_EXEMPT``.
  * Every option string that a JAX command line's parser takes (each
    ``add_argument``) is taken by its port's parser, over every
    ``ENTRY_POINTS`` pair, every JAX module that builds a parser with its
    counterpart, and every ``examples/NN_*.py`` with its
    ``examples/torch/`` port, but for the options of ``FLAG_EXEMPT``, each
    with its reason.
"""

import ast
import os

import pytest

from torch_parity import ROOT

JAX_PKG = os.path.join(ROOT, "gpudrive_lab_tpu")
PORT_PKG = os.path.join(ROOT, "gpudrive_lab_torch")

MODULE_RENAMES = {
    "env/env_jax.py": "env/env_torch.py",
    "core/pallas_kernels.py": "core/kernels.py",
}
MODULE_EXEMPT = {
    "utils/packing.py": "packs many arrays into one buffer for the TPU "
                        "remote runtime's per-handle dispatch cost; the "
                        "port's --packed-io is an alias",
    "utils/torch_interop.py": "converts JAX arrays to torch tensors; the "
                              "port's tensors are torch already",
}
# (JAX module, name) -> (the port's name for it or None, reason)
NAME_EXEMPT = {
    ("__init__.py", "enable_compile_cache"): (
        None, "XLA's persistent compilation cache; the port compiles no XLA "
              "program (its CUDA libraries are cached in _build/ by digest)"),
    ("vbd/model_official.py", "TorchGRU"): (
        None, "a flax module reproducing torch's GRU; the port uses nn.GRU"),
    ("vbd/model_official.py", "TorchGRUCell"): (
        None, "a flax cell reproducing torch's GRU cell; the port uses "
              "nn.GRU"),
    ("vbd/convert.py", "convert_state_dict"): (
        None, "maps the torch checkpoint's keys onto a flax tree; the port's "
              "OfficialVBD carries the checkpoint's own names and loads it "
              "with a strict load_state_dict"),
    ("vbd/convert.py", "assert_tree_matches"): (
        "assert_state_dict_matches", "checks a flax tree; the port checks a "
                                     "state dict against a torch module"),
    ("parallel/mesh.py", "make_mesh"): (
        None, "builds a jax.sharding.Mesh; the port's ranks are processes "
              "(WorldGroup)"),
    ("parallel/mesh.py", "replicated"): (
        "replicate", "a NamedSharding that replicates; the port broadcasts "
                     "the tensors from rank 0"),
    ("parallel/mesh.py", "world_sharding"): (
        "shard_worlds", "a NamedSharding over the world axis; the port "
                        "slices each rank's worlds"),
    ("parallel/distributed.py", "global_mesh"): (
        None, "the multi-host jax.sharding.Mesh; the port's group is "
              "torch.distributed's"),
    ("parallel/distributed.py", "host_local_to_global"): (
        "gather_worlds", "assembles a global jax.Array from host shards; the "
                         "port gathers the ranks' worlds"),
    ("env/env_jax.py", "GPUDriveTPUEnv"): (
        "GPUDriveTorchEnv", "the env under the port's name"),
    ("ppo/ppo.py", "PRESHUFFLE_DOT_MIN_ELEMS"): (
        None, "the size above which the TPU learner permutes a minibatch by "
              "a one-hot matmul instead of a gather; torch gathers"),
    ("ppo/ppo.py", "make_ppo_funcs"): (
        "PPO", "builds the jitted (init, train_step) pair; the port's "
               "learner is the PPO class"),
    ("ppo/ppo_rnn.py", "make_rnn_ppo_funcs"): (
        "RnnPPO", "the recurrent learner's jitted pair; the port's is the "
                  "RnnPPO class"),
    ("ppo/train.py", "PackedTrainer"): (
        None, "batches the trainer's arrays into one handle for the TPU "
              "remote runtime (utils/packing.py)"),
    ("core/pallas_kernels.py", "ROAD_TILE"): (
        None, "the Pallas kernel's road tile width; the CUDA kernels tile "
              "by their own constants"),
    ("core/pallas_kernels.py", "agent_road_hits_pallas"): (
        "agent_road_hits_dense", "kernel K2 under the port's name"),
}


# a root or scripts/ file that runs on JAX -> the port module that does its
# work (python -m gpudrive_lab_torch.<module>)
ENTRY_POINTS = {
    "bench.py": "bench.py",
    "bench_scaling.py": "parallel/scaling.py",
    "__graft_entry__.py": "entry.py",
    "scripts/bench_sb3.py": "bench_sb3.py",
    "scripts/eval_checkpoint.py": "utils/eval_checkpoint.py",
    "scripts/make_scene_pool.py": "scene/pool.py",
    "scripts/train_rnn.py": "ppo/train_rnn.py",
}
PROBE_REASON = ("an XLA/HLO diagnostic of the JAX program on the TPU (its "
                "lowering, fusion or dispatch); the port runs no XLA "
                "program and reads its device time with torch.profiler "
                "(scripts/profile_torch_rollout.py)")


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), top)


JAX_MODULES = sorted(_py_files(JAX_PKG))


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read())


def _imports_jax(path) -> bool:
    for n in ast.walk(_tree(path)):
        names = ([a.name for a in n.names] if isinstance(n, ast.Import)
                 else [n.module or ""] if isinstance(n, ast.ImportFrom)
                 else [])
        if any(m.split(".")[0] in ("jax", "gpudrive_lab_tpu") for m in names):
            return True
    return False


def _entry_scripts():
    files = [f for f in os.listdir(ROOT) if f.endswith(".py")]
    files += [os.path.join("scripts", f)
              for f in os.listdir(os.path.join(ROOT, "scripts"))
              if f.endswith(".py")]
    return sorted(f for f in files if _imports_jax(os.path.join(ROOT, f)))


ENTRY_SCRIPTS = _entry_scripts()
ENTRY_EXEMPT = {f: PROBE_REASON for f in ENTRY_SCRIPTS
                if os.path.basename(f).startswith("probe_")}


def _targets(node):
    for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
        for e in ast.walk(t):
            if isinstance(e, ast.Name):
                yield e.id


def public_names(path) -> set:
    """The public names a module defines at its top level."""
    out = set()
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(n))
    return {n for n in out if not n.startswith("_")}


def bound_names(path) -> set:
    """Every name bound at a module's top level, imports and names bound
    under a top-level if or try included."""
    out = set()
    for top in _tree(path).body:
        nested = isinstance(top, (ast.If, ast.Try))
        for n in ast.walk(top) if nested else [top]:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                out.add(n.name)
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                out.update(_targets(n))
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                out.update((a.asname or a.name).split(".")[0]
                           for a in n.names)
    return out


def counterpart(rel: str) -> str:
    return os.path.join(PORT_PKG, MODULE_RENAMES.get(rel, rel))


def test_the_walk_sees_the_whole_package():
    assert len(JAX_MODULES) >= 90
    for rel in list(MODULE_RENAMES) + list(MODULE_EXEMPT):
        assert rel in JAX_MODULES, rel


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_has_a_counterpart_with_its_names(rel):
    if rel in MODULE_EXEMPT:
        assert not os.path.exists(counterpart(rel)), (
            f"{rel} is exempt but the port has it")
        # the port's package docstring says why it needs none
        init = os.path.join(os.path.dirname(counterpart(rel)), "__init__.py")
        with open(init) as f:
            assert os.path.basename(rel) in f.read(), init
        return
    path = counterpart(rel)
    assert os.path.exists(path), f"no counterpart of {rel} in the port"
    have = bound_names(path)
    missing = sorted(n for n in public_names(os.path.join(JAX_PKG, rel))
                     - have if (rel, n) not in NAME_EXEMPT)
    assert not missing, f"{rel}: the port's {path} lacks {missing}"


def test_every_exemption_is_needed_and_says_why():
    """An exempt name is still missing from the port (else the exemption
    would hide nothing), carries a reason, and where it names the port's
    own name for the feature, the counterpart binds that name."""
    for (rel, name), (port_name, reason) in NAME_EXEMPT.items():
        assert len(reason) > 20, (rel, name)
        assert name in public_names(os.path.join(JAX_PKG, rel)), (rel, name)
        have = bound_names(counterpart(rel))
        assert name not in have, f"{rel}: {name} is ported; drop the entry"
        if port_name is not None:
            assert port_name in have, (rel, port_name)
    for rel, reason in MODULE_EXEMPT.items():
        assert len(reason) > 20, rel


def test_the_entry_walk_sees_every_entry_point():
    assert len(ENTRY_SCRIPTS) == len(ENTRY_POINTS) + len(ENTRY_EXEMPT)
    assert len(ENTRY_EXEMPT) >= 19


@pytest.mark.parametrize("script", ENTRY_SCRIPTS)
def test_entry_point_has_a_port_module_with_its_names(script):
    if script in ENTRY_EXEMPT:
        assert len(ENTRY_EXEMPT[script]) > 20 and script not in ENTRY_POINTS
        return
    assert script in ENTRY_POINTS, f"{script} runs on JAX and has no port"
    path = os.path.join(PORT_PKG, ENTRY_POINTS[script])
    assert os.path.exists(path), path
    missing = sorted(public_names(os.path.join(ROOT, script))
                     - bound_names(path))
    assert not missing, f"{script}: the port's {path} lacks {missing}"
    assert "main" in bound_names(path), path


# (JAX file, option string) -> reason the port's parser need not take it
FLAG_EXEMPT: dict = {}


def _cli_pairs():
    """(JAX file, port file) of every command line, paths under ROOT."""
    pairs = [(script, os.path.join("gpudrive_lab_torch", port))
             for script, port in ENTRY_POINTS.items()]
    for rel in JAX_MODULES:
        with open(os.path.join(JAX_PKG, rel)) as f:
            if "add_argument" in f.read():
                pairs.append((os.path.join("gpudrive_lab_tpu", rel),
                              os.path.relpath(counterpart(rel), ROOT)))
    examples = os.path.join(ROOT, "examples")
    pairs += [(os.path.join("examples", f),
               os.path.join("examples", "torch", f))
              for f in sorted(os.listdir(examples))
              if f.endswith(".py") and f[:2].isdigit() and f[2] == "_"]
    return pairs


CLI_PAIRS = _cli_pairs()


def option_strings(path) -> set:
    """The option strings of every ``add_argument`` call in a file."""
    out = set()
    for n in ast.walk(_tree(os.path.join(ROOT, path))):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "add_argument"):
            for a in n.args:
                assert isinstance(a, ast.Constant), (path, ast.dump(a))
                out.add(a.value)
    return out


def test_the_flag_walk_sees_every_command_line():
    """7 entry points, the 7 JAX modules with a parser, 9 examples; and
    the parsers seen hold the trainers' flags."""
    assert len(CLI_PAIRS) == len(set(CLI_PAIRS)) >= 23
    jax_files = [j for j, _ in CLI_PAIRS]
    for f in ("bench_scaling.py", "gpudrive_lab_tpu/ppo/train.py",
              "gpudrive_lab_tpu/il/train.py",
              "examples/09_pretrained_policy.py"):
        assert f in jax_files, f
    assert "--platform" in option_strings("gpudrive_lab_tpu/ppo/train.py")
    for (jax_file, option), reason in FLAG_EXEMPT.items():
        assert len(reason) > 20, (jax_file, option)
        assert option in option_strings(jax_file), (jax_file, option)


@pytest.mark.parametrize("jax_file,port_file", CLI_PAIRS,
                         ids=[j for j, _ in CLI_PAIRS])
def test_port_cli_takes_every_jax_flag(jax_file, port_file):
    assert os.path.exists(os.path.join(ROOT, port_file)), port_file
    missing = sorted(o for o in option_strings(jax_file)
                     - option_strings(port_file)
                     if (jax_file, o) not in FLAG_EXEMPT)
    assert not missing, f"{port_file} lacks {jax_file}'s {missing}"
