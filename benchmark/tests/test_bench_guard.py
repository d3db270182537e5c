"""The import guard compares whole top-level module names."""

import subprocess
import sys

from gdbench import guard
from conftest import BENCH_DIR


def test_forbidden_names_are_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "gpudrive_lab_tpu", "gpudrive_lab_tpu.core.step",
            "gpudrive_lab_torch", "gpudrive_lab_torch.core.step",
            "jaxtyping", "flaxen", "gpudrive_lab_tpux", "torch"]
    assert guard.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "gpudrive_lab_tpu", "gpudrive_lab_tpu.core.step"])


def test_harness_and_reference_load_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run, control\n"
            "from gdbench import common, sim, train, control as c, trace\n"
            "from gdbench.reference import compiler, step, ppo, policy\n"
            "import gpudrive_lab_torch.bench, gpudrive_lab_torch.ppo.train\n"
            "from gdbench import guard\n"
            "print(guard.forbidden_modules(sys.modules))\n"
            % (str(BENCH_DIR), str(BENCH_DIR.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "sim_pool512", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
