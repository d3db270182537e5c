"""``--platform`` across the port's command lines, where the JAX CLIs take
JAX's platform names (``jax.config.update("jax_platforms", ...)``):

  * ``device.platform_device``/``resolve_device`` map ``cpu`` to the CPU,
    ``gpu`` and ``cuda`` to CUDA (which raises the port's own message
    without a card), pass ``cuda:0`` through and refuse ``tpu``;
  * the three trainers' ``parse_args`` take ``--platform cpu``;
  * every port CLI that takes ``--platform`` refuses ``tpu`` with the
    port's message and sends ``gpu`` to CUDA (here, with no card, the port's
    "CUDA is not available", not torch's device-string parse error).
"""

import os
import runpy
import sys

import pytest
import torch

from gpudrive_lab_torch import bench, bench_sb3, entry
from gpudrive_lab_torch.device import platform_device, resolve_device
from gpudrive_lab_torch.il import train as il_train
from gpudrive_lab_torch.parallel import dryrun, scaling
from gpudrive_lab_torch.ppo import train as ppo_train
from gpudrive_lab_torch.ppo import train_rnn
from gpudrive_lab_torch.scene import pool
from gpudrive_lab_torch.utils import eval_checkpoint
from torch_parity import ROOT

TPU_MESSAGE = "the port runs on CUDA"
NO_CUDA = "CUDA is not available"


@pytest.mark.parametrize("name,want", [
    ("cpu", "cpu"), ("gpu", "cuda"), ("cuda", "cuda"), ("cuda:0", "cuda:0"),
    ("tpu", None),
])
def test_platform_names(monkeypatch, name, want):
    if want is None:
        for fn in (platform_device, resolve_device):
            with pytest.raises(ValueError, match=TPU_MESSAGE):
                fn(name)
        return
    assert platform_device(name) == torch.device(want)
    if torch.device(want).type == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match=NO_CUDA):
            resolve_device(name)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(name) == torch.device(want)


@pytest.mark.parametrize("parse", [ppo_train.parse_args,
                                   train_rnn.parse_args, il_train.parse_args],
                         ids=["ppo.train", "ppo.train_rnn", "il.train"])
def test_trainers_take_platform(parse):
    args = parse(["--platform", "cpu"])
    assert args.device == "cpu"
    assert resolve_device(args.device) == torch.device("cpu")
    assert parse(["--device", "cpu"]).device == "cpu"


def _example_09(argv):
    old = sys.argv
    sys.argv = ["09_pretrained_policy.py"] + argv
    try:
        runpy.run_path(os.path.join(ROOT, "examples", "torch",
                                    "09_pretrained_policy.py"),
                       run_name="__main__")
    finally:
        sys.argv = old


# every port command line with --platform, and the flags it needs besides
CLIS = {
    "bench": (bench.main, []),
    "bench_sb3": (bench_sb3.main, []),
    "utils.eval_checkpoint": (eval_checkpoint.main,
                              ["--checkpoint", "absent"]),
    "scene.pool": (pool.main, ["--out", "{tmp}"]),
    "parallel.dryrun": (dryrun.main, []),
    "entry": (entry.main, []),
    "parallel.scaling": (scaling.main, []),
    "ppo.train": (ppo_train.main, ["--checkpoint-path", "{tmp}"]),
    "ppo.train_rnn": (train_rnn.main, ["--checkpoint-path", "{tmp}"]),
    "il.train": (il_train.main, ["--out", "{tmp}/bc.pt"]),
    "examples/torch/09": (_example_09, ["--out", "{tmp}/fig.png"]),
}


@pytest.mark.parametrize("platform", ["tpu", "gpu"])
@pytest.mark.parametrize("cli", list(CLIS))
def test_cli_platform_goes_through_the_mapping(monkeypatch, tmp_path, cli,
                                               platform):
    # a host without a card, wherever the test runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, extra = CLIS[cli]
    argv = ["--platform", platform] + [a.format(tmp=tmp_path) for a in extra]
    err = (ValueError, TPU_MESSAGE) if platform == "tpu" else (RuntimeError,
                                                               NO_CUDA)
    with pytest.raises(err[0], match=err[1]):
        main(argv)
    assert not os.listdir(tmp_path), "the CLI wrote before it refused"
