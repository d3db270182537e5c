"""Top-level entry points (port of ``__graft_entry__.py``): the flagship
policy's forward step, and the multi-process dry run.

``entry()`` returns ``(fn, example_args)``: ``fn(variables, obs)`` is the
late-fusion driving policy's forward (logits and value) over a world of
agents, with the policy's parameters passed in as a state dict, as the JAX
entry passes its flax variables.  ``dryrun_multichip(n)`` runs the JAX dry
run's three learner configurations sharded over ``n`` processes against
one process (``parallel/dryrun.py``).  Both run on the card unless a
device is named.

    python -m gpudrive_lab_torch.entry --procs 2
    python -m gpudrive_lab_torch.entry --procs 2 --device cpu
"""

from __future__ import annotations

import torch

from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
)


def entry(device=None):
    """Returns (fn, example_args): the forward of
    ``LateFusionPolicy(PolicyConfig(action_dim=91))`` (weights drawn from
    seed 0) as ``fn(variables, obs) -> (logits, value)``, with its state
    dict and a [128, obs_dim] zero batch on ``device`` (CUDA unless
    another is named)."""
    device = resolve_device(device)
    cfg = PolicyConfig(action_dim=91)
    policy = LateFusionPolicy(cfg, device=device,
                              generator=torch.Generator().manual_seed(0))
    policy.eval()
    obs = torch.zeros((128, cfg.obs_dim), dtype=torch.float32, device=device)
    variables = dict(policy.state_dict())

    def fn(variables, obs):
        return torch.func.functional_call(policy, variables, (obs,))

    return fn, (variables, obs)


def dryrun_multichip(n_devices: int, device=None, **kwargs) -> dict:
    """The full PPO training step of the JAX dry run's three
    configurations (dense float32; flat block-local bf16 with a scene
    swap; recurrent flat) over ``n_devices`` world-sharded processes,
    each against the same program in one process
    (``parallel.dryrun.dryrun_multiprocess``, which takes ``kwargs``).
    Returns its report; raises where a configuration misses its bar."""
    from gpudrive_lab_torch.parallel.dryrun import dryrun_multiprocess

    return dryrun_multiprocess(n_devices, device, **kwargs)


def main(argv=None) -> int:
    """The dry run (``parallel.dryrun``'s flags and defaults: 2 ranks,
    NCCL where each has a card of its own, else gloo), then ``entry()``'s
    forward once on the same device."""
    from gpudrive_lab_torch.parallel import dryrun

    args = dryrun.parse_args(argv, __doc__.splitlines()[0])
    dryrun.run(args)
    fn, (variables, obs) = entry(args.device)
    with torch.no_grad():
        out = fn(variables, obs)
    print("entry OK:", [tuple(x.shape) for x in out])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
