"""Tutorial 9 on the PyTorch port: evaluate a released reference policy.

Counterpart of examples/09_pretrained_policy.py and of the reference's
pretrained-policy workflow (reference: README.md:207-231
``NeuralNet.from_pretrained(...)`` and
examples/experimental/eval_utils.py:15,56): load a torch ``NeuralNet``
checkpoint (hub id, local dir, or file) into the port's
``LateFusionPolicy`` with ``networks.convert.load_pretrained``, roll it
closed-loop, and render a frame (with matplotlib).

    PYTHONPATH=. python examples/torch/09_pretrained_policy.py --checkpoint model.safetensors
    PYTHONPATH=. python examples/torch/09_pretrained_policy.py \
        --checkpoint daphne-cornelisse/policy_S10_000_02_27  # needs network

Without --checkpoint it writes a random NeuralNet-layout checkpoint (the
JAX example's seeded weights) so the loader and the rollout still run
offline.  Runs on the GPU; ``--device cpu`` (or ``--platform cpu``, the
JAX example's flag) runs it on the CPU.
"""

import argparse
import importlib.util
import os
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synth_checkpoint() -> str:
    """A random state_dict in the torch NeuralNet layout (for the offline
    demo), in a new temporary directory as model.safetensors.
    reference: gpudrive/networks/late_fusion.py:117-167 module names."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    sd = {}

    def lin(o, i, name):
        sd[f"{name}.weight"] = rng.normal(0, 0.05, (o, i)).astype(np.float32)
        sd[f"{name}.bias"] = np.zeros(o, np.float32)

    for name, ind in (
        ("ego_embed", 6), ("partner_embed", 6), ("road_map_embed", 13)
    ):
        lin(64, ind, f"{name}.0")
        sd[f"{name}.1.weight"] = np.ones(64, np.float32)
        sd[f"{name}.1.bias"] = np.zeros(64, np.float32)
        lin(64, 64, f"{name}.4")
    lin(128, 192, "shared_embed.0")
    lin(91, 128, "actor")
    lin(1, 128, "critic")
    d = tempfile.mkdtemp()
    save_file(sd, os.path.join(d, "model.safetensors"))
    return d


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None,
                   help="hub repo id, dir with model.safetensors, or file; "
                        "default writes random weights (offline demo)")
    p.add_argument("--scenes-dir",
                   default=os.path.join(ROOT, "data", "pool_v3"))
    p.add_argument("--num-worlds", type=int, default=2)
    p.add_argument("--steps", type=int, default=91)
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "pretrained_rollout.png"))
    p.add_argument("--device", "--platform", dest="device", default=None,
                   help="torch device; the GPU unless 'cpu' is named")
    args = p.parse_args()

    from gpudrive_lab_torch.agents import PolicyActor
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.networks.convert import load_pretrained
    from gpudrive_lab_torch.utils.multi_policy_rollout import (
        multi_policy_rollout,
    )

    ckpt = args.checkpoint or synth_checkpoint()
    policy, pc = load_pretrained(ckpt, device=args.device)
    print(f"loaded {ckpt}: action_dim={pc.action_dim}, "
          f"hidden={pc.hidden_dim}")

    paths = sorted(
        os.path.join(args.scenes_dir, f)
        for f in os.listdir(args.scenes_dir)
        if f.endswith(".json")
    )[: args.num_worlds]
    env = GPUDriveTorchEnv(
        EnvConfig(num_worlds=len(paths), init_steps=11), scene_paths=paths,
        device=args.device,
    )
    actor = PolicyActor(
        None, variables=policy.state_dict(), policy_config=pc,
        deterministic=True, device=env.device,
    )
    metrics = multi_policy_rollout(
        env, {"pretrained": actor}, {"pretrained": env.cont_agent_mask},
        max_steps=args.steps,
    )["pretrained"]
    print({k: round(float(v), 3) for k, v in metrics.items()})

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib absent: no frame drawn")
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(args.out, env.render(0, zoom_radius=80))
    print(f"frame written to {args.out}")


if __name__ == "__main__":
    main()
