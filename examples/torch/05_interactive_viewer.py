"""Tutorial 5 on the PyTorch port: interactive viewer — drive one agent
with the keyboard.

Counterpart of examples/05_interactive_viewer.py and of the reference's
Madrona viewer app (reference: src/viewer.cpp:16-210: fly camera,
per-agent view, WASD -> setAction).  Matplotlib-based: arrow keys / WASD
steer the chosen agent, space pauses, 'n' switches agents; every key press
advances the simulation one step.  ``--fly`` switches to the Madrona
viewer's free 3-D camera: WASD translates in the look direction's
horizontal plane, r/f climb/descend, i/k/j/l look, 'p' advances the sim one
replay-log step (core.render.free_camera_render).  Needs a display to
interact (headless runs keep matplotlib's Agg backend and return at once);
``KeyboardController`` and ``FlyCamera`` need no matplotlib.  The
simulation runs on the GPU; ``--device cpu`` runs it on the CPU.
"""

import argparse
import os

import numpy as np
import torch

from gpudrive_lab_torch.core.render import CameraConfig, free_camera_render
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class KeyboardController:
    """Maps key presses to (accel, steer) for one focused agent and builds
    the full action array (experts drive everyone else)."""

    ACCEL = {"w": 2.0, "up": 2.0, "s": -2.0, "down": -2.0}
    STEER = {"a": 0.6, "left": 0.6, "d": -0.6, "right": -0.6}

    def __init__(self, env: GPUDriveTorchEnv, agent_idx: int | None = None):
        self.env = env
        ctrl = env.cont_agent_mask[0].cpu().numpy()
        candidates = np.nonzero(ctrl)[0]
        if not len(candidates):
            raise ValueError("no controllable agents in world 0")
        self.candidates = candidates
        self.agent_idx = int(candidates[0] if agent_idx is None else agent_idx)

    def next_agent(self):
        i = list(self.candidates).index(self.agent_idx)
        self.agent_idx = int(self.candidates[(i + 1) % len(self.candidates)])
        return self.agent_idx

    def actions_for_key(self, key: str) -> torch.Tensor:
        acts = torch.zeros((self.env.num_worlds, self.env.max_agent_count,
                            10), device=self.env.device)
        acts[0, self.agent_idx, 0] = self.ACCEL.get(key, 0.0)
        acts[0, self.agent_idx, 1] = self.STEER.get(key, 0.0)
        return acts

    def step(self, key: str):
        self.env.step_dynamics(self.actions_for_key(key))
        return self.env.state.pos[0, self.agent_idx].cpu().numpy()

    def replay_step(self):
        """Advance one step with EVERY agent following the logged expert
        (the madrona viewer's replay-log playback, viewer.cpp record/replay;
        the focused agent included)."""
        t = min(int(self.env.world_time_steps[0]),
                self.env.episode_len - 1)
        expert_actions = self.env.get_expert_actions()[0]
        self.env.step_dynamics(expert_actions[:, :, t])
        return self.env.state.pos[0, self.agent_idx].cpu().numpy()


class FlyCamera:
    """Free 3-D camera piloted by the keyboard (reference: src/viewer.cpp
    fly-camera controls).  Pure state + key handling; ``view()`` renders the
    current pose through core.render.free_camera_render, so it runs
    without a display."""

    MOVE = 4.0  # meters per key press
    TURN = 0.15  # radians per key press

    def __init__(self, env: GPUDriveTorchEnv, height: int = 160,
                 width: int = 160, world: int = 0):
        self.env = env
        self.world = world
        self.config = CameraConfig(height=height, width=width)
        # start above the scene's first valid agent, looking its way
        valid = np.nonzero(env.scene.agents.valid[world].cpu().numpy())[0]
        a = int(valid[0]) if len(valid) else 0
        pos = env.state.pos[world, a].cpu().numpy()
        self.pos = np.array([pos[0], pos[1], 15.0], np.float32)
        self.yaw = float(env.state.yaw[world, a])
        self.pitch = -0.5

    def handle_key(self, key: str) -> bool:
        """Update the pose; returns True if the key was a camera control."""
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        fwd = np.array([c, s, 0.0]) * self.MOVE
        left = np.array([-s, c, 0.0]) * self.MOVE
        if key == "w":
            self.pos += fwd
        elif key == "s":
            self.pos -= fwd
        elif key == "a":
            self.pos += left
        elif key == "d":
            self.pos -= left
        elif key == "r":
            self.pos[2] += self.MOVE
        elif key == "f":
            self.pos[2] -= self.MOVE
        elif key in ("j", "left"):
            self.yaw += self.TURN
        elif key in ("l", "right"):
            self.yaw -= self.TURN
        elif key in ("i", "up"):
            self.pitch = min(self.pitch + self.TURN, 1.5)
        elif key in ("k", "down"):
            self.pitch = max(self.pitch - self.TURN, -1.5)
        else:
            return False
        return True

    def view(self) -> np.ndarray:
        """[H, W, 4] uint8 frame at the current pose."""
        rgb, _ = free_camera_render(
            self.env.scene, self.env.state, self.pos, self.yaw, self.pitch,
            self.config, world=self.world,
        )
        return rgb.cpu().numpy()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default=os.path.join(
        ROOT, "tests", "data", "tfrecord_synthetic_0.json"))
    p.add_argument("--zoom", type=float, default=50.0)
    p.add_argument("--fly", action="store_true",
                   help="free 3-D fly camera instead of the top-down drive "
                        "view (reference: src/viewer.cpp)")
    p.add_argument("--device", default=None,
                   help="torch device; the GPU unless 'cpu' is named")
    args = p.parse_args()

    env = GPUDriveTorchEnv(
        EnvConfig(num_worlds=1, dynamics_model="classic",
                  collision_behavior="ignore"),
        scene_paths=[args.scene], device=args.device,
    )
    env.reset()
    ctl = KeyboardController(env)

    import matplotlib

    # interactive backend only when a display exists (the WASD window,
    # reference: src/viewer.cpp); headless runs keep Agg
    if os.environ.get("DISPLAY"):
        try:
            matplotlib.use("TkAgg")
        except ImportError:
            pass
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    fly = FlyCamera(env) if args.fly else None

    def redraw():
        ax.clear()
        if fly is not None:
            ax.imshow(fly.view())
            ax.set_title(
                "fly camera — wasd move, r/f up/down, ijkl look, "
                "p: replay-log step, q: quit"
            )
        else:
            ax.imshow(env.render(0, zoom_radius=args.zoom))
            ax.set_title(
                f"agent {ctl.agent_idx} — WASD/arrows drive, n: next agent, "
                "p: replay-log step, q: quit"
            )
        ax.set_axis_off()
        fig.canvas.draw_idle()

    def on_key(event):
        if event.key == "q":
            plt.close(fig)
            return
        if fly is not None:
            if event.key == "p":
                ctl.replay_step()
            else:
                fly.handle_key(event.key or "")
        elif event.key == "n":
            ctl.next_agent()
        elif event.key == "p":
            ctl.replay_step()
        else:
            ctl.step(event.key or "")
        redraw()

    fig.canvas.mpl_connect("key_press_event", on_key)
    redraw()
    plt.show()


if __name__ == "__main__":
    main()
