"""Rollout video rendering (port of ``gpudrive_lab_tpu/visualize/video.py``).

The reference's wandb video pipeline (reference:
gpudrive/env/env_puffer.py:405-483): render selected worlds every frame of
a rollout and encode them as GIF or MP4 with matplotlib's writers.  A
``.mp4`` target that ffmpeg cannot write is written as ``.gif`` beside it.
"""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch


def render_rollout(
    env,
    policy_fn: Optional[Callable] = None,
    env_idx: int = 0,
    max_steps: int = 91,
    zoom_radius: float = 80.0,
    generator: Optional[torch.Generator] = None,
) -> List[np.ndarray]:
    """Reset ``env``, roll it out and collect one world's frames (the reset
    state, then one frame a step, up to the step where every agent is
    done).  Actions are ``policy_fn(obs)`` -> [W, A] indices, or uniform
    random ones drawn from ``generator`` (a generator on the env's device;
    one seeded with 0 when None)."""
    obs = env.reset()
    frames = [env.render(env_idx, zoom_radius=zoom_radius)]
    if policy_fn is None and generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    for _ in range(max_steps):
        if policy_fn is None:
            acts = torch.randint(
                0, env.action_space_n, (env.num_worlds, env.max_agent_count),
                generator=generator, device=env.device)
        else:
            acts = policy_fn(obs)
        env.step_dynamics(acts)
        obs = env.get_obs()
        frames.append(env.render(env_idx, zoom_radius=zoom_radius))
        if bool(env.get_dones().all()):
            break
    return frames


def save_video(frames: List[np.ndarray], path: str, fps: int = 15) -> str:
    """Encode frames; .gif through Pillow, .mp4 through ffmpeg when it can
    write it and as .gif otherwise (reference render_format options
    gif/mp4).  Returns the path written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    path = str(path)
    fig = plt.figure(
        figsize=(frames[0].shape[1] / 100, frames[0].shape[0] / 100), dpi=100
    )
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_axis_off()
    im = ax.imshow(frames[0])

    def update(i):
        im.set_data(frames[i])
        return (im,)

    anim = animation.FuncAnimation(
        fig, update, frames=len(frames), interval=1000 / fps
    )
    try:
        if path.endswith(".mp4"):
            try:
                anim.save(path, writer=animation.FFMpegWriter(fps=fps))
            except (OSError, subprocess.SubprocessError):
                # no ffmpeg (or it failed): the frames as a GIF instead
                path = path[:-4] + ".gif"
                anim.save(path, writer=animation.PillowWriter(fps=fps))
        else:
            anim.save(path, writer=animation.PillowWriter(fps=fps))
    finally:
        plt.close(fig)
    return path


def render_training_videos(
    env,
    policy: torch.nn.Module,
    out_dir,
    global_step: int,
    num_worlds: int = 1,
    fmt: str = "gif",
    max_steps: int = 91,
) -> List[str]:
    """Rollout videos with the current policy, the training-telemetry hook
    (reference: gpudrive/env/env_puffer.py:405-483 renders rollouts into
    wandb during training).

    Rolls the env's own state (not a trainer's carry) with argmax actions
    of ``policy`` under ``torch.no_grad()`` and writes one video per world
    to ``out_dir/world{i}_step{global_step}.{fmt}``; the env is left
    freshly reset.  Returns the written paths."""
    def policy_fn(obs):
        with torch.no_grad():
            logits, _ = policy(obs)
        return logits.argmax(dim=-1)

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for w in range(min(num_worlds, env.num_worlds)):
        frames = render_rollout(env, policy_fn, env_idx=w,
                                max_steps=max_steps)
        paths.append(
            save_video(frames, str(out / f"world{w}_step{global_step}.{fmt}"))
        )
    # leave the env freshly reset so later callers see a clean state
    env.reset()
    return paths
