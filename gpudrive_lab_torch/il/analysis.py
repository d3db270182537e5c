"""Closed-loop analyses of a trained BC policy (port of
``gpudrive_lab_tpu/il/analysis.py``; its overlay plots are the visualizer's,
``visualize/core.py``; reference: baselines/il/test/simulation.py:1-253,
importance_weight.py:1-197, intervention.py:1-220).

  * ``closed_loop_rollout``: drive the controlled agents with the BC policy
    and record their episode flags, the goal-reached time against the
    logged expert's, the goal progress, and on request the per-head
    ego->partner attention ("importance"), the fused tokens and the states
    at every step (through the net's ``record`` flag);
  * ``expert_done_steps``: the step at which each logged expert first
    reaches its goal;
  * ``extract_token_dataset`` / ``train_position_probes``: linear probes of
    the future ego and partner grid cells on the frozen ego and partner
    tokens, on the reference's 8 x 8 grid over +-100 m;
  * ``intervention_effect``: add the partner probe's weight column for a
    target cell to the ego tokens and read how the ego probe's prediction
    moves.

Everything stays on the env's or the dataset's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.il.linear_probing import LinearProbe, ProbeConfig
from gpudrive_lab_torch.il.networks import BCConfig, gmm_sample
from gpudrive_lab_torch.il.train import stacked_inputs

# GRID_CELL_COUNT=9 corner lines over 0.1 * [MIN_REL_AGENT_POS,
# MAX_REL_AGENT_POS] = +-100 m: 8 x 8 = 64 cells (reference:
# visualize/core.py:1773, env/constants.py:35)
GRID_CORNER_LINES = 9
GRID_EXTENT = 0.1 * C.MAX_REL_AGENT_POS


def grid_cells() -> int:
    side = GRID_CORNER_LINES - 1
    return side * side


def position_to_cell(rel_xy: torch.Tensor) -> torch.Tensor:
    """Ego-frame displacement [..., 2] -> its cell on the 8 x 8 grid,
    positions outside clamped to the border cells."""
    side = GRID_CORNER_LINES - 1
    res = 2 * GRID_EXTENT / side
    col = torch.clamp(((rel_xy[..., 0] + GRID_EXTENT) / res).long(), 0,
                      side - 1)
    row = torch.clamp(((rel_xy[..., 1] + GRID_EXTENT) / res).long(), 0,
                      side - 1)
    return row * side + col


def cell_centers_ego_frame() -> np.ndarray:
    """[cells, 2] ego-frame xy of each cell's center."""
    corners = np.linspace(-GRID_EXTENT, GRID_EXTENT, GRID_CORNER_LINES)
    cx = (corners[:-1] + corners[1:]) / 2
    gx, gy = np.meshgrid(cx, cx)  # row-major: index = row * side + col
    return np.stack([gx.ravel(), gy.ravel()], axis=-1)


def partner_slot_map(A: int) -> np.ndarray:
    """[A, A-1] the agent behind partner slot k of agent a (the
    all-but-self wiring of the partner observation)."""
    k = np.arange(A - 1)
    return k[None, :] + (k[None, :] >= np.arange(A)[:, None])


def expert_done_steps(scene, goal_threshold: float = 2.0) -> torch.Tensor:
    """[W, A] the first logged step within ``goal_threshold`` of the goal,
    else the last valid logged step, at least 1 (the reference reads the
    same 'done_step' from its expert_*_data_v2.csv)."""
    ag = scene.agents
    traj = ag.traj_pos  # [W, A, T, 2]
    valid = ag.traj_valid > 0
    goal = ag.goal[..., None, :2]
    at_goal = (torch.linalg.norm(traj[..., :2] - goal, dim=-1)
               < goal_threshold) & valid
    T = traj.shape[2]
    first = torch.where(at_goal.any(-1), at_goal.int().argmax(-1), -1)
    last_valid = torch.where(valid.any(-1),
                             T - 1 - valid.flip(-1).int().argmax(-1), T - 1)
    return torch.clamp(torch.where(first >= 0, first, last_valid), min=1)


@dataclasses.dataclass
class ClosedLoopResult:
    metrics: Dict[str, float]
    # episode flags of the controlled agents [W, A]
    goal_achieved: torch.Tensor
    collided: torch.Tensor
    off_road: torch.Tensor
    # [T, W, H, A-1] ego->partner attention per head
    importance: Optional[torch.Tensor] = None
    # [T, W, A, D] fused ego tokens; [T, W, A, A-1, D] partner tokens
    ego_tokens: Optional[torch.Tensor] = None
    ro_tokens: Optional[torch.Tensor] = None
    # world-frame positions [T, W, A, 2] and yaw [T, W, A]
    positions: Optional[torch.Tensor] = None
    yaws: Optional[torch.Tensor] = None


@torch.no_grad()
def closed_loop_rollout(env, model, bc_config: BCConfig,
                        max_steps: int = C.EPISODE_LEN,
                        deterministic: bool = True,
                        collect_importance: bool = False,
                        collect_tokens: bool = False,
                        collect_states: bool = False,
                        generator: torch.Generator | None = None
                        ) -> ClosedLoopResult:
    """Drive every controlled agent with the BC policy (the mixture's
    heaviest mean, or a draw from ``generator`` when not
    ``deterministic``); uncontrolled agents get zero actions (reference:
    simulation.py:49-108).  Returns the episode metrics and the requested
    per-step tensors, on the env's device."""
    if generator is None and not deterministic:
        generator = torch.Generator(device=env.device).manual_seed(0)
    obs = env.reset()
    ns = bc_config.num_stack
    W, A = env.num_worlds, env.max_agent_count
    record = collect_importance or collect_tokens
    ctrl = env.cont_agent_mask
    n_ctrl = max(int(ctrl.sum()), 1)
    goal = env.scene.agents.goal[..., :2]
    init_goal_dist = torch.clamp(
        torch.linalg.norm(goal - env.state.pos, dim=-1), min=1e-3)
    expert_done = expert_done_steps(env.scene,
                                    env.params.dist_to_goal_threshold)
    goal_ep = torch.zeros_like(ctrl)
    col_ep = torch.zeros_like(ctrl)
    off_ep = torch.zeros_like(ctrl)
    goal_step = torch.full((W, A), -1.0, device=env.device)
    last_dist = init_goal_dist.clone()
    ego_rows = torch.argmax(ctrl.int(), dim=1)  # each world's first ego
    frames = [obs] * ns
    importance, ego_toks, ro_toks, poss, yaws = [], [], [], [], []
    for t in range(max_steps):
        out = model(*stacked_inputs(env, frames, ns), record=record)
        means, variances, weights = out[1]
        act = gmm_sample(generator, means, variances, weights,
                         deterministic).reshape(W, A, 3)
        act = torch.where(ctrl[..., None], act, 0.0)
        if collect_importance:
            attn = out[2]["attn"]["ego_ro_cross.attn"][:, :, 0, :]
            attn = attn.reshape(W, A, attn.shape[1], -1)
            importance.append(attn[torch.arange(W, device=env.device),
                                   ego_rows])
        if collect_tokens:
            ego_toks.append(out[2]["ego_token"].reshape(W, A, -1))
            ro = out[2]["ro_tokens"]
            ro_toks.append(ro.reshape(W, A, ro.shape[1], -1))
        if collect_states:
            poss.append(env.state.pos.clone())
            yaws.append(env.state.yaw.clone())
        env.step_dynamics(act)
        frames = frames[1:] + [env.get_obs()]
        infos = env.get_infos()
        goal_now = infos["goal_achieved"] > 0
        newly = goal_now & ~goal_ep & ctrl
        goal_step = torch.where(
            newly, (t / expert_done.double()).float(), goal_step)
        goal_ep |= goal_now
        col_ep |= infos["collided"] > 0
        off_ep |= infos["off_road"] > 0
        live = ~(goal_ep | col_ep | off_ep)
        last_dist = torch.where(
            live, torch.linalg.norm(goal - env.state.pos, dim=-1),
            last_dist)
        if bool(env.get_dones().all()):
            break

    progress = 1.0 - torch.clamp(last_dist / init_goal_dist, 0.0, 1.0)
    progress = torch.where(goal_ep, 1.0, progress)
    gt = goal_step[ctrl & goal_ep]
    metrics = {
        "goal_rate": float((goal_ep & ctrl).sum()) / n_ctrl,
        "collision_rate": float((col_ep & ctrl).sum()) / n_ctrl,
        "off_road_rate": float((off_ep & ctrl).sum()) / n_ctrl,
        "goal_progress": float(progress[ctrl].mean()),
        # rollout goal step over the expert's, among agents that made it
        # (reference: simulation.py:110-140 'Goal Reached Time')
        "goal_time_ratio": float(gt.mean()) if gt.numel() else -1.0,
    }

    def stack(xs):
        return torch.stack(xs) if xs else None

    return ClosedLoopResult(
        metrics=metrics, goal_achieved=goal_ep & ctrl,
        collided=col_ep & ctrl, off_road=off_ep & ctrl,
        importance=stack(importance), ego_tokens=stack(ego_toks),
        ro_tokens=stack(ro_toks), positions=stack(poss), yaws=stack(yaws))


@torch.no_grad()
def extract_token_dataset(model, dataset, batch_size: int = 256
                          ) -> Dict[str, torch.Tensor]:
    """The fused ego [N, D] and partner [N, A-1, D] tokens of every sample
    of an ExpertDataset through the frozen net (the analogue of the
    reference's forward hooks, intervention.py:45-63)."""
    ego, ro = [], []
    ids = np.arange(len(dataset))
    for i in range(0, len(ids), batch_size):
        b = dataset.batch(ids[i:i + batch_size])
        rec = model(b["obs"], b["partner_mask"], b["road_mask"],
                    record=True)[2]
        ego.append(rec["ego_token"])
        ro.append(rec["ro_tokens"])
    return {"ego": torch.cat(ego), "ro": torch.cat(ro)}


def _rotate_into_ego(rel_world, yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = rel_world[..., 0] * c + rel_world[..., 1] * s
    y = -rel_world[..., 0] * s + rel_world[..., 1] * c
    return torch.stack([x, y], dim=-1)


def probe_labels_from_positions(dataset, future_step: int
                                ) -> Dict[str, torch.Tensor]:
    """Grid-cell labels of the ego and partner position probes, from the
    data's 'positions' [T, W, A, 2] and 'yaw' [T, W, A]: the ego's
    displacement at t + future_step in its frame at t, and each partner
    slot's position at t + future_step in the same frame (the grid the
    reference draws around the ego, visualize/core.py:1762-1805).  The
    partner labels are [N, 127], one per observation slot, also on an
    agent axis bucketed below 128 rows (where the JAX package gives [N,
    A-1])."""
    pos, yaw = dataset.data["positions"], dataset.data["yaw"]
    T, W, A = yaw.shape
    t, w, a = dataset.index_t.unbind(1)
    tf = torch.clamp(t + future_step, 0, T - 1)
    ego_now, ego_yaw = pos[t, w, a], yaw[t, w, a]
    ego_label = position_to_cell(_rotate_into_ego(pos[tf, w, a] - ego_now,
                                                  ego_yaw))
    # the observation's 127 partner slots, whatever the env's agent rows:
    # a slot past the last row is padding (masked out of the partner
    # probe), its label read from the last row
    slots = torch.as_tensor(partner_slot_map(C.MAX_AGENTS),
                            device=pos.device)[a]
    partner_fut = pos[tf[:, None], w[:, None], torch.clamp(slots, max=A - 1)]
    rel = _rotate_into_ego(partner_fut - ego_now[:, None], ego_yaw[:, None])
    return {"ego": ego_label, "partner": position_to_cell(rel)}


def train_position_probes(tokens: Dict[str, torch.Tensor],
                          labels: Dict[str, torch.Tensor],
                          partner_valid: Optional[torch.Tensor] = None,
                          config: Optional[ProbeConfig] = None):
    """Fit the ego-token and partner-token position probes: (ego_probe,
    other_probe, metrics).  Partner samples are flattened over the slots,
    keeping the valid (unmasked) partners."""
    config = config or ProbeConfig()
    rng = np.random.default_rng(0)
    cells = grid_cells()
    dev = tokens["ego"].device
    ego_probe = LinearProbe(tokens["ego"].shape[-1], cells, config,
                            device=dev)
    m_ego = ego_probe.fit(tokens["ego"], labels["ego"], rng)
    ro = tokens["ro"].reshape(-1, tokens["ro"].shape[-1])
    lab = labels["partner"].reshape(-1)
    if partner_valid is not None:
        keep = partner_valid.reshape(-1)
        ro, lab = ro[keep], lab[keep]
    other_probe = LinearProbe(ro.shape[-1], cells, config, device=dev)
    m_other = other_probe.fit(ro, lab, rng)
    return ego_probe, other_probe, {"ego": m_ego, "partner": m_other}


@torch.no_grad()
def intervention_effect(ego_probe: LinearProbe, other_probe: LinearProbe,
                        ego_tokens: torch.Tensor, intervention_label: int
                        ) -> Dict[str, torch.Tensor]:
    """The fork's intervention experiment (intervention.py:152-165): add
    the partner probe's weight column for ``intervention_label`` to the ego
    tokens; the ego probe's cell before and after, [B] each."""
    w_ego, b_ego = ego_probe.params["w"], ego_probe.params["b"]
    direction = other_probe.params["w"][:, intervention_label]
    return {
        "ego_pred": torch.argmax(ego_tokens @ w_ego + b_ego, dim=-1),
        "ego_pred_prime": torch.argmax(
            (ego_tokens + direction) @ w_ego + b_ego, dim=-1),
    }


@torch.no_grad()
def predict_partner_cells(other_probe: LinearProbe,
                          ro_tokens: torch.Tensor) -> torch.Tensor:
    """[..., A-1] the predicted cell of each partner slot."""
    return torch.argmax(ro_tokens @ other_probe.params["w"]
                        + other_probe.params["b"], dim=-1)
