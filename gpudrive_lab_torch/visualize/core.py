"""Matplotlib scene visualizer (port of ``gpudrive_lab_tpu/visualize/core.py``;
reference: gpudrive/visualize/core.py:105-1872).

Multi-world figures of the road graph, oriented agent boxes colored by state
or policy, goals and optional expert-trajectory overlays, the 3-D
perspective view, the egocentric per-agent view (``plot_agent_observation``)
and the IL overlays (attention importance, linear-probe grid, log-replay
comparison).

Scene and state arrive as tensors on any device.  ``update_scene`` copies
the scene's roads and agents to the host once per scene; each plot call
copies the state rows of the worlds it draws in one device-to-host copy.
Everything after that is the JAX visualizer's numpy and matplotlib code, so
the same values give the same pixels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.types import Scene, SimState
from gpudrive_lab_torch.visualize.color import (
    AGENT_COLOR_BY_STATE,
    POLICY_COLORS,
    ROAD_GRAPH_COLORS,
)
from gpudrive_lab_torch.visualize.utils import (
    img_from_fig,
    plot_bounding_box,
    plot_crosswalk,
    plot_speed_bump,
    plot_stop_sign,
)


def _host(x, rows=None) -> np.ndarray:
    """A tensor (any device) or array as numpy, only ``rows`` of its first
    axis when given (selected on the device before the copy)."""
    if isinstance(x, torch.Tensor):
        if rows is not None:
            x = x[list(rows)]
        return x.detach().cpu().numpy()
    x = np.asarray(x)
    return x if rows is None else x[list(rows)]


def state_rows(state: SimState, worlds: Sequence[int]) -> dict:
    """The drawn state fields of ``worlds`` on the host, in one
    device-to-host copy: pos [n, A, 2] and yaw [n, A] float32, collided and
    reached_goal [n, A] (0/1, exact in float32)."""
    packed = torch.cat([state.pos, state.yaw[..., None],
                        state.collided[..., None].float(),
                        state.reached_goal[..., None].float()], dim=-1)
    h = _host(packed, worlds)
    return {"pos": np.ascontiguousarray(h[..., :2]),
            "yaw": np.ascontiguousarray(h[..., 2]),
            "collided": h[..., 3], "reached_goal": h[..., 4]}


class MatplotlibVisualizer:
    def __init__(self, scene: Scene, vis_config=None):
        self.update_scene(scene)
        self.config = vis_config

    def update_scene(self, scene: Scene):
        """Refresh the cached host copies for a new scene
        (reference: env_torch.py:1372-1384)."""
        self.scene = scene
        r, a = scene.roads, scene.agents
        self._roads = {k: _host(getattr(r, k))
                       for k in ("pos", "yaw", "scale", "etype", "valid")}
        self._agents = {k: _host(getattr(a, k))
                        for k in ("valid", "size", "goal", "static",
                                  "controlled", "traj_pos", "traj_valid")}

    def _plot_roads(self, ax, w: int):
        r = self._roads
        valid = r["valid"][w]
        pos = r["pos"][w][valid]
        yaw = r["yaw"][w][valid]
        scale = r["scale"][w][valid]
        etype = r["etype"][w][valid]
        for t in np.unique(etype):
            m = etype == t
            color = ROAD_GRAPH_COLORS.get(int(t), "#cccccc")
            if t in (C.ET_ROAD_EDGE, C.ET_ROAD_LINE, C.ET_ROAD_LANE):
                # segments: a line from the midpoint -+ the half-length
                dx = scale[m, 0] * np.cos(yaw[m])
                dy = scale[m, 0] * np.sin(yaw[m])
                x0, y0 = pos[m, 0] - dx, pos[m, 1] - dy
                x1, y1 = pos[m, 0] + dx, pos[m, 1] + dy
                lw = 1.0 if t == C.ET_ROAD_EDGE else 0.4
                segs = np.stack(
                    [np.stack([x0, y0], -1), np.stack([x1, y1], -1)], axis=1
                )
                from matplotlib.collections import LineCollection

                ax.add_collection(
                    LineCollection(segs, colors=color, linewidths=lw, zorder=1)
                )
            elif t == C.ET_STOP_SIGN:
                for k in np.nonzero(m)[0]:
                    plot_stop_sign(ax, pos[k, 0], pos[k, 1])
            elif t == C.ET_CROSSWALK:
                for k in np.nonzero(m)[0]:
                    plot_crosswalk(
                        ax, pos[k, 0], pos[k, 1], yaw[k],
                        2 * scale[k, 0], 2 * scale[k, 1],
                    )
            elif t == C.ET_SPEED_BUMP:
                for k in np.nonzero(m)[0]:
                    plot_speed_bump(
                        ax, pos[k, 0], pos[k, 1], yaw[k],
                        2 * scale[k, 0], 2 * scale[k, 1],
                    )
            else:
                for k in np.nonzero(m)[0]:
                    plot_bounding_box(
                        ax, pos[k, 0], pos[k, 1], yaw[k],
                        2 * scale[k, 0], 2 * scale[k, 1], color,
                        alpha=0.35, zorder=1,
                    )

    def _plot_roads_3d(self, ax, w: int):
        """Road graph as ground-plane 3-D line segments
        (reference: visualize/core.py:371-406 Line3DCollection)."""
        from mpl_toolkits.mplot3d.art3d import Line3DCollection

        r = self._roads
        valid = r["valid"][w]
        pos = r["pos"][w][valid]
        yaw = r["yaw"][w][valid]
        scale = r["scale"][w][valid]
        etype = r["etype"][w][valid]
        for t in np.unique(etype):
            if t not in (C.ET_ROAD_EDGE, C.ET_ROAD_LINE, C.ET_ROAD_LANE):
                continue
            m = etype == t
            dx = scale[m, 0] * np.cos(yaw[m])
            dy = scale[m, 0] * np.sin(yaw[m])
            z = np.zeros(m.sum())
            segs = np.stack(
                [
                    np.stack([pos[m, 0] - dx, pos[m, 1] - dy, z], -1),
                    np.stack([pos[m, 0] + dx, pos[m, 1] + dy, z], -1),
                ],
                axis=1,
            )
            color = ROAD_GRAPH_COLORS.get(int(t), "#cccccc")
            lw = 1.0 if t == C.ET_ROAD_EDGE else 0.4
            ax.add_collection3d(
                Line3DCollection(segs, colors=color, linewidths=lw)
            )

    @staticmethod
    def _agent_box_3d(ax, x, y, yaw, length, width, height, color):
        """One oriented 3-D vehicle box (Poly3DCollection of 6 faces;
        reference render_3d agent drawing)."""
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        c, s = np.cos(yaw), np.sin(yaw)
        hx, hy = length / 2, width / 2
        corners = np.array(
            [[hx, hy], [hx, -hy], [-hx, -hy], [-hx, hy]]
        ) @ np.array([[c, s], [-s, c]])
        corners += (x, y)
        lo = [(cx, cy, 0.0) for cx, cy in corners]
        hi = [(cx, cy, height) for cx, cy in corners]
        faces = [lo, hi] + [
            [lo[i], lo[(i + 1) % 4], hi[(i + 1) % 4], hi[i]]
            for i in range(4)
        ]
        ax.add_collection3d(
            Poly3DCollection(
                faces, facecolors=color, edgecolors="black",
                linewidths=0.3, alpha=0.9,
            )
        )

    def _agent_color(self, w: int, i: int, rows: Optional[dict] = None,
                     j: int = 0, masks=None):
        """Agent i of world w: its policy's color when a mask in ``masks``
        (host rows [n, A] each) holds it, else by its state in ``rows``
        (``state_rows``, world w at row j) and its static flags."""
        if masks is not None:
            for p, mask in enumerate(masks):
                if mask[j, i]:
                    return POLICY_COLORS[p % len(POLICY_COLORS)]
        if rows is not None:
            if rows["collided"][j, i]:
                return AGENT_COLOR_BY_STATE["collided"]
            if rows["reached_goal"][j, i]:
                return AGENT_COLOR_BY_STATE["goal_achieved"]
        if self._agents["static"][w, i]:
            return AGENT_COLOR_BY_STATE["static"]
        if not self._agents["controlled"][w, i]:
            return AGENT_COLOR_BY_STATE["expert"]
        return AGENT_COLOR_BY_STATE["ok"]

    def plot_simulator_state(
        self,
        state: SimState,
        env_indices: Sequence[int] = (0,),
        zoom_radius: Optional[float] = None,
        draw_expert_trajectories: bool = False,
        policy_masks=None,
        center_agent_indices: Optional[Sequence[int]] = None,
        return_single_figure: bool = False,
        figsize=(8, 8),
    ):
        """Top-down views of selected worlds; 3-D perspective when the
        vis config sets ``render_3d`` (reference: visualize/core.py:105-1400,
        3-D branch :274-475).  Returns a list of RGB arrays (or matplotlib
        figures when return_single_figure)."""
        render_3d = bool(getattr(self.config, "render_3d", False))
        veh_height = float(getattr(self.config, "vehicle_height", 0.06) or 0.06)
        env_indices = list(env_indices)
        rows = state_rows(state, env_indices)
        masks = (None if policy_masks is None
                 else [_host(m, env_indices) for m in policy_masks])
        outs = []
        for j, w in enumerate(env_indices):
            pos, yaw = rows["pos"][j], rows["yaw"][j]
            if render_3d:
                fig = plt.figure(figsize=figsize)
                ax = fig.add_subplot(projection="3d")
                ax.set_axis_off()
                self._plot_roads_3d(ax, w)
            else:
                fig, ax = plt.subplots(figsize=figsize)
                ax.set_aspect("equal")
                ax.set_axis_off()
                self._plot_roads(ax, w)
            valid = self._agents["valid"][w]
            for i in np.nonzero(valid)[0]:
                x, y = pos[i]
                if x < -10000:  # teleported-away padding position
                    continue
                size = self._agents["size"][w, i]
                color = self._agent_color(w, i, rows, j, masks)
                if render_3d:
                    self._agent_box_3d(
                        ax, x, y, yaw[i],
                        size[0] * C.VEHICLE_LENGTH_SCALE,
                        size[1] * C.VEHICLE_LENGTH_SCALE,
                        max(size[0], 1.0) * veh_height * 30, color,
                    )
                else:
                    plot_bounding_box(
                        ax, x, y, yaw[i],
                        size[0] * C.VEHICLE_LENGTH_SCALE,
                        size[1] * C.VEHICLE_LENGTH_SCALE, color,
                    )
                if self._agents["controlled"][w, i]:
                    g = self._agents["goal"][w, i]
                    if render_3d:
                        ax.scatter(g[0], g[1], 0.0, s=14, marker="*",
                                   color="#1a9641")
                    else:
                        ax.scatter(g[0], g[1], s=14, marker="*",
                                   color="#1a9641", zorder=2)
                if draw_expert_trajectories:
                    tv = self._agents["traj_valid"][w, i] > 0
                    tp = self._agents["traj_pos"][w, i][tv]
                    if render_3d:
                        ax.plot(tp[:, 0], tp[:, 1], 0.05,
                                color="#9e9e9e", linewidth=0.5, alpha=0.6)
                    else:
                        ax.plot(tp[:, 0], tp[:, 1], color="#9e9e9e",
                                linewidth=0.5, alpha=0.6, zorder=0)
            if render_3d:
                live = valid & (pos[:, 0] > -10000)
                cx, cy = pos[live].mean(axis=0) if live.any() else (0.0, 0.0)
                r3 = zoom_radius or 100.0
                ax.set_xlim(cx - r3, cx + r3)
                ax.set_ylim(cy - r3, cy + r3)
                ax.set_zlim(0, r3 * 0.05)
                outs.append(fig if return_single_figure else img_from_fig(fig))
                continue
            if zoom_radius is not None:
                ci = (center_agent_indices[j]
                      if center_agent_indices is not None else None)
                if ci is not None:
                    cx, cy = pos[ci]
                else:
                    live = valid & (pos[:, 0] > -10000)
                    cx, cy = (pos[live].mean(axis=0)
                              if live.any() else (0.0, 0.0))
                ax.set_xlim(cx - zoom_radius, cx + zoom_radius)
                ax.set_ylim(cy - zoom_radius, cy + zoom_radius)
            else:
                ax.autoscale_view()
            outs.append(fig if return_single_figure else img_from_fig(fig))
        return outs

    def plot_importance_weight(
        self,
        state: SimState,
        env_idx: int,
        importance,
        ego_agent: int,
        zoom_radius: Optional[float] = None,
        figsize=(8, 8),
    ):
        """Per-head figures with partner boxes colored by ego->partner
        attention (reference: visualize/core.py:1641-1734
        _plot_importance_weight + plot_bar_plot inset).

        importance: [H, A-1] per-head attention over the ego's partner obs
        slots (``il.analysis.closed_loop_rollout`` collects it).  Returns a
        list of RGB arrays, one per head."""
        from matplotlib import cm

        from gpudrive_lab_torch.il.analysis import partner_slot_map

        rows = state_rows(state, [env_idx])
        pos, yaw = rows["pos"][0], rows["yaw"][0]
        importance = _host(importance)
        A = pos.shape[0]
        slots = partner_slot_map(A)[ego_agent]  # [A-1] agent idx per slot
        valid = self._agents["valid"][env_idx][slots]
        live = valid & (pos[slots, 0] > -10000)

        outs = []
        for h in range(importance.shape[0]):
            fig, ax = plt.subplots(figsize=figsize)
            ax.set_aspect("equal")
            ax.set_axis_off()
            self._plot_roads(ax, env_idx)
            # ego box in red
            size = self._agents["size"][env_idx, ego_agent]
            plot_bounding_box(
                ax, *pos[ego_agent], yaw[ego_agent],
                size[0] * C.VEHICLE_LENGTH_SCALE,
                size[1] * C.VEHICLE_LENGTH_SCALE, "#d7191c",
            )
            w = importance[h][live]
            span = w.max() - w.min()
            score = (w - w.min()) / span if span > 1e-6 else np.zeros_like(w)
            colors = cm.viridis(score)[:, :3]
            for color, slot_agent in zip(colors, slots[live]):
                s = self._agents["size"][env_idx, slot_agent]
                plot_bounding_box(
                    ax, *pos[slot_agent], yaw[slot_agent],
                    s[0] * C.VEHICLE_LENGTH_SCALE,
                    s[1] * C.VEHICLE_LENGTH_SCALE, tuple(color),
                )
            # attention bar inset (reference utils.plot_bar_plot)
            if w.size:
                inset = fig.add_axes([0.72, 0.74, 0.24, 0.22])
                inset.bar(np.arange(w.size), np.sort(w)[::-1],
                          color="#2b83ba")
                inset.set_title(f"head {h} attention", fontsize=7)
                inset.tick_params(labelsize=5)
            if zoom_radius is not None:
                cx, cy = pos[ego_agent]
                ax.set_xlim(cx - zoom_radius, cx + zoom_radius)
                ax.set_ylim(cy - zoom_radius, cy + zoom_radius)
            else:
                ax.autoscale_view()
            outs.append(img_from_fig(fig))
        return outs

    def plot_linear_probing(
        self,
        state: SimState,
        env_idx: int,
        ego_agent: int,
        ego_pred: Sequence[int],
        ego_pred_prime: Sequence[int],
        partner_pred: Sequence[int],
        partner_log_cells: Optional[Sequence[int]] = None,
        figsize=(8, 8),
    ):
        """Ego-centered probe grid with predicted future-cell paths
        (reference: visualize/core.py:1736-1873 _plot_linear_probing):
        dashed numbered 8x8 grid around the ego, dashed ego path over the
        probe horizons, dotted intervened-ego path, dashed partner path,
        solid logged-partner path when labels are given.  Returns an RGB
        array."""
        from gpudrive_lab_torch.il.analysis import (
            GRID_CORNER_LINES,
            GRID_EXTENT,
            cell_centers_ego_frame,
        )

        rows = state_rows(state, [env_idx])
        pos, yaw = rows["pos"][0], rows["yaw"][0]
        fig, ax = plt.subplots(figsize=figsize)
        ax.set_aspect("equal")
        ax.set_axis_off()
        self._plot_roads(ax, env_idx)
        ex, ey = pos[ego_agent]
        eyaw = float(yaw[ego_agent])
        c, s = np.cos(eyaw), np.sin(eyaw)
        R = np.array([[c, -s], [s, c]])  # ego->world

        corners = np.linspace(-GRID_EXTENT, GRID_EXTENT, GRID_CORNER_LINES)
        gx, gy = np.meshgrid(corners, corners)
        pts = R @ np.stack([gx.ravel(), gy.ravel()])
        wx = pts[0].reshape(gx.shape) + ex
        wy = pts[1].reshape(gy.shape) + ey
        for i in range(GRID_CORNER_LINES):
            ax.plot(wx[i], wy[i], color="black", ls="--", lw=0.7, zorder=3)
            ax.plot(wx[:, i], wy[:, i], color="black", ls="--", lw=0.7,
                    zorder=3)
        side = GRID_CORNER_LINES - 1
        for r_i in range(side):
            for c_i in range(side):
                ax.text(wx[r_i, c_i], wy[r_i, c_i], str(r_i * side + c_i),
                        fontsize=6, color="black", zorder=3)

        centers = cell_centers_ego_frame()  # [cells, 2] ego frame

        def to_world(cells):
            p = centers[np.asarray(_host(cells), int)]
            return (R @ p.T).T + np.array([ex, ey])

        for cells, style, color in (
            (ego_pred, "--", "#d7191c"),
            (ego_pred_prime, ":", "#d7191c"),
            (partner_pred, "--", "#2b83ba"),
        ):
            if len(cells):
                p = to_world(cells)
                ax.plot(p[:, 0], p[:, 1], ls=style, color=color, lw=2,
                        zorder=4)
        if partner_log_cells is not None and len(partner_log_cells):
            p = to_world(partner_log_cells)
            ax.plot(p[:, 0], p[:, 1], ls="-", color="#2b83ba", lw=2,
                    zorder=4)

        size = self._agents["size"][env_idx, ego_agent]
        plot_bounding_box(
            ax, ex, ey, eyaw,
            size[0] * C.VEHICLE_LENGTH_SCALE,
            size[1] * C.VEHICLE_LENGTH_SCALE, "#d7191c",
        )
        ax.set_xlim(ex - GRID_EXTENT * 1.2, ex + GRID_EXTENT * 1.2)
        ax.set_ylim(ey - GRID_EXTENT * 1.2, ey + GRID_EXTENT * 1.2)
        return img_from_fig(fig)

    def plot_log_replay_comparison(
        self,
        positions,
        env_idx: int,
        agent_indices: Optional[Sequence[int]] = None,
        figsize=(8, 8),
    ):
        """Rollout trajectories (solid) against the logged expert
        trajectories (dashed) for the selected agents (the reference's
        log-replay comparison overlays).  positions: [T, W, A, 2] rollout
        position history (only world ``env_idx`` is copied to the host).
        Returns an RGB array."""
        positions = _host(positions[:, env_idx])  # [T, A, 2]
        fig, ax = plt.subplots(figsize=figsize)
        ax.set_aspect("equal")
        ax.set_axis_off()
        self._plot_roads(ax, env_idx)
        valid = self._agents["valid"][env_idx]
        if agent_indices is None:
            agent_indices = np.nonzero(
                valid & self._agents["controlled"][env_idx]
            )[0]
        for j, i in enumerate(agent_indices):
            color = POLICY_COLORS[j % len(POLICY_COLORS)]
            tv = self._agents["traj_valid"][env_idx, i] > 0
            tp = self._agents["traj_pos"][env_idx, i][tv]
            if len(tp):
                ax.plot(tp[:, 0], tp[:, 1], ls="--", color=color, lw=1.0,
                        alpha=0.7, label=f"agent {i} log" if j < 6 else None)
            rp = positions[:, i]
            live = rp[:, 0] > -10000
            ax.plot(rp[live, 0], rp[live, 1], ls="-", color=color, lw=1.2,
                    label=f"agent {i} policy" if j < 6 else None)
        ax.legend(fontsize=6, loc="upper right")
        ax.autoscale_view()
        return img_from_fig(fig)

    def plot_agent_observation(
        self,
        state: SimState,
        env_idx: int,
        agent_idx: int,
        observation_radius: float = 50.0,
        figsize=(6, 6),
    ):
        """Egocentric view of one agent's neighborhood
        (reference: visualize/core.py:1404+).  Returns the figure
        (``visualize.utils.img_from_fig`` turns it into an array)."""
        rows = state_rows(state, [env_idx])
        pos, yaw = rows["pos"][0], rows["yaw"][0]
        fig, ax = plt.subplots(figsize=figsize)
        ax.set_aspect("equal")
        ego = pos[agent_idx]
        eyaw = yaw[agent_idx]
        c, s = np.cos(eyaw), np.sin(eyaw)
        R = np.array([[c, s], [-s, c]])

        r = self._roads
        valid = r["valid"][env_idx]
        rel = (r["pos"][env_idx][valid][:, :2] - ego) @ R.T
        within = np.linalg.norm(rel, axis=-1) <= observation_radius
        for k in np.nonzero(within)[0]:
            t = int(r["etype"][env_idx][valid][k])
            ry = r["yaw"][env_idx][valid][k] - eyaw
            half = r["scale"][env_idx][valid][k]
            dx, dy = half[0] * np.cos(ry), half[0] * np.sin(ry)
            ax.plot(
                [rel[k, 0] - dx, rel[k, 0] + dx],
                [rel[k, 1] - dy, rel[k, 1] + dy],
                color=ROAD_GRAPH_COLORS.get(t, "#cccccc"), linewidth=0.6,
            )

        a_valid = self._agents["valid"][env_idx]
        for i in np.nonzero(a_valid)[0]:
            p = (pos[i] - ego) @ R.T
            if np.linalg.norm(p) > observation_radius and i != agent_idx:
                continue
            size = self._agents["size"][env_idx, i]
            color = "#d7191c" if i == agent_idx else "#2b83ba"
            plot_bounding_box(
                ax, p[0], p[1], yaw[i] - eyaw,
                size[0] * C.VEHICLE_LENGTH_SCALE,
                size[1] * C.VEHICLE_LENGTH_SCALE, color,
            )
        ax.set_xlim(-observation_radius, observation_radius)
        ax.set_ylim(-observation_radius, observation_radius)
        ax.set_axis_off()
        return fig
