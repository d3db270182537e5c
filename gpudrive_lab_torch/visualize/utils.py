"""Drawing primitives (port of ``gpudrive_lab_tpu/visualize/utils.py``;
reference: gpudrive/visualize/utils.py).  They take host numpy values: the
visualizer copies what it draws off the device once per call."""

from __future__ import annotations

import io

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
from matplotlib.patches import Polygon


def img_from_fig(fig) -> np.ndarray:
    """Render a figure to an RGB uint8 array
    (reference: visualize/utils.py:17-37)."""
    buf = io.BytesIO()
    fig.savefig(buf, format="raw", dpi=fig.dpi)
    buf.seek(0)
    w, h = fig.canvas.get_width_height()
    img = np.frombuffer(buf.getvalue(), np.uint8).reshape(h, w, 4)[..., :3]
    plt.close(fig)
    return img


def box_corners(cx, cy, yaw, half_l, half_w):
    """[4, 2] world-frame corners of an oriented box."""
    c, s = np.cos(yaw), np.sin(yaw)
    local = np.array(
        [[-half_l, -half_w], [half_l, -half_w], [half_l, half_w], [-half_l, half_w]]
    )
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + np.array([cx, cy])


def plot_bounding_box(ax, cx, cy, yaw, length, width, color, alpha=1.0,
                      label=None, zorder=3):
    """Oriented vehicle rectangle (reference: visualize/utils.py bounding-box
    prims)."""
    corners = box_corners(cx, cy, yaw, length / 2, width / 2)
    ax.add_patch(
        Polygon(corners, closed=True, facecolor=color, edgecolor="black",
                linewidth=0.4, alpha=alpha, zorder=zorder, label=label)
    )
    # heading tick
    tip = corners[1:3].mean(axis=0)
    ax.plot([cx, tip[0]], [cy, tip[1]], color="black", linewidth=0.4,
            zorder=zorder + 1)


def stripe_polygons(cx, cy, yaw, half_l, half_w, num_stripes=6):
    """[num_stripes, 4, 2] corner arrays of equal bands along the box length
    (reference: visualize/utils.py:293-332 get_stripe_polygon)."""
    c, s = np.cos(yaw), np.sin(yaw)
    u = np.array([c, s])  # lengthwise unit vector
    ut = np.array([-s, c])  # widthwise unit vector
    center = np.array([cx, cy])
    stripe = 2.0 * half_l / num_stripes
    out = []
    for i in range(num_stripes):
        a = -half_l + i * stripe
        b = a + stripe
        out.append(
            np.stack([
                center + u * a + ut * half_w,
                center + u * a - ut * half_w,
                center + u * b - ut * half_w,
                center + u * b + ut * half_w,
            ])
        )
    return np.stack(out)


def plot_crosswalk(ax, cx, cy, yaw, length, width, facecolor="white",
                   edgecolor="xkcd:bluish grey", alpha=0.4, zorder=1):
    """Zebra-striped crosswalk: alternating filled bands inside an outlined
    box (reference: visualize/utils.py:404-433 plot_crosswalk — hatched
    polygon; drawn here as explicit stripes)."""
    corners = box_corners(cx, cy, yaw, length / 2, width / 2)
    ax.add_patch(
        Polygon(corners, closed=True, fill=False, edgecolor=edgecolor,
                linewidth=1.2, alpha=min(1.0, alpha * 2), zorder=zorder)
    )
    for i, quad in enumerate(
        stripe_polygons(cx, cy, yaw, length / 2, width / 2, num_stripes=7)
    ):
        if i % 2 == 0:
            ax.add_patch(
                Polygon(quad, closed=True, facecolor=facecolor,
                        edgecolor="none", alpha=alpha, zorder=zorder)
            )


def plot_speed_bump(ax, cx, cy, yaw, length, width,
                    facecolor="xkcd:goldenrod", stripecolor="black",
                    alpha=0.5, zorder=2):
    """Hazard-striped speed bump (reference: visualize/utils.py:334-371
    plot_speed_bumps — goldenrod polygon with // hatch; drawn here as
    alternating diagonal bands)."""
    corners = box_corners(cx, cy, yaw, length / 2, width / 2)
    ax.add_patch(
        Polygon(corners, closed=True, facecolor=facecolor, edgecolor="black",
                linewidth=0.4, alpha=alpha, zorder=zorder)
    )
    for i, quad in enumerate(
        stripe_polygons(cx, cy, yaw, length / 2, width / 2, num_stripes=5)
    ):
        if i % 2 == 1:
            ax.add_patch(
                Polygon(quad, closed=True, facecolor=stripecolor,
                        edgecolor="none", alpha=alpha * 0.6, zorder=zorder)
            )


def plot_stop_sign(ax, x, y, radius=1.0, facecolor="#c04000",
                   edgecolor="white", linewidth=1.5, alpha=1.0, zorder=2):
    """Hexagonal stop-sign glyph (reference: visualize/utils.py:373-402
    plot_stop_sign — RegularPolygon numVertices=6)."""
    from matplotlib.patches import RegularPolygon

    ax.add_patch(
        RegularPolygon(
            (float(x), float(y)), numVertices=6, radius=radius,
            facecolor=facecolor, edgecolor=edgecolor, linewidth=linewidth,
            alpha=alpha, zorder=zorder,
        )
    )
