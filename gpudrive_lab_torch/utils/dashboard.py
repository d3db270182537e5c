"""Live rich-console training dashboard (port of
``gpudrive_lab_tpu/utils/dashboard.py``).

Counterpart of the reference's PufferLib dashboard
(reference: gpudrive/integrations/puffer/logging.py:50-164): a compact
live-updating table with run summary (steps / SPS / uptime / remaining),
loss row, episode stats, phase timing breakdown, and host utilization.
The JSONL metrics file stays the primary sink (utils/logging.MetricsLogger);
this is terminal QoL only.
"""

from __future__ import annotations

import time
from typing import Optional


def _abbrev(n: float) -> str:
    for div, suffix in ((1e9, "B"), (1e6, "M"), (1e3, "K")):
        if abs(n) >= div:
            return f"{n / div:.2f}{suffix}"
    return f"{n:.0f}" if float(n).is_integer() else f"{n:.3f}"


def _duration(seconds: float) -> str:
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h}h{m:02d}m" if h else (f"{m}m{s:02d}s" if m else f"{s}s")


class Dashboard:
    """Renders training progress as a live rich table.

    Usage:
        dash = Dashboard(total_timesteps=5e7, env_name="gpudrive_lab_torch")
        with dash:
            dash.update(global_step, metrics_dict)
    Falls back to no-op when rich is unavailable or stdout is not a tty
    (unless force=True, used by tests).
    """

    LOSS_KEYS = ("pg_loss", "v_loss", "entropy", "approx_kl", "ent_coef")
    EP_KEYS = (
        "perc_goal_achieved", "perc_collisions", "perc_off_road", "episodes",
        "mean_reward",
    )
    TIME_KEYS = ("time_learn_s", "time_env_s")
    UTIL_KEYS = ("cpu_util", "mem_util", "device_mem_gib")

    def __init__(
        self,
        total_timesteps: float,
        env_name: str = "gpudrive_lab_torch",
        force: bool = False,
        refresh_per_second: float = 4.0,
    ):
        self.total = total_timesteps
        self.env_name = env_name
        self.start = time.time()
        self._live = None
        self._enabled = force
        self._force = force
        self._refresh = refresh_per_second
        if not force:
            try:
                import sys

                from rich.console import Console  # noqa: F401

                self._enabled = sys.stdout.isatty()
            except ImportError:  # pragma: no cover
                self._enabled = False

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self):
        if self._enabled and not self._force:
            from rich.live import Live

            self._live = Live(
                self._render(0, {}), refresh_per_second=self._refresh
            )
            self._live.__enter__()
        return self

    def __exit__(self, *exc):
        if self._live is not None:
            self._live.__exit__(*exc)
            self._live = None
        return False

    # -- rendering ---------------------------------------------------------

    def _render(self, global_step: int, m: dict):
        from rich.table import Table

        uptime = time.time() - self.start
        sps = m.get("controlled_agent_sps", 0.0)
        remaining = (
            (self.total - global_step) / sps if sps > 0 else float("nan")
        )

        dashboard = Table(
            expand=True, show_header=False, border_style="bright_cyan"
        )
        head = Table(box=None, expand=True, show_header=False)
        head.add_row(
            f"[bold cyan]{self.env_name}[/]",
            f"steps [bold]{_abbrev(global_step)}[/]/{_abbrev(self.total)}",
            f"SPS [bold]{_abbrev(sps)}[/]",
            f"up {_duration(uptime)}",
            "eta "
            + (_duration(remaining) if remaining == remaining else "--"),
        )
        dashboard.add_row(head)

        body = Table(box=None, expand=True)
        body.add_column("Losses", justify="left")
        body.add_column("", justify="right")
        body.add_column("Episodes", justify="left")
        body.add_column("", justify="right")
        body.add_column("Perf/Util", justify="left")
        body.add_column("", justify="right")
        rows = max(len(self.LOSS_KEYS), len(self.EP_KEYS),
                   len(self.TIME_KEYS) + len(self.UTIL_KEYS))
        perf_keys = self.TIME_KEYS + self.UTIL_KEYS
        for i in range(rows):
            cells = []
            for keys in (self.LOSS_KEYS, self.EP_KEYS, perf_keys):
                if i < len(keys) and keys[i] in m:
                    cells += [f"[dim]{keys[i]}[/]", _abbrev(m[keys[i]])]
                else:
                    cells += ["", ""]
            body.add_row(*cells)
        dashboard.add_row(body)
        return dashboard

    def update(self, global_step: int, metrics: dict):
        if not self._enabled:
            return
        table = self._render(global_step, metrics)
        if self._live is not None:
            self._live.update(table)

    def render_text(self, global_step: int, metrics: dict) -> str:
        """Render one frame to plain text (test hook / non-tty snapshot)."""
        from rich.console import Console

        console = Console(record=True, width=100, force_terminal=False)
        console.print(self._render(global_step, metrics))
        return console.export_text()
