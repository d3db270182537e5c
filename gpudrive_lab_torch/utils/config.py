"""YAML experiment-config loading (port of
``gpudrive_lab_tpu/utils/config.py``).

Mirror of the reference's config loader (reference: gpudrive/utils/config.py
load_config -> Box): YAML files become attribute-accessible namespaces with
dotted-override support for CLI sweeps."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterable


class ConfigBox(dict):
    """dict with attribute access (a minimal Box).  Nested dicts are
    converted to ConfigBox IN PLACE at construction so attribute-style
    writes to nested keys (cfg.train.lr = ...) mutate the real tree."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in self.items():
            if isinstance(v, dict) and not isinstance(v, ConfigBox):
                self[k] = ConfigBox(v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, ConfigBox):
            v = ConfigBox(v)
        self[k] = v


def load_config(path: str | Path) -> ConfigBox:
    import yaml

    with open(path) as f:
        return ConfigBox(yaml.safe_load(f) or {})


def apply_overrides(cfg: ConfigBox, overrides: Iterable[str]) -> ConfigBox:
    """Apply "a.b.c=value" overrides (typer-style CLI dotted keys,
    reference: baselines/ppo/ppo_pufferlib.py:155-258)."""
    import json

    for ov in overrides:
        key, _, raw = ov.partition("=")
        node: Any = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        node[parts[-1]] = val
    return cfg
