"""Checkpoint save/load and hub upload (port of
``gpudrive_lab_tpu/utils/checkpoint.py``).

The reference's checkpointing (reference:
gpudrive/integrations/puffer/ppo.py:695-737 save_checkpoint;
gpudrive/utils/push_checkpoint_to_huggingface.py; the HF-hub mixin on the
policy, networks/late_fusion.py:69-75).  The JAX package writes its array
tree with orbax, which imports JAX, so the port writes ``torch.save``
files instead (``safetensors.torch`` for a flat tensor dict saved to a
``.safetensors`` path), beside the same JSON sidecar of architecture
metadata, ``<path>.meta.json``, so that a policy can be rebuilt from the
files alone.  Sim state itself is never checkpointed: episodes are 91 steps
and regenerate deterministically from scene JSON and seed, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _state(obj):
    """A module's or optimizer's state_dict; anything else as it is."""
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def save_checkpoint(
    path: str,
    state,
    opt_state=None,
    metadata: Optional[dict] = None,
) -> str:
    """Write ``{"state": state, "opt_state": opt_state}`` to ``path`` (a
    module or optimizer is saved as its state_dict) and ``metadata`` to
    ``<path>.meta.json``.  A ``.safetensors`` path takes a flat dict of
    tensors and no optimizer state.  The file is written under a temporary
    name and renamed, so a reader never sees half of it.  Returns the
    path."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    state = _state(state)
    if path.suffix == ".safetensors":
        if opt_state is not None:
            raise ValueError("a .safetensors checkpoint holds one flat "
                             "tensor dict and no optimizer state")
        from safetensors.torch import save_file

        save_file({k: v.detach().cpu().contiguous() for k, v in
                   state.items()}, str(tmp))
    else:
        payload = {"state": state}
        if opt_state is not None:
            payload["opt_state"] = _state(opt_state)
        torch.save(payload, tmp)
    tmp.replace(path)
    with open(str(path) + ".meta.json", "w") as f:
        json.dump(_jsonable(dict(metadata or {})), f, indent=2)
    return str(path)


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """The payload ``save_checkpoint`` wrote: ``{"state": ...}`` and, when
    saved, ``"opt_state"``, tensors on ``map_location``.  Read with
    ``weights_only=True``: tensors and plain containers only."""
    path = Path(path).absolute()
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file

        return {"state": load_file(str(path), device=str(map_location))}
    return torch.load(path, map_location=map_location, weights_only=True)


def load_metadata(path: str) -> dict:
    with open(str(Path(path).absolute()) + ".meta.json") as f:
        return json.load(f)


def _jsonable(obj: Any):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    if isinstance(obj, torch.dtype):
        return str(obj)
    return obj


def push_checkpoint_to_hub(
    path: str, repo_id: str, token: Optional[str] = None
):
    """Upload a checkpoint directory to the Hugging Face hub
    (reference: gpudrive/utils/push_checkpoint_to_huggingface.py:1-34).
    Needs huggingface_hub and the network."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "huggingface_hub is not installed in this environment"
        ) from e
    api = HfApi(token=token)
    api.create_repo(repo_id, exist_ok=True)
    api.upload_folder(folder_path=path, repo_id=repo_id)
