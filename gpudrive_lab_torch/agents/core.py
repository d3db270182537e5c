"""Combine per-actor actions into the global action tensor (port of
``gpudrive_lab_tpu/agents/core.py``; reference: gpudrive/agents/core.py:
4-39)."""

from __future__ import annotations

import torch


def merge_actions(actor_actions_dict, actor_ids_dict,
                  reference_action_tensor) -> torch.Tensor:
    """actor_actions_dict: {actor_name: [N] actions};
    actor_ids_dict: {actor_name: [N] flat agent indices into W*A};
    reference_action_tensor: a [W, A]-shaped tensor giving the shape and
    the device.  Returns the [W, A] int64 merged actions there."""
    ref = torch.as_tensor(reference_action_tensor)
    W, A = ref.shape[:2]
    flat = torch.zeros(W * A, dtype=torch.int64, device=ref.device)
    for name, actions in actor_actions_dict.items():
        ids = torch.as_tensor(actor_ids_dict[name], device=ref.device)
        flat[ids.reshape(-1).long()] = torch.as_tensor(
            actions, device=ref.device).reshape(-1).long()
    return flat.reshape(W, A)
