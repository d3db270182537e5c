"""The control and the faults of the VBD cells.

The control: the plain reference (``reference/vbd_official.py``) in the
program's place with every product on TF32-rounded operands, the nearest
precision below the configuration's float32 with TF32 off.  It replaces
``OfficialVBD.encode`` (in blocks of ``reference_block`` worlds) and
``OfficialVBD.denoise``, with the program's weights loaded by name; the
sampler, the scheduler, the roll-out and the env stay the program's.

The faults, each planted under the timed path, each a fault the check must
see: QCMHA without its relative terms, the decoder's causal mask dropped,
the scheduler one step off, one entry of the VBD observation block
altered, and the sim step that returns its state unchanged.

Each is a context manager that patches the program where the driver
reaches it and restores it on exit.
"""

from __future__ import annotations

import contextlib

import torch

from .faults import _patched, step_unchanged
from .reference import vbd_official as RV


def reference_of(model, cache: dict):
    """The reference with ``model``'s weights and TF32-rounded products,
    built once per model."""
    net = cache.get(id(model))
    if net is None:
        c = model.config
        net = RV.VBD(RV.Config(
            future_len=c.future_len, agents_len=c.agents_len,
            action_len=c.action_len, diffusion_steps=c.diffusion_steps,
            encoder_layers=c.encoder_layers, action_mean=c.action_mean,
            action_std=c.action_std),
            with_predictor=getattr(model, "with_predictor", True))
        net.load_state_dict(model.state_dict(), strict=True)
        net.to(next(model.parameters()).device)
        net.set_tf32(True)
        cache[id(model)] = net
    return net


@contextlib.contextmanager
def vbd_control(cell):
    """``OfficialVBD.encode`` and ``.denoise`` computed by the reference
    with TF32-rounded products."""
    from gpudrive_lab_torch.vbd import model_official as mo

    cache, block = {}, int(cell.traffic["reference_block"])

    def encode(self, inputs):
        net = reference_of(self, cache)
        W = inputs["agents_history"].shape[0]
        parts = [net.encode({k: v[w:w + block] for k, v in inputs.items()})
                 for w in range(0, W, block)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def denoise(self, enc, x_t, steps):
        return reference_of(self, cache).denoise(enc, x_t, steps)

    with _patched(mo.OfficialVBD, "encode", encode), \
            _patched(mo.OfficialVBD, "denoise", denoise):
        yield


def qcmha_unrelated():
    """QCMHA without its relative terms: no relation in the logits or the
    values of the encoder's attention."""
    from gpudrive_lab_torch.vbd import model_official as mo

    program = mo.QCMHA.forward
    return _patched(mo.QCMHA, "forward",
                    lambda self, query, rel_pos, query_pad_mask=None:
                    program(self, query, None, query_pad_mask))


def causal_mask_dropped():
    """The decoder's agent attention without its causal mask: every agent
    block sees every other agent's blocks."""
    from gpudrive_lab_torch.vbd import model_official as mo

    program = mo.TransformerDecoder.causal_mask
    return _patched(mo.TransformerDecoder, "causal_mask",
                    lambda self, device: torch.zeros_like(
                        program(self, device)))


def scheduler_step_off():
    """The scheduler's step one diffusion step off: step t takes the
    posterior of step t - 1 (t = 0 its own)."""
    from gpudrive_lab_torch.vbd.model import DDPMScheduler

    program = DDPMScheduler.step
    return _patched(DDPMScheduler, "step",
                    lambda self, x0, x_t, t, noise:
                    program(self, x0, x_t, max(int(t) - 1, 0), noise))


def vbd_obs_altered():
    """One entry of the VBD observation block altered where it is
    produced: agent 0's first predicted x in world 0, by 0.25."""
    from gpudrive_lab_torch.env import env_torch

    program = env_torch.egocentric_vbd_obs

    def egocentric_vbd_obs(state, trajectories):
        block = program(state, trajectories).clone()
        block.view(-1)[0] += 0.25
        return block

    return _patched(env_torch, "egocentric_vbd_obs", egocentric_vbd_obs)


FAULTS = {"qcmha_unrelated": qcmha_unrelated,
          "causal_mask_dropped": causal_mask_dropped,
          "scheduler_step_off": scheduler_step_off,
          "vbd_obs_altered": vbd_obs_altered,
          "step_unchanged": step_unchanged}
