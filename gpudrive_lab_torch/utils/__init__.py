"""Utilities of the port: logging, profiling, evaluation, multi-policy
rollouts, checkpoints, YAML configs, sweeps and the training dashboard.

Two modules of ``gpudrive_lab_tpu/utils/`` have no counterpart here.
``packing.py`` packs a train step's arguments into few device buffers to
cut the TPU remote runtime's per-handle dispatch cost
(``gpudrive_lab_tpu/utils/packing.py:1-15``); the port has no such runtime,
and its trainer's ``--packed-io`` is an accepted alias.
``torch_interop.py`` converts between JAX arrays and torch tensors; the
port's arrays are torch tensors already.
"""
