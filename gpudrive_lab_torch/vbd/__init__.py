"""Versatile Behavior Diffusion (VBD) sim agents (port of
``gpudrive_lab_tpu/vbd/``): the TPU-first denoiser (``model``), the exact
mirror of the released checkpoint's architecture (``model_official``), the
sample batch (``data_utils``), checkpoint loading and weight conversion
(``convert``), the trajectory sources and the env's VBD obs and reward
(``integration``), and sampling-time guidance (``guidance_metrics``,
``ilq``, ``guidance``)."""
