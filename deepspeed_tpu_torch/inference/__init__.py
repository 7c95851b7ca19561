"""Inference engines of the port: the v1 engine (``engine.py``), the
ragged engine (``ragged.py``) and Stable Diffusion's DDIM pipeline
(``diffusion.py``)."""

from .diffusion import DDIMSchedule, StableDiffusionPipeline  # noqa: F401
