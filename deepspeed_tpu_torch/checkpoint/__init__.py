"""Weight carry into the port: JAX parameter trees (``jax_params.py``)
and diffusers state-dict names (``diffusers.py``)."""

from .diffusers import (map_diffusers_unet, map_diffusers_vae,  # noqa: F401
                        unet_config, vae_config)
