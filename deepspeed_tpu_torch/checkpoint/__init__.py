"""Weight carry into and out of the port: JAX parameter trees
(``jax_params.py``), Hugging Face checkpoints (``hf.py``, ``export.py``)
and diffusers components (``diffusers.py``), all read and written through
the port's own safetensors codec (``safetensors_io.py``)."""

from .diffusers import (load_unet, load_vae, map_diffusers_unet,  # noqa: F401
                        map_diffusers_vae, read_diffusers_state,
                        unet_config, vae_config)
from .export import export_hf_gpt2, export_hf_llama, export_hf_mixtral  # noqa: F401
from .hf import from_pretrained, hf_config, map_hf_params, read_hf_state  # noqa: F401
