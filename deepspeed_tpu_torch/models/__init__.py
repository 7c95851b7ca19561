"""Model definitions of the port: the decoder families (Llama, GPT-2,
OPT, GPT-Neo), the encoder families (BERT, DistilBERT, CLIP's two
towers) and GPT-MoE on the shared Transformer core; Stable Diffusion's
UNet and VAE; and the ``from_module`` adapter of a foreign
``nn.Module``."""

from .api import FromModule, from_module  # noqa: F401
from .bert import Bert, DistilBert, bert_config, distilbert_config  # noqa: F401
from .clip import (CLIP, CLIPConfig, CLIPVision, clip_text_config,  # noqa: F401
                   clip_vision_config)
from .diffusion import (AutoencoderKL, UNet2DCondition, UNetConfig,  # noqa: F401
                        VAEConfig)
from .gpt2 import GPT2, OPT, GPTNeo, gpt2_config, gpt_neo_config, opt_config  # noqa: F401
from .llama import Llama, llama_config  # noqa: F401
from .moe import GPTMoE, MoETransformer, MoETransformerConfig, gpt_moe_config  # noqa: F401
from .transformer import Transformer, TransformerConfig  # noqa: F401
