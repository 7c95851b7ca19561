"""Model definitions of the port: the decoder families (Llama, GPT-2,
OPT, GPT-Neo) on the shared Transformer core."""

from .gpt2 import GPT2, OPT, GPTNeo, gpt2_config, gpt_neo_config, opt_config  # noqa: F401
from .llama import Llama, llama_config  # noqa: F401
from .transformer import Transformer, TransformerConfig  # noqa: F401
