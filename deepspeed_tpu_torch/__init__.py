"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` stays the reference; this package mirrors
its module paths (``deepspeed_tpu_torch/<sub>/<mod>.py`` ports
``deepspeed_tpu/<sub>/<mod>.py``) and imports ``torch`` and numpy, never
``jax`` or ``deepspeed_tpu``. Its kernels are hand-written for Hopper
(``csrc/``), each beside a plain PyTorch version of the same function.

It serves Llama, GPT-2 and OPT through the ragged engine and the serving
front-end (optionally over int8/int4 KV pools), generates from every
decoder family of the JAX package (Llama, GPT-2, OPT, GPT-Neo and the
GPT-J / Bloom flag sets) through the v1 inference engine (optionally with
ZeRO-Inference int8/int4 weights), runs the encoders (BERT and DistilBERT
MLM logits through the same engine's ``forward``, CLIP's two towers
through ``models.clip.CLIP``), serves DeepSpeed-MoE's GPT-MoE
(``models.moe.GPTMoE``: top-k routed expert banks on grouped GEMMs)
through both engines, trains Llama on one device, and trains
a ``zero3_blocks`` model with ZeRO stage 3 over several ranks through the
compressed-collective facade:

    from deepspeed_tpu_torch.models.gpt2 import GPT2, OPT, GPTNeo
    from deepspeed_tpu_torch.models.llama import Llama
    from deepspeed_tpu_torch.models.moe import GPTMoE
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.parallel.zero import SequentialBlockModel
    from deepspeed_tpu_torch.serving.server import ServingEngine

    import deepspeed_tpu_torch
    engine, opt, _, sched = deepspeed_tpu_torch.initialize(
        model=Llama("1b"), config={"train_batch_size": 8, ...})
    metrics = engine.train_batch({"input_ids": tokens})

    serving = RaggedInferenceEngine(OPT("6.7b", dtype=torch.bfloat16),
                                    RaggedConfig(max_context=2048))

    engine = deepspeed_tpu_torch.init_inference(
        Llama("7b", dtype=torch.bfloat16),
        config={"dtype": "bfloat16", "temperature": 0.0,
                "quant": {"enabled": True, "bits": 8, "group_size": 256}})
    out = engine.generate(ids, max_new_tokens=32)

    moe = RaggedInferenceEngine(GPTMoE("350m", 128, dtype=torch.bfloat16),
                                RaggedConfig(max_context=2048))

    from deepspeed_tpu_torch.models.bert import Bert
    mlm = deepspeed_tpu_torch.init_inference(
        Bert("large", dtype=torch.bfloat16), config={"dtype": "bfloat16"})
    logits = mlm.forward(ids)          # [b, s, 30522]

    # each rank (one process per rank):
    deepspeed_tpu_torch.init_distributed(dist_backend="nccl")   # or "gloo"
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=SequentialBlockModel((4096, 11008, 4096)), config={
            "train_batch_size": 64, "zero_optimization": {"stage": 3},
            "comm_compression": {"enabled": True, "grad_bits": 4}})
    metrics = engine.train_batch({"x": x, "y": y})   # the global batch

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from .comm.comm import init_distributed  # noqa: F401
from .config import Config, ConfigError  # noqa: F401
from .inference.engine import InferenceConfig, InferenceEngine
from .models.moe import (GPTMoE, MoETransformer,  # noqa: F401
                         MoETransformerConfig, gpt_moe_config)
from .models.transformer import Transformer, non_llama_flags
from .runtime.engine import TrainEngine

__version__ = "0.1.0"


def initialize(*, loss_fn: Optional[Callable] = None, params: Any = None,
               model: Any = None, config: Any = None,
               config_params: Any = None, optimizer: Any = None,
               lr_scheduler: Any = None, training_data: Any = None,
               device=None) -> Tuple[TrainEngine, Any, Any, Any]:
    """Bring up a training engine (one device, or ZeRO-3 over the ranks of
    ``init_distributed``); returns ``(engine, optimizer, dataloader,
    lr_scheduler)`` as ``deepspeed_tpu.initialize`` does.

    Pass either ``loss_fn(params, batch) -> loss | (loss, aux)`` plus
    ``params`` (a ``{name: tensor}`` dict), or ``model`` — an object with
    ``named_parameters()`` and ``loss(batch, params=...)`` (the port's
    :class:`~deepspeed_tpu_torch.models.transformer.Transformer`, or a
    :class:`~deepspeed_tpu_torch.parallel.zero.SequentialBlockModel`,
    whose ``zero3_blocks`` ZeRO stage 3 needs), whose own weights are the
    initial parameters unless ``params`` is given. ``config`` is a dict or
    a path to a DeepSpeed-style JSON file. The dataloader
    (``training_data``) comes with a later slice, and so does training a
    model off the Llama flag set (GPT-2, OPT, GPT-Neo, ..., and the
    encoders: BERT, DistilBERT, CLIP's towers) or any Mixture-of-Experts
    model."""
    cfg = Config.from_any(config if config is not None else config_params)
    if isinstance(model, MoETransformer):
        # whatever its flags: a silu_glu / rms / rope MoE has the Llama set
        raise NotImplementedError(
            "training a Mixture-of-Experts model (its capacity route and "
            "aux loss under TrainEngine) comes with a later slice "
            "(ROADMAP.md, Queue A item 7, the training part); serve it "
            "with init_inference or the ragged engine")
    bad = non_llama_flags(model.config) \
        if isinstance(model, Transformer) else []
    if bad:
        raise NotImplementedError(
            f"training a model with the non-Llama flags {bad} comes with a "
            f"later slice (ROADMAP.md, Queue A item 7, the training part); "
            f"serve it with init_inference or the ragged engine")
    if training_data is not None:
        raise NotImplementedError(
            "training_data (runtime/dataloader.py) comes with a later slice "
            "of deepspeed_tpu_torch (ROADMAP.md, Queue A); pass batches to "
            "engine.train_batch")
    if loss_fn is None and (model is None or not hasattr(model, "loss")):
        raise ValueError("initialize() needs loss_fn+params, or a model "
                         "exposing .loss()")
    if params is None:
        if model is None or not hasattr(model, "named_parameters"):
            raise ValueError("initialize() needs params, or a model exposing "
                             ".named_parameters()")
        params = dict(model.named_parameters())
    engine = TrainEngine(loss_fn=loss_fn, params=params, config=cfg,
                         model=model, optimizer=optimizer,
                         lr_scheduler=lr_scheduler, device=device)
    return engine, engine.optimizer, None, engine.lr_schedule


def init_inference(model: Any = None, config: Any = None, *, device=None,
                   **kwargs) -> InferenceEngine:
    """Bring up the v1 inference engine, as ``deepspeed_tpu.init_inference``
    does. ``model`` is a model, or a ``(model, params)`` pair whose
    ``params`` is a ``{name: tensor}`` dict as :func:`initialize` takes.
    ``config`` is a dict (or an ``InferenceConfig``); ``kwargs`` override
    its keys. A ``checkpoint`` entry (loading from a checkpoint directory)
    comes with a later slice and raises."""
    icfg = InferenceConfig.from_any(config, **kwargs)
    params = None
    if isinstance(model, tuple):
        model, params = model
    if model is None and not icfg.extras.get("checkpoint"):
        raise ValueError("init_inference() needs a model or a (model, "
                         "params) pair")
    return InferenceEngine(model, icfg, params=params, device=device)
