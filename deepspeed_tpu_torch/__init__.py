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
through both engines, trains every one of these families on one device
or over a ``data`` x ``model`` mesh of ranks at ZeRO stage 0, or at
ZeRO stages 1-3 over ``data`` ranks (fed by
:class:`~deepspeed_tpu_torch.runtime.dataloader.DataLoader` when
``initialize`` is given ``training_data``), and any ``nn.Module``
wrapped by ``models.api.from_module``, generates images with Stable
Diffusion (``models.diffusion``'s UNet and VAE, the DDIM pipeline of
``inference.diffusion`` fed by CLIP's text tower), trains a
``zero3_blocks`` model with ZeRO stage 3 over several ranks through the
compressed-collective facade, saves crash-safe checkpoints that resume
at any stage or layout (``runtime/checkpoint.py``, the config's
``checkpoint`` and ``resilience`` blocks, ``launcher/agent.py``) and
loads and exports Hugging Face weights (``checkpoint/hf.py``,
``checkpoint/export.py``):

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

    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=GPT2("small"), config={"train_batch_size": 16, "seed": 1,
                                     "bf16": {"enabled": True}, ...},
        training_data={"input_ids": tokens_np})    # [n, 1024] numpy
    for batch in loader:                           # on the card
        metrics = engine.train_batch(batch)

    serving = RaggedInferenceEngine(OPT("6.7b", dtype=torch.bfloat16),
                                    RaggedConfig(max_context=2048))

    engine = deepspeed_tpu_torch.init_inference(
        Llama("7b", dtype=torch.bfloat16),
        config={"dtype": "bfloat16", "temperature": 0.0,
                "quant": {"enabled": True, "bits": 8, "group_size": 256}})
    out = engine.generate(ids, max_new_tokens=32)

    moe = RaggedInferenceEngine(GPTMoE("350m", 128, dtype=torch.bfloat16),
                                RaggedConfig(max_context=2048))

    from deepspeed_tpu_torch.inference.diffusion import (
        StableDiffusionPipeline)
    from deepspeed_tpu_torch.models import (AutoencoderKL, CLIP,
                                            UNet2DCondition)
    states = clip.text_states(torch.cat([empty_ids, prompt_ids]))
    sd = StableDiffusionPipeline(UNet2DCondition(dtype=torch.bfloat16),
                                 AutoencoderKL(dtype=torch.bfloat16))
    images = sd(states[b:], states[:b],             # [b, 512, 512, 3]
                torch.Generator("cuda").manual_seed(0))

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

    # tensor-parallel training, each rank (gloo for ranks sharing a card):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=Llama("1b"), config={"train_batch_size": 4,
                                   "mesh": {"data": 2, "model": 2}, ...})
    metrics = engine.train_batch({"input_ids": tokens})  # the global batch

    # the rest of the trainer: any optimizer rule (sgd, lamb, lion,
    # adagrad and the reference's aliases) or a client Transform, remat
    # policies (the model's remat_policy), k steps back to back, the
    # micro-step API, warmup, step records and monitors, compression
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=Llama("1b", remat_policy="selective_flash"), config={
            "train_batch_size": 8, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "lamb", "params": {"lr": 1e-3}},
            "telemetry": {"enabled": True, "output_dir": "telemetry"},
            "csv_monitor": {"enabled": True, "output_path": "monitor"}})
    engine.warmup_async({"input_ids": tokens})
    out = engine.train_steps([batch_a, batch_b, batch_c])   # out["losses"]
    for mb in micro_batches:                        # train_batch_size / gas
        engine.backward(mb)
        engine.step()                               # applies at the boundary

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from .comm.comm import init_distributed  # noqa: F401
from .config import Config, ConfigError  # noqa: F401
from .parallel.mesh import Topology
from .inference.engine import InferenceConfig, InferenceEngine
from .models.moe import (GPTMoE, MoETransformer,  # noqa: F401
                         MoETransformerConfig, gpt_moe_config)
from .runtime.dataloader import DataLoader, RepeatingLoader  # noqa: F401
from .runtime.engine import TrainEngine
from .telemetry import MetricsRegistry, StepStats, get_telemetry  # noqa: F401
from .utils.logging import log_dist, logger  # noqa: F401

__version__ = "0.1.0"


def initialize(*, loss_fn: Optional[Callable] = None, params: Any = None,
               model: Any = None, config: Any = None,
               config_params: Any = None, optimizer: Any = None,
               lr_scheduler: Any = None, training_data: Any = None,
               collate_fn: Optional[Callable] = None,
               device=None) -> Tuple[TrainEngine, Any, Any, Any]:
    """Bring up a training engine (one device, a ``data`` x ``model`` mesh
    of the ranks of ``init_distributed`` at stage 0, or ZeRO stages 1-3
    over their ``data`` axis, the engine placing the masters, gradients
    and optimizer state by ``parallel.zero.ZeroShardingRules``); returns
    ``(engine, optimizer, dataloader, lr_scheduler)`` as
    ``deepspeed_tpu.initialize`` does.

    ``optimizer`` is a client optimizer (a
    :class:`~deepspeed_tpu_torch.runtime.optimizers.Transform`, or any
    object with ``init`` / ``update``, ``as_transform``'s protocol) in
    place of the config's ``optimizer`` block; ``lr_scheduler`` a
    callable ``count -> lr`` in place of its ``scheduler``.

    Pass either ``loss_fn(params, batch) -> loss | (loss, aux)`` plus
    ``params`` (a ``{name: tensor}`` dict), or ``model`` — an object with
    ``named_parameters()`` and ``loss(batch, params=...)``: any of the
    port's models (every decoder flag set, BERT, DistilBERT, CLIP, an MoE
    model), or a
    :class:`~deepspeed_tpu_torch.parallel.zero.SequentialBlockModel`,
    whose ``zero3_blocks`` stage 3 runs on the staged block schedule. The
    model's own weights
    are the initial parameters unless ``params`` is given. ``config`` is
    a dict or a path to a DeepSpeed-style JSON file.

    The config's ``mesh`` becomes the topology, and a model of the port
    (``bind_topology``) is bound to it. Under ``mesh.model`` > 1 the model
    is cut to this rank's shards by its ``partition_specs`` (``shard_``,
    as the JAX ``initialize`` places the tree by ``tp_specs``), or, with
    ``params`` given at full width, each leaf is sliced to the shard; a
    model already cut (``checkpoint.jax_params.shard_params``) is only
    bound.

    ``training_data`` (a sequence of samples, an array or a dict of
    arrays) becomes a :class:`DataLoader` of ``train_batch_size`` global
    batches on the engine's device, shuffled from the config's ``seed``,
    collated by ``collate_fn`` and prefetched ``dataloader.
    prefetch_depth`` deep; it is bound to the engine and returned."""
    cfg = Config.from_any(config if config is not None else config_params)
    if loss_fn is None and (model is None or not hasattr(model, "loss")):
        raise ValueError("initialize() needs loss_fn+params, or a model "
                         "exposing .loss()")
    if params is None and (model is None
                           or not hasattr(model, "named_parameters")):
        raise ValueError("initialize() needs params, or a model exposing "
                         ".named_parameters()")
    topo = Topology.build(cfg.mesh)
    if hasattr(model, "bind_topology"):
        params = _place(model, params, topo)
    if params is None:
        params = dict(model.named_parameters())
    engine = TrainEngine(loss_fn=loss_fn, params=params, config=cfg,
                         model=model, optimizer=optimizer,
                         lr_scheduler=lr_scheduler, device=device,
                         topology=topo)
    dataloader = None
    if training_data is not None:
        dataloader = DataLoader(training_data, cfg.train_batch_size,
                                engine.device, seed=cfg.train_seed,
                                collate_fn=collate_fn,
                                prefetch_depth=cfg.dataloader.prefetch_depth)
        engine.bind_dataloader(dataloader)
    if cfg.checkpoint.auto_resume and cfg.checkpoint.save_dir:
        # preemption-safe auto-resume: the newest VALID tag (torn or
        # corrupt tags are skipped by the manifest check); a missing
        # directory is the first boot. After bind_dataloader, so the
        # loader's position is restored too
        engine.load_checkpoint(cfg.checkpoint.save_dir, auto=True)
    return engine, engine.optimizer, dataloader, engine.lr_schedule


def _place(model, params, topo):
    """Bind ``model`` to ``topo``, cutting it (or the full-width
    ``params``) to this rank's shards over a model axis above 1; returns
    the params to train (None: the model's own)."""
    bound = getattr(model, "_topo", None)
    cut = 1 if bound is None else bound.model_parallel_size
    tp = topo.model_parallel_size
    if cut > 1 and cut != tp:
        raise ValueError(f"the model is cut over a model axis of {cut}; "
                         f"the config's mesh has {tp}")
    if cut > 1 or tp == 1:
        model.bind_topology(topo)
        return params
    if params is None:
        model.shard_(topo)
        return None
    model.bind_topology(topo)
    return {n: model.local_shard(n, p) for n, p in params.items()}


def init_inference(model: Any = None, config: Any = None, *, device=None,
                   **kwargs) -> InferenceEngine:
    """Bring up the v1 inference engine, as ``deepspeed_tpu.init_inference``
    does. ``model`` is a model, or a ``(model, params)`` pair whose
    ``params`` is a ``{name: tensor}`` dict as :func:`initialize` takes.
    ``config`` is a dict (or an ``InferenceConfig``); ``kwargs`` override
    its keys. A ``checkpoint`` entry naming a Hugging Face checkpoint
    directory loads it with ``checkpoint.hf.from_pretrained`` when no
    params are given (the checkpoint's own config builds the model unless
    one is passed, whose config must then match it); under
    ``tensor_parallel`` each rank reads its own shards."""
    icfg = InferenceConfig.from_any(config, **kwargs)
    params = None
    if isinstance(model, tuple):
        model, params = model
    ckpt = icfg.extras.get("checkpoint")
    if model is None and not ckpt:
        raise ValueError("init_inference() needs a model or a (model, "
                         "params) pair")
    if ckpt and params is None:
        if isinstance(ckpt, dict):
            raise NotImplementedError(
                f"checkpoint={ckpt!r}: a checkpoint description (Megatron "
                f"or universal checkpoints, checkpoint/megatron.py and "
                f"universal.py) comes with a later slice of "
                f"deepspeed_tpu_torch (ROADMAP.md, Queue A item 13); name "
                f"a Hugging Face checkpoint directory")
        from .checkpoint.hf import from_pretrained

        topo = None
        if icfg.tensor_parallel > 1:
            from .comm import comm

            if comm.get_world_size() != icfg.tensor_parallel:
                raise ValueError(
                    f"tensor_parallel={icfg.tensor_parallel} needs a world "
                    f"size of {icfg.tensor_parallel} "
                    f"(init_distributed), got {comm.get_world_size()}")
            topo = Topology.build({"model": icfg.tensor_parallel})
        loaded, params = from_pretrained(ckpt, dtype=icfg.torch_dtype,
                                         topology=topo, device=device)
        if model is None:
            model = loaded
    return InferenceEngine(model, icfg, params=params, device=device)
