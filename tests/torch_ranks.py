"""Rank processes for the port's multi-rank tests, on the CPU over gloo.

:func:`start_ranks` spawns one process per rank (``torch.multiprocessing``,
spawn) that joins a gloo group on a free localhost port, runs one job of
this module with one thread, and sends back what the job returns (numpy
arrays and plain values). Nothing here imports JAX: the JAX side of each
test runs in the pytest process while the ranks run. :meth:`Ranks.results`
waits for all ranks within a deadline and kills every child when one
fails or time runs out. A job that returns :class:`Exit` sends its value
and ends its process at once, without leaving the group: a rank that
dies mid-run.
"""

from __future__ import annotations

import importlib
import os
import queue as queue_mod
import socket
import threading
import time
import traceback
from typing import Any, Dict, List

import numpy as np
import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Exit:
    """A job's value, after which its rank process ends at once (no
    barrier, no leaving the group)."""

    def __init__(self, value: Any):
        self.value = value


def _entry(rank: int, world: int, port: int, job: str, args: tuple,
           out) -> None:
    torch.set_num_threads(1)
    try:
        from deepspeed_tpu_torch.comm import comm

        comm.init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}",
                              world_size=world, rank=rank, timeout_s=120)
        fn = getattr(importlib.import_module(__name__), job)
        value = fn(rank, world, *args)
        if isinstance(value, Exit):
            out.put((rank, "ok", value.value))
            out.close()
            out.join_thread()
            os._exit(0)
        out.put((rank, "ok", value))
        comm.barrier()
        comm.destroy()
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))


class Ranks:
    def __init__(self, world: int, job: str, *args, timeout: float = 150.0):
        ctx = mp.get_context("spawn")
        self.world = world
        self.deadline = time.monotonic() + timeout
        self.queue = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_entry, daemon=True,
                                  args=(r, world, port, job, args,
                                        self.queue))
                      for r in range(world)]
        # a spawned child takes its pickled arguments only once it has
        # imported torch: start the ranks side by side, not one by one
        starters = [threading.Thread(target=p.start) for p in self.procs]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        self._results: Dict[int, Any] = {}

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=10)

    def results(self) -> List[Any]:
        """Every rank's return value, in rank order."""
        try:
            while len(self._results) < self.world:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(self.world)) - set(self._results))} "
                                       f"did not finish in time")
                try:
                    rank, status, value = self.queue.get(timeout=min(left, 5))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if not p.is_alive() and r not in self._results]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited without a "
                                           f"result")
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                self._results[rank] = value
            for p in self.procs:
                p.join(timeout=max(self.deadline - time.monotonic(), 5))
        finally:
            self.kill()
        return [self._results[r] for r in range(self.world)]


def start_ranks(world: int, job: str, *args, timeout: float = 150.0) -> Ranks:
    return Ranks(world, job, *args, timeout=timeout)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()


def _counters() -> Dict[str, float]:
    from deepspeed_tpu_torch.telemetry.registry import get_registry

    return {k: v for k, v in get_registry().snapshot().items()
            if k.startswith("comm/facade")}


def _fresh_registry() -> None:
    from deepspeed_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                        set_registry)

    set_registry(MetricsRegistry())


# ----------------------------------------------------------------------
# jobs of tests/test_torch_comm.py

def facade_job(rank: int, world: int, cases: Dict[str, Any]) -> Dict[str, Any]:
    """The facade ops on this rank's inputs; ``cases[name]`` holds the
    per-rank inputs stacked on axis 0."""
    from deepspeed_tpu_torch.comm import compressed as cc

    out: Dict[str, Any] = {}
    for bits in (8, 4):
        for dim in (0, 1):
            x = torch.from_numpy(cases["ag"][rank])
            out[f"ag_{bits}_{dim}"] = _np(cc.quantized_all_gather(
                x, "data", dim=dim, qspec=cc.QuantSpec(bits, 64)))
    out["ag_dense"] = _np(cc.quantized_all_gather(
        torch.from_numpy(cases["ag"][rank]), "data", dim=1))
    for bits in (8, 4):
        spec = cc.QuantSpec(bits, 64)
        x = torch.from_numpy(cases["flat"][rank])
        for reduce in ("mean", "sum"):
            payload, s = cc._quantize(x, spec, None)
            out[f"xchg_{bits}_{reduce}"] = _np(cc.quantized_chunk_exchange(
                payload, s, n=x.numel(), axis_name="data", world=world,
                qspec=spec, op_prefix="t", reduce=reduce))
    _fresh_registry()
    spec = cc.QuantSpec(8, 64)
    out["hier_q"] = _np(cc.hierarchical_pmean(
        torch.from_numpy(cases["flat"][rank]), outer_axis="data",
        outer_world=world, qspec=spec))
    out["hier_dense"] = _np(cc.hierarchical_pmean(
        torch.from_numpy(cases["ragged"][rank]), outer_axis="data",
        outer_world=world, qspec=spec))
    out["hier_counters"] = _counters()
    x = torch.from_numpy(cases["flat"][rank])
    out["car_q"] = _np(cc.chunked_all_reduce(x, "data", qspec=spec))
    out["car_dense"] = _np(cc.chunked_all_reduce(x, "data"))
    out["car_ragged"] = _np(cc.chunked_all_reduce(
        torch.from_numpy(cases["ragged"][rank]), "data", qspec=spec))
    out["car_counters"] = _counters()
    pend = cc.ring_permute(torch.from_numpy(cases["ag"][rank]), "data",
                           world=world)
    out["ring"] = _np(pend.wait())
    ints = {}
    for name in ("int8", "uint8", "float32"):
        t = torch.arange(8, dtype=torch.float32).to(getattr(torch, name)) \
            + rank
        ints[name] = {"gather": [_np(p) for p in cc.comm.all_gather(
            t, cc._group("data"))],
            "a2a": _np(cc.comm.all_to_all(t.reshape(world, -1),
                                          cc._group("data"))),
            "ring": _np(cc.comm.ring_send_recv(t, cc._group("data")).wait())}
        if name == "float32":
            ints[name]["sum"] = _np(cc.comm.all_reduce(t, group=cc._group(
                "data")))
    out["dtypes"] = ints
    logger = cc.comm.get_comms_logger()
    logger.reset()
    cc.comm.configure_comms_logger(True)
    cc.quantized_all_gather(torch.from_numpy(cases["ag"][rank]), "data",
                            dim=1, qspec=cc.QuantSpec(4, 64))
    cc.chunked_all_reduce(torch.from_numpy(cases["flat"][rank]), "data",
                          qspec=cc.QuantSpec(8, 64))
    out["ledger"] = logger.snapshot_totals()
    cc.comm.configure_comms_logger(False)
    return out


# ----------------------------------------------------------------------
# jobs of tests/test_torch_fused_collectives.py

def backend_job(rank: int, world: int, cases: Dict[str, Any]) -> Dict[str, Any]:
    """The three entry points on the fused and the reference backend, and
    the metered fallbacks."""
    from deepspeed_tpu_torch.comm import compressed as cc
    from deepspeed_tpu_torch.comm.backends import (FusedCollectiveBackend,
                                                   ReferenceCollectiveBackend)

    fused, ref = FusedCollectiveBackend(), ReferenceCollectiveBackend()
    out: Dict[str, Any] = {}
    for tag, c in cases["entry"].items():
        dtype = getattr(torch, c["dtype"])
        h = torch.from_numpy(c["h"]).to(dtype)
        w = torch.from_numpy(c["w"][rank]).to(dtype)
        hr = torch.from_numpy(c["hr"][rank])
        g = torch.from_numpy(c["g"][rank])
        x = torch.from_numpy(c["x"][rank])
        wr = torch.from_numpy(c["wr"][rank])
        for q in c["bits"]:
            spec = None if q is None else cc.QuantSpec(q, 64)
            for name, be in (("fused", fused), ("ref", ref)):
                _fresh_registry()
                key = f"{tag}_{q}_{name}"
                out[f"ag_{key}"] = _np(be.all_gather_matmul(
                    h, w, "data", dim=1, qspec=spec))
                out[f"rs_{key}"] = _np(be.matmul_reduce_scatter(
                    hr, g, outer_axis="data", outer_world=world, qspec=spec,
                    min_quant_size=0))
                out[f"ar_{key}"] = _np(be.matmul_all_reduce(
                    x, wr, "data", qspec=spec))
                out[f"counters_{key}"] = _counters()
    spec = cc.QuantSpec(8, 64)
    fb = {}
    h = torch.from_numpy(cases["entry"]["rand"]["h"])
    w = torch.from_numpy(cases["entry"]["rand"]["w"][rank])
    checks = {
        "dim0": lambda: fused.all_gather_matmul(
            torch.from_numpy(cases["dim0_h"]), w, "data", dim=0, qspec=spec),
        "mixed": lambda: fused.all_gather_matmul(
            h, w.to(torch.bfloat16), "data", dim=1, qspec=spec),
        "indivisible": lambda: fused.all_gather_matmul(
            h, w[:, :5].contiguous(), "data", dim=1, qspec=spec),
        "small": lambda: fused.matmul_reduce_scatter(
            torch.from_numpy(cases["entry"]["rand"]["hr"][rank]),
            torch.from_numpy(cases["entry"]["rand"]["g"][rank]),
            outer_axis="data", outer_world=world, qspec=spec,
            min_quant_size=10 ** 9),
    }
    for name, fn in checks.items():
        _fresh_registry()
        fn()
        fb[name] = _counters()
    out["fallbacks"] = fb
    return out


def _engine_config(enabled: bool, backend: str, overlap: str = "staged",
                   error_stats: bool = False):
    return {
        "train_batch_size": 32,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
        "zero_optimization": {"stage": 3,
                              "stage3_param_persistence_threshold": 0},
        "comm_compression": {"enabled": enabled, "weight_bits": 8,
                             "grad_bits": 4, "overlap": overlap,
                             "kernel_backend": backend,
                             "error_stats": error_stats},
        "steps_per_print": 1000,
    }


def engine_job(rank: int, world: int, init_np, batch_np, dims, runs,
               steps: int = 3) -> Dict[str, Any]:
    """``steps`` train_batch steps of SequentialBlockModel(dims) from the
    carried JAX weights, per run ``(name, enabled, backend, overlap)``:
    losses, grad norms, the full weights after the steps (rank 0) and the
    facade counters."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import (
        export_block_params, load_block_params)
    from deepspeed_tpu_torch.parallel.zero import SequentialBlockModel

    out: Dict[str, Any] = {}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    for name, enabled, backend, overlap, err in runs:
        _fresh_registry()
        model = load_block_params(SequentialBlockModel(dims, device="cpu"),
                                  init_np)
        engine, *_ = dst.initialize(
            model=model, config=_engine_config(enabled, backend, overlap,
                                               err), device="cpu")
        losses, norms, errs = [], [], []
        for _ in range(steps):
            m = engine.train_batch(batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if "quant_rel_err" in m:
                errs.append(float(m["quant_rel_err"]))
        full = engine.full_params()
        out[name] = {"losses": losses, "norms": norms, "errs": errs,
                     "counters": _counters(),
                     "params": export_block_params(full) if rank == 0
                     else None}
    return out


# ----------------------------------------------------------------------
# jobs of tests/test_torch_tensor_parallel.py

def drive_puts(eng, prompts: Dict[int, List[int]], n_decode: int
               ) -> List[np.ndarray]:
    """The logits of every ``put`` of a greedy run: the prompts (and any
    prefill continuation), then ``n_decode`` one-token puts of each uid's
    argmax. Runs the same on the JAX engine and on the port's (the
    controller under tensor parallelism). Flushes the uids."""
    uids = list(prompts)
    rows = [eng.put(uids, [list(p) for p in prompts.values()])]
    first: Dict[int, int] = {}
    pending = uids
    while True:
        for u, r in zip(pending, rows[-1]):
            if not np.isnan(r).any():
                first[u] = int(np.argmax(r))
        pending = [u for u in uids if u not in first]
        if not pending:
            break
        rows.append(eng.put(pending, [[] for _ in pending]))
    toks = first
    for _ in range(n_decode):
        rows.append(eng.put(uids, [[toks[u]] for u in uids]))
        toks = {u: int(np.argmax(r)) for u, r in zip(uids, rows[-1])}
    eng.flush(uids)
    return [np.asarray(r) for r in rows]


def _tp_model(model_kw: Dict[str, Any], params: Dict[str, Any], topo):
    """A port Llama cut to this rank's shard, with the carried JAX
    weights loaded leaf by leaf into the shard."""
    from deepspeed_tpu_torch.checkpoint.jax_params import (load_jax_params,
                                                           shard_params)
    from deepspeed_tpu_torch.models.llama import Llama

    model = shard_params(Llama("tiny", device="cpu", **model_kw), topo)
    return load_jax_params(model, params)


def tp_job(rank: int, world: int, cases: Dict[str, Any]) -> Dict[str, Any]:
    """Every tensor-parallel case of the file on this rank: the ragged
    engine (``put`` logits and ``generate`` streams), v1 ``generate``
    (plain SPMD) with the fused counters, ServingEngine over a TP engine,
    and the shards of the carried weights. Workers return what they
    replayed."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import export_params
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.parallel.mesh import Topology
    from deepspeed_tpu_torch.serving.server import ServingEngine

    topo = Topology.build({"model": world})
    out: Dict[str, Any] = {"shards": None}
    for name, case in cases.get("ragged", {}).items():
        model = _tp_model(case["model"], case["params"], topo)
        if name == "fp32":
            out["shards"] = export_params(model)
        eng = RaggedInferenceEngine(
            model, RaggedConfig(dtype=torch.float32, **case["cfg"]),
            device="cpu", topology=topo)
        k_leaf = eng.kv_pool[0][0]          # layer 0's K pages
        if not eng.is_controller:
            out[name] = eng.serve_worker()
            out[name]["copied"] = bool(torch.equal(k_leaf[5], k_leaf[3]))
            continue
        rows = drive_puts(eng, case["prompts"], case["n_decode"])
        streams = eng.generate(dict(case["prompts"]),
                               max_new_tokens=case["new"])
        # trim's copy-on-write page copy goes through a step record too
        differed = not torch.equal(k_leaf[5], k_leaf[3])
        eng._copy_page(3, 5)
        out[name] = {"rows": rows, "streams": streams,
                     "free": eng.allocator.free_blocks,
                     "copied": differed and bool(torch.equal(k_leaf[5],
                                                             k_leaf[3]))}
        eng.stop_workers()
    for kb, case in cases.get("v1", {}).items():
        model = _tp_model(case["model"], case["params"], topo)
        _fresh_registry()
        eng = dst.init_inference(model, case["config"], device="cpu")
        ids = eng.generate(case["ids"], max_new_tokens=case["new"])
        out[f"v1_{kb}"] = {"ids": ids, "counters": _counters(),
                           "bound": model._comm_backend is not None}
    serve = cases.get("serve")
    if serve:
        model = _tp_model(serve["model"], serve["params"], topo)
        eng = RaggedInferenceEngine(
            model, RaggedConfig(dtype=torch.float32, **serve["cfg"]),
            device="cpu", topology=topo)
        if eng.is_controller:
            srv = ServingEngine(eng, {"policy": "fcfs"}, start=False,
                                device="cpu")
            reqs = [srv.submit(p, max_new_tokens=serve["new"])
                    for p in serve["prompts"]]
            for _ in range(500):
                if all(r.is_terminal for r in reqs):
                    break
                srv.step()
            srv.close()
            out["serve"] = {"tokens": [r.tokens for r in reqs],
                            "states": [r.state.value for r in reqs],
                            "leaks": srv.block_leaks()}
        else:
            out["serve"] = eng.serve_worker()
    return out


def tp_rank_death_job(rank: int, world: int, case: Dict[str, Any]):
    """The worker replays ``case["steps"]`` records, then its process
    ends mid-run; the controller's ``generate`` must raise RankFailure
    well inside the process group's timeout, and so must the next call."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine,
                                                      RankFailure)
    from deepspeed_tpu_torch.parallel.mesh import Topology

    topo = Topology.build({"model": world})
    model = _tp_model(case["model"], case["params"], topo)
    eng = RaggedInferenceEngine(
        model, RaggedConfig(dtype=torch.float32, **case["cfg"]),
        device="cpu", topology=topo)
    if not eng.is_controller:
        replay, seen = dict(eng._REPLAY), [0]

        def dying(self, rec):
            seen[0] += 1
            if seen[0] > case["steps"]:
                raise SystemExit(0)
            return replay[rec["op"]](self, rec)

        eng._REPLAY = {op: dying for op in replay}
        try:
            eng.serve_worker()
        except SystemExit:
            pass
        return Exit({"replayed": seen[0] - 1})
    t0 = time.monotonic()
    try:
        eng.generate(dict(case["prompts"]), max_new_tokens=case["new"])
        first = None
    except RankFailure as e:
        first = str(e)
    elapsed = time.monotonic() - t0
    try:
        eng.put([99], [[1, 2, 3]])
        second = None
    except RankFailure as e:
        second = str(e)
    return Exit({"first": first, "second": second, "elapsed": elapsed})


def tp_import_job(rank: int, world: int) -> List[str]:
    """A rank of tensor-parallel serving (the controller's ``generate``,
    the worker's ``serve_worker``) on a small model; returns the JAX
    modules loaded in the process (none are expected)."""
    import sys

    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.models.llama import Llama
    from deepspeed_tpu_torch.parallel.mesh import Topology

    model = Llama("tiny", device="cpu", n_layers=1, d_model=32, n_heads=2,
                  n_kv_heads=2, vocab_size=64, max_seq_len=64)
    eng = RaggedInferenceEngine(
        model, RaggedConfig(token_budget=16, max_seqs=2, n_kv_blocks=8,
                            max_context=64, dtype=torch.float32),
        device="cpu", topology=Topology.build({"model": world}))
    if eng.is_controller:
        eng.generate({1: [1, 2, 3]}, max_new_tokens=3)
        eng.stop_workers()
    else:
        eng.serve_worker()
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu"))


# ----------------------------------------------------------------------
# jobs of tests/test_torch_tp_serving.py

def _family(case: Dict[str, Any]):
    """A port model of ``case``'s flag set (``"dense"`` or ``"moe"``) on
    the CPU, full width."""
    from deepspeed_tpu_torch.models.moe import (MoETransformer,
                                                MoETransformerConfig)
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)

    if case["family"] == "moe":
        return MoETransformer(MoETransformerConfig(**case["config"]),
                              device="cpu")
    return Transformer(TransformerConfig(**case["config"]), device="cpu")


def _full(case: Dict[str, Any]):
    """``case``'s model at full width with the carried JAX weights."""
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params

    return load_jax_params(_family(case), case["params"])


def _shard(case: Dict[str, Any], topo):
    """``case``'s model cut to this rank's shard (``shard_params``), the
    carried JAX weights loaded into the shard."""
    from deepspeed_tpu_torch.checkpoint.jax_params import (load_jax_params,
                                                           shard_params)

    return load_jax_params(shard_params(_family(case), topo), case["params"])


def _routing_log():
    """Record a digest of every no-drop route's gate input and chosen
    experts on this rank (the ranks must route alike). Returns the list
    the digests go to and the undo."""
    import hashlib

    from deepspeed_tpu_torch.parallel import moe as moe_mod

    real, log = moe_mod.no_drop_moe, []

    def logged(x_flat, probs, idx, *a, **k):
        log.append(hashlib.sha256(x_flat.detach().numpy().tobytes()
                                  + idx.numpy().tobytes()).hexdigest())
        return real(x_flat, probs, idx, *a, **k)

    moe_mod.no_drop_moe = logged

    def undo():
        moe_mod.no_drop_moe = real

    return log, undo


def _pages(export) -> Dict[str, np.ndarray]:
    """A ``KVExport``'s or ``PrefixExport``'s pages and scales as numpy
    (bf16 through fp32: exact)."""
    if hasattr(export, "k_pages"):
        leaves = {"k": export.k_pages, "v": export.v_pages,
                  "ks": export.k_scales, "vs": export.v_scales}
    else:
        k, v = export.pages
        ks, vs = export.scales or (None, None)
        leaves = {"k": k, "v": v, "ks": ks, "vs": vs}
    return {n: _np(t) for n, t in leaves.items() if t is not None}


def _same_pages(a, b) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[n], b[n]) for n in a)


def _handoffs(case, topo, pool: str) -> Dict[str, Any]:
    """Both directions of the hand-off between a TP engine and a
    one-device engine over ``pool`` (``"fp32"``, ``"bf16"``, ``"int8"``):
    each export re-exported by its importer bitwise, each continued
    stream against the one-device engine's uninterrupted one. Workers
    replay the TP engine's records."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine,
                                                      assert_block_balance)

    dtype = torch.bfloat16 if pool == "bf16" else torch.float32
    cfg = RaggedConfig(dtype=dtype, kv_quant="int8" if pool == "int8"
                       else "none", **case["cfg"])
    e2 = RaggedInferenceEngine(_shard(case, topo), cfg, device="cpu",
                               topology=topo)
    if not e2.is_controller:
        return e2.serve_worker()
    e1 = RaggedInferenceEngine(_full(case), cfg, device="cpu")
    p, n = case["handoff"], case["new"]
    ref = e1.generate({9: p}, max_new_tokens=n)[9]
    out: Dict[str, Any] = {"ref": ref}
    for src, dst, uid in ((e1, e2, 1), (e2, e1, 2)):
        first = int(np.argmax(src.put([uid], [p])[0]))
        x = src.export_kv(uid)
        src.flush([uid])
        dst.import_kv(uid, x)
        again = dst.export_kv(uid)
        tag = "to_tp" if src is e1 else "from_tp"
        out[tag] = {"pages": _pages(x),
                    "bitwise": _same_pages(_pages(x), _pages(again)),
                    "stream": [first] + dst.decode_steps(
                        {uid: first}, n - 1)[uid]}
        dst.flush([uid])
    for e in (e1, e2):
        assert_block_balance(e, expect_free=cfg.n_kv_blocks)
    e2.stop_workers()
    return out


def _prefix_tier(case, topo) -> Dict[str, Any]:
    """A TP engine with a prefix cache and a cold tier: export_prefix,
    eviction into the cold tier (gather records inside the controller's
    admission), import_prefix re-exported bitwise, then a cold-tier
    re-admission whose stream equals the first."""
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine,
                                                      assert_block_balance)
    from deepspeed_tpu_torch.serving.kvtier import ColdTier

    cfg = RaggedConfig(dtype=torch.float32, enable_prefix_cache=True,
                       **case["cfg"])
    eng = RaggedInferenceEngine(_shard(case, topo), cfg, device="cpu",
                                topology=topo)
    if not eng.is_controller:
        return eng.serve_worker()
    cold = ColdTier(capacity_pages=64)
    eng.enable_kv_tier(member="tp", cold_tier=cold)
    p, n = case["prefix"], case["new"]
    first = eng.generate({1: p}, max_new_tokens=n)[1]
    pe = eng.export_prefix(p)
    eng.prefix_cache.drop_all(eng.allocator)
    spills = eng.kvtier_cold_spills
    adopted = eng.import_prefix(pe)
    again = eng.export_prefix(p)
    eng.prefix_cache.drop_all(eng.allocator)
    second = eng.generate({2: p}, max_new_tokens=n)[2]
    assert_block_balance(eng)
    out = {"first": first, "second": second, "pages": _pages(pe),
           "n_pages": pe.n_pages, "spills": spills, "adopted": adopted,
           "bitwise": _same_pages(_pages(pe), _pages(again)),
           "readmits": eng.kvtier_cold_readmits, "checksum": pe.verify()}
    eng.stop_workers()
    return out


def tp_serving_job(rank: int, world: int, cases: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """Every case of tests/test_torch_tp_serving.py on this rank: the
    ragged engine over each flag set (``put`` logits, ``generate``
    streams, for MoE the routing digests), speculative decoding, the
    hand-offs and the prefix tier on the OPT set, and v1
    ``init_inference`` (tokens or MLM logits, dequantized shards; rank 0
    also the one-device engine's dequantized leaves). Workers return
    what they replayed."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import export_params
    from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                      RaggedInferenceEngine)
    from deepspeed_tpu_torch.parallel.mesh import Topology

    topo = Topology.build({"model": world})
    out: Dict[str, Any] = {"shards": {}}
    for name, case in cases.get("ragged", {}).items():
        model = _shard(case, topo)
        out["shards"][name] = export_params(model)
        routes, undo = _routing_log() if case["family"] == "moe" \
            else (None, None)
        eng = RaggedInferenceEngine(
            model, RaggedConfig(dtype=torch.float32, **case["cfg"]),
            device="cpu", topology=topo)
        if not eng.is_controller:
            out[name] = eng.serve_worker()
        else:
            out[name] = {
                "rows": drive_puts(eng, case["prompts"], case["n_decode"]),
                "streams": eng.generate(dict(case["prompts"]),
                                        max_new_tokens=case["new"])}
            if "spec" in case:
                spec = case["spec"]
                out[name]["spec"] = eng.generate_speculative(
                    dict(spec["prompts"]), max_new_tokens=case["new"],
                    ngram=2, lookahead=3)
                out[name]["spec_stats"] = dict(eng.spec_stats)
                uids = list(spec["prompts"])
                rows = eng.put(uids, list(spec["prompts"].values()))
                toks = [[int(np.argmax(r))] for r in rows]
                o, verified = eng.put_spec(uids, toks, spec["drafts"])
                out[name]["put_spec"] = {
                    "out": o, "verified": {u: (c, np.asarray(r)) for u, (c, r)
                                           in verified.items()}}
                eng.flush(uids)
            eng.stop_workers()
        if routes is not None:
            undo()
            out[name + "_routes"] = routes
        if "handoff" in case:
            for pool in ("fp32", "bf16", "int8"):
                out[f"handoff_{pool}"] = _handoffs(case, topo, pool)
        if "prefix" in case:
            out["prefix"] = _prefix_tier(case, topo)
    for name, case in cases.get("v1", {}).items():
        # an unsharded model (the engine cuts it) or one cut first: either
        # way each leaf is gathered for the quantize
        model = _shard(case, topo) if case.get("cut") else _full(case)
        eng = dst.init_inference(model, case["engine"], device="cpu")
        res: Dict[str, Any] = {}
        if case.get("forward"):
            res["logits"] = _np(eng.forward(case["ids"]))
        else:
            res["ids"] = eng.generate(case["ids"],
                                      max_new_tokens=case["new"])
        res["deq"] = {n: _np(eng._leaf(n)) for n in eng._wq_shapes}
        res["blocks"] = dict(eng._wq_blocks)
        if rank == 0 and eng._wq_shapes:
            one = dst.init_inference(_full(case), {
                **case["engine"], "tensor_parallel": 1}, device="cpu")
            res["deq_tp1"] = {n: _np(one._leaf(n)) for n in one._wq_shapes}
        out[f"v1_{name}"] = res
    return out


# ----------------------------------------------------------------------
# jobs of tests/test_torch_tp_train.py

def _train_model(case: Dict[str, Any]):
    """A full-width port model of ``case`` (``family`` dense / moe /
    clip, its config kwargs) carrying ``case["params"]`` (the JAX
    layout)."""
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
    from deepspeed_tpu_torch.models import clip
    from deepspeed_tpu_torch.models.moe import (MoETransformer,
                                                MoETransformerConfig)
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)

    kw = case["config"]
    if case["family"] == "clip":
        model = clip.CLIP(clip.CLIPConfig(
            clip.clip_text_config(**kw["text"]),
            clip.clip_vision_config(**kw["vision"]), **kw["pixels"]),
            device="cpu")
    elif case["family"] == "moe":
        model = MoETransformer(MoETransformerConfig(**kw), device="cpu")
    else:
        model = Transformer(TransformerConfig(**kw), device="cpu")
    return load_jax_params(model, case["params"])


def tp_train_job(rank: int, world: int, cases: Dict[str, Any],
                 mesh: Dict[str, int]) -> Dict[str, Any]:
    """Each case of tests/test_torch_tp_train.py through ``initialize``
    over ``mesh``: the full-width model cut by ``initialize``, three
    ``train_batch`` steps on the global batches (every rank passes the
    same), each step's metrics, this rank's masters, ``eval_batch`` of
    the first batch after the steps, and on rank 0 the
    masters gathered to full width (as the JAX tree, ``export_params``)
    with the smallest and largest |g| of each element that the optimizer
    received. A case with ``plant`` = (rank, step)
    sets one element of that rank's first cut leaf's gradient to inf at
    that step."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import export_params
    from deepspeed_tpu_torch.runtime import optimizers as opt

    out = {}
    for name, case in cases.items():
        model = _train_model(case)
        eng, *_ = dst.initialize(model=model,
                                 config={**case["cfg"], "mesh": mesh},
                                 device="cpu")
        lo: Dict[str, torch.Tensor] = {}
        hi: Dict[str, torch.Tensor] = {}
        inner = eng.optimizer

        def update(grads, state, params, lo=lo, hi=hi, inner=inner):
            for n, g in grads.items():
                a = g.abs()
                lo[n] = torch.minimum(lo[n], a) if n in lo else a.clone()
                hi[n] = torch.maximum(hi[n], a) if n in hi else a.clone()
            return inner.update(grads, state, params)

        eng.optimizer = opt.Transform(inner.init, update)
        plant = case.get("plant")
        if plant is not None and plant[0] == rank:
            leaf = sorted(eng.tp_sharded)[0]
            plain = eng._loss_and_grads

            def planted(batch, scale, plain=plain, leaf=leaf):
                g, loss = plain(batch, scale)
                if eng.global_steps == plant[1]:
                    g[leaf].view(-1)[0] = float("inf")
                return g, loss

            eng._loss_and_grads = planted
        steps = []
        for batch in case["batches"]:
            m = eng.train_batch({k: torch.from_numpy(np.asarray(v))
                                 for k, v in batch.items()})
            steps.append({k: float(v) for k, v in m.items()})
        res = {"steps": steps, "sharded": sorted(eng.tp_sharded),
               "local": {n: _np(p) for n, p in eng.params.items()},
               "eval": float(eng.eval_batch(case["batches"][0]))}
        full = export_params(eng.full_params())      # the JAX layout
        lo_full, hi_full = eng.full_width(lo), eng.full_width(hi)
        if rank == 0:
            res.update(full=full, lo={n: _np(t) for n, t in lo_full.items()},
                       hi={n: _np(t) for n, t in hi_full.items()})
        out[name] = res
    return out


def tp_card_job(rank: int, world: int, device: str, bf16: bool
                ) -> Dict[str, Any]:
    """tests/test_torch_tp_train_gpu.py: a 2-layer Llama (hd 64) made on
    the host from seed 0, moved to ``device`` and trained 3 steps through
    ``initialize`` at TP ``world`` (fp32, or bf16 on fp32 masters); the
    steps and, on the card, the flash wrappers' launch counts."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    model = card_model().to(device)
    eng, *_ = dst.initialize(model=model, config=card_config(world, bf16),
                             device=device)
    wrappers = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    for w in wrappers:
        w.launches = w.wgmma_launches = 0
    ids = torch.from_numpy(card_tokens()).to(device)
    steps = [{k: float(v) for k, v in eng.train_batch(
        {"input_ids": ids}).items()} for _ in range(3)]
    return {"steps": steps,
            "launches": [(w.launches, w.wgmma_launches) for w in wrappers]}


def card_model():
    from deepspeed_tpu_torch.models.llama import Llama

    return Llama("tiny", device="cpu", seed=0, n_layers=2, d_model=256,
                 n_heads=4, n_kv_heads=2, vocab_size=512, max_seq_len=128)


def card_config(tp: int, bf16: bool) -> Dict[str, Any]:
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    if tp > 1:
        cfg["mesh"] = {"model": tp}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def card_tokens() -> np.ndarray:
    return np.random.default_rng(3).integers(0, 512, (4, 128))


# ----------------------------------------------------------------------
# jobs of tests/test_torch_zero.py and tests/test_torch_zero_gpu.py

def _ledger_counts() -> Dict[str, float]:
    from deepspeed_tpu_torch.comm import comm

    return {op: v["count"] for op, v in
            comm.get_comms_logger().snapshot_totals().items()}


def zero_train_job(rank: int, world: int, cases: Dict[str, Any],
                   runs: Dict[str, Any]) -> Dict[str, Any]:
    """tests/test_torch_zero.py: each run ``runs[key] = (case name, ZeRO
    config overrides)`` through ``initialize`` over ``{"data": world}``:
    three ``train_batch`` steps on the case's global batches, each step's
    metrics, ``eval_batch`` of the first batch, and of the same batch on
    a stage-0 engine over the same ranks that starts from the run's
    trained masters, the comms ledger's counts of the steps, the shapes
    of this rank's masters and moments, a digest of the masters whole on
    every rank, and on rank 0 the masters gathered whole (the JAX layout,
    ``export_params`` where the case is a port model) with the smallest
    and largest |g| of each element that the optimizer received,
    gathered whole. A case with ``loss_fn`` (a ``SequentialBlockModel``'s)
    trains that custom loss."""
    import hashlib

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import export_params
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.parallel.zero import SequentialBlockModel
    from deepspeed_tpu_torch.runtime import optimizers as opt

    def engine(case, cfg, params=None):
        if case["family"] != "blocks":
            return dst.initialize(model=_train_model(case), config=cfg,
                                  params=params, device="cpu")[0]
        model = SequentialBlockModel(case["dims"], seed=2, device="cpu")
        params = params or dict(model.named_parameters())
        if case.get("custom_loss"):
            return dst.initialize(
                loss_fn=lambda p, b, m=model: m.loss(b, params=p),
                params=params, config=cfg, device="cpu")[0]
        return dst.initialize(model=model, params=params, config=cfg,
                              device="cpu")[0]

    out = {}
    for key, (name, zero) in runs.items():
        case = cases[name]
        base = {**case["cfg"], "mesh": {"data": world}}
        cfg = {**base, "zero_optimization": dict(
            zero.get("zero_optimization", {}))}
        cfg.update({k: v for k, v in zero.items()
                    if k != "zero_optimization"})
        comm.configure_comms_logger(True)
        comm.get_comms_logger().reset()
        eng = engine(case, cfg)
        lo: Dict[str, torch.Tensor] = {}
        hi: Dict[str, torch.Tensor] = {}
        inner = eng.optimizer

        def update(grads, state, params, lo=lo, hi=hi, inner=inner):
            for n, g in grads.items():
                a = g.abs()
                lo[n] = torch.minimum(lo[n], a) if n in lo else a.clone()
                hi[n] = torch.maximum(hi[n], a) if n in hi else a.clone()
            return inner.update(grads, state, params)

        eng.optimizer = opt.Transform(inner.init, update)
        steps = []
        for batch in case["batches"]:
            m = eng.train_batch({k: torch.from_numpy(np.asarray(v))
                                 for k, v in batch.items()})
            steps.append({k: float(v) for k, v in m.items()})
        ledger = _ledger_counts()
        comm.configure_comms_logger(False)
        whole = sorted(n for n, p in eng.params.items()
                       if tuple(p.shape) == eng.full_shapes[n])
        digest = hashlib.sha256(b"".join(
            eng.params[n].numpy().tobytes() for n in whole)).hexdigest()
        res = {"steps": steps, "ledger": ledger, "route": eng._route,
               "eval": float(eng.eval_batch(case["batches"][0])),
               "shapes": {n: tuple(p.shape) for n, p in eng.params.items()},
               "moments": {n: tuple(t.shape)
                           for n, t in eng.opt_state.mu.items()},
               "whole": whole, "digest": digest}
        full = {n: p.detach() for n, p in eng.full_params().items()}
        lo_full, hi_full = eng.full_state(lo), eng.full_state(hi)
        res["eval_stage0"] = float(engine(
            case, {**base, "zero_optimization": {"stage": 0}},
            {n: p.clone() for n, p in full.items()}).eval_batch(
                case["batches"][0]))
        if rank == 0:
            res.update(
                full=({n: _np(p) for n, p in full.items()}
                      if case["family"] == "blocks" else export_params(full)),
                lo={n: _np(t) for n, t in lo_full.items()},
                hi={n: _np(t) for n, t in hi_full.items()})
        out[key] = res
    return out


def optimizer_layout_job(rank: int, world: int, case: Dict[str, Any],
                         runs: Dict[str, Any]) -> Dict[str, Any]:
    """tests/test_torch_optimizers.py: each run ``runs[key] = (mesh, ZeRO
    stage, optimizer block, compat)`` through ``initialize``: two steps on
    the case's global batches, by ``train_batch`` or, with ``compat``,
    by ``backward`` on each micro-batch and ``step``; each step's loss
    (the compat path's: the mean of its micro-batches' losses) and grad
    norm (None on the compat path) and, on rank 0, the masters gathered
    to full width."""
    import deepspeed_tpu_torch as dst

    out = {}
    for key, (mesh, stage, optimizer, compat) in runs.items():
        cfg = {**case["cfg"], "mesh": mesh, "optimizer": optimizer,
               "zero_optimization": {"stage": stage}}
        model = _train_model(case)
        eng = dst.initialize(model=model, config=cfg, device="cpu")[0]
        gas = eng.gradient_accumulation_steps
        steps = []
        for b in case["batches"]:
            b = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            if compat:
                n = next(iter(b.values())).shape[0] // gas
                losses = []
                for i in range(gas):
                    losses.append(eng.backward(
                        {k: v[i * n:(i + 1) * n] for k, v in b.items()}))
                    eng.step()
                loss = sum(losses[1:], losses[0]) * (1.0 / gas)
                steps.append((float(loss), None, False))
                continue
            m = eng.train_batch(b)
            steps.append((float(m["loss"]), float(m["grad_norm"]),
                          bool(m["skipped"])))
        full = eng.full_params()
        res = {"steps": steps}
        if rank == 0:
            res["full"] = {n: _np(t).copy() for n, t in full.items()}
        out[key] = res
    return out


def zero_card_job(rank: int, world: int, device: str, runs: List[tuple]
                  ) -> List[Dict[str, Any]]:
    """tests/test_torch_zero_gpu.py: for each ``(stage, qgz)`` of
    ``runs``, the 2-layer Llama of :func:`card_model` on ``device``
    trained 3 steps through ``initialize`` at ZeRO ``stage`` over
    ``{"data": world}`` (fp32, or with ``qgz`` bf16 on fp32 masters with
    ``zero_quantized_gradients``): the steps, and the flash and quantizer
    wrappers' launch counts (which only the card's kernels move)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    qk = (quant.quantize_blockwise, quant.dequantize_blockwise)
    ids = torch.from_numpy(card_tokens()).to(device)
    out = []
    for stage, qgz in runs:
        cfg = card_config(1, qgz)
        cfg["mesh"] = {"data": world}
        cfg["zero_optimization"] = {"stage": stage,
                                    "stage3_param_persistence_threshold": 0,
                                    "zero_quantized_gradients": qgz}
        eng, *_ = dst.initialize(model=card_model().to(device), config=cfg,
                                 device=device)
        for w in wrappers:
            w.launches = w.wgmma_launches = 0
        for w in qk:
            w.launches = 0
        steps = [{k: float(v) for k, v in eng.train_batch(
            {"input_ids": ids}).items()} for _ in range(3)]
        out.append({"steps": steps,
                    "launches": [(w.launches, w.wgmma_launches)
                                 for w in wrappers],
                    "quant_launches": [w.launches for w in qk]})
    return out


# ----------------------------------------------------------------------
# jobs of tests/test_torch_checkpoint.py

def ckpt_job(rank: int, world: int, case: Dict[str, Any],
             runs: Dict[str, Any], root: str) -> Dict[str, Any]:
    """tests/test_torch_checkpoint.py: each run ``runs[key] = (mesh, ZeRO
    stage)`` through ``initialize``: two ``train_batch`` steps on the
    case's global batches, ``save_checkpoint(root/key, tag="t")``, then
    the remaining batches' losses; on rank 0 the masters and the AdamW
    moments at the save, gathered to full width."""
    import deepspeed_tpu_torch as dst

    out = {}
    for key, (mesh, stage) in runs.items():
        cfg = {**case["cfg"], "mesh": mesh,
               "zero_optimization": {"stage": stage}}
        eng = dst.initialize(model=_train_model(case), config=cfg,
                             device="cpu")[0]
        batches = [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
                   for b in case["batches"]]
        for b in batches[:2]:
            eng.train_batch(b)
        eng.save_checkpoint(os.path.join(root, key), tag="t")
        # copies now: a leaf kept whole is the master itself, which the
        # steps below update in place
        saved = {"full": eng.full_params(),
                 "mu": eng.full_width(eng.full_state(eng.opt_state.mu)),
                 "nu": eng.full_width(eng.full_state(eng.opt_state.nu))}
        saved = {k: {n: _np(t).copy() for n, t in v.items()}
                 for k, v in saved.items()}
        res = {"steps": [float(eng.train_batch(b)["loss"])
                         for b in batches[2:]]}
        if rank == 0:
            res.update(saved)
        out[key] = res
    return out


def hf_tp_job(rank: int, world: int, dirs: Dict[str, str],
              tokens: np.ndarray) -> Dict[str, Any]:
    """tests/test_torch_hf_checkpoint.py: each HF directory loaded with
    ``from_pretrained`` over ``{"model": world}`` (this rank's shards):
    the logits of ``tokens``, this rank's leaves, and the greedy stream
    of ``init_inference(config={"checkpoint": ...,
    "tensor_parallel": world})``."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.hf import from_pretrained
    from deepspeed_tpu_torch.parallel.mesh import Topology

    out = {}
    ids = torch.from_numpy(tokens).long()
    for key, d in dirs.items():
        topo = Topology.build({"model": world})
        model, params = from_pretrained(d, dtype=torch.float32,
                                        topology=topo, device="cpu")
        with torch.no_grad():
            logits = model.apply(ids)
        eng = dst.init_inference(config={"checkpoint": d, "dtype": "float32",
                                         "tensor_parallel": world},
                                 device="cpu")
        stream = eng.generate(ids[:1, :8], max_new_tokens=6)
        out[key] = {"logits": _np(logits),
                    "leaves": {n: _np(p) for n, p in params.items()},
                    "stream": np.asarray(stream)}
    return out


# ----------------------------------------------------------------------
# jobs of tests/test_torch_fault_tolerance.py

def _ft_loss(params, batch):
    p = batch["x"] @ params["w"] + params["b"]
    return ((p - batch["y"]) ** 2).mean()


def _ft_engine(world: int, root: str, resume: bool = False):
    import deepspeed_tpu_torch as dst

    cfg = {"train_batch_size": 16,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "mesh": {"data": world}, "zero_optimization": {"stage": 3},
           "checkpoint": {"save_dir": root, "auto_resume": resume},
           "steps_per_print": 1000}
    params = {"w": torch.ones(8, 4) * 0.1, "b": torch.zeros(4)}
    return dst.initialize(loss_fn=_ft_loss, params=params, config=cfg,
                          device="cpu")[0]


def _ft_batch(i: int) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(1000 + i)
    return {"x": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
            "y": torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))}


def preempt_job(rank: int, world: int, root: str, late_rank: int
                ) -> Dict[str, Any]:
    """SIGTERM reaches every rank entering step 2, except ``late_rank``,
    which it reaches entering step 3: a ZeRO-3 trainer over the data
    axis with a preemption guard, drained when it asks to stop. Then a
    fresh trainer auto-resumes from the save dir. Returns the stop
    reason, the steps taken, the gathered masters at the stop and after
    the resume, the resumed step, and how many tags this rank verified
    while resuming."""
    import signal

    from deepspeed_tpu_torch.resilience.preemption import PreemptionGuard
    from deepspeed_tpu_torch.runtime import checkpoint as ck

    eng = _ft_engine(world, root)
    at = 3 if rank == late_rank else 2

    def hook(engine, step):
        if step == at:
            os.kill(os.getpid(), signal.SIGTERM)

    eng.register_step_hook(hook)
    steps = 0
    with PreemptionGuard() as guard:
        eng.attach_preemption_guard(guard)
        for i in range(6):
            eng.train_batch(_ft_batch(i))
            steps += 1
            if eng.should_stop:
                break
    stopped = {n: _np(t) for n, t in eng.full_params().items()}
    verified = []
    orig = ck.verify_tag

    def counting(*a, **k):
        verified.append(a[0])
        return orig(*a, **k)

    ck.verify_tag = counting
    try:
        eng2 = _ft_engine(world, root, resume=True)
    finally:
        ck.verify_tag = orig
    return {"reason": eng.stop_reason, "steps": steps, "stopped": stopped,
            "resumed": eng2.global_steps, "verified": len(verified),
            "params": {n: _np(t) for n, t in eng2.full_params().items()}}


def offload_job(rank: int, world: int, case: Dict[str, Any],
                runs: Dict[str, Any]) -> Dict[str, Any]:
    """tests/test_torch_offload.py: each run ``runs[key] = ZeRO config``
    through ``initialize`` over ``{"data": world}``: three ``train_batch``
    steps on the case's global batches, each step's metrics, where the
    masters and moments lie between steps, a digest of this rank's
    masters and moments (the offloaded runs against the resident ones,
    bitwise), and on rank 0 the masters gathered whole (the JAX layout)
    with the smallest |g| of each element that the optimizer received,
    gathered whole."""
    import hashlib

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.jax_params import export_params
    from deepspeed_tpu_torch.runtime import optimizers as opt

    out = {}
    for key, zero in runs.items():
        cfg = {**case["cfg"], "mesh": {"data": world},
               "zero_optimization": zero}
        eng = dst.initialize(model=_train_model(case), config=cfg,
                             device="cpu")[0]
        lo: Dict[str, torch.Tensor] = {}
        hi: Dict[str, float] = {}
        inner = eng.optimizer

        def update(grads, state, params, lo=lo, hi=hi, inner=inner):
            for n, g in grads.items():
                a = g.abs()
                lo[n] = torch.minimum(lo[n], a) if n in lo else a.clone()
                hi[n] = max(hi.get(n, 0.0), float(a.max()))
            return inner.update(grads, state, params)

        eng.optimizer = opt.Transform(inner.init, update,
                                      separable=inner.separable)
        steps = []
        for batch in case["batches"]:
            m = eng.train_batch({k: torch.from_numpy(np.asarray(v))
                                 for k, v in batch.items()})
            steps.append({k: float(v) for k, v in m.items()})
        masters = eng._materialized_params()
        mu = eng._opt_store.read("mu") if eng._opt_store is not None \
            else eng.opt_state.mu
        digest = hashlib.sha256(b"".join(
            t.numpy().tobytes() for tree in (masters, mu)
            for t in tree.values())).hexdigest()
        res = {"steps": steps, "digest": digest,
               "parked": eng.params is None or all(
                   p is eng._param_store.host("")[n]
                   for n, p in eng.params.items())
               if eng._param_store is not None else None,
               "eligible": eng.train_steps_eligible()}
        full = {n: p.detach() for n, p in eng.full_params().items()}
        lo_full = eng.full_state(lo)
        if rank == 0:
            res.update(full=export_params(full),
                       lo={n: _np(t) for n, t in lo_full.items()}, hi=hi)
        out[key] = res
    return out
