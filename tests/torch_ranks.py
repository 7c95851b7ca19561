"""Rank processes for the port's multi-rank tests, on the CPU over gloo.

:func:`start_ranks` spawns one process per rank (``torch.multiprocessing``,
spawn) that joins a gloo group on a free localhost port, runs one job of
this module with one thread, and sends back what the job returns (numpy
arrays and plain values). Nothing here imports JAX: the JAX side of each
test runs in the pytest process while the ranks run. :meth:`Ranks.results`
waits for all ranks within a deadline and kills every child when one
fails or time runs out.
"""

from __future__ import annotations

import importlib
import queue as queue_mod
import socket
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


def _entry(rank: int, world: int, port: int, job: str, args: tuple,
           out) -> None:
    torch.set_num_threads(1)
    try:
        from deepspeed_tpu_torch.comm import comm

        comm.init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}",
                              world_size=world, rank=rank, timeout_s=120)
        fn = getattr(importlib.import_module(__name__), job)
        out.put((rank, "ok", fn(rank, world, *args)))
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
        for p in self.procs:
            p.start()
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
