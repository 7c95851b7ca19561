"""The CPU reference of a rank process must not depend on how its caller
launched it. Two callers that set different ``ATEN_CPU_CAPABILITY`` values
and thread counts run the same small fp32 ``SequentialBlockModel`` training
steps in subprocesses; through :mod:`deepspeed_tpu_torch.utils.cpu_pin`
(the helper ``chip_smoke.py`` pins its cpu ranks with) their losses are
equal bitwise, and without it they differ on this host's CPU — so the
test shows what the pin removes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

from deepspeed_tpu_torch.utils import cpu_pin

REPO = Path(__file__).resolve().parents[1]

# two train_batch steps of a 3-block fp32 model on a 256-row batch: wide
# enough that the reductions split over threads and take vector kernels
STEP = r"""
import json, sys
import torch
pinned = sys.argv[1] == "pinned"
threads = int(sys.argv[2])
from deepspeed_tpu_torch.utils import cpu_pin
if pinned:
    cpu_pin.pin_threads()
    got = cpu_pin.check_pinned()
else:
    torch.set_num_threads(threads)
    got = {"capability": torch.backends.cpu.get_cpu_capability()}
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.parallel.zero import SequentialBlockModel
g = torch.Generator().manual_seed(1)
dims = (128, 512, 512, 1024)
x = torch.randn(256, dims[0], generator=g)
y = torch.randn(256, dims[-1], generator=g)
eng, *_ = dst.initialize(
    model=SequentialBlockModel(dims, device="cpu"),
    config={"train_batch_size": 256,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}},
    device="cpu")
losses = [eng.train_batch({"x": x, "y": y})["loss"].item() for _ in range(2)]
print(json.dumps({"losses": losses, "run": got}))
"""

# what each caller sets before it starts the rank process
CALLERS = (("default", 1), ("avx2", 3))


def _run_all(jobs):
    procs = []
    for env, mode, threads in jobs:
        env = {**env, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", STEP, mode, str(threads)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr[-2000:]
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


def test_pinned_cpu_ranks_agree_bitwise_whatever_the_caller_set():
    jobs = []
    for cap, threads in CALLERS:
        caller = {**os.environ, "ATEN_CPU_CAPABILITY": cap,
                  "OMP_NUM_THREADS": str(threads)}
        jobs.append((cpu_pin.pinned_env(caller), "pinned", threads))
        jobs.append((caller, "unpinned", threads))
    pinned_a, free_a, pinned_b, free_b = _run_all(jobs)
    # the pin: one capability, one MKL path, one thread count, one result
    assert pinned_a["run"] == pinned_b["run"] == {
        "capability": "AVX2", "mkl_cbwr": "COMPATIBLE",
        "threads": cpu_pin.PINNED_THREADS}
    assert pinned_a["losses"] == pinned_b["losses"]        # bitwise
    # without it the callers' settings reach the arithmetic
    assert free_a["run"]["capability"] == "DEFAULT"
    assert free_b["run"]["capability"] == "AVX2"
    assert free_a["losses"] != free_b["losses"]


def test_pinned_spawn_env_sets_and_restores(monkeypatch):
    monkeypatch.setenv("ATEN_CPU_CAPABILITY", "default")
    monkeypatch.delenv("MKL_CBWR", raising=False)
    with cpu_pin.pinned_spawn_env(3):
        assert os.environ["ATEN_CPU_CAPABILITY"] == "avx2"
        assert os.environ["MKL_CBWR"] == "COMPATIBLE"
        assert os.environ["OMP_NUM_THREADS"] == "3"
    assert os.environ["ATEN_CPU_CAPABILITY"] == "default"
    assert "MKL_CBWR" not in os.environ
    assert "avx2=" in cpu_pin.cpu_report()
