"""Fault tolerance of the port's trainer and launcher, held to the JAX
package: the preemption drain (SIGTERM at step k, the emergency
checkpoint, resume), the divergence guards (NaN skip, spike rollback,
the rollback loop's halt, NaN halt), no extra host sync with every guard
off, and the elastic agent (``launcher/agent.py``) with short worker
subprocesses. Each scenario runs on both packages where the JAX suite
has it, with the same outcome.
"""

import json
import os
import random
import signal
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as tdst
from deepspeed_tpu.launcher import agent as jagent
from deepspeed_tpu.resilience import chaos as jchaos
from deepspeed_tpu.resilience import divergence as jdiv
from deepspeed_tpu.resilience import preemption as jpre
from deepspeed_tpu.runtime import checkpoint as jck
from deepspeed_tpu_torch.launcher import agent as tagent
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.resilience import divergence as tdiv
from deepspeed_tpu_torch.resilience import preemption as tpre
from deepspeed_tpu_torch.runtime import checkpoint as tck

import torch_ranks


@pytest.fixture(autouse=True)
def _no_injectors():
    yield
    jchaos.install_fault_injector(None)
    tchaos.install_fault_injector(None)


def _batch(i, scale=1.0):
    rng = np.random.default_rng(1000 + i)
    return {"x": rng.normal(size=(16, 8)).astype(np.float32),
            "y": rng.normal(size=(16, 4)).astype(np.float32),
            "scale": np.full((16,), scale, np.float32)}


def _jax_loss(params, batch, rng):
    p = batch["x"] @ params["w"] + params["b"]
    return ((p - batch["y"]) ** 2).mean() * batch["scale"][0]


def _torch_loss(params, batch):
    p = batch["x"] @ params["w"] + params["b"]
    return ((p - batch["y"]) ** 2).mean() * batch["scale"][0]


class Side:
    """One package: its engine, checkpoint module, guard classes and
    telemetry registry."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.ck = jck if jax_side else tck
        self.div = jdiv if jax_side else tdiv
        self.pre = jpre if jax_side else tpre

    def engine(self, extra=None):
        cfg = {"train_batch_size": 16,
               "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
               "steps_per_print": 1000, **(extra or {})}
        if self.name == "jax":
            import jax.numpy as jnp
            params = {"w": jnp.ones((8, 4), jnp.float32) * 0.1,
                      "b": jnp.zeros((4,), jnp.float32)}
            return jdst.initialize(loss_fn=_jax_loss, params=params,
                                   config=cfg)[0]
        params = {"w": torch.ones(8, 4) * 0.1, "b": torch.zeros(4)}
        return tdst.initialize(loss_fn=_torch_loss, params=params,
                               config=cfg, device="cpu")[0]

    def params(self, e):
        return {k: np.array(v) for k, v in e.params.items()}

    def counter(self, name):
        if self.name == "jax":
            from deepspeed_tpu.telemetry.registry import get_registry
        else:
            from deepspeed_tpu_torch.telemetry.registry import get_registry
        return get_registry().counter(name).value


SIDES = [Side("jax"), Side("torch")]
IDS = ["jax", "torch"]


def _both(fn, tmp_path):
    out = []
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        out.append(fn(side, str(d)))
    return out


# ----------------------------------------------------------------------
# preemption drain + emergency checkpoint

def _sigterm(side, d):
    e = side.engine({"checkpoint": {"save_dir": d},
                     "resilience": {"chaos": {"enabled": True,
                                              "sigterm_at_step": 2}}})
    before = side.counter("resilience/emergency_saves")
    with side.pre.PreemptionGuard() as guard:
        e.attach_preemption_guard(guard)
        steps = 0
        for i in range(8):
            e.train_batch(_batch(i))
            steps += 1
            if e.should_stop:
                break
    found = side.ck.find_valid_tag(d)
    e2 = side.engine({"checkpoint": {"save_dir": d, "auto_resume": True}})
    return {"reason": e.stop_reason, "steps": steps, "found": found,
            "ok": side.ck.verify_tag(os.path.join(d, found))[0],
            "saves": side.counter("resilience/emergency_saves") - before,
            "resumed": e2.global_steps}


def test_sigterm_at_step_k_emergency_checkpoint_and_resume(tmp_path):
    """SIGTERM raised entering step 2: that step completes, the boundary
    saves an emergency tag at step 3, the loop drains, and a fresh
    engine resumes there."""
    j, t = _both(_sigterm, tmp_path)
    assert j == t == {"reason": "preempted", "steps": 3,
                      "found": "global_step3", "ok": True, "saves": 1,
                      "resumed": 3}


# ----------------------------------------------------------------------
# divergence guards

def _nan_skip(side, d):
    e = side.engine({"resilience": {"divergence": {"nan_action": "skip"}}})
    guarded = (e._divergence is not None, e._ft_active)
    e.train_batch(_batch(0))
    before = side.params(e)
    m = e.train_batch(_batch(1, scale=np.nan))
    after = side.params(e)
    same = all(np.array_equal(before[k], after[k]) for k in before)
    nxt = float(e.train_batch(_batch(2))["loss"])
    return {"guarded": guarded, "skipped": bool(m["skipped"]),
            "kept": same, "finite": bool(np.isfinite(nxt))}


def test_nan_guard_skip_keeps_params(tmp_path):
    j, t = _both(_nan_skip, tmp_path)
    assert j == t == {"guarded": (False, False), "skipped": True,
                      "kept": True, "finite": True}


def _spike_rollback(side, d):
    e = side.engine({"checkpoint": {"save_dir": d, "save_interval": 1,
                                    "keep_last_n": 2},
                     "resilience": {"divergence": {
                         "spike_action": "rollback", "spike_factor": 5.0,
                         "warmup_steps": 2, "window": 8}}})
    spikes = side.counter("resilience/divergence/spike")
    rollbacks = side.counter("resilience/rollbacks")
    for i in range(4):
        e.train_batch(_batch(i))
    e.train_batch(_batch(4, scale=500.0))   # loss explodes -> rollback
    step = e.global_steps
    nxt = float(e.train_batch(_batch(5))["loss"])
    return {"step": step, "finite": bool(np.isfinite(nxt)),
            "spikes": side.counter("resilience/divergence/spike") - spikes,
            "rollbacks": side.counter("resilience/rollbacks") - rollbacks}


def test_spike_guard_rolls_back_to_last_checkpoint(tmp_path):
    j, t = _both(_spike_rollback, tmp_path)
    assert j == t == {"step": 4, "finite": True, "spikes": 1,
                      "rollbacks": 1}


def _rollback_loop(side, d):
    e = side.engine({"checkpoint": {"save_dir": d, "save_interval": 1,
                                    "keep_last_n": 2},
                     "resilience": {"divergence": {"nan_action": "rollback",
                                                   "max_rollbacks": 2}}})
    for i in range(3):
        e.train_batch(_batch(i))
    steps = []
    for _ in range(2):
        e.train_batch(_batch(3, scale=np.nan))
        steps.append(e.global_steps)
    with pytest.raises(side.div.DivergenceError, match="rollback"):
        e.train_batch(_batch(3, scale=np.nan))
    return {"steps": steps, "reason": e.stop_reason}


def test_rollback_loop_escalates_to_halt(tmp_path):
    j, t = _both(_rollback_loop, tmp_path)
    assert j == t == {"steps": [3, 3],
                      "reason": "divergence:nan:rollback-loop"}


def _nan_halt(side, d):
    e = side.engine({"resilience": {"divergence": {"nan_action": "halt"}}})
    e.train_batch(_batch(0))
    with pytest.raises(side.div.DivergenceError):
        e.train_batch(_batch(1, scale=np.nan))
    return {"reason": e.stop_reason, "stop": e.should_stop}


def test_nan_guard_halt_raises(tmp_path):
    j, t = _both(_nan_halt, tmp_path)
    assert j == t == {"reason": "divergence:nan", "stop": True}


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_zero_extra_host_syncs_when_guards_disabled(side, monkeypatch):
    e = side.engine()
    assert e._divergence is None and not e._ft_active
    assert e.preemption_guard is None

    def boom(*a, **k):
        raise AssertionError("_after_step must not run with guards off")

    monkeypatch.setattr(e, "_after_step", boom)
    assert np.isfinite(float(e.train_batch(_batch(0))["loss"]))


def test_port_step_reads_nothing_back_with_guards_off(monkeypatch):
    """With every guard off (fp32) the port's step converts no device
    tensor to a Python number: ``Tensor.item`` and ``__bool__`` /
    ``__float__`` of a tensor never run inside ``train_batch``."""
    e = SIDES[1].engine()
    calls = []
    for name in ("item", "__bool__", "__float__", "__int__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    e.train_batch(_batch(0))
    monkeypatch.undo()
    assert calls == []


def test_checkpoint_and_resilience_blocks_match_jax():
    """The ``checkpoint`` and ``resilience`` blocks parse to the JAX
    package's values, field for field, on every field the port reads."""
    from deepspeed_tpu.config import Config as JConfig
    from deepspeed_tpu_torch.config import Config as TConfig

    d = {"train_batch_size": 16,
         "checkpoint": {"save_dir": "ck", "tag_validation": "fail",
                        "async_save": True, "save_interval": 3,
                        "keep_last_n": 2, "verify_checksums": False,
                        "auto_resume": True},
         "resilience": {"divergence": {"nan_action": "Rollback",
                                       "spike_action": "warn",
                                       "spike_factor": 4.0, "window": 7,
                                       "warmup_steps": 1,
                                       "max_rollbacks": 3},
                        "chaos": {"enabled": True, "seed": 3,
                                  "sigterm_at_step": 5}}}
    j, t = JConfig.from_dict(d), TConfig.from_dict(d)
    assert vars(t.checkpoint) == {k: getattr(j.checkpoint, k)
                                  for k in vars(t.checkpoint)}
    assert vars(j.resilience.divergence) == vars(t.resilience.divergence)
    assert vars(j.resilience.chaos) == vars(t.resilience.chaos)
    assert t.resilience.divergence.wants_host_check


@pytest.mark.parametrize("key,value", [("use_node_local_storage", True),
                                       ("parallel_write",
                                        {"pipeline_stage": True})])
def test_checkpoint_keys_the_port_does_not_read_warn(monkeypatch, key,
                                                     value):
    """A ``checkpoint`` key the port reads nowhere is not parsed into a
    field: it warns as unknown and is ignored."""
    from deepspeed_tpu_torch import config as config_mod

    warned = []
    monkeypatch.setattr(config_mod.logger, "warning", warned.append)
    cfg = config_mod.Config.from_dict({"train_batch_size": 16,
                                       "checkpoint": {key: value,
                                                      "keep_last_n": 2}})
    assert cfg.checkpoint.keep_last_n == 2
    assert not hasattr(cfg.checkpoint, key)
    assert len(warned) == 1 and f"'{key}'" in warned[0]


@pytest.mark.parametrize("block", [
    {"checkpoint": {"save_interval": -1}},
    {"checkpoint": {"keep_last_n": -2}},
    {"resilience": {"divergence": {"nan_action": "explode"}}},
    {"resilience": {"divergence": {"spike_action": "rollback",
                                   "spike_factor": 1.0}}},
    {"resilience": {"divergence": {"max_rollbacks": 0}}},
])
def test_bad_blocks_raise_in_both(block):
    from deepspeed_tpu.config import ConfigError as JErr
    from deepspeed_tpu.config import Config as JConfig
    from deepspeed_tpu_torch.config import Config as TConfig
    from deepspeed_tpu_torch.config import ConfigError as TErr

    with pytest.raises(JErr):
        JConfig.from_dict({"train_batch_size": 16, **block})
    with pytest.raises(TErr):
        TConfig.from_dict({"train_batch_size": 16, **block})


def test_guard_classes_agree():
    """The DivergenceGuard of both packages judges one loss stream the
    same way."""
    stream = [1.0, 1.1, 0.9, 1.0, 1.05, 30.0, 1.0, float("nan"), 1.0]
    got = []
    for div in (jdiv, tdiv):
        g = div.DivergenceGuard(nan_action="rollback", spike_action="warn",
                                spike_factor=5.0, window=4, warmup_steps=2)
        got.append([g.observe(i, x) for i, x in enumerate(stream)])
    assert got[0] == got[1]
    assert ("spike", "warn") in got[1] and ("nan", "rollback") in got[1]


# ----------------------------------------------------------------------
# elastic agent

def _worker(tmp_path, body):
    script = tmp_path / "worker.py"
    script.write_text(body)
    return [sys.executable, str(script)]


AGENTS = [jagent, tagent]


def _backoff_run(tmp_path, mod):
    """The JAX suite's backoff scenario: its checks, and the delays."""
    marker = tmp_path / "attempts"
    cmd = _worker(tmp_path,
                  "import os, sys\n"
                  f"p = {str(marker)!r}\n"
                  "n = int(open(p).read()) if os.path.exists(p) else 0\n"
                  "open(p, 'w').write(str(n + 1))\n"
                  "sys.exit(0 if n >= 2 else 7)\n")
    hb = str(tmp_path / "heartbeat.json")
    delays, seen = [], []

    def fake_sleep(d):
        delays.append(d)
        with open(hb) as f:
            seen.append(json.load(f))

    report = mod.ElasticAgent(cmd, max_restarts=3, backoff_s=0.01,
                              backoff_multiplier=2.0, jitter=0.5,
                              heartbeat_path=hb, sleep=fake_sleep,
                              rng=random.Random(0)).run()
    assert report.succeeded and report.restarts == 2
    assert report.reasons == ["exit:7", "exit:7"]
    assert len(delays) == 2
    assert 0.01 <= delays[0] <= 0.015 and 0.02 <= delays[1] <= 0.03
    assert [s["state"] for s in seen] == ["restarting", "restarting"]
    assert seen[0]["reason"] == "exit:7"
    with open(hb) as f:
        assert json.load(f)["state"] == "done"
    return delays


@pytest.mark.parametrize("mod", AGENTS, ids=IDS)
def test_agent_backoff_reasons_and_heartbeat(tmp_path, mod):
    _backoff_run(tmp_path, mod)


def test_agents_back_off_alike(tmp_path):
    """Both agents draw the same jittered delays from one seed."""
    got = []
    for mod in AGENTS:
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        got.append(_backoff_run(d, mod))
    assert got[0] == got[1]


@pytest.mark.parametrize("mod", AGENTS, ids=IDS)
def test_classify_exit_taxonomy(mod):
    assert mod.classify_exit(7) == "exit:7"
    assert mod.classify_exit(-int(signal.SIGKILL)) == "signal:SIGKILL"
    assert mod.classify_exit(mod.PLANNED_ROLLOUT_EXIT) == "planned:rollout"
    assert mod.classify_exit(mod.PLANNED_ROLLOUT_EXIT,
                             planned_codes=()) == "exit:86"


@pytest.mark.parametrize("mod", AGENTS, ids=IDS)
def test_agent_planned_rollout_restart_is_free(tmp_path, mod):
    log = tmp_path / "launches"
    cmd = _worker(tmp_path,
                  "import os, sys\n"
                  f"p = {str(log)!r}\n"
                  "n = int(os.environ['DST_ELASTIC_RESTART'])\n"
                  "open(p, 'a').write(str(n) + '\\n')\n"
                  f"sys.exit(0 if n >= 2 else {mod.PLANNED_ROLLOUT_EXIT})\n")

    def no_sleep(d):
        raise AssertionError(f"planned reload slept {d}s")

    report = mod.ElasticAgent(cmd, max_restarts=0, sleep=no_sleep).run()
    assert report.succeeded and report.restarts == 0
    assert report.planned_restarts == 2
    assert report.reasons == ["planned:rollout", "planned:rollout"]
    assert log.read_text().split() == ["0", "1", "2"]


@pytest.mark.parametrize("mod", AGENTS, ids=IDS)
def test_agent_planned_cap_falls_through_to_failure(tmp_path, mod):
    cmd = _worker(tmp_path,
                  f"import sys; sys.exit({mod.PLANNED_ROLLOUT_EXIT})\n")
    delays = []
    report = mod.ElasticAgent(cmd, max_restarts=1, backoff_s=0.01,
                              max_planned_restarts=2, sleep=delays.append,
                              rng=random.Random(0)).run()
    assert not report.succeeded
    assert report.returncode == mod.PLANNED_ROLLOUT_EXIT
    assert report.planned_restarts == 2 and report.restarts == 1
    assert len(delays) == 1


@pytest.mark.parametrize("mod", AGENTS, ids=IDS)
def test_agent_heartbeat_marks_planned_window(tmp_path, mod):
    hb = str(tmp_path / "hb.json")
    agent = mod.ElasticAgent(["true"], heartbeat_path=hb)
    agent._write_status("restarting", 0, reason="planned:rollout",
                        next_delay_s=0.0)
    with open(hb) as f:
        rec = json.load(f)
    assert rec["planned"] is True and rec["next_delay_s"] == 0.0
    agent._write_status("restarting", 1, reason="exit:7", next_delay_s=0.5)
    with open(hb) as f:
        assert "planned" not in json.load(f)


@pytest.mark.parametrize("mod", AGENTS, ids=IDS)
def test_elastic_agent_restarts_until_success(tmp_path, mod):
    marker = tmp_path / "attempts"
    cmd = _worker(tmp_path,
                  "import os, sys\n"
                  f"p = {str(marker)!r}\n"
                  "n = int(open(p).read()) if os.path.exists(p) else 0\n"
                  "open(p, 'w').write(str(n + 1))\n"
                  "assert os.environ['DST_ELASTIC_RESTART'] == str(n)\n"
                  "sys.exit(0 if n >= 2 else 1)\n")
    report = mod.ElasticAgent(cmd, max_restarts=3, backoff_s=0.0).run()
    assert report.succeeded and report.restarts == 2
    assert report.history == [1, 1, 0]


@pytest.mark.parametrize("mod", AGENTS, ids=IDS)
def test_elastic_agent_gives_up(tmp_path, mod):
    cmd = _worker(tmp_path, "import sys; sys.exit(7)\n")
    report = mod.ElasticAgent(cmd, max_restarts=2, backoff_s=0.0).run()
    assert not report.succeeded
    assert report.returncode == 7 and len(report.history) == 3


def test_agent_cli_restarts_a_resuming_trainer(tmp_path):
    """``python -m deepspeed_tpu_torch.launcher.agent -- trainer``: the
    trainer dies after its first save; the agent restarts it, and the
    restart resumes from the tag (``DST_ELASTIC_RESTART`` = 1) and
    finishes."""
    d = str(tmp_path / "ck")
    out = tmp_path / "out.json"
    cmd = _worker(tmp_path, f"""
import json, os, sys
import numpy as np, torch
import deepspeed_tpu_torch as dst

def loss(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean()

cfg = {{"train_batch_size": 4, "steps_per_print": 1000,
        "optimizer": {{"type": "adamw", "params": {{"lr": 1e-2}}}},
        "checkpoint": {{"save_dir": {d!r}, "save_interval": 2,
                        "auto_resume": True}}}}
e = dst.initialize(loss_fn=loss, params={{"w": torch.zeros(3, 2)}},
                   config=cfg, device="cpu")[0]
start = e.global_steps
g = np.random.default_rng(0)
while e.global_steps < 4:
    e.train_batch({{"x": g.normal(size=(4, 3)).astype(np.float32),
                    "y": g.normal(size=(4, 2)).astype(np.float32)}})
    if e.global_steps == 2 and os.environ["DST_ELASTIC_RESTART"] == "0":
        sys.exit(3)
json.dump({{"start": start, "end": e.global_steps,
           "restart": os.environ["DST_ELASTIC_RESTART"]}},
          open({str(out)!r}, "w"))
""")
    env = {**os.environ, "PYTHONPATH": os.getcwd()}
    rc = tagent.ElasticAgent(cmd, max_restarts=2, backoff_s=0.0,
                             env=env).run()
    assert rc.succeeded and rc.reasons == ["exit:3"]
    assert json.loads(out.read_text()) == {"start": 2, "end": 4,
                                           "restart": "1"}


def test_preemption_agreed_over_ranks_when_sigterm_is_late_on_one(tmp_path):
    """ZeRO-3 over 2 gloo ranks, SIGTERM entering step 2 on rank 0 and a
    step later on rank 1: the ranks agree on the stop at the first
    boundary, save one emergency tag together and drain after the same
    step; a fresh pair resumes from it with rank 0 alone verifying the
    tag, to the masters the ranks stopped with."""
    root = str(tmp_path / "ck")
    res = torch_ranks.start_ranks(2, "preempt_job", root, 1,
                                  timeout=120).results()
    assert [r["reason"] for r in res] == ["preempted", "preempted"]
    assert [r["steps"] for r in res] == [3, 3]
    assert tck.list_tags(root) == ["global_step3"]
    assert tck.verify_tag(os.path.join(root, "global_step3"))[0]
    assert [r["resumed"] for r in res] == [3, 3]
    assert res[0]["verified"] >= 1 and res[1]["verified"] == 0
    for r in res:
        for n, v in res[0]["stopped"].items():
            np.testing.assert_array_equal(r["stopped"][n], v)
            np.testing.assert_array_equal(r["params"][n], v)
