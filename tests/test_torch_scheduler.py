"""The port's host-side scheduler (``repro_torch.serve.scheduler``) over the
slot engine, against the engine's own admit/step loop and the reference's
``repro.serve.scheduler`` on the same requests.

smollm-135m smoke weights from the reference's init (bridged), served in
deploy mode; both engines take the same requests (prompt lengths 3-20,
buckets 8/16/32, slot reuse), so the greedy tokens must be identical.
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.context import QuantCtx as JQuantCtx
from repro.models import build_model as jbuild_model
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.context import QuantCtx
from repro_torch.models.model import build_model
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.scheduler import Request, Scheduler

torch.set_num_threads(2)

ENGINE_KW = dict(slots=3, max_len=32, prefill_group=2, kv_quant=True)
LENS = [5, 9, 12, 7, 3, 20, 14]
MAX_NEW = 6


@pytest.fixture(scope="module")
def lm():
    jmodel = jbuild_model(jget_smoke_config("smollm-135m"))
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(get_smoke_config("smollm-135m"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab, n).astype(np.int32)
               for n in LENS]
    return dict(jmodel=jmodel, jparams=jparams, model=model,
                params=bridge.params(jparams, "cpu"), prompts=prompts)


def _engine(lm):
    return ServeEngine(lm["model"], lm["params"], QuantCtx(mode="deploy"),
                       EngineConfig(**ENGINE_KW), device="cpu")


def _requests(lm, cls=Request, max_new=MAX_NEW):
    return [cls(rid=i, tokens=t, max_new=max_new)
            for i, t in enumerate(lm["prompts"])]


def _engine_loop(engine, requests):
    """FIFO admission into free slots (up to the prefill group), one decode
    step per round, without the scheduler."""
    backlog, out = [(r.rid, r.tokens, r.max_new) for r in requests], {}
    while backlog or engine.active:
        n = min(engine.cfg.prefill_group, len(engine.free_slots()), len(backlog))
        if n:
            for rid, tok in engine.admit(backlog[:n]):
                out.setdefault(rid, []).append(tok)
            backlog = backlog[n:]
        if engine.active:
            for rid, tok in engine.step():
                out[rid].append(tok)
    return out


def test_tokens_equal_the_engine_loop_and_the_reference(lm):
    with Scheduler(_engine(lm)) as sched:
        got = {rid: list(v) for rid, v in sched.run(_requests(lm)).items()}
    want = _engine_loop(_engine(lm), _requests(lm))
    jengine = JServeEngine(lm["jmodel"], lm["jparams"],
                           JQuantCtx(mode="deploy", backend="xla"),
                           JEngineConfig(**ENGINE_KW))
    with JScheduler(jengine) as jsched:
        jgot = {rid: list(v)
                for rid, v in jsched.run(_requests(lm, JRequest)).items()}
    assert got == want == jgot
    assert sorted(got) == list(range(len(LENS)))
    assert all(len(v) == MAX_NEW for v in got.values())


def test_stats_carry_prefill_latency_and_request_lifecycle(lm):
    engine = _engine(lm)
    with Scheduler(engine) as sched:
        sched.run(_requests(lm))
        st = sched.stats()
    n = len(LENS)
    assert sorted(st["prefill_us"]) == [b for b in engine.buckets
                                        if st["prefill_calls"][b]]
    assert sum(h["count"] for h in st["prefill_us"].values()) == \
        sum(st["prefill_calls"].values())
    assert all(h["p50"] > 0 for h in st["prefill_us"].values())
    rq = st["requests"]
    assert rq["admitted"] == rq["finished"] == n
    assert rq["ttft_us"]["count"] == rq["queue_wait_us"]["count"] == n
    assert rq["ttft_us"]["p50"] >= rq["queue_wait_us"]["p50"]
    assert rq["decode_step_us"]["count"] == st["decode_steps"]
    assert rq["occupancy"] == rq["backlog_depth"] == rq["detok_errors"] == 0
    assert st["tokens_emitted"] == n * MAX_NEW
    assert set(st["manifest"]) == {"git_sha", "schema_version"}


@pytest.mark.parametrize("fail_at", ["first", "last"])
def test_a_detokenize_error_is_reraised(lm, fail_at):
    """The callback raises on its first call, or on its very last (the
    error then surfaces after the final drain); ``run`` re-raises the first
    error, every failing call is counted, the drain thread ends."""
    total = len(LENS) * MAX_NEW
    calls = []

    def detok(rid, tok):
        calls.append((rid, tok))
        if (fail_at == "first" and len(calls) == 1) or (
                fail_at == "last" and len(calls) == total):
            raise RuntimeError(f"boom at call {len(calls)}")

    sched = Scheduler(_engine(lm), detokenize=detok)
    with pytest.raises(RuntimeError, match="boom at call"):
        with sched:
            sched.run(_requests(lm))
    sched._detok_thread.join(timeout=10)
    assert not sched._detok_thread.is_alive()
    assert sched.metrics.detok_errors == 1
    sched.close()  # the error was raised once; closing again is quiet


def test_many_requests_keep_per_request_order_under_thread_switches(lm):
    """Stress: 48 short requests over 3 slots with the interpreter switching
    threads every microsecond; the drain thread must hand every token to the
    callback once, in each request's emission order."""
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, tokens=rng.integers(0, 128, int(rng.integers(2, 9))
                                               ).astype(np.int32), max_new=3)
            for i in range(48)]
    seen, lock = {}, threading.Lock()

    def detok(rid, tok):
        with lock:
            seen.setdefault(rid, []).append(tok)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with Scheduler(_engine(lm), detokenize=detok) as sched:
            outs = sched.run(reqs)
    finally:
        sys.setswitchinterval(prev)
    assert not sched._detok_thread.is_alive()
    assert sorted(outs) == list(range(48))
    assert seen == {rid: list(v) for rid, v in outs.items()}
    assert all(len(v) == 3 for v in seen.values())
