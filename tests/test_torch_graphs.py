"""The serving engine's fixed-shape bodies (``make_prefill``/``make_decode``
in ``repro_torch.serve.engine``), the compile accounting
(``repro_torch.obs.compile_events``), the profiler
(``repro_torch.obs.profiler``) and the launch tallies of ``kernels.ops``.

On the CPU the engine runs the same bodies it captures as CUDA graphs on a
card. They are held against the reference's compiled engine on the
smollm-135m smoke config (dense) and the reduced llama4-scout (MoE), both
served the reference's export-only QTensors and activation states
(``iters=0``, W4 body, W8 layer 0, A8, per-channel), carried across with
``repro_torch.bridge``:

- greedy tokens identical over a mix of buckets 8/16/32, groups with a
  dummy row, ``max_new=1`` and slot reuse;
- after a group with a dummy row: ``tokens``, ``pos`` and ``remaining``
  equal the reference's bit for bit, and so does every cache entry the
  group did not admit (both engines start from the reference's state);
  the admitted slot's int8 codes within one step and its float32 scales
  within rtol 1e-5 (the keys and values come out of float32 matmuls that
  XLA and torch sum in different orders);
- the static buffers keep their storage across admit and step.

The reference modules are imported inside the fixtures and tests that use
them, so the card tests (``requires_cuda``, port weights only) also run on
a machine without ``jax``:
``python -m pytest -q -m requires_cuda tests/test_torch_graphs.py``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.context import QuantCtx
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.core.reconstruct import engine_stats, quantize_blocks
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.obs import compile_events, profiler, sink
from repro_torch.obs.telemetry import TELEMETRY, span
from repro_torch.serve.engine import EngineConfig, ServeEngine

torch.set_num_threads(2)

ARCHS = ("smollm-135m", "llama4-scout-17b-a16e")
RULES = ("layers.0.*:w_bits=8",)
RECIPE_KW = dict(method="flexround", w_bits=4, a_bits=8,
                 w_granularity="per_channel", iters=0, batch_size=4)
ENGINE_KW = dict(slots=3, max_len=32, prefill_group=2, kv_quant=True)
# (prompt length, max_new): buckets 8, 16 and 32, max_new = 1, more
# requests than slots; with 3 slots and groups of 2 some groups hold one
# request and a dummy row
MIX = [(5, 6), (9, 1), (12, 4), (7, 6), (3, 1), (20, 3), (14, 5), (30, 2),
       (2, 1)]


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """The reference's export of ``request.param``'s smoke config, and the
    port's model with the same QTensors and activation states."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.core.context import QuantCtx as JQuantCtx
    from repro.core.quant_config import QuantRecipe as JQuantRecipe
    from repro.core.reconstruct import quantize_blocks as jquantize_blocks
    from repro.models import build_model as jbuild_model
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch import bridge

    arch = request.param
    jmodel = jbuild_model(jget_smoke_config(arch))
    model = build_model(get_smoke_config(arch))
    jparams = jmodel.init(jax.random.key(0))
    calib = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (4, 16)).astype(np.int32)
    jrecipe = JQuantRecipe(rules=RULES, **RECIPE_KW)
    jx0, jblocks, jassemble = jmodel.quant_blocks(jparams, jnp.asarray(calib))
    jfin, jast, _ = jquantize_blocks(jblocks, jrecipe, jx0)
    jq = jassemble(jfin)
    jctx = JQuantCtx(mode="deploy", recipe=jrecipe, astates=jast,
                     backend="xla")
    ctx = QuantCtx(mode="deploy", recipe=QuantRecipe(rules=RULES, **RECIPE_KW),
                   astates=bridge.astates(jast, "cpu"))
    qparams = bridge.params(jq, "cpu")
    return dict(
        arch=arch, model=model,
        jengine=lambda: JServeEngine(jmodel, jq, jctx,
                                     JEngineConfig(**ENGINE_KW)),
        engine=lambda **kw: ServeEngine(model, qparams, ctx,
                                        EngineConfig(**ENGINE_KW),
                                        device="cpu", **kw))


def _requests(vocab, mix=MIX, seed=1):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, n).astype(np.int32), mn)
            for i, (n, mn) in enumerate(mix)]


def _serve(engine, requests, groups=None):
    """Admit FIFO into free slots (up to the prefill group), step until
    every request is done; returns {rid: tokens}. ``groups`` collects the
    size of each admitted group."""
    backlog, out = list(requests), {}
    while backlog or engine.active:
        n = min(engine.cfg.prefill_group, len(engine.free_slots()), len(backlog))
        if n:
            if groups is not None:
                groups.append(n)
            for rid, tok in engine.admit(backlog[:n]):
                out.setdefault(rid, []).append(tok)
            backlog = backlog[n:]
        if engine.active:
            for rid, tok in engine.step():
                out[rid].append(tok)
    engine.drain_finished()
    return out


def _buffers(engine):
    """Every static buffer of the engine, by name."""
    out = {f"cache.{k}": t for k, t in engine.state["cache"].items()}
    out.update({k: engine.state[k] for k in ("tokens", "pos", "remaining")})
    out.update({f"prompt.{b}": t for b, t in engine.io["prompt"].items()})
    out.update({k: v for k, v in engine.io.items() if k != "prompt"})
    return out


def test_bodies_emit_the_reference_engines_tokens(lm):
    requests = _requests(lm["model"].cfg.vocab)
    groups = []
    eng = lm["engine"]()
    want = _serve(lm["jengine"](), requests)
    got = _serve(eng, requests, groups)
    assert got == want
    assert [len(got[rid]) for rid, _, _ in requests] == [mn for _, mn in MIX]
    st = eng.stats()
    assert all(st["prefill_calls"][b] > 0 for b in (8, 16, 32))
    assert 1 in groups and 2 in groups  # half-empty and full groups
    assert len(requests) > ENGINE_KW["slots"]
    # the CPU runs the bodies directly: nothing is captured
    assert (st["compile_count"], st["compile_us"], st["graphs"],
            st["build_launches"]) == (0, {}, False, {})


def test_half_empty_group_leaves_other_slots_bit_for_bit(lm):
    """Two requests admitted and stepped twice in the reference's engine;
    the port's engine starts from that state, then both admit one request
    in a group of two (a dummy row, aimed at the occupied slot 0)."""
    from repro_torch import bridge
    vocab = lm["model"].cfg.vocab
    reqs = _requests(vocab, [(5, 6), (11, 4)], seed=3)
    late = _requests(vocab, [(7, 5)], seed=4)[0]
    jeng, eng = lm["jengine"](), lm["engine"]()
    jeng.admit(reqs)
    jeng.step()
    jeng.step()
    for k in ("tokens", "pos", "remaining"):
        eng.state[k].copy_(torch.from_numpy(np.array(jeng.state[k])))
    for k, t in eng.state["cache"].items():
        t.copy_(bridge.tensor(jeng.state["cache"][k], "cpu"))
    for s in (0, 1):  # the host mirror of the two busy slots
        eng.slots[s].rid, eng.slots[s].remaining = s, 1
    before = {k: t.clone() for k, t in eng.state["cache"].items()}

    assert jeng.admit([late]) == eng.admit([late])
    for k in ("tokens", "pos", "remaining"):
        np.testing.assert_array_equal(eng.state[k].numpy(),
                                      np.asarray(jeng.state[k]), err_msg=k)
    np.testing.assert_array_equal(eng.state["pos"].numpy(), [7, 13, 7])
    for k, t in eng.state["cache"].items():
        got, want = bridge.to_numpy(t), np.asarray(jeng.state["cache"][k])
        # slots 0 and 1 (slot 0 took the dummy row), and slot 2 past the
        # bucket: untouched, so the reference's state bit for bit
        np.testing.assert_array_equal(got[:, :2], want[:, :2], err_msg=k)
        np.testing.assert_array_equal(got[:, 2, 8:], want[:, 2, 8:], err_msg=k)
        np.testing.assert_array_equal(got[:, :2], before[k][:, :2].numpy())
        if t.dtype == torch.int8:
            assert np.abs(got[:, 2].astype(int) - want[:, 2]).max() <= 1, k
        else:
            np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5,
                                       err_msg=k)


def test_dummy_row_after_a_real_row_into_the_same_slot(lm):
    """All slots free: the real row 0 takes slot 0 and the dummy row 1
    writes slot 0 back after it; the result equals a group of one whose
    dummy row is skipped, so the engine's state equals the reference's."""
    vocab = lm["model"].cfg.vocab
    req = _requests(vocab, [(6, 4)], seed=5)
    jeng, eng = lm["jengine"](), lm["engine"]()
    assert jeng.admit(req) == eng.admit(req)
    for k in ("tokens", "pos", "remaining"):
        np.testing.assert_array_equal(eng.state[k].numpy(),
                                      np.asarray(jeng.state[k]), err_msg=k)
    for k, t in eng.state["cache"].items():
        got, want = t.numpy(), np.asarray(jeng.state["cache"][k])
        assert got[:, 0, :6].any() and not got[:, 1:].any()
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:], err_msg=k)
        if t.dtype == torch.int8:
            assert np.abs(got.astype(int) - want).max() <= 1, k
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)


def test_static_buffers_keep_their_storage(lm):
    eng = lm["engine"]()
    ptrs = {k: t.data_ptr() for k, t in _buffers(eng).items()}
    _serve(eng, _requests(lm["model"].cfg.vocab, MIX[:5]))
    assert {k: t.data_ptr() for k, t in _buffers(eng).items()} == ptrs


def test_graphs_need_a_card():
    cfg = get_smoke_config("smollm-135m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="graphs=True needs a CUDA device"):
        ServeEngine(model, params, QuantCtx(mode="fp"),
                    EngineConfig(**ENGINE_KW), device="cpu", graphs=True)
    eng = ServeEngine(model, params, QuantCtx(mode="fp"),
                      EngineConfig(**ENGINE_KW), device="cpu", graphs=False)
    assert not eng.graphs and eng.compile_count == 0


# ------------------------------------------------------------ launch tallies
def test_set_aside_and_add_launches_round_trip():
    ops.reset_launch_counts()
    ops.add_launches({"dequant_matmul_w4": 3, "dequant_matmul_w4[decode]": 3,
                      "qmatmul_int8": 1})
    with ops.set_aside() as tally:
        ops.add_launches({"dequant_matmul_batched": 2,
                          "dequant_matmul_batched[packed]": 2,
                          "dequant_matmul_batched[decode]": 2})
    assert tally == {"dequant_matmul_batched": 2,
                     "dequant_matmul_batched[packed]": 2,
                     "dequant_matmul_batched[decode]": 2}
    counts = ops.launch_counts()
    assert {k: n for k, n in counts.items() if n} == {
        "dequant_matmul_w4": 3, "dequant_matmul_w4[decode]": 3,
        "qmatmul_int8": 1}
    for _ in range(2):  # two replays of the set-aside region
        ops.add_launches(tally)
    assert ops.launch_counts()["dequant_matmul_batched[packed]"] == 4
    ops.reset_launch_counts()


# ------------------------------------------------------------ compile events
@pytest.fixture
def _fresh_telemetry():
    TELEMETRY.reset()
    compile_events.reset()
    yield
    TELEMETRY.reset()
    compile_events.reset()


def test_captures_are_attributed_to_the_open_span(_fresh_telemetry):
    rec = sink.ListSink()
    compile_events.record_capture("decode", 0.5)  # telemetry off
    with TELEMETRY.enabled_scope(sink=rec):
        with span("serve.build", buckets=3):
            with span("inner"):
                compile_events.record_capture("prefill_b8", 0.25)
            compile_events.record_capture("prefill_b16", 0.125)
    assert compile_events.captures() == 3
    assert compile_events.captures_by_span() == {
        "<unattributed>": 1, "inner": 1, "serve.build": 1}
    events = [r for r in rec.records if r["kind"] == "compile"]
    assert [(e["graph"], e["span"], e["dur_s"]) for e in events] == [
        ("prefill_b8", "inner", 0.25), ("prefill_b16", "serve.build", 0.125)]
    summary = compile_events.compile_summary()
    assert summary["graph_captures"] == 3 and summary["capture_s"] == 0.875
    assert summary["by_span"] == compile_events.captures_by_span()
    st = engine_stats()
    assert summary["engine"] == dict(dataclasses.asdict(st),
                                     compile_count=st.compile_count)
    assert TELEMETRY.snapshot()["counters"]["cuda.graph_captures"] == 2


def test_compile_events_pass_the_reference_validator(_fresh_telemetry,
                                                     tmp_path):
    from repro.obs import sink as jsink
    path = str(tmp_path / "events.jsonl")
    man = sink.RunManifest.collect(device="cpu")
    with TELEMETRY.enabled_scope(sink=sink.JsonlSink(path), manifest=man):
        with span("serve.build", buckets=4):
            for name in ("prefill_b8", "prefill_b16", "prefill_b32", "decode"):
                compile_events.record_capture(name, 0.01)
    TELEMETRY._sink = None
    recs = [json.loads(line) for line in open(path)]
    assert [r["kind"] for r in recs].count("compile") == 4
    assert jsink.validate_events(path) == []
    assert sink.validate_events(path) == []


# ------------------------------------------------------------------ profiler
def test_profiler_trace_holds_serve_and_recon_annotations(tmp_path):
    assert profiler.active() is None
    assert profiler.annotate("serve.decode_step", 0).__class__.__name__ \
        == "nullcontext"
    cfg = get_smoke_config("smollm-135m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    calib = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    d = str(tmp_path / "profile")
    with profiler.trace(d):
        assert profiler.active() == d
        x0, blocks, _ = model.quant_blocks(params, calib)
        quantize_blocks(blocks[:1], QuantRecipe(w_bits=4, iters=1,
                                                batch_size=2), x0)
        eng = ServeEngine(model, params, QuantCtx(mode="fp"),
                          EngineConfig(**ENGINE_KW), device="cpu")
        _serve(eng, _requests(cfg.vocab, [(5, 3)]))
    assert profiler.active() is None
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(os.path.join(d, files[0])))["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("serve.decode_step") == 2
    assert names.count("serve.prefill") == 1 and names.count("recon.chunk") == 1


# ---------------------------------------------------------------- on a card
def _card_lm(arch: str, dtype: str):
    """Port weights on the card (seed 0), export-only at the test recipe."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    calib = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 16))).cuda()
    recipe = QuantRecipe(rules=RULES, **RECIPE_KW)
    x0, blocks, assemble = model.quant_blocks(params, calib)
    fin, astates, _ = quantize_blocks(blocks, recipe, x0)
    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
    return model, assemble(fin), ctx


CARD = [(arch, dtype) for arch in ARCHS for dtype in ("float32", "bfloat16")]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch,dtype", CARD,
                         ids=[f"{a}-{d}" for a, d in CARD])
def test_graphed_engine_matches_the_eager_engine(arch, dtype):
    """On a card: the graphed engine emits the eager engine's tokens over
    the mix, ``compile_count`` is ``len(buckets) + 1`` before and after,
    the replayed launch tallies equal the eager launches kernel by kernel
    and regime by regime, and warm-up and capture stay out of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py serves both paths "
                    "through CUDA graphs on the card")
    model, qparams, ctx = _card_lm(arch, dtype)
    requests = _requests(model.cfg.vocab)
    runs = {}
    for graphs in (False, True):
        ops.reset_launch_counts()
        eng = ServeEngine(model, qparams, ctx, EngineConfig(**ENGINE_KW),
                          graphs=graphs)
        assert not any(ops.launch_counts().values())
        n_before = eng.compile_count
        out = _serve(eng, requests)
        torch.cuda.synchronize()
        runs[graphs] = (out, ops.launch_counts(), eng)
        assert eng.compile_count == n_before
    (eager, eager_n, e_eng), (graphed, graphed_n, g_eng) = runs[False], runs[True]
    assert graphed == eager
    assert e_eng.compile_count == 0 and not e_eng.build_launches
    assert g_eng.compile_count == len(g_eng.buckets) + 1 == 4
    assert sorted(g_eng.compile_us) == ["decode", "prefill_b16",
                                        "prefill_b32", "prefill_b8"]
    assert graphed_n == eager_n and eager_n["dequant_matmul_w4"] > 0
    assert g_eng.build_launches["capture"]["dequant_matmul_w4"] > 0
    assert g_eng.build_launches["warmup"]["dequant_matmul_w4"] > 0
