"""The train step's spans (``lightning_asr_torch/training/profiler.py``,
``training/steps.py``) on the CPU: off by default at the cost of one global
read, the same bits with them on, one of each phase under ``train_step``
(``forward`` and ``backward`` once a micro-batch, ``all_reduce`` only with
``data_parallel``), and each a ``lasr/`` annotation around its own aten ops
in a torch.profiler trace.

The model is the full-width ``quartznet12_context`` in float32, on a batch
of 2 rows of 1.1-1.3 s (the benchmark's tiny training mix).
"""

import json
import socket

import numpy as np
import pytest
import torch

from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
from lightning_asr_torch.parallel import distributed
from lightning_asr_torch.training import profiler
from lightning_asr_torch.training.profiler import SimpleProfiler, span, tracing
from lightning_asr_torch.training.steps import create_train_state, make_train_step

NUM_CLASSES = 29
PHASES = ("features", "forward", "backward", "update")


@pytest.fixture(scope="module")
def recipe():
    """(model, optimizer, state, batch) of the default recipe at 2 rows."""
    torch.manual_seed(0)
    model = build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    schedule = cosine_annealing_warmup_restarts(first_cycle_steps=100, cycle_mult=2,
                                                max_lr=1e-2, min_lr=1e-4, warmup_steps=10,
                                                gamma=0.5)
    optimizer = novograd(schedule, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    rng = np.random.default_rng(3)
    lens = np.array([20800, 17600], np.int32)
    waves = np.zeros((2, 20800), np.int16)
    for b, n in enumerate(lens):
        waves[b, :n] = (rng.standard_normal(n) * 3000).astype(np.int16)
    targets = np.zeros((2, 32), np.int32)
    targets[0, :20] = rng.integers(0, NUM_CLASSES - 1, 20)
    targets[1, :14] = rng.integers(0, NUM_CLASSES - 1, 14)
    batch = {"waves": torch.from_numpy(waves), "wave_lens": torch.from_numpy(lens),
             "prev_samples": torch.zeros(2), "targets": torch.from_numpy(targets),
             "target_lens": torch.tensor([20, 14], dtype=torch.int32)}
    return model, optimizer, create_train_state(model, optimizer), batch


def _step(recipe, **kw):
    model, optimizer, state, batch = recipe
    step = make_train_step(model, optimizer, NUM_CLASSES - 1, MelFrontendConfig(), **kw)
    return step(state, batch, torch.Generator().manual_seed(5))


def _traced(recipe, **kw) -> SimpleProfiler:
    prof = SimpleProfiler()
    with tracing(prof):
        _step(recipe, **kw)
    return prof


def _equal(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_spans_nest_and_keep_self_time():
    prof = SimpleProfiler()
    assert span("outside") is span("elsewhere")          # the shared no-op
    with tracing(prof):
        for _ in range(2):
            with span("a"):
                with span("b"):
                    pass
                with span("c"):
                    with span("b"):
                        pass
    assert dict(prof.counts) == {"a": 2, "a/b": 2, "a/c": 2, "a/c/b": 2}
    assert prof.parents == {"a": None, "a/b": "a", "a/c": "a", "a/c/b": "a/c"}
    assert prof.self_seconds("a") == pytest.approx(
        prof.totals["a"] - prof.totals["a/b"] - prof.totals["a/c"])
    assert all(prof.self_seconds(n) >= 0 for n in prof.totals)
    assert profiler._TRACING is None


def test_tracing_off_reads_no_clock_and_opens_no_annotation(recipe, monkeypatch):
    calls = {"clock": 0, "record_function": 0}
    clock, record_function = profiler._clock, profiler.record_function

    def counted_clock():
        calls["clock"] += 1
        return clock()

    def counted_record_function(name):
        calls["record_function"] += 1
        return record_function(name)

    monkeypatch.setattr(profiler, "_clock", counted_clock)
    monkeypatch.setattr(profiler, "record_function", counted_record_function)
    _step(recipe)
    assert calls == {"clock": 0, "record_function": 0}
    _traced(recipe)                                     # the counters see a traced step
    assert calls == {"clock": 2 * 5, "record_function": 5}


def test_tracing_on_gives_the_same_bits(recipe):
    off_state, off_metrics = _step(recipe)
    with tracing(SimpleProfiler()):
        on_state, on_metrics = _step(recipe)
    assert _equal(vars(off_state), vars(on_state)) and _equal(off_metrics, on_metrics)


def test_phases_once_each_under_train_step(recipe):
    prof = _traced(recipe)
    assert dict(prof.counts) == {"train_step": 1, **{f"train_step/{p}": 1 for p in PHASES}}
    assert all(prof.parents[f"train_step/{p}"] == "train_step" for p in PHASES)
    assert prof.self_seconds("train_step") >= 0


def test_accum_steps_count_forward_and_backward_per_micro_batch(recipe):
    counts = _traced(recipe, accum_steps=2).counts
    assert counts["train_step/forward"] == counts["train_step/backward"] == 2
    assert counts["train_step/features"] == counts["train_step/update"] == 1


def test_data_parallel_step_records_all_reduce(recipe):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.init({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                      "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}, "cpu",
                     timeout_s=60)
    try:
        counts = _traced(recipe, data_parallel=True).counts
    finally:
        distributed.shutdown()
    assert counts["train_step/all_reduce"] == 1
    assert all(counts[f"train_step/{p}"] == 1 for p in PHASES)


def test_profiler_trace_holds_the_phases_and_their_ops(recipe, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _traced(recipe)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {ev["name"][len("lasr/"):]: (ev["ts"], ev["ts"] + ev["dur"]) for ev in events
             if ev.get("cat") == "user_annotation" and ev["name"].startswith("lasr/")}
    assert set(spans) == {"train_step", *(f"train_step/{p}" for p in PHASES)}
    t0, t1 = spans["train_step"]
    assert all(t0 <= s and e <= t1 for s, e in spans.values())
    ops = [(ev["name"], ev["ts"]) for ev in events
           if ev.get("cat") == "cpu_op" and ev["name"].startswith("aten::")]
    for p, marker in (("features", "aten::"), ("forward", "aten::convolution"),
                      ("backward", "aten::convolution_backward"), ("update", "aten::where")):
        s, e = spans[f"train_step/{p}"]
        assert any(name.startswith(marker) and s <= ts <= e for name, ts in ops), p
