"""The train step as one CUDA graph per input key (``training/graphs.py``).

On the CPU: the capture policy, which calls capture, replay or stay eager
(the CPU, ``data_parallel``, ``accum_steps > 1``, a first sighting of the
first key and of a later one, a state shaped otherwise, the limit on
graphs, a capture that fails), the train state as a pytree node, and the
kernel wrappers' launch counts that a capture takes back and a replay
adds.

On the card (marked ``cuda``, skipped without one), the default recipe at
full width in bf16 on batches of 2 rows: two shapes interleaved and replayed
against the eager step bit for bit, each other route (the frontend's plain
tier, the conv kernels, the other encoders, the fused BiLSTM, the LSTM
head, the crop in the step) captured and replayed bit for bit, a NaN batch
under replay, a state and ``preds`` returned earlier left intact by later
steps, a second generator object under a key of its own, a capture that
fails, and the wrappers' launch counts under replay; and the benchmark's
training recipe at its batch of 32 rows, four of its duration buckets
interleaved, the longest among them, replayed against the eager step bit
for bit.  On a machine with a card (JAX need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_train_capture.py -q
"""

from collections import Counter

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.ops.lstm_kernels import lstm_recurrence
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd, \
    with_gradient_clipping
from lightning_asr_torch.training import graphs
from lightning_asr_torch.training.graphs import GraphedStep
from lightning_asr_torch.training.profiler import SimpleProfiler, tracing
from lightning_asr_torch.training.steps import AsrTrainState, create_train_state, \
    make_train_step

NUM_CLASSES = 29


def _toy(state, batch, generator=None):
    return {"w": state["w"] + batch["x"].sum()}, {"loss": batch["x"].mean()}


def _cpu_batch(n=4):
    return {"x": torch.ones(n)}


# ---- the policy, on the CPU ------------------------------------------------

def test_a_cpu_call_stays_eager_and_counts_its_reason():
    step = GraphedStep(_toy)
    prof = SimpleProfiler()
    with tracing(prof):
        for _ in range(3):
            state, metrics = step({"w": torch.zeros(())}, _cpu_batch())
    assert float(state["w"]) == 4.0 and float(metrics["loss"]) == 1.0
    assert step.counts == Counter({"eager/cpu": 3})
    assert not prof.counts                              # no capture, no replay


def test_a_batch_entry_that_is_no_tensor_stays_eager():
    step = GraphedStep(lambda s, b, g: (s, {}))
    step({"w": torch.zeros(())}, {"x": torch.ones(2), "note": "x"})
    assert step.counts == Counter({"eager/batch": 1})


def test_first_sighting_then_capture_then_replay(monkeypatch):
    step = GraphedStep(_toy)
    assert [step.route(k) for k in (("a",), ("a",), ("b",))] == ["capture"] * 3
    step._graphs[("a",)] = object()                     # what a capture leaves
    assert [step.route(k) for k in (("a",), ("b",))] == ["replay", "capture"]

    # the first key's first call gives the eager step's result, the capture
    # following it; a later key's first call records and replays its graph
    step = GraphedStep(_toy)
    monkeypatch.setattr(step, "key", lambda spec, batch, gen: ((batch["x"].shape,), None))
    monkeypatch.setattr(step, "_capture", lambda flat, spec, batch, gen: f"graph{len(batch['x'])}")
    monkeypatch.setattr(step, "_replay", lambda g, flat, batch: ("replayed", g))
    prof = SimpleProfiler()
    with tracing(prof):
        first = step({"w": torch.zeros(())}, _cpu_batch())
        later = [step({"w": torch.zeros(())}, _cpu_batch(n)) for n in (4, 4, 3, 3)]
    assert float(first[0]["w"]) == 4.0
    assert later == [("replayed", "graph4")] * 2 + [("replayed", "graph3")] * 2
    assert step.counts == Counter({"capture": 2, "replay": 3})
    assert dict(prof.counts) == {"capture": 2, "replay": 3}


def test_a_step_reason_keeps_every_call_eager():
    step = GraphedStep(_toy, reason="data_parallel")
    assert [step.route(("a",)) for _ in range(3)] == ["eager/data_parallel"] * 3
    assert step.route(("a",), "cpu") == "eager/cpu"


def test_the_limit_on_graphs():
    step = GraphedStep(_toy)
    step._graphs.update({i: object() for i in range(graphs.MAX_GRAPHS)})
    assert step.route("new") == "eager/limit"
    assert step.route(0) == "replay"
    del step._graphs[0]
    assert step.route("new") == "capture"


def test_a_failed_capture_falls_back_and_is_counted(monkeypatch):
    step = GraphedStep(_toy)
    monkeypatch.setattr(step, "key", lambda spec, batch, gen: (("x",), None))

    def refuse(*args):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(step, "_capture", refuse)
    prof = SimpleProfiler()
    outs = []
    with tracing(prof):
        for _ in range(3):
            outs.append(step({"w": torch.zeros(())}, _cpu_batch()))
    assert all(float(s["w"]) == 4.0 for s, _ in outs)
    assert step.counts == Counter({"eager/failed": 3})
    assert dict(prof.counts) == {"capture": 1}         # the attempt's span


def _state(names="ab"):
    return AsrTrainState(step=torch.tensor(3), params={k: torch.ones(2) for k in names},
                         batch_stats={}, opt_state=(torch.tensor(1), torch.ones(4)),
                         nan_count=torch.tensor(0))


def test_a_state_shaped_otherwise_stays_eager():
    step = GraphedStep(_toy)
    step._state_spec = pytree.tree_flatten(_state("ab"))[1]   # what a capture holds
    batch = _cpu_batch()
    assert step.key(pytree.tree_flatten(_state("ab"))[1], batch, None)[1] == "cpu"
    for other in (_state("ba"), _state("abc")):
        assert step.key(pytree.tree_flatten(other)[1], batch, None)[1] == "state"


def test_a_train_state_flattens_and_rebuilds():
    state = _state()
    flat, spec = pytree.tree_flatten(state)
    assert [tuple(t.shape) for t in flat] == [(), (2,), (2,), (), (4,), ()]
    back = pytree.tree_unflatten([t + 1 for t in flat], spec)
    assert isinstance(back, AsrTrainState) and list(back.params) == ["a", "b"]
    assert float(back.step) == 4.0 and float(back.opt_state[1][0]) == 2.0


def test_a_capture_takes_back_its_launches_and_a_replay_adds_them(monkeypatch):
    monkeypatch.setattr(lstm_recurrence, "launches", 5)
    monkeypatch.setattr(lstm_recurrence, "launches_at", {40: 5})
    before = graphs.launch_counts()
    lstm_recurrence.launches += 2                       # what a capture's calls count
    lstm_recurrence.launches_at[40] += 1
    lstm_recurrence.launches_at[128] = 1
    counted = graphs.launches_since(before)
    assert counted[lstm_recurrence] == (2, {40: 1, 128: 1})
    assert all(n == 0 and not at for fn, (n, at) in counted.items() if fn is not lstm_recurrence)
    graphs.add_launches(counted, -1)
    assert lstm_recurrence.launches == 5 and lstm_recurrence.launches_at == {40: 5, 128: 0}
    for _ in range(3):                                  # three replays
        graphs.add_launches(counted)
    assert lstm_recurrence.launches == 11 and lstm_recurrence.launches_at == {40: 8, 128: 3}


def _recipe_step(**kw):
    model = build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    optimizer = novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    return make_train_step(model, optimizer, NUM_CLASSES - 1, MelFrontendConfig(), **kw)


def test_make_train_step_gives_its_reasons():
    assert _recipe_step().graphs.reason is None
    assert _recipe_step(accum_steps=2).graphs.reason == "accum_steps"
    assert _recipe_step(data_parallel=True).graphs.reason == "data_parallel"


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    """The card, with cuDNN's deterministic algorithms: the 1x1 convolutions'
    weight gradients otherwise differ from one eager call to the next."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = before


def _card_recipe(dev, frontend=MelFrontendConfig(precision="default"), step_kw=None,
                 **model_kw):
    """(step, state) of the default recipe in bf16 as the benchmark builds it
    (K1's frontend tier, fused NovoGrad on cosine warm-up restarts with
    cycle_mult 2), with dropout and clipping on, so that every draw and the
    update's every branch run."""
    torch.manual_seed(0)
    model = build_model(NUM_CLASSES, **{"encoder": "quartznet12_context", "mask": True,
                                        "drop_rate": 0.1, "dtype": torch.bfloat16,
                                        **model_kw}).to(dev)
    schedule = cosine_annealing_warmup_restarts(first_cycle_steps=100, cycle_mult=2,
                                                max_lr=1e-2, min_lr=1e-4, warmup_steps=10,
                                                gamma=0.5)
    optimizer = with_gradient_clipping(novograd(schedule, betas=(0.8, 0.5), weight_decay=1e-3),
                                       1.0, "value")
    step = make_train_step(model, optimizer, NUM_CLASSES - 1, frontend, **(step_kw or {}))
    return step, create_train_state(model, optimizer)


def _card_batch(dev, seed, seconds, L, dtype=torch.int16):
    rng = np.random.default_rng(seed)
    S = int(seconds * 16000)
    lens = np.array([S, S * 3 // 4], np.int32)
    waves = np.zeros((2, S), np.float32)
    for b, n in enumerate(lens):
        waves[b, :n] = rng.standard_normal(n) * 3000
    targets = np.zeros((2, L), np.int32)
    tl = np.array([L - 5, L // 2], np.int32)
    for b, n in enumerate(tl):
        targets[b, :n] = rng.integers(0, NUM_CLASSES - 1, n)
    w = torch.from_numpy(waves)
    w = w.to(dtype) if dtype == torch.int16 else w / 32768.0
    return {"waves": w.to(dev), "wave_lens": torch.from_numpy(lens).to(dev),
            "prev_samples": torch.zeros(2, device=dev),
            "targets": torch.from_numpy(targets).to(dev),
            "target_lens": torch.from_numpy(tl).to(dev)}


def _same(a, b) -> bool:
    (fa, sa), (fb, sb) = pytree.tree_flatten(a), pytree.tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(fa, fb))


def _eager(step, state, batch, gen, seed):
    gen.manual_seed(seed)
    return step.graphs.fn(state, batch, gen)


@pytest.mark.cuda
def test_two_shapes_interleaved_replay_the_eager_bits(card):
    step, state = _card_recipe(card)
    shapes = [_card_batch(card, 1, 1.2, 32), _card_batch(card, 2, 2.0, 64)]
    gen = torch.Generator(device=card)
    s_graph = s_eager = state
    for i in range(8):
        batch = shapes[i % 2]
        gen.manual_seed(1000 + i)
        s_graph, m_graph = step(s_graph, batch, gen)
        s_eager, m_eager = _eager(step, s_eager, batch, gen, 1000 + i)
        assert _same(s_eager, s_graph), i
        assert _same(m_eager, m_graph), i
    assert step.graphs.counts == Counter({"capture": 2, "replay": 6})
    assert int(s_graph.step) == 8 and int(s_graph.nan_count) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("route", [
    {"frontend": MelFrontendConfig()},                  # the plain frontend tier
    {"conv_kernel": "sepconv"}, {"conv_kernel": "dw_wgrad"},
    {"encoder": "quartznet12_context_se"}, {"encoder": "quartznet10x5"},
    {"fuse_directions": True}, {"lstm_head": True},
    {"lstm_head": True, "fuse_directions": True},
    {"step_kw": {"crop": True}}], ids=str)
def test_each_route_captures_and_replays_the_eager_bits(card, route):
    step, state = _card_recipe(card, **route)
    batch = _card_batch(card, 6, 1.2, 32)
    gen = torch.Generator(device=card)
    for i in range(3):
        gen.manual_seed(50 + i)
        got = step(state, batch, gen)
        assert _same(_eager(step, state, batch, gen, 50 + i), got), i
        state = got[0]
    assert step.graphs.counts == Counter({"capture": 1, "replay": 2})


@pytest.mark.cuda
def test_a_nan_batch_under_replay_keeps_the_state(card):
    # the plain frontend tier carries a NaN sample through (K1's clamp to
    # amin would turn it into a number)
    step, state = _card_recipe(card, frontend=MelFrontendConfig())
    good = _card_batch(card, 3, 1.2, 32, dtype=torch.float32)
    gen = torch.Generator(device=card)
    for i in range(2):                                  # capture, replay
        gen.manual_seed(i)
        state, _ = step(state, good, gen)
    bad = dict(good, waves=good["waves"].clone())
    bad["waves"][0, 100] = float("nan")
    gen.manual_seed(2)
    new, metrics = step(state, bad, gen)
    assert step.graphs.counts["replay"] == 2
    assert not bool(metrics["finite"])
    assert int(new.nan_count) == int(state.nan_count) + 1 and int(new.step) == int(state.step) + 1
    for part in ("params", "batch_stats", "opt_state"):
        assert _same(getattr(state, part), getattr(new, part)), part


@pytest.mark.cuda
def test_a_returned_state_and_preds_stay_intact(card):
    step, state = _card_recipe(card)
    batch = _card_batch(card, 4, 1.2, 32)
    gen = torch.Generator(device=card)
    kept = None
    for i in range(6):
        gen.manual_seed(i)
        state, metrics = step(state, batch, gen)
        if i == 2:                                      # a replay's
            kept = (state, metrics)
            copies = [t.clone() for t in pytree.tree_leaves(kept)]
    assert step.graphs.counts == Counter({"capture": 1, "replay": 5})
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(kept), copies))
    assert not _same(kept[0].params, state.params)     # the later steps moved on


@pytest.mark.cuda
def test_a_second_generator_gets_its_own_key(card):
    step, state = _card_recipe(card)
    batch = _card_batch(card, 5, 1.2, 32)
    g1, g2 = torch.Generator(device=card), torch.Generator(device=card)
    for gen in (g1, g1, g2, g2, g2):
        gen.manual_seed(7)
        out = step(state, batch, gen)
    assert step.graphs.counts == Counter({"capture": 2, "replay": 3})
    assert len(step.graphs._graphs) == 2
    assert _same(_eager(step, state, batch, g2, 7), out)
    g1.manual_seed(7)
    assert _same(step(state, batch, g1), out)           # g1's graph: the same draws


@pytest.mark.cuda
def test_a_capture_that_syncs_falls_back_and_the_next_one_captures(card):
    def syncs(state, batch, gen=None):
        total = batch["x"].sum()
        return {"w": state["w"] + float(total)}, {"total": total}

    state = {"w": torch.zeros((), device=card)}
    batch = {"x": torch.ones(8, device=card)}
    bad = GraphedStep(syncs)
    for _ in range(3):
        out, _ = bad(state, batch)
        assert float(out["w"]) == 8.0
    assert bad.counts == Counter({"eager/failed": 3})
    good = GraphedStep(_toy)
    for _ in range(3):
        out, metrics = good(state, batch)
    assert float(out["w"]) == 8.0 and float(metrics["loss"]) == 1.0
    assert good.counts == Counter({"capture": 1, "replay": 2})


@pytest.mark.cuda
def test_a_replay_counts_the_wrappers_launches(card):
    step, state = _card_recipe(card)
    batch = _card_batch(card, 8, 1.2, 32)
    gen = torch.Generator(device=card).manual_seed(0)
    before = graphs.launch_counts()
    for _ in range(4):                                  # capture, 3 replays
        state, _ = step(state, batch, gen)
    ran = graphs.launches_since(before)
    # K1, K6, K4, K5 once a step; K2 and K3 once (the context BiLSTM, H=40)
    for fn in graphs.COUNTED:
        want = 4 if fn.__name__ in ("mel_from_extended", "extend_preemph", "ctc_alpha", "ctc_beta",
                                    "lstm_recurrence", "lstm_backward") else 0
        assert ran[fn][0] == want, fn.__name__
    assert ran[lstm_recurrence][1] == {40: 4}
    assert step.graphs.counts == Counter({"capture": 1, "replay": 3})


# the benchmark's training cell: LibriSpeech-like buckets (seconds) of 32
# rows, each with the target width its longest row's characters give
CELL_BUCKETS = ((2.0, 1.0), (8.0, 6.0), (12.0, 10.0), (16.7, 14.0))
CELL_CHARS_PER_SECOND = 13.413173652694612


def _cell_batch(dev, seed, hi, lo, rows=32):
    rng = np.random.default_rng(seed)
    S = int(hi * 16000)
    lens = np.minimum((rng.uniform(lo, hi, rows) * 16000).astype(np.int64), S)
    lens[0] = S                                         # a row that fills the bucket
    waves = np.zeros((rows, S), np.int16)
    for b, n in enumerate(lens):
        waves[b, :n] = np.clip(rng.standard_normal(n) * 3000, -32768, 32767)
    tl = np.maximum(1, np.round(lens / 16000 * CELL_CHARS_PER_SECOND)).astype(np.int32)
    L = -(-int(tl.max()) // 32) * 32
    targets = rng.integers(0, NUM_CLASSES - 1, (rows, L)).astype(np.int32)
    targets[np.arange(L)[None, :] >= tl[:, None]] = 0
    return {"waves": torch.from_numpy(waves).to(dev),
            "wave_lens": torch.from_numpy(lens.astype(np.int32)).to(dev),
            "targets": torch.from_numpy(targets).to(dev),
            "target_lens": torch.from_numpy(tl).to(dev)}


@pytest.mark.cuda
def test_the_benchmark_recipe_at_32_rows_replays_the_eager_bits(card):
    """The recipe of the benchmark's training cell (bf16, SpecAugment, the
    dithered K1 frontend, fused NovoGrad on cosine warm-up restarts, no
    dropout), four of its buckets interleaved, the 16.7 s one among them,
    each step replayed against the eager step from the same state."""
    torch.manual_seed(0)
    model = build_model(NUM_CLASSES, "quartznet12_context", mask=True, drop_rate=0.0,
                        dtype=torch.bfloat16).to(card)
    schedule = cosine_annealing_warmup_restarts(first_cycle_steps=89200, cycle_mult=2,
                                                max_lr=1e-2, min_lr=1e-4, warmup_steps=1000,
                                                gamma=0.5)
    optimizer = with_gradient_clipping(
        novograd(schedule, betas=(0.8, 0.5), weight_decay=1e-3, fused=True), 0.0, "value")
    step = make_train_step(model, optimizer, NUM_CLASSES - 1,
                           MelFrontendConfig(dither=1e-5, precision="default"), augment=True,
                           freq_mask=27, time_mask=0.07)
    state = create_train_state(model, optimizer)
    batches = [_cell_batch(card, 20 + i, hi, lo) for i, (hi, lo) in enumerate(CELL_BUCKETS)]
    assert [b["targets"].shape[1] for b in batches] == [32, 128, 192, 224]
    gen = torch.Generator(device=card)
    order = [3, 0, 1, 2, 3, 1, 0, 2, 3, 2]              # every bucket captured, then replayed
    for i, k in enumerate(order):
        gen.manual_seed(3_000_000_019 + i)
        got = step(state, batches[k], gen)
        gen.manual_seed(3_000_000_019 + i)
        want = step.graphs.fn(state, batches[k], gen)
        assert _same(want, got), (i, k)
        assert bool(got[1]["finite"]), (i, k)
        state = got[0]
    assert step.graphs.counts == Counter({"capture": 4, "replay": 6})
    assert int(state.step) == len(order) and int(state.nan_count) == 0
