"""Conformer-CTC Large's train step on the card (marked ``cuda``, skipped
without one): the benchmark cell's recipe (bf16, the dithered K1
frontend, SpecAugment, fused NovoGrad on cosine warm-up restarts) at its
32 rows, four of its duration buckets interleaved, the 16.7 s one among
them, each step replayed from its CUDA graph against the eager step from
the same state and generator state, bit for bit, under PyTorch's
deterministic algorithms (``torch.use_deterministic_algorithms``, which
needs ``CUBLAS_WORKSPACE_CONFIG``): without them the memory-efficient
kernel's backward sums a query's gradient over blocks of keys in any
order, and two eager steps differ too (8 of 24 repeats of one step did);
every step's attention on the memory-efficient kernel. On a machine with
a card (JAX need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_conformer_cuda.py -q
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from lightning_asr_torch.models.conformer import ATTENTION_COUNTER, NAME
from lightning_asr_torch.models.quartznet import build_model, reset_parameters
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd, \
    with_gradient_clipping
from lightning_asr_torch.training.profiler import COUNTERS
from lightning_asr_torch.training.steps import create_train_state, make_train_step

# deterministic cuBLAS, read when cuBLAS makes its first workspace, so
# before any test runs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

CLASSES = 129
# the cell's buckets (seconds: upper edge, shortest row) and labels a second
BUCKETS = ((2.0, 1.0), (8.0, 6.0), (12.0, 10.0), (16.7, 14.0))
LABELS_PER_SECOND = 5.4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the memory-efficient kernel")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda", 0)
    torch.use_deterministic_algorithms(before)


def _batch(dev, seed, hi, lo, rows=32):
    rng = np.random.default_rng(seed)
    S = int(hi * 16000)
    lens = np.minimum((rng.uniform(lo, hi, rows) * 16000).astype(np.int64), S)
    lens[0] = S
    waves = np.zeros((rows, S), np.int16)
    for b, n in enumerate(lens):
        waves[b, :n] = np.clip(rng.standard_normal(n) * 3000, -32768, 32767)
    tl = np.maximum(1, np.round(lens / 16000 * LABELS_PER_SECOND)).astype(np.int32)
    L = -(-int(tl.max()) // 32) * 32
    targets = rng.integers(0, CLASSES - 1, (rows, L)).astype(np.int32)
    targets[np.arange(L)[None, :] >= tl[:, None]] = 0
    return {"waves": torch.from_numpy(waves).to(dev),
            "wave_lens": torch.from_numpy(lens.astype(np.int32)).to(dev),
            "targets": torch.from_numpy(targets).to(dev),
            "target_lens": torch.from_numpy(tl).to(dev)}


def _same(a, b) -> bool:
    (fa, sa), (fb, sb) = pytree.tree_flatten(a), pytree.tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(fa, fb))


@pytest.mark.cuda
def test_the_cell_recipe_at_32_rows_replays_the_eager_bits(card):
    torch.manual_seed(0)
    model = build_model(CLASSES, NAME, mask=True, dtype=torch.bfloat16)
    reset_parameters(model, torch.Generator().manual_seed(0))
    model.to(card)
    schedule = cosine_annealing_warmup_restarts(first_cycle_steps=89200, cycle_mult=2,
                                                max_lr=1e-2, min_lr=1e-4, warmup_steps=1000,
                                                gamma=0.5)
    optimizer = with_gradient_clipping(
        novograd(schedule, betas=(0.8, 0.5), weight_decay=1e-3, fused=True), 0.0, "value")
    frontend = MelFrontendConfig(n_mels=80, win_length=400, dither=1e-5, precision="default")
    step = make_train_step(model, optimizer, CLASSES - 1, frontend, augment=True, freq_mask=27,
                           time_mask=0.07)
    state = create_train_state(model, optimizer)
    batches = [_batch(card, 40 + i, hi, lo) for i, (hi, lo) in enumerate(BUCKETS)]
    before = Counter(COUNTERS[ATTENTION_COUNTER])
    gen = torch.Generator(device=card)
    order = [3, 0, 1, 2, 3, 1, 0, 2, 3, 2]              # every bucket captured, then replayed
    for i, k in enumerate(order):
        gen.manual_seed(4_000_000_007 + i)
        got = step(state, batches[k], gen)
        gen.manual_seed(4_000_000_007 + i)
        want = step.graphs.fn(state, batches[k], gen)
        assert _same(want, got), (i, k)
        assert bool(got[1]["finite"]), (i, k)
        state = got[0]
    assert step.graphs.counts == Counter({"capture": 4, "replay": 6})
    assert int(state.step) == len(order) and int(state.nan_count) == 0
    calls = Counter(COUNTERS[ATTENTION_COUNTER])
    calls.subtract(before)
    # the first capture's eager run, four recordings, ten eager references
    assert +calls == Counter({"cuda/efficient": 15})
