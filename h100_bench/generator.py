"""The one traffic generator: it reads a mix file of ``h100_bench/traffic/``
and makes the mix's batches from ``--seed``.

Every seed gets the same work in another order: the durations are fixed
quantiles of each bucket (so the same multiset for every seed), and the
seed only shuffles them, draws the noise the audio is cut from and the
transcripts' labels.

A mix of ``"kind": "buckets"`` (training): steps of ``rows`` rows, every
row of a step from one duration bucket (upper edges ``buckets``, each with
its share of the audio), padded to that bucket's samples as the trainer's
bucket batcher pads them; a cycle of ``cycle_batches`` steps holds the
buckets in proportion to their audio shares; transcripts of
``chars_per_second`` labels a second, padded to ``target_pad_multiple``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream])


def noise_pool(seed: int, samples: int, amplitude: float) -> np.ndarray:
    """``samples`` int16 samples of Gaussian noise of std ``amplitude``."""
    x = _rng(seed, 1).standard_normal(samples, dtype=np.float32) * amplitude
    return np.clip(np.rint(x), -32768, 32767).astype(np.int16)


def _cuts(rng, pool: np.ndarray, lengths: np.ndarray) -> List[np.ndarray]:
    """Each length's slice of ``pool`` at a seeded offset."""
    starts = rng.integers(0, pool.size - int(lengths.max()), lengths.size)
    return [pool[s: s + n] for s, n in zip(starts, lengths)]


# -- training: bucketed steps ---------------------------------------------
@dataclass
class TrainBatch:
    waves: np.ndarray          # (rows, bucket samples) int16
    wave_lens: np.ndarray      # (rows,) int32
    targets: np.ndarray        # (rows, L) int32
    target_lens: np.ndarray    # (rows,) int32
    bucket: float              # seconds

    @property
    def audio_s(self) -> float:
        return float(self.wave_lens.sum()) / 16000.0


def bucket_counts(mix: dict) -> List[int]:
    """Steps of each bucket in a cycle: proportional to the bucket's audio
    share over its mean duration (largest remainders), at least one each."""
    edges = [b for b, _ in mix["buckets"]]
    lows = [mix["min_seconds"]] + edges[:-1]
    weight = [w / ((lo + hi) / 2) for (hi, w), lo in zip(mix["buckets"], lows)]
    want = np.asarray(weight) / sum(weight) * mix["cycle_batches"]
    counts = np.maximum(np.floor(want).astype(int), 1)
    for i in np.argsort(-(want - np.floor(want))):
        if counts.sum() >= mix["cycle_batches"]:
            break
        counts[i] += 1
    return counts.tolist()


def train_cycle(mix: dict, seed: int) -> List[TrainBatch]:
    """The mix's cycle of steps for ``seed`` (each of ``rows`` rows)."""
    rng = _rng(seed, 2)
    sr, rows = mix["sample_rate"], mix["rows"]
    edges = [b for b, _ in mix["buckets"]]
    lows = [mix["min_seconds"]] + edges[:-1]
    pool = noise_pool(seed, int(2 * edges[-1] * sr * rows), mix["amplitude"])
    batches = []
    for lo, hi, n in zip(lows, edges, bucket_counts(mix)):
        q = (np.arange(n * rows) + 0.5) / (n * rows)          # the bucket's quantiles
        seconds = rng.permutation(lo + (hi - lo) * q)
        samples = np.minimum((seconds * sr).astype(np.int64), int(hi * sr))
        for b in range(n):
            lens = samples[b * rows: (b + 1) * rows]
            waves = np.zeros((rows, int(hi * sr)), np.int16)
            for r, cut in enumerate(_cuts(rng, pool, lens)):
                waves[r, : cut.size] = cut
            tl = np.maximum(1, np.round(lens / sr * mix["chars_per_second"])).astype(np.int32)
            m = mix["target_pad_multiple"]
            L = max(-(-int(tl.max()) // m) * m, m)
            targets = rng.integers(0, mix["num_labels"], (rows, L)).astype(np.int32)
            targets[np.arange(L)[None, :] >= tl[:, None]] = 0
            batches.append(TrainBatch(waves, lens.astype(np.int32), targets, tl, hi))
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]


def first_steps(cycle: List[TrainBatch], n_min: int) -> List[int]:
    """The cycle's first batch of each bucket, in the cycle's order (padded
    with the cycle's next batches to at least ``n_min``): a run's first
    steps, which warm every shape and which the reference follows."""
    seen, out = set(), []
    for i, b in enumerate(cycle):
        if b.bucket not in seen:
            seen.add(b.bucket)
            out.append(i)
    return out + [i for i in range(len(cycle)) if i not in out][: max(0, n_min - len(out))]
