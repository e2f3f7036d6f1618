"""Incremental (streaming) transcription on top of ``AsrTranslator`` (port of
``lightning_asr_tpu/inference/streaming.py``): feed PCM as it arrives, read
a stable partial transcript after every feed, get the final transcript at
``finish()``.

Every window runs through the translator's forward on its device at one
fixed ``(1, chunk)`` shape.  Window placement and keep-region stitching are
``plan_chunks``'s: windows of ``chunk`` samples every ``chunk - 2*overlap``,
each non-final window keeping the frames of samples ``[start+keep_lo,
start+chunk-overlap)``, the final right-aligned window keeping through the
end, so ``finish()`` gives ``AsrTranslator.translate_long``'s transcript of
the same audio.

The greedy collapse is incremental: the previous frame's token carries
across windows, so each ``feed()`` does work in the new frames only and
``partial()`` is free.  With a beam decoder the kept log-probs are buffered
and decoded once at ``finish()`` (a beam search is not prefix-stable, so
greedy serves the partials either way).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.frontend import mel_num_frames
from .predict import out_frame


class StreamingTranscriber:
    """Push-based transcription session over one fixed window shape.

    Args:
      translator: a loaded ``AsrTranslator``.
      chunk_seconds / overlap_seconds: the window geometry, as
        ``translate_long`` takes it; ``chunk`` must exceed ``2*overlap``.

    Usage::

        st = StreamingTranscriber(translator)
        for block in microphone():     # any block sizes
            text_so_far = st.feed(block)
        final = st.finish()
    """

    def __init__(self, translator, chunk_seconds: float = 8.0, overlap_seconds: float = 1.0):
        sr = translator.frontend.sample_rate
        self.translator = translator
        self.chunk = int(chunk_seconds * sr)
        self.overlap = int(overlap_seconds * sr)
        if self.chunk <= 2 * self.overlap:
            raise ValueError(f"chunk ({self.chunk}) must exceed 2*overlap ({2 * self.overlap})")
        self.hop = self.chunk - 2 * self.overlap
        self._T_mel = mel_num_frames(self.chunk, translator.frontend)

        self._buf: List[np.ndarray] = []   # samples from _buf_start onward
        self._buf_start = 0                # absolute index of _buf[0][0]
        self._total = 0                    # samples fed so far
        self._next_start = 0               # next window's absolute start
        self._keep_end = 0                 # absolute sample the stitch reached
        self._lp_pieces: List[np.ndarray] = []  # kept frames (beam finish)
        self._prev_tok = translator.vocab.blank_id  # greedy collapse state
        self._committed: List[str] = []
        self._finished: Optional[str] = None

    def feed(self, samples: np.ndarray) -> str:
        """Append PCM samples; process every window that is now complete and
        cannot be the final one (a window is final only if the stream ends
        within it, unknowable until ``finish``, hence the strict >).
        Returns the committed partial transcript."""
        if self._finished is not None:
            raise RuntimeError("stream already finished")
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size:
            self._buf.append(samples)
            self._total += samples.size
        while self._total > self._next_start + self.chunk:
            self._process_window(self._next_start, final=False)
            self._next_start += self.hop
            self._drop_consumed()
        return self.partial()

    def partial(self) -> str:
        """Transcript of all committed (stitch-stable) frames so far."""
        if self._finished is not None:
            return self._finished
        return "".join(self._committed)

    def finish(self) -> str:
        """Run the final right-aligned window and return the transcript
        (beam-decoded over all kept frames when the translator has a beam
        decoder, else the incremental greedy result)."""
        if self._finished is not None:
            return self._finished
        if self._total > self._keep_end:
            self._process_window(max(self._total - self.chunk, 0), final=True)
        if self.translator.beam_decoder is not None and self._lp_pieces:
            stitched = np.concatenate(self._lp_pieces, axis=0)[None]
            total = np.asarray([stitched.shape[1]], np.int32)
            self._finished = self.translator.beam_decoder.forward(stitched, total)[0]
        else:
            self._finished = "".join(self._committed)
        self._buf, self._lp_pieces = [], []
        return self._finished

    @property
    def samples_fed(self) -> int:
        return self._total

    def _drop_consumed(self) -> None:
        """Free buffered samples no window will read again, so a session
        holds O(chunk) samples.  The bound is not ``_next_start``: the
        stream may end at any moment, and the final right-aligned window
        then starts at ``total - chunk``, before ``_next_start`` whenever
        the stream ends within ``2*overlap`` of a hop boundary."""
        bound = min(self._next_start, max(self._total - self.chunk, 0))
        while self._buf and self._buf_start + self._buf[0].size <= bound:
            self._buf_start += self._buf[0].size
            self._buf.pop(0)

    def _window_samples(self, start: int) -> np.ndarray:
        """Zero-padded (chunk,) copy of absolute samples [start, start+chunk)."""
        if start < self._buf_start:
            raise RuntimeError(f"window start {start} reads samples already freed "
                               f"(buffer begins at {self._buf_start})")
        out = np.zeros(self.chunk, np.float32)
        pos = self._buf_start
        for piece in self._buf:
            lo = max(start, pos)
            hi = min(start + self.chunk, pos + piece.size)
            if hi > lo:
                out[lo - start: hi - start] = piece[lo - pos: hi - pos]
            pos += piece.size
            if pos >= start + self.chunk:
                break
        return out

    def _process_window(self, start: int, final: bool) -> None:
        tr = self.translator
        n_valid = min(self._total, start + self.chunk) - start
        log_probs, out_lens = tr._forward(
            torch.from_numpy(self._window_samples(start)[None]).to(tr.device),
            torch.tensor([n_valid], dtype=torch.int32, device=tr.device))
        frames = int(out_lens[0])
        keep_lo = self._keep_end - start          # 0 for the first window
        keep_hi = (self._total - start) if final else (self.chunk - self.overlap)
        f_lo = out_frame(keep_lo, frames, self._T_mel, tr.frontend)
        f_hi = max(out_frame(keep_hi, frames, self._T_mel, tr.frontend), f_lo)
        lp = log_probs[0, f_lo:f_hi].cpu().numpy()
        self._keep_end = start + keep_hi
        if tr.beam_decoder is not None:
            self._lp_pieces.append(lp)
        # incremental greedy collapse, the previous frame's token carried
        # across windows
        blank, labels = tr.vocab.blank_id, tr.vocab.labels
        prev = self._prev_tok
        for t in np.argmax(lp, axis=-1) if lp.size else ():
            if t != blank and t != prev:
                self._committed.append(labels[int(t)])
            prev = int(t)
        self._prev_tok = prev
