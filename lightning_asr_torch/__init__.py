"""lightning_asr_torch — the PyTorch / CUDA port of ``lightning_asr_tpu``.

The module layout mirrors the JAX package so that each port sits at the
same path as its counterpart.  The JAX package is the reference the port is
tested against; this package imports neither it nor JAX.

Layering (bottom → top):
  csrc/      hand-written CUDA C++ kernels for Hopper (sm_90a)
  ops/       mel frontend (+ fused log-mel kernel), LSTM recurrence and its
             backward (+ kernels), CTC loss (+ alpha / beta kernels),
             SpecAugment
  data/      vocabulary, WAV decode
  models/    QuartNet12Context + CTC head (nn.Modules, eval and train)
  optim/     NovoGrad, cosine warmup restarts, gradient clipping
  decoding/  greedy CTC decode
  training/  train and eval steps; the port's checkpoint format
             (state.pt + metadata.json)
  utils/     device selection, flax <-> torch weight bridge
  inference/ AsrTranslator + HTTP server

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
