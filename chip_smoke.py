#!/usr/bin/env python3
"""Drive the PyTorch port's serving, decoding, training, trainer, SSL (also
over data-parallel ranks), data-parallel, tensor-parallel, LSTM-head and
mmap-cache paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the last line:

  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from lightning_asr_torch/csrc (time,
     whether it came from the cache, and the tensor-core HMMA instructions
     of each library from cuobjdump where the toolkit has it), and beside
     it the g++ build of the native decoder library (native/ctc_decoder);
  3. K1, the fused log-mel kernel, at the serving shape (8 float32 rows of
     16 s, 1601 frames) and at the training shape (32 dithered int16 rows
     padded to 16.7 s, 1671 frames), against its plain PyTorch version on
     the card, with its time, the plain version's and torch.stft's as a
     yardstick, its achieved TFLOP/s and its share of the bound;
  4. K2, the BiLSTM recurrence kernel (B=8, T=801, C=256, H=40, ragged
     lengths, both directions), the same way, with cuDNN's packed LSTM as
     the yardstick; its cell-state output (training) leaves h bit for bit;
     its shared memory against the stated layout, its registers and
     spills, its time a sequential step, and digests of h and c at that
     shape and at the training shape (phase 11's inputs, with the cell
     output);
  5. K6, the fused preemphasis + extension kernel, at the serving and the
     training shapes, against its plain version, bit for bit, with the
     wrapper's time by CUDA events and the kernel's own device time by
     torch.profiler, each beside the bound;
  6. K9, K10 and K11, the separable-conv forward and backward and the
     depthwise weight gradient, in bf16 at B=32, T'=836 for three layers of
     the model (256->256 k33, 336->512 k51, 512->512 k87), against their
     plain versions (K9 and K10's dx within one bf16 ulp, the weight
     gradients relative to their largest value), run twice for the same
     bits, with cuDNN's F.conv1d pair, its autograd backward and its
     depthwise weight gradient as the yardsticks, each one's achieved
     TFLOP/s and share of its bound, K10's and K11's device time by kernel
     (torch.profiler); and K9's float32 instantiation at the widest layer;
  7. serving: a full-width quartznet12_context checkpoint made from seeded
     weights (bf16 convs, "default" frontend tier) is loaded by
     AsrTranslator on the card and served over HTTP with dynamic batching;
     8 concurrent WAV requests of 2-16 s must answer 200 as one device
     batch, a wrong form field 400, K1, K2 and K6 must launch once; the
     served batch's log-probs on the card must agree with the same
     translator on the CPU, and the served texts must be the card's
     transcription of it; then serving_sepconv: the same with
     AsrTranslator(conv_kernel="sepconv"), K9 launched 14 times;
  8. profile: one steady serving batch's host-clock latency and, from
     torch.profiler, its device time by kernel group;
  9. encoders: the other three encoders (quartznet12_context_se,
     quartznet15x5, quartznet10x5), each a seeded full-width checkpoint
     (with_teeth's BatchNorm terms, running statistics from train-mode
     passes, the decoder scaled to a class std of 0.8: calibrated_teeth)
     served as in phase 7 (K2 once in the SE burst, none in the others;
     15x5 also with conv_kernel="sepconv", K9 26 times), the served batch in
     float32 on the card against the CPU, a steady batch profiled as in
     phase 8, and for the SE encoder a 90 s wave through translate_long
     against StreamingTranscriber (C13: the stitched log-probs within the
     bf16 serving bounds, the texts compared); then five training configurations
     (SE, SE with fuse_directions, 15x5 sepconv, 15x5 dw_wgrad, 10x5), 8
     bf16 steps each as in phase 14 and one float32 step each card against
     CPU as in phase 15, but from the CPU's log-mels and bound by the card's
     own move under a 1e-7 change of them (the seeded stacks are chaotic),
     the step from waves recorded beside; one ``encoders`` line an encoder: served ms a
     batch, audio-s/s, device busy share, card-vs-CPU errors in bf16 and
     float32, each training configuration's step and parity;
 10. decoding: over the serving checkpoint and the served batch's
     log-probs on the card (8 rows of up to 801 frames, 29 classes): the
     native library's build; a 3-gram ARPA LM by scripts/make_arpa_lm.py;
     the greedy collapse on the card equal to the host's and to the served
     texts; the device beam search (K=40) twice for the same bits, against
     itself on the CPU (prefixes equal, scores within BEAM_SCORE_RTOL),
     against the native search's texts (beam 64, no pruning, no LM) on a
     lattice peaked as a trained model's, and on the served batch (the
     same width; the rows that agree counted, the others scored by exact
     CTC); the native search with the LM, and with one hot word that flips the
     decision it was built for; translate_long of a 90 s wave (20 s
     windows, 2 s overlap) against the CPU translator's stitched log-probs
     and StreamingTranscriber fed 1 s blocks; evaluate_manifest over 16
     WAVs with confidences and a CSV against word_error_rate; the predict
     CLI with --manifest --lm --hotword --csv --confidence; K1, K2 and K6
     once a forward; times of the device beam (events, host clock, its
     device share and launches by torch.profiler), of the native search
     with and without the LM, of translate_long, and evaluate_manifest's
     audio-seconds per second;
 11. K3, the BiLSTM backward kernel (its gates pass and its walk), at the
     training shape (B=32, T'=836, the 16.7 s bucket after the stride-2
     stem), against its plain version, twice for the same bits, with its
     time a sequential step beside K2's, its device time by kernel, its
     shared memory against the stated layout, its HMMA count and its
     kernels' registers and spills, and cuDNN's packed LSTM forward +
     backward as the yardstick; K2 with its cell-state output at that shape
     against its plain version too;
 12. K7 and K8, the batch-stacked BiLSTM recurrence (both directions as the
     2B rows of one walk) and its backward, at that shape against their
     plain versions and against K2 / K3 on the same inputs (K7's h equal
     to K2's bit for bit), run twice for the same bits, with cuDNN's packed
     LSTM forward (and forward + backward) as the yardsticks; K7's, K8's,
     K3's and K2's time a sequential step, K7's and K8's shared memory
     against the stated layouts, and K7's registers and spills;
 13. K4 and K5, the CTC alpha and beta + gradient kernels (B=32, T'=836,
     C=29, ~15 labels a second, one impossible alignment), against their
     plain versions and against PyTorch's own CTC (its forward and backward
     ops as the yardsticks), each twice for the same bits, with their time
     a sequential step, their rings and shared memory against the stated
     layouts, and K4's registers and spills;
 14. training: a seeded full-width bf16 quartznet12_context takes 20 steps
     of the recipe (dither, SpecAugment, fused NovoGrad, the NaN guard) on
     one batch of 32 int16 waves of 2-16.7 s; the loss must be finite and
     fall, nan_count stay 0, and K1-K6 launch once a step; the steady
     steps' host-clock times, audio-seconds trained per second (the audio of
     the steady steps over their summed time), device time by kernel group
     (torch.profiler) and peak memory; then training_sepconv,
     training_dw_wgrad and training_fused_bidir, 8 steps each of the model
     built with that conv_kernel or with fuse_directions, K9 and K10 (or
     K11) launched 14 times a step, or K7 and K8 once in place of K2 and K3;
 15. training parity: one float32 step from one state and one batch (B=4,
     4 s bucket, no dither, augmentation or dropout) on the card and on the
     CPU: loss, grad norm, per-tensor gradients, parameter updates; for each
     of the four configurations; for the default one also the same card
     step with K1's plain version in place of K1, which shows how much of
     the card-vs-CPU gap K1's summation order accounts for;
 16. trainer: ``python -m lightning_asr_torch.train`` (its ``main``) with
     LASR_LSTM_FUSED_BIDIR=1 on a tone-language corpus of 128 + 32 WAVs of
     0.5-3 s written to a temporary directory, the default full-width model
     in bf16, batch 32, 3 epochs validated each, then one more epoch resumed
     from ``last`` under torch.profiler: losses finite and the epoch mean
     falling, val_wer finite, at most 3 top-k checkpoints and ``last``, the
     resumed run starting at the saved step + 1, K7 launched once a train
     step and evaluation batch and K8 once a train step (K2, K3 never);
     AsrTranslator on the card transcribes an utterance from ``last``;
     epoch times, audio-seconds per second and the step's share of them;
 17. ssl: the SSL paths at the ssl-conf batch, 32 rows of 2-16.7 s (835
     wav2vec2 frames, T'=418 after the stem), each a handful of steps on one
     batch with K1-K6's launches a step, step times, audio-seconds trained
     per second, device time by kernel group, peak memory and the losses,
     and one float32 step card against CPU (bound as phase 9's, by the
     card's own move under a 1e-7 change of its inputs): the feature step
     (AsrModel(feature_in=512) in bf16, cutout, 512 features a frame); the
     dual step (DualStreamAsrModel in float32, the mel stream at
     DUAL_MEL_CONFIG from 267,200 raw samples a row: K6 at pad 0, hop 320
     held bit for bit against its plain version on that batch; K1 does not
     run); the retrain step (SSLRetrainAsrModel, the 7 x 512 "layer" feature
     encoder in float32 on int16 waves, 834 frames), with its forward card
     against CPU; then ``python -m lightning_asr_torch.train_ssl`` (a pseudo
     pass after epochs 1 and 2 that decodes, injects and grows the next
     epoch), ``train_ssl ssl.retrain=true`` and ``python -m
     lightning_asr_torch.train_ssl_double`` through their ``main`` on a
     tone-language corpus with seeded feature pickles, each one's launches
     against its steps and evaluation batches; and the train_ssl checkpoint
     served: the translator's feature forward on the card against the CPU
     (bf16 and float32) on precomputed features; then (``ssl_data_parallel``)
     the same paths over 2 ranks sharing the card over gloo, in worker
     processes as in phase 18: 4 bf16 feature steps with cutout at 16 rows
     a rank (losses and parameters bit for bit across the ranks, losses
     within DP_BF16_LOSS_RTOL of one process, K2-K5 once a step on each),
     one float32 step of each mode (feature, dual, retrain) against one
     process under DP_TOL with K6 once in the dual step and bit for bit
     against its plain version on the rank's raw rows; ``python -m
     lightning_asr_torch.train_ssl`` (its ``main``) as 2 ranks for 2 epochs
     with a pseudo pass after each (the same metrics on both ranks, the
     gathered pool equal to a one-process pass's from the same ``last``,
     ``pseudo_total`` counting the pool once, ``last`` written once and
     loaded by AsrTranslator) and ``train_ssl_double`` as 2 ranks for an
     epoch, each rank's launches against its steps and evaluation batches;
     the step ms of one process and of each rank and the gloo all-reduce,
     beside the card's name and power limit;
 18. data_parallel: ranks in worker processes of this script
     (``chip_smoke.py --dp-worker TASK SPEC``, started with a launcher's
     variables): 2 ranks sharing the card over gloo take 4 steps of phase
     14's recipe on its batch, 16 rows each: their losses and parameters bit
     for bit, their losses within DP_BF16_LOSS_RTOL of one process on the
     whole batch, K1-K6 once a step on each rank; one float32 step (no dither
     or augmentation) and one at accumulate_grad_batches=2, 2 ranks against
     one process, under DP_TOL; 2 steps at a world of 1 over NCCL against
     the same steps with no process group, bit for bit (cuDNN deterministic);
     ``python -m lightning_asr_torch.train`` (its ``main``) as 2 ranks over
     gloo on phase 16's corpus for one epoch and a validation: the same val
     and test metrics on both ranks, ``last`` written once (by rank 0), K1-K6
     once a train step (K1, K2, K4, K6 once an eval batch), AsrTranslator on
     the card loading ``last``; the step ms of one process and of each rank
     sharing the card and the gloo all-reduce of the flat gradient, beside
     the card's name and power limit;
 19. tensor_parallel: K9/K10 at the local widths of a model group of 2
     (gathered Cin, this rank's Cout: (256, 128, 33), (336, 256, 51), (512,
     256, 87)) and K11 at this rank's C (32, 128, 168, 256) against their
     plain versions under phase 6's limits, twice for the same bits; then
     ranks in worker processes as in phase 18: a model group of 2 ranks
     sharing the card over gloo (dp1 x tp2) splits the default model's
     trunk and takes 4 of phase 14's recipe steps on its batch: losses and
     gathered parameters bit for bit across the ranks, losses within
     DP_BF16_LOSS_RTOL of one process (per-tensor NovoGrad), the gathered
     parameters within TP_BF16_UPDATE_REL of it (the one process's own move
     under a one-LSB change beside), K1-K6 once a step; one step with the
     gathers timed; one float32 step of each conv route (F.conv1d,
     dw_wgrad, sepconv) against one process under DP_TOL, the context
     BiLSTM's gradient on a line of its own; 4 ranks (dp2 x tp2) take 2
     steps on 8 rows of up to 4 s against one process; ``python -m
     lightning_asr_torch.train train.tp=2 train.n_devices=2`` (its
     ``main``) as 2 ranks on phase 16's corpus for one epoch and a
     validation: the same metrics on both ranks, ``last`` written once with
     whole tensors, resumed by one process (fused NovoGrad) for an epoch,
     and AsrTranslator on the card loading it; each rank's step ms, the
     gathers' count, bytes and ms a step, beside the card's name and power
     limit (ranks sharing one card through the host, not tp across cards);
 20. lstm_head_and_data: the LSTM head and the data surface.  First
     (``lstm_h128``) K2, K3, K7 and K8 at the head's H=128 at the training
     shape (B=32, T'=836, ragged rows, input width 1024) against their
     plain versions, twice for the same bits, K7's h equal to K2's, their
     shared memory as stated, their times, bounds, cuDNN's packed BiLSTM at
     hidden 128 and the registers and spills of the H=128 instantiations;
     K7 and K8 on a mask with holes; K2's device time (its pair walk,
     whose CTAs fill their pad frames after the walk), K3's, K7's and K8's
     split into their passes, the clusters of K2's and K7's walks and of
     K3's and K8's walks and dW passes the card holds at once, and 0 bytes
     of spill in K2's, K3's, K7's and K8's H=128 kernels.
     Then the head model
     (quartznet12_context with ``lstm_head=True``, bf16 convs, mask on,
     seeded by ``head_teeth``): an eval forward at the
     serving shape (8 rows of 2-16 s, 1601 frames), also with
     ``fuse_directions``, against the CPU under the serving bounds;
     ``training_lstm_head`` and ``training_lstm_head_fused_bidir``, HEAD_STEPS
     bf16 recipe steps each (finite, falling loss; the LSTM kernels twice a
     step, once at H=128); one float32 step of each against the CPU under
     TRAIN_TOL.  Then ``data.cache=mmap``: the native loader on a tone
     corpus against ``read_audio``'s int16, the training CLI with
     ``data.cache=mmap`` in this process (every file decoded by the loader,
     none by ``read_audio``), again in a fresh process (no append: the
     bin's size and the index unchanged) and with ``data.cache=ram``, the
     three runs' metrics equal; the H=40 digests of phase 4 are repeated;
 21. a {"kernels": [...]} line: per kernel K1-K11 its launches on the main
     paths (the serving bursts of every encoder, the decoding phase's
     forwards, the training steps of the nine configurations and of the
     head's two, the trainer's runs, the mmap and RAM CLI runs, the SSL
     phase's steps, runs and served forwards and its ranks' steps and CLI
     runs, the data-parallel ranks' steps and CLI runs, and the
     tensor-parallel ranks' steps and CLI runs, also alone as
     ``tp_launches``), its error against the plain version, its time,
     the plain version's, the library yardstick's, and the least time the
     card could take (K1 and K2 at the serving shape, K3-K8 at the training
     shape, K9-K11 at the widest layer); K2, K3, K7 and K8 also under
     ``h128`` at H=128 (launches on the head's paths);
 22. {"ok": true, "device": {...}} as the last line.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import hashlib
import http.client
import io
import json
import os
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from lightning_asr_torch import native
from lightning_asr_torch.data.audio import read_audio, wav_bytes, write_wav
from lightning_asr_torch.data.pipeline import BucketBatcher
from lightning_asr_torch.decoding.beam_search import BeamSearchDecoderWithLM
from lightning_asr_torch.decoding.device_beam import DeviceBeamSearchDecoder, beam_search_device
from lightning_asr_torch.decoding.greedy import (compact_to_strings, greedy_collapse_device,
                                                 greedy_emit_mask)
from lightning_asr_torch.inference.predict import AsrTranslator, plan_chunks
from lightning_asr_torch.inference.server import make_stdlib_server
from lightning_asr_torch.inference.streaming import StreamingTranscriber
from lightning_asr_torch.metrics.wer import word_error_rate
from lightning_asr_torch.models.dual_stream import DUAL_MEL_CONFIG, DualStreamAsrModel
from lightning_asr_torch.models.layers import MaskedBatchNorm
from lightning_asr_torch.models.quartznet import build_model, reset_parameters
from lightning_asr_torch.ops import kernel_build
from lightning_asr_torch.ops.ctc_kernels import (ALPHA_RING, ctc_alpha, ctc_alpha_plain,
                                                 ctc_alpha_smem_bytes, ctc_alpha_smem_on_card,
                                                 ctc_beta, ctc_beta_plain, ctc_beta_ring,
                                                 ctc_beta_smem_bytes, ctc_beta_smem_on_card,
                                                 ctc_loss)
from lightning_asr_torch.ops.frontend import (MelFrontendConfig, _preemphasis, expand_wire,
                                              extended_batch, log_mel_spectrogram, mel_filterbank)
from lightning_asr_torch.ops.depthwise_kernels import depthwise_wgrad, depthwise_wgrad_plain
from lightning_asr_torch.ops import frontend_kernels
from lightning_asr_torch.ops.frontend_kernels import (extend_preemph, extend_preemph_plain,
                                                      mel_from_extended, mel_from_extended_plain,
                                                      window_range)
from lightning_asr_torch.ops.lstm import stack_directions, stacked_valid, unstack_directions
from lightning_asr_torch.ops.lstm_kernels import (backward_clusters_on_card, backward_smem_bytes,
                                                  backward_smem_on_card, forward_clusters_on_card,
                                                  forward_smem_bytes, forward_smem_on_card,
                                                  lstm_backward, lstm_backward_plain,
                                                  lstm_backward_stacked, lstm_backward_stacked_plain,
                                                  lstm_recurrence, lstm_recurrence_plain,
                                                  lstm_recurrence_stacked,
                                                  lstm_recurrence_stacked_plain,
                                                  stacked_backward_clusters_on_card,
                                                  stacked_backward_smem_bytes,
                                                  stacked_backward_smem_on_card,
                                                  stacked_forward_clusters_on_card,
                                                  stacked_forward_smem_bytes,
                                                  stacked_forward_smem_on_card)
from lightning_asr_torch.ops.sepconv_kernels import (sepconv_backward, sepconv_backward_plain,
                                                     sepconv_forward, sepconv_forward_plain)
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
from lightning_asr_torch.optim.novograd import GradientTransformation
from lightning_asr_torch.parallel import distributed, tp
from lightning_asr_torch.parallel.mesh import local_rows
from lightning_asr_torch.predict import main as predict_main
from lightning_asr_torch.ssl_codec.retrain import SSLRetrainAsrModel
from lightning_asr_torch.ssl_codec.ssl_datamodule import SSLDataModule
from lightning_asr_torch.ssl_codec.wav2vec import output_lengths as ssl_output_lengths
from lightning_asr_torch.train import main as train_main
from lightning_asr_torch.train_ssl import main as ssl_train_main
from lightning_asr_torch.train_ssl_double import main as ssl_double_main
from lightning_asr_torch.training import steps as ssl_steps
from lightning_asr_torch.training.checkpoint import (TRAIN_STATE_FILE, load_checkpoint,
                                                     save_checkpoint)
from lightning_asr_torch.training.ssl_trainer import SSLTrainer
from lightning_asr_torch.training.steps import (create_train_state, make_dual_train_step,
                                                make_raw_ssl_train_step, make_train_step)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

# One bf16 rounding flip of one power term moves a mel value by at most
# 10·log10(1 + 2^-8) = 0.017 dB; the narrowest mel filters span two bins.
K1_TOL_DB = 2 * 10 * np.log10(1 + 2.0 ** -8)
# float32 recurrence: dot sums in another order and the card's expf/tanhf,
# carried through up to 836 dependent steps with |h| < 1
K2_TOL = 1e-4
# bf16 model, card vs CPU, over the valid frames of the served batch: cuDNN
# and oneDNN round each conv's bf16 output from different fp32 sums (2^-8
# relative), through 16 blocks.  The same model in bf16 against float32 on
# the CPU, on the same batch, differs by max 0.23, mean 0.039, argmax
# agreement 0.980; the card's bf16 against the CPU's differs by mean 0.032
# on an H100, so the two bf16 roundings are largely independent.
SERVE_TOL_MAX, SERVE_TOL_MEAN, SERVE_MIN_ARGMAX = 0.5, 0.05, 0.9
# The tighter check: the card's bf16 log-probs may lie no further from the
# float32 model's (on the CPU) than the CPU's bf16 log-probs do, by mean
# over valid frames, within this factor.
SERVE_BF16_GAP_RATIO = 1.25
# With these seeded weights nearly every frame's argmax is one class, so a
# text hangs on a few near-tied frames: bf16 against float32 on the CPU
# gives a character error rate of 0.355 on the served batch.
SERVE_MAX_CER = 0.5
# transcribe_batch calls timed on the host clock, and calls profiled
PROFILE_ITERS = (10, 3)
# K3 against its plain version, float32: the gate recompute, dh_prev and
# the dW_hh sums run in another order, through up to 836 dependent steps;
# dW_hh sums 32 rows x 836 frames of products (bound relative to its max)
K3_TOL_DX, K3_TOL_DW = 1e-4, 1e-4
# K4/K5 against their plain versions: float32 log-space sums with the
# card's expf/logf, a few ulps a step over 836 steps, relative to |ll| up
# to ~3000; gradients are probabilities times the upstream 1/B
K45_TOL_REL, K45_TOL_GRAD = 1e-5, 1e-5
# the port's CTC losses against PyTorch's (another algorithm, float32)
CTC_TORCH_TOL_REL = 1e-4
# torch.profiler on the H100 host drops some of the card's kernel records:
# now and then one of thousands, at times every record of a short pass (a
# 5-call pass of K5, three passes running).  A pass counts if the card
# recorded all but at most PROFILER_MISSING_SHARE of the kernels the host
# launched in it; after PROFILER_PASSES passes without one, CUDA events time
# the calls instead, under EVENTS_KEY: the span of the calls on the stream,
# idle gaps included
PROFILER_PASSES, PROFILER_MISSING_SHARE = 6, 0.01
EVENTS_KEY = "all kernels (CUDA events)"
# what kernel_times saw in each call: printed as the "profiler" line
PROFILER_LOG = []
# training: rows of the batch, steps on it, and steps profiled
TRAIN_BATCH, TRAIN_STEPS, TRAIN_PROFILE_STEPS = 32, 20, 3
# training parity, card vs CPU, one float32 step (no TF32): conv sums in
# another order through 16 blocks in train-mode BatchNorm; the CPU tests
# saw this network's gradients move by up to 2% from 1e-6 input changes
TRAIN_TOL = {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "grad_rel": 5e-2, "update_rel": 5e-2}

# K9/K10 against their plain versions: the depthwise sums run in the plain
# version's order, so only the pointwise (and dz) products' float32 sums
# differ before the rounding to bf16: at most one bf16 ulp of the value, plus
# a float32 slack of 2^-17 of the largest value where a sum cancels; the
# float32 weight gradients sum 26,752 row-frames in another order, bounded
# relative to their largest value
SEPCONV_SLACK, SEPCONV_TOL_GRAD = 2.0 ** -17, 1e-4
# K11: the same bf16-rounded products as its plain version, summed in
# another order within each 256-frame chunk
K11_TOL = 1e-4
# the separable layers K9-K11 are checked and timed at (Cin, Cout, k): the
# narrowest trunk block, the context block and the widest
SEPCONV_LAYERS = ((256, 256, 33), (336, 512, 51), (512, 512, 87))
# steps of each conv-kernel training configuration, and of fuse_directions
CONV_TRAIN_STEPS = 8
# K7/K8 against their plain versions and against K2/K3 on the same inputs:
# the bounds of K2 and K3 (the same float32 recurrences, sums in another
# order); c_prev, whose |c| grows past 1, as K2's cell output
# trainer phase: a tone-language corpus of 0.5-3 s utterances in one 3 s
# bucket, batch 32, epochs before the resume and after it
TRAINER_UTTS, TRAINER_DEV_UTTS, TRAINER_EPOCHS = 128, 32, 3
FUSED_SWITCH = "LASR_LSTM_FUSED_BIDIR"

# the encoders phase: the encoders besides the default, their configurations
# trained for CONV_TRAIN_STEPS steps and held card against CPU (encoder,
# conv_kernel, fuse_directions), and the stride-1 SepConvs of each encoder
# that conv_kernel routes (the SE convs have no route)
DEFAULT_ENCODER = "quartznet12_context"
OTHER_ENCODERS = ("quartznet12_context_se", "quartznet15x5", "quartznet10x5")
LSTM_ENCODERS = ("quartznet12_context", "quartznet12_context_se")
ROUTED_CONVS = {"quartznet12_context": 14, "quartznet12_context_se": 0, "quartznet15x5": 26,
                "quartznet10x5": 51}
SEPCONV_SERVED = "quartznet15x5"       # also served with conv_kernel="sepconv"
ENCODER_CONFIGS = (("quartznet12_context_se", None, False), ("quartznet12_context_se", None, True),
                   ("quartznet15x5", "sepconv", False), ("quartznet15x5", "dw_wgrad", False),
                   ("quartznet10x5", None, False))
# float32 step of the other encoders, card against CPU from the same
# features: these seeded train-mode stacks are chaotic (a ReLU input within
# rounding of 0 flips, and the flip reaches every gradient before it); on an
# H100 the card's own gradients moved by up to 2.5% (SE), 2.0% (15x5) and
# 8.1% (10x5) when its features moved by 1e-7 relative, and its gap to the
# CPU was 0.83-1.88 times that move.  So each bound is the larger of
# TRAIN_TOL's and this factor times the move measured in the run.
CHAOS_GAP_RATIO = 2.0
# conv biases that a train-mode BatchNorm follows: their gradient is zero
ZERO_GRAD_BIASES = {"quartznet15x5": ("encoder.first_cnn.bias", "encoder.last_conv.bias"),
                    "quartznet10x5": ("encoder.last_conv.bias",)}
# float32 served log-probs, card against CPU, over valid frames: the card's
# K1 sums the frontend in another order (within 0.031 dB, C4), which the
# float32 network carries into the log-probs; the bounds of the CPU test of
# the same frontend gap (tests/test_torch_serving.py)
SERVE32_TOL_MAX, SERVE32_TOL_MEAN, SERVE32_MIN_ARGMAX = 5e-2, 1e-3, 0.98
# calibrated_teeth: the train-mode passes that set the other encoders'
# BatchNorm statistics, and the class std their log-probs are scaled to on
# random features (0.6-0.8 on the served batch, above its check's 0.5)
CALIBRATION_PASSES, TEETH_CLASS_STD = 30, 0.8

SR = 16000
LABELS = [" ", "'"] + [chr(ord("a") + i) for i in range(26)]
BLANK = len(LABELS)
TRAIN_BUCKET_S = 16.7                 # conf.yaml train_max_duration, a bucket
T_TRAIN = 836                         # its frames after the stride-2 stem
HEAD_HIDDEN = 128                     # the LSTM head's hidden size (build_model lstm_head)
# K2's kernels at H=128 (csrc/lstm.cu: the pair walk), as ptxas names them
K2_H128_KERNELS = ("lstm_fwd_pair_kernel<128,4>", "lstm_fwd_pair_kernel<128,1>")
# K7's kernels at H=128 (csrc/lstm_bidir.cu: K2's pair walk on the stacked
# rows; its step lists take no H)
K7_H128_KERNELS = ("lstm_stacked_fwd_pair_kernel<128,4>", "lstm_stacked_fwd_pair_kernel<128,1>")
# K3's kernels at H=128 (csrc/lstm_bwd.cu)
K3_H128_KERNELS = ("lstm_bwd_gates_kernel<128>", "lstm_bwd_pair_kernel<128,4>",
                   "lstm_bwd_pair_kernel<128,1>", "lstm_bwd_dw_kernel<128,4>",
                   "lstm_bwd_dw_kernel<128,1>")
# K8's kernels at H=128 (csrc/lstm_bidir.cu; its step lists take no H)
K8_H128_KERNELS = ("lstm_stacked_bwd_gates_kernel<128>", "lstm_stacked_bwd_pair_kernel<128,4>",
                   "lstm_stacked_bwd_pair_kernel<128,1>", "lstm_stacked_bwd_dw_kernel<128,4>",
                   "lstm_stacked_bwd_dw_kernel<128,1>")
# K8's call at H=128 on a mask with holes: rows, steps, the share of valid steps
HOLES_B, HOLES_T, HOLES_VALID = 4, 70, 0.7
# the LSTM head phase: its bf16 steps, the train-mode passes that set its
# BatchNorm statistics, and the mmap trainer's corpus and epochs
HEAD_STEPS, HEAD_CALIBRATION_PASSES = 6, 10
MMAP_UTTS, MMAP_DEV_UTTS, MMAP_EPOCHS, MMAP_BATCH = 64, 32, 2, 32
CHARS_PER_S = 15

# the decoding phase: the sentences of the LM corpus, the peaked lattice
# and the manifest
LM_SENTENCES = ("the cat sat on the mat", "the dog sat on the log", "a cat and a dog",
                "the cat ate the rat", "a dog ate a bone", "the rat sat")
# device beam width, the native search's width when held against it on a
# peaked lattice, and the long wave's length, window and overlap in seconds
DEVICE_BEAM_K, NATIVE_BEAM_K = 40, 64
LONG_S, CHUNK_S, OVERLAP_S = 90.0, 20.0, 2.0
MANIFEST_UTTS, MANIFEST_BATCH = 16, 8
MANIFEST_MIN_S, MANIFEST_MAX_S = 2.0, 16.0
# device beam, card against the CPU: scores are float32 log-space sums over
# up to 801 steps through the card's exp/log1p/log and the CPU's, a few ulps
# a step (the CPU tests hold the CPU against JAX at 1e-5 over 32 steps)
BEAM_SCORE_RTOL = 1e-5
# boost above a runner-up's score gap that a hot word is given, and the
# decisions tried until one flips
HOTWORD_MARGIN, HOTWORD_TRIES = 20.0, 24
# frames of the served batch over which torch.profiler reads the device
# beam's kernels
BEAM_PROFILE_STEPS = 100


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call on the card, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, kind: str):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _k1_at(dev, cfg: MelFrontendConfig, waves, lens, generator=None) -> dict:
    """K1 against its plain version on the signal the frontend builds from
    ``waves`` (wire expansion, dither with ``generator``, preemphasis,
    extension), with times and bound."""
    q, T = extended_batch(waves, lens, cfg, generator)
    q = q.contiguous()
    B = waves.shape[0]
    got = mel_from_extended(q, cfg, T)
    want = mel_from_extended_plain(q, cfg, T)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(got.shape == (B, T, cfg.n_mels) and bool(torch.isfinite(got).all()), "K1 output shape/finite")
    check(err <= K1_TOL_DB, f"K1 at {list(waves.shape)}: max |kernel - plain| = {err} dB > {K1_TOL_DB}")

    ms = cuda_ms(lambda: mel_from_extended(q, cfg, T), 20)
    plain_ms = cuda_ms(lambda: mel_from_extended_plain(q, cfg, T), 10)
    # yardstick: torch.stft + power + filterbank matmul + dB on the
    # zero-padded preemphasized rows (reflect padding by stft itself)
    pre = _preemphasis(expand_wire(waves), None, cfg.preemph)
    x = torch.nn.functional.pad(pre, (cfg.pad, cfg.pad))
    window = torch.hann_window(cfg.win_length, periodic=True, device=dev)
    fb = torch.from_numpy(mel_filterbank(cfg)).to(dev)

    def library():
        spec = torch.stft(x, cfg.n_fft, cfg.hop_length, cfg.win_length, window, center=True,
                          pad_mode="reflect", return_complex=True)
        mel = torch.matmul(spec.abs().pow(2).transpose(1, 2), fb)
        return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))

    check(library().shape == got.shape, "stft yardstick shape")
    library_ms = cuda_ms(library, 20)
    # bytes: the samples the frames cover, the unpadded DFT table over the
    # window's non-zero samples and the mel table in bf16, the log-mels out;
    # the DFT over those K samples only (the other table rows are exactly 0)
    F = cfg.n_freqs
    n_lo, n_hi = window_range(cfg)
    K = n_hi - n_lo
    span = min(q.shape[1], (T - 1) * cfg.hop_length + cfg.n_fft)
    nbytes = B * span * 4 + (2 * F * K + F * cfg.n_mels) * 2 + got.numel() * 4
    flops = B * T * (2 * 2 * F * K + 3 * F + 2 * F * cfg.n_mels)
    bound_ms, bound_by = bound(nbytes, flops, "bf16")
    return {"shape": [B, waves.shape[1], T], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "tflops": flops / ms * 1e-9, "bound_share": bound_ms / ms}


def phase_k1(dev) -> dict:
    cfg = MelFrontendConfig(precision="default")
    rng = np.random.default_rng(0)
    B, S = 8, 16 * SR
    waves = torch.from_numpy((rng.standard_normal((B, S)) * 0.1).astype(np.float32)).to(dev)
    lens = torch.tensor([S, S - 1, 15 * SR, 12 * SR + 7, 9 * SR, 6 * SR, 3 * SR, 2 * SR + 289],
                        dtype=torch.int32, device=dev)
    mel_from_extended.launches = 0
    serve = _k1_at(dev, cfg, waves, lens)
    # the training step's batch: the training phase's int16 waves, dithered
    batch, _ = train_batch(np.random.default_rng(5), TRAIN_BATCH, TRAIN_BUCKET_S, TRAIN_BUCKET_S)
    train = _k1_at(dev, cfg, torch.from_numpy(batch["waves"]).to(dev),
                   torch.from_numpy(batch["wave_lens"]).to(dev),
                   torch.Generator(device=dev).manual_seed(0))
    res = {"name": "log_mel (K1)", "route": "cuda", "source": "lightning_asr_torch/csrc/mel.cu",
           "replaces": "lightning_asr_tpu/ops/frontend_pallas.py:194",
           **{k: serve[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
           "max_abs_err": max(serve["max_abs_err"], train["max_abs_err"])}
    print(json.dumps({"phase": "K1", "tol_db": K1_TOL_DB, "serving": serve, "training": train,
                      "phase_launches": mel_from_extended.launches}), flush=True)
    return res


def _cudnn_bilstm(dev, w_ih, w_hh, b_ih, b_hh):
    """cuDNN's bidirectional LSTM with the given (2, ...) weights, the
    yardstick of the recurrence kernels (the port never calls it)."""
    ref = torch.nn.LSTM(w_ih.shape[2], w_hh.shape[2], batch_first=True, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(ref, f"weight_ih_l0{sfx}").copy_(w_ih[d])
            getattr(ref, f"weight_hh_l0{sfx}").copy_(w_hh[d])
            getattr(ref, f"bias_ih_l0{sfx}").copy_(b_ih[d])
            getattr(ref, f"bias_hh_l0{sfx}").copy_(b_hh[d])
    return ref


def bilstm_inputs(dev, rng, B: int, T: int, lens_np=None, C: int = 256, H: int = 40):
    """Seeded inputs of the BiLSTM kernels (the context BiLSTM's C=256, H=40
    unless given; both directions): x (B, T, C), the weights (w_ih, w_hh,
    b_ih, b_hh), each (2, ...), the row lengths (``train_rows``' unless
    given) and the input projection xproj (B, T, 2, 4H)."""
    D = 2
    s = 1.0 / np.sqrt(H)
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(dev)
    w_ih, w_hh, b_ih, b_hh = (torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32)).to(dev)
                              for shape in ((D, 4 * H, C), (D, 4 * H, H), (D, 4 * H), (D, 4 * H)))
    if lens_np is None:
        lens_np = train_rows(rng, B)[2]
    lens = torch.from_numpy(lens_np).to(dev)
    xproj = (torch.matmul(x, w_ih.reshape(D * 4 * H, C).t()) + b_ih.reshape(-1)
             + b_hh.reshape(-1)).reshape(B, T, D, 4 * H).contiguous()
    return x, (w_ih, w_hh, b_ih, b_hh), lens_np, lens, xproj


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def phase_k2(dev, ptxas_report: str) -> dict:
    B, T, C, H, D = 8, 801, 256, 40, 2
    x, (w_ih, w_hh, b_ih, b_hh), lens_np, lens, xproj = bilstm_inputs(
        dev, np.random.default_rng(1), B, T, np.array([T, 1, 750, 640, 512, 401, 233, 97], np.int32))

    lstm_recurrence.launches = 0
    got = lstm_recurrence(xproj, lens, w_hh)
    want = lstm_recurrence_plain(xproj, lens, w_hh)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(got.shape == (B, T, D * H) and bool(torch.isfinite(got).all()), "K2 output shape/finite")
    pad_zero = all(bool((got[b, n:] == 0).all()) for b, n in enumerate(lens_np))
    check(pad_zero, "K2 pad frames are not exactly zero")
    check(err <= K2_TOL, f"K2 max |kernel - plain| = {err} > {K2_TOL}")
    # the training variant stores the cell states too, and changes no bit of h
    h_c, cell = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    _, want_cell = lstm_recurrence_plain(xproj, lens, w_hh, with_cell=True)
    cell_err = (cell - want_cell).abs().max().item()
    check(torch.equal(h_c, got), "K2 with the cell output changed h")
    check(cell_err <= 10 * K2_TOL, f"K2 cell states: max |kernel - plain| = {cell_err}")

    smem = forward_smem_on_card(H, dev)
    check(smem == forward_smem_bytes(H),
          f"K2's shared memory on the card {smem} B, stated {forward_smem_bytes(H)} B")
    # at the training shape (phase_k3's inputs, which checks and times K2
    # there): h and c, for their digests
    _, (_, w_hh_t, _, _), _, lens_t, xproj_t = bilstm_inputs(
        dev, np.random.default_rng(3), TRAIN_BATCH, T_TRAIN)
    h_t, c_t = lstm_recurrence(xproj_t, lens_t, w_hh_t, with_cell=True)
    ms = cuda_ms(lambda: lstm_recurrence(xproj, lens, w_hh), 20)
    plain_ms = cuda_ms(lambda: lstm_recurrence_plain(xproj, lens, w_hh), 2, warmup=1)
    # yardstick: cuDNN's bidirectional LSTM over the packed sequence, input
    # projection included (the port never calls it)
    ref = _cudnn_bilstm(dev, w_ih, w_hh, b_ih, b_hh)
    lens_cpu = torch.from_numpy(lens_np.astype(np.int64))

    @torch.no_grad()
    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens_cpu, batch_first=True,
                                                         enforce_sorted=False)
        out, _ = ref(packed)
        return torch.nn.utils.rnn.pad_packed_sequence(out, batch_first=True, total_length=T)[0]

    lib_err = (library() - got).abs().max().item()
    library_ms = cuda_ms(library, 10)
    G = 4 * H
    steps = int(lens_np.sum()) * D
    # bytes: the projections of the valid frames only (the kernel reads no
    # pad frame), W_hh and the lengths in, the whole of h out
    nbytes = steps * G * 4 + w_hh.numel() * 4 + lens.numel() * 4 + got.numel() * 4
    flops = steps * (2 * G * H + 2 * G + 5 * H)
    bound_ms, bound_by = bound(nbytes, flops, "fp32")
    res = {"name": "lstm_recurrence (K2)", "route": "cuda", "source": "lightning_asr_torch/csrc/lstm.cu",
           "replaces": "lightning_asr_tpu/ops/lstm_pallas.py:62",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    print(json.dumps({"phase": "K2", "shape": [B, T, C, H, D], "tol": K2_TOL, "kernel_ms": ms,
                      "cudnn_max_abs_diff": lib_err, "sequential_steps": int(lens_np.max()),
                      "cell_max_abs_err": cell_err, "us_per_step": 1e3 * ms / int(lens_np.max()),
                      "smem_bytes": smem, "ptxas": ptxas_kernels(ptxas_report),
                      "digest": {"h": digest(got), "c": digest(cell)},
                      "training_digest": {"h": digest(h_t), "c": digest(c_t)},
                      "phase_launches": lstm_recurrence.launches, **res}), flush=True)
    res["digests"] = {"serving": {"h": digest(got), "c": digest(cell)},
                      "training": {"h": digest(h_t), "c": digest(c_t)}}
    return res


def _k6_at(cfg: MelFrontendConfig, waves, lens) -> dict:
    """K6 against its plain version on float32 ``waves``, with times and
    bound; the output length is the one the frontend asks for."""
    B, S = waves.shape
    S_ext = S + 2 * cfg.pad + cfg.n_fft
    T = (S_ext - cfg.n_fft) // cfg.hop_length + 1
    out_total = max(S_ext, (T + -(-cfg.n_fft // cfg.hop_length)) * cfg.hop_length)
    got = extend_preemph(waves, lens, None, cfg, out_total)
    want = extend_preemph_plain(waves, lens, None, cfg, out_total)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K6 at {[B, S]}: not bit for bit its plain version "
                                  f"(max |diff| {(got - want).abs().max().item()})")
    ms = cuda_ms(lambda: extend_preemph(waves, lens, None, cfg, out_total), 20)
    plain_ms = cuda_ms(lambda: extend_preemph_plain(waves, lens, None, cfg, out_total), 10)
    # the kernel's own device time: back-to-back wrapper calls pace the
    # events at the host's rate (argument checks, ctypes, the allocation)
    kernels, _, passes = kernel_times(lambda: extend_preemph(waves, lens, None, cfg, out_total), 20)
    device_ms = sum(v for k, v in kernels.items() if _category(k) in ("K6 extend_preemph", EVENTS_KEY))
    check(device_ms > 0, "K6: no extend_kernel time recorded")
    # bytes: the waves and lengths read once, q written once; a multiply and
    # a subtract per body sample
    bound_ms, bound_by = bound(waves.numel() * 4 + B * 4 + got.numel() * 4, 2 * waves.numel(), "fp32")
    return {"shape": [B, S, out_total], "max_abs_err": (got - want).abs().max().item(), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bound_share": bound_ms / ms, "device_ms": device_ms,
            "device_bound_share": bound_ms / device_ms, "profiler_passes": passes}


def phase_k6(dev) -> dict:
    cfg = MelFrontendConfig(precision="default")
    rng = np.random.default_rng(0)
    B, S = 8, 16 * SR
    waves = torch.from_numpy((rng.standard_normal((B, S)) * 0.1).astype(np.float32)).to(dev)
    lens = torch.tensor([S, S - 1, 15 * SR, 12 * SR + 7, 9 * SR, 6 * SR, 3 * SR, 2 * SR + 289],
                        dtype=torch.int32, device=dev)
    extend_preemph.launches = 0
    serve = _k6_at(cfg, waves, lens)
    # the training step's batch: the training phase's int16 waves, dithered
    batch, _ = train_batch(np.random.default_rng(5), TRAIN_BATCH, TRAIN_BUCKET_S, TRAIN_BUCKET_S)
    w = expand_wire(torch.from_numpy(batch["waves"]).to(dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    w = w + cfg.dither * torch.randn(w.shape, generator=gen, device=dev, dtype=torch.float32)
    train = _k6_at(cfg, w.contiguous(), torch.from_numpy(batch["wave_lens"]).to(dev))
    res = {"name": "extend_preemph (K6)", "route": "cuda", "source": "lightning_asr_torch/csrc/extend.cu",
           "replaces": "lightning_asr_tpu/ops/frontend_pallas.py:48",
           **{k: train[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
           "max_abs_err": max(serve["max_abs_err"], train["max_abs_err"])}
    print(json.dumps({"phase": "K6", "serving": serve, "training": train,
                      "phase_launches": extend_preemph.launches}), flush=True)
    return res


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(a.abs().float().clamp_min(2.0 ** -126))) - 7)


def _bf16_err(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, its largest share of one bf16 ulp of the value, and
    whether every element lies within one ulp plus the float32 slack)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
    ok = bool((d <= ulp + SEPCONV_SLACK * w.abs().max()).all())
    return d.max().item(), (d / ulp).max().item(), ok


def _sepconv_layer(dev, Cin: int, Cout: int, k: int, seed: int) -> dict:
    """K9, K10 and K11 at one layer of the training step (B=32, T'=836,
    bf16) against their plain versions, with times, bounds and the cuDNN
    calls they stand in for."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, T, P = TRAIN_BATCH, T_TRAIN, k // 2
    x = torch.randn((B, Cin, T), generator=g, device=dev).bfloat16()
    dy = torch.randn((B, Cout, T), generator=g, device=dev).bfloat16()
    dyx = torch.randn((B, Cin, T), generator=g, device=dev).bfloat16()   # K11's dy
    wd = (torch.rand((Cin, 1, k), generator=g, device=dev) * 2 - 1) / k ** 0.5
    wp = (torch.rand((Cout, Cin, 1), generator=g, device=dev) * 2 - 1) / Cin ** 0.5
    y = sepconv_forward(x, wd, wp)
    dx, gwd, gwp = sepconv_backward(x, wd, wp, dy)
    gk = depthwise_wgrad(x, dyx, k)
    want_y = sepconv_forward_plain(x, wd, wp)
    want_dx, want_gwd, want_gwp = sepconv_backward_plain(x, wd, wp, dy)
    want_gk = depthwise_wgrad_plain(x, dyx, k)
    torch.cuda.synchronize()
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()  # noqa: E731
    y_err, y_ulps, y_ok = _bf16_err(y, want_y)
    dx_err, dx_ulps, dx_ok = _bf16_err(dx, want_dx)
    errs = {"K9_y_max_abs": y_err, "K9_y_max_ulps": y_ulps, "K10_dx_max_abs": dx_err,
            "K10_dx_max_ulps": dx_ulps, "K10_wd_grad_rel": rel(gwd, want_gwd),
            "K10_wp_grad_rel": rel(gwp, want_gwp), "K11_rel": rel(gk, want_gk),
            "K11_max_abs": (gk - want_gk).abs().max().item()}
    shape = f"Cin={Cin}, Cout={Cout}, k={k}"
    check(all(bool(torch.isfinite(t).all()) for t in (y, dx, gwd, gwp, gk)), f"{shape}: K9-K11 finite")
    check(y_ok, f"{shape}: K9 against plain beyond one bf16 ulp: {errs}")
    check(dx_ok, f"{shape}: K10 dx against plain beyond one bf16 ulp: {errs}")
    check(errs["K10_wd_grad_rel"] <= SEPCONV_TOL_GRAD and errs["K10_wp_grad_rel"] <= SEPCONV_TOL_GRAD,
          f"{shape}: K10 weight gradients against plain: {errs}")
    check(errs["K11_rel"] <= K11_TOL, f"{shape}: K11 against plain: {errs}")
    again = sepconv_backward(x, wd, wp, dy)
    check(all(torch.equal(a, b) for a, b in zip(again, (dx, gwd, gwp)))
          and torch.equal(gk, depthwise_wgrad(x, dyx, k)), f"{shape}: K10/K11 not deterministic")

    # the cuDNN calls they stand in for: the F.conv1d pair in bf16, its
    # autograd backward, and the depthwise weight gradient alone
    wdb, wpb = wd.bfloat16(), wp.bfloat16()
    conv1d = torch.nn.functional.conv1d
    pair = lambda a, u, v: conv1d(conv1d(a, u, None, 1, P, 1, Cin), v)  # noqa: E731
    xg, wdg, wpg = (t.clone().requires_grad_(True) for t in (x, wdb, wpb))
    yg = pair(xg, wdg, wpg)
    times = {
        "K9": (cuda_ms(lambda: sepconv_forward(x, wd, wp), 10),
               cuda_ms(lambda: sepconv_forward_plain(x, wd, wp), 2, warmup=1),
               cuda_ms(lambda: pair(x, wdb, wpb), 10)),
        "K10": (cuda_ms(lambda: sepconv_backward(x, wd, wp, dy), 10),
                cuda_ms(lambda: sepconv_backward_plain(x, wd, wp, dy), 2, warmup=1),
                cuda_ms(lambda: torch.autograd.grad(yg, (xg, wdg, wpg), dy, retain_graph=True), 10)),
        "K11": (cuda_ms(lambda: depthwise_wgrad(x, dyx, k), 10),
                cuda_ms(lambda: depthwise_wgrad_plain(x, dyx, k), 2, warmup=1),
                cuda_ms(lambda: torch.ops.aten.convolution_backward(
                    dyx, x, wdb, None, [1], [P], [1], False, [0], Cin, [False, True, False]), 10)),
    }
    BT, n2 = B * T, 2          # row-frames; bytes a bf16 value
    bounds = {
        # x in, y out, the weights in bf16; the depthwise taps and the
        # pointwise product
        "K9": bound((x.numel() + y.numel() + wd.numel() + wp.numel()) * n2,
                    2 * BT * Cin * (k + Cout), "bf16"),
        # x and dy in, dx out, the weights in, both float32 gradients out; dz,
        # dx, dwr and wd_grad (k taps each) and wp_grad
        "K10": bound((x.numel() + dy.numel() + dx.numel() + wd.numel() + wp.numel()) * n2
                     + (gwd.numel() + gwp.numel()) * 4, 2 * BT * Cin * (2 * Cout + 3 * k), "bf16"),
        # x and dy in, the float32 gradient out; k taps
        "K11": bound((x.numel() + dyx.numel()) * n2 + gk.numel() * 4, 2 * BT * Cin * k, "bf16"),
    }
    flops = {"K9": 2 * BT * Cin * (k + Cout), "K10": 2 * BT * Cin * (2 * Cout + 3 * k),
             "K11": 2 * BT * Cin * k}
    splits = {"K10": _split_ms(lambda: sepconv_backward(x, wd, wp, dy)),
              "K11": _split_ms(lambda: depthwise_wgrad(x, dyx, k))}
    return {"shape": [B, Cin, Cout, T, k], **errs,
            **{f"{n}_tflops": f / times[n][0] * 1e-9 for n, f in flops.items()},
            **{f"{n}_bound_share": bounds[n][0] / times[n][0] for n in flops},
            **{f"{n}_split_ms": split for n, (split, _) in splits.items()},
            "profiler_passes": {n: passes for n, (_, passes) in splits.items()},
            **{f"{n}_{m}": v for n, (ms, pms, lms) in times.items()
               for m, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms))},
            **{f"{n}_bound_ms": b[0] for n, b in bounds.items()},
            **{f"{n}_bound_by": b[1] for n, b in bounds.items()}}


def _split_ms(fn):
    """Device time of each kernel of one call of ``fn``, by kernel name
    (torch.profiler over 3 calls), and the profiler's passes."""
    _, _, top, passes = device_time(fn, 3)
    short = lambda name: re.split(r"[<(]", name.removeprefix("void ").replace(  # noqa: E731
        "(anonymous namespace)::", ""))[0].split("::")[-1]
    split = {}
    for name, ms in top.items():
        split[short(name)] = split.get(short(name), 0.0) + ms
    return split, passes


def _sepconv_fwd_float32(dev, Cin: int, Cout: int, k: int) -> dict:
    """K9's float32 instantiation (the CUDA-core product the parity checks
    run) at one layer of the training step: against its plain version and
    timed, so the SIMT path's cost stays on record."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((TRAIN_BATCH, Cin, T_TRAIN), generator=g, device=dev)
    wd = (torch.rand((Cin, 1, k), generator=g, device=dev) * 2 - 1) / k ** 0.5
    wp = (torch.rand((Cout, Cin, 1), generator=g, device=dev) * 2 - 1) / Cin ** 0.5
    y, want = sepconv_forward(x, wd, wp), sepconv_forward_plain(x, wd, wp)
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    # float32 sums in another order: the slack of the bf16 check
    check(err <= SEPCONV_SLACK * want.abs().max().item(), f"K9 float32 at Cin={Cin}: {err}")
    ms = cuda_ms(lambda: sepconv_forward(x, wd, wp), 10)
    flops = 2 * TRAIN_BATCH * T_TRAIN * Cin * (k + Cout)
    bound_ms, bound_by = bound((x.numel() + y.numel() + wd.numel() + wp.numel()) * 4, flops, "fp32")
    return {"max_abs_err": err, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flops / ms * 1e-9}


def phase_sepconv(dev):
    """K9, K10 and K11 at the training step's layers, bf16."""
    sepconv_forward.launches = sepconv_backward.launches = depthwise_wgrad.launches = 0
    layers = [_sepconv_layer(dev, cin, cout, k, i) for i, (cin, cout, k) in enumerate(SEPCONV_LAYERS)]
    widest = layers[-1]
    widest["K9_float32"] = _sepconv_fwd_float32(dev, *SEPCONV_LAYERS[-1])
    rows = []
    for key, name, src, line, err in (
            ("K9", "sepconv_forward (K9)", "sepconv.cu", "sepconv_pallas.py:80", "K9_y_max_abs"),
            ("K10", "sepconv_backward (K10)", "sepconv.cu", "sepconv_pallas.py:148", "K10_dx_max_abs"),
            ("K11", "depthwise_wgrad (K11)", "depthwise.cu", "depthwise_pallas.py:90", "K11_max_abs")):
        rows.append({"name": name, "route": "cuda", "source": f"lightning_asr_torch/csrc/{src}",
                     "replaces": f"lightning_asr_tpu/ops/{line}",
                     "max_abs_err": max(layer[err] for layer in layers),
                     **{m: widest[f"{key}_{m}"] for m in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                          "library_ms")}})
    print(json.dumps({"phase": "K9/K10/K11", "dtype": "bfloat16", "slack": SEPCONV_SLACK,
                      "tol_grad_rel": SEPCONV_TOL_GRAD, "k11_tol_rel": K11_TOL, "layers": layers,
                      "phase_launches": {"K9": sepconv_forward.launches, "K10": sepconv_backward.launches,
                                         "K11": depthwise_wgrad.launches},
                      "kernels": rows}), flush=True)
    return rows


def mel_inputs(gen: torch.Generator) -> tuple:
    """A calibration batch of the mel models: 2 x 200 frames of 64 random
    features, all valid."""
    return torch.randn((2, 200, 64), generator=gen), torch.ones(2)


def bn_teeth(model, gen: torch.Generator) -> None:
    """Random BatchNorm affine terms and running statistics."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                n = m.weight.numel()
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.5)
                m.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)


def with_teeth(model, gen: torch.Generator, decoder_scale: float = 50.0,
               inputs=mel_inputs) -> None:
    """Non-trivial BatchNorm statistics and affine terms and a scaled-up
    decoder: freshly initialised weights give nearly uniform log-probs.

    The decoder's input is non-negative (ReLU) with a large common mean, so
    one class would win every frame; its bias is set to cancel that mean on
    a calibration batch (``inputs(gen)``, the model's arguments), and the
    head is then scaled, so that the greedy argmax varies from frame to
    frame."""
    bn_teeth(model, gen)
    with torch.no_grad():
        seen = {}
        hook = model.decoder.register_forward_pre_hook(lambda mod, args: seen.setdefault("x", args[0]))
        model.eval()(*inputs(gen))
        hook.remove()
        mean_in = seen["x"].float().mean(dim=(0, 2))
        model.decoder.bias.copy_(-(model.decoder.weight[:, :, 0] @ mean_in))
        model.decoder.weight.mul_(decoder_scale)
        model.decoder.bias.mul_(decoder_scale)


def calibrated_teeth(model, gen: torch.Generator, inputs=mel_inputs,
                     passes: int = CALIBRATION_PASSES) -> None:
    """``with_teeth``'s random BatchNorm terms, then running statistics
    moved towards what training leaves (``passes`` train-mode passes,
    momentum 0.1, over ``inputs(gen)``, by default random features of 2 x
    200 frames) and a decoder
    scaled to a set spread: its bias cancels its input's mean on one more
    such batch, and its scale brings that batch's log-probs to a class std of
    TEETH_CLASS_STD.  With ``with_teeth``'s random running statistics alone
    the SE encoder's log-probs are nearly constant (class std 0.19 at scale
    50) and its bf16 log-probs agree with its float32 ones on 21% of the
    frames' argmax: the constant terms swamp the signal."""
    with_teeth(model, gen, 1.0, inputs)
    with torch.no_grad():
        model.train()
        for _ in range(passes):
            model(*inputs(gen))
        seen = {}
        hook = model.decoder.register_forward_pre_hook(lambda mod, args: seen.update(x=args[0].float()))
        model.eval()(*inputs(gen))
        hook.remove()
        w = model.decoder.weight[:, :, 0]
        model.decoder.bias.copy_(-(w @ seen["x"].mean(dim=(0, 2))))
        logits = torch.einsum("oc,bct->bto", w, seen["x"]) + model.decoder.bias
        scale = TEETH_CLASS_STD / logits.std(dim=-1).mean().item()
        model.decoder.weight.mul_(scale)
        model.decoder.bias.mul_(scale)


def _edits(a: str, b: str) -> int:
    """Levenshtein distance between two strings."""
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _post(port: int, payload: bytes, field: str = "audio"):
    boundary = "chipsmokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
    body += payload + f"\r\n--{boundary}--\r\n".encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/", body=body,
                     headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace"), time.perf_counter() - t0
    finally:
        conn.close()


def serving_checkpoint(root, compute_dtype: str = "bfloat16",
                       encoder: str = DEFAULT_ENCODER) -> str:
    """The seeded full-width checkpoint of ``encoder`` that the serving,
    decoding and encoders phases load ("default" frontend tier), saved under
    ``root``: ``with_teeth`` for the default encoder, ``calibrated_teeth``
    for the others."""
    gen = torch.Generator().manual_seed(0)
    model = build_model(len(LABELS) + 1, encoder, mask=True, dtype=torch.bfloat16)
    reset_parameters(model, gen)
    (with_teeth if encoder == DEFAULT_ENCODER else calibrated_teeth)(model, gen)
    hparams = {"labels": LABELS, "use_cer": False, "encoder": encoder, "in_c": 64,
               "mask": True, "compute_dtype": compute_dtype,
               "frontend": dict(MelFrontendConfig(precision="default").__dict__),
               "normalize": True}
    return save_checkpoint(root, model.state_dict(), hparams)


def serving_burst():
    """The seconds and WAV bodies of the 8 requests every serving burst sends."""
    rng = np.random.default_rng(2)
    seconds = [2.0, 3.5, 5.0, 7.0, 9.0, 11.0, 13.5, 16.0]
    waves = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in seconds]
    return seconds, [wav_bytes(w, SR) for w in waves]


def phase_serving(dev):
    """The seeded full-width bf16 checkpoint served over HTTP twice: by
    ``AsrTranslator`` as built by default, then with
    ``conv_kernel="sepconv"`` (phase ``serving_sepconv``); each against the
    same translator on the CPU."""
    seconds, blobs = serving_burst()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = serving_checkpoint(tmp)
        t0 = time.perf_counter()
        translator = AsrTranslator(ckpt, device="cuda")
        load_s = time.perf_counter() - t0
        cpu = AsrTranslator(ckpt, device="cpu")
        cpu32 = AsrTranslator(serving_checkpoint(f"{tmp}/fp32", "float32"), device="cpu")
        sep = AsrTranslator(ckpt, device="cuda", conv_kernel="sepconv")
        sep_cpu = AsrTranslator(ckpt, device="cpu", conv_kernel="sepconv")
    check(translator.device.type == "cuda" and sep.device.type == "cuda", "translator is not on the card")
    base = _serve_and_check(dev, "serving", translator, cpu, cpu32, blobs, {}, load_s=load_s,
                            seconds=seconds)
    # K9 runs the 14 stride-1 block convs of each device batch
    sepconv = _serve_and_check(dev, "serving_sepconv", sep, sep_cpu, cpu32, blobs,
                               {"sepconv_forward": (sepconv_forward, 14)})
    return base, sepconv, translator, base["served"]


def _serve_and_check(dev, name: str, translator, cpu, cpu32, blobs, extra: dict, **info) -> dict:
    """8 concurrent requests and a wrong form field over HTTP, served as one
    device batch; the kernels' launches during the burst (K1, K2 and K6 once,
    ``extra``'s as many times as given, overriding those); the served batch's log-probs on the
    card against ``cpu``'s (the same model on the CPU) over valid frames, the
    card's and the CPU's gap to ``cpu32`` (float32 on the CPU), and the
    served texts."""
    counters = {"mel": (mel_from_extended, 1), "lstm": (lstm_recurrence, 1),
                "extend": (extend_preemph, 1), **extra}
    # the window outlasts the burst's arrival, and the batcher dispatches as
    # soon as it holds max_batch requests: the 8 requests form one device
    # batch, the one checked below
    server = make_stdlib_server(translator, port=0, batching=True, max_batch=8, max_wait_ms=2000.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        for fn, _ in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(blobs) + 1) as pool:
            futs = [pool.submit(_post, port, b) for b in blobs]
            bad = pool.submit(_post, port, blobs[0], "file")
            answers = [f.result() for f in futs]
            bad_status = bad.result()[0]
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
        launches = {key: fn.launches for key, (fn, _) in counters.items()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), f"{name}: server thread did not stop")
    statuses = [a[0] for a in answers]
    check(all(s == 200 for s in statuses), f"{name}: request statuses {statuses}")
    check(bad_status == 400, f"{name}: wrong form field answered {bad_status}, not 400")
    want = {key: n for key, (_, n) in counters.items()}
    check(launches == want, f"{name}: kernel launches while serving {launches}, want {want}: "
                            "the burst did not run as one device batch through the kernels")

    # the served batch, as the server decoded it (16-bit PCM), on the card
    # against the same translator on the CPU, over each row's valid frames
    served = [read_audio(b, mono=True)[0][0] for b in blobs]
    batch, lens = translator.pad_batch(served)
    check(batch.shape == (8, 16 * SR), f"{name}: served batch shape {batch.shape}")
    lp, out_lens = translator._forward(torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev))
    lp_cpu, out_lens_cpu = cpu._forward(torch.from_numpy(batch), torch.from_numpy(lens))
    lp_fp32 = cpu32._forward(torch.from_numpy(batch), torch.from_numpy(lens))[0].numpy()
    lp, lp_cpu = lp.float().cpu().numpy(), lp_cpu.float().numpy()
    out_lens, out_lens_cpu = out_lens.cpu().numpy(), out_lens_cpu.numpy()
    check(bool(np.isfinite(lp).all()) and lp.shape == lp_cpu.shape, f"{name}: log-probs shape/finite")
    check(np.array_equal(out_lens, out_lens_cpu), f"{name}: out_lens differ card vs CPU")
    valid = np.arange(lp.shape[1])[None, :] < out_lens_cpu[:, None]
    class_std = float(np.mean(np.std(lp_cpu[valid], axis=-1)))
    err = np.abs(lp - lp_cpu)[valid]
    agree = float(np.mean(lp.argmax(-1)[valid] == lp_cpu.argmax(-1)[valid]))
    check(class_std >= 0.5, f"{name}: log-prob class std {class_std} < 0.5: weights without teeth")
    check(err.max() <= SERVE_TOL_MAX and err.mean() <= SERVE_TOL_MEAN,
          f"{name}: card vs CPU log-probs: max {err.max()}, mean {err.mean()}")
    check(agree >= SERVE_MIN_ARGMAX, f"{name}: greedy argmax agreement {agree}")
    gap_card = float(np.abs(lp - lp_fp32)[valid].mean())
    gap_cpu = float(np.abs(lp_cpu - lp_fp32)[valid].mean())
    check(gap_card <= SERVE_BF16_GAP_RATIO * gap_cpu,
          f"{name}: card bf16 vs float32: mean {gap_card}, CPU bf16 vs float32: mean {gap_cpu}")

    # the served texts are the card's transcription of that batch; against
    # the CPU's, by character error rate
    texts = [a[1] for a in answers]
    card_texts = translator.transcribe_batch(served)
    cpu_texts = cpu.transcribe_batch(served)
    check(texts == card_texts, f"{name}: served texts {texts} differ from the card's {card_texts}")
    cer = sum(_edits(a, b) for a, b in zip(card_texts, cpu_texts)) / max(1, sum(map(len, cpu_texts)))
    check(cer <= SERVE_MAX_CER, f"{name}: card vs CPU texts: character error rate {cer}")
    res = {"phase": name, "requests": len(blobs), **info, "statuses": statuses,
           "wrong_field_status": bad_status, "launches": launches,
           "burst_s": burst_s, "latency_s": [a[2] for a in answers],
           "texts_chars": [len(t) for t in texts], "class_std": class_std,
           "card_vs_cpu_max_abs": float(err.max()), "card_vs_cpu_mean_abs": float(err.mean()),
           "argmax_agreement": agree, "card_bf16_vs_fp32_mean_abs": gap_card,
           "cpu_bf16_vs_fp32_mean_abs": gap_cpu, "card_vs_cpu_cer": cer,
           "texts_equal_cpu": sum(a == b for a, b in zip(card_texts, cpu_texts)),
           "batch_shape": list(batch.shape)}
    print(json.dumps(res), flush=True)
    return {**res, "served": served, "fp32_cpu": (batch, lens, lp_fp32, out_lens_cpu)}


def _category(name: str) -> str:
    if name == EVENTS_KEY:
        return EVENTS_KEY
    low = name.lower()
    # K7's names (lstm_stacked_fwd_steps_kernel, lstm_stacked_fwd_kernel) and
    # K8's (lstm_stacked_steps_kernel, lstm_stacked_bwd_gates_kernel,
    # lstm_stacked_bwd_walk_kernel) first, so that no K2 or K3 tag takes one
    for tag, cat in (("lstm_stacked_fwd_", "K7 lstm_stacked"),
                     ("lstm_stacked_steps_", "K8 lstm_stacked_bwd"),
                     ("lstm_stacked_bwd_", "K8 lstm_stacked_bwd"),
                     ("log_mel_kernel", "K1 log_mel"), ("lstm_fwd_kernel", "K2 lstm"),
                     ("lstm_fwd_pair_kernel", "K2 lstm"),
                     ("lstm_bwd_kernel", "K3 lstm_bwd"), ("lstm_bwd_gates_kernel", "K3 lstm_bwd"),
                     ("lstm_bwd_pair_kernel", "K3 lstm_bwd"), ("lstm_bwd_dw_kernel", "K3 lstm_bwd"),
                     ("ctc_alpha_kernel", "K4 ctc_alpha"),
                     ("ctc_beta_kernel", "K5 ctc_beta"), ("extend_kernel", "K6 extend_preemph"),
                     ("sepconv_fwd", "K9 sepconv_fwd"), ("sepconv_dz", "K10 sepconv_bwd"),
                     ("sepconv_bwd_dw", "K10 sepconv_bwd"), ("sepconv_wp_grad", "K10 sepconv_bwd"),
                     ("dw_wgrad_", "K11 dw_wgrad"), ("sum_partials_kernel", "K10/K11 partial sums")):
        if tag in low:
            return cat
    if "memcpy" in low or "memset" in low:
        return "copy"
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")):
        return "conv"
    if "gemm" in low or "cutlass" in low:
        return "gemm"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def phase_profile(translator: AsrTranslator, waves, name: str = "profile") -> dict:
    """Where one steady serving batch's time goes: the host-clock latency of
    transcribe_batch over PROFILE_ITERS[0] batches after warm-up, and with
    torch.profiler the device time of each kernel per batch over
    PROFILE_ITERS[1] batches, grouped; the device's busy share is that
    device time over the unprofiled median latency (the profiler slows the
    host side)."""
    iters, prof_iters = PROFILE_ITERS
    for _ in range(2):
        translator.transcribe_batch(waves)
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        translator.transcribe_batch(waves)
        lat.append(time.perf_counter() - t0)
    device_ms, by_cat, top, passes = device_time(lambda: translator.transcribe_batch(waves), prof_iters)
    median_ms = 1e3 * statistics.median(lat)
    res = {"phase": name, "batch": len(waves), "audio_s_per_batch": sum(len(w) for w in waves) / SR,
           "steady_latency_ms": {"median": median_ms, "min": 1e3 * min(lat), "max": 1e3 * max(lat),
                                 "n": iters},
           "device_ms_per_batch": device_ms, "device_busy_share": device_ms / median_ms,
           "device_ms_by_category": by_cat, "top_kernels_ms": top, "profiler_passes": passes}
    print(json.dumps(res), flush=True)
    return res


@contextlib.contextmanager
def card_forwards():
    """Count AsrTranslator._forward calls on the card, in every instance."""
    inner = AsrTranslator._forward
    count = {"n": 0}

    def counting(self, waves, wave_lens):
        if waves.device.type == "cuda":
            count["n"] += 1
        return inner(self, waves, wave_lens)

    AsrTranslator._forward = counting
    try:
        yield count
    finally:
        AsrTranslator._forward = inner


def _texts(prefixes, plens):
    return ["".join(LABELS[i] for i in row[:n]) for row, n in zip(prefixes, plens)]


def _hotword_candidates(beam_texts, scores, lm_texts):
    """Decisions a hot word is built to flip: for each row and runner-up
    beam k, the first word ``w`` where beam k's text differs from the best
    beam's (2+ letters, neither a prefix of the other word, not in the
    row's LM text), as (row, w, the beams' score gap), closest gap first."""
    out = []
    for r, (row, lm) in enumerate(zip(beam_texts, lm_texts)):
        best = row[0].split()
        for k in range(1, len(row)):
            words = row[k].split()
            j = next((i for i, (a, b) in enumerate(zip(best, words)) if a != b), None)
            if j is None:
                continue
            w, w0 = words[j], best[j]
            if len(w) >= 2 and not w.startswith(w0) and not w0.startswith(w) \
                    and w not in lm.split() and all(w != c[1] for c in out if c[0] == r):
                out.append((r, w, float(scores[r, 0] - scores[r, k])))
    return sorted(out, key=lambda c: c[2])


def spelled_lattice(rng, lengths, T: int) -> torch.Tensor:
    """(B, T, 29) float32 log-probs peaked as a trained CTC model's: each
    row spells words of LM_SENTENCES, a character over two frames then a
    blank, half the characters with a runner-up letter at 0.45 of its
    mass; the frames after the text blanks."""
    words = " ".join(LM_SENTENCES).split()
    blank = np.full(len(LABELS) + 1, 0.002)
    blank[BLANK] = 1.0
    out = np.tile(np.log(blank / blank.sum()), (len(lengths), T, 1))
    for b, n in enumerate(lengths):
        text = " ".join(rng.choice(words, size=n // 6 + 1))[: n // 3]
        for i, ch in enumerate(text):
            p = np.full(len(LABELS) + 1, 0.002)
            p[LABELS.index(ch)] = 1.0
            if rng.random() < 0.5:
                p[rng.integers(2, len(LABELS))] += 0.45
            out[b, 3 * i: 3 * i + 2] = np.log(p / p.sum())
    return torch.from_numpy(out.astype(np.float32))


def exact_ll(log_probs: torch.Tensor, length: int, text: str) -> float:
    """log P(text | frames), summed over every alignment (CTC, float64 on
    the CPU)."""
    lp = log_probs[:length].double().cpu()[:, None]
    target = torch.tensor([[LABELS.index(c) for c in text]], dtype=torch.long)
    return -float(torch.nn.functional.ctc_loss(
        lp, target, torch.tensor([length]), torch.tensor([len(text)]), blank=BLANK,
        reduction="sum", zero_infinity=False))


def phase_decoding(dev, translator: AsrTranslator, served, native_build: dict) -> dict:
    """The decoding and offline-inference path on the card, over the
    serving phase's checkpoint, translator and served batch."""
    res = {"phase": "decoding", "native_build": native_build}
    counters = {"mel": mel_from_extended, "lstm": lstm_recurrence, "extend": extend_preemph}
    for fn in counters.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp, card_forwards() as forwards:
        tmp = Path(tmp)
        ckpt = serving_checkpoint(tmp / "ckpt")
        cpu = AsrTranslator(ckpt, device="cpu")

        # the served batch on the card: its greedy collapse against the
        # host's and against the texts the server answered
        batch, lens = translator.pad_batch(served)
        lp, out_lens = translator._forward(torch.from_numpy(batch).to(dev),
                                           torch.from_numpy(lens).to(dev))
        check(lp.dtype == torch.float32 and lp.shape[0] == 8, f"served log-probs {lp.dtype}")
        preds = torch.argmax(lp, dim=-1)
        ids, emit = greedy_collapse_device(preds, out_lens, BLANK)
        greedy_card = compact_to_strings(ids.cpu().numpy(), emit.cpu().numpy(), LABELS)
        preds_np, lens_np = preds.cpu().numpy(), out_lens.cpu().numpy()
        greedy_host = compact_to_strings(preds_np, greedy_emit_mask(preds_np, lens_np, BLANK), LABELS)
        check(greedy_card == greedy_host, f"greedy collapse on the card {greedy_card} != host's "
                                          f"{greedy_host}")
        served_texts = translator.transcribe_batch(served)
        check(greedy_card == served_texts, "greedy texts differ from the served batch's")

        # LM: a 3-gram ARPA file by the repository's script, from a few
        # sentences and the served batch's greedy texts
        corpus = tmp / "corpus.txt"
        corpus.write_text("\n".join(LM_SENTENCES + tuple(t for t in greedy_card if t.strip())) + "\n")
        lm = tmp / "lm.arpa"
        script = Path(__file__).resolve().parent / "scripts" / "make_arpa_lm.py"
        proc = subprocess.run([sys.executable, str(script), "--text", str(corpus), "--order", "3",
                               "--out", str(lm)], capture_output=True, text=True, timeout=120)
        check(proc.returncode == 0 and lm.is_file(), f"make_arpa_lm.py failed: {proc.stderr}")
        res["lm"] = json.loads(proc.stdout.strip().splitlines()[-1])

        # device beam: twice the same bits, the CPU's beams, the native
        # search's texts
        lengths_i32 = out_lens.to(torch.int32)
        run = lambda: beam_search_device(lp, lengths_i32, DEVICE_BEAM_K)  # noqa: E731
        first, second = run(), run()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              "device beam: two runs on the card differ")
        prefixes, plens, scores = (x.cpu().numpy() for x in first)
        c_prefixes, c_plens, c_scores = (x.numpy() for x in beam_search_device(
            lp.cpu(), lengths_i32.cpu(), DEVICE_BEAM_K))
        finite = c_scores > -1e29
        same = [np.array_equal(prefixes[b, k, : plens[b, k]], c_prefixes[b, k, : c_plens[b, k]])
                and plens[b, k] == c_plens[b, k] for b, k in zip(*np.nonzero(finite))]
        score_rel = float(np.max(np.abs(scores - c_scores)[finite] / np.abs(c_scores[finite])))
        res["device_beam"] = {"K": DEVICE_BEAM_K, "shape": list(lp.shape),
                              "finite_beams": int(finite.sum()), "beams_equal_cpu": int(sum(same)),
                              "score_max_rel_err": score_rel, "score_rtol": BEAM_SCORE_RTOL}
        check(np.array_equal(finite, scores > -1e29) and all(same),
              f"device beam: {len(same) - sum(same)} of {len(same)} beams differ card vs CPU")
        check(score_rel <= BEAM_SCORE_RTOL, f"device beam scores card vs CPU: rel {score_rel}")
        # against the native search: on a lattice peaked as a trained model's
        # (the JAX package's test_device_beam.py pins agreement there) the
        # texts must be equal; on the served batch's near-flat log-probs the
        # two float32 searches may rank near-ties apart over 801 steps, so
        # there the agreement is counted, with each differing row's two
        # texts scored exactly (float64 CTC)
        dev_dec = DeviceBeamSearchDecoder(LABELS, DEVICE_BEAM_K, device=dev)
        peaked = spelled_lattice(np.random.default_rng(9), lens_np, lp.shape[1]).to(dev)
        want = BeamSearchDecoderWithLM(LABELS, beam_width=NATIVE_BEAM_K, cutoff_prob=1.0,
                                       cutoff_top_n=len(LABELS) + 1, num_cpus=8).forward(peaked, out_lens)
        got = dev_dec.forward(peaked, out_lens)
        check(got == want, f"device beam {got} != native {want} on the peaked lattice")
        dev_texts = dev_dec.forward(lp, out_lens)
        native_texts = BeamSearchDecoderWithLM(LABELS, beam_width=DEVICE_BEAM_K, cutoff_prob=1.0,
                                               cutoff_top_n=len(LABELS) + 1,
                                               num_cpus=8).forward(lp, out_lens)
        differ = [b for b in range(8) if dev_texts[b] != native_texts[b]]
        res["device_beam"].update(
            texts_equal_native_peaked=True, native_beam_K_peaked=NATIVE_BEAM_K,
            served_rows_equal_native=8 - len(differ),
            served_differing_rows={b: {"device_ll": exact_ll(lp[b], lens_np[b], dev_texts[b]),
                                       "native_ll": exact_ll(lp[b], lens_np[b], native_texts[b]),
                                       "device_top2_gap": float(scores[b, 0] - scores[b, 1])}
                                   for b in differ})

        # the native search with the LM, then with one hot word: runner-up
        # beams' words, the closest decisions first, each tried on its row
        lm_dec = BeamSearchDecoderWithLM(LABELS, lm_path=str(lm), num_cpus=8)
        lm_texts = lm_dec.forward(lp, out_lens)
        check(len(lm_texts) == 8 and all(isinstance(t, str) for t in lm_texts), "LM texts")
        beam_texts = [_texts(prefixes[b], plens[b]) for b in range(8)]
        flipped, tried = None, 0
        for row, word, gap in _hotword_candidates(beam_texts, scores, lm_texts)[:HOTWORD_TRIES]:
            boost = gap + HOTWORD_MARGIN
            tried += 1
            text = BeamSearchDecoderWithLM(LABELS, lm_path=str(lm), num_cpus=1,
                                           hotwords={word: boost}).forward(lp[row:row + 1],
                                                                           out_lens[row:row + 1])[0]
            if word in text.split() and word not in lm_texts[row].split():
                flipped = {"word_chars": len(word), "boost": boost, "built_for_row": row}
                hot = f"{word}:{boost}"
                break
        check(flipped is not None, f"no hot word flipped its decision ({tried} tried)")
        hot_texts = BeamSearchDecoderWithLM(LABELS, lm_path=str(lm), num_cpus=8,
                                            hotwords={word: boost}).forward(lp, out_lens)
        rows = [r for r, (a, b) in enumerate(zip(lm_texts, hot_texts))
                if a != b and word in b.split() and word not in a.split()]
        check(len(hot_texts) == 8 and flipped["built_for_row"] in rows,
              f"hot word: rows flipped {rows}, built for {flipped['built_for_row']}")
        res["hotword"] = {**flipped, "rows_flipped": rows, "tried": tried}

        # long audio: the card's stitched log-probs against the CPU's,
        # translate_long's text, the stream's
        long_wave = (np.random.default_rng(6).standard_normal(int(LONG_S * SR)) * 0.1).astype(np.float32)
        long_blob = wav_bytes(long_wave, SR)
        long16 = read_audio(long_blob)[0][0]
        n_windows = len(plan_chunks(long16.shape[0], int(CHUNK_S * SR), int(OVERLAP_S * SR)))
        long_card = translator.long_log_probs(long16, CHUNK_S, OVERLAP_S)
        long_cpu = cpu.long_log_probs(long16, CHUNK_S, OVERLAP_S)
        check(long_card.shape == long_cpu.shape and bool(np.isfinite(long_card).all()),
              f"long log-probs {long_card.shape} vs {long_cpu.shape}")
        err = np.abs(long_card - long_cpu)
        agree = float(np.mean(long_card.argmax(-1) == long_cpu.argmax(-1)))
        check(err.max() <= SERVE_TOL_MAX and err.mean() <= SERVE_TOL_MEAN,
              f"long audio card vs CPU: max {err.max()}, mean {err.mean()}")
        check(agree >= SERVE_MIN_ARGMAX, f"long audio argmax agreement {agree}")
        long_text = translator.translate_long(long_blob, CHUNK_S, OVERLAP_S)
        check(long_text == translator.decode_stitched(long_card), "translate_long's text")
        st = StreamingTranscriber(translator, CHUNK_S, OVERLAP_S)
        for lo in range(0, long16.shape[0], SR):
            st.feed(long16[lo: lo + SR])
        stream_text = st.finish()
        check(stream_text == long_text, "StreamingTranscriber.finish() differs from translate_long")
        res["long"] = {"seconds": LONG_S, "windows": n_windows, "frames": long_card.shape[0],
                       "card_vs_cpu_max_abs": float(err.max()),
                       "card_vs_cpu_mean_abs": float(err.mean()), "argmax_agreement": agree,
                       "text_chars": len(long_text), "stream_equals_translate_long": True}

        # a manifest of 16 WAVs: WER and the CSV with confidences
        rng = np.random.default_rng(8)
        entries, waves = [], []
        for i in range(MANIFEST_UTTS):
            n = int(rng.uniform(MANIFEST_MIN_S, MANIFEST_MAX_S) * SR)
            wave = (rng.standard_normal(n) * 0.1).astype(np.float32)
            write_wav(tmp / f"u{i}.wav", wave, SR)
            waves.append(read_audio(tmp / f"u{i}.wav")[0][0])
            entries.append({"audio_filepath": str(tmp / f"u{i}.wav"),
                            "duration": wave.shape[0] / SR, "text": LM_SENTENCES[i % 6]})
        manifest = tmp / "manifest.json"
        manifest.write_text("".join(json.dumps(e) + "\n" for e in entries))
        conf_tr = AsrTranslator(ckpt, device="cuda", return_confidence=True)
        report = tmp / "report.csv"
        t0 = time.perf_counter()
        result = conf_tr.evaluate_manifest(manifest, batch_size=MANIFEST_BATCH, csv_path=report)
        manifest_s = time.perf_counter() - t0
        texts = [t for i in range(0, MANIFEST_UTTS, MANIFEST_BATCH)
                 for t in translator.transcribe_batch(waves[i: i + MANIFEST_BATCH])]
        want_wer = word_error_rate(texts, [e["text"] for e in entries])
        check(result == {"wer": want_wer, "n_utterances": MANIFEST_UTTS},
              f"evaluate_manifest {result}, want wer {want_wer}")
        with open(report, newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))[1:]
        check(len(rows) == MANIFEST_UTTS and all(np.isfinite(float(r[4])) for r in rows),
              "manifest CSV rows / confidences")
        check([r[2] for r in rows] == texts, "manifest CSV hypotheses")
        audio_s = sum(e["duration"] for e in entries)
        res["manifest"] = {"utterances": MANIFEST_UTTS, "audio_s": audio_s, "wer": result["wer"],
                           "seconds": manifest_s, "audio_s_per_s": audio_s / manifest_s}

        # the CLI over the same manifest with the LM and the hot word
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli = predict_main(["--model", str(ckpt), "--manifest", str(manifest), "--lm", str(lm),
                                "--hotword", hot,
                                "--csv", str(tmp / "cli.csv"), "--confidence",
                                "--batch_size", str(MANIFEST_BATCH), "--num_cpus", "8"])
        check(cli["manifest"]["n_utterances"] == MANIFEST_UTTS and str(cli["manifest"]) in out.getvalue(),
              f"predict CLI printed {out.getvalue()!r}")
        with open(tmp / "cli.csv", newline="", encoding="utf-8") as f:
            check(len(list(csv.reader(f))) == MANIFEST_UTTS + 1, "predict CLI CSV rows")
        res["cli"] = cli["manifest"]

        # times: the device beam (CUDA events, host clock, torch.profiler),
        # the native search with and without the LM, translate_long
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        beam_host_ms = 1e3 * (time.perf_counter() - t0)
        beam_ms = cuda_ms(run, 3, warmup=0)
        # torch.profiler over the first BEAM_PROFILE_STEPS frames only: a
        # whole batch is over 100,000 launches
        head = lp[:, :BEAM_PROFILE_STEPS]
        kernels, launches, passes = kernel_times(
            lambda: beam_search_device(head, lengths_i32.clamp_max(BEAM_PROFILE_STEPS), DEVICE_BEAM_K), 1)
        step_device_ms = sum(kernels.values()) / BEAM_PROFILE_STEPS
        native_ms = {}
        for name, dec in (("no_lm", BeamSearchDecoderWithLM(LABELS, num_cpus=8)), ("lm", lm_dec)):
            t0 = time.perf_counter()
            dec.forward(lp, out_lens)
            native_ms[name] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        translator.translate_long(long_blob, CHUNK_S, OVERLAP_S)
        torch.cuda.synchronize()
        res["times"] = {
            "device_beam_ms": beam_ms, "device_beam_host_ms": beam_host_ms,
            "device_beam_profiled_steps": BEAM_PROFILE_STEPS,
            "device_beam_device_ms_per_step": step_device_ms,
            "device_beam_launches_per_step": launches / BEAM_PROFILE_STEPS,
            "device_beam_host_ms_per_step": beam_ms / lp.shape[1],
            "device_beam_device_share": step_device_ms * lp.shape[1] / beam_ms,
            "native_beam_ms": native_ms, "translate_long_ms": 1e3 * (time.perf_counter() - t0),
            "evaluate_manifest_audio_s_per_s": res["manifest"]["audio_s_per_s"],
            "profiler_passes": passes}
        res["forwards"] = forwards["n"]
    res["launches"] = {key: fn.launches for key, fn in counters.items()}
    check(res["forwards"] > 0 and all(n == res["forwards"] for n in res["launches"].values()),
          f"decoding: launches {res['launches']} for {res['forwards']} forwards on the card")
    print(json.dumps(res), flush=True)
    return res


def kernel_times(fn, n: int):
    """Device time per call of each kernel of ``fn`` over ``n`` profiled
    calls, from torch.profiler: ({kernel: ms}, device records per call, the
    passes it took).  A pass counts only if its kernel records on the card
    fall short of the host's kernel launches by at most
    PROFILER_MISSING_SHARE; after PROFILER_PASSES passes without such a
    pass the calls are timed by CUDA events, as ({EVENTS_KEY: ms}, host
    launches per call, "cuda_events").  Each call adds its entry to
    PROFILER_LOG."""
    from torch.profiler import ProfilerActivity, profile

    entry = {"caller": fn.__qualname__.split(".<locals>")[0], "calls": n, "missing": []}
    PROFILER_LOG.append(entry)
    for passes in range(1, PROFILER_PASSES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels, records, kernel_records, host_launches = {}, 0, 0, 0
        for ev in prof.key_averages():
            if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
                host_launches += ev.count if "LaunchKernel" in ev.key else 0
                continue
            kernel_records += 0 if ev.key.startswith(("Memcpy", "Memset")) else ev.count
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3 / n
                records += ev.count
        missing = host_launches - kernel_records
        entry.update(host_launches=host_launches, passes=passes)
        entry["missing"].append(missing)
        if kernels and missing <= PROFILER_MISSING_SHARE * host_launches:
            return kernels, records / n, passes
    entry["passes"] = "cuda_events"
    return {EVENTS_KEY: cuda_ms(fn, n, warmup=0)}, host_launches / n, "cuda_events"


def device_time(fn, n: int):
    """Device time per call of ``fn`` over ``n`` profiled calls
    (``kernel_times``): (total ms, ms by kernel group, the 12 largest
    kernels, the passes it took)."""
    kernels, _, passes = kernel_times(fn, n)
    by_cat = {}
    for name, ms in kernels.items():
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + ms
    return (sum(kernels.values()), dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12]), passes)


def train_rows(rng, B: int):
    """Seconds of B utterances of 2-16.7 s (one at 16.7 s), and their frame
    counts after the stride-2 stem as the model recovers them, int(836 ·
    float32(mel frames / 1671))."""
    seconds = np.sort(rng.uniform(2.0, TRAIN_BUCKET_S, B))[::-1].copy()
    seconds[0] = TRAIN_BUCKET_S
    samples = (seconds * SR).astype(np.int64)
    frames = 1 + (samples + 64) // 160
    T_mel = 1 + (int(TRAIN_BUCKET_S * SR) + 64) // 160
    percents = frames.astype(np.float32) / np.float32(T_mel)
    return seconds, samples, (np.float32(T_TRAIN) * percents).astype(np.int32)


def train_targets(rng, seconds, L_multiple: int = 32):
    """~15 labels a second from the vocabulary (no blank), padded to a
    multiple of 32 as the data pipeline pads them."""
    tl = np.maximum(1, np.round(CHARS_PER_S * seconds)).astype(np.int32)
    L = int(-(-tl.max() // L_multiple) * L_multiple)
    return rng.integers(0, BLANK, (len(seconds), L)).astype(np.int32), tl


def _kernel_name(mangled: str) -> str:
    """``name<40,4>`` from a mangled ``_ZN<len><id>...<len><name>I...E`` name."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, ident = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        ident, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    return f"{ident}<{','.join(re.findall(r'Li(\d+)E', args.group(1)))}>" if args else ident


def ptxas_kernels(report: str) -> dict:
    """Registers and spill bytes of each kernel in one library's ``-Xptxas
    -v`` report (empty when the library came from the cache)."""
    out, name = {}, None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = _kernel_name(m.group(1))
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def phase_k3(dev, hmma, ptxas_report: str) -> dict:
    rng = np.random.default_rng(3)
    B, T, C, H, D = TRAIN_BATCH, T_TRAIN, 256, 40, 2
    x, (w_ih, w_hh, b_ih, b_hh), lens_np, lens, xproj = bilstm_inputs(dev, rng, B, T)
    h, cell = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    grad_h = torch.from_numpy(rng.standard_normal((B, T, D * H)).astype(np.float32)).to(dev)
    # K2 with the cell output, whose h and c K3 takes, at this shape
    want_h, want_cell = lstm_recurrence_plain(xproj, lens, w_hh, with_cell=True)
    torch.cuda.synchronize()
    k2_err = (h - want_h).abs().max().item()
    k2_cell_err = (cell - want_cell).abs().max().item()
    check(torch.equal(h, lstm_recurrence(xproj, lens, w_hh)), "K2 with the cell output changed h")
    check(k2_err <= K2_TOL, f"K2 at the training shape: max |kernel - plain| = {k2_err} > {K2_TOL}")
    check(k2_cell_err <= 10 * K2_TOL,
          f"K2 cell states at the training shape: max |kernel - plain| = {k2_cell_err}")
    k2_ms = cuda_ms(lambda: lstm_recurrence(xproj, lens, w_hh, with_cell=True), 20)

    lstm_backward.launches = 0
    d_x, dw = lstm_backward(xproj, lens, w_hh, h, cell, grad_h)
    again = lstm_backward(xproj, lens, w_hh, h, cell, grad_h)
    want_dx, want_dw = lstm_backward_plain(xproj, lens, w_hh, h, cell, grad_h)
    torch.cuda.synchronize()
    check(torch.equal(again[0], d_x) and torch.equal(again[1], dw), "K3: two runs differ")
    smem = backward_smem_on_card(H, dev)
    check(smem == backward_smem_bytes(H),
          f"K3's shared memory on the card {smem} B, stated {backward_smem_bytes(H)} B")
    err_dx = (d_x - want_dx).abs().max().item()
    err_dw = (dw - want_dw).abs().max().item() / want_dw.abs().max().item()
    check(bool(torch.isfinite(d_x).all()) and bool(torch.isfinite(dw).all()), "K3 outputs finite")
    check(all(bool((d_x[b, n:] == 0).all()) for b, n in enumerate(lens_np)),
          "K3 d_xproj at pad frames is not exactly zero")
    check(err_dx <= K3_TOL_DX, f"K3 d_xproj max |kernel - plain| = {err_dx} > {K3_TOL_DX}")
    check(err_dw <= K3_TOL_DW, f"K3 dW_hh max |kernel - plain| / max |plain| = {err_dw}")

    ms = cuda_ms(lambda: lstm_backward(xproj, lens, w_hh, h, cell, grad_h), 10)
    plain_ms = cuda_ms(lambda: lstm_backward_plain(xproj, lens, w_hh, h, cell, grad_h), 1, warmup=1)
    # yardstick: cuDNN's bidirectional LSTM over the packed sequence, forward
    # and backward, input projection included (the port never calls it)
    ref = _cudnn_bilstm(dev, w_ih, w_hh, b_ih, b_hh)
    xg = x.clone().requires_grad_(True)
    lens_cpu = torch.from_numpy(lens_np.astype(np.int64))

    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(xg, lens_cpu, batch_first=True,
                                                         enforce_sorted=False)
        out = torch.nn.utils.rnn.pad_packed_sequence(ref(packed)[0], batch_first=True,
                                                     total_length=T)[0]
        torch.autograd.backward(out, grad_h)

    library_ms = cuda_ms(library, 5)
    G = 4 * H
    steps = int(lens_np.sum()) * D
    # bytes: per valid step its projection, h_prev, c_prev and dh in; W_hh
    # and the lengths in; all of d_xproj (zeros at pad frames) and dW_hh out
    nbytes = (steps * (G + 3 * H) * 4 + w_hh.numel() * 4 + lens.numel() * 4
              + d_x.numel() * 4 + dw.numel() * 4)
    # per valid step: the gate recompute, dh_prev and dW_hh (2·4H·H each),
    # and the cell's elementwise backward (~30 a unit)
    flops = steps * (3 * 2 * G * H + 30 * H)
    bound_ms, bound_by = bound(nbytes, flops, "fp32")
    # K2 with the cell output: the valid frames' projections, W_hh and the
    # lengths in; all of h and the valid frames' cell states out
    k2_bound = bound(steps * G * 4 + w_hh.numel() * 4 + lens.numel() * 4 + h.numel() * 4
                     + steps * H * 4, steps * (2 * G * H + 2 * G + 5 * H), "fp32")
    res = {"name": "lstm_backward (K3)", "route": "cuda", "source": "lightning_asr_torch/csrc/lstm_bwd.cu",
           "replaces": "lightning_asr_tpu/ops/lstm_pallas.py:89",
           "max_abs_err": err_dx, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    steps_seq = int(lens_np.max())
    # K3's device time by kernel: the gates of every frame, the walk, the
    # sum of the per-row dW_hh partials
    _, _, split, passes = device_time(lambda: lstm_backward(xproj, lens, w_hh, h, cell, grad_h), 5)
    print(json.dumps({"phase": "K3", "shape": [B, T, C, H, D], "tol_dx": K3_TOL_DX, "tol_dw_rel": K3_TOL_DW,
                      "dw_max_rel_err": err_dw, "kernel_ms": ms, "sequential_steps": steps_seq,
                      "us_per_step": 1e3 * ms / steps_seq, "k2_us_per_step": 1e3 * k2_ms / steps_seq,
                      "valid_row_frames": int(lens_np.sum()), "same_bits_twice": True,
                      "split_ms": {("gates" if "gates_kernel" in k else "walk" if "lstm_bwd" in k
                                    else "dw_row_sum" if "reduce" in k else k[:40]): v
                                   for k, v in split.items()},
                      "profiler_passes": passes,
                      "smem_bytes": smem, "hmma": None if hmma is None else hmma["lstm_bwd"],
                      "ptxas": ptxas_kernels(ptxas_report),
                      "k2_with_cell": {"max_abs_err": k2_err, "cell_max_abs_err": k2_cell_err,
                                       "ms": k2_ms, "bound_ms": k2_bound[0], "bound_by": k2_bound[1]},
                      "phase_launches": lstm_backward.launches, **res}), flush=True)
    return res


def phase_k78(dev, hmma, ptxas_report: str):
    """K7 and K8, the batch-stacked BiLSTM recurrence and its backward, at
    the training shape (B=32, T'=836, C=256, H=40, ragged lengths) against
    their plain versions and against K2 / K3 on the same inputs."""
    rng = np.random.default_rng(7)
    B, T, C, H, D = TRAIN_BATCH, T_TRAIN, 256, 40, 2
    x, (w_ih, w_hh, b_ih, b_hh), lens_np, lens, xproj = bilstm_inputs(dev, rng, B, T)
    grad_h = torch.from_numpy(rng.standard_normal((B, T, D * H)).astype(np.float32)).to(dev)
    # the stacked rows as ops/lstm.py builds them
    xp = stack_directions(xproj).contiguous()
    valid = stacked_valid(T, lens)
    gs = stack_directions(grad_h.reshape(B, T, D, H)).contiguous()
    w_f, w_b = w_hh[0].contiguous(), w_hh[1].contiguous()

    lstm_recurrence_stacked.launches = lstm_backward_stacked.launches = 0
    h, h_prev, c_prev = lstm_recurrence_stacked(xp, valid, w_f, w_b)
    d_x, dw_f, dw_b = lstm_backward_stacked(xp, valid, w_f, w_b, h_prev, c_prev, gs)
    want = lstm_recurrence_stacked_plain(xp, valid, w_f, w_b)
    want_dx, want_f, want_b = lstm_backward_stacked_plain(xp, valid, w_f, w_b, h_prev, c_prev, gs)
    h2, cell = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    dx3, dw3 = lstm_backward(xproj, lens, w_hh, h2, cell, grad_h)
    torch.cuda.synchronize()
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()  # noqa: E731
    errs = {
        "K7_h": (h - want[0]).abs().max().item(), "K7_h_prev": (h_prev - want[1]).abs().max().item(),
        "K7_c_prev": (c_prev - want[2]).abs().max().item(),
        "K7_h_vs_K2": (unstack_directions(h).reshape(B, T, D * H) - h2).abs().max().item(),
        "K8_dx": (d_x - want_dx).abs().max().item(),
        "K8_dw_rel": max(rel(dw_f, want_f), rel(dw_b, want_b)),
        "K8_dx_vs_K3": (unstack_directions(d_x) - dx3).abs().max().item(),
        "K8_dw_vs_K3_rel": max(rel(dw_f, dw3[0]), rel(dw_b, dw3[1])),
    }
    check(all(bool(torch.isfinite(t).all()) for t in (h, h_prev, c_prev, d_x, dw_f, dw_b)),
          "K7/K8 outputs finite")
    check(bool((h[valid == 0] == 0).all()) and bool((d_x[valid == 0] == 0).all()),
          "K7 h / K8 d_xproj at invalid steps are not exactly zero")
    check(errs["K7_h"] <= K2_TOL and errs["K7_h_prev"] <= K2_TOL and errs["K7_c_prev"] <= 10 * K2_TOL,
          f"K7 against plain: {errs}")
    check(errs["K7_h_vs_K2"] == 0.0, f"K7's h is not K2's bit for bit: {errs}")
    check(errs["K8_dx"] <= K3_TOL_DX and errs["K8_dw_rel"] <= K3_TOL_DW
          and errs["K8_dx_vs_K3"] <= K3_TOL_DX and errs["K8_dw_vs_K3_rel"] <= K3_TOL_DW,
          f"K8 against plain / K3: {errs}")
    again7 = lstm_recurrence_stacked(xp, valid, w_f, w_b)
    again8 = lstm_backward_stacked(xp, valid, w_f, w_b, h_prev, c_prev, gs)
    check(all(torch.equal(a, b) for a, b in zip(again7 + again8, (h, h_prev, c_prev, d_x, dw_f, dw_b))),
          "K7/K8: two runs differ")
    launches = {"K7": lstm_recurrence_stacked.launches, "K8": lstm_backward_stacked.launches}
    smem = stacked_backward_smem_on_card(H, dev)
    check(smem == stacked_backward_smem_bytes(H),
          f"K8's shared memory on the card {smem} B, stated {stacked_backward_smem_bytes(H)} B")
    smem7 = stacked_forward_smem_on_card(H, dev)
    check(smem7 == stacked_forward_smem_bytes(H),
          f"K7's shared memory on the card {smem7} B, stated {stacked_forward_smem_bytes(H)} B")
    check(hmma is None or hmma["lstm_bidir"] == 0, f"K7/K8 run on the CUDA cores: HMMA {hmma}")

    ref = _cudnn_bilstm(dev, w_ih, w_hh, b_ih, b_hh)
    lens_cpu = torch.from_numpy(lens_np.astype(np.int64))
    xg = x.clone().requires_grad_(True)

    def cudnn(backward: bool):
        with torch.set_grad_enabled(backward):
            packed = torch.nn.utils.rnn.pack_padded_sequence(xg if backward else x, lens_cpu,
                                                             batch_first=True, enforce_sorted=False)
            out = torch.nn.utils.rnn.pad_packed_sequence(ref(packed)[0], batch_first=True,
                                                         total_length=T)[0]
            if backward:
                torch.autograd.backward(out, grad_h)

    times = {
        "K7": (cuda_ms(lambda: lstm_recurrence_stacked(xp, valid, w_f, w_b), 20),
               cuda_ms(lambda: lstm_recurrence_stacked_plain(xp, valid, w_f, w_b), 1, warmup=1),
               cuda_ms(lambda: cudnn(False), 10)),
        "K8": (cuda_ms(lambda: lstm_backward_stacked(xp, valid, w_f, w_b, h_prev, c_prev, gs), 10),
               cuda_ms(lambda: lstm_backward_stacked_plain(xp, valid, w_f, w_b, h_prev, c_prev, gs),
                       1, warmup=1),
               cuda_ms(lambda: cudnn(True), 5)),
        "K2_with_cell": (cuda_ms(lambda: lstm_recurrence(xproj, lens, w_hh, with_cell=True), 20),),
        "K3": (cuda_ms(lambda: lstm_backward(xproj, lens, w_hh, h2, cell, grad_h), 10),),
    }
    G = 4 * H
    steps = int(lens_np.sum()) * D                  # valid row-steps
    small = valid.numel() * 4 + 2 * w_f.numel() * 4
    # K7: the valid steps' projections, the mask and both W_hh in; h, h_prev
    # and c_prev out for every step
    b7 = bound(steps * G * 4 + small + 3 * h.numel() * 4, steps * (2 * G * H + 2 * G + 5 * H), "fp32")
    # K8: per valid step its projection, h_prev, c_prev and dh in; all of
    # d_xproj and both dW_hh out; the gate recompute, dh_prev and dW_hh
    b8 = bound(steps * (G + 3 * H) * 4 + small + d_x.numel() * 4 + 2 * dw_f.numel() * 4,
               steps * (3 * 2 * G * H + 30 * H), "fp32")
    rows = []
    for key, name, line, err, (bms, bby) in (
            ("K7", "lstm_recurrence_stacked (K7)", 155, errs["K7_h"], b7),
            ("K8", "lstm_backward_stacked (K8)", 184, errs["K8_dx"], b8)):
        ms, plain_ms, library_ms = times[key]
        rows.append({"name": name, "route": "cuda", "source": "lightning_asr_torch/csrc/lstm_bidir.cu",
                     "replaces": f"lightning_asr_tpu/ops/lstm_pallas.py:{line}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bby, "library_ms": library_ms})
    # K8's device time by kernel: the step lists, the gates of every valid
    # step, the walk, the sum of the per-row dW_hh partials
    _, _, split, passes = device_time(
        lambda: lstm_backward_stacked(xp, valid, w_f, w_b, h_prev, c_prev, gs), 5)
    steps_seq = int(lens_np.max())
    us = {key: 1e3 * times[key][0] / steps_seq for key in ("K7", "K8", "K3", "K2_with_cell")}
    ptxas = ptxas_kernels(ptxas_report)
    print(json.dumps({"phase": "K7/K8", "shape": [B, T, C, H, D], "tol": K2_TOL, "tol_dx": K3_TOL_DX,
                      "tol_dw_rel": K3_TOL_DW, **errs, "valid_row_steps": steps,
                      "same_inputs_ms": {"K2_with_cell": times["K2_with_cell"][0],
                                         "K3": times["K3"][0]},
                      "sequential_steps": steps_seq, "us_per_step": us,
                      "K8_split_ms": {("steps" if "steps_kernel" in k else "gates" if "gates_kernel" in k
                                       else "walk" if "walk_kernel" in k else "dw_row_sum" if "reduce" in k
                                       else k[:40]): v for k, v in split.items()},
                      "profiler_passes": passes,
                      "K7_smem_bytes": smem7, "K8_smem_bytes": smem,
                      "hmma": None if hmma is None else hmma["lstm_bidir"],
                      "K7_ptxas": {k: v for k, v in ptxas.items() if k.startswith("lstm_stacked_fwd")},
                      "ptxas": ptxas,
                      "phase_launches": launches, "kernels": rows}), flush=True)
    return rows


def h128_kernels(dev, reports: dict) -> dict:
    """K2, K3, K7 and K8 at the LSTM head's hidden size (H=128) at the
    training shape (B=32, T'=836, ragged rows, input width 1024: the 12x1
    encoder's output) against their plain versions, twice for the same
    bits, with their times, bounds and cuDNN's packed BiLSTM at hidden 128
    as the yardstick; K8 against K3 on the same rows (equal bits expected)
    and K7 and K8 on a mask with holes against their plain versions; their
    shared memory against the stated layouts, and the registers and spills
    of the H=128 instantiations (K2's, K3's, K7's and K8's must spill none);
    their device time by kernel (step lists, gates pass, pair walk, dW
    pass) and the resident clusters of their walks and dW passes.  Returns
    {"K2": row, ...} of the kernels line's keys (launches: this call's)."""
    rng = np.random.default_rng(128)
    B, T, C, H, D = TRAIN_BATCH, T_TRAIN, 1024, HEAD_HIDDEN, 2
    x, (w_ih, w_hh, b_ih, b_hh), lens_np, lens, xproj = bilstm_inputs(dev, rng, B, T, C=C, H=H)
    grad_h = torch.from_numpy(rng.standard_normal((B, T, D * H)).astype(np.float32)).to(dev)
    xp = stack_directions(xproj).contiguous()
    valid = stacked_valid(T, lens)
    gs = stack_directions(grad_h.reshape(B, T, D, H)).contiguous()
    w_f, w_b = w_hh[0].contiguous(), w_hh[1].contiguous()
    counters = (lstm_recurrence, lstm_backward, lstm_recurrence_stacked, lstm_backward_stacked)
    for fn in counters:
        fn.launches = 0

    k2 = lambda: lstm_recurrence(xproj, lens, w_hh, with_cell=True)  # noqa: E731
    h, cell = k2()
    k3 = lambda: lstm_backward(xproj, lens, w_hh, h, cell, grad_h)  # noqa: E731
    d_x, dw = k3()
    k7 = lambda: lstm_recurrence_stacked(xp, valid, w_f, w_b)  # noqa: E731
    h7, h_prev, c_prev = k7()
    k8 = lambda: lstm_backward_stacked(xp, valid, w_f, w_b, h_prev, c_prev, gs)  # noqa: E731
    d_x8, dw_f, dw_b = k8()
    outs = (h, cell, d_x, dw, h7, h_prev, c_prev, d_x8, dw_f, dw_b)
    check(all(bool(torch.isfinite(t).all()) for t in outs), "H=128 LSTM kernels: outputs finite")
    again = (*k2(), *k3(), *k7(), *k8())
    check(all(torch.equal(a, b) for a, b in zip(again, outs)), "H=128 LSTM kernels: two runs differ")
    launches = {fn.__name__: fn.launches for fn in counters}
    plain2 = lambda: lstm_recurrence_plain(xproj, lens, w_hh, with_cell=True)  # noqa: E731
    plain3 = lambda: lstm_backward_plain(xproj, lens, w_hh, h, cell, grad_h)  # noqa: E731
    plain7 = lambda: lstm_recurrence_stacked_plain(xp, valid, w_f, w_b)  # noqa: E731
    plain8 = lambda: lstm_backward_stacked_plain(xp, valid, w_f, w_b, h_prev, c_prev, gs)  # noqa: E731
    want_h, want_c = plain2()
    want_dx, want_dw = plain3()
    want7 = plain7()
    want_dx8, want_f, want_b = plain8()
    torch.cuda.synchronize()
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()  # noqa: E731
    errs = {"K2_h": (h - want_h).abs().max().item(), "K2_c": (cell - want_c).abs().max().item(),
            "K3_dx": (d_x - want_dx).abs().max().item(), "K3_dw_rel": rel(dw, want_dw),
            "K7_h": (h7 - want7[0]).abs().max().item(),
            "K7_h_prev": (h_prev - want7[1]).abs().max().item(),
            "K7_c_prev": (c_prev - want7[2]).abs().max().item(),
            "K7_h_vs_K2": (unstack_directions(h7).reshape(B, T, D * H) - h).abs().max().item(),
            "K8_dx": (d_x8 - want_dx8).abs().max().item(),
            "K8_dw_rel": max(rel(dw_f, want_f), rel(dw_b, want_b)),
            "K8_dx_vs_K3": (unstack_directions(d_x8) - d_x).abs().max().item(),
            "K8_dw_vs_K3_rel": max(rel(dw_f, dw[0]), rel(dw_b, dw[1]))}
    errs.update(_k8_holes(dev, w_f, w_b))
    check(all(bool((h[b, n:] == 0).all()) and bool((d_x[b, n:] == 0).all())
              for b, n in enumerate(lens_np)), "H=128 K2 h / K3 d_xproj at pad frames not exactly 0")
    check(bool((h7[valid == 0] == 0).all()) and bool((d_x8[valid == 0] == 0).all()),
          "H=128 K7 h / K8 d_xproj at invalid steps not exactly 0")
    check(errs["K2_h"] <= K2_TOL and errs["K2_c"] <= 10 * K2_TOL and errs["K7_h"] <= K2_TOL
          and errs["K7_h_prev"] <= K2_TOL and errs["K7_c_prev"] <= 10 * K2_TOL,
          f"H=128 K2/K7 against plain: {errs}")
    check(errs["K7_h_vs_K2"] == 0.0, f"H=128 K7's h is not K2's bit for bit: {errs}")
    check(errs["K7_holes_h"] <= K2_TOL and errs["K7_holes_h_prev"] <= K2_TOL
          and errs["K7_holes_c_prev"] <= 10 * K2_TOL, f"H=128 K7 with holes against plain: {errs}")
    check(errs["K3_dx"] <= K3_TOL_DX and errs["K3_dw_rel"] <= K3_TOL_DW and errs["K8_dx"] <= K3_TOL_DX
          and errs["K8_dw_rel"] <= K3_TOL_DW and errs["K8_holes_dx"] <= K3_TOL_DX
          and errs["K8_holes_dw_rel"] <= K3_TOL_DW, f"H=128 K3/K8 against plain: {errs}")
    check(errs["K8_dx_vs_K3"] <= K3_TOL_DX and errs["K8_dw_vs_K3_rel"] <= K3_TOL_DW,
          f"H=128 K8 against K3: {errs}")
    smem = {"K2": (forward_smem_on_card(H, dev), forward_smem_bytes(H)),
            "K3": (backward_smem_on_card(H, dev), backward_smem_bytes(H)),
            "K7": (stacked_forward_smem_on_card(H, dev), stacked_forward_smem_bytes(H)),
            "K8": (stacked_backward_smem_on_card(H, dev), stacked_backward_smem_bytes(H))}
    check(all(a == b for a, b in smem.values()), f"H=128 shared memory on the card vs stated: {smem}")

    ref = _cudnn_bilstm(dev, w_ih, w_hh, b_ih, b_hh)
    lens_cpu = torch.from_numpy(lens_np.astype(np.int64))
    xg = x.clone().requires_grad_(True)

    def cudnn(backward: bool):
        with torch.set_grad_enabled(backward):
            packed = torch.nn.utils.rnn.pack_padded_sequence(xg if backward else x, lens_cpu,
                                                             batch_first=True, enforce_sorted=False)
            out = torch.nn.utils.rnn.pad_packed_sequence(ref(packed)[0], batch_first=True,
                                                         total_length=T)[0]
            if backward:
                torch.autograd.backward(out, grad_h)
            return out

    with torch.no_grad():
        cudnn_diff = (cudnn(False) - h).abs().max().item()
    fwd_lib, bwd_lib = cuda_ms(lambda: cudnn(False), 5), cuda_ms(lambda: cudnn(True), 3)
    G = 4 * H
    steps = int(lens_np.sum()) * D                  # valid row-steps
    small = w_hh.numel() * 4 + lens.numel() * 4
    f_fwd, f_bwd = steps * (2 * G * H + 2 * G + 5 * H), steps * (3 * 2 * G * H + 30 * H)
    bounds = {
        # the valid frames' projections, W_hh and the lengths in; all of h
        # and the valid frames' cell states out
        "K2": bound(steps * G * 4 + small + h.numel() * 4 + steps * H * 4, f_fwd, "fp32"),
        # per valid step its projection, h_prev, c_prev and dh in; all of
        # d_xproj and dW_hh out
        "K3": bound(steps * (G + 3 * H) * 4 + small + d_x.numel() * 4 + dw.numel() * 4, f_bwd, "fp32"),
        # the valid steps' projections, the mask and both W_hh in; h, h_prev
        # and c_prev out for every step
        "K7": bound(steps * G * 4 + valid.numel() * 4 + w_hh.numel() * 4 + 3 * h7.numel() * 4,
                    f_fwd, "fp32"),
        "K8": bound(steps * (G + 3 * H) * 4 + valid.numel() * 4 + w_hh.numel() * 4
                    + d_x8.numel() * 4 + 2 * dw_f.numel() * 4, f_bwd, "fp32"),
    }
    timed = {"K2": (k2, plain2, fwd_lib, errs["K2_h"]), "K3": (k3, plain3, bwd_lib, errs["K3_dx"]),
             "K7": (k7, plain7, fwd_lib, errs["K7_h"]), "K8": (k8, plain8, bwd_lib, errs["K8_dx"])}
    rows = {}
    for key, (fn, plain, library_ms, err) in timed.items():
        ms = cuda_ms(fn, 5)
        rows[key] = {"launches": 0, "max_abs_err": err, "ms": ms,
                     "plain_ms": cuda_ms(plain, 1, warmup=0), "bound_ms": bounds[key][0],
                     "bound_by": bounds[key][1], "library_ms": library_ms,
                     "us_per_step": 1e3 * ms / int(lens_np.max())}
    ptxas = {k: v for name in ("lstm", "lstm_bwd", "lstm_bidir")
             for k, v in ptxas_kernels(reports.get(name, "")).items() if "<128" in k}
    for key, source, names in (("K2", "lstm", K2_H128_KERNELS), ("K3", "lstm_bwd", K3_H128_KERNELS),
                               ("K7", "lstm_bidir", K7_H128_KERNELS),
                               ("K8", "lstm_bidir", K8_H128_KERNELS)):
        got = {k: v for k, v in ptxas.items() if k.split("<")[0] in {n.split("<")[0] for n in names}}
        if reports.get(source):                     # built in this run: ptxas reported each kernel
            check(set(got) == set(names) and all(v.get("spill_bytes", -1) == 0 for v in got.values()),
                  f"{key}'s H=128 kernels must spill 0 bytes: {got}")
    # K2's, K3's, K7's and K8's device time by kernel: the step lists (K7,
    # K8), the gates pass, the pair walk (K2's with its pad frames, K7's with
    # its gaps), the dW pass
    splits, passes = {}, {}
    for key, fn in (("K2", k2), ("K3", k3), ("K7", k7), ("K8", k8)):
        _, _, split, passes[key] = device_time(fn, 5)
        splits[key] = {("steps" if "steps_kernel" in k else "gates" if "gates_kernel" in k
                        else "walk" if "pair_kernel" in k else "dw" if "dw_kernel" in k
                        else k[:40]): v for k, v in split.items()}
    clusters = {"K2": {"walk": forward_clusters_on_card(dev), "walk_needed": B * D},
                "K3": {"walk": backward_clusters_on_card(dev), "dw": backward_clusters_on_card(dev, True),
                       "walk_needed": B * D},
                "K7": {"walk": stacked_forward_clusters_on_card(dev), "walk_needed": 2 * B},
                "K8": {"walk": stacked_backward_clusters_on_card(dev),
                       "dw": stacked_backward_clusters_on_card(dev, True), "walk_needed": 2 * B}}
    check(all(min(c["walk"], c.get("dw", c["walk"])) > 0 for c in clusters.values()),
          f"K2's, K3's, K7's or K8's H=128 clusters do not fit: {clusters}")
    print(json.dumps({"phase": "lstm_h128", "shape": [B, T, C, H, D], "tol": K2_TOL,
                      "tol_dx": K3_TOL_DX, "tol_dw_rel": K3_TOL_DW, **errs,
                      "cudnn_max_abs_diff": cudnn_diff, "valid_row_steps": steps,
                      "sequential_steps": int(lens_np.max()), "smem_bytes": smem,
                      "K2_split_ms": splits["K2"], "K3_split_ms": splits["K3"],
                      "K7_split_ms": splits["K7"], "K8_split_ms": splits["K8"],
                      "profiler_passes": passes, "resident_clusters": clusters,
                      "ptxas": ptxas, "check_launches": launches, "kernels": rows}), flush=True)
    return rows


def _k8_holes(dev, w_f, w_b) -> dict:
    """K7 and K8 at H=128 on a random mask with holes (HOLES_B rows, HOLES_T
    steps, a share HOLES_VALID of them valid, every row's state carried
    through its holes) against their plain versions, twice for the same
    bits, with exact zeros at the invalid steps."""
    rng = np.random.default_rng(70)
    G, H = w_f.shape
    B2 = 2 * HOLES_B
    xp = torch.from_numpy(rng.standard_normal((HOLES_T, B2, G)).astype(np.float32)).to(dev)
    valid = torch.from_numpy((rng.uniform(size=(HOLES_T, B2)) < HOLES_VALID).astype(np.float32)).to(dev)
    gs = torch.from_numpy(rng.standard_normal((HOLES_T, B2, H)).astype(np.float32)).to(dev)
    fwd = lstm_recurrence_stacked(xp, valid, w_f, w_b)
    _, h_prev, c_prev = fwd
    got = lstm_backward_stacked(xp, valid, w_f, w_b, h_prev, c_prev, gs)
    fwd_again = lstm_recurrence_stacked(xp, valid, w_f, w_b)
    want_fwd = lstm_recurrence_stacked_plain(xp, valid, w_f, w_b)
    again = lstm_backward_stacked(xp, valid, w_f, w_b, h_prev, c_prev, gs)
    want_dx, want_f, want_b = lstm_backward_stacked_plain(xp, valid, w_f, w_b, h_prev, c_prev, gs)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got + fwd, again + fwd_again)),
          "H=128 K7/K8 with holes: two runs differ")
    check(all(bool(torch.isfinite(t).all()) for t in fwd) and bool((fwd[0][valid == 0] == 0).all()),
          "H=128 K7 with holes: outputs not finite or h at invalid steps not exactly 0")
    check(all(bool(torch.isfinite(t).all()) for t in got) and bool((got[0][valid == 0] == 0).all()),
          "H=128 K8 with holes: outputs not finite or d_xproj at invalid steps not exactly 0")
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()  # noqa: E731
    return {"K7_holes_h": (fwd[0] - want_fwd[0]).abs().max().item(),
            "K7_holes_h_prev": (fwd[1] - want_fwd[1]).abs().max().item(),
            "K7_holes_c_prev": (fwd[2] - want_fwd[2]).abs().max().item(),
            "K8_holes_dx": (got[0] - want_dx).abs().max().item(),
            "K8_holes_dw_rel": max(rel(got[1], want_f), rel(got[2], want_b)),
            "K8_holes_valid_share": valid.mean().item()}


def head_teeth(model, gen: torch.Generator, dev) -> None:
    """The LSTM head model's seeded terms: ``bn_teeth``'s BatchNorm terms,
    running statistics from HEAD_CALIBRATION_PASSES train-mode passes on the
    card over random features (``mel_inputs``), then ``head_fc`` centred
    (its bias cancels its logits' mean on one more such batch) and scaled to
    a class std of TEETH_CLASS_STD, as ``calibrated_teeth`` sets a decoder."""
    bn_teeth(model, gen)
    inputs = lambda: tuple(t.to(dev) for t in mel_inputs(gen))  # noqa: E731
    with torch.no_grad():
        model.train()
        for _ in range(HEAD_CALIBRATION_PASSES):
            model(*inputs())
        seen = {}
        hook = model.head_fc.register_forward_pre_hook(lambda mod, args: seen.update(x=args[0]))
        model.eval()(*inputs())
        hook.remove()
        logits = model.head_fc(seen["x"])
        model.head_fc.bias.sub_(logits.mean(dim=(0, 1)))
        scale = TEETH_CLASS_STD / (logits - logits.mean(dim=(0, 1))).std(dim=-1).mean().item()
        model.head_fc.weight.mul_(scale)
        model.head_fc.bias.mul_(scale)


def _head_counts() -> dict:
    """The LSTM kernels' launches at H=128 so far."""
    return {fn.__name__: fn.launches_at.get(HEAD_HIDDEN, 0)
            for fn in (lstm_recurrence, lstm_backward, lstm_recurrence_stacked, lstm_backward_stacked)}


def _head_serving(dev) -> dict:
    """The head model (quartznet12_context, ``lstm_head=True``, bf16 convs,
    mask on, ``head_teeth``) in eval mode at the serving shape, the serving
    burst's 8 rows of 2-16 s as log-mels (1601 frames) from the CPU
    frontend: on the card,
    also with ``fuse_directions``, against the CPU under the serving bounds
    (SERVE_TOL_*, over valid frames); K2 (or K7) once at H=40 and once at
    H=128 a forward."""
    model = build_model(len(LABELS) + 1, mask=True, dtype=torch.bfloat16, lstm_head=True)
    reset_parameters(model, torch.Generator().manual_seed(19))
    model.to(dev)
    head_teeth(model, torch.Generator().manual_seed(20), dev)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    rows = [torch.from_numpy(read_audio(blob)[0][0]) for blob in serving_burst()[1]]
    waves = torch.nn.utils.rnn.pad_sequence(rows, batch_first=True)
    feats, feat_lens = log_mel_spectrogram(waves, torch.tensor([len(r) for r in rows]),
                                           MelFrontendConfig(precision="default"))
    percents = feat_lens.float() / feats.shape[1]

    def forward(where, fuse: bool):
        m = build_model(len(LABELS) + 1, mask=True, dtype=torch.bfloat16, lstm_head=True,
                        fuse_directions=fuse)
        m.load_state_dict(state)
        m.to(where).eval()
        with torch.no_grad():
            lp, lens = m(feats.to(where), percents.to(where))
        return lp.float().cpu(), lens.cpu()

    cpu, cpu_lens = forward("cpu", False)
    out = {}
    for fuse in (False, True):
        before = {fn.__name__: fn.launches for fn in (lstm_recurrence, lstm_recurrence_stacked)}
        before_h = _head_counts()
        card, lens = forward(dev, fuse)
        ran = {fn.__name__: fn.launches - before[fn.__name__]
               for fn in (lstm_recurrence, lstm_recurrence_stacked)}
        ran_h = {k: v - before_h[k] for k, v in _head_counts().items()}
        key = "lstm_recurrence_stacked" if fuse else "lstm_recurrence"
        check(ran[key] == 2 and ran_h[key] == 1 and sum(ran.values()) == 2,
              f"head serving (fuse {fuse}): LSTM launches {ran}, at H=128 {ran_h}")
        check(torch.equal(lens, cpu_lens) and bool(torch.isfinite(card).all()),
              "head serving: lengths or finite")
        valid = torch.arange(card.shape[1])[None, :] < lens[:, None]
        err = (card - cpu).abs()[valid]
        agree = float((card.argmax(-1) == cpu.argmax(-1))[valid].float().mean())
        class_std = float(cpu.std(dim=-1)[valid].mean())
        check(err.max().item() <= SERVE_TOL_MAX and err.mean().item() <= SERVE_TOL_MEAN
              and agree >= SERVE_MIN_ARGMAX,
              f"head serving (fuse {fuse}) card vs CPU: max {err.max().item()}, mean "
              f"{err.mean().item()}, argmax agreement {agree}")
        out["fused_bidir" if fuse else "default"] = {
            "max_abs": err.max().item(), "mean_abs": err.mean().item(), "argmax_agreement": agree,
            "cpu_class_std": class_std, "lstm_launches": ran, "at_h128": ran_h}
    return {"shape": list(feats.shape), "valid_frames": int(lens.sum()), **out}


def _head_parity(dev) -> dict:
    """One float32 step of the head model (B=4, 4 s, no dither,
    augmentation or dropout) from the CPU's log-mels, on the card (also
    with ``fuse_directions``) against the CPU, under TRAIN_TOL (worst
    gradient 5e-2); the card's own move when the log-mels move by 1e-7
    relative is recorded beside (``chaos_floor``), not used as a bound."""
    gen = torch.Generator().manual_seed(6)
    model0 = build_model(len(LABELS) + 1, mask=True, lstm_head=True)
    reset_parameters(model0, gen)
    init = {k: v.clone() for k, v in model0.state_dict().items()}
    batch_np, _ = train_batch(np.random.default_rng(6), 4, 4.0, 3.9)
    waves = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    frontend = MelFrontendConfig(dither=0.0, precision="default")
    feats, feat_lens = log_mel_spectrogram(waves["waves"], waves["wave_lens"], frontend)
    batch = {**waves, "waves": feats, "wave_lens": feat_lens}

    def one_step(where, batch, fuse: bool):
        return parity_step(init, where, batch, frontend, True, lstm_head=True, fuse_directions=fuse)

    cpu = one_step("cpu", batch, False)
    out = {}
    for fuse in (False, True):
        card = one_step(dev, batch, fuse)
        errs, worst = _step_errors(card, cpu)
        check(bool(card[3]["finite"]) and bool(cpu[3]["finite"]), "head parity: loss not finite")
        check(torch.equal(card[3]["pred_lens"], cpu[3]["pred_lens"]), "head parity: pred_lens differ")
        for key, lim in TRAIN_TOL.items():
            check(errs[key] <= lim, f"head parity (fuse {fuse}): {key} {errs[key]} > {lim} "
                                    f"(worst tensor {worst})")
        out["fused_bidir" if fuse else "default"] = {**errs, "worst_grad_tensor": worst,
                                                     "loss_card": card[3]["loss"].item()}
        if not fuse:
            jitter = torch.randn(feats.shape, generator=torch.Generator().manual_seed(7))
            moved = one_step(dev, {**batch, "waves": feats * (1 + 1e-7 * jitter)}, False)
            out["chaos_floor"] = _step_errors(moved, card)[0]
    return {"batch": 4, "bucket_s": 4.0, "dtype": "float32", "from_features": True,
            "loss_cpu": cpu[3]["loss"].item(), "limits": TRAIN_TOL, **out}


MMAP_COUNTERS = (mel_from_extended, lstm_recurrence, lstm_backward, ctc_alpha, ctc_beta,
                 extend_preemph)


def _mmap_trainer(dev) -> dict:
    """``data.cache=mmap`` on the card, on a tone corpus as phase 16's: the
    native loader on every file against ``read_audio``'s int16; the training
    CLI's ``main`` with ``data.cache=mmap`` in this process (the cache at
    its default place, beside the train manifest), then again in a fresh
    process (``python -c``), which must append nothing, and with
    ``data.cache=ram`` in this process: the three runs' losses and metrics
    equal (cuDNN deterministic in each)."""
    deterministic = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        train = tone_corpus(root, MMAP_UTTS, 0, "train")
        dev_m = tone_corpus(root, MMAP_DEV_UTTS, 1, "dev")
        paths = [json.loads(line)["audio_filepath"]
                 for m in (train, dev_m) for line in m.read_text().splitlines()]
        t0 = time.perf_counter()
        waves, lens, _, srs = native.load_wav_batch(paths, None, 3 * SR, dtype="int16")
        loader_s = time.perf_counter() - t0
        check(bool((lens > 0).all()) and bool((srs == SR).all()), f"native loader: lens {lens}")
        for i, p in enumerate(paths):
            want = np.round(read_audio(p)[0][0] * 32768.0).clip(-32768, 32767).astype(np.int16)
            check(lens[i] == want.shape[0] and np.array_equal(waves[i, : lens[i]], want),
                  f"native loader: {p} differs from read_audio's int16")
        cache = train.parent / "_lasr_wave_cache"
        common = [f"data.train_manifest={train}", f"data.val_manifest={dev_m}",
                  f"data.test_manifest={dev_m}", "data.bucket_seconds=[3.0]",
                  f"train.total_epoch={MMAP_EPOCHS}", f"train.train_batch_size={MMAP_BATCH}",
                  f"train.dev_batch_size={MMAP_BATCH}", "train.warmup_steps=2",
                  "train.log_every_n_steps=1", "model.compute_dtype=bf16"]

        def results(run: Path) -> dict:
            metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
            return {"metrics": [{k: v for k, v in m.items() if k != "time"} for m in metrics]}

        def stat():
            lines = (cache / "index.jsonl").read_text().splitlines()
            return (cache / "waves.bin").stat().st_size, {json.loads(line)["p"] for line in lines}

        torch.backends.cudnn.deterministic = True
        try:
            runs = {}
            for name, extra in (("mmap", ["data.cache=mmap"]), ("ram", ["data.cache=ram"])):
                for fn in MMAP_COUNTERS:
                    fn.launches = 0
                rows, reads = native.load_wav_batch.rows, BucketBatcher.audio_reads
                t0 = time.perf_counter()
                _run_train(common + extra + [f"log.run.dir={root / name}"])
                runs[name] = {"wall_s": time.perf_counter() - t0, **results(root / name),
                              "launches": {fn.__name__: fn.launches for fn in MMAP_COUNTERS},
                              "loader_rows": native.load_wav_batch.rows - rows,
                              "read_audio_files": BucketBatcher.audio_reads - reads}
                if name == "mmap":
                    size, cached = stat()
            check(cached == set(paths), f"mmap: the index holds {len(cached)} of {len(paths)} files")
            code = ("import sys, torch; sys.path.insert(0, '.'); "
                    "torch.backends.cudnn.deterministic = True; "
                    "torch.backends.cuda.matmul.allow_tf32 = False; "
                    "torch.backends.cudnn.allow_tf32 = False; "
                    "from lightning_asr_torch.train import main; main(sys.argv[1:])")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", code, *common, "data.cache=mmap",
                                   f"log.run.dir={root / 'mmap_again'}"], cwd=Path(__file__).parent,
                                  capture_output=True, text=True, timeout=600)
            again_s = time.perf_counter() - t0
            check(proc.returncode == 0, f"mmap rerun failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
            size2, cached2 = stat()
            runs["mmap_again"] = {"wall_s": again_s, **results(root / "mmap_again")}
        finally:
            torch.backends.cudnn.deterministic = deterministic
    check(size2 == size and cached2 == cached, f"mmap rerun appended: {size} -> {size2} bytes")
    m = runs["mmap"]
    check(m["loader_rows"] >= len(paths) and m["read_audio_files"] == 0,
          f"mmap run: the loader decoded {m['loader_rows']} rows, read_audio {m['read_audio_files']}")
    check(runs["ram"]["metrics"] == m["metrics"] == runs["mmap_again"]["metrics"],
          f"mmap / mmap again / ram metrics differ: {[r['metrics'][-1] for r in runs.values()]}")
    losses = [x["train_loss"] for x in m["metrics"] if "train_loss" in x]
    check(len(losses) > 0 and all(np.isfinite(losses)), f"mmap run: losses {losses}")
    return {"utterances": [MMAP_UTTS, MMAP_DEV_UTTS], "epochs": MMAP_EPOCHS,
            "loader": {"files": len(paths), "ms": 1e3 * loader_s},
            "waves_bin_bytes": size, "indexed_files": len(cached), "rerun_appended_bytes": size2 - size,
            "metrics_equal": True, "last_metrics": m["metrics"][-1],
            "runs": {k: {kk: v for kk, v in r.items() if kk != "metrics"} for k, r in runs.items()}}


def phase_lstm_head_and_data(dev, reports: dict, k2_digests: dict) -> tuple:
    """The LSTM head (K2, K3, K7, K8 at H=128: ``h128_kernels``; the head
    model served, trained and held against the CPU) and the data surface
    (``cache='mmap'`` and the native loader through the training CLI).
    Returns (the kernels' H=128 rows with their launches on the head's
    paths, the launches of K1-K6 on those paths)."""
    t0 = time.perf_counter()
    rows = h128_kernels(dev, reports)
    before = _head_counts()
    serving = _head_serving(dev)
    trainings = [phase_training(dev, steps=HEAD_STEPS, lstm_head=True),
                 phase_training(dev, steps=HEAD_STEPS, fuse_directions=True, lstm_head=True)]
    parity = _head_parity(dev)
    head = {k: v - before[k] for k, v in _head_counts().items()}
    mmap = _mmap_trainer(dev)
    for key, fn in (("K2", "lstm_recurrence"), ("K3", "lstm_backward"),
                    ("K7", "lstm_recurrence_stacked"), ("K8", "lstm_backward_stacked")):
        rows[key]["launches"] = head[fn]
    check(all(r["launches"] > 0 for r in rows.values()), f"a kernel at H=128 never ran: {head}")
    launches = {name: sum(t["launches"][name] for t in trainings) for name in trainings[0]["launches"]}
    for name, n in mmap["runs"]["mmap"]["launches"].items():
        launches[name] = launches.get(name, 0) + n + mmap["runs"]["ram"]["launches"][name]
    print(json.dumps({"phase": "lstm_head_and_data", "seconds": time.perf_counter() - t0,
                      "k2_digests_h40": k2_digests, "head_serving": serving, "head_parity": parity,
                      "head_launches_h128": head, "mmap": mmap,
                      "training_launches": launches}), flush=True)
    return rows, launches


def phase_k45(dev, ptxas_report: str):
    rng = np.random.default_rng(4)
    B, T, C = 32, T_TRAIN, len(LABELS) + 1
    seconds, _, in_np = train_rows(rng, B)
    targets_np, tl_np = train_targets(rng, seconds)
    tl_np[-1] = in_np[-1] + 10            # more labels than frames: an impossible alignment
    logits = torch.from_numpy((rng.standard_normal((B, T, C)) * 2).astype(np.float32)).to(dev)
    lp = torch.log_softmax(logits, dim=-1).contiguous()
    il, tg, tl = (torch.from_numpy(a).to(dev) for a in (in_np, targets_np, tl_np))
    S = 2 * targets_np.shape[1] + 1
    possible = torch.arange(B, device=dev) < B - 1

    ctc_alpha.launches = ctc_beta.launches = 0
    alpha, ll = ctc_alpha(lp, il, tg, tl, BLANK)
    alpha_again, ll_again = ctc_alpha(lp, il, tg, tl, BLANK)
    want_alpha, want_ll = ctc_alpha_plain(lp, il, tg, tl, BLANK)
    gbar = torch.full((B,), 1.0 / B, device=dev)
    grad = ctc_beta(lp, il, tg, tl, alpha, ll, gbar, BLANK)
    again = ctc_beta(lp, il, tg, tl, alpha, ll, gbar, BLANK)
    want_grad = ctc_beta_plain(lp, il, tg, tl, want_alpha, want_ll, gbar, BLANK)
    torch.cuda.synchronize()
    check(torch.equal(again, grad), "K5: two runs differ")
    smem = ctc_beta_smem_on_card(S)
    check(smem == ctc_beta_smem_bytes(S),
          f"K5's shared memory on the card {smem} B, stated {ctc_beta_smem_bytes(S)} B")
    smem4 = ctc_alpha_smem_on_card(S)
    check(smem4 == ctc_alpha_smem_bytes(S),
          f"K4's shared memory on the card {smem4} B, stated {ctc_alpha_smem_bytes(S)} B")
    valid = (torch.arange(T, device=dev)[None, :] < il[:, None])[:, :, None]
    check(torch.equal(alpha_again[valid.expand_as(alpha)], alpha[valid.expand_as(alpha)])
          and torch.equal(ll_again, ll), "K4: two runs differ")
    live = valid & (want_alpha > -1e29)
    scale = want_ll[possible].abs().max().item()
    err_alpha = torch.where(live, alpha - want_alpha, 0.0).abs().max().item() / scale
    err_ll_abs = (ll - want_ll)[possible].abs().max().item()
    err_ll = err_ll_abs / scale
    err_grad = (grad - want_grad).abs().max().item()
    check(ll[-1].item() == want_ll[-1].item() == np.float32(-1e30),
          f"impossible alignment: ll {ll[-1].item()}, plain {want_ll[-1].item()}, want -1e30")
    check(bool(torch.isfinite(ll).all()) and bool(torch.isfinite(grad).all()), "K4/K5 outputs finite")
    check(err_alpha <= K45_TOL_REL and err_ll <= K45_TOL_REL,
          f"K4 against plain: alpha {err_alpha}, ll {err_ll} (relative to max |ll| {scale})")
    check(err_grad <= K45_TOL_GRAD, f"K5 max |kernel - plain| = {err_grad} > {K45_TOL_GRAD}")
    check(bool((torch.where(valid, 0.0, grad) == 0).all()), "K5 gradient past a row's length")

    # the losses against PyTorch's CTC, and the gradients at the logits
    ours = ctc_loss(lp, il, tg, tl, BLANK)
    theirs = torch.nn.functional.ctc_loss(lp.transpose(0, 1), tg, il, tl, blank=BLANK,
                                          reduction="none")
    torch_rel = ((ours - theirs).abs() / theirs.abs())[possible].max().item()
    check(ours[-1].item() == np.float32(1e30) and bool(torch.isinf(theirs[-1])),
          f"impossible row: ours {ours[-1].item()}, torch {theirs[-1].item()}")
    check(torch_rel <= CTC_TORCH_TOL_REL, f"CTC losses vs torch: max rel {torch_rel}")
    weight = possible.to(torch.float32) / B
    g_ours, g_theirs = (logits.clone().requires_grad_(True) for _ in range(2))
    (ctc_loss(torch.log_softmax(g_ours, -1), il, tg, tl, BLANK) * weight).sum().backward()
    (torch.nn.functional.ctc_loss(torch.log_softmax(g_theirs, -1).transpose(0, 1), tg, il, tl,
                                  blank=BLANK, reduction="none").nan_to_num(0.0, 0.0, 0.0)
     * weight).sum().backward()
    torch_grad_err = (g_ours.grad - g_theirs.grad)[:-1].abs().max().item()
    check(torch_grad_err <= 1e-4, f"CTC logit gradients vs torch: max {torch_grad_err}")
    launches = {"alpha": ctc_alpha.launches, "beta": ctc_beta.launches}

    lp_tbc = lp.transpose(0, 1)
    il_l, tl_l = in_np.tolist(), tl_np.tolist()
    nll, log_alpha = torch.ops.aten._ctc_loss(lp_tbc, tg, il_l, tl_l, BLANK, False)
    ones = torch.ones(B, device=dev)
    timing = {
        "alpha": (cuda_ms(lambda: ctc_alpha(lp, il, tg, tl, BLANK), 10),
                  cuda_ms(lambda: ctc_alpha_plain(lp, il, tg, tl, BLANK), 1, warmup=1),
                  cuda_ms(lambda: torch.ops.aten._ctc_loss(lp_tbc, tg, il_l, tl_l, BLANK, False), 10)),
        "beta": (cuda_ms(lambda: ctc_beta(lp, il, tg, tl, alpha, ll, gbar, BLANK), 10),
                 cuda_ms(lambda: ctc_beta_plain(lp, il, tg, tl, alpha, ll, gbar, BLANK), 1, warmup=1),
                 cuda_ms(lambda: torch.ops.aten._ctc_loss_backward(ones, lp_tbc, tg, il_l, tl_l, nll,
                                                                   log_alpha, BLANK, False), 10)),
    }
    frames = int(in_np.sum())
    small = (targets_np.size + 3 * B) * 4
    # K4: the valid frames' log-probs in, alpha of the valid frames out; per
    # (valid frame, state) three exp, a log and ~8 adds and maxes
    b4 = bound(frames * C * 4 + small + frames * S * 4, frames * S * 12, "fp32")
    # K5: log-probs and alpha of the valid frames in, all of grad_emit out;
    # per (valid frame, state) the beta step and exp(alpha + beta - ll)
    b5 = bound(frames * C * 4 + frames * S * 4 + small + grad.numel() * 4, frames * S * 16, "fp32")
    rows = []
    for key, name, line, err, (bms, bby) in (
            ("alpha", "ctc_alpha (K4)", 67, err_ll_abs, b4),
            ("beta", "ctc_beta (K5)", 130, err_grad, b5)):
        ms, plain_ms, library_ms = timing[key]
        rows.append({"name": name, "route": "cuda", "source": "lightning_asr_torch/csrc/ctc.cu",
                     "replaces": f"lightning_asr_tpu/ops/ctc_pallas.py:{line}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bby, "library_ms": library_ms})
    steps_seq = int(in_np.max())
    # K5's device time by kernel
    _, _, split, passes = device_time(lambda: ctc_beta(lp, il, tg, tl, alpha, ll, gbar, BLANK), 5)
    ptxas = ptxas_kernels(ptxas_report)
    print(json.dumps({"phase": "K4/K5", "shape": [B, T, C, S], "tol_rel": K45_TOL_REL,
                      "tol_grad": K45_TOL_GRAD, "alpha_max_rel_err": err_alpha,
                      "ll_max_rel_err": err_ll, "grad_max_abs_err": err_grad,
                      "vs_torch_loss_max_rel": torch_rel, "vs_torch_logit_grad_max_abs": torch_grad_err,
                      "impossible_row_loss": ours[-1].item(), "valid_row_frames": frames,
                      "sequential_steps": steps_seq, "phase_launches": launches,
                      "K4_us_per_step": 1e3 * timing["alpha"][0] / steps_seq,
                      "K5_us_per_step": 1e3 * timing["beta"][0] / steps_seq,
                      "K4_same_bits_twice": True, "K4_ring": ALPHA_RING, "K4_smem_bytes": smem4,
                      "K4_ptxas": {k: v for k, v in ptxas.items() if k.startswith("ctc_alpha_kernel")},
                      "K5_same_bits_twice": True, "K5_ring": ctc_beta_ring(S), "K5_smem_bytes": smem,
                      "K5_split_ms": {k.replace("(anonymous namespace)::", "")[:60]: v
                                      for k, v in split.items()},
                      "profiler_passes": passes, "ptxas": ptxas,
                      "kernels": rows}), flush=True)
    return rows


def train_batch(rng, B: int, bucket_s: float, max_s: float):
    """B int16 waves of 2-``max_s`` s padded to the ``bucket_s`` bucket, with
    ~15 labels a second; numpy."""
    seconds = np.sort(rng.uniform(2.0, max_s, B))[::-1].copy()
    seconds[0] = max_s
    S = int(bucket_s * SR)
    lens = (seconds * SR).astype(np.int32)
    waves = np.zeros((B, S), np.int16)
    for b, n in enumerate(lens):
        waves[b, :n] = (rng.standard_normal(n) * 3000).astype(np.int16)
    targets, tl = train_targets(rng, seconds)
    return {"waves": waves, "wave_lens": lens, "targets": targets, "target_lens": tl}, float(seconds.sum())


def _config_name(prefix: str, conv_kernel, fuse_directions: bool,
                 encoder: str = DEFAULT_ENCODER, lstm_head: bool = False) -> str:
    return (prefix + ("" if encoder == DEFAULT_ENCODER else f"_{encoder}")
            + ("_lstm_head" if lstm_head else "")
            + ("_fused_bidir" if fuse_directions else "") + (f"_{conv_kernel}" if conv_kernel else ""))


def phase_training(dev, conv_kernel=None, steps: int = TRAIN_STEPS, fuse_directions: bool = False,
                   encoder: str = DEFAULT_ENCODER, lstm_head: bool = False) -> dict:
    """The recipe's train step at full width, ``steps`` steps on one batch,
    the ``encoder`` model built with ``conv_kernel`` / ``fuse_directions`` /
    ``lstm_head`` (phase ``training``, ``training_<conv_kernel>``,
    ``training_fused_bidir``, ``training_lstm_head[_fused_bidir]``, or with
    ``_<encoder>`` after ``training``)."""
    name = _config_name("training", conv_kernel, fuse_directions, encoder, lstm_head)
    gen = torch.Generator().manual_seed(5)
    model = build_model(len(LABELS) + 1, encoder, mask=True, dtype=torch.bfloat16,
                        conv_kernel=conv_kernel, fuse_directions=fuse_directions,
                        lstm_head=lstm_head)
    reset_parameters(model, gen)
    model.to(dev)
    schedule = cosine_annealing_warmup_restarts(first_cycle_steps=1000, cycle_mult=2, max_lr=1e-2,
                                                min_lr=1e-4, warmup_steps=5, gamma=0.5)
    opt = novograd(schedule, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    step = make_train_step(model, opt, BLANK, MelFrontendConfig(precision="default"), augment=True,
                           freq_mask=27, time_mask=0.07)
    state = create_train_state(model, opt)
    batch_np, audio_s = train_batch(np.random.default_rng(5), TRAIN_BATCH, TRAIN_BUCKET_S,
                                    TRAIN_BUCKET_S)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    rng = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # launches a step: K1, K4-K6 once, K2 and K3 (or K7 and K8 with
    # fuse_directions) once in an encoder with a BiLSTM and once more in the
    # LSTM head; the stride-1 block convs (ROUTED_CONVS) each run K9 and K10
    # (sepconv) or K11 (dw_wgrad) once
    lstm, routed = int(encoder in LSTM_ENCODERS) + int(lstm_head), ROUTED_CONVS[encoder]
    per_step = {mel_from_extended: 1, lstm_recurrence: lstm * (not fuse_directions),
                lstm_backward: lstm * (not fuse_directions),
                lstm_recurrence_stacked: lstm * fuse_directions,
                lstm_backward_stacked: lstm * fuse_directions, ctc_alpha: 1, ctc_beta: 1,
                extend_preemph: 1, sepconv_forward: routed * (conv_kernel == "sepconv"),
                sepconv_backward: routed * (conv_kernel == "sepconv"),
                depthwise_wgrad: routed * (conv_kernel == "dw_wgrad")}
    for fn in per_step:
        fn.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, rng)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in per_step}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"{name}: losses not finite: {losses}")
    check(int(state.nan_count) == 0 and int(state.step) == steps,
          f"{name}: nan_count {int(state.nan_count)}, step {int(state.step)}")
    check(int(state.opt_state.count) == steps, f"{name}: the optimizer skipped a step")
    w = min(5, steps // 2)
    check(np.mean(losses[-w:]) < np.mean(losses[:w]) and losses[-1] < losses[0],
          f"{name}: the training loss did not fall: {losses}")
    want = {fn.__name__: n * steps for fn, n in per_step.items()}
    check(launches == want, f"{name}: kernel launches over {steps} steps: {launches}, want {want}")
    # one batch shape and generator: the first step runs eagerly and records
    # the graph, the others replay it (training/graphs.py)
    routes = dict(step.graphs.counts)
    check(routes == {"capture": 1, "replay": steps - 1}, f"{name}: the step's routes {routes}")

    steady = times[2:]
    median_ms = 1e3 * statistics.median(steady)
    steady_s = sum(steady)
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step(holder["state"], batch, rng)

    device_ms, by_cat, top, passes = device_time(one_step, TRAIN_PROFILE_STEPS)
    res = {"phase": name, "encoder": encoder, "lstm_head": lstm_head, "batch": TRAIN_BATCH,
           "bucket_s": TRAIN_BUCKET_S, "audio_s_per_batch": audio_s,
           "steps": steps, "losses": losses, "launches": launches, "routes": routes,
           "step_ms": {"median": median_ms, "min": 1e3 * min(steady), "max": 1e3 * max(steady),
                       "mean": 1e3 * steady_s / len(steady), "first": 1e3 * times[0],
                       "n": len(steady)},
           "audio_s_trained_per_s": audio_s * len(steady) / steady_s,
           "device_ms_per_step": device_ms, "device_busy_share": device_ms / (1e3 * steady_s / len(steady)),
           "device_ms_by_category": by_cat, "top_kernels_ms": top, "profiler_passes": passes,
           "peak_memory_gb": peak_gb, "nan_count": int(state.nan_count)}
    print(json.dumps(res), flush=True)
    return res


def _capture(inner):
    """The optimizer behind a transform that keeps the raw gradients."""
    def update(grads, state, params):
        updates, new_inner = inner.update(grads, state[1], params)
        return updates, (grads, new_inner)

    return GradientTransformation(lambda p: ({k: torch.zeros_like(v) for k, v in p.items()},
                                             inner.init(p)), update)


def _step_errors(card, cpu, skip=()):
    """(errors of one step against another, the worst gradient's tensor),
    each a ``one_step`` result; the tensors in ``skip`` are left out."""
    rel = lambda a, b: (a - b).norm().item() / max(b.norm().item(), 1e-30)  # noqa: E731
    old, cpu_new, cpu_g, cpu_m = cpu
    _, card_new, card_g, card_m = card
    grads = {k: rel(card_g[k], cpu_g[k]) for k in cpu_g if k not in skip}
    errs = {
        "loss_rel": abs(card_m["loss"].item() - cpu_m["loss"].item()) / abs(cpu_m["loss"].item()),
        "grad_norm_rel": rel(card_m["grad_norm"], cpu_m["grad_norm"]),
        "grad_rel": max(grads.values()),
        "update_rel": max(rel(card_new[k] - old[k], cpu_new[k] - old[k]) for k in old if k not in skip),
    }
    return errs, max(grads, key=grads.get)


def parity_step(init: dict, where, batch: dict, frontend: MelFrontendConfig,
                from_features: bool, **build) -> tuple:
    """One float32 step (no augmentation) of ``build_model(**build)`` from
    the state dict ``init`` on ``where``: (the parameters before and after,
    the captured gradients, the metrics), on the CPU."""
    model = build_model(len(LABELS) + 1, mask=True, **build)
    model.load_state_dict(init)
    model.to(where)
    opt = _capture(novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True))
    step = make_train_step(model, opt, BLANK, frontend, augment=None, from_features=from_features)
    state = create_train_state(model, opt)
    new, metrics = step(state, {k: v.to(where) for k, v in batch.items()})
    return ({k: v.cpu() for k, v in state.params.items()},
            {k: v.cpu() for k, v in new.params.items()},
            {k: v.cpu() for k, v in new.opt_state[0].items()},
            {k: v.cpu() if torch.is_tensor(v) else v for k, v in metrics.items()})


def phase_train_parity(dev, conv_kernel=None, fuse_directions: bool = False,
                       encoder: str = DEFAULT_ENCODER) -> dict:
    """One float32 step from one state and one batch, on the card and on
    the CPU (plain versions of every kernel), the ``encoder`` model built
    with ``conv_kernel`` / ``fuse_directions``.

    The default encoder takes the step from int16 waves under TRAIN_TOL;
    without a route, also the card step with K1 swapped for its plain
    version (on the card), recorded beside the checked one.  The other
    encoders take it from the CPU's log-mels of those waves (K1's summation
    order, C4, held against its plain version in phase K1, stays out), each
    bound the larger of TRAIN_TOL's and CHAOS_GAP_RATIO times the card's own
    move when its features move by 1e-7 relative (``chaos_floor``); the
    waves' step is recorded beside (``card_vs_cpu_from_waves``).  A conv
    bias that a train-mode BatchNorm follows (ZERO_GRAD_BIASES) has a zero
    gradient: it is checked to be below 1e-6 of its weight's on both sides
    and left out of the relative errors."""
    name = _config_name("training_parity", conv_kernel, fuse_directions, encoder)
    gen = torch.Generator().manual_seed(6)
    model0 = build_model(len(LABELS) + 1, encoder, mask=True,
                         conv_kernel=conv_kernel, fuse_directions=fuse_directions)
    reset_parameters(model0, gen)
    init = {k: v.clone() for k, v in model0.state_dict().items()}
    batch_np, _ = train_batch(np.random.default_rng(6), 4, 4.0, 3.9)
    waves = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    frontend = MelFrontendConfig(dither=0.0, precision="default")
    from_features = encoder != DEFAULT_ENCODER
    batch = waves
    if from_features:
        feats, feat_lens = log_mel_spectrogram(waves["waves"], waves["wave_lens"], frontend)
        batch = {**waves, "waves": feats, "wave_lens": feat_lens}

    def one_step(where, batch, from_features=from_features):
        return parity_step(init, where, batch, frontend, from_features, encoder=encoder,
                           conv_kernel=conv_kernel, fuse_directions=fuse_directions)

    skip = ZERO_GRAD_BIASES.get(encoder, ())
    cpu = one_step("cpu", batch)
    card = one_step(dev, batch)
    card_m, cpu_m = card[3], cpu[3]
    errs, worst = _step_errors(card, cpu, skip)
    limits, floor = dict(TRAIN_TOL), None
    if from_features:
        jitter = torch.randn(batch["waves"].shape, generator=torch.Generator().manual_seed(7))
        moved = one_step(dev, {**batch, "waves": batch["waves"] * (1 + 1e-7 * jitter)})
        floor, _ = _step_errors(moved, card, skip)
        limits.update({k: max(TRAIN_TOL[k], CHAOS_GAP_RATIO * floor[k])
                       for k in ("grad_norm_rel", "grad_rel", "update_rel")})
    check(bool(card_m["finite"]) and bool(cpu_m["finite"]), f"{name}: loss not finite")
    check(torch.equal(card_m["pred_lens"], cpu_m["pred_lens"]), f"{name}: pred_lens differ")
    for key, lim in limits.items():
        check(errs[key] <= lim, f"{name}: {key} {errs[key]} > {lim} (worst tensor {worst})")
    zero = {}
    for key in skip:
        weight = key.rsplit(".", 1)[0] + ".weight"
        zero[key] = max(side[2][key].norm().item() / side[2][weight].norm().item() for side in (card, cpu))
        check(zero[key] <= 1e-6, f"{name}: {key}'s gradient is {zero[key]} of its weight's, not zero")
    res = {"phase": name, "encoder": encoder, "batch": 4, "bucket_s": 4.0, "dtype": "float32",
           "from_features": from_features, "loss_card": card_m["loss"].item(),
           "loss_cpu": cpu_m["loss"].item(), **errs, "limits": limits, "worst_grad_tensor": worst,
           "preds_agreement": float((card_m["preds"] == cpu_m["preds"]).float().mean()),
           "chaos_floor": floor, "zero_grad_biases": zero}
    if from_features:
        with_k1, with_k1_worst = _step_errors(one_step(dev, waves, False), one_step("cpu", waves, False), skip)
        res["card_vs_cpu_from_waves"] = {**with_k1, "worst_grad_tensor": with_k1_worst}
    elif conv_kernel is None and not fuse_directions:
        kernel = frontend_kernels.mel_from_extended
        frontend_kernels.mel_from_extended = mel_from_extended_plain
        try:
            plain_errs, plain_worst = _step_errors(one_step(dev, batch), cpu)
        finally:
            frontend_kernels.mel_from_extended = kernel
        res["card_with_plain_k1"] = {**plain_errs, "worst_grad_tensor": plain_worst}
    print(json.dumps(res), flush=True)
    return res


class _KeepLogProbs:
    """A beam decoder that keeps the stitched log-probs it is given."""

    def forward(self, log_probs, lengths):
        self.log_probs = np.asarray(log_probs)[0, :int(lengths[0])]
        return [""]


def _stream_against_long(translator: AsrTranslator) -> dict:
    """C13 on ``translator``: a LONG_S wave through translate_long (its
    windows as rows of one batch) and through StreamingTranscriber fed 1 s
    blocks (one row a window).  PyTorch's depthwise conv gives the SE
    encoder's stride-2 stem other bf16 bits for odd rows of a batch than for
    the same row alone on an H100 (``scripts/torch_row_invariance.py``), so
    the stream's stitched log-probs are bound as the card's are against the
    CPU's (SERVE_TOL_*), its text by SERVE_MAX_CER; whether the texts are
    equal is reported."""
    wave = (np.random.default_rng(6).standard_normal(int(LONG_S * SR)) * 0.1).astype(np.float32)
    blob = wav_bytes(wave, SR)
    wave16 = read_audio(blob)[0][0]
    long_text = translator.translate_long(blob, CHUNK_S, OVERLAP_S)
    long_lp = translator.long_log_probs(wave16, CHUNK_S, OVERLAP_S)

    def stream():
        st = StreamingTranscriber(translator, CHUNK_S, OVERLAP_S)
        for lo in range(0, wave16.shape[0], SR):
            st.feed(wave16[lo: lo + SR])
        return st.finish()

    stream_text = stream()
    keep = translator.beam_decoder = _KeepLogProbs()
    try:
        stream()
    finally:
        translator.beam_decoder = None
    check(keep.log_probs.shape == long_lp.shape,
          f"stream log-probs {keep.log_probs.shape} vs translate_long's {long_lp.shape}")
    err = np.abs(keep.log_probs - long_lp)
    agree = float(np.mean(keep.log_probs.argmax(-1) == long_lp.argmax(-1)))
    cer = _edits(stream_text, long_text) / max(1, len(long_text))
    check(err.max() <= SERVE_TOL_MAX and err.mean() <= SERVE_TOL_MEAN and agree >= SERVE_MIN_ARGMAX
          and cer <= SERVE_MAX_CER,
          f"stream against translate_long: max {err.max()}, mean {err.mean()}, argmax {agree}, CER {cer}")
    return {"seconds": LONG_S, "text_chars": len(long_text),
            "stream_equals_translate_long": stream_text == long_text, "cer": cer,
            "max_abs": float(err.max()), "mean_abs": float(err.mean()), "argmax_agreement": agree}


def _serve_encoder(dev, encoder: str, blobs, seconds) -> tuple:
    """One encoder's seeded bf16 checkpoint served as phase_serving serves
    the default one (and for SEPCONV_SERVED with conv_kernel="sepconv", K9
    ROUTED_CONVS times a batch), the
    served batch in float32 on the card against the CPU, one steady batch
    profiled.  Returns (summary, the bursts' launches)."""
    lstm = {"lstm": (lstm_recurrence, int(encoder in LSTM_ENCODERS))}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = serving_checkpoint(tmp, encoder=encoder)
        ckpt32 = serving_checkpoint(f"{tmp}/fp32", "float32", encoder)
        translator = AsrTranslator(ckpt, device="cuda")
        cpu = AsrTranslator(ckpt, device="cpu")
        card32 = AsrTranslator(ckpt32, device="cuda")
        cpu32 = AsrTranslator(ckpt32, device="cpu")
        routes = []
        if encoder == SEPCONV_SERVED:
            routes.append(("sepconv", AsrTranslator(ckpt, device="cuda", conv_kernel="sepconv"),
                           AsrTranslator(ckpt, device="cpu", conv_kernel="sepconv")))
    check(translator.device.type == "cuda", f"{encoder}: translator is not on the card")
    served = _serve_and_check(dev, f"encoders_serving_{encoder}", translator, cpu, cpu32, blobs,
                              lstm, encoder=encoder, seconds=seconds)
    bursts = [served["launches"]]
    summary = {"card_vs_cpu_bf16": {k: served[k] for k in (
        "card_vs_cpu_max_abs", "card_vs_cpu_mean_abs", "argmax_agreement", "card_vs_cpu_cer",
        "card_bf16_vs_fp32_mean_abs", "cpu_bf16_vs_fp32_mean_abs", "texts_equal_cpu")}}
    for route, card, card_cpu in routes:
        extra = {**lstm, "sepconv_forward": (sepconv_forward, ROUTED_CONVS[encoder])}
        res = _serve_and_check(dev, f"encoders_serving_{encoder}_{route}", card, card_cpu, cpu32,
                               blobs, extra, encoder=encoder)
        bursts.append(res["launches"])
        summary[f"card_vs_cpu_bf16_{route}"] = {k: res[k] for k in (
            "card_vs_cpu_max_abs", "card_vs_cpu_mean_abs", "argmax_agreement", "card_vs_cpu_cer")}

    # the served batch in float32, card against CPU, over valid frames
    batch, lens, lp_cpu32, out_lens_cpu = served["fp32_cpu"]
    lp32, out_lens32 = card32._forward(torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev))
    lp32 = lp32.cpu().numpy()
    check(np.array_equal(out_lens32.cpu().numpy(), out_lens_cpu), f"{encoder}: float32 out_lens differ")
    valid = np.arange(lp32.shape[1])[None, :] < out_lens_cpu[:, None]
    err = np.abs(lp32 - lp_cpu32)[valid]
    agree = float(np.mean(lp32.argmax(-1)[valid] == lp_cpu32.argmax(-1)[valid]))
    check(bool(np.isfinite(lp32).all()) and err.max() <= SERVE32_TOL_MAX
          and err.mean() <= SERVE32_TOL_MEAN and agree >= SERVE32_MIN_ARGMAX,
          f"{encoder}: float32 card vs CPU log-probs: max {err.max()}, mean {err.mean()}, "
          f"argmax agreement {agree}")
    summary["card_vs_cpu_fp32"] = {"max_abs": float(err.max()), "mean_abs": float(err.mean()),
                                   "argmax_agreement": agree,
                                   "limits": [SERVE32_TOL_MAX, SERVE32_TOL_MEAN, SERVE32_MIN_ARGMAX]}
    prof = phase_profile(translator, served["served"], f"encoders_profile_{encoder}")
    median_ms = prof["steady_latency_ms"]["median"]
    summary.update(served_ms_per_batch=median_ms,
                   audio_s_per_s=prof["audio_s_per_batch"] / (median_ms / 1e3),
                   device_ms_per_batch=prof["device_ms_per_batch"],
                   device_busy_share=prof["device_busy_share"])
    if encoder in LSTM_ENCODERS:
        summary["long"] = _stream_against_long(translator)
    return summary, bursts


def phase_encoders(dev):
    """The encoders besides the default one, at full width: each served
    (``_serve_encoder``), then the training configurations of
    ENCODER_CONFIGS, CONV_TRAIN_STEPS bf16 steps each and one float32 step
    card against CPU.  One ``encoders`` line an encoder; returns (the serving
    bursts' launches, the training phases)."""
    seconds, blobs = serving_burst()
    summaries, bursts = {}, []
    for encoder in OTHER_ENCODERS:
        summaries[encoder], launches = _serve_encoder(dev, encoder, blobs, seconds)
        bursts.extend(launches)
    trainings = [phase_training(dev, ck, CONV_TRAIN_STEPS, fused, enc)
                 for enc, ck, fused in ENCODER_CONFIGS]
    parities = [phase_train_parity(dev, ck, fused, enc) for enc, ck, fused in ENCODER_CONFIGS]
    for encoder in OTHER_ENCODERS:
        training = {t["phase"]: {"step_ms_median": t["step_ms"]["median"],
                                 "audio_s_trained_per_s": t["audio_s_trained_per_s"],
                                 "device_ms_per_step": t["device_ms_per_step"],
                                 "device_busy_share": t["device_busy_share"],
                                 "loss_first": t["losses"][0], "loss_last": t["losses"][-1],
                                 "launches": t["launches"]}
                    for t in trainings if t["encoder"] == encoder}
        parity = {r["phase"]: {k: r[k] for k in ("loss_rel", "grad_norm_rel", "grad_rel",
                                                 "update_rel", "worst_grad_tensor", "limits",
                                                 "chaos_floor", "card_vs_cpu_from_waves")}
                  for r in parities if r["encoder"] == encoder}
        print(json.dumps({"phase": "encoders", "encoder": encoder, **summaries[encoder],
                          "training": training, "training_parity": parity}), flush=True)
    return bursts, trainings


def tone_corpus(root: Path, n: int, seed: int, name: str, lo: float = 0.5, hi: float = 3.0) -> Path:
    """``n`` WAVs of a tone language (ten characters, each a sine tone of
    80 ms, a space silence, light noise) of ``lo``-``hi`` seconds, and their
    JSONL manifest."""
    rng = np.random.default_rng(seed)
    chars = "abcdefghij"
    t = np.arange(int(SR * 0.08)) / SR
    tones = {c: 0.3 * np.sin(2 * np.pi * (300.0 + 150.0 * i) * t) for i, c in enumerate(chars)}
    rows = []
    for i in range(n):
        n_chars = int(rng.uniform(lo, hi) / 0.08)
        text = ""
        while len(text) < n_chars:
            word = "".join(rng.choice(list(chars), size=rng.integers(2, 5)))
            text = f"{text} {word}" if text else word
        text = text[:n_chars].strip()
        wave = np.concatenate([tones.get(c, np.zeros_like(t)) for c in text]).astype(np.float32)
        wave += 0.01 * rng.standard_normal(wave.shape).astype(np.float32)
        path = root / f"{name}_{i}.wav"
        write_wav(path, wave, SR)
        rows.append({"audio_filepath": str(path), "duration": len(wave) / SR, "text": text})
    manifest = root / f"{name}.json"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


def _run_train(args):
    """``python -m lightning_asr_torch.train`` in this process (the resolved
    config and the profiler table it prints are kept out of this output)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return train_main(args)


def phase_trainer(dev) -> dict:
    """The trainer entry point on the card: ``lightning_asr_torch.train.main``
    with ``LASR_LSTM_FUSED_BIDIR=1`` (the model through K7 / K8) on a
    tone-language corpus, the full-width default model in bf16, batch 32,
    TRAINER_EPOCHS epochs validated each, then one more epoch resumed from
    ``last`` under torch.profiler; and AsrTranslator on the card transcribing
    an utterance from ``last``."""
    counters = (lstm_recurrence_stacked, lstm_backward_stacked, lstm_recurrence, lstm_backward)
    old_switch = os.environ.get(FUSED_SWITCH)
    os.environ[FUSED_SWITCH] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            train = tone_corpus(root, TRAINER_UTTS, 0, "train")
            dev_m = tone_corpus(root, TRAINER_DEV_UTTS, 1, "dev")
            run = root / "run"
            args = [f"data.train_manifest={train}", f"data.val_manifest={dev_m}",
                    f"data.test_manifest={dev_m}", "data.bucket_seconds=[3.0]",
                    f"train.total_epoch={TRAINER_EPOCHS}", "train.train_batch_size=32",
                    "train.dev_batch_size=32", "train.warmup_steps=4", "train.log_every_n_steps=1",
                    "model.compute_dtype=bf16", f"log.run.dir={run}"]
            runs = []
            for i, extra in enumerate(([], [f"train.total_epoch={TRAINER_EPOCHS + 1}",
                                            f"train.checkpoint={run / 'checkpoints' / 'last'}"])):
                saved_step = None
                if i:
                    saved_step = int(torch.load(run / "checkpoints" / "last" / TRAIN_STATE_FILE,
                                                weights_only=True)["step"])
                    shutil.copytree(run, root / "run_before_resume")
                for fn in counters:
                    fn.launches = 0
                t0 = time.perf_counter()
                if i:
                    holder = {}

                    def resumed():
                        if "out" in holder:     # a pass again: the same files, counts from 0
                            shutil.rmtree(run)
                            shutil.copytree(root / "run_before_resume", run)
                            for fn in counters:
                                fn.launches = 0
                        holder["out"] = _run_train(args + extra)

                    device_ms, by_cat, _, passes = device_time(resumed, 1)
                    out = holder["out"]
                else:
                    out, device_ms, by_cat, passes = _run_train(args + extra), None, None, None
                wall = time.perf_counter() - t0
                tr = out["trainer"]
                runs.append({"trainer": tr, "state": out["state"], "saved_step": saved_step,
                             "wall_s": wall, "device_ms": device_ms, "by_cat": by_cat,
                             "profiler_passes": passes,
                             "launches": {fn.__name__: fn.launches for fn in counters},
                             "eval_batches": tr.profiler.counts["val_step"] + tr.profiler.counts["test_step"],
                             "train_steps": sum(e["batches"] for e in tr.epoch_stats), "test": out["test"]})
            index = json.loads((run / "checkpoints" / "index.json").read_text())
            metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
            translator = AsrTranslator(run / "checkpoints" / "last", device="cuda")
            utt = json.loads(train.read_text().splitlines()[0])
            text = translator.translate(utt["audio_filepath"])
            del translator
    finally:
        if old_switch is None:
            os.environ.pop(FUSED_SWITCH, None)
        else:
            os.environ[FUSED_SWITCH] = old_switch

    first, resumed = runs
    stats = first["trainer"].epoch_stats + resumed["trainer"].epoch_stats
    means = [e["loss_mean"] for e in stats]
    check(all(np.isfinite(e["losses"]).all() for e in stats), f"trainer: losses not finite: {means}")
    check(means[TRAINER_EPOCHS - 1] < means[0], f"trainer: the epoch mean loss did not fall: {means}")
    val_wers = [m["val_wer"] for m in metrics if "val_wer" in m]
    check(len(val_wers) == TRAINER_EPOCHS + 1 and all(np.isfinite(val_wers)), f"trainer: val_wer {val_wers}")
    check(len(index["saved"]) <= 3 and index["last"] == "last", f"trainer: index.json {index}")
    check(resumed["saved_step"] == int(first["state"].step)
          and resumed["trainer"].epoch_stats[0]["first_step"] == resumed["saved_step"] + 1,
          f"trainer: resumed at step {resumed['trainer'].epoch_stats[0]['first_step']}, "
          f"saved {resumed['saved_step']}")
    for r in runs:
        want = {"lstm_recurrence_stacked": r["train_steps"] + r["eval_batches"],
                "lstm_backward_stacked": r["train_steps"], "lstm_recurrence": 0, "lstm_backward": 0}
        check(r["launches"] == want, f"trainer: launches {r['launches']}, want {want}")
    check(isinstance(text, str) and set(text) <= set(LABELS), f"trainer: translator gave {text!r}")
    train_s = sum(e["wall_sec"] for e in stats)
    step_s = first["trainer"].profiler.totals["train_step"] + resumed["trainer"].profiler.totals["train_step"]
    res_epoch = resumed["trainer"].epoch_stats[0]
    res = {"phase": "trainer", "utterances": [TRAINER_UTTS, TRAINER_DEV_UTTS], "bucket_s": 3.0,
           "batch": 32, "dtype": "bfloat16", "fuse_directions": True,
           "epochs": [{k: e[k] for k in ("epoch", "batches", "first_step", "wall_sec", "audio_sec",
                                          "audio_sec_per_sec", "loss_mean")} for e in stats],
           "val_wer": val_wers, "test": resumed["test"],
           "train_step_share_of_epoch_wall": step_s / train_s,
           "run_wall_s": [r["wall_s"] for r in runs],
           "resumed_run": {"device_ms": resumed["device_ms"], "wall_s": resumed["wall_s"],
                           "epoch_wall_s_profiled": res_epoch["wall_sec"],
                           "device_ms_by_category": resumed["by_cat"],
                           "profiler_passes": resumed["profiler_passes"]},
           "launches": [r["launches"] for r in runs], "saved": [e["name"] for e in index["saved"]],
           "translated_chars": len(text)}
    print(json.dumps(res), flush=True)
    return {**res, "k7_launches": sum(r["launches"]["lstm_recurrence_stacked"] for r in runs),
            "k8_launches": sum(r["launches"]["lstm_backward_stacked"] for r in runs)}


# --- the SSL paths (feature step, dual stream, encoder retrain, entry points) ---

# the SSL steps' batch: B rows of 2-16.7 s at the 16.7 s bucket, 835
# wav2vec2 frames (50 a second) of 512 features, 267,200 raw samples (320 a
# frame); steps timed on one batch, and steps profiled
SSL_FRAMES, SSL_FEATURE_DIM, SSL_HOP = 835, 512, 320
SSL_STEPS, SSL_RETRAIN_STEPS, SSL_PROFILE_STEPS = 8, 4, 2
SSL_RETRAIN_BATCH = 32
# the float32 card-vs-CPU steps: rows and bucket seconds
SSL_PARITY_ROWS, SSL_PARITY_S = 4, 4.0
SSL_RETRAIN_PARITY_ROWS, SSL_RETRAIN_PARITY_S = 2, 2.0
# the entry points' corpus: utterances (train, dev, unlabeled pool) of
# 0.5-3.5 s in one 4 s bucket, batch, epochs of train_ssl (a pseudo pass
# after epochs 1 and 2 on a threshold that keeps every non-empty text)
SSL_CLI_UTTS, SSL_CLI_BATCH, SSL_CLI_EPOCHS = (64, 16, 32), 16, 3
# train-mode passes of calibrated_teeth for the retrain forward and the
# served SSL checkpoint
SSL_CALIBRATION_PASSES = 5


def ssl_batch(rng, B: int, bucket_s: float, waves: str = None):
    """B rows of 2-``bucket_s`` s (the first fills the bucket): float32
    wav2vec2 features at 50 frames a second with ~15 labels a second;
    ``waves="raw"`` adds the rows' float32 raw waves (``raw_waves``, as the
    dual batcher gives them), ``waves="int16"`` gives int16 waves in place
    of the features (the retrain mode's wire).  Numpy, and the audio
    seconds."""
    seconds = np.sort(rng.uniform(2.0, bucket_s, B))[::-1].copy()
    seconds[0] = bucket_s
    frames = (seconds * 50).astype(np.int32)
    T = int(round(bucket_s * 50))
    targets, tl = train_targets(rng, seconds)
    batch = {"targets": targets, "target_lens": tl}
    if waves == "int16":
        S = T * SSL_HOP
        lens = np.minimum((seconds * SR).astype(np.int32), S)
        w = np.zeros((B, S), np.int16)
        for b, n in enumerate(lens):
            w[b, :n] = (rng.standard_normal(n) * 3000).astype(np.int16)
        return {**batch, "waves": w, "wave_lens": lens}, float(lens.sum()) / SR
    feats = np.zeros((B, T, SSL_FEATURE_DIM), np.float32)
    for b, n in enumerate(frames):
        feats[b, :n] = rng.standard_normal((n, SSL_FEATURE_DIM))
    batch.update(waves=feats, wave_lens=frames)
    if waves == "raw":
        raw = np.zeros((B, T * SSL_HOP), np.float32)
        for b, n in enumerate(frames):
            raw[b, : n * SSL_HOP] = rng.standard_normal(n * SSL_HOP) * 0.1
        batch.update(raw_waves=raw, raw_wave_lens=frames * SSL_HOP)
    return batch, float(frames.sum()) / 50


SSL_COUNTERS = (mel_from_extended, extend_preemph, lstm_recurrence, lstm_backward, ctc_alpha,
                ctc_beta)


def _ssl_counts() -> dict:
    return {fn.__name__: fn.launches for fn in SSL_COUNTERS}


def _ssl_zero() -> None:
    for fn in SSL_COUNTERS:
        fn.launches = 0


def _ssl_steps(dev, name: str, step, state, batch_np, audio_s: float, steps: int,
               per_step: dict) -> dict:
    """``steps`` steps of ``step`` on one batch on the card: the launches
    of K1-K6 (``per_step`` a step), losses finite, nan_count 0, the steady
    steps' times, audio-seconds a second, device time by kernel group and
    peak memory."""
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    rng = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ssl_zero()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, rng)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = _ssl_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {fn.__name__: per_step.get(fn, 0) * steps for fn in SSL_COUNTERS}
    check(launches == want, f"{name}: kernel launches over {steps} steps: {launches}, want {want}")
    check(all(np.isfinite(losses)), f"{name}: losses not finite: {losses}")
    check(int(state.nan_count) == 0 and int(state.step) == steps,
          f"{name}: nan_count {int(state.nan_count)}, step {int(state.step)}")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step(holder["state"], batch, rng)

    device_ms, by_cat, top, passes = device_time(one_step, SSL_PROFILE_STEPS)
    steady = times[1:]
    mean_s = sum(steady) / len(steady)
    return {"phase": name, "batch": int(batch_np["targets"].shape[0]),
            "shape": list(batch_np["waves"].shape), "audio_s_per_batch": audio_s, "steps": steps,
            "losses": losses, "loss_first": losses[0], "loss_last": losses[-1],
            "launches": launches,
            "step_ms": {"median": 1e3 * statistics.median(steady), "min": 1e3 * min(steady),
                        "max": 1e3 * max(steady), "first": 1e3 * times[0], "n": len(steady)},
            "audio_s_trained_per_s": audio_s / mean_s, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / (1e3 * mean_s), "device_ms_by_category": by_cat,
            "top_kernels_ms": top, "profiler_passes": passes, "peak_memory_gb": peak_gb}


def _ssl_parity(dev, name: str, build, make_step, batch_np, jitter=("waves",)) -> dict:
    """One float32 step of ``build()``'s model (seeded weights) on the card
    and on the CPU from the same batch, each against TRAIN_TOL or
    CHAOS_GAP_RATIO times the card's own move when the ``jitter`` inputs
    move by 1e-7 relative, whichever is larger (the seeded train-mode
    stacks are chaotic: phase_train_parity)."""
    init = {k: v.clone() for k, v in build().state_dict().items()}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    def one_step(where, b):
        model = build()
        model.load_state_dict(init)
        model.to(where)
        opt = _capture(novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True))
        state = create_train_state(model, opt)
        gen = torch.Generator(device=where).manual_seed(0)
        new, metrics = make_step(model, opt)(state, {k: v.to(where) for k, v in b.items()}, gen)
        return ({k: v.cpu() for k, v in state.params.items()},
                {k: v.cpu() for k, v in new.params.items()},
                {k: v.cpu() for k, v in new.opt_state[0].items()},
                {k: v.cpu() if torch.is_tensor(v) else v for k, v in metrics.items()})

    cpu, card = one_step("cpu", batch), one_step(dev, batch)
    gen = torch.Generator().manual_seed(7)
    moved = {k: (v.float() * (1 + 1e-7 * torch.randn(v.shape, generator=gen)) if k in jitter
                 else v) for k, v in batch.items()}
    floor, _ = _step_errors(one_step(dev, moved), card)
    errs, worst = _step_errors(card, cpu)
    limits = {**TRAIN_TOL, **{k: max(TRAIN_TOL[k], CHAOS_GAP_RATIO * floor[k])
                              for k in ("grad_norm_rel", "grad_rel", "update_rel")}}
    card_m, cpu_m = card[3], cpu[3]
    check(bool(card_m["finite"]) and bool(cpu_m["finite"]), f"{name}: loss not finite")
    check(torch.equal(card_m["pred_lens"], cpu_m["pred_lens"]), f"{name}: pred_lens differ")
    for key, lim in limits.items():
        check(errs[key] <= lim, f"{name}: {key} {errs[key]} > {lim} (worst tensor {worst})")
    return {**errs, "limits": limits, "chaos_floor": floor, "worst_grad_tensor": worst,
            "loss_card": card_m["loss"].item(), "loss_cpu": cpu_m["loss"].item(),
            "rows": int(batch_np["targets"].shape[0]), "dtype": "float32"}


@contextlib.contextmanager
def _no_cutout():
    """The dual step's cutout (the one augmentation it draws whatever its
    widths) as the identity, so that the card and the CPU, whose generators
    draw other numbers, take the same step."""
    kept = ssl_steps.cutout
    ssl_steps.cutout = lambda feats, *a, **k: feats
    try:
        yield
    finally:
        ssl_steps.cutout = kept


def _ssl_optimizer():
    schedule = cosine_annealing_warmup_restarts(first_cycle_steps=1000, cycle_mult=1, max_lr=1e-2,
                                                min_lr=1e-4, warmup_steps=5, gamma=0.1)
    return novograd(schedule, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)


def _seeded(model, seed: int):
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model


def phase_ssl_feature(dev) -> dict:
    """The SSL feature step: ``AsrModel(feature_in=512)`` in bf16, cutout, no
    normalization, at B=32 x 835 frames x 512; and one float32 step card
    against CPU."""
    build = lambda dtype=None: _seeded(build_model(  # noqa: E731
        len(LABELS) + 1, mask=True, feature_in=SSL_FEATURE_DIM, dtype=dtype), 11)
    model = build(torch.bfloat16).to(dev)
    opt = _ssl_optimizer()
    step = make_train_step(model, opt, BLANK, augment="cutout", from_features=True, normalize=False)
    batch, audio_s = ssl_batch(np.random.default_rng(11), TRAIN_BATCH, TRAIN_BUCKET_S)
    check(batch["waves"].shape == (TRAIN_BATCH, SSL_FRAMES, SSL_FEATURE_DIM), "feature batch shape")
    res = _ssl_steps(dev, "ssl_feature_step", step, create_train_state(model, opt), batch, audio_s,
                     SSL_STEPS, {lstm_recurrence: 1, lstm_backward: 1, ctc_alpha: 1, ctc_beta: 1})
    res["dtype"] = "bfloat16"
    pbatch, _ = ssl_batch(np.random.default_rng(12), SSL_PARITY_ROWS, SSL_PARITY_S)
    res["card_vs_cpu_fp32"] = _ssl_parity(
        dev, "ssl_feature_step_parity", build,
        lambda m, o: make_train_step(m, o, BLANK, augment=None, from_features=True,
                                     normalize=False), pbatch)
    print(json.dumps(res), flush=True)
    return res


def phase_ssl_dual(dev) -> tuple:
    """The dual step: ``DualStreamAsrModel`` (float32), the mel stream at
    DUAL_MEL_CONFIG from 267,200 raw samples a row (K6, not K1), at B=32;
    K6 on that batch bit for bit against its plain version; one float32
    step card against CPU (cutout off, SpecAugment widths 0, no dither)."""
    build = lambda: _seeded(DualStreamAsrModel(len(LABELS) + 1, mask=True), 12)  # noqa: E731
    model = build().to(dev)
    opt = _ssl_optimizer()
    step = make_dual_train_step(model, opt, BLANK, DUAL_MEL_CONFIG)
    batch, audio_s = ssl_batch(np.random.default_rng(13), TRAIN_BATCH, TRAIN_BUCKET_S, "raw")
    check(batch["raw_waves"].shape == (TRAIN_BATCH, SSL_FRAMES * SSL_HOP), "dual batch shape")
    res = _ssl_steps(dev, "ssl_dual_step", step, create_train_state(model, opt), batch, audio_s,
                     SSL_STEPS, {extend_preemph: 1, lstm_recurrence: 1, lstm_backward: 1,
                                 ctc_alpha: 1, ctc_beta: 1})
    res["dtype"] = "float32"
    # K6 at the dual config on the dual batch, dithered as the step dithers it
    raw = torch.from_numpy(batch["raw_waves"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = raw + DUAL_MEL_CONFIG.dither * torch.randn(raw.shape, generator=gen, device=dev)
    k6 = _k6_at(DUAL_MEL_CONFIG, raw.contiguous(), torch.from_numpy(batch["raw_wave_lens"]).to(dev))
    res["K6_dual_config"] = {**k6, "config": {"pad": DUAL_MEL_CONFIG.pad,
                                              "hop": DUAL_MEL_CONFIG.hop_length,
                                              "win": DUAL_MEL_CONFIG.win_length}}
    pbatch, _ = ssl_batch(np.random.default_rng(14), SSL_PARITY_ROWS, SSL_PARITY_S, "raw")
    quiet = dataclasses.replace(DUAL_MEL_CONFIG, dither=0.0)
    with _no_cutout():
        res["card_vs_cpu_fp32"] = _ssl_parity(
            dev, "ssl_dual_step_parity", build,
            lambda m, o: make_dual_train_step(m, o, BLANK, quiet, freq_mask=0, time_mask=0),
            pbatch, jitter=("waves", "raw_waves"))
    print(json.dumps(res), flush=True)
    return res, k6


def phase_ssl_retrain(dev) -> dict:
    """The retrain step: ``SSLRetrainAsrModel`` ("layer", 7 x 512 feature
    encoder, float32) on int16 waves of 267,200 samples; its eval forward
    on the card against the CPU (the float32 serving bounds) and one
    float32 step card against CPU (cutout off)."""
    build = lambda cut=True: _seeded(SSLRetrainAsrModel(  # noqa: E731
        len(LABELS) + 1, mask=True, feat_extract_norm="layer", conv_bias=True,
        augment_cutout=cut), 13)
    model = build().to(dev)
    opt = _ssl_optimizer()
    step = make_raw_ssl_train_step(model, opt, BLANK)
    batch, audio_s = ssl_batch(np.random.default_rng(15), SSL_RETRAIN_BATCH, TRAIN_BUCKET_S, "int16")
    check(int(ssl_output_lengths(batch["waves"].shape[1])) == 834, "retrain frames")
    res = _ssl_steps(dev, "ssl_retrain_step", step, create_train_state(model, opt), batch, audio_s,
                     SSL_RETRAIN_STEPS, {lstm_recurrence: 1, lstm_backward: 1, ctc_alpha: 1,
                                         ctc_beta: 1})
    res["dtype"] = "float32"
    del model, step, opt
    torch.cuda.empty_cache()
    # the forward, card against CPU, over the valid frames, of the model
    # with calibrated_teeth (its seeded log-probs are nearly uniform)
    fbatch, _ = ssl_batch(np.random.default_rng(16), SSL_PARITY_ROWS, SSL_PARITY_S, "int16")
    ref = build(False)
    calibrated_teeth(ref, torch.Generator().manual_seed(16), lambda g: (
        torch.round(torch.randn((2, SR), generator=g) * 3000), torch.full((2,), SR)),
        SSL_CALIBRATION_PASSES)
    ref.eval()
    with torch.no_grad():
        lp_cpu, lens_cpu = ref(torch.from_numpy(fbatch["waves"]), torch.from_numpy(fbatch["wave_lens"]))
        ref.to(dev)
        lp, lens = ref(torch.from_numpy(fbatch["waves"]).to(dev),
                       torch.from_numpy(fbatch["wave_lens"]).to(dev))
    lp, lp_cpu = lp.cpu().numpy(), lp_cpu.numpy()
    check(np.array_equal(lens.cpu().numpy(), lens_cpu.numpy()), "retrain forward: lengths differ")
    valid = np.arange(lp.shape[1])[None, :] < lens_cpu.numpy()[:, None]
    err = np.abs(lp - lp_cpu)[valid]
    agree = float(np.mean(lp.argmax(-1)[valid] == lp_cpu.argmax(-1)[valid]))
    check(np.isfinite(lp).all() and err.max() <= SERVE32_TOL_MAX and err.mean() <= SERVE32_TOL_MEAN
          and agree >= SERVE32_MIN_ARGMAX,
          f"retrain forward card vs CPU: max {err.max()}, mean {err.mean()}, argmax {agree}")
    res["forward_card_vs_cpu_fp32"] = {"max_abs": float(err.max()), "mean_abs": float(err.mean()),
                                       "argmax_agreement": agree, "class_std": float(lp_cpu.std(-1).mean()),
                                       "limits": [SERVE32_TOL_MAX, SERVE32_TOL_MEAN,
                                                  SERVE32_MIN_ARGMAX]}
    pbatch, _ = ssl_batch(np.random.default_rng(17), SSL_RETRAIN_PARITY_ROWS, SSL_RETRAIN_PARITY_S,
                          "int16")
    pbatch["waves"] = pbatch["waves"].astype(np.float32)      # the model's cast, made here
    res["card_vs_cpu_fp32"] = _ssl_parity(dev, "ssl_retrain_step_parity", lambda: build(False),
                                          lambda m, o: make_raw_ssl_train_step(m, o, BLANK), pbatch)
    print(json.dumps(res), flush=True)
    return res


def ssl_corpus(root: Path) -> dict:
    """The entry points' corpus under ``root``: tone-language WAVs
    (``tone_corpus``) and beside each a feature pickle of int(duration · 50)
    frames of seeded features; manifests ``train``, ``dev``, ``pool``."""
    feats = root / "feats"
    feats.mkdir()
    rng = np.random.default_rng(18)
    out = {}
    for i, (name, n) in enumerate(zip(("train", "dev", "pool"), SSL_CLI_UTTS)):
        out[name] = tone_corpus(root, n, 20 + i, name, lo=0.5, hi=3.5)
        for line in out[name].read_text().splitlines():
            row = json.loads(line)
            f = rng.standard_normal((1, int(row["duration"] * 50), SSL_FEATURE_DIM)).astype(np.float32)
            with open(feats / (Path(row["audio_filepath"]).stem + ".pkl"), "wb") as fh:
                pickle.dump(f, fh)
    return out


def _run_entry(main_fn, args):
    """An SSL entry point's ``main`` on the card in this process (its
    printed config kept out of this output), with its launches of K1-K6."""
    _ssl_zero()
    with contextlib.redirect_stdout(io.StringIO()):
        out = main_fn(args)
    torch.cuda.synchronize()
    return out, _ssl_counts()


def phase_ssl_entry_points(dev) -> dict:
    """``python -m lightning_asr_torch.train_ssl`` (with the pseudo pass),
    ``train_ssl ssl.retrain=true`` and ``python -m
    lightning_asr_torch.train_ssl_double`` through their ``main`` on the
    card on a small corpus; then the SSL checkpoint served: the
    translator's feature forward on the card against the CPU, in bf16 and
    float32, fed precomputed features (its extractor needs transformers)."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        m = ssl_corpus(root)
        common = [f"data.train_manifest={m['train']}", f"data.val_manifest={m['dev']}",
                  f"data.test_manifest={m['dev']}", f"ssl.feature_folder={root / 'feats'}",
                  "data.bucket_seconds=[4.0]", f"train.train_batch_size={SSL_CLI_BATCH}",
                  f"train.dev_batch_size={SSL_CLI_BATCH}", "train.warmup_steps=1",
                  "train.log_every_n_steps=1"]
        runs = {}
        run = root / "ssl"
        # a CTC model trained a few steps decodes every row as blanks, and
        # the pass keeps no empty text: a learning rate of 1e-6 keeps the
        # seeded model's decodes as they start, so that the pass injects
        out, launches = _run_entry(ssl_train_main, common + [
            f"log.run.dir={run}", f"train.total_epoch={SSL_CLI_EPOCHS}",
            "train.learning_rate=1e-6", "train.min_lr=1e-7",
            f"data.pseudo_manifest={m['pool']}", "ssl.pseudo_start_epoch=1",
            "ssl.pseudo_every_n_epochs=1", "ssl.pseudo_confidence_threshold=1e9"])
        tr = out["trainer"]
        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        pseudo = [r for r in rows if "pseudo_total" in r]
        pool = len(tr.dm.unlabeled_entries)
        batches = [e["batches"] for e in tr.epoch_stats]
        check([r["pseudo_total"] for r in pseudo] == [pool] * (SSL_CLI_EPOCHS - 1),
              f"train_ssl: pseudo passes {pseudo}, pool {pool}")
        check(pseudo[0]["pseudo_kept"] > 0 and batches[2] > batches[1],
              f"train_ssl: kept {pseudo[0]['pseudo_kept']}, batches a epoch {batches}")
        runs["train_ssl"] = (out, launches, len(pseudo) * len(tr.dm.pseudo_train_dataloader()), 0)
        for name, main_fn, extra in (("train_ssl_retrain", ssl_train_main, ["ssl.retrain=true"]),
                                     ("train_ssl_double", ssl_double_main, [])):
            out, launches = _run_entry(main_fn, common + extra + [
                f"log.run.dir={root / name}", "train.total_epoch=1"])
            runs[name] = (out, launches, 0, int(name == "train_ssl_double"))
        summary = {}
        for name, (out, launches, pseudo_batches, dual) in runs.items():
            tr = out["trainer"]
            steps = sum(e["batches"] for e in tr.epoch_stats)
            evals = tr.profiler.counts["val_step"] + tr.profiler.counts["test_step"] + pseudo_batches
            want = {"mel_from_extended": 0, "extend_preemph": dual * (steps + evals),
                    "lstm_recurrence": steps + evals, "lstm_backward": steps,
                    "ctc_alpha": steps + evals, "ctc_beta": steps}
            check(launches == want, f"{name}: launches {launches}, want {want}")
            losses = [e["loss_mean"] for e in tr.epoch_stats]
            check(all(np.isfinite(losses)) and np.isfinite(out["test"]["test_loss"]),
                  f"{name}: losses {losses}, test {out['test']}")
            summary[name] = {"epochs": len(losses), "train_steps": steps, "eval_batches": evals,
                             "loss_means": losses, "test_loss": out["test"]["test_loss"],
                             "epoch_wall_s": [e["wall_sec"] for e in tr.epoch_stats],
                             "launches": launches}
        summary["train_ssl"].update(pseudo=pseudo, pool=pool, batches_per_epoch=batches)
        served, served_launches = _serve_ssl(dev, run / "checkpoints" / "last", root)
    total = {k: sum(r[1][k] for r in runs.values()) + served_launches.get(k, 0)
             for k in _ssl_counts()}
    res = {"phase": "ssl_entry_points", "corpus_utts": list(SSL_CLI_UTTS), "bucket_s": 4.0,
           "batch": SSL_CLI_BATCH, **summary, "served": served, "launches": total}
    print(json.dumps(res), flush=True)
    return res


def _serve_ssl(dev, ckpt: Path, root: Path):
    """The ``feature_in`` checkpoint, its weights given calibrated_teeth
    (saved again, in its bf16 and with compute_dtype float32), through the
    translator on the card and on the CPU, on 8 rows of precomputed
    features of 2-16 s: log-probs over valid frames within the serving
    bounds, and K2 once a card forward."""
    state_dict, meta = load_checkpoint(ckpt)
    model = build_model(len(meta["hparams"]["labels"]) + 1, mask=True, feature_in=SSL_FEATURE_DIM)
    model.load_state_dict(state_dict)
    calibrated_teeth(model, torch.Generator().manual_seed(19), lambda g: (
        torch.randn((2, 200, SSL_FEATURE_DIM), generator=g), torch.ones(2)), SSL_CALIBRATION_PASSES)
    ckpt = save_checkpoint(root / "served", model.state_dict(), meta["hparams"])
    ckpt32 = save_checkpoint(root / "served32", model.state_dict(),
                             {**meta["hparams"], "compute_dtype": "float32"})
    rng = np.random.default_rng(19)
    seconds = [2.0, 3.5, 5.0, 7.0, 9.0, 11.0, 13.5, 16.0]
    frames = np.asarray([int(s * 50) for s in seconds], np.int32)
    feats = np.zeros((8, int(frames.max()), SSL_FEATURE_DIM), np.float32)
    for b, n in enumerate(frames):
        feats[b, :n] = rng.standard_normal((n, SSL_FEATURE_DIM))
    out, launches = {}, {}
    for tag, path, tols in (("bf16", ckpt, (SERVE_TOL_MAX, SERVE_TOL_MEAN, SERVE_MIN_ARGMAX)),
                            ("fp32", ckpt32, (SERVE32_TOL_MAX, SERVE32_TOL_MEAN, SERVE32_MIN_ARGMAX))):
        card, cpu = AsrTranslator(path, device="cuda"), AsrTranslator(path, device="cpu")
        check(card.ssl_extractor is not None and card.model.feature_mapping is not None,
              f"served SSL {tag}: not a feature checkpoint")
        lp_cpu, lens_cpu = cpu._forward_feats(torch.from_numpy(feats), torch.from_numpy(frames))
        _ssl_zero()
        t0 = time.perf_counter()
        lp, lens = card._forward_feats(torch.from_numpy(feats).to(dev), torch.from_numpy(frames).to(dev))
        lp = lp.cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: launches.get(k, 0) + v for k, v in _ssl_counts().items()}
        check(_ssl_counts()["lstm_recurrence"] == 1, f"served SSL {tag}: launches {_ssl_counts()}")
        lp_cpu = lp_cpu.numpy()
        check(np.array_equal(lens.cpu().numpy(), lens_cpu.numpy()), f"served SSL {tag}: lengths")
        valid = np.arange(lp.shape[1])[None, :] < lens_cpu.numpy()[:, None]
        err = np.abs(lp - lp_cpu)[valid]
        agree = float(np.mean(lp.argmax(-1)[valid] == lp_cpu.argmax(-1)[valid]))
        check(np.isfinite(lp).all() and err.max() <= tols[0] and err.mean() <= tols[1]
              and agree >= tols[2], f"served SSL {tag}: max {err.max()}, mean {err.mean()}, "
                                    f"argmax {agree}")
        out[tag] = {"max_abs": float(err.max()), "mean_abs": float(err.mean()),
                    "argmax_agreement": agree, "limits": list(tols), "first_forward_ms": ms,
                    "class_std": float(lp_cpu.std(-1).mean())}
    return {"rows": 8, "frames": frames.tolist(), **out}, launches


def phase_ssl(dev, card: str) -> dict:
    """The SSL paths: the feature, dual and retrain steps, then the entry
    points and the served checkpoint, then the same over data-parallel
    ranks; returns their launches of K1-K6."""
    results = [phase_ssl_feature(dev)]
    dual, k6_dual = phase_ssl_dual(dev)
    results += [dual, phase_ssl_retrain(dev)]
    entry = phase_ssl_entry_points(dev)
    ranks = phase_ssl_data_parallel(dev, card)
    launches = {k: sum(r["launches"][k] for r in results) + entry["launches"][k] + ranks[k]
                for k in _ssl_counts()}
    print(json.dumps({"phase": "ssl", "launches": launches, "K6_dual_config_max_abs_err":
                      k6_dual["max_abs_err"]}), flush=True)
    return launches


# --- data parallelism: ranks in worker processes of this script ---

# ranks that share the one card over gloo, the recipe's bf16 steps they
# take, and the steps of the NCCL run at a world of 1
DP_WORLD, DP_STEPS, DP_NCCL_STEPS = 2, 4, 2
# 2 ranks against one process, the same global batch and draws: the bf16
# losses differ by the order of the BatchNorm, loss and gradient sums and
# by cuDNN's algorithms at 16 rows against 32, carried through 4 steps of
# this seeded network (the bound of BF16_TOL's loss in the CPU tests)
DP_BF16_LOSS_RTOL = 2e-2
# the float32 step and the accumulated step, 2 ranks against one: reduction
# order only, under TRAIN_TOL (the card-vs-CPU bound of the same network)
DP_TOL = TRAIN_TOL
# a worker's wall limit, the group's collective timeout, and the flat
# gradient all-reduces timed under gloo
DP_TIMEOUT_S, DP_ALLREDUCE_ITERS = 300, 10
DP_COUNTERS = (mel_from_extended, lstm_recurrence, lstm_backward, ctc_alpha, ctc_beta,
               extend_preemph)


def _dp_recipe(dev, recipe: bool = True, accum: int = 1, data_parallel: bool = False):
    """(step, state) of phase ``training``'s seeded full-width model and
    optimizer: bf16 with the recipe's dither and SpecAugment, or float32
    without either behind ``_capture``."""
    model = build_model(len(LABELS) + 1, DEFAULT_ENCODER, mask=True,
                        dtype=torch.bfloat16 if recipe else None)
    reset_parameters(model, torch.Generator().manual_seed(5))
    model.to(dev)
    schedule = cosine_annealing_warmup_restarts(first_cycle_steps=1000, cycle_mult=2, max_lr=1e-2,
                                                min_lr=1e-4, warmup_steps=5, gamma=0.5)
    opt = novograd(schedule, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    if not recipe:
        opt = _capture(opt)
    frontend = MelFrontendConfig(precision="default") if recipe else \
        MelFrontendConfig(dither=0.0, precision="default")
    step = make_train_step(model, opt, BLANK, frontend, augment=recipe, freq_mask=27,
                           time_mask=0.07, accum_steps=accum, data_parallel=data_parallel)
    if data_parallel:
        distributed.broadcast_(dict(model.named_parameters()))
    return step, create_train_state(model, opt)


def _dp_batch(dev, rank: int = 0, world: int = 1, accum: int = 1) -> dict:
    """This rank's rows of phase ``training``'s batch (32 int16 waves of
    2-16.7 s) on ``dev``."""
    batch_np, _ = train_batch(np.random.default_rng(5), TRAIN_BATCH, TRAIN_BUCKET_S, TRAIN_BUCKET_S)
    rows = local_rows(TRAIN_BATCH, rank, world, accum)
    return {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch_np.items()}


def _dp_steps(dev, step, state, batch, steps: int):
    """``steps`` steps on one batch from one generator, as phase
    ``training``: (losses, step ms on the host clock, state)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        losses.append(metrics["loss"].item())
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, ms, state


def _dp_float32(dev, rank: int = 0, world: int = 1, accum: int = 1) -> tuple:
    """One float32 step without dither or augmentation: (old params, new
    params, gradients, metrics) on the CPU, ``_step_errors``' operands."""
    step, state = _dp_recipe(dev, recipe=False, accum=accum, data_parallel=world > 1)
    new, metrics = step(state, _dp_batch(dev, rank, world, accum))
    cpu = lambda tree: {k: v.cpu() for k, v in tree.items()}  # noqa: E731
    return (cpu(state.params), cpu(new.params), cpu(new.opt_state[0]),
            {k: metrics[k].cpu() for k in ("loss", "grad_norm", "finite")})


def _dp_digest(state) -> str:
    return digest(*state.params.values(), *state.batch_stats.values())


def _dp_counts() -> dict:
    return {fn.__name__: fn.launches for fn in DP_COUNTERS}


def _dp_zero() -> None:
    for fn in DP_COUNTERS:
        fn.launches = 0


# --- tensor parallelism: model groups of ranks sharing the card ---

# the model group of the tp runs; the recipe's bf16 steps of the dp1 x tp2
# run; the dp2 x tp2 run's rows, bucket and steps
TP_SIZE, TP_STEPS = 2, 4
TP_DP2_ROWS, TP_DP2_SECONDS, TP_DP2_STEPS = 8, 4.0, 2
# the recipe's parameters after TP_STEPS bf16 steps, model group against one
# process on the same batch and draws: the relative difference of the whole
# update.  The sums run in another order through bf16 (the model group
# adds two bf16 partial input gradients where one process rounds once) and
# 16 train-mode BatchNorms, carried through the steps: on an H100 the gap
# read 0.29 where the one process's own move under a one-LSB change of one
# sample (TP_BUMP, printed beside) read 0.12, and on the CPU at 4 rows 0.48
# against 0.54.  So this is a gross-error gate (a gradient lost or counted
# twice moves the whole update by order 1); the float32 steps below hold
# each tensor's update to DP_TOL
TP_BF16_UPDATE_REL, TP_BUMP = 0.5, (0, 1000)
# K9/K10 at (gathered Cin, this rank's Cout, k) and K11 at (this rank's C, k)
# in the tp2 step of the default model: the 256-, 336- and 512-channel
# blocks, and the stem's 64 channels split
TP_SEPCONV_SHAPES = ((256, 128, 33), (336, 256, 51), (512, 256, 87))
TP_K11_SHAPES = ((32, 33), (128, 33), (168, 51), (256, 87))
TP_COUNTERS = DP_COUNTERS + (sepconv_forward, sepconv_backward, depthwise_wgrad)


def _tp_counts() -> dict:
    return {fn.__name__: fn.launches for fn in TP_COUNTERS}


def _tp_zero() -> None:
    for fn in TP_COUNTERS:
        fn.launches = 0


def _tp_recipe(dev, recipe: bool = True, conv_kernel=None, split: bool = False):
    """(step, state, shard) of ``_dp_recipe``'s seeded full-width model with
    the per-tensor NovoGrad (the tp variant), ``conv_kernel`` routing its
    separable convs; with ``split`` the step and state of this rank of the
    process group's layout (this rank's blocks)."""
    model = build_model(len(LABELS) + 1, DEFAULT_ENCODER, mask=True,
                        dtype=torch.bfloat16 if recipe else None, conv_kernel=conv_kernel)
    reset_parameters(model, torch.Generator().manual_seed(5))
    model.to(dev)
    schedule = cosine_annealing_warmup_restarts(first_cycle_steps=1000, cycle_mult=2, max_lr=1e-2,
                                                min_lr=1e-4, warmup_steps=5, gamma=0.5)
    opt = novograd(schedule, betas=(0.8, 0.5), weight_decay=1e-3, fused=False)
    if not recipe:
        opt = _capture(opt)
    frontend = MelFrontendConfig(precision="default") if recipe else \
        MelFrontendConfig(dither=0.0, precision="default")
    step = make_train_step(model, opt, BLANK, frontend, augment=recipe, freq_mask=27,
                           time_mask=0.07, data_parallel=split)
    shard = tp.model_shard(model) if split else None
    return step, tp.shard_state(create_train_state(model, opt), shard), shard


def _tp_float32(dev, conv_kernel=None, split: bool = False) -> tuple:
    """One float32 step of ``_tp_recipe`` (no dither, augmentation or
    dropout) on phase ``training``'s batch (this data index's rows): (old
    params, new params, gradients, metrics), whole, on the CPU."""
    step, state, shard = _tp_recipe(dev, recipe=False, conv_kernel=conv_kernel, split=split)
    batch = _dp_batch(dev, distributed.data_index(), distributed.data_size()) if split \
        else _dp_batch(dev)
    new, metrics = step(state, batch)
    old, new = tp.gather_state((state.params, new), shard)
    cpu = lambda tree: {k: v.cpu() for k, v in tree.items()}  # noqa: E731
    return (cpu(old), cpu(new.params), cpu(new.opt_state[0]),
            {k: metrics[k].cpu() for k in ("loss", "grad_norm", "finite")})


def _update_rel(old: dict, got: dict, want: dict):
    """(the relative difference of the whole update, the tensor whose own
    update differs most, that difference)."""
    diff = {k: (got[k] - want[k]).norm().item() ** 2 for k in old}
    size = {k: (want[k] - old[k]).norm().item() ** 2 for k in old}
    rel = {k: (diff[k] / max(size[k], 1e-60)) ** 0.5 for k in old}
    worst = max(rel, key=rel.get)
    return (sum(diff.values()) / sum(size.values())) ** 0.5, worst, rel[worst]


def _tp_worker(task: str, spec: dict, env: dict) -> dict:
    """A rank of phase ``tensor_parallel``: ``tp_steps`` (dp1 x tp2) or
    ``tp_dp2`` (dp2 x tp2).  Rank 0 also runs the one-process steps it is
    held against, after this rank's counts are read (its model-group
    partner waits at its next collective)."""
    out = {}
    rank = distributed.init(env, "cuda", DP_TIMEOUT_S, tp=TP_SIZE)
    dev = rank.device
    cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
    if task == "tp_steps":
        step, state, shard = _tp_recipe(dev, split=True)
        batch = _dp_batch(dev, distributed.data_index(), distributed.data_size())
        init = tp.gather_state(state.params, shard)
        _tp_zero()
        losses, ms, state = _dp_steps(dev, step, state, batch, TP_STEPS)
        out.update(backend=rank.backend, device=str(dev), losses=losses, step_ms=ms,
                   launches=_tp_counts(),
                   local_shapes={k: list(state.params[k].shape)
                                 for k in sorted(shard.specs) if k.endswith("conv.weight")})
        # one more step with the gathers timed (each behind a synchronise)
        tp.reset_stats()
        tp.TIMING = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        tp.TIMING = False
        out.update(timed_step_ms=1e3 * (time.perf_counter() - t0), gathers=dict(tp.STATS))
        whole = tp.gather_state(state.params, shard)
        out["digest"] = digest(*whole.values())
        _tp_zero()
        out["float32"] = _tp_float32(dev, split=True)
        out["dw_wgrad"] = _tp_float32(dev, "dw_wgrad", split=True)
        out["sepconv"] = _tp_float32(dev, "sepconv", split=True)
        out["parity_launches"] = _tp_counts()
        if rank.rank == 0:                      # the one process they are held against
            with tp.model_parallel(None):
                one_step, one_state, _ = _tp_recipe(dev)
                one_losses, one_ms, one_state = _dp_steps(dev, one_step, one_state, _dp_batch(dev),
                                                          TP_STEPS)
                out.update(one_losses=one_losses, one_step_ms=one_ms)
                out["update_rel"] = _update_rel(cpu(init), cpu(whole), cpu(one_state.params))
                bumped = _dp_batch(dev)
                bumped["waves"][TP_BUMP] += 1
                bump_step, bump_state, _ = _tp_recipe(dev)
                _, _, bump_state = _dp_steps(dev, bump_step, bump_state, bumped, TP_STEPS)
                out["chaos_floor"] = _update_rel(cpu(init), cpu(bump_state.params),
                                                 cpu(one_state.params))
                parity = {}
                for name, kernel in (("float32", None), ("dw_wgrad", "dw_wgrad"),
                                     ("sepconv", "sepconv")):
                    one = _tp_float32(dev, kernel)
                    errs, worst = _step_errors(out[name], one)
                    rel = lambda a, b: (a - b).norm().item() / max(b.norm().item(), 1e-30)  # noqa: E731
                    parity[name] = {**errs, "worst_grad_tensor": worst,
                                    "context_rnn_grad_rel": {k: rel(out[name][2][k], one[2][k])
                                                             for k in one[2] if "context_rnn" in k}}
                out["parity"] = parity
        for name in ("float32", "dw_wgrad", "sepconv"):
            out[name] = digest(*out[name][1].values())     # the ranks' updates, compared
    elif task == "tp_dp2":
        batch_np, _ = train_batch(np.random.default_rng(9), TP_DP2_ROWS, TP_DP2_SECONDS,
                                  TP_DP2_SECONDS)
        rows = local_rows(TP_DP2_ROWS, distributed.data_index(), distributed.data_size())
        step, state, _ = _tp_recipe(dev, split=True)
        _tp_zero()
        losses, ms, _ = _dp_steps(dev, step, state,
                                  {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch_np.items()},
                                  TP_DP2_STEPS)
        out.update(backend=rank.backend, losses=losses, step_ms=ms, launches=_tp_counts(),
                   data_index=distributed.data_index(), model_index=distributed.model_index())
        if rank.rank == 0:
            with tp.model_parallel(None):
                one_step, one_state, _ = _tp_recipe(dev)
                out["one_losses"], _, _ = _dp_steps(
                    dev, one_step, one_state,
                    {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}, TP_DP2_STEPS)
    distributed.shutdown()
    return out


def dp_worker(task: str, spec_path: str) -> int:
    """One rank of phase ``data_parallel`` (``chip_smoke.py --dp-worker TASK
    SPEC``, the launcher's variables in the environment): writes its results
    beside SPEC."""
    spec = json.loads(Path(spec_path).read_text())
    env = distributed.launcher_env()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if task == "steps":           # the recipe's steps, the float32 and accumulated steps
        rank = distributed.init(env, "cuda", DP_TIMEOUT_S)
        dev = rank.device
        step, state = _dp_recipe(dev, data_parallel=True)
        _dp_zero()
        losses, ms, state = _dp_steps(dev, step, state, _dp_batch(dev, rank.rank, rank.world),
                                      DP_STEPS)
        out.update(backend=rank.backend, device=str(dev), losses=losses, step_ms=ms,
                   launches=_dp_counts(), digest=_dp_digest(state))
        flat = torch.zeros(sum(v.numel() for v in state.params.values()) + 1, device=dev)
        distributed.all_reduce_(flat)
        distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_ALLREDUCE_ITERS):
            distributed.all_reduce_(flat)
        torch.cuda.synchronize()
        out.update(allreduce_ms=1e3 * (time.perf_counter() - t0) / DP_ALLREDUCE_ITERS,
                   allreduce_floats=flat.numel())
        _dp_zero()
        out["float32"] = _dp_float32(dev, rank.rank, rank.world)
        out["accum2"] = _dp_float32(dev, rank.rank, rank.world, accum=2)
        out["parity_launches"] = _dp_counts()
        distributed.shutdown()
    elif task == "nccl1":         # a world of 1 over NCCL against no group, bit for bit
        torch.backends.cudnn.deterministic = True
        dev = torch.device("cuda", 0)
        step, state = _dp_recipe(dev)
        plain, _, plain_state = _dp_steps(dev, step, state, _dp_batch(dev), DP_NCCL_STEPS)
        rank = distributed.init(env, "cuda", DP_TIMEOUT_S)
        step, state = _dp_recipe(rank.device, data_parallel=True)
        _dp_zero()
        losses, ms, state = _dp_steps(rank.device, step, state, _dp_batch(rank.device),
                                      DP_NCCL_STEPS)
        out.update(backend=rank.backend, losses=losses, plain_losses=plain, step_ms=ms,
                   launches=_dp_counts(), digest=_dp_digest(state),
                   plain_digest=_dp_digest(plain_state))
        distributed.shutdown()
    elif task in ("tp_steps", "tp_dp2"):
        out = _tp_worker(task, spec, env)
    elif task in ("ssl_steps", "ssl_cli"):
        out = _ssl_dp_worker(task, spec, env)
    elif task == "cli":           # python -m lightning_asr_torch.train under a launcher
        from lightning_asr_torch.training import checkpoint
        from lightning_asr_torch.training.trainer import Trainer

        writes, vals = [], []
        save, validate = checkpoint.save_checkpoint, Trainer.validate
        checkpoint.save_checkpoint = lambda *a, **k: (writes.append(str(a[0])), save(*a, **k))[1]
        Trainer.validate = lambda self, state: (vals.append(validate(self, state)), vals[-1])[1]
        _tp_zero()
        result = _run_train(spec["args"])
        tr = result["trainer"]
        out.update(launches=_tp_counts(), writes=writes, val=vals, test=result["test"],
                   data_parallel=tr.data_parallel, split=tr.model_shard is not None,
                   optimizer=type(result["state"].opt_state).__name__,
                   losses=[loss for e in tr.epoch_stats for loss in e["losses"]],
                   epochs=[{k: e[k] for k in ("wall_sec", "audio_sec", "audio_sec_per_sec")}
                           for e in tr.epoch_stats],
                   train_steps=sum(e["batches"] for e in tr.epoch_stats),
                   eval_batches=tr.profiler.counts["val_step"] + tr.profiler.counts["test_step"],
                   digest=digest(*result["state"].params.values()))
    else:
        raise ValueError(f"unknown data-parallel task {task!r}")
    torch.save(out, Path(spec_path).with_name(f"{task}_{env['RANK']}.pt"))
    return 0


def _dp_launch(task: str, world: int, tmp: Path, **spec) -> list:
    """Run ``world`` ranks of ``dp_worker(task)``, started as a launcher
    starts them (a free local port); returns each rank's results."""
    spec_path = tmp / f"{task}.json"
    spec_path.write_text(json.dumps(spec))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
               "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-worker",
                                       task, str(spec_path)], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"{task} rank {r} exited {p.returncode}:\n{log[-3000:]}")
    return [torch.load(tmp / f"{task}_{r}.pt", weights_only=False) for r in range(world)]


def phase_data_parallel(dev, card: str) -> dict:
    """Data parallelism on the one card: 2 ranks over gloo take the
    recipe's steps on phase ``training``'s batch (16 rows each) against one
    process on the whole batch, then one float32 step and one step at
    ``accumulate_grad_batches=2``; 2 steps at a world of 1 over NCCL against
    no group, bit for bit; the training CLI as 2 ranks over gloo on the
    trainer phase's corpus for one epoch and a validation, and
    AsrTranslator on the card loading its ``last``.  Returns the ranks'
    launches of K1-K6."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ranks = _dp_launch("steps", DP_WORLD, tmp)
        step, state = _dp_recipe(dev)
        one_losses, one_ms, _ = _dp_steps(dev, step, state, _dp_batch(dev), DP_STEPS)
        one_f32, one_acc = _dp_float32(dev), _dp_float32(dev, accum=2)
        nccl, = _dp_launch("nccl1", 1, tmp)
        train = tone_corpus(tmp, TRAINER_UTTS, 0, "train")
        dev_m = tone_corpus(tmp, TRAINER_DEV_UTTS, 1, "dev")
        run = tmp / "run"
        cli = _dp_launch("cli", DP_WORLD, tmp, args=[
            f"data.train_manifest={train}", f"data.val_manifest={dev_m}",
            f"data.test_manifest={dev_m}", "data.bucket_seconds=[3.0]", "train.total_epoch=1",
            "train.train_batch_size=32", "train.dev_batch_size=32", "train.warmup_steps=1",
            "train.log_every_n_steps=1", "model.compute_dtype=bf16", f"log.run.dir={run}",
            f"train.dist_timeout_s={DP_TIMEOUT_S}"])
        index = json.loads((run / "checkpoints" / "index.json").read_text())
        translator = AsrTranslator(run / "checkpoints" / "last", device="cuda")
        text = translator.translate(json.loads(train.read_text().splitlines()[0])["audio_filepath"])
        loaded = digest(*(translator.model.state_dict()[k] for k in translator.model.state_dict()
                          if not k.endswith(("running_mean", "running_var"))))
        del translator

    r0, r1 = ranks
    check(r0["backend"] == r1["backend"] == "gloo", f"data_parallel: backends {r0['backend']}, {r1['backend']}")
    check(r0["losses"] == r1["losses"] and r0["digest"] == r1["digest"],
          f"data_parallel: the ranks differ: losses {r0['losses']} / {r1['losses']}")
    check(all(np.isfinite(r0["losses"])), f"data_parallel: losses {r0['losses']}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], one_losses))
    check(loss_rel <= DP_BF16_LOSS_RTOL,
          f"data_parallel: 2 ranks against one: losses {r0['losses']} / {one_losses}")
    per_step = {fn.__name__: DP_STEPS for fn in DP_COUNTERS}
    check(r0["launches"] == r1["launches"] == per_step,
          f"data_parallel: launches {r0['launches']} / {r1['launches']}, want {per_step}")
    parity = {}
    for name, one in (("float32", one_f32), ("accum2", one_acc)):
        check(r0[name][1].keys() == one[1].keys()
              and all(torch.equal(r0[name][1][k], r1[name][1][k]) for k in one[1]),
              f"data_parallel: {name}: the ranks' updates differ")
        errs, worst = _step_errors(r0[name], one)
        for key, lim in DP_TOL.items():
            check(errs[key] <= lim, f"data_parallel: {name}: {key} {errs[key]} > {lim} ({worst})")
        parity[name] = {**errs, "worst_grad_tensor": worst}
    check(nccl["backend"] == "nccl" and nccl["losses"] == nccl["plain_losses"]
          and nccl["digest"] == nccl["plain_digest"],
          f"data_parallel: NCCL at a world of 1 against no group: {nccl['losses']} / "
          f"{nccl['plain_losses']}")
    c0, c1 = cli
    check(c0["val"] == c1["val"] and len(c0["val"]) == 1 and np.isfinite(c0["val"][0]["val_loss"]),
          f"data_parallel: CLI val metrics {c0['val']} / {c1['val']}")
    check(c0["test"] == c1["test"] and c0["losses"] == c1["losses"] and c0["digest"] == c1["digest"],
          "data_parallel: the CLI's ranks differ")
    check([len(c["writes"]) for c in cli] == [1, 0] and index["last"] == "last",
          f"data_parallel: checkpoints written {[c['writes'] for c in cli]}")
    check(loaded == c0["digest"], "data_parallel: the translator's weights are not rank 0's last")
    check(isinstance(text, str) and set(text) <= set(LABELS), f"data_parallel: translator gave {text!r}")
    for c in cli:
        t, e = c["train_steps"], c["eval_batches"]
        want = {"mel_from_extended": t + e, "lstm_recurrence": t + e, "lstm_backward": t,
                "ctc_alpha": t + e, "ctc_beta": t, "extend_preemph": t + e,
                "sepconv_forward": 0, "sepconv_backward": 0, "depthwise_wgrad": 0}
        check(c["launches"] == want, f"data_parallel: CLI launches {c['launches']}, want {want}")
    median = lambda ms: statistics.median(ms[1:])  # noqa: E731
    res = {"phase": "data_parallel", "card": card, "world": DP_WORLD, "backend": r0["backend"],
           "rows_per_rank": TRAIN_BATCH // DP_WORLD, "steps": DP_STEPS,
           "losses": r0["losses"], "one_process_losses": one_losses,
           "loss_rel_vs_one_process": loss_rel, "loss_rtol": DP_BF16_LOSS_RTOL,
           "launches_per_rank": r0["launches"], "parity": parity, "limits": DP_TOL,
           "nccl_world1": {"backend": nccl["backend"], "steps": DP_NCCL_STEPS,
                           "bit_equal": True, "cudnn_deterministic": True,
                           "step_ms": nccl["step_ms"]},
           "cli": {"ranks": DP_WORLD, "val": c0["val"][0], "test": c0["test"],
                   "epochs": c0["epochs"], "train_steps": c0["train_steps"],
                   "eval_batches": c0["eval_batches"], "checkpoint_writes": [len(c["writes"]) for c in cli],
                   "top_k": [e["name"] for e in index["saved"]], "translated_chars": len(text)},
           "times": {"step_ms_one_process": median(one_ms),
                     "step_ms_two_ranks_sharing_the_card": [median(r["step_ms"]) for r in ranks],
                     "gloo_flat_gradient_allreduce_ms": [r["allreduce_ms"] for r in ranks],
                     "allreduce_floats": r0["allreduce_floats"]}}
    print(json.dumps(res), flush=True)
    launches = {}
    for out in (*ranks, nccl, *cli):
        for name, n in out["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches


# --- SSL over data-parallel ranks (phase ssl): ranks sharing the card ---

# the feature model's bf16 steps on the SSL batch, 16 rows a rank; the
# entry points' epochs over the ranks (train_ssl: a pseudo pass after each)
SSL_DP_STEPS, SSL_DP_CLI_EPOCHS = 4, 2
# the SSL models of phase ssl (their seeds) and their batches (the
# generators' seeds, rows, waves): the feature and dual batches of 32 rows
# of 2-16.7 s, the retrain mode's int16 waves
SSL_DP_MODES = {"feature": (11, 11, TRAIN_BATCH, None), "dual": (12, 13, TRAIN_BATCH, "raw"),
                "retrain": (13, 15, SSL_RETRAIN_BATCH, "int16")}


def _ssl_dp_step(dev, mode: str, recipe: bool, data_parallel: bool = False):
    """(step, state) of phase ssl's seeded ``mode`` model and its trainer's
    step with its augmentation (cutout; the dual step's dither, SpecAugment
    and cutout; the retrain model's cutout): ``recipe`` the feature model
    in bf16 with the SSL schedule, else float32 behind ``_capture``."""
    seed = SSL_DP_MODES[mode][0]
    if mode == "feature":
        model = build_model(len(LABELS) + 1, mask=True, feature_in=SSL_FEATURE_DIM,
                            dtype=torch.bfloat16 if recipe else None)
    elif mode == "dual":
        model = DualStreamAsrModel(len(LABELS) + 1, mask=True)
    else:
        model = SSLRetrainAsrModel(len(LABELS) + 1, mask=True, feat_extract_norm="layer",
                                   conv_bias=True)
    _seeded(model, seed).to(dev)
    opt = _ssl_optimizer() if recipe else _capture(novograd(1e-2, betas=(0.8, 0.5),
                                                            weight_decay=1e-3, fused=True))
    if mode == "feature":
        step = make_train_step(model, opt, BLANK, augment="cutout", from_features=True,
                               normalize=False, data_parallel=data_parallel)
    elif mode == "dual":
        step = make_dual_train_step(model, opt, BLANK, DUAL_MEL_CONFIG, data_parallel=data_parallel)
    else:
        step = make_raw_ssl_train_step(model, opt, BLANK, data_parallel=data_parallel)
    return step, create_train_state(model, opt)


def _ssl_dp_batch(dev, mode: str, rank: int = 0, world: int = 1) -> dict:
    """This rank's rows of phase ssl's ``mode`` batch on ``dev``."""
    _, seed, rows, waves = SSL_DP_MODES[mode]
    batch_np, _ = ssl_batch(np.random.default_rng(seed), rows, TRAIN_BUCKET_S, waves)
    mine = local_rows(rows, rank, world)
    return {k: torch.from_numpy(v[mine]).to(dev) for k, v in batch_np.items()}


def _ssl_dp_float32(dev, mode: str, rank: int = 0, world: int = 1) -> tuple:
    """One float32 step of ``mode`` (``_step_errors``' operands) on this
    rank's rows, data-parallel when ``world`` > 1, with its launches of
    K1-K6."""
    step, state = _ssl_dp_step(dev, mode, recipe=False, data_parallel=world > 1)
    batch = _ssl_dp_batch(dev, mode, rank, world)
    _ssl_zero()
    new, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    launches = _ssl_counts()
    cpu = lambda tree: {k: v.cpu() for k, v in tree.items()}  # noqa: E731
    return (cpu(state.params), cpu(new.params), cpu(new.opt_state[0]),
            {k: metrics[k].cpu() for k in ("loss", "grad_norm", "finite")}), launches, batch


def _ssl_dp_worker(task: str, spec: dict, env: dict) -> dict:
    """A rank of phase ssl's data-parallel part: ``ssl_steps`` (the feature
    model's bf16 steps, the gloo all-reduce timed, a float32 step of each
    mode, K6 at the dual rows against its plain version) or ``ssl_cli``
    (an SSL entry point's ``main`` under the launcher's variables)."""
    out = {}
    if task == "ssl_steps":
        rank = distributed.init(env, "cuda", DP_TIMEOUT_S)
        dev = rank.device
        step, state = _ssl_dp_step(dev, "feature", recipe=True, data_parallel=True)
        _ssl_zero()
        losses, ms, state = _dp_steps(dev, step, state, _ssl_dp_batch(dev, "feature", rank.rank,
                                                                      rank.world), SSL_DP_STEPS)
        out.update(backend=rank.backend, losses=losses, step_ms=ms, launches=_ssl_counts(),
                   digest=_dp_digest(state))
        flat = torch.zeros(sum(v.numel() for v in state.params.values()) + 1, device=dev)
        distributed.all_reduce_(flat)
        distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_ALLREDUCE_ITERS):
            distributed.all_reduce_(flat)
        torch.cuda.synchronize()
        out.update(allreduce_ms=1e3 * (time.perf_counter() - t0) / DP_ALLREDUCE_ITERS,
                   allreduce_floats=flat.numel())
        del step, state
        parity_launches = {}
        for mode in SSL_DP_MODES:
            res, launches, batch = _ssl_dp_float32(dev, mode, rank.rank, rank.world)
            out[mode], out[f"{mode}_update"] = res, digest(*res[1].values())
            parity_launches[mode] = launches
            if mode == "dual":            # K6 at the dual config on this rank's raw rows
                raw, lens = batch["raw_waves"].contiguous(), batch["raw_wave_lens"]
                S_ext = raw.shape[1] + DUAL_MEL_CONFIG.n_fft
                got = extend_preemph(raw, lens, None, DUAL_MEL_CONFIG, S_ext)
                want = extend_preemph_plain(raw, lens, None, DUAL_MEL_CONFIG, S_ext)
                out["k6_dual_max_abs_err"] = (got - want).abs().max().item()
                out["k6_dual_bit_equal"] = torch.equal(got, want)
            del batch
            torch.cuda.empty_cache()
        out["parity_launches"] = parity_launches
        distributed.shutdown()
    else:                         # an SSL entry point under a launcher
        from lightning_asr_torch.training import checkpoint
        from lightning_asr_torch.training.trainer import Trainer

        writes, vals, passes = [], [], []
        save, validate, pseudo_pass = checkpoint.save_checkpoint, Trainer.validate, SSLTrainer._pseudo_pass
        checkpoint.save_checkpoint = lambda *a, **k: (writes.append(str(a[0])), save(*a, **k))[1]
        Trainer.validate = lambda self, state: (vals.append(validate(self, state)), vals[-1])[1]
        SSLTrainer._pseudo_pass = lambda self, state: (passes.append(
            len(self.dm.pseudo_train_dataloader())), pseudo_pass(self, state))[1]
        _ssl_zero()
        result, launches = _run_entry({"train_ssl": ssl_train_main,
                                       "train_ssl_double": ssl_double_main}[spec["entry"]],
                                      spec["args"])
        tr = result["trainer"]
        out.update(launches=launches, writes=writes, val=vals, test=result["test"],
                   data_parallel=tr.data_parallel, pseudo_batches=sum(passes),
                   pseudo=[(e.audio_filepath, e.text) for e in tr.dm.pseudo_entries],
                   batches=[e["batches"] for e in tr.epoch_stats],
                   epoch_wall_s=[e["wall_sec"] for e in tr.epoch_stats],
                   train_steps=sum(e["batches"] for e in tr.epoch_stats),
                   eval_batches=tr.profiler.counts["val_step"] + tr.profiler.counts["test_step"],
                   digest=digest(*result["state"].params.values()))
    return out


def phase_ssl_data_parallel(dev, card: str) -> dict:
    """The SSL paths over 2 ranks sharing the card (gloo), as the JAX SSL
    entry points train over a data mesh: the feature model's bf16 steps on
    the SSL batch (16 rows a rank) against one process; one float32 step
    of each mode (feature, dual, retrain) against one process (DP_TOL), K6
    bit for bit on the dual rows; ``train_ssl`` (its ``main``) as 2 ranks
    on the entry points' corpus with a pseudo pass after each epoch: the
    same metrics on both ranks, the gathered pool equal to a one-process
    pass's from the same ``last`` (at the ranks' batch of rows, so that the
    card's convs see the same shapes), ``last`` written once and loaded by
    AsrTranslator; ``train_ssl_double`` as 2 ranks for an epoch.  Returns
    the ranks' launches of K1-K6."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ranks = _dp_launch("ssl_steps", DP_WORLD, tmp)
        step, state = _ssl_dp_step(dev, "feature", recipe=True)
        one_losses, one_ms, _ = _dp_steps(dev, step, state, _ssl_dp_batch(dev, "feature"),
                                          SSL_DP_STEPS)
        del step, state
        one = {}
        for mode in SSL_DP_MODES:
            one[mode] = _ssl_dp_float32(dev, mode)[0]
            torch.cuda.empty_cache()
        m = ssl_corpus(tmp)
        common = [f"data.train_manifest={m['train']}", f"data.val_manifest={m['dev']}",
                  f"data.test_manifest={m['dev']}", f"ssl.feature_folder={tmp / 'feats'}",
                  "data.bucket_seconds=[4.0]", f"train.train_batch_size={SSL_CLI_BATCH}",
                  f"train.dev_batch_size={SSL_CLI_BATCH}", "train.warmup_steps=1",
                  "train.log_every_n_steps=1", f"train.dist_timeout_s={DP_TIMEOUT_S}"]
        run = tmp / "ssl"
        # lr 1e-6 keeps the seeded model's decodes non-empty (phase
        # ssl_entry_points), so that every pass injects
        cli = _dp_launch("ssl_cli", DP_WORLD, tmp, entry="train_ssl", args=common + [
            f"log.run.dir={run}", f"train.total_epoch={SSL_DP_CLI_EPOCHS}",
            "train.learning_rate=1e-6", "train.min_lr=1e-7", f"data.pseudo_manifest={m['pool']}",
            "ssl.pseudo_start_epoch=0", "ssl.pseudo_every_n_epochs=1",
            "ssl.pseudo_confidence_threshold=1e9"])
        double = _dp_launch("ssl_cli", DP_WORLD, tmp, entry="train_ssl_double", args=common + [
            f"log.run.dir={tmp / 'double'}", "train.total_epoch=1"])
        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        # one process's pass from the same last, over the ranks' batch of rows
        last = run / "checkpoints" / "last"
        state_dict, meta = load_checkpoint(last)
        model = build_model(len(LABELS) + 1, mask=True, feature_in=SSL_FEATURE_DIM,
                            dtype=torch.bfloat16)
        model.load_state_dict(state_dict)
        dm = SSLDataModule(train_manifest=str(m["train"]), labels=LABELS,
                           dev_bs=SSL_CLI_BATCH // DP_WORLD, ssl_folder=str(tmp / "feats"),
                           pseudo_manifest=str(m["pool"]), bucket_seconds=(4.0,))
        trainer = SSLTrainer(model.to(dev), novograd(1e-3), dm, run_dir=tmp / "one",
                             pseudo_confidence_threshold=1e9)
        trainer._pseudo_pass(trainer.init_state())
        one_pool = [(e.audio_filepath, e.text) for e in dm.pseudo_entries]
        del trainer, model
        translator = AsrTranslator(last, device="cuda")
        loaded = digest(*(v for k, v in translator.model.state_dict().items()
                          if not k.endswith(("running_mean", "running_var"))))
        saved = digest(*(state_dict[k].to(dev) for k, v in translator.model.state_dict().items()
                         if not k.endswith(("running_mean", "running_var"))))
        del translator

    failed = []           # every check runs, the phase line prints, then failures exit

    def expect(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)

    r0, r1 = ranks
    expect(r0["backend"] == r1["backend"] == "gloo", f"ssl ranks: backends {r0['backend']}, {r1['backend']}")
    expect(r0["losses"] == r1["losses"] and r0["digest"] == r1["digest"],
           f"ssl ranks: the ranks differ: losses {r0['losses']} / {r1['losses']}")
    expect(all(np.isfinite(r0["losses"])), f"ssl ranks: losses {r0['losses']}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], one_losses))
    expect(loss_rel <= DP_BF16_LOSS_RTOL,
           f"ssl ranks: 2 ranks against one: losses {r0['losses']} / {one_losses}")
    per_step = {"mel_from_extended": 0, "extend_preemph": 0, "lstm_recurrence": SSL_DP_STEPS,
                "lstm_backward": SSL_DP_STEPS, "ctc_alpha": SSL_DP_STEPS, "ctc_beta": SSL_DP_STEPS}
    expect(r0["launches"] == r1["launches"] == per_step,
           f"ssl ranks: launches {r0['launches']} / {r1['launches']}, want {per_step}")
    parity = {}
    for mode in SSL_DP_MODES:
        expect(r0[f"{mode}_update"] == r1[f"{mode}_update"], f"ssl ranks: {mode}: the ranks' updates differ")
        errs, worst = _step_errors(r0[mode], one[mode])
        for key, lim in DP_TOL.items():
            expect(errs[key] <= lim, f"ssl ranks: {mode}: {key} {errs[key]} > {lim} ({worst})")
        want = {**{k: 0 for k in per_step}, "lstm_recurrence": 1, "lstm_backward": 1,
                "ctc_alpha": 1, "ctc_beta": 1, "extend_preemph": int(mode == "dual")}
        for r in ranks:
            expect(r["parity_launches"][mode] == want,
                   f"ssl ranks: {mode} float32 launches {r['parity_launches'][mode]}, want {want}")
        parity[mode] = {**errs, "worst_grad_tensor": worst}
    expect(r0["k6_dual_bit_equal"] and r1["k6_dual_bit_equal"],
           f"ssl ranks: K6 at the dual rows: {r0['k6_dual_max_abs_err']}, {r1['k6_dual_max_abs_err']}")
    for name, (c0, c1) in (("train_ssl", cli), ("train_ssl_double", double)):
        expect(c0["data_parallel"] and c1["data_parallel"], f"ssl ranks: {name} ran one process")
        expect(c0["val"] == c1["val"] and len(c0["val"]) == len(c0["batches"])
               and all(np.isfinite(v["val_loss"]) for v in c0["val"]),
               f"ssl ranks: {name} val metrics {c0['val']} / {c1['val']}")
        expect(c0["test"] == c1["test"] and c0["digest"] == c1["digest"]
               and c0["batches"] == c1["batches"], f"ssl ranks: {name}: the ranks differ")
        expect([len(c["writes"]) for c in (c0, c1)] == [len(c0["batches"]), 0],
               f"ssl ranks: {name}: checkpoints written {[c['writes'] for c in (c0, c1)]}")
        for c in (c0, c1):
            t, e = c["train_steps"], c["eval_batches"] + c["pseudo_batches"]
            want = {"mel_from_extended": 0, "extend_preemph": (t + e) * (name == "train_ssl_double"),
                    "lstm_recurrence": t + e, "lstm_backward": t, "ctc_alpha": t + e, "ctc_beta": t}
            expect(c["launches"] == want, f"ssl ranks: {name} launches {c['launches']}, want {want}")
    c0, c1 = cli
    pseudo = [r for r in rows if "pseudo_total" in r]
    expect([r["pseudo_total"] for r in pseudo] == [SSL_CLI_UTTS[2]] * SSL_DP_CLI_EPOCHS
           and pseudo[-1]["pseudo_kept"] == len(c0["pseudo"]) > 0,
           f"ssl ranks: train_ssl pseudo passes {pseudo}")
    expect(c0["pseudo"] == c1["pseudo"] == one_pool,
           f"ssl ranks: the gathered pool ({len(c0['pseudo'])}) is not one process's from last "
           f"({len(one_pool)})")
    expect(loaded == saved == c0["digest"],
           "ssl ranks: the translator's weights are not rank 0's last")
    median = lambda ms: statistics.median(ms[1:])  # noqa: E731
    res = {"phase": "ssl_data_parallel", "card": card, "world": DP_WORLD, "backend": r0["backend"],
           "rows_per_rank": TRAIN_BATCH // DP_WORLD, "steps": SSL_DP_STEPS,
           "losses": r0["losses"], "one_process_losses": one_losses,
           "loss_rel_vs_one_process": loss_rel, "loss_rtol": DP_BF16_LOSS_RTOL,
           "launches_per_rank": r0["launches"], "parity": parity, "limits": DP_TOL,
           "k6_dual_max_abs_err": [r0["k6_dual_max_abs_err"], r1["k6_dual_max_abs_err"]],
           "train_ssl": {"ranks": DP_WORLD, "val": c0["val"], "test": c0["test"],
                         "batches_per_epoch": c0["batches"], "epoch_wall_s": c0["epoch_wall_s"],
                         "pseudo": pseudo, "pool_equals_one_process": c0["pseudo"] == one_pool,
                         "checkpoint_writes": [len(c["writes"]) for c in cli],
                         "launches_per_rank": c0["launches"]},
           "train_ssl_double": {"val": double[0]["val"], "test": double[0]["test"],
                                "epoch_wall_s": double[0]["epoch_wall_s"],
                                "launches_per_rank": double[0]["launches"]},
           "times": {"note": "ranks sharing one card through the host (gloo)",
                     "step_ms_one_process": median(one_ms),
                     "step_ms_two_ranks_sharing_the_card": [median(r["step_ms"]) for r in ranks],
                     "gloo_flat_gradient_allreduce_ms": [r["allreduce_ms"] for r in ranks],
                     "allreduce_floats": r0["allreduce_floats"]}}
    print(json.dumps(res), flush=True)
    check(not failed, "; ".join(failed))
    launches = {k: 0 for k in _ssl_counts()}
    for out in (*ranks, *cli, *double):
        for name, n in out["launches"].items():
            launches[name] += n
    for out in ranks:
        for counts in out["parity_launches"].values():
            for name, n in counts.items():
                launches[name] += n
    return launches


def _tp_local_kernels(dev) -> dict:
    """K9/K10 at TP_SEPCONV_SHAPES and K11 at TP_K11_SHAPES (B=32, T'=836,
    bf16) against their plain versions under phase K9/K10/K11's limits, each
    run twice for the same bits; K9's and K10's ms at those shapes."""
    B, T = TRAIN_BATCH, T_TRAIN
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()  # noqa: E731
    out = {"sepconv": [], "depthwise": []}
    for i, (cin, cout, k) in enumerate(TP_SEPCONV_SHAPES):
        g = torch.Generator(device=dev).manual_seed(40 + i)
        x = torch.randn((B, cin, T), generator=g, device=dev).bfloat16()
        dy = torch.randn((B, cout, T), generator=g, device=dev).bfloat16()
        wd = (torch.rand((cin, 1, k), generator=g, device=dev) * 2 - 1) / k ** 0.5
        wp = (torch.rand((cout, cin, 1), generator=g, device=dev) * 2 - 1) / cin ** 0.5
        y, (dx, gwd, gwp) = sepconv_forward(x, wd, wp), sepconv_backward(x, wd, wp, dy)
        want_dx, want_gwd, want_gwp = sepconv_backward_plain(x, wd, wp, dy)
        y_err, y_ulps, y_ok = _bf16_err(y, sepconv_forward_plain(x, wd, wp))
        dx_err, dx_ulps, dx_ok = _bf16_err(dx, want_dx)
        errs = {"shape": [B, cin, cout, T, k], "K9_y_max_abs": y_err, "K9_y_max_ulps": y_ulps,
                "K10_dx_max_abs": dx_err, "K10_dx_max_ulps": dx_ulps,
                "K10_wd_grad_rel": rel(gwd, want_gwd), "K10_wp_grad_rel": rel(gwp, want_gwp)}
        check(y_ok and dx_ok, f"tensor_parallel: K9/K10 at {errs['shape']} beyond one bf16 ulp: {errs}")
        check(errs["K10_wd_grad_rel"] <= SEPCONV_TOL_GRAD and errs["K10_wp_grad_rel"] <= SEPCONV_TOL_GRAD,
              f"tensor_parallel: K10 weight gradients at {errs['shape']}: {errs}")
        check(torch.equal(sepconv_forward(x, wd, wp), y)
              and all(torch.equal(a, b) for a, b in zip(sepconv_backward(x, wd, wp, dy), (dx, gwd, gwp))),
              f"tensor_parallel: K9/K10 at {errs['shape']} not deterministic")
        errs.update(K9_ms=cuda_ms(lambda: sepconv_forward(x, wd, wp), 5),
                    K10_ms=cuda_ms(lambda: sepconv_backward(x, wd, wp, dy), 5))
        out["sepconv"].append(errs)
    for i, (c, k) in enumerate(TP_K11_SHAPES):
        g = torch.Generator(device=dev).manual_seed(50 + i)
        x = torch.randn((B, c, T), generator=g, device=dev).bfloat16()
        dy = torch.randn((B, c, T), generator=g, device=dev).bfloat16()
        gk = depthwise_wgrad(x, dy, k)
        err = rel(gk, depthwise_wgrad_plain(x, dy, k))
        check(err <= K11_TOL, f"tensor_parallel: K11 at C={c}, k={k}: {err}")
        check(torch.equal(depthwise_wgrad(x, dy, k), gk), f"tensor_parallel: K11 at C={c} not deterministic")
        out["depthwise"].append({"shape": [B, c, T, k], "K11_rel": err})
    return out


def phase_tensor_parallel(dev, card: str) -> dict:
    """Tensor parallelism on the one card: K9-K11 at the local widths of a
    model group of 2; 2 ranks over gloo splitting the default model's trunk
    (dp1 x tp2) take 4 of the recipe's bf16 steps on phase ``training``'s
    batch against one process, then a float32 step of each conv route; 4
    ranks (dp2 x tp2) take 2 steps on 8 rows; the training CLI with
    ``train.tp=2 train.n_devices=2`` for an epoch, resumed by one process
    (fused NovoGrad) and served by AsrTranslator.  Returns the tp runs'
    launches by wrapper."""
    local = _tp_local_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ranks = _dp_launch("tp_steps", TP_SIZE, tmp)
        dp2 = _dp_launch("tp_dp2", 2 * TP_SIZE, tmp)
        train = tone_corpus(tmp, TRAINER_UTTS, 0, "train")
        dev_m = tone_corpus(tmp, TRAINER_DEV_UTTS, 1, "dev")
        common = [f"data.train_manifest={train}", f"data.val_manifest={dev_m}",
                  f"data.test_manifest={dev_m}", "data.bucket_seconds=[3.0]",
                  "train.train_batch_size=32", "train.dev_batch_size=32", "train.warmup_steps=1",
                  "train.log_every_n_steps=1", "model.compute_dtype=bf16",
                  f"train.dist_timeout_s={DP_TIMEOUT_S}"]
        run = tmp / "run"
        cli = _dp_launch("cli", TP_SIZE, tmp, args=common + [
            "train.total_epoch=1", f"log.run.dir={run}", f"train.tp={TP_SIZE}",
            f"train.n_devices={TP_SIZE}"])
        last = run / "checkpoints" / "last"
        sd, meta = load_checkpoint(last)
        whole = build_model(len(LABELS) + 1, DEFAULT_ENCODER, mask=True).state_dict()
        shapes_whole = {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: tuple(v.shape) for k, v in whole.items()}
        resumed = _run_train(common + ["train.total_epoch=2", "train.n_devices=1",
                                       f"train.checkpoint={last}", f"log.run.dir={tmp / 'resumed'}"])
        translator = AsrTranslator(last, device="cuda")
        text = translator.translate(json.loads(train.read_text().splitlines()[0])["audio_filepath"])
        loaded = digest(*(v for k, v in translator.model.state_dict().items()))
        saved = digest(*(sd[k].to(dev) for k in translator.model.state_dict()))
        del translator

    r0, r1 = ranks
    failed = []         # every check runs, the phase line prints, then failures exit

    def expect(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)

    expect(r0["backend"] == r1["backend"] == "gloo", f"tensor_parallel: backends {r0['backend']}, {r1['backend']}")
    expect(r0["losses"] == r1["losses"] and r0["digest"] == r1["digest"],
           f"tensor_parallel: the model group's ranks differ: {r0['losses']} / {r1['losses']}")
    expect(all(np.isfinite(r0["losses"])), f"tensor_parallel: losses {r0['losses']}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["one_losses"]))
    expect(loss_rel <= DP_BF16_LOSS_RTOL,
           f"tensor_parallel: tp2 against one process: {r0['losses']} / {r0['one_losses']}")
    update_rel, update_worst, worst_rel = r0["update_rel"]
    floor = r0["chaos_floor"][0]
    expect(update_rel <= TP_BF16_UPDATE_REL,
           f"tensor_parallel: the gathered parameters against one process: {r0['update_rel']}, "
           f"the one process's own one-LSB move {r0['chaos_floor']}")
    per_step = {fn.__name__: TP_STEPS if fn in DP_COUNTERS else 0 for fn in TP_COUNTERS}
    expect(r0["launches"] == r1["launches"] == per_step,
           f"tensor_parallel: launches {r0['launches']} / {r1['launches']}, want {per_step}")
    routed = ROUTED_CONVS[DEFAULT_ENCODER]
    want = {fn.__name__: 3 for fn in DP_COUNTERS}
    want.update(sepconv_forward=routed, sepconv_backward=routed, depthwise_wgrad=routed)
    expect(r0["parity_launches"] == r1["parity_launches"] == want,
           f"tensor_parallel: float32 steps' launches {r0['parity_launches']}, want {want}")
    for name, errs in r0["parity"].items():
        expect(r0[name] == r1[name], f"tensor_parallel: {name}: the ranks' updates differ")
        for key, lim in DP_TOL.items():
            expect(errs[key] <= lim, f"tensor_parallel: {name}: {key} {errs[key]} > {lim}")
        worst_lstm = max(errs["context_rnn_grad_rel"].values())
        expect(worst_lstm <= DP_TOL["grad_rel"],
               f"tensor_parallel: {name}: the context BiLSTM's gradient {errs['context_rnn_grad_rel']}")
    d0 = dp2[0]
    expect(all(d["losses"] == d0["losses"] for d in dp2) and all(np.isfinite(d0["losses"])),
           f"tensor_parallel: dp2 x tp2 ranks' losses {[d['losses'] for d in dp2]}")
    expect([(d["data_index"], d["model_index"]) for d in dp2] == [(0, 0), (0, 1), (1, 0), (1, 1)],
           "tensor_parallel: dp2 x tp2 layout")
    dp2_rel = max(abs(a - b) / abs(b) for a, b in zip(d0["losses"], d0["one_losses"]))
    expect(dp2_rel <= DP_BF16_LOSS_RTOL,
           f"tensor_parallel: dp2 x tp2 against one process: {d0['losses']} / {d0['one_losses']}")
    dp2_steps = {fn.__name__: TP_DP2_STEPS if fn in DP_COUNTERS else 0 for fn in TP_COUNTERS}
    expect(all(d["launches"] == dp2_steps for d in dp2), f"tensor_parallel: dp2 launches {d0['launches']}")
    c0, c1 = cli
    expect(c0["split"] and c1["split"] and c0["optimizer"] == "NovogradState",
           f"tensor_parallel: the CLI ran split {c0['split']} with {c0['optimizer']}")
    expect(c0["val"] == c1["val"] and len(c0["val"]) == 1 and np.isfinite(c0["val"][0]["val_loss"]),
           f"tensor_parallel: CLI val metrics {c0['val']} / {c1['val']}")
    expect(c0["test"] == c1["test"] and c0["losses"] == c1["losses"],
           "tensor_parallel: the CLI's ranks differ")
    expect([len(c["writes"]) for c in cli] == [1, 0] and shapes_whole and meta["epoch"] == 0,
           f"tensor_parallel: checkpoints written {[c['writes'] for c in cli]}, whole {shapes_whole}")
    for c in cli:
        t, e = c["train_steps"], c["eval_batches"]
        want = {"mel_from_extended": t + e, "lstm_recurrence": t + e, "lstm_backward": t,
                "ctc_alpha": t + e, "ctc_beta": t, "extend_preemph": t + e,
                "sepconv_forward": 0, "sepconv_backward": 0, "depthwise_wgrad": 0}
        expect(c["launches"] == want, f"tensor_parallel: CLI launches {c['launches']}, want {want}")
    tr = resumed["trainer"]
    resumed_losses = [x for e in tr.epoch_stats for x in e["losses"]]
    expect(len(tr.epoch_stats) == 1 and tr.epoch_stats[0]["epoch"] == 1
           and int(resumed["state"].step) == 2 * c0["train_steps"] and all(np.isfinite(resumed_losses))
           and type(resumed["state"].opt_state).__name__ == "FusedNovogradState",
           f"tensor_parallel: one process resuming the tp checkpoint: {tr.epoch_stats}")
    expect(loaded == saved and isinstance(text, str) and set(text) <= set(LABELS),
           f"tensor_parallel: the translator on the tp checkpoint gave {text!r}")
    median = lambda ms: statistics.median(ms[1:])  # noqa: E731
    steps = TP_STEPS
    res = {"phase": "tensor_parallel", "card": card, "layout": {"dp": 1, "tp": TP_SIZE},
           "backend": r0["backend"], "rows": TRAIN_BATCH, "steps": steps,
           "local_widths": local, "local_shapes": r0["local_shapes"],
           "losses": r0["losses"], "one_process_losses": r0["one_losses"],
           "loss_rel_vs_one_process": loss_rel, "loss_rtol": DP_BF16_LOSS_RTOL,
           "update_rel_vs_one_process": {"whole": update_rel, "worst_tensor": update_worst,
                                         "worst_tensor_rel": worst_rel},
           "chaos_floor": {"one_lsb_move": floor, "worst_tensor": r0["chaos_floor"][1],
                           "worst_tensor_rel": r0["chaos_floor"][2]},
           "update_rel_limit": TP_BF16_UPDATE_REL,
           "launches_per_rank": r0["launches"], "parity_launches_per_rank": r0["parity_launches"],
           "parity": {n: {k: v for k, v in e.items() if k != "context_rnn_grad_rel"}
                      for n, e in r0["parity"].items()}, "limits": DP_TOL,
           "dp2_tp2": {"ranks": 2 * TP_SIZE, "rows": TP_DP2_ROWS, "bucket_s": TP_DP2_SECONDS,
                       "losses": d0["losses"], "one_process_losses": d0["one_losses"],
                       "loss_rel_vs_one_process": dp2_rel,
                       "step_ms_per_rank": [median(d["step_ms"]) for d in dp2]},
           "cli": {"ranks": TP_SIZE, "val": c0["val"][0], "test": c0["test"],
                   "train_steps": c0["train_steps"], "eval_batches": c0["eval_batches"],
                   "epochs": c0["epochs"], "checkpoint_writes": [len(c["writes"]) for c in cli],
                   "resumed_by_one_process": {"losses": resumed_losses,
                                              "step": int(resumed["state"].step)},
                   "translated_chars": len(text)},
           "times": {"note": "ranks sharing one card through the host (gloo); not tp across cards",
                     "step_ms_one_process": median(r0["one_step_ms"]),
                     "step_ms_per_rank": [median(r["step_ms"]) for r in ranks],
                     "gathers_a_step": r0["gathers"]["gathers"],
                     "gather_bytes_a_step": r0["gathers"]["bytes"],
                     "gather_ms_a_step_per_rank": [r["gathers"]["ms"] for r in ranks],
                     "timed_step_ms_per_rank": [r["timed_step_ms"] for r in ranks]}}
    print(json.dumps(res), flush=True)
    print(json.dumps({"phase": "tensor_parallel_context_rnn", "card": card,
                      "grad_rel_vs_one_process": {n: e["context_rnn_grad_rel"]
                                                  for n, e in r0["parity"].items()},
                      "limit": DP_TOL["grad_rel"]}), flush=True)
    check(not failed, "; ".join(failed))
    launches = {}
    for out in (*ranks, *dp2, *cli):
        for name, n in out["launches"].items():
            launches[name] = launches.get(name, 0) + n
    for out in ranks:
        for name, n in out["parity_launches"].items():
            launches[name] += n
    return launches


def hmma_counts():
    """Tensor-core (HMMA) instructions in each built library's SASS, from
    the toolkit's cuobjdump; None where the toolkit has none."""
    tool = Path(kernel_build._nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    counts = {}
    for name in kernel_build.SOURCES:
        sass = subprocess.run([str(tool), "-sass", str(kernel_build.library_path(name))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        counts[name] = sum("HMMA" in line for line in sass.splitlines())
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with ThreadPoolExecutor(1) as pool:     # g++ beside the nvcc processes
        native_build = pool.submit(native.build)
        info = kernel_build.build_all()
        native_build = native_build.result()
    ptxas = [line.strip() for out in info["ptxas"].values() for line in out.splitlines()
             if "registers" in line or "Compiling entry" in line]
    hmma = hmma_counts()
    print(json.dumps({"phase": "build", "seconds": info["seconds"], "cached": info["cached"],
                      "native": native_build, "hmma": hmma, "ptxas": ptxas}), flush=True)

    k1 = phase_k1(dev)
    k2 = phase_k2(dev, info["ptxas"].get("lstm", ""))
    k6 = phase_k6(dev)
    k9, k10, k11 = phase_sepconv(dev)
    serving, serving_sep, translator, served = phase_serving(dev)
    phase_profile(translator, served)
    encoder_bursts, encoder_trainings = phase_encoders(dev)
    decoding = phase_decoding(dev, translator, served, native_build)
    del translator
    k3 = phase_k3(dev, hmma, info["ptxas"].get("lstm_bwd", ""))
    k7, k8 = phase_k78(dev, hmma, info["ptxas"].get("lstm_bidir", ""))
    k4, k5 = phase_k45(dev, info["ptxas"].get("ctc", ""))
    trainings = [phase_training(dev), phase_training(dev, "sepconv", CONV_TRAIN_STEPS),
                 phase_training(dev, "dw_wgrad", CONV_TRAIN_STEPS),
                 phase_training(dev, steps=CONV_TRAIN_STEPS, fuse_directions=True)]
    for conv_kernel, fused in ((None, False), ("sepconv", False), ("dw_wgrad", False), (None, True)):
        phase_train_parity(dev, conv_kernel, fused)
    trainer = phase_trainer(dev)
    ssl = phase_ssl(dev, card)
    dp = phase_data_parallel(dev, card)
    tpl = phase_tensor_parallel(dev, card)
    h128, head_launches = phase_lstm_head_and_data(dev, info["ptxas"], k2["digests"])
    # launches on the main paths: the serving bursts of every encoder, the
    # decoding phase's forwards, the training steps of every configuration,
    # the trainer's runs, the SSL phase's steps, runs and served forwards,
    # and the data-parallel ranks' steps and CLI runs
    ssl = {k: n + dp.get(k, 0) for k, n in ssl.items()}
    serve = {key: sum(b.get(key, 0) for b in [serving["launches"], serving_sep["launches"],
                                              decoding["launches"], *encoder_bursts])
             for key in ("mel", "lstm", "extend", "sepconv_forward")}
    trainings += encoder_trainings
    train = {name: sum(t["launches"][name] for t in trainings) for name in trainings[0]["launches"]}
    for name, n in head_launches.items():
        train[name] += n
    k1["launches"] = serve["mel"] + train["mel_from_extended"] + ssl["mel_from_extended"]
    k2["launches"] = serve["lstm"] + train["lstm_recurrence"] + ssl["lstm_recurrence"]
    k3["launches"] = train["lstm_backward"] + ssl["lstm_backward"]
    k4["launches"] = train["ctc_alpha"] + ssl["ctc_alpha"]
    k5["launches"] = train["ctc_beta"] + ssl["ctc_beta"]
    k6["launches"] = serve["extend"] + train["extend_preemph"] + ssl["extend_preemph"]
    k7["launches"] = train["lstm_recurrence_stacked"] + trainer["k7_launches"]
    k8["launches"] = train["lstm_backward_stacked"] + trainer["k8_launches"]
    k9["launches"] = serve["sepconv_forward"] + train["sepconv_forward"]
    k10["launches"] = train["sepconv_backward"]
    k11["launches"] = train["depthwise_wgrad"]
    rows = (k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11)
    # the tensor-parallel ranks' steps and CLI runs (K7, K8 are not on that path)
    for row, name in ((k1, "mel_from_extended"), (k2, "lstm_recurrence"), (k3, "lstm_backward"),
                      (k4, "ctc_alpha"), (k5, "ctc_beta"), (k6, "extend_preemph"),
                      (k7, None), (k8, None), (k9, "sepconv_forward"), (k10, "sepconv_backward"),
                      (k11, "depthwise_wgrad")):
        row["tp_launches"] = tpl[name] if name else 0
        row["launches"] += row["tp_launches"]
    check(all(r["launches"] > 0 for r in rows), "a kernel of the main paths was never launched")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # the LSTM kernels at the head's H=128: their launches on the head's
    # paths, their error, times, bound and cuDNN's at the training shape
    for row, key in ((k2, "K2"), (k3, "K3"), (k7, "K7"), (k8, "K8")):
        row["h128"] = {k: h128[key][k] for k in keys if k in h128[key]}
    print(json.dumps({"phase": "profiler", "missing_share": PROFILER_MISSING_SHARE,
                      "calls": PROFILER_LOG}), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys + ("tp_launches", "h128") if k in r}
                                  for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(*sys.argv[2:4]))
    sys.exit(main())
