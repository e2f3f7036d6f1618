"""One rank of the port's data-parallel CPU tests (``test_torch_data_parallel.py``):

    python tests/torch_dp_worker.py TASK RANK WORLD PORT IN.pt OUT.pt

joins a gloo group of WORLD ranks on 127.0.0.1:PORT, runs TASK on its rows
of the global inputs in IN.pt and writes its results to OUT.pt.  It imports
only torch and the port.  Tasks:

  * ``bn``: ``MaskedBatchNorm`` in train mode on the rank's rows of x inside
    ``row_shard``: the output, x's gradient, the summed weight and bias
    gradients of sum(y · cotangent), the running statistics;
  * ``step``: the small model's ``make_train_step(data_parallel=True)`` on
    the rank's rows of one batch, ``steps`` times: each step's loss and
    grad norm, the final state, the captured gradients, preds and
    pred_lens;
  * ``fit``: ``Trainer.fit`` of the small model for one epoch on a corpus:
    the logged train losses, the val metrics, the batch WERs of a second
    validation, the number of checkpoints this rank wrote.
  * ``mmap``: an ``AsrDataModule`` with ``cache='mmap'`` in the group: its
    cache directory, the files it cached after a train epoch and the val
    loader, and the rank's val batches (waves, lengths, paths).

Tensor parallelism (``test_torch_tensor_parallel.py``; the input's ``tp``
sets the model groups of the layout):

  * ``tp_ops``: ``gather_channels``, ``copy_to_model_group`` and
    ``split_channels`` on the rank's block of a tensor: the gathered and
    split tensors, and the gradients of a loss that reads the gathered
    tensor through a column-parallel conv and a replicated branch;
  * ``tp_steps``: for each configuration of the input, ``steps`` train
    steps of ``SmallAsr`` with the per-tensor NovoGrad on the rank's rows
    and blocks, then an eval step: the losses, the gathered state, the
    eval log-probs, the local shapes of the split parameters;
  * ``tp_norms``: the per-tensor NovoGrad's update (with and without LUC),
    ``global_norm`` and ``clip_by_global_norm`` on the rank's blocks of a
    tree, gathered;
  * ``tp_fit``: ``Trainer.fit`` of ``SmallAsr`` with the per-tensor NovoGrad
    (optionally resumed): the gathered state it returns, the val metrics,
    its checkpoint writes, and a one-process forward before and after the
    fit with no layout left behind;
  * ``tp_bf16``: ``bf16_recipe``'s steps of the full-width bf16 model on the
    rank's rows and blocks: the losses and the gathered parameters.

SSL (``test_torch_ssl_data_parallel.py``):

  * ``ssl``: one data-parallel train step of each SSL model of the input
    (``ssl_step``) on the rank's rows (the state, the loss, the grad norm,
    the captured gradients), then ``SSLTrainer._pseudo_pass`` of the narrow
    feature model over the datamodule's pool (the injected entries and the
    logged counts);
  * ``cli``: an SSL entry point's ``main`` under the launcher's variables
    (the rank joins its group there): each validation's metrics, the test
    metrics, the checkpoint writes, the pseudo-labeled entries, the steps.

``SmallAsr`` is the tests' model: ``AsrModel``'s interface at narrow widths
(a SepConv stem 64->32 k11 stride 2, a repeat-2 block 32->32 k7, the BiLSTM
32->2x8 concatenated, a block 48->64 k5, the float32 1x1 decoder).  Inside
``tp.model_parallel`` it runs split as the full-width encoders do.
``ssl_model`` gives the three SSL models with its encoder and decoder in
place of the full-width ones.
"""

import contextlib
import importlib
import os
import sys

import torch
from torch import nn

from lightning_asr_torch.models.layers import (BatchLSTM, Conv, MaskedBatchNorm, QuartNetBlock,
                                               SepConv, _lengths_from_percents)
from lightning_asr_torch.models.quartznet import ctc_head
from lightning_asr_torch.optim.novograd import GradientTransformation
from lightning_asr_torch.parallel import distributed, tp
from lightning_asr_torch.parallel.mesh import RowShard, local_rows, row_shard

TIMEOUT_S = 120.0


class SmallEncoder(nn.Module):
    def __init__(self, dtype=None, drop_rate: float = 0.0, conv_kernel=None, in_c: int = 64):
        super().__init__()
        common = dict(mask=True, drop_rate=drop_rate, dtype=dtype, conv_kernel=conv_kernel)
        self.first_cnn = SepConv(in_c, 32, 11, stride=2, **common)
        self.block1 = QuartNetBlock(repeat=2, in_ch=32, out_ch=32, k=7, **common)
        self.context_rnn = BatchLSTM(32, 8)
        self.block2 = QuartNetBlock(repeat=1, in_ch=48, out_ch=64, k=5, **common)

    def forward(self, x, percents, generator=None):
        x = self.block1(self.first_cnn(tp.own(x), percents, generator), percents, generator)
        x = tp.full(x, 32)
        lengths = _lengths_from_percents(x.shape[-1], percents)
        c = self.context_rnn(x.transpose(1, 2).float(), lengths)
        x = tp.own(torch.cat([x, c.to(x.dtype).transpose(1, 2)], dim=1))
        return self.block2(x, percents, generator)


class SmallAsr(nn.Module):
    def __init__(self, num_classes: int, dtype=None, drop_rate: float = 0.0, conv_kernel=None):
        super().__init__()
        self.dtype = dtype
        self.encoder = SmallEncoder(dtype, drop_rate, conv_kernel)
        self.decoder = Conv(64, num_classes, 1, bias=True)

    def forward(self, x, percents, generator=None):
        return ctc_head(self.decoder, tp.full(self.encoder(x.transpose(1, 2), percents, generator),
                                              64), percents)


def capture(inner: GradientTransformation) -> GradientTransformation:
    """The optimizer behind a transform that keeps the raw gradients in the
    first slot of its state."""
    def update(grads, state, params):
        updates, new_inner = inner.update(grads, state[1], params)
        return updates, (grads, new_inner)

    return GradientTransformation(
        lambda p: ({k: torch.zeros_like(v) for k, v in p.items()}, inner.init(p)), update)


def rank_rows(batch: dict, rank: int, world: int, micro_batches: int = 1) -> dict:
    """This rank's rows of a global batch of tensors (``local_rows``)."""
    total = next(iter(batch.values())).shape[0]
    rows = torch.as_tensor(local_rows(total, rank, world, micro_batches))
    return {k: v[rows] for k, v in batch.items()}


def task_bn(rank, world, inp):
    x, cot = inp["x"], inp["cotangent"]
    bn = MaskedBatchNorm(x.shape[1])
    bn.load_state_dict(inp["state"])
    bn.train()
    rows = torch.as_tensor(local_rows(x.shape[0], rank, world))
    xr = x[rows].clone().requires_grad_(True)
    with row_shard(RowShard(rows, x.shape[0], world)):
        y = bn(xr)
    (y * cot[rows]).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    distributed.all_reduce_(grads)
    C = x.shape[1]
    return {"y": y.detach(), "x_grad": xr.grad, "weight_grad": grads[:C], "bias_grad": grads[C:],
            "running_mean": bn.running_mean, "running_var": bn.running_var, "rows": rows}


def task_step(rank, world, inp):
    from lightning_asr_torch.ops.frontend import MelFrontendConfig
    from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
    from lightning_asr_torch.training.steps import create_train_state, make_train_step

    model = SmallAsr(inp["num_classes"])
    model.load_state_dict(inp["state_dict"])
    opt = capture(novograd(cosine_annealing_warmup_restarts(**inp["schedule"]), betas=(0.8, 0.5),
                           weight_decay=1e-3, fused=True))
    step = make_train_step(model, opt, inp["num_classes"] - 1, MelFrontendConfig(**inp["frontend"]),
                           augment=inp["augment"], accum_steps=inp["accum"], data_parallel=True)
    state = create_train_state(model, opt)
    batch = rank_rows(inp["batch"], rank, world, inp["accum"])
    losses, norms = [], []
    for i in range(inp["steps"]):
        state, metrics = step(state, batch, torch.Generator().manual_seed(100 + i))
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    return {"losses": torch.stack(losses), "grad_norms": torch.stack(norms), "state": state,
            "preds": metrics["preds"], "pred_lens": metrics["pred_lens"],
            "rows": torch.as_tensor(local_rows(inp["batch"]["waves"].shape[0], rank, world,
                                               inp["accum"]))}


def task_fit(rank, world, inp):
    from lightning_asr_torch.data.datamodule import AsrDataModule
    from lightning_asr_torch.metrics import wer as wer_module
    from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
    from lightning_asr_torch.training import checkpoint
    from lightning_asr_torch.training.callbacks import Callback
    from lightning_asr_torch.training.loggers import BaseLogger
    from lightning_asr_torch.training.trainer import Trainer

    class Capture(BaseLogger):
        def __init__(self):
            self.rows = []

        def log_metrics(self, metrics, step):
            self.rows.append((int(step), {k: float(v) for k, v in metrics.items()}))

    writes = []
    save = checkpoint.save_checkpoint

    def counted(*args, **kwargs):
        writes.append(str(args[0]))
        return save(*args, **kwargs)

    checkpoint.save_checkpoint = counted
    dm = AsrDataModule(**inp["datamodule"])
    model = SmallAsr(inp["num_classes"])
    model.load_state_dict(inp["state_dict"])
    sched = cosine_annealing_warmup_restarts(**inp["schedule"])
    log = Capture()
    trainer = Trainer(model, novograd(sched, betas=(0.8, 0.5), weight_decay=1e-3, fused=True), dm,
                      total_epochs=1, run_dir=inp["run_dir"], log_every_n_steps=1,
                      train_wer_every_n_steps=10**6, loggers=log if rank == 0 else None,
                      lr_schedule=sched, hparams={"labels": dm.vocab.labels}, seed=4,
                      **inp.get("trainer", {}))
    losses = []

    class Losses(Callback):
        def on_train_batch_end(self, trainer, state, metrics, batch, i):
            losses.append(float(metrics["loss"]))

    trainer.callbacks.append(Losses())
    state = trainer.fit()
    batch_wers = []
    update = wer_module.WER.update

    def recorded(self, hyps, refs):
        batch_wers.append(update(self, hyps, refs))
        return batch_wers[-1]

    wer_module.WER.update = recorded
    val = trainer.validate(state)
    return {"losses": losses, "val": val, "batch_wers": batch_wers, "writes": writes,
            "logged": log.rows, "step": int(state.step),
            "params": {k: v for k, v in state.params.items()}}


def task_mmap(rank, world, inp):
    from lightning_asr_torch.data.datamodule import AsrDataModule

    dm = AsrDataModule(**inp["datamodule"])
    list(dm.train_dataloader(0))
    val = list(dm.val_dataloader())
    cache = dm._wave_cache
    return {"cache_dir": str(dm.cache_dir), "entries": len(cache), "paths": sorted(cache._index),
            "val": [(b.waves, b.wave_lens) for b in val], "val_paths": [b.paths for b in val]}


def task_tp_ops(rank, world, inp):
    import torch.nn.functional as F

    shard = tp.ModelShard(distributed.model_index(), distributed.model_size(), {})
    x, w, c_rep, c_col = inp["x"], inp["w"], inp["c_rep"], inp["c_col"]
    n, m = x.shape[1] // shard.size, w.shape[0] // shard.size
    xl = x[:, shard.index * n:(shard.index + 1) * n].clone().requires_grad_(True)
    wl = w[shard.index * m:(shard.index + 1) * m].clone().requires_grad_(True)
    with tp.model_parallel(shard):
        y = tp.gather_channels(xl)
        out = tp.gather_channels(F.conv1d(tp.copy_to_model_group(y), wl))   # column parallel
        loss = (out * c_col).sum() + (y * c_rep).sum()                      # + a replicated branch
        loss.backward()
        xs = x.clone().requires_grad_(True)
        split = tp.split_channels(xs)
        (split * c_rep[:, shard.index * n:(shard.index + 1) * n]).sum().backward()
    return {"gathered": y.detach(), "loss": loss.detach(), "x_grad": xl.grad, "w_grad": wl.grad,
            "split": split.detach(), "split_grad": xs.grad, "index": shard.index}


def _tp_optimizer(inp):
    from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd

    return capture(novograd(cosine_annealing_warmup_restarts(**inp["schedule"]), betas=(0.8, 0.5),
                            weight_decay=1e-3, fused=False))


def task_tp_steps(rank, world, inp):
    from lightning_asr_torch.ops.frontend import MelFrontendConfig
    from lightning_asr_torch.training.steps import (create_train_state, make_eval_step,
                                                    make_train_step)

    results = []
    batch = rank_rows(inp["batch"], distributed.data_index(), distributed.data_size())
    for cfg in inp["configs"]:
        model = SmallAsr(inp["num_classes"], drop_rate=cfg.get("drop_rate", 0.0),
                         conv_kernel=cfg.get("conv_kernel"))
        model.load_state_dict(inp["state_dict"])
        opt = _tp_optimizer(inp)
        frontend = MelFrontendConfig(**inp["frontend"])
        step = make_train_step(model, opt, inp["num_classes"] - 1, frontend,
                               augment=cfg.get("augment"), data_parallel=True)
        evaluate = make_eval_step(model, inp["num_classes"] - 1, frontend, data_parallel=True)
        shard = tp.model_shard(model)
        state = tp.shard_state(create_train_state(model, opt), shard)
        local = {k: tuple(state.params[k].shape) for k in shard.specs if k in state.params}
        losses, norms = [], []
        for i in range(inp["steps"]):
            state, metrics = step(state, batch, torch.Generator().manual_seed(100 + i))
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
        log_probs = evaluate(state, batch)["log_probs"]
        assert tp.current() is None
        results.append({"losses": torch.stack(losses), "grad_norms": torch.stack(norms),
                        "state": tp.gather_state(state, shard), "log_probs": log_probs,
                        "preds": metrics["preds"], "pred_lens": metrics["pred_lens"],
                        "local_shapes": local, "specs": dict(shard.specs)})
    return {"configs": results, "rows": torch.as_tensor(local_rows(
        inp["batch"]["waves"].shape[0], distributed.data_index(), distributed.data_size()))}


def task_tp_norms(rank, world, inp):
    from lightning_asr_torch.optim import novograd
    from lightning_asr_torch.optim.clipping import clip_by_global_norm
    from lightning_asr_torch.optim.novograd import global_norm

    shard = tp.ModelShard(distributed.model_index(), distributed.model_size(),
                          tp.specs({k: v.shape for k, v in inp["params"].items()},
                                   distributed.model_size()))
    params, grads = tp.shard_state(inp["params"], shard), tp.shard_state(inp["grads"], shard)
    out = {}
    with tp.model_parallel(shard):
        for luc in (False, True):
            opt = novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=False, luc=luc)
            state = opt.init(params)
            for _ in range(2):
                updates, state = opt.update(grads, state, params)
            out[f"luc{int(luc)}"] = (updates, state)
        out["global_norm"] = global_norm(grads)
        out["clipped"] = clip_by_global_norm(grads, inp["max_norm"])
        try:
            novograd(1e-2, fused=True).update(grads, None, params)
            out["fused_refused"] = False
        except ValueError:
            out["fused_refused"] = True
    return tp.gather_state(out, shard)


def task_tp_fit(rank, world, inp):
    from lightning_asr_torch.data.datamodule import AsrDataModule
    from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
    from lightning_asr_torch.training import checkpoint
    from lightning_asr_torch.training.callbacks import Callback
    from lightning_asr_torch.training.trainer import Trainer

    writes = []
    save = checkpoint.save_checkpoint
    checkpoint.save_checkpoint = lambda *a, **k: (writes.append(str(a[0])), save(*a, **k))[1]
    model = SmallAsr(inp["num_classes"])
    model.load_state_dict(inp["state_dict"])
    probe = inp["probe"]
    model.eval()
    with torch.no_grad():
        before = model(probe["feats"], probe["percents"])[0]
    sched = cosine_annealing_warmup_restarts(**inp["schedule"])
    trainer = Trainer(model, novograd(sched, betas=(0.8, 0.5), weight_decay=1e-3, fused=False),
                      AsrDataModule(**inp["datamodule"]), total_epochs=inp["epochs"],
                      run_dir=inp["run_dir"], log_every_n_steps=1,
                      train_wer_every_n_steps=10**6, lr_schedule=sched,
                      hparams={"labels": inp["datamodule"]["labels"]}, seed=4)
    restored = []

    class Restored(Callback):
        def on_fit_start(self, trainer, state):
            restored.append(trainer.full_state(state))

    trainer.callbacks.append(Restored())
    state = trainer.fit(resume=inp.get("resume"))
    val = trainer.validate(state)
    whole = trainer.full_state(state)
    leaked = tp.current() is not None
    model.eval()
    with torch.no_grad():
        after = model(probe["feats"], probe["percents"])[0]
    return {"state": whole, "restored": restored[0], "val": val, "writes": writes,
            "leaked": leaked, "before": before,
            "after": after, "losses": [x for e in trainer.epoch_stats for x in e["losses"]],
            "local_shapes": {k: tuple(state.params[k].shape) for k in trainer.model_shard.specs
                             if k in state.params}}


def bf16_recipe(inp, steps_batch, data_parallel: bool = False):
    """``steps`` of the training recipe (bf16, per-tensor NovoGrad, dither and
    SpecAugment) of the full-width default model from ``inp["state_dict"]``
    on ``steps_batch``, one generator for all of them: (losses, whole
    parameters)."""
    from lightning_asr_torch.models.quartznet import build_model
    from lightning_asr_torch.ops.frontend import MelFrontendConfig
    from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
    from lightning_asr_torch.training.steps import create_train_state, make_train_step

    model = build_model(inp["num_classes"], mask=True, dtype=torch.bfloat16)
    model.load_state_dict(inp["state_dict"])
    opt = novograd(cosine_annealing_warmup_restarts(**inp["schedule"]), betas=(0.8, 0.5),
                   weight_decay=1e-3, fused=False)
    step = make_train_step(model, opt, inp["num_classes"] - 1,
                           MelFrontendConfig(precision="default"), augment=True,
                           data_parallel=data_parallel)
    shard = tp.model_shard(model) if data_parallel else None
    state = tp.shard_state(create_train_state(model, opt), shard)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(inp["steps"]):
        state, metrics = step(state, steps_batch, gen)
        losses.append(float(metrics["loss"]))
    return losses, tp.gather_state(state.params, shard)


def task_tp_bf16(rank, world, inp):
    batch = rank_rows(inp["batch"], distributed.data_index(), distributed.data_size())
    losses, params = bf16_recipe(inp, batch, data_parallel=True)
    return {"losses": losses, "params": params}


def ssl_model(mode: str, num_classes: int, drop_rate: float = 0.0) -> nn.Module:
    """The ``mode`` SSL model ("feature": ``AsrModel(feature_in=512)``;
    "dual": ``DualStreamAsrModel``; "raw": ``SSLRetrainAsrModel``) with
    ``SmallEncoder`` and a 64-channel decoder in place of the full-width
    encoder and decoder."""
    from lightning_asr_torch.models.dual_stream import DualStreamAsrModel
    from lightning_asr_torch.models.quartznet import build_model
    from lightning_asr_torch.ssl_codec.retrain import SSLRetrainAsrModel

    model, in_c = {"feature": lambda: (build_model(num_classes, feature_in=512, mask=True), 64),
                   "dual": lambda: (DualStreamAsrModel(num_classes, mask=True), 128),
                   "raw": lambda: (SSLRetrainAsrModel(num_classes, mask=True), 64)}[mode]()
    model.encoder = SmallEncoder(drop_rate=drop_rate, in_c=in_c)
    model.decoder = Conv(64, num_classes, 1, bias=True)
    return model


def ssl_step(mode: str, inp: dict, batch: dict, data_parallel: bool = False,
             plain: bool = False):
    """One train step of the ``mode`` model from ``inp["state_dicts"][mode]``
    with its trainer's augmentation (the feature step's cutout, the dual
    step's dither, SpecAugment and cutout, the retrain model's cutout) and
    ``inp["drop_rate"]``, the fused NovoGrad behind ``capture``: (state,
    metrics).  ``plain`` turns every draw off (no dither, zero SpecAugment
    widths, no cutout, no dropout), so that the JAX step can be held
    against it."""
    import dataclasses
    from unittest import mock

    from lightning_asr_torch.models.dual_stream import DUAL_MEL_CONFIG
    from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
    from lightning_asr_torch.training import steps
    from lightning_asr_torch.training.steps import (create_train_state, make_dual_train_step,
                                                    make_raw_ssl_train_step, make_train_step)

    model = ssl_model(mode, inp["num_classes"], 0.0 if plain else inp["drop_rate"])
    model.load_state_dict(inp["state_dicts"][mode])
    opt = capture(novograd(cosine_annealing_warmup_restarts(**inp["schedule"]), betas=(0.8, 0.5),
                           weight_decay=1e-3, fused=True))
    blank = inp["num_classes"] - 1
    if mode == "feature":
        step = make_train_step(model, opt, blank, augment=None if plain else "cutout",
                               from_features=True, normalize=False, data_parallel=data_parallel)
    elif mode == "dual":
        mel, masks = DUAL_MEL_CONFIG, {}
        if plain:
            mel, masks = dataclasses.replace(mel, dither=0.0), dict(freq_mask=0, time_mask=0)
        step = make_dual_train_step(model, opt, blank, mel, data_parallel=data_parallel,
                                    **masks)
    else:
        model.augment_cutout = not plain
        step = make_raw_ssl_train_step(model, opt, blank, data_parallel=data_parallel)
    # the dual step's cutout has no switch, as in the JAX step
    with mock.patch.object(steps, "cutout", lambda feats, *a, **k: feats) if plain \
            else contextlib.nullcontext():
        return step(create_train_state(model, opt), batch, torch.Generator().manual_seed(7))


def task_ssl(rank, world, inp):
    return {"steps": _ssl_steps(rank, world, inp["steps"]),
            "plain_steps": _ssl_steps(rank, world, inp["steps"], plain=True),
            "pool": _ssl_pool(rank, world, inp["pool"])}


def _ssl_steps(rank, world, inp, plain: bool = False):
    out = {}
    for mode, batch in inp["batches"].items():
        state, metrics = ssl_step(mode, inp, rank_rows(batch, rank, world), data_parallel=True,
                                  plain=plain)
        out[mode] = {"state": state, "loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                     "preds": metrics["preds"], "pred_lens": metrics["pred_lens"]}
    return out


def _ssl_pool(rank, world, inp):
    from lightning_asr_torch.optim import novograd
    from lightning_asr_torch.ssl_codec.ssl_datamodule import SSLDataModule
    from lightning_asr_torch.training.ssl_trainer import SSLTrainer

    class Rows:
        def __init__(self):
            self.rows = []

        def log_metrics(self, metrics, step):
            self.rows.append(dict(metrics))

    model = ssl_model("feature", inp["num_classes"])
    model.load_state_dict(inp["state_dict"])
    trainer = SSLTrainer(model, novograd(1e-3), SSLDataModule(**inp["datamodule"]),
                         run_dir=inp["run_dir"], loggers=Rows() if rank == 0 else None,
                         pseudo_confidence_threshold=inp["threshold"])
    trainer._pseudo_pass(trainer.init_state())
    return {"pool": [(e.audio_filepath, e.text, e.duration) for e in trainer.dm.pseudo_entries],
            "logged": trainer.loggers.rows if rank == 0 else []}


def task_cli(rank, world, inp):
    from lightning_asr_torch.training import checkpoint
    from lightning_asr_torch.training.trainer import Trainer

    writes, vals = [], []
    save, validate = checkpoint.save_checkpoint, Trainer.validate
    checkpoint.save_checkpoint = lambda *a, **k: (writes.append(str(a[0])), save(*a, **k))[1]
    Trainer.validate = lambda self, state: (vals.append(validate(self, state)), vals[-1])[1]
    out = importlib.import_module(inp["module"]).main(inp["args"])
    tr = out["trainer"]
    return {"val": vals, "test": out["test"], "writes": writes, "step": int(out["state"].step),
            "data_parallel": tr.data_parallel, "batches": [e["batches"] for e in tr.epoch_stats],
            "pseudo": [(e.audio_filepath, e.text) for e in tr.dm.pseudo_entries],
            "params": out["state"].params}


def main():
    task, rank, world, port, inp, out = sys.argv[1:7]
    torch.set_num_threads(1)
    inp = torch.load(inp, weights_only=False)
    env = {"RANK": rank, "WORLD_SIZE": world, "LOCAL_RANK": rank, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": port}
    if task == "cli":                    # the entry point joins the launcher's group
        os.environ.update(env)
    else:
        distributed.init(env, "cpu", TIMEOUT_S, tp=inp.get("tp", 1) if isinstance(inp, dict) else 1)
    result = {"task_bn": task_bn, "task_step": task_step, "task_fit": task_fit,
              "task_mmap": task_mmap, "task_tp_ops": task_tp_ops, "task_tp_steps": task_tp_steps,
              "task_tp_norms": task_tp_norms, "task_tp_fit": task_tp_fit,
              "task_tp_bf16": task_tp_bf16, "task_ssl": task_ssl,
              "task_cli": task_cli}[f"task_{task}"](int(rank), int(world), inp)
    distributed.shutdown()
    torch.save(result, out)


if __name__ == "__main__":
    main()
