"""The port's tensor parallelism on the CPU (``lightning_asr_torch/parallel/tp.py``,
the model groups of ``parallel/distributed.py``, the split model, steps,
optimizer, trainer and ``train.py``), against the JAX package's
``parallel/tp.py`` and against the port's own one-process step.

Ranks are worker processes of ``torch_dp_worker.py`` (torch and the port
only) in a gloo group on 127.0.0.1, in the (W / T) x T layout that the
input's ``tp`` sets; the model is ``torch_dp_worker.SmallAsr``, whose widths
(32, 48 = 32 + 2 x 8, 64) split at tp 2 and 4, and at tp 3 only where a
width is 48 (a mixed layout); at tp 4 one block of the 48-channel concat
straddles the trunk and the BiLSTM's channels.

Tolerances:
  * the split steps against the port's one-process step on the same
    global batch: the JAX package's own bounds for dp4 x tp2 against dp8
    (``tests/test_tensor_parallel.py``): loss rtol 2e-5, eval log-probs
    rtol 1e-4 / atol 1e-5, updated parameters atol 5e-4; and, since
    NovoGrad's normalisation would hide a gradient counted twice, each
    tensor's gradient within ``FEATURE_TOL`` (reduction order only, as the
    data-parallel test holds its 2 ranks);
  * dp1 x tp2 against JAX's one-device per-tensor NovoGrad step:
    ``RECIPE_TOL`` (the "default" frontend tier's bf16 rounding flips);
  * the collectives' forwards, the state round trips and the NovoGrad
    bridge: bit for bit; their gradients and the sharded optimizer and
    norms against the whole tensors': 1e-6 relative (the order of sums);
  * the recipe's bf16 steps split against whole (ROADMAP C18): the port's
    gap no more than twice the JAX package's on the same rows and steps.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.ops.frontend import MelFrontendConfig as JaxMelConfig
from lightning_asr_tpu.optim import cosine_annealing_warmup_restarts as jax_schedule
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.parallel import batch_sharding, make_mesh, shard_state
from lightning_asr_tpu.parallel.tp import set_tp_mesh
from lightning_asr_tpu.parallel.tp import tp_spec as jax_tp_spec
from lightning_asr_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from lightning_asr_tpu.training.steps import AsrTrainState as JaxState
from lightning_asr_tpu.training.steps import create_train_state as jax_create_train_state
from lightning_asr_tpu.training.steps import make_train_step as jax_make_train_step
from lightning_asr_torch.data.datamodule import AsrDataModule
from lightning_asr_torch.inference.predict import AsrTranslator
from lightning_asr_torch.models.quartznet import MODEL_REGISTRY, build_model
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
from lightning_asr_torch.optim.clipping import clip_by_global_norm
from lightning_asr_torch.optim.novograd import FlatLayout, NovogradState, global_norm
from lightning_asr_torch.parallel import distributed, tp
from lightning_asr_torch.train import main
from lightning_asr_torch.training.checkpoint import CheckpointManager, load_checkpoint
from lightning_asr_torch.training.steps import (create_train_state, make_eval_step,
                                                make_train_step)
from lightning_asr_torch.training.trainer import Trainer
from lightning_asr_torch.utils.jax_params import (_port_name, _sorted_leaves, from_jax,
                                                  opt_state_from_jax, opt_state_to_jax)
from test_torch_checkpoint_convert import _script, _teeth_weights
from test_torch_data_parallel import (BLANK, NUM_CLASSES, JaxSmallAsr, _cli_args, _fit_input,
                                      corpus, run_ranks, small_weights)
from test_torch_model import NUM_CLASSES as FULL_CLASSES
from test_torch_train_step import (FEATURE_TOL, FRONTEND, RECIPE_TOL, SCHEDULE, compare_step,
                                   jax_batch, jax_capture, make_batch, port_batch)
from torch_dp_worker import SmallAsr, bf16_recipe, capture

assert corpus and small_weights                       # fixtures, used by name
LOSS_RTOL, LOGP_RTOL, LOGP_ATOL, PARAM_ATOL = 2e-5, 1e-4, 1e-5, 5e-4
EXACT_REL = 1e-6
STEP_CONFIGS = {"plain": {}, "dropout": {"drop_rate": 0.1},
                "sepconv": {"conv_kernel": "sepconv"}, "dw_wgrad": {"conv_kernel": "dw_wgrad"}}


# --- tp_spec against the JAX package's, no processes ---

def _jax_shapes(encoder, lstm_head):
    model = jax_build_model(FULL_CLASSES, encoder, mask=True, lstm_head=lstm_head)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 64)),
                                             jnp.ones((1,)), False))


@pytest.mark.parametrize("encoder,lstm_head",
                         [(e, False) for e in MODEL_REGISTRY] + [("quartznet12_context", True)])
def test_tp_spec_equals_jax_on_every_leaf(encoder, lstm_head):
    """Every parameter and BatchNorm statistic of the encoder (and of the LSTM
    head model) splits on the port at tp 2, 3 and 4 exactly where the JAX
    ``tp_spec`` splits its flax leaf: flax's last axis of a conv kernel is
    torch's axis 0, a 1-D leaf splits on axis 0 on both sides."""
    shapes = _jax_shapes(encoder, lstm_head)
    params, stats = shapes["params"], shapes["batch_stats"]
    bn_modules = {p[:-1] for p, _ in _sorted_leaves(stats)}
    stat_names = {"mean": "running_mean", "var": "running_var"}
    jax_leaves = {}
    for tree, is_stat in ((params, False), (stats, True)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            keys = tuple(str(k.key) for k in path)
            name = (".".join(keys[:-1] + (stat_names[keys[-1]],)) if is_stat
                    else _port_name(keys, bn_modules))
            jax_leaves[name] = (path, leaf)
    port = build_model(FULL_CLASSES, encoder, mask=True, lstm_head=lstm_head)
    port_shapes = {k: tuple(t.shape) for k, t in [*port.named_parameters(), *port.named_buffers()]}
    assert port_shapes.keys() == jax_leaves.keys()
    for size in (2, 3, 4):
        split = tp.specs(port_shapes, size)
        for name, (path, leaf) in jax_leaves.items():
            spec = tuple(jax_tp_spec(path, leaf, size))
            want = 0 if "model" in spec else None
            if want is not None:
                # flax (k, in, out) splits its last axis: torch's (out, in, k) axis 0
                assert spec.index("model") == leaf.ndim - 1, (name, spec)
            assert split.get(name) == want, (size, name, spec, port_shapes[name])
        if size == 2 and not lstm_head:
            assert "encoder.last_conv.weight" in split and "decoder.weight" not in split
    # at tp 3 the default model splits its 336-channel depthwise convs only
    if encoder == "quartznet12_context" and not lstm_head:
        assert sorted(tp.specs(port_shapes, 3)) == [
            "encoder.block3.sep_last.depthwise_conv.weight"]


# --- the collectives ---

def test_gather_copy_and_split_against_one_process(tmp_path):
    """``gather_channels`` gives every rank the whole tensor bit for bit (its
    -0.0 entries too), ``split_channels`` its block; a loss that reads the
    gathered tensor through a column-parallel conv (its input behind
    ``copy_to_model_group``, its output gathered) and a replicated branch
    gives each rank its block of the one-process input gradient and its
    rows of the weight gradient: a gather whose backward summed over the
    group would count the replicated branch twice."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 8, 5), generator=gen)
    x[0, 1, :2] = -0.0
    x[2, 6, 4] = -0.0
    w = torch.randn((6, 8, 1), generator=gen)
    c_rep, c_col = torch.randn(x.shape, generator=gen), torch.randn((3, 6, 5), generator=gen)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want_loss = (F.conv1d(xs, ws) * c_col).sum() + (xs * c_rep).sum()
    want_loss.backward()
    ranks = run_ranks("tp_ops", {"x": x, "w": w, "c_rep": c_rep, "c_col": c_col, "tp": 2},
                      tmp_path)
    for out in ranks:
        i = out["index"]
        assert torch.equal(out["gathered"].view(torch.int32), x.view(torch.int32))
        assert torch.equal(out["split"], x[:, 4 * i:4 * (i + 1)])
        for got, want in ((out["x_grad"], xs.grad[:, 4 * i:4 * (i + 1)]),
                          (out["w_grad"], ws.grad[3 * i:3 * (i + 1)]),
                          (out["split_grad"], c_rep)):
            assert (got - want).abs().max() <= EXACT_REL * want.abs().max(), (got - want).abs().max()
        assert abs(out["loss"].item() - want_loss.item()) <= EXACT_REL * abs(want_loss.item())


def test_model_groups_and_layout_without_a_group():
    """No group: one rank of one model group, every helper the identity and
    no layout current."""
    assert distributed.model_size() == distributed.data_size() == 1
    assert distributed.model_index() == distributed.data_index() == 0
    x = torch.randn(2, 4, 3)
    assert tp.current() is None and not tp.sharded(4)
    assert tp.full(x, 4) is x and tp.own(x) is x and tp.column_input(x, 8) is x
    assert tp.model_sum("encoder.block1.sep_last.bn.weight", x) is x
    shard = tp.ModelShard(1, 2, {"a.bn.weight": 0})
    with tp.model_parallel(shard):
        assert tp.current() is shard and tp.sharded(4) and not tp.sharded(3)
        with tp.model_parallel(None):
            assert tp.current() is None
        assert torch.equal(tp.own_block(x), x[:, 2:])
    assert tp.current() is None
    state = {"a.bn.weight": torch.arange(6.0), "a.bn.count": torch.arange(6.0),
             "m": (torch.zeros(()), {"a.bn.weight": torch.tensor(3.0)})}
    cut = tp.shard_state(state, shard)
    assert torch.equal(cut["a.bn.weight"], torch.arange(3.0, 6.0))
    assert torch.equal(cut["a.bn.count"], state["a.bn.count"])            # not a split leaf
    assert cut["m"][1]["a.bn.weight"].item() == 3.0                         # scalar moment whole
    with pytest.raises(ValueError, match="does not split"):
        distributed.init({"RANK": "0", "WORLD_SIZE": "3", "LOCAL_RANK": "0",
                          "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}, "cpu", 1.0, tp=2)
    assert distributed.current() is None


# --- the split steps ---

BATCH_LENS, BATCH_TLENS = (15000, 11000, 13500, 9000), (14, 9, 12, 7)


def _batch():
    return make_batch(3, B=4, lens=BATCH_LENS, tlens=BATCH_TLENS)


def _per_tensor():
    return capture(novograd(cosine_annealing_warmup_restarts(**SCHEDULE), betas=(0.8, 0.5),
                            weight_decay=1e-3, fused=False))


def _one_process(state_dict, cfg):
    model = SmallAsr(NUM_CLASSES, drop_rate=cfg.get("drop_rate", 0.0),
                     conv_kernel=cfg.get("conv_kernel"))
    model.load_state_dict(state_dict)
    opt = _per_tensor()
    step = make_train_step(model, opt, BLANK, MelFrontendConfig(**FRONTEND), augment=None)
    state, metrics = step(create_train_state(model, opt), port_batch(_batch()),
                          torch.Generator().manual_seed(100))
    log_probs = make_eval_step(model, BLANK, MelFrontendConfig(**FRONTEND))(
        state, port_batch(_batch()))["log_probs"]
    return state, metrics, log_probs


def _tp_run(state_dict, tmp_path, world, size, configs):
    inp = {"num_classes": NUM_CLASSES, "state_dict": state_dict, "schedule": SCHEDULE,
           "frontend": FRONTEND, "steps": 1, "batch": port_batch(_batch()), "tp": size,
           "configs": [STEP_CONFIGS[c] for c in configs]}
    ranks = run_ranks("tp_steps", inp, tmp_path, world=world)
    return {name: [r["configs"][i] | {"rows": r["rows"]} for r in ranks]
            for i, name in enumerate(configs)}


def _global(ranks, size):
    """The metrics of a split step in global row order (one rank of each
    model group), after checking the model group's ranks agree bit for bit."""
    leads = ranks[::size]
    for lead, group in zip(leads, (ranks[i:i + size] for i in range(0, len(ranks), size))):
        for other in group[1:]:
            assert torch.equal(other["losses"], lead["losses"])
            assert torch.equal(other["log_probs"], lead["log_probs"])
            for a, b in ((lead["state"].params, other["state"].params),
                         (lead["state"].batch_stats, other["state"].batch_stats)):
                assert all(torch.equal(a[k], b[k]) for k in a)
    order = torch.argsort(torch.cat([r["rows"] for r in leads]))
    cat = lambda key: torch.cat([r[key] for r in leads])[order]  # noqa: E731
    return {"loss": leads[0]["losses"][-1], "grad_norm": leads[0]["grad_norms"][-1],
            "preds": cat("preds"), "pred_lens": cat("pred_lens"), "log_probs": cat("log_probs")}


def _compare_one_process(ranks, size, want_state, want_metrics, want_log_probs):
    got = _global(ranks, size)
    state = ranks[0]["state"]
    loss, want_loss = float(got["loss"]), float(want_metrics["loss"])
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    np.testing.assert_allclose(got["log_probs"].numpy(), want_log_probs.numpy(), rtol=LOGP_RTOL,
                               atol=LOGP_ATOL)
    tol = FEATURE_TOL[0]
    for k in want_state.params:
        err = (state.params[k] - want_state.params[k]).abs().max().item()
        assert err <= min(PARAM_ATOL, tol["params"]), (k, err)
    rel = lambda a, b: float((a - b).norm() / max(b.norm(), 1e-30))  # noqa: E731
    grads = {k: rel(state.opt_state[0][k], want_state.opt_state[0][k]) for k in want_state.params}
    worst = max(grads, key=grads.get)
    assert grads[worst] <= tol["grad"], (worst, grads[worst])
    # NovoGrad's second moments: the whole tensors' squared gradient norms
    moments, want_moments = state.opt_state[1].exp_avg_sq, want_state.opt_state[1].exp_avg_sq
    assert max(rel(moments[k], want_moments[k]) for k in moments) <= 2 * tol["grad"]
    assert rel(got["grad_norm"], want_metrics["grad_norm"]) <= tol["grad_norm"]
    assert max(rel(state.batch_stats[k], want_state.batch_stats[k])
               for k in want_state.batch_stats) <= tol["stats"]
    assert torch.equal(got["pred_lens"], want_metrics["pred_lens"])
    assert int(state.step) == 1 and int(state.opt_state[1].count) == 1
    return grads


@pytest.fixture(scope="module")
def dp1_tp2(small_weights, tmp_path_factory):
    return _tp_run(small_weights[2], tmp_path_factory.mktemp("tp2"), 2, 2, list(STEP_CONFIGS))


@pytest.mark.parametrize("config", list(STEP_CONFIGS))
def test_dp1_tp2_step_matches_one_process(small_weights, dp1_tp2, config):
    """One float32 step over a model group of 2 ranks (the trunk's widths all
    split; no dither or augmentation) against the port's one-process step
    on the same batch: plain, with dropout 0.1 (each rank keeps its rows'
    and channels' block of the one-process draw), and on both kernel routes
    (their plain versions on the CPU): the JAX package's tp bounds and each
    gradient within FEATURE_TOL; the split leaves are this rank's blocks."""
    ranks = dp1_tp2[config]
    specs = ranks[0]["specs"]
    assert "encoder.block1.sep_last.pointwise_conv.weight" in specs
    assert "encoder.context_rnn.w_ih_f" not in specs and "decoder.weight" not in specs
    assert ranks[0]["local_shapes"]["encoder.block2.sep_last.depthwise_conv.weight"] == (24, 1, 5)
    want = _one_process(small_weights[2], STEP_CONFIGS[config])
    grads = _compare_one_process(ranks, 2, *want)
    # the replicated context branch: its gradient counted once
    assert grads["encoder.context_rnn.w_hh_f"] <= FEATURE_TOL[0]["grad"]


def test_dp1_tp2_step_matches_jax_per_tensor(small_weights, dp1_tp2):
    """The dp1 x tp2 step against JAX's jitted one-device step with the
    per-tensor NovoGrad on the same global batch (``RECIPE_TOL``)."""
    params, stats, _ = small_weights
    jopt = jax_capture(jax_novograd(jax_schedule(**SCHEDULE), betas=(0.8, 0.5), weight_decay=1e-3,
                                    fused=False))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=jopt.init(params), nan_count=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(JaxSmallAsr(), jopt, BLANK, JaxMelConfig(**FRONTEND),
                                        augment=None))
    jstate, jmetrics = jstep(jstate, jax_batch(_batch()), jax.random.PRNGKey(0))
    ranks = dp1_tp2["plain"]
    compare_step(jstate, jmetrics, ranks[0]["state"], _global(ranks, 2), RECIPE_TOL[0])


@pytest.mark.parametrize("world,size", [(4, 2), (3, 3), (4, 4)])
def test_split_layouts_match_one_process(small_weights, tmp_path, world, size):
    """dp2 x tp2 (2 model groups of 2 ranks: the rows split over the data
    group, the channels over the model group), dp1 x tp3 (a mixed layout:
    only the 48-channel depthwise conv splits) and dp1 x tp4 (the 48-channel
    concat cut in blocks of 12, one straddling the trunk and the BiLSTM):
    one float32 step against the port's one-process step."""
    ranks = _tp_run(small_weights[2], tmp_path, world, size, ["plain"])["plain"]
    if size == 3:
        assert sorted(ranks[0]["specs"]) == ["encoder.block2.sep_last.depthwise_conv.weight"]
    _compare_one_process(ranks, size, *_one_process(small_weights[2], {}))


# --- the recipe's bf16 steps, split against whole (ROADMAP C18) ---

# 8 rows of 0.3 s (the fewest the 8-device test mesh takes, each shorter
# than the padding), the recipe's 4 steps and schedule, the sample that the
# one-LSB change moves
C18_ROWS, C18_SECONDS, C18_STEPS, C18_BUMP = 8, 0.3, 4, (0, 1000)
C18_SCHEDULE = dict(first_cycle_steps=1000, cycle_mult=2, max_lr=1e-2, min_lr=1e-4,
                    warmup_steps=5, gamma=0.5)
# the port's gap stays clearly below the 1.0 of a split step that moved
# nothing (it read 0.44, JAX's 0.52)
C18_NO_OP_MARGIN = 0.8


def _update_rel(old, got, want) -> float:
    """The relative difference of the whole update: |got - want| / |want -
    old| over all the leaves (the card's smoke prints this measure)."""
    num = sum(float(np.sum((np.float64(g) - np.float64(w)) ** 2)) for g, w in zip(got, want))
    den = sum(float(np.sum((np.float64(w) - np.float64(o)) ** 2)) for w, o in zip(want, old))
    return (num / den) ** 0.5


def _jax_bf16_params(state0, step, batch, mesh, split: bool):
    """``C18_STEPS`` jitted recipe steps on ``mesh`` (with the trunk's
    activations pinned to its model axis when ``split``): the leaves."""
    set_tp_mesh(mesh if split else None)
    try:
        sharded = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in batch.items()}
        state, fn = shard_state(state0, mesh), jax.jit(step)
        for i in range(C18_STEPS):
            state, _ = fn(state, sharded, jax.random.fold_in(jax.random.PRNGKey(1), i))
        return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(
            jax.device_get(state.params))]
    finally:
        set_tp_mesh(None)


def test_bf16_split_gap_against_jax(tmp_path, capsys):
    """C18: the recipe's 4 bf16 steps (per-tensor NovoGrad, dither,
    SpecAugment) of the full-width model on 8 rows, split over a model
    group of 2 against the whole model: the JAX package's dp4 x tp2 against
    its dp8 on the test mesh, the port's dp1 x tp2 (gloo) against its one
    process, the relative difference of the whole update printed beside
    each package's own move under a one-LSB change of one sample.  The
    bf16 sums in another order are carried through 16 train-mode
    BatchNorms: both packages part about as far as a one-LSB change moves
    them, so the port's gap may be at most twice the JAX package's."""
    lens = tuple(int(n) for n in np.random.default_rng(0).integers(4000, 4700, C18_ROWS))
    batch = make_batch(7, B=C18_ROWS, seconds=C18_SECONDS, lens=lens, tlens=(5,) * C18_ROWS)
    bumped = {k: v.copy() for k, v in batch.items()}
    bumped["waves"][C18_BUMP] += 1
    jmodel = jax_build_model(FULL_CLASSES, "quartznet12_context", mask=True, dtype=jnp.bfloat16)
    jopt = jax_novograd(jax_schedule(**C18_SCHEDULE), betas=(0.8, 0.5), weight_decay=1e-3,
                        fused=False)
    state0 = jax_create_train_state(jmodel, jopt, jax.random.PRNGKey(0), feature_shape=(1, 128, 64))
    jstep = jax_make_train_step(jmodel, jopt, FULL_CLASSES - 1, JaxMelConfig(precision="default"),
                                augment=True)
    dp8 = make_mesh(8)
    dp4_tp2 = make_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    j_old = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(state0.params)]
    j_whole = _jax_bf16_params(state0, jstep, batch, dp8, False)
    j_gap = _update_rel(j_old, _jax_bf16_params(state0, jstep, batch, dp4_tp2, True), j_whole)
    j_lsb = _update_rel(j_old, _jax_bf16_params(state0, jstep, bumped, dp8, False), j_whole)

    inp = {"num_classes": FULL_CLASSES, "schedule": C18_SCHEDULE, "steps": C18_STEPS,
           "state_dict": from_jax(jax.device_get(state0.params),
                                  jax.device_get(state0.batch_stats)),
           "batch": port_batch(batch), "tp": 2}
    ranks = run_ranks("tp_bf16", inp, tmp_path)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in ranks[0]["params"])
    _, whole = bf16_recipe(inp, port_batch(batch))
    _, moved = bf16_recipe(inp, port_batch(bumped))
    keys = list(whole)
    leaves = lambda tree: [tree[k].float().numpy() for k in keys]  # noqa: E731
    p_old = leaves(inp["state_dict"])
    p_gap = _update_rel(p_old, leaves(ranks[0]["params"]), leaves(whole))
    p_lsb = _update_rel(p_old, leaves(moved), leaves(whole))
    with capsys.disabled():
        print(json.dumps({"c18": {"rows": C18_ROWS, "seconds": C18_SECONDS, "steps": C18_STEPS,
                                  "jax_dp4_tp2_vs_dp8": j_gap, "jax_one_lsb_move": j_lsb,
                                  "port_dp1_tp2_vs_one_process": p_gap,
                                  "port_one_lsb_move": p_lsb}}))
    # a split step that left the parameters where they were reads exactly 1.0
    assert np.isfinite(p_gap) and p_gap <= min(2 * j_gap, C18_NO_OP_MARGIN), \
        (p_gap, j_gap, j_lsb, p_lsb)


# --- the optimizer's norms ---

def test_per_tensor_novograd_and_clipping_on_a_split_tree(tmp_path):
    """The per-tensor NovoGrad (two updates, with and without LUC),
    ``global_norm`` and ``clip_by_global_norm`` on each rank's blocks,
    gathered, against the whole tree's; the fused variant refuses to run
    split."""
    gen = torch.Generator().manual_seed(1)
    model = SmallAsr(NUM_CLASSES)
    params = {k: torch.randn(p.shape, generator=gen) for k, p in model.named_parameters()}
    grads = {k: torch.randn(p.shape, generator=gen) for k, p in params.items()}
    max_norm = 0.5 * float(global_norm(grads))
    ranks = run_ranks("tp_norms", {"params": params, "grads": grads, "max_norm": max_norm,
                                   "tp": 2}, tmp_path)
    rel = lambda a, b: float((a - b).norm() / max(b.norm(), 1e-30))  # noqa: E731
    for out in ranks:
        assert out["fused_refused"]
        for luc in (False, True):
            opt = novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=False, luc=luc)
            state = opt.init(params)
            for _ in range(2):
                updates, state = opt.update(grads, state, params)
            got_updates, got_state = out[f"luc{int(luc)}"]
            for k in params:
                assert rel(got_updates[k], updates[k]) <= EXACT_REL, (luc, k)
                assert rel(got_state.exp_avg[k], state.exp_avg[k]) <= EXACT_REL, (luc, k)
                assert rel(got_state.exp_avg_sq[k], state.exp_avg_sq[k]) <= EXACT_REL, (luc, k)
        assert rel(out["global_norm"], global_norm(grads)) <= EXACT_REL
        clipped = clip_by_global_norm(grads, max_norm)
        assert all(rel(out["clipped"][k], clipped[k]) <= EXACT_REL for k in grads)


# --- the trainer, the checkpoints, the CLI ---

def _probe():
    gen = torch.Generator().manual_seed(3)
    return {"feats": torch.randn((2, 40, 64), generator=gen), "percents": torch.tensor([1.0, 0.7])}


def _tp_fit_input(corpus, state_dict, run_dir, epochs, resume=None):
    return {**_fit_input(corpus, state_dict, run_dir), "epochs": epochs, "resume": resume,
            "probe": _probe(), "tp": 2}


def _one_process_trainer(corpus, state_dict, run_dir, epochs):
    model = SmallAsr(NUM_CLASSES)
    model.load_state_dict(state_dict)
    sched = cosine_annealing_warmup_restarts(**SCHEDULE)
    inp = _fit_input(corpus, state_dict, run_dir)
    return Trainer(model, novograd(sched, betas=(0.8, 0.5), weight_decay=1e-3, fused=True),
                   AsrDataModule(**inp["datamodule"]), total_epochs=epochs, run_dir=run_dir,
                   log_every_n_steps=1, train_wer_every_n_steps=10**6, lr_schedule=sched,
                   hparams={"labels": inp["datamodule"]["labels"]}, seed=4)


def _assert_migrated(per_tensor: NovogradState, fused, params):
    """A per-tensor NovoGrad state equal bit for bit to a fused one."""
    layout = FlatLayout(params)
    assert int(per_tensor.count) == int(fused.count)
    for k, m in layout.unflatten(fused.exp_avg).items():
        assert torch.equal(per_tensor.exp_avg[k], m), k
    for field in ("exp_avg_sq", "max_exp_avg_sq"):
        vec = getattr(fused, field)
        assert all(torch.equal(getattr(per_tensor, field)[k], vec[i])
                   for i, k in enumerate(layout.names)), field


def test_checkpoints_cross_dp_and_tp_and_no_layout_leaks(corpus, small_weights, tmp_path):
    """One process trains an epoch with the fused NovoGrad and writes
    ``last``; a dp1 x tp2 trainer resumes from it (its restored state,
    gathered, is the checkpoint's bit for bit, the NovoGrad state migrated to
    the per-tensor variant), trains a second epoch and writes ``last`` once,
    from rank 0, with whole tensors; one process resumes from that (its
    parameters the tp ranks' bit for bit, the state migrated back to the
    fused variant) and ``AsrTranslator`` loads it.  After the tp fit no
    layout is current and a one-process forward gives the bits it gave
    before (the JAX trainer's ``test_trainer_does_not_leak_tp_mesh``)."""
    state_dict = small_weights[2]
    dp = _one_process_trainer(corpus, state_dict, tmp_path / "dp", 1)
    dp_state = dp.fit()
    ranks = run_ranks("tp_fit", _tp_fit_input(corpus, state_dict, tmp_path / "tp", 2,
                                              str(tmp_path / "dp" / "checkpoints" / "last")),
                      tmp_path)
    r0, r1 = ranks
    for out in ranks:
        restored = out["restored"]
        for k, v in dp_state.params.items():
            assert torch.equal(restored.params[k], v), k
        for k, v in dp_state.batch_stats.items():
            assert torch.equal(restored.batch_stats[k], v), k
        _assert_migrated(restored.opt_state, dp_state.opt_state, dp_state.params)
        assert not out["leaked"] and torch.equal(out["before"], out["after"])
        assert out["local_shapes"]["encoder.block1.sep_last.bn.weight"] == (16,)
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2 and r0["val"] == r1["val"]
    assert [len(r["writes"]) for r in ranks] == [1, 0]
    assert all(torch.equal(r0["state"].params[k], r1["state"].params[k]) for k in r0["state"].params)
    last = tmp_path / "tp" / "checkpoints" / "last"
    sd, meta = load_checkpoint(last)
    assert meta["epoch"] == 1
    for k, v in {**r0["state"].params, **r0["state"].batch_stats}.items():
        assert torch.equal(sd[k], v), k

    back = _one_process_trainer(corpus, state_dict, tmp_path / "back", 2)
    back_state = back.fit(resume=str(last))
    assert int(back_state.step) == int(r0["state"].step) == 4
    for k, v in r0["state"].params.items():
        assert torch.equal(back_state.params[k], v), k
    _assert_migrated(r0["state"].opt_state, back_state.opt_state, back_state.params)


def test_cli_trains_over_a_model_group_of_two(corpus, tmp_path, monkeypatch):
    """``python -m lightning_asr_torch.train --device cpu train.tp=2
    train.n_devices=2`` through ``main()``: rank 0 starts rank 1, the two
    split the full-width model's trunk (per-tensor NovoGrad), train one step
    of 8 rows each, validate and test; rank 0 alone writes ``last``, with
    whole tensors, which ``AsrTranslator`` serves; the group is gone after."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run = tmp_path / "run"
    out = main(_cli_args(corpus, run) + ["train.tp=2", "train.n_devices=2", "--device", "cpu"])
    assert distributed.current() is None and tp.current() is None
    trainer, state = out["trainer"], out["state"]
    assert trainer.model_shard is not None and trainer.model_shard.size == 2
    assert isinstance(state.opt_state, NovogradState) and int(state.step) == 1
    assert state.params["encoder.last_conv.weight"].shape == (512, 512, 1)
    assert np.isfinite(out["test"]["test_loss"])
    sd, _ = load_checkpoint(run / "checkpoints" / "last")
    full = dict(trainer.model.state_dict())
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in full.items()}
    for k in ("decoder.weight", "encoder.context_rnn.w_ih_f"):        # replicated leaves
        assert torch.equal(sd[k], state.params[k])
    assert torch.equal(sd["encoder.last_conv.weight"][:512], state.params["encoder.last_conv.weight"])
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert sum("train_loss" in r for r in rows) == 1 and "test_wer" in rows[-1]
    translator = AsrTranslator(run / "checkpoints" / "last", device="cpu")
    wave = (np.random.default_rng(5).standard_normal(8000) * 0.1).astype(np.float32)
    assert isinstance(translator.transcribe_batch([wave])[0], str)


# --- the per-tensor NovoGrad state of a JAX checkpoint ---

def test_jax_per_tensor_novograd_state_crosses_bit_for_bit(tmp_path):
    """A JAX train state with the per-tensor NovoGrad (the tp variant) after
    one update: ``opt_state_from_jax`` gives the port's ``NovogradState``
    leaf by leaf (kernels transposed, scalars as they are) and
    ``opt_state_to_jax`` gives the JAX trees back, bit for bit; the Orbax
    checkpoint through ``scripts/torch_from_jax_ckpt.py`` restores into a
    per-tensor template as that state, and into a fused one migrated."""
    params, stats = _teeth_weights("quartznet12_context", 5)
    opt = jax_novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=False)
    rng = np.random.default_rng(6)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    opt_state = jax.device_get(jax.jit(lambda g, p: opt.update(g, opt.init(p), p)[1])(grads, params))
    model = build_model(FULL_CLASSES, "quartznet12_context", mask=True)
    port_params = {k: p.detach() for k, p in model.named_parameters()}
    got = opt_state_from_jax(opt_state, params, stats, port_params)
    assert isinstance(got, NovogradState) and list(got.exp_avg) == list(port_params)
    sd = from_jax(params, stats)
    for k in port_params:
        assert got.exp_avg[k].shape == sd[k].shape, k
    w = "encoder.block1.sep_last.pointwise_conv.weight"
    np.testing.assert_array_equal(
        got.exp_avg[w].numpy(),
        np.transpose(opt_state.exp_avg["encoder"]["block1"]["sep_last"]["pointwise_conv"]["kernel"]))
    back = opt_state_to_jax(got, port_params, {k: sd[k] for k, _ in model.named_buffers()})
    for field in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
        want = dict(_sorted_leaves(getattr(opt_state, field)))
        have = dict(_sorted_leaves(back[field]))
        assert want.keys() == have.keys(), field
        assert all(np.array_equal(want[p], have[p]) for p in want), field
    assert int(back["count"]) == int(opt_state.count) == 1

    state = JaxState(step=jnp.ones((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=opt_state, nan_count=jnp.zeros((), jnp.int32))
    JaxCheckpointManager(tmp_path / "jax", top_k=1).save(
        state, epoch=0, metrics={}, hparams={"encoder": "quartznet12_context"})
    out = _script("torch_from_jax_ckpt").main(["--jax-ckpt", str(tmp_path / "jax" / "last"),
                                               "--out", str(tmp_path / "port")])
    template = create_train_state(model, novograd(1e-2, fused=False))
    restored, _ = CheckpointManager(tmp_path / "r").restore(template, str(out))
    assert int(restored.opt_state.count) == 1
    for field in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
        assert all(torch.equal(getattr(restored.opt_state, field)[k], getattr(got, field)[k])
                   for k in port_params), field
    fused, _ = CheckpointManager(tmp_path / "f").restore(
        create_train_state(model, novograd(1e-2, fused=True)), str(out))
    _assert_migrated(got, fused.opt_state, template.params)
