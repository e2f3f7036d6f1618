"""Parity: the port's CTC loss (``lightning_asr_torch/ops/ctc_kernels.py``,
the autograd Function over the plain versions of kernels K4 and K5) against
the JAX package's ``ops.ctc.ctc_loss`` (the scan) and ``ctc_loss_pallas``
(interpret mode), on the same numpy inputs, on the CPU: per-sample losses
and their gradient with respect to ``log_probs``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.ops.ctc import ctc_loss as jax_ctc_scan
from lightning_asr_tpu.ops.ctc_pallas import ctc_loss_pallas
from lightning_asr_torch.ops.ctc_kernels import (ctc_alpha, ctc_alpha_plain, ctc_beta,
                                                 ctc_loss)

C = 7
BLANK = C - 1


def _log_probs(rng, B, T):
    x = rng.standard_normal((B, T, C)).astype(np.float32) * 2.0
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


# rows: (input_len, targets); L is the longest target, zero-padded
CASES = {
    # ragged lengths, a repeated label (no skip between the two 2s), a
    # single label
    "ragged_repeats": (24, [(24, [1, 2, 2, 3, 0]), (17, [4, 4, 4]), (9, [5]), (20, [0, 1, 0, 1])]),
    # an empty target (only final state 0), input_len == 0 (loss 0, zero
    # gradient), input_len == 1, and a row using every frame
    "empty_and_zero_len": (12, [(12, []), (0, [1, 2]), (1, [3]), (12, [2, 3, 2, 3, 2])]),
    # impossible alignments: 4 repeated labels need 7 frames, 3 distinct
    # need 3; both get the same finite loss as the reference, 1e30
    "impossible": (10, [(6, [1, 1, 1, 1]), (2, [1, 2, 3]), (10, [1, 2]), (3, [4, 4])]),
}


def _case(name):
    T, rows = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    B = len(rows)
    L = max(1, max(len(r[1]) for r in rows))
    lp = _log_probs(rng, B, T)
    targets = np.zeros((B, L), np.int32)
    for b, (_, tgt) in enumerate(rows):
        targets[b, :len(tgt)] = tgt
    in_lens = np.array([r[0] for r in rows], np.int32)
    tgt_lens = np.array([len(r[1]) for r in rows], np.int32)
    upstream = rng.uniform(0.5, 1.5, B).astype(np.float32)
    return lp, in_lens, targets, tgt_lens, upstream


def _port(fn, lp, in_lens, targets, tgt_lens, upstream):
    x = torch.from_numpy(lp).requires_grad_(True)
    losses = fn(x, torch.from_numpy(in_lens), torch.from_numpy(targets),
                torch.from_numpy(tgt_lens), BLANK)
    (losses * torch.from_numpy(upstream)).sum().backward()
    return losses.detach().numpy(), x.grad.numpy()


def _jax(fn, lp, in_lens, targets, tgt_lens, upstream):
    args = tuple(map(jnp.asarray, (in_lens, targets, tgt_lens)))
    losses = np.asarray(fn(jnp.asarray(lp), *args, BLANK))
    grad = np.asarray(jax.grad(lambda x: jnp.sum(fn(x, *args, BLANK) * upstream))(jnp.asarray(lp)))
    return losses, grad


@pytest.mark.parametrize("name", sorted(CASES))
def test_ctc_loss_matches_jax(name):
    lp, in_lens, targets, tgt_lens, upstream = _case(name)
    args = (lp, in_lens, targets, tgt_lens, upstream)
    loss, grad = _port(ctc_loss, *args)
    want_loss, want_grad = _jax(ctc_loss_pallas, *args)
    # float32 on both sides with the same log-space recursion; the sums of
    # three exponentials and the logs round alike, the max differences are a
    # few ulps of losses of order 10-50
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-4, atol=1e-5)
    assert np.all(np.isfinite(loss))
    for b in np.flatnonzero(in_lens == 0):
        assert loss[b] == 0.0 and np.all(grad[b] == 0.0)
    for b, n in enumerate(in_lens):
        assert np.all(grad[b, n:] == 0.0)             # no gradient past a row's length

    # JAX's scan CTC: the same losses where a row has frames (the scan keeps
    # frame 0's loss at input_len == 0); the gradients agree where the
    # alignment is possible
    jscan_loss, jscan_grad = _jax(jax_ctc_scan, *args)
    live = in_lens > 0
    np.testing.assert_allclose(loss[live], jscan_loss[live], rtol=1e-5, atol=1e-5)
    possible = live & (want_loss < 1e29)
    np.testing.assert_allclose(grad[possible], jscan_grad[possible], rtol=1e-4, atol=1e-5)


def test_impossible_alignment_is_the_reference_sentinel():
    lp, in_lens, targets, tgt_lens, upstream = _case("impossible")
    loss, _ = _port(ctc_loss, lp, in_lens, targets, tgt_lens, upstream)
    want, _ = _jax(ctc_loss_pallas, lp, in_lens, targets, tgt_lens, upstream)
    assert loss[0] == loss[1] == np.float32(1e30)
    np.testing.assert_array_equal(loss[:2], want[:2])
    assert np.all(loss[2:] < 1e3)


@pytest.mark.parametrize("name", ["ragged_repeats", "empty_and_zero_len"])
def test_plain_beta_gradient_equals_autograd_through_plain_alpha(name):
    """K5's plain version against autograd through K4's plain loop."""
    lp, in_lens, targets, tgt_lens, upstream = _case(name)
    x = torch.from_numpy(lp).requires_grad_(True)
    lens, tg, tl = map(torch.from_numpy, (in_lens, targets, tgt_lens))
    _, ll = ctc_alpha_plain(x, lens, tg, tl, BLANK)
    losses = torch.where(lens > 0, -ll, torch.zeros_like(ll))
    (losses * torch.from_numpy(upstream)).sum().backward()
    _, grad = _port(ctc_loss, lp, in_lens, targets, tgt_lens, upstream)
    # float32; the beta recursion and autograd's chain of softmax weights
    # round differently
    np.testing.assert_allclose(grad, x.grad.numpy(), rtol=1e-4, atol=2e-6)


def test_ctc_wrappers_check_and_count():
    lp, in_lens, targets, tgt_lens, _ = _case("ragged_repeats")
    lp_t, il, tg, tl = map(torch.from_numpy, (lp, in_lens, targets, tgt_lens))
    before = (ctc_alpha.launches, ctc_beta.launches)
    alpha, ll = ctc_alpha(lp_t, il, tg, tl, BLANK)
    assert alpha.shape == (4, 24, 2 * targets.shape[1] + 1) and ll.shape == (4,)
    with pytest.raises(ValueError):
        ctc_alpha(lp_t.double(), il, tg, tl, BLANK)
    with pytest.raises(ValueError):
        ctc_alpha(lp_t, il.long(), tg, tl, BLANK)
    with pytest.raises(ValueError):
        ctc_alpha(lp_t, il, tg, tl, C)
    with pytest.raises(ValueError):
        ctc_beta(lp_t, il, tg, tl, alpha[:, :3], ll, torch.ones(4), BLANK)
    assert (ctc_alpha.launches, ctc_beta.launches) == before   # CPU runs never count
