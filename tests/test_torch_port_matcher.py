"""The port's assignment solver against the JAX package's, on the CPU.

`solve_assignment_plain` (the plain version of M1, `csrc/matcher.cu`) gives
`lwdetr_tpu.models.matcher.solve_assignment`'s columns exactly, tolerance
none, on the same f32 cost and the same `n_rows`: random normal costs over
the (T, Q) sweep of `tests/test_matcher.py`, integer costs in {0, 1, 2}
(ties everywhere), constant padded rows, and NaN / inf rows (the JAX loop's
finite 1e15 and its one-hot contractions). On finite costs its total is
scipy's within 1e-5 relative. `hungarian_match` gives `jmatcher.hungarian_match`'s
indices exactly on costs that are bit-equal in both frameworks (dyadic boxes,
an L1 cost). Inputs are made from numpy seeds.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from lwdetr_tpu.models import matcher as jmatcher
from lwdetr_tpu_torch.models import matcher as tmatcher

SWEEP = [(1, 5), (4, 4), (7, 20), (30, 100), (100, 300)]


def _jax_columns(cost: np.ndarray, n: int) -> np.ndarray:
    return np.asarray(jmatcher.solve_assignment(jnp.asarray(cost), n_rows=jnp.int32(n)))[:n]


def _port_columns(costs: np.ndarray, ns) -> np.ndarray:
    return tmatcher.solve_assignment_plain(torch.from_numpy(costs),
                                           torch.tensor(ns)).numpy()


def _check_equal_to_jax(costs: np.ndarray, ns):
    """All problems in one lockstep call against the JAX loop one by one."""
    got = _port_columns(costs, ns)
    for k, (cost, n) in enumerate(zip(costs, ns)):
        np.testing.assert_array_equal(got[k, :n], _jax_columns(cost, n), err_msg=f"problem {k}")
        assert not got[k, n:].any(), "rows past n_rows hold 0"
    return got


@pytest.mark.parametrize("t,q", SWEEP)
def test_plain_solver_gives_the_jax_columns_and_scipys_total(t, q):
    rng = np.random.default_rng(t * 1000 + q)
    costs = (rng.standard_normal((3, t, q)) * 10).astype(np.float32)
    ns = [t, max(t - 1, 0), t // 2]
    got = _check_equal_to_jax(costs, ns)
    ri, ci = linear_sum_assignment(costs[0])
    total, ref = costs[0][np.arange(t), got[0]].sum(), costs[0][ri, ci].sum()
    assert total == pytest.approx(ref, rel=1e-5, abs=1e-5)
    assert len(set(got[0].tolist())) == t


def test_plain_solver_breaks_ties_as_jax_on_integer_costs():
    rng = np.random.default_rng(1)
    costs = rng.integers(0, 3, (6, 12, 30)).astype(np.float32)
    ns = [12, 11, 7, 3, 1, 0]
    got = _check_equal_to_jax(costs, ns)
    for k, n in enumerate(ns[:4]):
        ri, ci = linear_sum_assignment(costs[k, :n])
        assert costs[k, np.arange(n), got[k, :n]].sum() == costs[k, ri, ci].sum()


def test_plain_solver_with_constant_padded_rows():
    rng = np.random.default_rng(5)
    costs = np.zeros((2, 10, 15), np.float32)
    costs[:, :6] = rng.standard_normal((2, 6, 15))
    costs[1, 6:] = 0.25
    _check_equal_to_jax(costs, [6, 6])
    # and every row augmented, the padded ones too
    _check_equal_to_jax(costs, [10, 10])


@pytest.mark.parametrize("where", ["valid_row", "padded_row", "inf_entry", "all_rows"])
def test_plain_solver_gives_the_jax_columns_on_non_finite_costs(where):
    """NaN (and inf) costs: the JAX loop ends on its finite 1e15, and its
    one-hot contractions spread a non-finite entry to its whole column."""
    rng = np.random.default_rng(11)
    costs = rng.standard_normal((4, 8, 12)).astype(np.float32)
    if where == "valid_row":
        costs[:, 2] = np.nan
    elif where == "padded_row":
        costs[:, 7] = np.nan
    elif where == "inf_entry":
        costs[:, 1, 3] = np.inf
        costs[:, 4, 5] = -np.inf
    else:
        costs[:] = np.nan
    got = _check_equal_to_jax(costs, [6, 6, 8, 3])
    for k, n in enumerate([6, 6, 8, 3]):
        assert len(set(got[k, :n].tolist())) == n, "distinct columns on any input"


def test_hungarian_match_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    B, G, Qg, T = 3, 2, 20, 7
    cost = torch.from_numpy(rng.standard_normal((4, B, T, G * Qg)).astype(np.float32))
    valid = torch.arange(T)[None, :] < torch.tensor([[7], [0], [3]])
    before = tmatcher.assignment_kernel.launches
    with mock.patch.object(tmatcher, "match_cost_matrix", lambda *a: cost):
        out = tmatcher.hungarian_match(torch.zeros(4, B, G * Qg, 5), torch.zeros(4, B, G * Qg, 4),
                                       torch.zeros(B, T, dtype=torch.long), torch.zeros(B, T, 4),
                                       valid, group_detr=G)
    assert out.dtype == torch.int64 and out.shape == (4, B, G, T)
    assert torch.equal(out, tmatcher.assign_plain(cost, valid, G))
    assert tmatcher.assignment_kernel.launches == before
    assert tmatcher.assignment_kernel._fn is None
    per = cost[0, 0, :7, Qg:].numpy()  # image 0, group 1: its columns, offset by Qg
    np.testing.assert_array_equal(out[0, 0, 1].numpy() - Qg, _jax_columns(per, 7))


# -- hungarian_match on bit-equal costs ------------------------------------------------------------


def _l1_cost_jax(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid, *costs):
    c = jnp.sum(jnp.abs(pred_boxes[:, None, :] - tgt_boxes[None, :, :]), axis=-1)
    return jnp.where(tgt_valid[None, :], c, 0.0).T


def _l1_cost_port(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid, *costs):
    c = (pred_boxes[..., :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    return c.masked_fill(~tgt_valid[:, None, :], 0.0).transpose(-1, -2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hungarian_match_gives_the_jax_indices_on_bit_equal_costs(seed):
    """Boxes on a 1/16 grid make the L1 cost exact in both frameworks, and
    ties frequent; the grouping, the valid counts and the offsets are the
    matcher's own."""
    rng = np.random.default_rng(seed)
    S, B, G, Qg, K, T = 2, 3, 3, 12, 5, 8
    logits = rng.standard_normal((S, B, G * Qg, K)).astype(np.float32)
    boxes = (rng.integers(1, 16, (S, B, G * Qg, 4)) / 16).astype(np.float32)
    labels = rng.integers(0, K, (B, T)).astype(np.int32)
    tboxes = (rng.integers(1, 16, (B, T, 4)) / 16).astype(np.float32)
    valid = np.arange(T)[None, :] < np.array([[5], [8], [0]])
    with mock.patch.object(tmatcher, "match_cost_matrix", _l1_cost_port):
        got = tmatcher.hungarian_match(torch.from_numpy(logits), torch.from_numpy(boxes),
                                       torch.from_numpy(labels), torch.from_numpy(tboxes),
                                       torch.from_numpy(valid), group_detr=G).numpy()
    assert got.shape == (S, B, G, T)
    with mock.patch.object(jmatcher, "match_cost_matrix", _l1_cost_jax):
        for s in range(S):
            ref = np.asarray(jmatcher.hungarian_match.__wrapped__(
                jnp.asarray(logits[s]), jnp.asarray(boxes[s]), jnp.asarray(labels),
                jnp.asarray(tboxes), jnp.asarray(valid), group_detr=G))
            for b in range(B):
                n = int(valid[b].sum())
                np.testing.assert_array_equal(got[s, b, :, :n], ref[b, :, :n])
                assert not got[s, b, :, n:].any()
