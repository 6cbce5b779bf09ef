"""The count kernel's search tree (irfinder_tpu_torch/ops/device_ref.py
search_tree) against ``torch.searchsorted``.

``tree_rank_plain`` models the kernel's search step for step: a binary
search over the level it stages in shared memory, then one node per level
below.  Which level the kernel stages depends on the table's size, so every
level is tried as the staged one.  Both sides (lower bound for ``plo``,
upper bound for ``phi`` and the span ranks) on every key, key +- 1, keys of
negative coords, queries near INT64_MIN, the sentinel and random queries.
Tables of sizes around each tree-level boundary, and the key tables of a
config-A-like and a 3-chrom synthetic reference.  ``_walk`` models the
kernel's walk from one rank to the next (csrc/count.cu walk), which gives
a block's end ranks from its start ranks.  Integer results, exact.
"""

import numpy as np
import pytest
import torch

from irfinder_tpu_torch.ops.device_ref import (
    FANOUT, INT64_MAX, PAD_CHROM, build_device_ref, make_key, search_tree, tree_rank_plain,
)
from irfinder_tpu_torch.synth import synth_ref

SIZES = [1, 2, 15, 16, 17, 255, 256, 257, 4097]
REFS = {
    "config_a_like": dict(n_genes=800),
    "three_chroms": dict(n_genes=60, n_chroms=3, chrom_len=3_000_000),
}


def _random_keys(n: int, rng) -> torch.Tensor:
    """n sorted keys over chroms -1..4 with negative and duplicate coords,
    the last one the sentinel row, as every key table ends."""
    c = rng.integers(-1, 5, n - 1).astype(np.int32)
    v = rng.integers(-(2**31), 2**31 - 1, n - 1).astype(np.int32)
    if n > 3:
        c[1], v[1] = c[0], v[0]  # a duplicate key
    k = np.sort(make_key(c, v))
    return torch.from_numpy(np.append(k, make_key(np.int32(PAD_CHROM), np.int32(0))))


def _queries(keys: torch.Tensor, rng) -> torch.Tensor:
    edge = torch.tensor([-(2**63), -(2**63) + 1, -(2**62), -1, 0, 1,
                         int(make_key(np.int32(PAD_CHROM), np.int32(2**31 - 1)))], dtype=torch.int64)
    rand = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, 2000, dtype=np.int64))
    near = keys[torch.from_numpy(rng.integers(0, keys.numel(), 2000))]
    near = near + torch.from_numpy(rng.integers(-50, 50, 2000))
    return torch.cat([keys, keys - 1, keys + 1, edge, rand, near])


def _check(keys: torch.Tensor, rng) -> tuple:
    tree, levels = search_tree(keys)
    assert tree.dtype == torch.int64 and tree.numel() == sum(levels)
    assert levels[0] == FANOUT and all(n % FANOUT == 0 for n in levels)
    assert levels[-1] > keys.numel() and torch.equal(tree[-levels[-1] :][: keys.numel()], keys)
    offs = np.cumsum((0,) + levels)
    for lvl in range(len(levels)):
        assert int(tree[offs[lvl + 1] - 1]) == INT64_MAX  # every level ends in the pad key
    q = _queries(keys, rng)
    assert (q < INT64_MAX).all()
    for right in (False, True):
        want = torch.searchsorted(keys, q, right=right)
        for start in range(len(levels)):
            got = tree_rank_plain(tree, levels, q, right, start)
            assert torch.equal(got, want), (right, start)
    return levels


@pytest.mark.parametrize("n", SIZES)
def test_tree_rank_matches_searchsorted(n):
    rng = np.random.default_rng(n)
    levels = _check(_random_keys(n, rng), rng)
    assert len(levels) == max(1, int(np.ceil(np.log(n + 1) / np.log(FANOUT))))


def _walk(level0: torch.Tensor, start: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """#keys <= q over level 0, from ``start``, the rank of a query no
    greater than q: decided by the two keys at start, else -1."""
    k0 = level0[start]
    k1 = level0[(start + 1).clamp(max=level0.numel() - 1)]
    return torch.where(k1 <= q, -1, start + (k0 <= q).to(torch.int64))


@pytest.mark.parametrize("n", SIZES)
def test_walk_matches_searchsorted(n):
    """A block's end (or end - OH) query from its start's rank, either side:
    decided exactly when fewer than two keys lie between, and then equal to
    the upper bound."""
    rng = np.random.default_rng(100 + n)
    keys = _random_keys(n, rng)
    tree, levels = search_tree(keys)
    level0 = tree[-levels[-1] :]
    q1 = _queries(keys, rng)
    q1 = q1[q1 < INT64_MAX - 5000]
    q2 = q1 + torch.from_numpy(rng.integers(0, 3000, q1.numel()))
    q2[: keys.numel()] = keys + 1  # across one key, and the sentinel
    want = torch.searchsorted(keys, q2, right=True)
    for right in (False, True):
        start = torch.searchsorted(keys, q1, right=right)
        got = _walk(level0, start, q2)
        decided = got >= 0
        assert torch.equal(decided, want - start < 2)
        assert torch.equal(got[decided], want[decided])
        assert decided.any() and (n < 3 or (~decided).any())


@pytest.mark.parametrize("kind", list(REFS))
def test_tree_rank_on_reference_tables(kind):
    dref = build_device_ref(synth_ref(**REFS[kind]), "cpu")
    rng = np.random.default_rng(7)
    for keys, tree, levels in ((dref.uspan_key, dref.uspan_tree, dref.uspan_levels),
                               (dref.point_key, dref.point_tree, dref.point_levels)):
        assert search_tree(keys)[1] == levels and torch.equal(search_tree(keys)[0], tree)
        # the key column is the front of the tree's level 0, stored once
        assert keys.data_ptr() == tree[-levels[-1] :].data_ptr() and keys.is_contiguous()
        _check(keys, rng)
    assert torch.equal(dref.uspan_rec, torch.stack([dref.uspan_len, dref.uspan_off], 1))
    assert dref.uspan_len.data_ptr() == dref.uspan_rec.data_ptr()
    assert dref.uspan_off.data_ptr() == dref.uspan_rec[:, 1].data_ptr()
