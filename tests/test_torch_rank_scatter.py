"""The port's plain rank and scatter ops against the JAX package's TPU kernels.

irfinder_tpu_torch/ops/rank.py:block_ranks is held against
irfinder_tpu/ops/pallas_rank.py:block_ranks_pallas, and
irfinder_tpu_torch/ops/scatter.py:scatter_add against
irfinder_tpu/ops/scatter.py:scatter_add_pallas, both Pallas kernels run in
interpret mode on the CPU as their own tests run them.  Inputs are made with
numpy from a seed; every comparison is integer and exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from irfinder_tpu.ops.pallas_rank import block_ranks_pallas, build_rank_tables
from irfinder_tpu.ops.scatter import TILE, W, scatter_add_pallas
from irfinder_tpu_torch.ops.device_ref import PAD_CHROM, from_columns
from irfinder_tpu_torch.ops.rank import block_ranks
from irfinder_tpu_torch.ops.scatter import pad_len, scatter_add

OH = 5
N_CHROMS = 4
EMPTY_CHROM = 1  # a chrom with no spans and no points


def _tables(rng):
    """Disjoint sorted spans and boundary points (with duplicates) over
    N_CHROMS chroms, one of which has none."""
    chroms, starts, lens = [], [], []
    pts_c, pts_v = [], []
    for c in range(N_CHROMS):
        if c == EMPTY_CHROM:
            continue
        pos = int(rng.integers(100, 300))  # leaves room before the first span/point
        for _ in range(int(rng.integers(100, 200))):
            pos += int(rng.integers(1, 50))
            ln = int(rng.integers(1, 40))
            chroms.append(c)
            starts.append(pos)
            lens.append(ln)
            pos += ln
        vs = np.sort(rng.integers(200, 4000, size=150))
        vs[10] = vs[11]  # a duplicate key
        pts_c.append(np.full(len(vs), c, np.int32))
        pts_v.append(vs.astype(np.int32))
    chrom = np.array(chroms, np.int32)
    start = np.array(starts, np.int32)
    ln = np.array(lens, np.int32)
    off = np.concatenate([[0], np.cumsum(ln)]).astype(np.int32)
    return chrom, start, ln, off[:-1], int(off[-1]), np.concatenate(pts_c), np.concatenate(pts_v)


def _port_ref(chrom, start, ln, off, mbs, pts_c, pts_v):
    seg = np.searchsorted(chrom, np.arange(N_CHROMS + 1), side="left")
    chrom_base = np.append(off, mbs)[seg[:-1]].astype(np.int32)

    def sent(a, first):
        return np.append(a, PAD_CHROM if first else 0).astype(np.int32)

    cols = {
        "uspan_chrom": sent(chrom, True), "uspan_start": sent(start, False),
        "uspan_len": sent(ln, False), "uspan_off": np.append(off, mbs).astype(np.int32),
        "chrom_base": chrom_base,
        "point_chrom": sent(pts_c, True), "point_coord": sent(pts_v, False),
        "roi_chrom": np.array([PAD_CHROM], np.int32), "roi_start": np.zeros(1, np.int32),
        "roi_end": np.zeros(1, np.int32), "mbs_size_static": mbs,
    }
    return from_columns(cols, "cpu")


def _queries(rng, chrom, start, ln, pts_v, nq=512):
    qc = rng.integers(-1, N_CHROMS + 1, size=nq).astype(np.int32)  # pads, empty and absent chroms
    qs = rng.integers(0, 4200, size=nq).astype(np.int32)
    qe = qs + rng.integers(0, 200, size=nq).astype(np.int32)  # some shorter than 2*OH
    k = nq // 8
    # block edges exactly at span starts / ends
    qc[:k], qs[:k], qe[:k] = chrom[:k], start[:k], start[:k] + ln[:k]
    # e - OH before the chrom's first point (and e - OH < 0)
    qc[k : 2 * k], qs[k : 2 * k] = 0, 0
    qe[k : 2 * k] = rng.integers(2 * OH, 100, size=k)
    # block edges at boundary points (side='left' / 'right' ties)
    p = pts_v[rng.integers(0, pts_v.size, size=k)]
    qc[2 * k : 3 * k], qs[2 * k : 3 * k], qe[2 * k : 3 * k] = 0, p - OH, p + OH
    qc[3 * k : 4 * k] = -1  # explicit pad lanes
    return qc, qs, qe


@pytest.mark.parametrize("seed", [0, 1])
def test_block_ranks_match_pallas(seed):
    rng = np.random.default_rng(seed)
    chrom, start, ln, off, mbs, pts_c, pts_v = _tables(rng)
    qc, qs, qe = _queries(rng, chrom, start, ln, pts_v)
    strand = rng.integers(0, 2, size=qc.size).astype(np.int32)
    P = int(pts_c.size)

    lo_j, hi_j, sp_j = block_ranks_pallas(
        build_rank_tables(chrom, start, "mbs", len_col=ln, off_col=off),
        build_rank_tables(pts_c, pts_v, "point"),
        jnp.asarray(qc), jnp.asarray(qs), jnp.asarray(qe), jnp.asarray(strand),
        OH, P, interpret=True,
    )
    dref = _port_ref(chrom, start, ln, off, mbs, pts_c, pts_v)
    t = torch.from_numpy
    lo, hi, sp = block_ranks(dref, t(qc), t(qs), t(qe), t(strand), OH, P)

    # the kernel leaves pad lanes raw (its caller masks them); the port ranks
    # them at mbs, the trash rank
    real = qc >= 0
    np.testing.assert_array_equal(lo.numpy()[real], np.asarray(lo_j)[real], err_msg="lo")
    np.testing.assert_array_equal(hi.numpy()[real], np.asarray(hi_j)[real], err_msg="hi")
    assert (lo.numpy()[~real] == mbs).all() and (hi.numpy()[~real] == mbs).all()
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_j), err_msg="spans")
    assert sp.dtype == torch.int32 and lo.dtype == torch.int32
    # the crafted cases really occur
    assert ((qc >= 0) & (qe - qs < 2 * OH)).any()
    assert (qc == EMPTY_CHROM).any() and (qc == N_CHROMS).any()


@pytest.mark.parametrize(
    "m_raw,n,seed",
    [
        (TILE, 1000, 0),  # single tile
        (3 * TILE + 17, 5000, 1),  # several tiles, unpadded raw length
        (2 * TILE, 3 * W + 5, 2),  # window remainder
    ],
)
def test_scatter_add_matches_pallas(m_raw, n, seed):
    rng = np.random.default_rng(seed)
    m = pad_len(m_raw)
    base = rng.integers(-50, 50, size=m).astype(np.int32)
    idx = rng.integers(0, m_raw, size=n).astype(np.int32)
    val = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    want = scatter_add_pallas(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(val), interpret=True)
    got = scatter_add(torch.from_numpy(base.copy()), torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_add_duplicates_hotspots_and_sentinels():
    """Duplicate-heavy updates on a few slots across a tile boundary, plus
    sentinel indices >= M, which both versions ignore."""
    rng = np.random.default_rng(7)
    m = pad_len(2 * TILE)
    slots = np.array([0, 5, TILE - 1, TILE, TILE + 1, m - 1, m, m + 123], np.int32)
    idx = rng.choice(slots, size=4 * W).astype(np.int32)
    val = np.where(rng.random(idx.size) < 0.5, 1, -1).astype(np.int32)
    want = scatter_add_pallas(jnp.zeros(m, jnp.int32), jnp.asarray(idx), jnp.asarray(val), interpret=True)
    got = scatter_add(torch.zeros(m, dtype=torch.int32), torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (idx >= m).any()
