"""The port's per-intron depth statistics against the JAX package's.

irfinder_tpu_torch.ops.finalize_stats.device_all_stats (CPU tensors, so the
plain composition intron_stats_plain) must equal, exactly, both
irfinder_tpu.ops.finalize_stats.device_all_stats (Pallas kernels in
interpret mode on the CPU backend) and the host path
finalize._depth_stats_vectorized, on each variant's own introns: every
intron for the strand-summed variant 2, the annotation-strand subset for the
per-plane variants.  Inputs are made with numpy from a seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irfinder_tpu.ops.finalize_stats as JFS
from irfinder_tpu.finalize import _depth_stats_vectorized
from irfinder_tpu.refio.compile import compile_reference
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import kernels
from irfinder_tpu_torch.ops import finalize_stats as FS

from test_oracle import CHROMS, ROIS, toy_exons

NAMES = ("cov", "mean", "p25", "p50", "p75", "firstw", "lastw")


def _toy():
    return compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)


def _trailing_zero(base):
    """base plus one fully excluded intron owning no runs, at the END of the
    CSR (intron_run_off[i] == R), as tests/test_finalize_device.py builds it."""
    def cat(a, v):
        return np.concatenate([a, [v]]).astype(a.dtype)

    return dataclasses.replace(
        base,
        intron_chrom=cat(base.intron_chrom, 0),
        intron_start=cat(base.intron_start, 1),
        intron_end=cat(base.intron_end, 2),
        intron_strand=cat(base.intron_strand, 0),
        intron_names=list(base.intron_names) + ["G/x/clean"],
        intron_run_off=cat(base.intron_run_off, base.intron_run_off[-1]),
        intron_bstart_idx=cat(base.intron_bstart_idx, 0),
        intron_bend_idx=cat(base.intron_bend_idx, 0),
        intron_pair_idx=cat(base.intron_pair_idx, 0),
        intron_pstart_idx=cat(base.intron_pstart_idx, 0),
        intron_pend_idx=cat(base.intron_pend_idx, 0),
    )


def _one_strand(base):
    """base with every intron on strand 0: subset B is empty."""
    return dataclasses.replace(base, intron_strand=np.zeros_like(base.intron_strand))


REFS = {
    "toy": _toy,
    "synth40": lambda: synth_ref(n_genes=40),
    "trailing_zero": lambda: _trailing_zero(_toy()),
    "one_strand": lambda: _one_strand(synth_ref(n_genes=40)),
}


@pytest.fixture(scope="module")
def refs():
    return {k: fn() for k, fn in REFS.items()}


def _depth(ref, seed, hot=0):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 7, size=(2, ref.mbs_size)).astype(np.int32)
    d[rng.random((2, ref.mbs_size)) < 0.3] = 0  # coverage gaps
    if hot:
        d[:, : ref.mbs_size // 2] += hot  # saturate the capped histogram
    return d


def _own_introns(ref, flip):
    """variant -> the introns intron_table reads it on."""
    ist = ref.intron_strand.astype(np.int64)
    pa = 1 if flip else 0
    return {2: np.arange(ref.n_introns), pa: np.nonzero(ist == 0)[0], 1 - pa: np.nonzero(ist == 1)[0]}


def _assert_equal(got, want, ref, flip, what):
    for v, introns in _own_introns(ref, flip).items():
        for name, g, w in zip(NAMES, got[v], want[v]):
            np.testing.assert_array_equal(
                np.asarray(g)[introns], np.asarray(w)[introns], err_msg=f"{what} v{v} {name}"
            )
            assert np.asarray(g).dtype == np.asarray(w).dtype, (what, v, name)


def _port(ref, d, flip, cap=FS.CAP, info=None):
    fr = FS.build_finalize_ref(ref, "cpu")
    return FS.device_all_stats(ref, fr, torch.from_numpy(d), flip, cap=cap, info=info)


def _host(ref, d):
    return {v: _depth_stats_vectorized(ref, (d[0] + d[1] if v == 2 else d[v]).astype(np.int64))
            for v in (0, 1, 2)}


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("ref_name", list(REFS))
def test_matches_jax_device_stats(ref_name, flip, refs):
    ref = refs[ref_name]
    d = _depth(ref, 11)
    want = JFS.device_all_stats(ref, JFS.build_finalize_ref(ref), jnp.asarray(d), flip, interpret=True)
    _assert_equal(_port(ref, d, flip), want, ref, flip, f"{ref_name} vs jax")


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("ref_name", list(REFS))
def test_matches_host_stats(ref_name, flip, refs):
    ref = refs[ref_name]
    d = _depth(ref, 12)
    _assert_equal(_port(ref, d, flip), _host(ref, d), ref, flip, f"{ref_name} vs host")


@pytest.mark.parametrize("ref_name", ["toy", "synth40"])
def test_saturated_fallback_matches_host(ref_name, refs):
    """cap=4 sends most introns to the exact host sort over their bases."""
    ref = refs[ref_name]
    d = _depth(ref, 13, hot=20)
    info = {}
    got = _port(ref, d, True, cap=4, info=info)
    assert info["saturated"] > 0
    _assert_equal(got, _host(ref, d), ref, True, f"{ref_name} cap=4")


def test_trailing_zero_intron_stats_are_zero(refs):
    ref = refs["trailing_zero"]
    got = _port(ref, _depth(ref, 14), False)
    for v in (2, 0):
        assert all(np.asarray(col)[-1] == 0 for col in got[v])


def test_empty_subset_launches_nothing(refs, monkeypatch):
    """A one-strand ref has an empty subset B: no pass runs for it (the
    kernel must never see a zero grid), and its variant is all zeros."""
    ref = refs["one_strand"]
    sizes = []
    real = FS.intron_stats

    def spy(depth, plane_sel, sub, cap, out):
        sizes.append(sub.size)
        real(depth, plane_sel, sub, cap, out)

    monkeypatch.setattr(FS, "intron_stats", spy)
    got = _port(ref, _depth(ref, 15), False)
    assert sizes == [ref.n_introns, ref.n_introns]
    assert all(not np.asarray(col).any() for col in got[1])


def test_plain_rows_match_numpy(refs):
    """intron_stats_plain's packed rows against a direct numpy reading of
    the same runs: sums, nonzero counts, edge windows and percentile bins."""
    ref = refs["synth40"]
    d = _depth(ref, 16)
    fr = FS.build_finalize_ref(ref, "cpu")
    sub = fr.subsets["A"]
    rows = FS.intron_stats_plain(torch.from_numpy(d), 1, sub, 8).numpy()
    idx = FS._host_flat_src(ref, sub.introns)
    off = np.concatenate([[0], np.cumsum(sub.n_bases)])
    for j in range(sub.size):
        v = d[1][idx[off[j] : off[j + 1]]].astype(np.int64)
        w = min(FS.EDGE, v.size)
        hcs = np.cumsum(np.bincount(np.clip(v, 0, 7), minlength=8))
        r = FS._ridx(sub.n_bases[j : j + 1])[:, 0]
        want = [v.sum(), np.count_nonzero(v), v[:w].sum(), v[v.size - w :].sum()]
        want += [int((hcs < r[k] + 1).sum()) for k in range(3)]
        assert rows[j].tolist() == want, j


def test_kernel_wrapper_refuses_cpu_tensors(refs):
    """The CUDA wrapper never computes on the CPU: the dispatch takes the
    plain version for a CPU depth, and the wrapper itself raises."""
    ref = refs["toy"]
    fr = FS.build_finalize_ref(ref, "cpu")
    sub = fr.subsets["both"]
    out = torch.empty((sub.size, 7), dtype=torch.int64)
    before = kernels.launches["intron_stats"]
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.intron_stats(torch.from_numpy(_depth(ref, 17)), 2, sub, FS.CAP, out)
    assert kernels.launches["intron_stats"] == before
