"""The port's per-intron depth statistics against the JAX package's.

irfinder_tpu_torch.ops.finalize_stats.device_all_stats (CPU tensors, so the
plain composition all_stats_plain) must equal, exactly, both
irfinder_tpu.ops.finalize_stats.device_all_stats (Pallas kernels in
interpret mode on the CPU backend) and the host path
finalize._depth_stats_vectorized, on each variant's own introns: every
intron for the strand-summed variant 2, the annotation-strand subset for the
per-plane variants.  The port gets each reference converted from the JAX
package's (convert.compiled_ref_from_numpy).  Inputs are made with numpy
from a seed; every comparison is integer or float64 and exact.

The CUDA kernel itself runs only on the card (chip_smoke.py).  Here its work
items (build_items) are walked by a numpy model of the kernel
(``_kernel_model``) and held to all_stats_plain, split introns included.
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
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from irfinder_tpu_torch.ops import finalize_stats as FS
from irfinder_tpu_torch.ops import step as tstep
from irfinder_tpu_torch.ops.device_ref import build_device_ref

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


def _unstranded(base):
    """base with every fifth intron on strand 2 ('.'): in subset "both"
    only, with no strand row."""
    st = base.intron_strand.copy()
    st[::5] = 2
    return dataclasses.replace(base, intron_strand=st)


REFS = {
    "toy": _toy,
    "synth40": lambda: synth_ref(n_genes=40),
    "trailing_zero": lambda: _trailing_zero(_toy()),
    "one_strand": lambda: _one_strand(synth_ref(n_genes=40)),
    "unstranded": lambda: _unstranded(synth_ref(n_genes=40)),
}


def port_ref(ref):
    """The port's CompiledRef of a JAX package reference, carried as data."""
    return compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})


@pytest.fixture(scope="module")
def refs():
    return {k: fn() for k, fn in REFS.items()}


@pytest.fixture(scope="module")
def prefs(refs):
    return {k: port_ref(r) for k, r in refs.items()}


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


def _padded(d):
    """d as finalize_device lays the depth out: rows padded to 4 words."""
    return tstep.depth_rows(torch.from_numpy(
        np.concatenate([d[:, :1], np.diff(d, axis=1), np.zeros((2, 1), d.dtype)], axis=1)))


def _host(ref, d):
    return {v: _depth_stats_vectorized(ref, (d[0] + d[1] if v == 2 else d[v]).astype(np.int64))
            for v in (0, 1, 2)}


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("ref_name", list(REFS))
def test_matches_jax_device_stats(ref_name, flip, refs, prefs):
    ref = refs[ref_name]
    d = _depth(ref, 11)
    want = JFS.device_all_stats(ref, JFS.build_finalize_ref(ref), jnp.asarray(d), flip, interpret=True)
    _assert_equal(_port(prefs[ref_name], d, flip), want, ref, flip, f"{ref_name} vs jax")


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("ref_name", list(REFS))
def test_matches_host_stats(ref_name, flip, refs, prefs):
    ref = refs[ref_name]
    d = _depth(ref, 12)
    _assert_equal(_port(prefs[ref_name], d, flip), _host(ref, d), ref, flip, f"{ref_name} vs host")


@pytest.mark.parametrize("ref_name", ["toy", "synth40"])
def test_saturated_fallback_matches_host(ref_name, refs, prefs):
    """cap=4 sends most introns to the exact host sort over their bases."""
    ref = refs[ref_name]
    d = _depth(ref, 13, hot=20)
    info = {}
    got = _port(prefs[ref_name], d, True, cap=4, info=info)
    assert info["saturated"] > 0
    _assert_equal(got, _host(ref, d), ref, True, f"{ref_name} cap=4")


def test_trailing_zero_intron_stats_are_zero(prefs):
    ref = prefs["trailing_zero"]
    got = _port(ref, _depth(ref, 14), False)
    for v in (2, 0):
        assert all(np.asarray(col)[-1] == 0 for col in got[v])


def test_empty_subset_launches_nothing(prefs, monkeypatch):
    """A one-strand ref has an empty subset B: the plain version runs no
    pass for it, the kernel's items carry no strand-B row, and its variant
    is all zeros."""
    ref = prefs["one_strand"]
    sizes = []
    real = FS.intron_stats_plain

    def spy(depth, plane_sel, sub, cap):
        sizes.append(sub.size)
        return real(depth, plane_sel, sub, cap)

    monkeypatch.setattr(FS, "intron_stats_plain", spy)
    got = _port(ref, _depth(ref, 15), False)
    assert sizes == [ref.n_introns, ref.n_introns]
    assert all(not np.asarray(col).any() for col in got[1])
    fr = FS.build_finalize_ref(ref, "cpu")
    slots = fr.items().table.numpy()[:, FS.ITEM_FIELDS.index("slot_s")]
    assert fr.n_rows == 2 * ref.n_introns and slots.max() < fr.n_rows


def test_plain_rows_match_numpy(prefs):
    """intron_stats_plain's packed rows against a direct numpy reading of
    the same runs: sums, nonzero counts, edge windows and percentile bins."""
    ref = prefs["synth40"]
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


def test_kernel_wrapper_refuses_cpu_tensors(prefs):
    """The CUDA wrapper never computes on the CPU: the dispatch takes the
    plain version for a CPU depth, and the wrapper itself raises."""
    ref = prefs["toy"]
    fr = FS.build_finalize_ref(ref, "cpu")
    out = torch.empty((fr.n_rows, 7), dtype=torch.int64)
    before = kernels.launches["intron_stats"]
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.intron_stats(_padded(_depth(ref, 17)), fr.items(), fr.subsets["both"], 0, FS.CAP, out)
    assert kernels.launches["intron_stats"] == before
    FS.launch_all_stats(fr, _padded(_depth(ref, 17)), False)
    assert kernels.launches["intron_stats"] == before


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("ref_name", ["unstranded", "toy", "trailing_zero"])
def test_all_stats_plain_matches_jax_and_host(ref_name, flip, refs, prefs):
    """all_stats_plain's packed rows, finished on the host, equal the JAX
    package's device statistics (Pallas in interpret mode) and the host path,
    on a padded depth, including introns on strand '.' (no strand row)."""
    ref, pref = refs[ref_name], prefs[ref_name]
    d = _depth(ref, 18)
    fr = FS.build_finalize_ref(pref, "cpu")
    depth = _padded(d)
    assert torch.equal(depth, torch.from_numpy(d))
    rows = FS.all_stats_plain(depth, fr, FS.subset_planes(flip)["A"], FS.CAP)
    assert rows.shape == (fr.n_rows, 7) and rows.dtype == torch.int64
    got = FS.finish_all_stats(pref, fr, depth, flip, rows.numpy())
    want = JFS.device_all_stats(ref, JFS.build_finalize_ref(ref), jnp.asarray(d), flip, interpret=True)
    _assert_equal(got, want, ref, flip, f"{ref_name} all_stats_plain vs jax")
    _assert_equal(got, _host(ref, d), ref, flip, f"{ref_name} all_stats_plain vs host")
    if ref_name == "unstranded":
        assert fr.n_rows < 2 * ref.n_introns


def _kernel_model(fr, depth, plane_a, cap, chunk):
    """A numpy model of csrc/stats.cu: walk the work items of ``chunk`` as
    the kernel does (first segment from the record, later runs from the run
    table), feed the "both" row and the strand row, merge a split intron's
    items, and take each percentile bin from the touched bins [0, top) plus
    cap - top when the intron's total is below the target."""
    F = {n: i for i, n in enumerate(FS.ITEM_FIELDS)}
    tab = fr.items(chunk).table.numpy().astype(np.int64)
    _, rs, rl = fr.runs_host
    d0, d1 = (depth[k].numpy().astype(np.int64) for k in (0, 1))
    acc = {}
    for rec in tab:
        n = rec[F["n"]]
        w = min(n, FS.EDGE)
        idx, done, s, ln, r = [], 0, rec[F["seg_start"]], rec[F["seg_len"]], rec[F["run"]]
        while done < rec[F["count"]]:
            idx.append(np.arange(s, s + ln))
            done += ln
            if done < rec[F["count"]]:
                r += 1
                s, ln = rs[r], min(rl[r], rec[F["count"]] - done)
        idx = np.concatenate(idx) if idx else np.zeros(0, np.int64)
        loc = rec[F["loc0"]] + np.arange(idx.size)
        rows = [(rec[F["intron"]], ((d0[idx] + d1[idx] + 2**31) % 2**32) - 2**31)]
        if rec[F["slot_s"]] >= 0:
            rows.append((rec[F["slot_s"]], (d1 if plane_a ^ rec[F["strand"]] else d0)[idx]))
        for slot, v in rows:
            a = acc.setdefault(slot, [np.zeros(4, np.int64), np.zeros(cap, np.int64), rec])
            a[0] += [v.sum(), np.count_nonzero(v), v[loc < w].sum(), v[loc >= n - w].sum()]
            np.add.at(a[1], np.clip(v, 0, cap - 1), 1)
    out = np.zeros((fr.n_rows, 7), np.int64)
    for slot, (sums, h, rec) in acc.items():
        top = int(np.nonzero(h)[0].max()) + 1 if h.any() else 0
        cs = np.cumsum(h[:top])
        tgts = rec[F["ridx0"] : F["ridx2"] + 1] + 1
        out[slot, :4] = sums
        out[slot, 4:] = [(cs < t).sum() + (cap - top if rec[F["n"]] < t else 0) for t in tgts]
    return out


@pytest.mark.parametrize("ref_name,chunk", [
    ("unstranded", FS.CHUNK), ("unstranded", 97), ("unstranded", 1000),
    ("trailing_zero", FS.CHUNK), ("trailing_zero", 97), ("trailing_zero", 1),
])
def test_kernel_model_matches_plain(ref_name, chunk, prefs):
    """The work items of every chunk, walked as the kernel walks them (split
    introns merged), give all_stats_plain's rows, flip both ways, at cap
    2048 and 4."""
    ref = prefs[ref_name]
    fr = FS.build_finalize_ref(ref, "cpu")
    depth = _padded(_depth(ref, 19, hot=3000 if chunk == 97 else 0))
    for flip in (False, True):
        for cap in (FS.CAP, 4):
            pa = FS.subset_planes(flip)["A"]
            np.testing.assert_array_equal(
                _kernel_model(fr, depth, pa, cap, chunk),
                FS.all_stats_plain(depth, fr, pa, cap).numpy(), err_msg=f"flip={flip} cap={cap}")


@pytest.mark.parametrize("ref_name,chunk", [
    ("synth40", FS.CHUNK), ("synth40", 97), ("trailing_zero", 1),
])
def test_work_items_cover_every_base_once(ref_name, chunk, prefs):
    """Each intron's items tile its bases [0, n) in chunk-sized pieces, each
    record's first segment lies inside its run, records run in genomic
    order, and exactly the introns of more than one item carry a split
    id."""
    ref = prefs[ref_name]
    fr = FS.build_finalize_ref(ref, "cpu")
    it = fr.items(chunk)
    assert it is fr.items(chunk) and it.chunk == chunk and it.n_rows == fr.n_rows
    t = it.table.numpy().astype(np.int64)
    F = {n: i for i, n in enumerate(FS.ITEM_FIELDS)}
    cnt = t[:, F["count"]]
    assert cnt.max() <= chunk
    order = np.lexsort((t[:, F["loc0"]], t[:, F["intron"]]))
    assert (order == np.arange(len(t))).all()
    _, rs, rl = fr.runs_host
    run, off = t[:, F["run"]], t[:, F["off"]]
    live = cnt > 0
    assert (t[live, F["seg_start"]] == rs[run[live]] + off[live]).all()
    assert (off[live] + t[live, F["seg_len"]] <= rl[run[live]]).all()
    for i in range(ref.n_introns):
        mine = t[t[:, F["intron"]] == i]
        mine = mine[np.argsort(mine[:, F["loc0"]])]
        n = fr.n_bases[i]
        assert mine[:, F["count"]].sum() == n
        assert (mine[:, F["loc0"]] == chunk * np.arange(len(mine))).all()
        split = mine[:, F["split"]]
        assert (split >= 0).all() == (len(mine) > 1) and len(set(split)) == 1
    assert it.n_split == int((fr.n_bases > chunk).sum())
    assert int(it.split_items.numpy().sum()) == int((t[:, F["split"]] >= 0).sum())


def test_depth_rows_are_padded_and_unchanged(refs, prefs):
    """finalize_device's depth holds the JAX package's values, in rows whose
    stride is a multiple of 4 words; the kernel wrapper's layout check takes
    it and refuses an unpadded (2, mbs) depth."""
    from irfinder_tpu.ops import step as jstep
    from irfinder_tpu.ops.device_ref import build_device_ref as jax_build_device_ref

    ref, pref = refs["synth40"], prefs["synth40"]
    jd = jax_build_device_ref(ref)
    jc = jstep.init_counters(jd, len(ref.chroms))
    lay = jstep.CounterLayout.build(jd)
    rng = np.random.default_rng(20)
    cnt = np.zeros(lay.total, np.int32)
    cnt[lay.off_dd : lay.off_dd + 2 * lay.w_dd] = rng.integers(-3, 4, 2 * lay.w_dd)
    jc = {"cnt": jnp.asarray(cnt), "chr": jc["chr"]}
    want = np.asarray(jstep.finalize_device(jd, jc)["depth"])
    td = build_device_ref(pref, "cpu")
    got = tstep.finalize_device(td, {"cnt": torch.from_numpy(cnt), "chr": torch.zeros(2, dtype=torch.int32)})
    depth = got["depth"]
    assert depth.shape == want.shape and depth.stride(0) % kernels.ROW_ALIGN == 0 and depth.stride(1) == 1
    np.testing.assert_array_equal(depth.numpy(), want)
    kernels.check_depth(depth)
    mbs = pref.mbs_size
    bad = torch.zeros((2, mbs + (1 if mbs % 4 == 0 else 0)), dtype=torch.int32)
    with pytest.raises(ValueError, match="row stride"):
        kernels.check_depth(bad)
