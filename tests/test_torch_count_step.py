"""The port's counting step and finalize against the JAX package's, and the
conversion of JAX device state into the port.

irfinder_tpu_torch/ops/step.py runs its plain path here (CPU tensors); the
JAX step runs on the CPU backend.  The same numpy batches go to both.  Every
counter is an integer and every merge add-associative: all comparisons are
exact (tolerance 0).  The port gets the reference converted from the JAX
package's (convert.compiled_ref_from_numpy).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from irfinder_tpu.io.batch import device_batch
from irfinder_tpu.ops import step as jstep
from irfinder_tpu.ops.device_ref import build_device_ref as jax_build_device_ref
from irfinder_tpu.synth import synth_batch_arrays, synth_ref
from irfinder_tpu_torch import kernels
from irfinder_tpu_torch.convert import (
    compiled_ref_from_numpy, counters_from_numpy, device_ref_from_numpy,
)
from irfinder_tpu_torch.ops import step as tstep
from irfinder_tpu_torch.ops.device_ref import COLUMNS, build_device_ref

N_FRAGS = 384


@pytest.fixture(scope="module")
def setup():
    ref = synth_ref(n_genes=24, chrom_len=1_500_000)
    batches = [device_batch(synth_batch_arrays(ref, n_frags=N_FRAGS, seed=s)[0]) for s in range(4)]
    # an edge batch: pad lanes, chrom -1, blocks shorter than 2*OH, both
    # strands, refids past the header, fragments on the ROIs
    rng = np.random.default_rng(11)
    e = {k: v.copy() for k, v in batches[0].items()}
    B, F = e["blk_chrom"].size, e["frag_chrom"].size
    e["blk_chrom"][: B // 4] = -1
    e["blk_end"][B // 4 : B // 2] = e["blk_start"][B // 4 : B // 2] + rng.integers(0, 10, B // 4)
    e["blk_strand"][:] = rng.integers(0, 2, B)
    e["frag_refid"][: F // 8] = len(ref.chroms) + 3
    e["frag_refid"][F // 8 : F // 4] = -1
    e["frag_start"][F // 4 : F // 2] = rng.integers(0, 55_000, F // 4)
    e["frag_end"][F // 4 : F // 2] = e["frag_start"][F // 4 : F // 2] + 400
    e["frag_chrom"][F // 4 : F // 2] = 0
    batches.append(e)
    return ref, batches


def _jax_run(ref, batches, counters=None):
    dref = jax_build_device_ref(ref)
    c = counters or jstep.init_counters(dref, len(ref.chroms))
    step = jax.jit(jstep.count_step)
    for b in batches:
        c = step(dref, c, {k: jnp.asarray(v) for k, v in b.items()})
    return dref, c


def port_ref(ref):
    """The port's CompiledRef of a JAX package reference, carried as data."""
    return compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})


def _port_run(ref, batches, counters=None):
    dref = build_device_ref(port_ref(ref), "cpu")
    c = counters or tstep.init_counters(dref, len(ref.chroms))
    for b in batches:
        tstep.count_step(dref, c, {k: torch.from_numpy(v) for k, v in b.items()})
    return dref, c


def test_count_step_matches_jax(setup):
    ref, batches = setup
    jd, jc = _jax_run(ref, batches)
    kernels.reset_launches()
    td, tc = _port_run(ref, batches)
    assert kernels.launches["count_blocks"] == 0  # CPU tensors take the plain path
    assert tstep.CounterLayout.build(td).total == jstep.CounterLayout.build(jd).total
    for k in ("cnt", "chr"):
        assert tc[k].dtype == torch.int32
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    assert np.abs(np.asarray(jc["cnt"])).sum() > 0

    jf = jstep.finalize_device(jd, jc)
    tf = tstep.finalize_device(td, tc)
    assert set(jf) == set(tf)
    for k in jf:
        assert tf[k].dtype == torch.int32, k
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), err_msg=k)


def test_device_ref_from_jax_columns(setup):
    ref, _ = setup
    jd = jax_build_device_ref(ref)
    cols = {k: np.asarray(getattr(jd, k)) for k in COLUMNS}
    got = device_ref_from_numpy(cols, "cpu")
    want = build_device_ref(port_ref(ref), "cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_counters_continue_from_jax_mid_stream(setup):
    """JAX counters taken mid-stream, continued in the port, end equal to a
    JAX-only run over the whole stream."""
    ref, batches = setup
    _, jc_all = _jax_run(ref, batches)
    _, jc_mid = _jax_run(ref, batches[:2])
    carried = counters_from_numpy({k: np.asarray(v) for k, v in jc_mid.items()}, "cpu")
    _, tc = _port_run(ref, batches[2:], counters=carried)
    for k in ("cnt", "chr"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc_all[k]), err_msg=k)


def test_kernel_wrapper_refuses_cpu_tensors(setup):
    """The CUDA wrapper launches or raises: a CPU tensor never reaches a
    silent plain path through it."""
    ref, batches = setup
    dref = build_device_ref(port_ref(ref), "cpu")
    lay = tstep.CounterLayout.build(dref)
    cnt = torch.zeros(lay.total, dtype=torch.int32)
    cols = [torch.from_numpy(batches[0][k]) for k in ("blk_chrom", "blk_start", "blk_end", "blk_strand")]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.count_blocks(dref, cnt, *cols, lay, 5)
    with pytest.raises(TypeError):
        counters_from_numpy({"cnt": np.zeros(4, np.int64), "chr": np.zeros(2, np.int32)})
