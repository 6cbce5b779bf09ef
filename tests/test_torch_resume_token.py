"""The port's decoder resume tokens (io/bampy.py, native/bamdecode.py).

Resuming either of the port's decoders from a batch's token reproduces the
rest of the stream exactly; tokens cross between the two decoders and between
the two packages (one binary format); the native decoder's resume seeks
instead of inflating the skipped prefix; a corrupt token or an offset beyond
the end is refused.
"""

import dataclasses
import struct

import numpy as np
import pytest

from irfinder_tpu.io import bampy as jbampy
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.native import bamdecode as jbamdecode
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch.io import bampy
from irfinder_tpu_torch.native import bamdecode

COLS = (
    "blk_chrom", "blk_start", "blk_end", "blk_strand",
    "gap_chrom", "gap_start", "gap_end", "gap_strand",
    "frag_chrom", "frag_refid", "frag_start", "frag_end", "frag_strand", "frag_nblk",
)
CAP = 512


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ref = synth_ref(n_genes=40)
    path = str(tmp_path_factory.mktemp("resume") / "mix.bam")
    write_realistic_bam(path, ref, n_pairs=6_000, seed=3)
    return path, {c: i for i, c in enumerate(ref.chroms)}


def decode(pkg: str, decoder: str, path: str, ci: dict, token=None):
    """(batches, stats) of one package's decoder, resumed from ``token``."""
    if decoder == "native":
        mod = bamdecode if pkg == "port" else jbamdecode
        _, b, st = mod.decode_bam_native(path, ci, cap_frags=CAP, resume_token=token)
        return list(b), st
    mod = bampy if pkg == "port" else jbampy
    with open(path, "rb") as fh:
        _, b, st = mod.decode_bam(fh, ci, cap_frags=CAP, resume_token=token)
        return list(b), st


def assert_stream_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x.n_blocks, x.n_gaps, x.n_frags, x.n_reads) == (y.n_blocks, y.n_gaps, y.n_frags, y.n_reads)
        for k in COLS:
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k), err_msg=k)


@pytest.mark.parametrize("k", [0, 3, 7])
@pytest.mark.parametrize("decoder", ["python", "native"])
def test_token_round_trip(decoder, k, setup):
    path, ci = setup
    full, st_full = decode("port", decoder, path, ci)
    assert k < len(full) - 1 and full[k].resume_token
    resumed, st_res = decode("port", decoder, path, ci, token=full[k].resume_token)
    assert_stream_equal(full[k + 1 :], resumed)
    a, b = dataclasses.asdict(st_full), dataclasses.asdict(st_res)
    for key in ("reads_total", "reads_admitted", "fragments", "pairs", "singles"):
        assert a[key] == b[key], key


@pytest.mark.parametrize("made_by, resumed_by", [
    (("port", "python"), ("port", "native")),
    (("port", "native"), ("port", "python")),
    (("port", "python"), ("jax", "native")),
    (("jax", "native"), ("port", "python")),
    (("port", "native"), ("jax", "python")),
    (("jax", "python"), ("port", "native")),
])
def test_tokens_cross_decoders_and_packages(made_by, resumed_by, setup):
    """A token made by one decoder of one package resumes in the other
    decoder, and in the other package."""
    path, ci = setup
    full, _ = decode(*made_by, path, ci)
    k = len(full) // 2
    resumed, _ = decode(*resumed_by, path, ci, token=full[k].resume_token)
    assert_stream_equal(full[k + 1 :], resumed)


def test_native_resume_skips_inflation(setup):
    """The resumed native decoder inflates only the remaining blocks."""
    path, ci = setup
    full, st_full = decode("port", "native", path, ci)
    _, st_res = decode("port", "native", path, ci, token=full[-2].resume_token)
    assert st_res.blocks_inflated < max(4, st_full.blocks_inflated // 2), (
        st_res.blocks_inflated, st_full.blocks_inflated)


@pytest.mark.parametrize("fault", ["magic", "truncated", "beyond_eof"])
@pytest.mark.parametrize("decoder", ["python", "native"])
def test_bad_token_refused(decoder, fault, setup):
    """A mangled token, a truncated one, or one whose offset lies past the
    end of the BAM fails with an error, never with a silent stream."""
    path, ci = setup
    tok = bytearray(decode("port", "python", path, ci)[0][2].resume_token)
    if fault == "magic":
        tok[0] ^= 0xFF
    elif fault == "truncated":
        tok = tok[: len(tok) // 2]
    else:
        struct.pack_into("<Q", tok, 4, 1 << 60)
    with pytest.raises((ValueError, struct.error), match="magic|token|offset|buffer|unpack"):
        decode("port", decoder, path, ci, token=bytes(tok))


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("cap", [64, 700])
def test_resume_from_every_batch(cap, threads, setup):
    """The native decoder's token after every batch of a decode in small
    batches resumes the same remaining batches and final counts as the
    uninterrupted decode, and is byte-equal to the JAX package's native
    decoder's token at the same batch.  The decoder frames records into
    chunks of ~2,000; a batch here holds ~130, so most tokens fall inside a
    chunk, and many carry a pending mate or a fragment carried over."""
    path, ci = setup
    _, b, st_full = bamdecode.decode_bam_native(path, ci, cap_frags=cap, n_threads=threads)
    full = list(b)
    _, b, _ = jbamdecode.decode_bam_native(path, ci, cap_frags=cap, n_threads=threads)
    jax = list(b)
    assert len(full) == len(jax) > 8
    pending = carried = 0
    offsets = set()
    for k, (x, y) in enumerate(zip(full, jax)):
        tok = x.resume_token
        assert tok == y.resume_token, k
        offsets.add(struct.unpack_from("<Q", tok, 4)[0])
        pending += tok[52]
        carried += tok[53] > 0
        if k == len(full) - 1:
            break
        _, b, st_res = bamdecode.decode_bam_native(
            path, ci, cap_frags=cap, n_threads=threads, resume_token=tok)
        assert_stream_equal(full[k + 1 :], list(b))
        for key in ("reads_total", "reads_admitted", "fragments", "pairs", "singles"):
            assert getattr(st_res, key) == getattr(st_full, key), (k, key)
    assert len(offsets) == len(full)
    if cap == 64:
        assert pending > 3 and carried > 3
