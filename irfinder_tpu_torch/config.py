"""Run configuration: one dataclass with a CLI mirror (SURVEY.md §5.6).

The reference's configuration surface was bash getopts in `bin/IRFinder`
plus positional argv on the C++ binary [R]; here every knob that affects a
counting run lives in RunConfig, constructed by the CLI (cli.py) or directly
by library users, and threaded through engine.run_bam / run_multi_bam.
Flag names follow the reference where behavior overlaps (-r, -d, mode names).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunConfig:
    #: fragments per device batch (static shape; decoders emit early when any
    #: column fills — io/batch.py)
    cap_frags: int = 1 << 15
    #: use the native C++ decoder for file paths (falls back to Python)
    use_native: bool = True
    #: worker threads for the native decoder's BGZF inflate + parse.
    #: None = auto: 4 for single-sample runs; multi-sample mode budgets
    #: ~2 threads per vCPU across ALL samples.  An explicit value is always
    #: honored (run_multi_bam warns if it oversubscribes the host).
    decoder_threads: int | None = None
    #: snapshot file for resumable runs (None = no checkpointing)
    checkpoint: str | None = None
    #: batches between snapshots
    checkpoint_every: int = 64
    #: widen the batch block/gap columns for many-block single-end
    #: alignments (ONT/PacBio full-length transcripts).  Semantics are
    #: identical either way — long CIGARs always decode fully; this only
    #: rebalances the fixed batch shapes (io/batch.py LONGREAD_*)
    long_reads: bool = False

    @classmethod
    def from_args(cls, args) -> "RunConfig":
        """Build from an argparse namespace, using defaults for absent
        attributes (different CLI modes expose different subsets)."""
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(args, f.name, None)
            if v is not None:
                kw[f.name] = v
        if getattr(args, "no_native", False):
            kw["use_native"] = False
        return cls(**kw)
