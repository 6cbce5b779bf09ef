"""irfinder_tpu_torch — the PyTorch/CUDA port of irfinder_tpu.

The device half of the engine in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (csrc/*.cu, built at first use).  The framework-free layers
(semantics, reference compiler and GTF parser, BAM decoders and writers,
junction tally, finalize join, table writers, QC, differential, GLM export,
golden-file harness, mappability generation and the NumPy conformance
oracle) are the port's own copies of the JAX package's modules, in the same
layout, with their C++ components under csrc/host/; the tests hold each copy
to its original.  This package imports neither JAX nor ``irfinder_tpu``.

The port does what the JAX package does: every CLI mode (cli.py: BuildRef
and its aliases, BAM with checkpoint/resume and the dp x genome mesh, Batch,
FastQ, Diff, ExportGLM, Goldens, Mapability, BuildRefDownload) and the
top-level API below.  The counting modes run on the card by default.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level API: importing the package stays light (no torch); the
    # commonly-used entry points resolve on first touch
    _api = {
        "run_bam": ("irfinder_tpu_torch.engine", "run_bam"),
        "run_multi_bam": ("irfinder_tpu_torch.engine", "run_multi_bam"),
        "Engine": ("irfinder_tpu_torch.engine", "Engine"),
        "RunConfig": ("irfinder_tpu_torch.config", "RunConfig"),
        "compile_reference": ("irfinder_tpu_torch.refio.compile", "compile_reference"),
        "CompiledRef": ("irfinder_tpu_torch.refio.compile", "CompiledRef"),
        "run_bam_mesh": ("irfinder_tpu_torch.engine_mesh", "run_bam_mesh"),
        "MeshSpec": ("irfinder_tpu_torch.engine_mesh", "MeshSpec"),
        "run_differential": ("irfinder_tpu_torch.diff", "run_differential"),
    }
    if name in _api:
        import importlib

        mod, attr = _api[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'irfinder_tpu_torch' has no attribute {name!r}")
