"""sbwt_tpu_torch: the SBWT k-mer index on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package ``sbwt_tpu``, which stays beside it as the
reference. This package imports ``torch`` and never ``jax``; host-side
construction, file formats and query batching are shared with
``sbwt_tpu`` through its modules that import no JAX (construct, io,
native, utils).

Ported so far: the plain-matrix ``build`` -> ``search`` path with the
precalc table and the turbo successor engine (arity 1, 2 or 3). Kernels:
csrc/lf_interval.cu (K1), succ_table.cu (K2), seed_bits.cu (K3) and
turbo_stream.cu (K4), built by nvcc at first use (see kernels/).

Top-level names are lazy, so importing the package loads no index code.
"""

__version__ = "0.1.0"

__all__ = ["SBWT"]


def __getattr__(name):
    if name in __all__:
        from .models import sbwt as _sbwt

        return getattr(_sbwt, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
