"""sbwt_tpu_torch: the SBWT k-mer index on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package ``sbwt_tpu``, which stays beside it as the
reference. This package imports ``torch``, never ``jax`` and nothing of
``sbwt_tpu``: host-side construction, file formats, query batching and
the native C runtime are its own copies (construct, io, native, utils),
under the same sub-package names.

Ported so far: ``build``, ``build-variant`` and ``search`` for all ten
variants, with the precalc table, the turbo successor engine (arity 1, 2
or 3, built from any variant's own ranks), the LF streaming engine (every
variant), the wide (int64) tier for an index of 2^31 columns or more
(models/wide.py) and the on-device build (``SBWT.build_on_device``,
construct/device.py). Kernels in csrc/, built by nvcc at first use (see
kernels/): K1 (precalc fill, k-mer search), K14 (LF streaming) and
partial_search in lf_stream.cuh, K2's succ1 in succ_table.cuh and K4 in
turbo_stream.cuh, all templates over the rank structures K15-K17 (bv.cuh,
wavelet.cuh, subset_rank.cuh) and the wide tier's WideMatrix (K18), with
one instance per rank type; succ_table.cu (K2's table composition),
seed_bits.cu (K3) and build_sbwt.cu (K19, the four build kernels).

Top-level names are lazy, so importing the package loads no index code.
"""

__version__ = "0.1.0"

__all__ = ["SBWT"]


def __getattr__(name):
    if name in __all__:
        from .models import sbwt as _sbwt

        return getattr(_sbwt, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
