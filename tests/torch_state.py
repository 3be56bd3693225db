"""JAX index state as numpy, for carrying it into sbwt_tpu_torch."""
import numpy as np


def matrix_state(di) -> dict:
    """The fields of a JAX MatrixIndex as numpy arrays, with its metadata."""
    state = {f: np.asarray(getattr(di, f)) for f in ("rank_tbl", "sgs_tbl", "C", "precalc")}
    state.update({f: getattr(di, f) for f in (
        "n_nodes", "n_kmers", "k", "precalc_k", "n_words", "has_streaming")})
    return state


def turbo_state(jt) -> dict:
    """The fields of a JAX TurboIndex as numpy arrays, with its metadata."""
    state = {f: np.asarray(getattr(jt, f)) for f in ("tbl", "precalc", "C")}
    state["seed_bits"] = None if jt.seed_bits is None else np.asarray(jt.seed_bits)
    state.update({f: getattr(jt, f) for f in ("n_nodes", "k", "precalc_k", "arity")})
    return state
