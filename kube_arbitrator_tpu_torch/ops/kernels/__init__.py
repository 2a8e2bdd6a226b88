"""Hand-written CUDA kernels of the main path, each beside its plain
PyTorch version and with a launch counter:

* K1 :func:`admit_chunk.admit_chunk`         — ops/allocate.py slot body
* K2 :func:`lex_argmin.lex_argmin`           — ops/common.lex_argmin
* K3 :func:`decode_deferred.decode_deferred` — ops/allocate._decode_deferred
* K4 :func:`segment_sum.segment_sum`         — slot-order segment sums

A wrapper takes the plain version only for CPU tensors; on CUDA tensors
it launches its kernel (built on first use, see build.py) or raises.
"""
from . import admit_chunk, decode_deferred, lex_argmin, segment_sum

# kernel name -> wrapper (each wrapper carries its ``launches`` count)
KERNELS = {
    "admit_chunk": admit_chunk.admit_chunk,
    "lex_argmin": lex_argmin.lex_argmin,
    "decode_deferred": decode_deferred.decode_deferred,
    "segment_sum": segment_sum.segment_sum,
}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
