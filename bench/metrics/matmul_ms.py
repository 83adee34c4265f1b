"""Device ms a step in matrix multiplications (cuBLAS f32), by kernel name
as ``bench/frozen/lm_split.py`` names them, whatever range launched them."""

_MATMUL = ("gemm", "gemv", "sm90", "cutlass", "matmul")


def read(t):
    us = sum(k.time_range.end - k.time_range.start for k in t.kernels
             if any(m in k.name.lower() for m in _MATMUL))
    return us / t.steps / 1e3 if us > 0 else None
