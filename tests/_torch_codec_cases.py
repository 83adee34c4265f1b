"""Codec inputs shared by the CPU parity tests (tests/test_torch_comm.py)
and the card's (tests/test_torch_cuda.py): q8 rows with non-finite and
signed-zero blocks, and top-k wires as a corrupted wire carries them
(duplicate indices, indices outside the block). numpy only, from a seed."""
import numpy as np

# an index at which pair order matters: 1 + 1e8 rounds to 1e8 in f32, so
# ((0 + 1) + 1e8) + -1e8 = 0, while 1e8 + -1e8 + 1 = 1
ORDER_COL, ORDER_VALS = 5, (1.0, 1e8, -1e8)


def q8_nonfinite_rows(block, extra=37, seed=0):
    """[2, 6 * block + extra] f32. Row 0: block 0 holds a NaN, block 1 a
    +inf, block 2 a -inf, block 3 a -0.0 among other values, block 4 only
    -0.0, block 5 nothing special. Row 1: block 0 a NaN with its sign bit
    set beside a +inf, block 1 a -inf beside a +inf, block 3 a NaN, and the
    ragged last block a NaN."""
    x = np.random.RandomState(seed).randn(2, 6 * block + extra).astype(np.float32)
    x[0, 5] = np.nan
    x[0, block + 9] = np.inf
    x[0, 2 * block + 100] = -np.inf
    x[0, 3 * block + 3] = -0.0
    x[0, 4 * block:5 * block] = -0.0
    x[1, 17] = np.float32(np.nan) * np.float32(-1.0)
    x[1, 20] = np.inf
    x[1, block + 1], x[1, block + 2] = -np.inf, np.inf
    x[1, 3 * block + 64] = np.nan
    x[1, 6 * block + extra // 2] = np.nan
    return x


def finite_lanes(x, block):
    """bool [W, nb * block]: the wire lanes whose input is finite (padded
    lanes count as finite: they read 0). Converting NaN or inf / inf to
    int8 is defined by neither the reference nor the port."""
    W, n = x.shape
    nb = -(-n // block)
    ok = np.ones((W, nb * block), bool)
    ok[:, :n] = np.isfinite(x)
    return ok


def corrupted_topk_wire(W, nb, k, block, seed=0):
    """(values f32 [W, nb * k], indices int32 [W, nb * k]) of a corrupted
    wire. Indices are drawn from a few columns, so most repeat, and values
    span twelve decades, so their sums depend on the order; a fifth of the
    pairs point outside [0, block). Row 0's first block carries
    ORDER_VALS at ORDER_COL and the indices -5, block, 2**31 - 1 and
    -2**31; its second (where nb > 1) a lone -0.0, which decodes to +0.0.
    Needs k >= 8."""
    rng = np.random.RandomState(seed)
    pool = rng.randint(0, block, size=(W, nb, max(2, k // 4)))
    idx = np.take_along_axis(pool, rng.randint(0, pool.shape[-1], (W, nb, k)), -1)
    out = rng.rand(W, nb, k) < 0.2
    idx[out] = rng.choice(np.array([-1, -block, block, block + 7, 2**31 - 1, -2**31]),
                          int(out.sum()))
    vals = rng.randn(W, nb, k) * 10.0 ** rng.randint(-3, 9, (W, nb, k))
    idx[0, 0, :3], vals[0, 0, :3] = ORDER_COL, ORDER_VALS
    idx[0, 0, 3:7] = [-5, block, 2**31 - 1, -2**31]
    if nb > 1:
        idx[0, 1, :] = np.where(idx[0, 1] == 3, 4, idx[0, 1])
        idx[0, 1, 0], vals[0, 1, 0] = 3, -0.0
    return (vals.astype(np.float32).reshape(W, nb * k),
            idx.astype(np.int32).reshape(W, nb * k))
