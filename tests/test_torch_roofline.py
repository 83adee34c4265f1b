"""The port's roofline (``analysis.roofline``) and the card's spec
(``common.hardware``) against the reference's and the port's own kernel
table.

- ``model_flops`` equal to the reference's for 10 archs x 4 shapes
  (exact);
- ``Roofline.to_dict()`` over a ``ChipSpec`` holding TPU v5e's figures
  equal to the reference's ``Roofline.to_dict()`` from the same counts
  (the same keys; floats within rtol 1e-12, the rest exact);
- the kernel cost functions reproduce the bound column of the kernel table
  (PERF.md §6) at the table's shapes, to the printed digits (4 decimals of
  a millisecond, exact), over the H100 spec;
- ``chip_spec`` maps card names to specs in the table's order, its default
  is the H100 SXM of PERF.md §3 (3.35 TB/s, 67 TFLOP/s f32, 989 TFLOP/s
  bf16 dense, 80 GB), and it refuses a card it does not know."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import roofline as jrf  # noqa: E402
from repro.common import config as jconfig  # noqa: E402
from repro.common.hardware import TPU_V5E  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch.analysis import roofline as rf  # noqa: E402
from repro_torch.common import config, hardware  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
H100 = hardware.H100_SXM
BW, F32, BF16 = H100.hbm_bandwidth, H100.peak_f32_flops, H100.peak_bf16_flops
N = 2913408                      # the full-width MLP plane


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch, shape):
    got = rf.model_flops(get_config(arch), config.INPUT_SHAPES[shape])
    want = jrf.model_flops(jget_config(arch), jconfig.INPUT_SHAPES[shape])
    assert got == want


def _v5e_spec() -> hardware.ChipSpec:
    """A ChipSpec holding the reference's TPU v5e figures (ICI link as the
    NVLink term, DCN as the inter-node one, VMEM as shared memory)."""
    return hardware.ChipSpec(
        name=TPU_V5E.name, peak_bf16_flops=TPU_V5E.peak_bf16_flops,
        peak_f32_flops=TPU_V5E.peak_bf16_flops, hbm_bandwidth=TPU_V5E.hbm_bandwidth,
        hbm_capacity=TPU_V5E.hbm_capacity, nvlink_bandwidth=TPU_V5E.ici_link_bandwidth,
        nvlink_links=TPU_V5E.ici_links, internode_bandwidth=TPU_V5E.dcn_bandwidth,
        smem_bytes_per_sm=TPU_V5E.vmem_bytes)


@pytest.mark.parametrize("counts", [
    (3.1e15, 2.2e12, 4.5e9, {"all-reduce": 4.0e9, "all-gather": 5.0e8}, 1.0e18, 7.5e9),
    (2.0e11, 9.0e12, 0.0, {}, 3.0e13, None),
    (1.0e9, 1.0e6, 8.0e10, {"collective-permute": 8.0e10}, 0.0, 1.0),
], ids=["compute", "memory", "collective"])
def test_roofline_dict_equals_the_reference_over_v5e_figures(counts):
    flops, nbytes, coll, breakdown, mflops, peak = counts
    args = ("tinyllama_1_1b", "train_4k", "train", 256, flops, nbytes, coll, dict(breakdown),
            mflops, peak)
    got = rf.Roofline(*args, spec=_v5e_spec(), dtype=torch.bfloat16).to_dict()
    want = jrf.Roofline(*args).to_dict()
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-12, abs=0.0), k
        else:
            assert g == w, k


def _ms(cost, rate, bw=BW):
    return round(rf.bound_ms(*cost, rate, bw)[0], 4)


def test_update_and_codec_costs_reproduce_the_kernel_table():
    """B1-B8 rows of PERF.md §6 (f32 at 67 TFLOP/s, 3.35 TB/s)."""
    b1 = {(8, N): 0.1670, (4, N): 0.0835, (1, N): 0.0209, (2, 1100048384): 15.7619,
          (2, 1085287424): 15.5504, (4, 211971880): 6.0744, (2, 1039033056): 14.8876,
          (2, 1040281615): 14.9055}
    for (W, n), want in b1.items():
        assert _ms(rf.b1_cost(W, n), F32) == want, (W, n)
    assert [_ms(rf.b2_cost(W, N), F32) for W in (8, 4)] == [0.1391, 0.0696]
    assert [_ms(rf.b3_cost(W * N), F32) for W in (8, 4)] == [0.1670, 0.0835]
    assert _ms(rf.q8_encode_cost(8, N, 512), F32) == 0.0348
    assert _ms(rf.q8_decode_cost(8, N, 512), F32) == 0.0348
    assert _ms(rf.topk_encode_cost(8, N, 512, 26), F32) == 0.0863
    assert _ms(rf.topk_decode_cost(8, N, 512, 26), F32) == 0.0307
    assert _ms(rf.b8_cost(8, N), F32) == 0.0835
    # B8 in column chunks: the scalars once a chunk (below the printed digits)
    assert _ms(rf.b8_cost(8, N, chunks=8), F32) == 0.0835
    assert rf.bound_ms(*rf.b1_cost(8, N), F32, BW)[1] == "bytes"


# (B, Sq, H, Hkv, hd, dv, visible keys, causal) -> the table's bound (bf16)
B9_TABLE = [
    ((8, 512, 32, 4, 64, 64, 512, True), 0.0113),      # TinyLlama prefill (mma)
    ((8, 1, 32, 4, 64, 64, 513, True), 0.0013),        # its decode at pos 512 (split)
    ((8, 512, 16, 1, 576, 512, 512, True), 0.0440),    # MLA prefill (simt)
    ((8, 1, 16, 1, 576, 512, 513, True), 0.0015),      # MLA decode
    ((8, 512, 32, 32, 80, 80, 512, True), 0.0250),     # Zamba2 hd 80 prefill
    ((8, 1, 32, 32, 80, 80, 513, True), 0.0126),       # its decode
    ((8, 512, 32, 8, 128, 128, 512, True), 0.0250),    # vision self prefill
    ((8, 512, 32, 8, 128, 128, 1601, False), 0.1086),  # vision cross prefill
    ((8, 1, 32, 8, 128, 128, 513, True), 0.0051),      # vision self decode
    ((8, 1, 32, 8, 128, 128, 1601, False), 0.0157),    # vision cross decode
    ((8, 512, 32, 32, 64, 64, 512, True), 0.0200),     # MusicGen self prefill
    ((8, 512, 32, 32, 64, 64, 64, False), 0.0113),     # MusicGen cross prefill
    ((8, 1, 32, 32, 64, 64, 513, True), 0.0101),       # MusicGen self decode
    ((8, 1, 32, 32, 64, 64, 64, False), 0.0013),       # MusicGen cross decode
    ((8, 512, 16, 2, 64, 64, 512, True), 0.0056),      # TinyLlama at M = 2, prefill
    ((8, 1, 16, 2, 64, 64, 513, True), 0.0006),        # decode
    ((8, 512, 8, 1, 64, 64, 512, True), 0.0028),       # M = 4 prefill
    ((8, 1, 8, 1, 64, 64, 513, True), 0.0003),         # decode
    ((8, 512, 8, 1, 576, 512, 512, True), 0.0227),     # MLA at M = 2, prefill
    ((8, 1, 8, 1, 576, 512, 513, True), 0.0015),       # decode
    ((8, 256, 16, 16, 80, 80, 256, True), 0.0063),     # Zamba2 at M = 2, prefill
    ((8, 1, 16, 16, 80, 80, 257, True), 0.0032),       # decode
    ((8, 256, 16, 4, 128, 128, 256, True), 0.0063),    # vision self at M = 2
    ((8, 1, 16, 4, 128, 128, 257, True), 0.0013),      # decode
    ((8, 256, 16, 4, 128, 128, 1601, False), 0.0272),  # vision cross at M = 2
    ((8, 1, 16, 4, 128, 128, 1601, False), 0.0078),    # decode
]


@pytest.mark.parametrize("shape,want", B9_TABLE, ids=[str(s) for s, _ in B9_TABLE])
def test_b9_cost_reproduces_the_kernel_table(shape, want):
    B, Sq, H, Hkv, hd, dv, visible, causal = shape
    cost = rf.b9_cost(B, Sq, H, Hkv, hd, visible, dv=dv, causal=causal)
    assert _ms(cost, BF16) == want


def test_b9_cost_window_and_offsets():
    """A window caps the keys each query sees (and reads); a causal block of
    queries at an offset sees the keys up to its own position."""
    full = rf.b9_cost(1, 8, 1, 1, 8, 8)
    assert full[0] == 2 * 16 * 36                                   # 1 + ... + 8 pairs
    assert rf.b9_cost(1, 8, 1, 1, 8, 8, window=8) == full          # a window as wide
    # window 3: rows see 1, 2, 3, 3, 3, 3, 3, 3 keys
    assert rf.b9_cost(1, 8, 1, 1, 8, 8, window=3)[0] == 2 * 16 * 21
    # 4 queries at positions 4..7 of 8 keys: 5 + 6 + 7 + 8
    assert rf.b9_cost(1, 4, 1, 1, 8, 8)[0] == 2 * 16 * 26
    # decode over 100 keys in a window of 10 reads 10 key rows
    f, b = rf.b9_cost(1, 1, 1, 1, 8, 100, window=10, size=4)
    assert f == 2 * 16 * 10 and b == 4 * (8 + 10 * 16 + 8)


def test_chip_spec_lookup():
    assert hardware.chip_spec() is H100
    assert (H100.hbm_bandwidth, H100.peak_f32_flops, H100.peak_bf16_flops) == \
        (3.35e12, 67e12, 989e12)
    assert H100.hbm_capacity == 80 * 2 ** 30
    assert hardware.chip_spec("NVIDIA H100 80GB HBM3") is H100
    assert hardware.chip_spec("NVIDIA H100 NVL") is hardware.H100_NVL
    assert hardware.chip_spec("NVIDIA H100 PCIe") is hardware.H100_PCIE
    assert hardware.chip_spec("NVIDIA H200") is hardware.H200
    assert H100.peak_flops(torch.bfloat16) == 989e12
    assert H100.peak_flops(torch.float32) == 67e12
    with pytest.raises(ValueError, match="no memory / compute figures"):
        hardware.chip_spec("NVIDIA A100-SXM4-80GB")
    assert hardware.compute_time_s(989e12, 2) == 0.5
    assert hardware.memory_time_s(3.35e12, 1) == 1.0
    assert hardware.collective_time_s(H100.nvlink_bandwidth * 4, 4) == 1.0
    assert dataclasses.replace(H100, name="x").peak_flops(torch.float16) == 989e12
