"""The frozen yardstick of the top-k kernel at its main shapes: the
bytes and least times of the port's kernel table (PERF.md section 6)."""

import pytest

from benchmark import kernel_counts as kc


def test_topk_main_shape():
    assert kc.topk_bytes(256, 8208, 16) == 8_437_760
    assert kc.least_seconds(8_437_760, kc.topk_ops(256, 8208)) == \
        pytest.approx(2.52e-6, abs=0.005e-6)


def test_topk_merge_main_shape():
    assert kc.topk_merge_bytes(256, 8192, 16) == 8_462_336
    assert kc.least_seconds(8_462_336, kc.topk_ops(256, 8192)) == \
        pytest.approx(2.53e-6, abs=0.005e-6)


def test_peaks_and_scoring():
    assert kc.HBM_BYTES_PER_S == 3.35e12 and kc.BF16_OPS_PER_S == 989.4e12
    # one rescan of the 2^20-id corpus for 256 queries of 768 dims
    assert kc.score_ops(256, 768, 1 << 20) == pytest.approx(4.12e11,
                                                            rel=1e-3)


def test_scan_score_main_shape():
    # an int8 [8192, 768] chunk and bf16 [256, 768] queries read, float32
    # [256, 8192] scores written; the bytes bind (the operations: 3.26 us)
    nbytes = kc.scan_score_bytes(256, 768, 8192)
    assert nbytes == 15_073_280
    ops = kc.score_ops(256, 768, 8192)
    assert ops / kc.BF16_OPS_PER_S == pytest.approx(3.26e-6, abs=0.005e-6)
    assert kc.least_seconds(nbytes, ops, kc.BF16_OPS_PER_S) == \
        pytest.approx(4.50e-6, abs=0.005e-6)
