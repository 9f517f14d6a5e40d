"""The roofline's byte counts against counts worked by hand, and the
chunk geometry and bytes the harness reads from the built runner."""
import pytest

from conftest import CELLS
from tiltbench import harness, roofline


def test_kernel_bytes_by_hand():
    # (2, 2025) f32 in, the same out
    assert roofline.sliding_assoc_bytes(2, 2025) == 2 * 2025 * 4 * 2
    # keyed fraud's change detection: (16384, 1, 2025) f32 and bool rows,
    # one flag a key
    mats = [((16384, 1, 2025), 4), ((16384, 1, 2025), 1)]
    assert roofline.seg_dirty_bytes(mats, 16384, 1) == \
        16384 * 2025 * 5 + 16384 == 165_904_384


def test_chunk_bytes_by_hand():
    # fraud: 1024 ticks in (f32 + bool), 1024 out, a 1000-tick tail read
    # and written, for each of 16384 holders
    assert roofline.chunk_bytes(16384, 1024, 5, 1024, 5, 1000) == \
        16384 * (1024 * 5 + 1024 * 5 + 2 * 1000 * 5) == 331_612_160
    # ysb: 160000 ticks in (etype f32 + bool), 16 windows out, no tail
    assert roofline.chunk_bytes(100, 160000, 5, 16, 5, 0) == \
        100 * (160000 * 5 + 16 * 5) == 80_008_000


def test_share_and_picks():
    assert abs(roofline.share_pct(3.35e9, 2e-3) - 50.0) < 1e-9
    assert roofline.over_picks({1024: 10, 2048: 30}, {1024: 3, 2048: 1}) \
        == 60.0


# (cell, keys, chunk ticks, bytes of one chunk) worked by hand from each
# configuration: ysb's 16 segments of one 10000-tick window, etype f32 and
# valid in, 16 counts (f32 and valid) out, no tail; fraud's one segment of
# 1024 ticks, f32 and valid in and out, a 1000-tick tail read and written
@pytest.mark.parametrize("cell, keys, ticks, nbytes", [
    ("ysb100", 4, 160000, 4 * (160000 * 5 + 16 * 5)),
    ("fraud-busy", 64, 1024, 64 * (1024 * 5 + 1024 * 5 + 2 * 1000 * 5)),
])
def test_the_chunk_read_from_the_runner(cell, keys, ticks, nbytes):
    ses = harness.Session(harness.load_cell(cell, False, **CELLS[cell]),
                          "cpu")
    ses.load(3)
    assert (ses.K, ses.T, ses.kt) == (keys, ticks, keys * ticks)
    assert ses.chunk_bytes == nbytes
