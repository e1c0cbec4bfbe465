"""K2's two designs: which one a parallel projection's map takes by its
shape, the streamed design's grid, and how a launch's scan span counts
them.  All of it is host arithmetic, so it runs on the CPU; the designs
themselves are held to the plain version on the card in
``tests/test_torch_cuda.py``."""
from types import SimpleNamespace

import pytest
import torch

from repro_torch import trace
from repro_torch.core.runtime import executor
from repro_torch.kernels.spike_wdm_matmul import ops
from repro_torch.kernels.spike_wdm_matmul import stream_tiling, wdm_design

#: (M, K) of the full-scale microcircuit's 11 parallel projections as lowered
#: (``build_microcircuit(1.0, seed=0)``: targets x distinct (source, delay)
#: pairs): L5I->L5E, L2/3I->L5I, L4I->L5I, L5E->L5I, L5I->L5I, L6E->L5I,
#: L5I->L6E, L4I->L6I, L5E->L6I, L5I->L6I, L6I->L6I
MICROCIRCUIT_MAPS = [
    (4850, 2134), (1065, 8600), (1065, 5210), (1065, 15627), (1065, 2130),
    (1065, 36805), (14395, 2130), (2948, 4377), (2948, 15867), (2948, 1517),
    (2948, 5897),
]
#: the gesture network's parallel maps (2048-20-4 at density 0.0316)
GESTURE_MAPS = [(20, 965), (4, 20)]
#: the cerebellum scaffold's parallel maps at 10k and 100k neurons
SCAFFOLD_MAPS = [(8000, 650), (200, 7404), (8000, 200), (250, 7911), (800, 8000),
                 (2000, 6489), (2500, 917)]
H100_SMS = 132


@pytest.mark.parametrize("m,k", MICROCIRCUIT_MAPS)
def test_the_microcircuits_maps_are_streamed(m, k):
    # the cell serves one lane; above the streamed design's lanes the
    # latency design takes any batch
    assert wdm_design(m, k, 1) == "streamed"
    assert wdm_design(m, k, ops.STREAM_MAX_LANES + 1) == "latency"
    assert wdm_design(m, k, 8) == ("streamed" if m * k >= ops.STREAM_MIN_BYTES
                                   else "latency")


@pytest.mark.parametrize("m,k", GESTURE_MAPS)
@pytest.mark.parametrize("lanes", [1, 8])
def test_gestures_maps_keep_the_latency_design(m, k, lanes):
    assert wdm_design(m, k, lanes) == "latency"


#: the scaffold's maps at batch 8 that the sweep found faster streamed
#: (5.2, 6.4 and 13 MB); the others (1.5-2.3 MB) stay on the latency design,
#: which was as fast or faster there
SCAFFOLD_STREAMED = {(8000, 650), (800, 8000), (2000, 6489)}


@pytest.mark.parametrize("m,k", SCAFFOLD_MAPS)
def test_the_scaffolds_maps_at_batch_8(m, k):
    want = "streamed" if (m, k) in SCAFFOLD_STREAMED else "latency"
    assert wdm_design(m, k, 8) == want


def test_the_thresholds_are_the_maps_bytes_and_its_rows():
    big, one = ops.STREAM_MIN_BYTES, ops.STREAM_MIN_BYTES_ONE_LANE
    for lanes in (1, 2, 8):
        assert wdm_design(big // 1024, 1024, lanes) == "streamed"
        assert wdm_design(big // 1024 - 1, 1024, lanes) == "latency"
    # at one lane, rows past the latency design's tile stream from 1 MiB
    assert wdm_design(one // 2048, 2048, 1) == "streamed"
    assert wdm_design(one // 2048 - 1, 2048, 1) == "latency"
    assert wdm_design(one // 2048, 2048, 2) == "latency"
    assert wdm_design(one // 1024, ops.LATENCY_TILE, 1) == "latency"
    assert wdm_design(big, 1, 0) == "latency"


@pytest.mark.parametrize("lanes", [1, 2, 3, 8])
@pytest.mark.parametrize("m,k", MICROCIRCUIT_MAPS + SCAFFOLD_MAPS)
def test_the_streamed_grid_fills_the_card_within_the_kernels_limits(m, k, lanes):
    rows, split, width, slice_, lpr = stream_tiling(m, k, lanes, H100_SMS)
    blocks = -(-m // rows) * split
    assert rows in (16, 32, 64) and rows <= ops.STREAM_MAX_ROWS
    assert split in (1, 2, 4, 8)
    assert lpr in (4, 8, 16, 32)
    assert width % 16 == 0 and slice_ % 16 == 0
    # a slice's spikes (and a chunk either side) fit the kernel's copies
    kernel_lanes = 1 << (lanes - 1).bit_length()
    assert 0 < slice_ <= width and slice_ + 16 <= ops.STREAM_SPIKE_BYTES // kernel_lanes
    # the slices cover K, none empty, and the passes over a slice cover it
    assert width * split >= k > width * (split - 1)
    assert -(-width // slice_) * slice_ >= width
    assert split == 1 or width >= 512
    # a row's chunks of a pass (one more than its groups, for a row that
    # starts inside a chunk) take one turn, where 32 lanes allow
    assert lpr * ops.STREAM_UNROLL >= slice_ // 16 + 1 or lpr == 32
    # every microcircuit map fills at least one wave of the card
    if (m, k) in MICROCIRCUIT_MAPS:
        assert blocks >= H100_SMS


def test_the_small_maps_split_k_across_a_cluster():
    for m, k in MICROCIRCUIT_MAPS:
        if m == 1065:
            assert stream_tiling(m, k, 1, H100_SMS)[1] > 1


def test_a_ragged_slice_is_cut_into_equal_passes():
    rows, split, width, slice_, lpr = stream_tiling(1065, 36805, 1, H100_SMS)
    assert (split, width, slice_, lpr) == (8, 4608, 1536, 32)
    # eight lanes stage an eighth of the columns at a time
    assert stream_tiling(1065, 36805, 8, H100_SMS)[3] == 240


class CardMap:
    """Stands in for a map on the card: ``_mark_scan`` reads its shape."""

    is_cuda = True

    def __init__(self, m, k):
        self.shape = (m, k)

    def numel(self):
        return self.shape[0] * self.shape[1]


def _scan_counts(forms, params, steps, batch, metas=None):
    trace.enable()
    try:
        with trace.span("executor.scan", steps=steps) as scan:
            executor._mark_scan(scan, "replay", metas or [None] * len(forms),
                                forms, params, steps, batch)
        (rec,) = [r for r in trace.records() if r.name == "executor.scan"]
        return rec.counts
    finally:
        trace.disable()
        trace.clear()


def test_the_microcircuits_projection_steps_all_count_as_streamed():
    steps = 48
    forms = ("-",) * len(MICROCIRCUIT_MAPS) + ("event", "event")
    params = [(CardMap(m, k), None, None) for m, k in MICROCIRCUIT_MAPS]
    params += [None, None]                 # event edges another rank holds
    metas = [None] * len(MICROCIRCUIT_MAPS) + [SimpleNamespace(n_rows=7)] * 2
    counts = _scan_counts(forms, params, steps, 1, metas)
    assert counts == {"event_driven": 0, "event_swept": 0,
                      "wdm_streamed": steps * 11, "wdm_latency": 0}


@pytest.mark.parametrize("batch", [1, 8])
def test_gestures_projection_steps_all_count_as_latency(batch):
    params = [(CardMap(m, k), None, None) for m, k in GESTURE_MAPS]
    counts = _scan_counts(("-", "-"), params, 30, batch)
    assert counts == {"event_driven": 0, "event_swept": 0,
                      "wdm_streamed": 0, "wdm_latency": 30 * 2}


def test_a_mixed_launch_counts_each_map_by_its_own_shape():
    maps = [(1065, 2130), (20, 965), (0, 5)]     # an empty map runs no kernel
    params = [(CardMap(m, k), None, None) for m, k in maps] + [None]
    counts = _scan_counts(("-", "-", "-", "-"), params, 5, 1)
    assert (counts["wdm_streamed"], counts["wdm_latency"]) == (5, 5)
    # at two lanes a 2.3 MB map takes the latency design, a 13 MB one not
    counts = _scan_counts(("-", "-", "-"), [(CardMap(1065, 2130), None, None),
                                           (CardMap(2000, 6489), None, None),
                                           None], 5, 2)
    assert (counts["wdm_streamed"], counts["wdm_latency"]) == (5, 5)
    # above the streamed design's lanes every map takes the latency design
    counts = _scan_counts(("-", "-", "-", "-"), params, 5, 9)
    assert (counts["wdm_streamed"], counts["wdm_latency"]) == (0, 10)


def test_cpu_launches_count_neither_design():
    params = [(torch.zeros((1065, 2130), dtype=torch.int8), None, None)]
    counts = _scan_counts(("-",), params, 4, 1)
    assert "wdm_streamed" not in counts and "wdm_latency" not in counts


def test_the_launch_refuses_what_no_design_takes():
    """Checked before anything is built or launched, so on the CPU too."""
    ops_ = (torch.zeros((2, 3), dtype=torch.int8), torch.zeros(3, dtype=torch.int32),
            torch.ones(3, dtype=torch.int32))
    nine = torch.zeros((ops.STREAM_MAX_LANES + 1, 1, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="1 to 8 lanes"):
        ops._project("streamed", *ops_, nine, 1)
    with pytest.raises(ValueError, match="no design"):
        ops._project("dense", *ops_, nine[:2], 1)
