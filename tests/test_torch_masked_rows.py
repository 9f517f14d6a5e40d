"""The masked channel rows every window kernel reads, on the CPU:
``ref.masked_rows_ref`` (what ``window_reduce.masked_rows`` runs for a CPU
tensor, and what the CUDA kernel is held to in tests/test_torch_cuda.py)
against the where / cast / cat composition ``ops`` ran before it, bit for
bit; ``ops`` on a ``(C, *B, T)`` tensor against the list of its channels;
``window_reduce.masked_plan``, the kernel's form and grid.
"""
import math
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import window_reduce as wr

CSRC = Path(wr.__file__).resolve().with_name("csrc")
FILLS = {"add": 0.0, "max": -math.inf, "min": math.inf}
# NaNs with payloads, both infinities and both zeros, as f32 bit patterns
SPECIALS = torch.tensor([0x7FC00001, 0xFFC12345, 0x7F800000, 0xFF800000,
                         0, 0x80000000], dtype=torch.int64).to(
                             torch.int32).view(torch.float32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _old_composition(x: torch.Tensor, valid: torch.Tensor, op: str):
    """The rows as ``ops`` built them before the kernel: a where, a cast
    and a cat over the stacked channels."""
    xm = torch.where(valid.unsqueeze(0), x, FILLS[op]).float()
    vch = valid.unsqueeze(0).float()
    return torch.cat([xm, -vch if op == "min" else vch], dim=0)


def _channels(C, B, T, seed, strided):
    """``C`` f32 channels and a validity ``(*B, T)`` with NaN, inf and
    signed-zero payloads at random ticks; ``strided``: views into wider
    rows at an odd offset, so no row starts where the previous one ends."""
    g = torch.Generator().manual_seed(seed)
    pad = 7 if strided else 0
    base = torch.randn((C,) + B + (T + pad,), generator=g)
    if base.numel():
        flat = base.view(-1)
        at = torch.randint(0, flat.numel(), (min(64, flat.numel()),),
                           generator=g)
        flat[at] = SPECIALS[torch.arange(at.numel()) % SPECIALS.numel()]
    vbase = torch.rand(B + (T + pad,), generator=g) > 0.3
    off = 3 if strided else 0
    chans = [base[c, ..., off:off + T] for c in range(C)]
    return chans, vbase[..., off:off + T]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("B", [(0,), (3,), (2, 3)])
@pytest.mark.parametrize("T", [1, 5, 8665])
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_masked_rows_ref_is_the_old_composition_bit_for_bit(C, op, T, B,
                                                            strided):
    chans, valid = _channels(C, B, T, C * 1000 + T, strided)
    want = _old_composition(torch.stack(chans), valid, op)
    got = ref.masked_rows_ref(chans, valid, op)
    assert got.shape == (C + 1,) + B + (T,) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))
    # a (C, *B, T) tensor is read as it is
    assert torch.equal(_bits(ref.masked_rows_ref(torch.stack(chans), valid,
                                                 op)), _bits(want))
    # the CPU wrapper is the plain version, and launches nothing
    n0, c0 = dict(wr.launches), dict(wr.copies)
    assert torch.equal(_bits(wr.masked_rows(chans, valid, op)), _bits(want))
    assert wr.launches == n0 and wr.copies == c0


def test_min_validity_row_holds_negative_zero():
    valid = torch.tensor([[True, False, True]])
    rows = ref.masked_rows_ref([torch.ones(1, 3)], valid, "min")
    assert _bits(rows[1]).tolist() == [[_bits(torch.tensor(-1.0)).item(),
                                        -0x80000000,
                                        _bits(torch.tensor(-1.0)).item()]]
    assert rows[0, 0, 1].item() == math.inf
    assert _bits(ref.masked_rows_ref([torch.ones(1, 3)], valid,
                                     "max")[1])[0, 1].item() == 0


@pytest.mark.parametrize("W", [1, 3, 8, 50])
@pytest.mark.parametrize("algo", ["block", "soe"])
def test_ops_sum_reads_a_stack_and_a_channel_list_alike(W, algo):
    chans, valid = _channels(3, (4,), 300, W, strided=True)
    chans = [torch.nan_to_num(c, nan=1.0, posinf=2.0, neginf=-2.0)
             for c in chans]
    s_list, n_list = ops.sliding_sum(chans, valid, W, algo=algo)
    s_stack, n_stack = ops.sliding_sum(torch.stack(chans), valid, W,
                                       algo=algo)
    assert torch.equal(_bits(s_list), _bits(s_stack))
    assert torch.equal(_bits(n_list), _bits(n_stack))


@pytest.mark.parametrize("W", [3, 8, 50])
@pytest.mark.parametrize("op", ["max", "min", "absmax"])
def test_ops_assoc_reads_a_stack_and_a_channel_list_alike(W, op):
    chans, valid = _channels(2, (4,), 300, W + 7, strided=True)
    v_list, a_list = ops.sliding_assoc(chans, valid, W, op)
    v_stack, a_stack = ops.sliding_assoc(torch.stack(chans), valid, W, op)
    assert torch.equal(_bits(v_list), _bits(v_stack))
    assert torch.equal(a_list, a_stack)


def test_masked_rows_does_not_fall_back_off_the_cpu():
    x = torch.zeros(2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wr.masked_rows([x], torch.ones(2, 16, dtype=torch.bool,
                                       device="meta"), "add")


def _constant(name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  (CSRC / "masked_rows.cu").read_text())
    assert m, name
    return m.group(1)


def test_masked_geometry_matches_the_cuda_source():
    threads, items = int(_constant("MR_THREADS")), int(_constant("MR_ITEMS"))
    assert _constant("MR_TILE") == "MR_THREADS * MR_ITEMS"
    assert wr.MASKED_TILE == threads * items
    assert wr.MASKED_MAX_CH == int(_constant("MR_MAX_CH"))
    assert wr._MAX_GRID_Y == int(_constant("MR_MAX_GRID_Y"))


def _covers(plan: wr.MaskedPlan, R: int, T: int) -> None:
    """The kernel's grid visits every launched (row, tick) once, within
    CUDA's limits, and the launched rows hold the caller's."""
    assert plan.rows * plan.ticks == R * T
    assert (plan.blocks_x - 1) * wr.MASKED_TILE < plan.ticks
    assert plan.blocks_x * wr.MASKED_TILE >= plan.ticks
    assert plan.blocks_x <= 2**31 - 1
    assert 1 <= plan.blocks_y <= min(plan.rows, 65535)


# (R, T) of the main path's windows: qrs96's five (unit windows of 3072
# rows), ysb100's count, the keyed runner's short rows
MAIN = [(3072, 8665), (3072, 8660), (3072, 8655), (3072, 8620),
        (3072, 8591), (1600, 10000), (65536, 129), (100_000, 5), (7, 1)]


@pytest.mark.parametrize("R,T", MAIN)
def test_contiguous_inputs_launch_as_one_vector_row(R, T):
    """Inputs laid out as one run each (row stride T) launch as one row of
    R * T ticks, in the vector form wherever R * T is a multiple of 4."""
    plan = wr.masked_plan(R, T, [1 << 20, 1 << 24], [T, T], 1 << 28, T)
    _covers(plan, R, T)
    assert (plan.rows, plan.ticks) == (1, R * T)
    assert plan.vec == (R * T % 4 == 0)


@pytest.mark.parametrize("R,T", MAIN)
def test_row_strided_inputs_keep_their_rows(R, T):
    """A view into wider rows (qrs96's shifted 6- and 32-tick sums) keeps
    R rows; it is vector only where every row starts aligned."""
    s, off = T + 5, 5
    plan = wr.masked_plan(R, T, [(1 << 20) + 4 * off], [s], 1 << 28, T)
    _covers(plan, R, T)
    assert (plan.rows, plan.ticks, plan.vec) == (R, T, False)
    aligned = wr.masked_plan(R, T, [1 << 20], [T + 8], 1 << 28, T + 4)
    _covers(aligned, R, T)
    assert aligned.vec == (T % 4 == 0)


@pytest.mark.parametrize("x_addr,v_addr,vec", [
    (1 << 20, 1 << 28, True), ((1 << 20) + 4, 1 << 28, False),
    ((1 << 20) + 16, (1 << 28) + 2, False), ((1 << 20) + 32, 4, True)])
def test_vector_form_needs_aligned_bases(x_addr, v_addr, vec):
    plan = wr.masked_plan(3072, 8665, [x_addr], [8665], v_addr, 8665)
    assert plan.vec == vec
    _covers(plan, 3072, 8665)


def test_rows_beyond_the_grid_loop_in_the_kernel():
    plan = wr.masked_plan(200_000, 6, [1 << 20], [8], 1 << 28, 8)
    assert (plan.rows, plan.blocks_y) == (200_000, 65535)
    _covers(plan, 200_000, 6)


def test_a_broadcast_validity_is_read_in_place():
    """A validity shared by every row (stride 0) is not copied: the rows
    stay apart, the vector form needs only T % 4 == 0."""
    plan = wr.masked_plan(96, 1000, [1 << 20], [1000], 1 << 28, 0)
    assert (plan.rows, plan.ticks, plan.vec) == (96, 1000, True)
