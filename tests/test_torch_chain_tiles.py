"""The Hopper canonical T and chain kernels' addressing, on the CPU.

A Python mirror of the row-map arithmetic of ``ops/csrc/block_sm90.cuh``
(``fast_div`` / ``fdiv``, ``make_map``'s ``lin``, ``strided_tile`` and
``StridedTile::off``) walks every tile of every block under the tile plans
the wrappers hand the kernels (``chain_plans``: ``sm90_plan`` of each axis)
and the row maps of ``chain_plan``: each block must read every row of its
input and write every row of its output exactly once, at the rows the plain
formula gives (``_torch_parity.walk_chain_plan``, which
``tests/test_torch_chain.py`` holds against ``chain_ref``).  The divisions are
multiply-highs, so they are checked for exactness on their own.  Exact
integer arithmetic throughout: no tolerance."""

import numpy as np
import pytest
import torch

from _torch_parity import block_params
from tante_tpu_torch.ops import fused_block as tblock

FLAGSHIP = (4, 16, 48)  # (T, H, W) of the flagship latent, B = 8


def fast_div(d: int) -> tuple:
    """``block_sm90.cuh:fast_div``: (mul, shift) with n / d = (umulhi(n, mul)
    + n) >> shift for 0 <= n < 2^31."""
    shift = 0
    while (1 << shift) < d:
        shift += 1
    return ((1 << 32) * ((1 << shift) - d)) // d + 1 & 0xFFFFFFFF, shift


def fdiv(n, mul: int, shift: int):
    """``fdiv``, on Python ints or uint64 numpy arrays (32-bit sum)."""
    return (((n * mul) >> 32) + n & 0xFFFFFFFF) >> shift


class RowMap:
    """``make_map``: the six ints of a ``chain_plan`` map, the multipliers,
    ``lin`` (2: every sequence s2 rows after the one before; 1: within a
    batch element; 0: neither, or a tensor of 2^32 elements or more) and the
    element strides sa*C and (s2 - L*sa)*C modulo 2^32."""

    def __init__(self, ints, l: int, c: int, elems: int):
        self.per, self.n2, self.sb, self.s1, self.s2, self.sa = ints
        assert self.per >= 1 and self.n2 >= 1 and self.per % self.n2 == 0
        self.div_per, self.div_n2 = fast_div(self.per), fast_div(self.n2)
        lines = self.s1 == self.n2 * self.s2
        self.lin = 2 if lines and self.sb == (self.per // self.n2) * self.s1 else int(lines)
        if elems >= 1 << 32:
            self.lin = 0
        self.c = c
        self.sa_c = self.sa * c & 0xFFFFFFFF
        self.d_c = (self.s2 - l * self.sa) * c & 0xFFFFFFFF

    def split(self, g):
        b = fdiv(g, *self.div_per)
        r = g - b * self.per
        i = fdiv(r, *self.div_n2)
        return b, i, r - i * self.n2


def tile_rows(m: RowMap, l: int, seq0: int, nseq: int) -> tuple:
    """``strided_tile`` + ``off(r)`` for every valid row r of one tile: the
    rows (element offsets over C), and whether the tile took the evenly
    spaced path (base + r*sa*C + s*(s2 - L*sa)*C in 32-bit arithmetic)."""
    div_l = fast_div(l)
    b0, i0, j0 = m.split(seq0)
    b1, i1, _ = m.split(seq0 + nseq - 1)
    lin = m.lin == 2 or (b0 == b1 and (m.lin == 1 or i0 == i1))
    base = (b0 * m.sb + i0 * m.s1 + j0 * m.s2) * m.c
    rows = []
    for r in range(nseq * l):
        s = fdiv(r, *div_l)
        if lin:
            off = base + ((r * m.sa_c & 0xFFFFFFFF) + (s * m.d_c & 0xFFFFFFFF) & 0xFFFFFFFF)
        else:
            b, i, j = m.split(seq0 + s)
            off = (b * m.sb + i * m.s1 + j * m.s2 + (r - s * l) * m.sa) * m.c
        assert off % m.c == 0
        rows.append(off // m.c)
    return rows, lin


def plain_rows(ints, l: int, n_seqs: int) -> np.ndarray:
    """The rows of (sequence, token) by ``walk_chain_plan``'s formula."""
    per, n2, sb, s1, s2, sa = ints
    seq = np.arange(n_seqs)
    b, r = seq // per, seq % per
    return ((b * sb + (r // n2) * s1 + (r % n2) * s2)[:, None] + np.arange(l) * sa).reshape(-1)


def walk(axes: str, dims, b: int, c: int, start: str, stop: str) -> list:
    """Every block of a run, tile by tile as the kernel's CTAs take them:
    per block (read rows, write rows, tiles on the evenly spaced path, tiles)."""
    plans = tblock.chain_plans(axes, dims, c, c)
    out = []
    for plan, row in zip(plans, tblock.chain_plan(axes, dims, b, start, stop)):
        l, _, n_seqs = row[:3]
        m_in, m_out = (RowMap(row[k:k + 6], l, c, n_seqs * l * c) for k in (3, 9))
        reads, writes, linear, tiles = [], [], 0, -(-n_seqs // plan.seqs)
        for tile in range(tiles):
            seq0 = tile * plan.seqs
            nseq = min(plan.seqs, n_seqs - seq0)
            assert nseq * l <= plan.rows
            got_in, lin_in = tile_rows(m_in, l, seq0, nseq)
            got_out, lin_out = tile_rows(m_out, l, seq0, nseq)
            reads += got_in
            writes += got_out
            linear += lin_in and lin_out
        assert reads == plain_rows(row[3:9], l, n_seqs).tolist()
        assert writes == plain_rows(row[9:15], l, n_seqs).tolist()
        out.append((reads, writes, linear, tiles))
    return out


@pytest.mark.parametrize("d", [*range(1, 70), 96, 128, 192, 768, 1000, 3072, 24576, 98304,
                               (1 << 20) + 7, (1 << 30) + 1, (1 << 31) - 1])
def test_fast_division_is_exact(d):
    mul, shift = fast_div(d)
    n = np.concatenate([np.arange(1 << 16, dtype=np.uint64),
                        np.random.default_rng(d).integers(0, 1 << 31, 1 << 14).astype(np.uint64),
                        np.array([(1 << 31) - 1, d - 1, d, d + 1, 2 * d - 1], dtype=np.uint64)])
    n = n[n < (1 << 31)]
    assert np.array_equal(fdiv(n, np.uint64(mul), np.uint64(shift)), n // np.uint64(d))


# (axes, (T, H, W), B, C): the flagship, the chain tests' ragged geometry,
# T = 1 and 2, C = 192 (the 128-row plan) and 512 (the 64-row plan).
CASES = [
    ("THWTHWTHW", FLAGSHIP, 8, 256),
    ("THW", FLAGSHIP, 3, 256),
    ("THW", (4, 6, 5), 2, 64),
    ("HW", (4, 6, 5), 2, 64),
    ("WT", (4, 6, 5), 2, 64),
    ("TH", (2, 5, 7), 3, 128),
    ("WWH", (4, 6, 5), 2, 64),
    ("HWTHW", (8, 4, 8), 2, 128),
    ("THW", (1, 3, 5), 2, 64),
    ("THW", (3, 6, 10), 1, 192),
    ("THW", (4, 6, 10), 2, 512),
    ("THWTHWTHWTHW", (4, 8, 12), 2, 128),
]


@pytest.mark.parametrize("axes,dims,b,c", CASES)
@pytest.mark.parametrize("orders", ["canonical", "chain"])
def test_chain_tiles_read_and_write_every_row_once(axes, dims, b, c, orders):
    """``fused_group_apply`` (canonical in and out) and ``fused_chain_apply``
    (first axis's token order in, last's out)."""
    start, stop = ((tblock._CANONICAL, tblock._CANONICAL) if orders == "canonical"
                   else (tblock._ORDER[axes[0]], tblock._ORDER[axes[-1]]))
    m = b * dims[0] * dims[1] * dims[2]
    for reads, writes, _, _ in walk(axes, dims, b, c, start, stop):
        assert sorted(reads) == list(range(m))
        assert sorted(writes) == list(range(m))


def test_flagship_tiles_all_take_the_evenly_spaced_path():
    """At the flagship no tile wraps a line or a batch element: every row
    offset is two 32-bit multiply-adds after one division (by L)."""
    for start, stop in [("thw", "thw"), ("hwt", "thw")]:
        for _, _, linear, tiles in walk("THWTHWTHW", FLAGSHIP, 8, 256, start, stop):
            assert linear == tiles


def test_ragged_tiles_take_the_general_path_and_stay_exact():
    """105 canonical T sequences of 35 pixels in tiles of 32 cross batch
    elements: those tiles decompose each sequence (and still cover every
    row once, checked in ``walk``)."""
    (reads, _, linear, tiles), = walk("T", (4, 5, 7), 3, 256, "thw", "thw")
    assert tiles == 4 and linear < tiles


@pytest.mark.parametrize("dims,b,c", [(FLAGSHIP, 8, 256), ((2, 5, 7), 2, 128),
                                      ((3, 5, 7), 3, 256), ((8, 3, 11), 2, 512),
                                      ((2, 9, 9), 1, 512)])
def test_canonical_t_map_covers_every_row_once(dims, b, c):
    """The canonical T kernel's one map, read and written under the plan of
    L = T, with ragged last tiles where the pixel count leaves one."""
    t, h, w = dims
    ints = tblock.canon_t_map(dims, b)
    assert ints == tblock.chain_plan("T", dims, b)[0][3:9]
    assert ints == (h * w, w, t * h * w, w, 1, h * w)
    plan = tblock.sm90_plan(t, c, c)
    n_seqs = b * h * w
    m = RowMap(ints, t, c, n_seqs * t * c)
    rows = []
    for tile in range(-(-n_seqs // plan.seqs)):
        seq0 = tile * plan.seqs
        rows += tile_rows(m, t, seq0, min(plan.seqs, n_seqs - seq0))[0]
    assert rows == plain_rows(ints, t, n_seqs).tolist()
    assert sorted(rows) == list(range(n_seqs * t))


@pytest.mark.parametrize("axes,dims,c,hidden", [("THWTHWTHW", FLAGSHIP, 256, 256),
                                                ("THW", (2, 64, 1), 512, 1024),
                                                ("WH", (4, 6, 5), 64, 128)])
def test_each_chain_step_plan_is_its_axis_sm90_plan(axes, dims, c, hidden):
    sizes = dict(zip("THW", dims))
    plans = tblock.chain_plans(axes, dims, c, hidden)
    assert plans == [tblock.sm90_plan(sizes[a], c, hidden) for a in axes]
    # One shared-memory layout for the run: rows, passes and stages agree.
    assert len({(p.rows, p.np, p.stages) for p in plans}) == 1


def test_every_fusable_chain_has_plans():
    """The gate ``group_fusable`` did not narrow: every chain it admits gets
    a plan for each block, and the plans share one layout."""
    for c in range(64, 513, 64):
        for hidden in range(64, 2 * c + 1, 64):
            for dims in [(1, 64, 33), (4, 16, 48), (64, 2, 7)]:
                assert tblock.group_fusable("THW", dims, c, c // 16, hidden)
                plans = tblock.chain_plans("THW", dims, c, hidden)
                assert len({(p.rows, p.np, p.stages) for p in plans}) == 1


def test_chain_weight_schedule_is_each_blocks_sm90_weights_once_per_version():
    axes, heads = "THW", 4
    ps = [tblock.BlockParams(*(torch.from_numpy(np.asarray(t)).to(torch.bfloat16)
                               for t in block_params(64, 64, seed=i))) for i in range(3)]
    plans = tblock.chain_plans(axes, (4, 6, 5), 64, 64)
    first = tblock.chain_weights(ps, heads, plans)
    assert all(w is tblock.sm90_weights(p, heads, plan)
               for w, p, plan in zip(first, ps, plans))
    again = tblock.chain_weights(ps, heads, plans)
    assert all(a is f for a, f in zip(again, first))  # re-laid once per weight version
    # Back to back: the kernel's pointer array is the blocks' nine each, in order.
    ptrs = list(tblock._ptr_array(first))
    assert ptrs == [t.data_ptr() for w in first for t in w]
    with torch.no_grad():
        ps[1].w2.mul_(2.0)  # an optimizer step on the second block only
    third = tblock.chain_weights(ps, heads, plans)
    assert third[0] is first[0] and third[2] is first[2] and third[1] is not first[1]


def tile_batches(per: int, seq0: int, nseq: int) -> tuple:
    """``fused_chain_sm90.cu:tile_batches``: the batch elements of a tile."""
    d = fast_div(per)
    return fdiv(seq0, *d), fdiv(seq0 + nseq - 1, *d)


def chain_tiles(axes, dims, b, c, start, stop) -> list:
    """Per block: its tiles as (batch range, rows read, rows written)."""
    out = []
    for plan, row in zip(tblock.chain_plans(axes, dims, c, c),
                         tblock.chain_plan(axes, dims, b, start, stop)):
        l, _, n_seqs = row[:3]
        per = row[3]
        assert row[9] == per and per * b == n_seqs
        tiles = []
        for tile in range(-(-n_seqs // plan.seqs)):
            seq0 = tile * plan.seqs
            nseq = min(plan.seqs, n_seqs - seq0)
            reads = tile_rows(RowMap(row[3:9], l, c, n_seqs * l * c), l, seq0, nseq)[0]
            writes = tile_rows(RowMap(row[9:15], l, c, n_seqs * l * c), l, seq0, nseq)[0]
            tiles.append((tile_batches(per, seq0, nseq), reads, writes, per, plan.seqs))
        out.append(tiles)
    return out


@pytest.mark.parametrize("axes,dims,b,c", CASES)
def test_chain_schedule_waits_cover_every_conflict(axes, dims, b, c):
    """A tile of block i waits for block i - 1's tiles of its batch elements
    (``wait_inputs``): enough when every tile reads and writes only rows of
    its own batch elements (of m = T*H*W rows each), and when ``need`` is
    the number of block i - 1's tiles that touch a batch element."""
    m = dims[0] * dims[1] * dims[2]
    for orders in [("thw", "thw"), (tblock._ORDER[axes[0]], tblock._ORDER[axes[-1]])]:
        blocks = chain_tiles(axes, dims, b, c, *orders)
        for i, tiles in enumerate(blocks):
            for (b0, b1), reads, writes, per, seqs in tiles:
                assert all(b0 <= r // m <= b1 for r in reads + writes)
            for bb in range(b):
                need = ((bb + 1) * per - 1) // seqs - (bb * per) // seqs + 1
                assert need == sum(b0 <= bb <= b1 for (b0, b1), *_ in tiles)


@pytest.mark.parametrize("axes,dims,b,c", CASES)
@pytest.mark.parametrize("grid", [1, 7, 132])
def test_chain_schedule_runs_to_its_end(axes, dims, b, c, grid):
    """The schedule on ``grid`` CTAs, each taking its tiles (g, g + grid, ...
    of all blocks' tiles in one sequence) in order and starting one only
    when its waits are met: every tile runs, whatever the grid."""
    blocks = chain_tiles(axes, dims, b, c, "thw", "thw")
    order = [(i, t) for i, tiles in enumerate(blocks) for t in range(len(tiles))]
    queues = [order[g::grid] for g in range(min(grid, len(order)))]
    done = np.zeros((len(blocks), b), dtype=np.int64)
    while any(queues):
        progressed = False
        for q in queues:
            if not q:
                continue
            i, t = q[0]
            (b0, b1), _, _, _, _ = blocks[i][t]
            if i > 0:
                _, _, _, per, seqs = blocks[i - 1][0]
                if any(done[i - 1, bb] < ((bb + 1) * per - 1) // seqs - (bb * per) // seqs + 1
                       for bb in range(b0, b1 + 1)):
                    continue
            done[i, b0:b1 + 1] += 1
            q.pop(0)
            progressed = True
        assert progressed, "the schedule would wait forever"
