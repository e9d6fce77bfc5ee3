"""The launch plans of K-Y (midranks) and K-AF (predict_head), on the CPU.

``ops/stats.py::midrank_plan`` picks K-Y's route (the ranks straight into
the output, or through row buckets placed as whole rows) and
``ops/linear.py::head_plan`` K-AF's warps a row, rows a block and blocks;
``csrc/stream_stats.cu`` and ``csrc/predict_head.cu`` take them as launch
arguments.  These tests replay the kernels' blocks in numpy: K-Y's segments,
warps, 32-position ballots, the carries across steps and warps and the
32-way warp search of the runs through a segment's ends, bit-equal to the
plain version on columns whose runs cross every boundary, at the ranks
blocks' 2,048 positions and the partition's 1,024; the partition's two
passes (each block's items by row bucket, runs appended to their regions
in any block order, each bucket placed by row) writing every entry of the
output slice once and nothing beside it;
K-AF's entry hanging on p alone, its lane groups summing as a warp a row,
its quarters covering every chunk of a row once in an order that does not
depend on the warps a row, and its grid covering every row once.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from transmogrifai_tpu_torch.ops import linear as L
from transmogrifai_tpu_torch.ops import stats as K

torch.set_num_threads(1)

#: the H100's SMs, and another card's, for the plans' grids
SM_COUNTS = (132, 114)


# ---------------------------------------------------------------------------
# K-Y
# ---------------------------------------------------------------------------
def _warp_partition(col, a, b, v, equal):
    """``warp_partition``: the first q in [a, b) failing ``col[q] == v``
    (equal) or ``col[q] < v``, by rounds of 32 evenly spaced probes."""
    test = (lambda x: x == v) if equal else (lambda x: x < v)
    while b - a > 32:
        step = (b - a + 31) >> 5
        m = sum(1 for lane in range(32) if a + lane * step < b and test(col[a + lane * step]))
        if m == 0:
            return a
        a, b = a + (m - 1) * step + 1, min(b, a + m * step)
    return a + sum(1 for q in range(a, b) if test(col[q]))


def _emulate_column(col, seg=K.RANK_SEG, warp_span=K.RANK_WARP_SPAN):
    """``segment_midranks``' lo + hi + 1 of one sorted column, position by
    position, as its blocks of ``seg`` positions compute them."""
    n = len(col)
    mid = np.empty(n, np.int64)
    for seg0 in range(0, n, seg):
        seg1 = min(n, seg0 + seg)
        back = seg0
        if seg0 > 0 and col[seg0 - 1] == col[seg0]:
            back = _warp_partition(col, 0, seg0, col[seg0], False)
        ahead = seg1
        if seg1 < n and col[seg1] == col[seg1 - 1]:
            ahead = _warp_partition(col, seg1 + 1, n, col[seg1 - 1], True)
        warps = []
        for base in range(seg0, seg0 + seg, warp_span):
            p = np.arange(base, min(base + warp_span, n))
            starts = p[(p == 0) | (col[p] != col[np.maximum(p - 1, 0)])] if len(p) else p
            warps.append((p, starts))
        for w, (p, starts) in enumerate(warps):
            if not len(p):
                continue
            lo_run = max([back] + [s[-1] for _, s in warps[:w] if len(s)])
            hi_run = min([ahead] + [s[0] for _, s in warps[w + 1:] if len(s)])
            i = np.searchsorted(starts, p, side="right")  # starts <= p
            ext = np.concatenate([[lo_run], starts, [hi_run]])
            lo, hi = ext[i], ext[i + 1]
            mid[p] = lo + hi + 1
    return mid


def _midrank_f32(lohi1):
    """``midrank_of``: the float32 cast of lo + hi + 1, halved."""
    return np.asarray(lohi1).astype(np.float32) * np.float32(0.5)


def _columns(rng, n, k, kind):
    return {"normal": lambda: rng.normal(size=(n, k)),
            "ties": lambda: rng.integers(0, 3, size=(n, k)),
            "few": lambda: rng.integers(0, 40, size=(n, k)),
            "constant": lambda: np.full((n, k), 1.5)}[kind]()


@pytest.mark.parametrize("n,kind", [(1, "normal"), (255, "ties"), (257, "ties"), (2047, "ties"),
                                    (2048, "ties"), (2049, "ties"), (6000, "ties"),
                                    (9000, "few"), (5000, "constant"), (4097, "normal")])
def test_midrank_blocks_replay_the_plain_ranks(n, kind):
    rng = np.random.default_rng(n)
    X = torch.from_numpy(_columns(rng, n, 2, kind))
    want = K.midranks_plain(X).numpy()
    ss = torch.sort(X.T.contiguous(), dim=1)[0].numpy()
    order = torch.sort(X.T.contiguous(), dim=1)[1].numpy()
    for c in range(2):
        for seg, span in ((K.RANK_SEG, K.RANK_WARP_SPAN), (K.PART_SPAN, K.PART_WARP_SPAN)):
            got = np.empty(n, np.float32)
            got[order[c]] = _midrank_f32(_emulate_column(ss[c], seg, span))
            assert np.array_equal(got, want[:, c])


def test_midrank_blocks_start_a_run_at_every_nan():
    """NaN (sorted last) is unequal to itself, so each NaN is a run of its
    own, as the parent kernel counted them."""
    col = np.array([0.0, 1.0, 1.0, np.nan, np.nan, np.nan])
    assert np.array_equal(_midrank_f32(_emulate_column(col)), [1, 2.5, 2.5, 4, 5, 6])


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 6), min_size=1, max_size=3000), st.data())
def test_warp_partition_finds_the_run_bounds(values, data):
    col = np.sort(np.asarray(values, np.float64))
    q = data.draw(st.integers(0, len(col) - 1))
    v = col[q]
    assert _warp_partition(col, 0, q + 1, v, False) == np.searchsorted(col, v, "left")
    assert _warp_partition(col, q, len(col), v, True) == np.searchsorted(col, v, "right")


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 4097, (1 << 18) + 5, 1 << 20, (1 << 21),
                               (1 << 21) + 1, 3 << 20])
@pytest.mark.parametrize("k,ld", [(1, 1), (1, 30), (4, 4), (17, 17), (24, 24), (25, 30),
                                  (40, 40), (128, 300), (512, 512)])
def test_midrank_plan_picks_a_route_and_sizes_it(n, k, ld):
    plan = K.midrank_plan(n, k, ld)
    assert plan.route in K.MIDRANK_ROUTES
    buckets = -(-n // K.PART_BUCKET_ROWS)
    if plan.route == "direct":
        assert n * ld * 4 <= K.MIDRANK_DIRECT_BYTES or buckets > K.PART_MAX_BUCKETS
        assert plan.segments == -(-n // K.RANK_SEG) and plan.scratch_bytes == plan.cursors == 0
        assert plan.groups == plan.buckets == 0
        return
    # one column's whole output (at most 2^21 rows) never takes the partition
    assert n * ld * 4 > K.MIDRANK_DIRECT_BYTES and not (k == 1 and ld == 1)
    assert plan.buckets == buckets <= K.PART_MAX_BUCKETS
    assert plan.groups == -(-k // K.PART_GROUP_COLS) and plan.segments == -(-n // K.PART_SPAN)
    # each (group, bucket) region holds every item of its rows and columns
    assert plan.scratch_bytes == plan.groups * plan.buckets * K.PART_BUCKET_ROWS \
        * K.PART_GROUP_COLS * 8 and plan.cursors == plan.groups * plan.buckets
    # the packed item's fields: lo + hi + 1 < 2^31, a bucket's row < 2^11,
    # the group's column < 2^3, the bucket < 2^10
    assert 2 * n < 1 << 31 and K.PART_BUCKET_ROWS == 1 << 11
    assert K.PART_GROUP_COLS == 8 and K.PART_MAX_BUCKETS == 1 << 10


@pytest.mark.parametrize("n,k,ld", [(1, 1, 1), (1000, 3, 3), (100000, 23, 23), (1 << 20, 4, 4),
                                    (1 << 20, 24, 24), (1 << 21, 24, 30)])
def test_midrank_plan_takes_the_route_asked_for(n, k, ld):
    """Either route on any shape the partition takes (both are timed on
    one shape that way), the same plan as the chosen route's, and no
    unknown route."""
    chosen = K.midrank_plan(n, k, ld)
    for route in K.MIDRANK_ROUTES:
        plan = K.midrank_plan(n, k, ld, route)
        assert plan.route == route
        if route == chosen.route:
            assert plan == chosen
    with pytest.raises(ValueError):
        K.midrank_plan(n, k, ld, "transpose")


def test_midrank_partition_refuses_past_its_buckets():
    n = K.PART_MAX_BUCKETS * K.PART_BUCKET_ROWS
    assert K.midrank_plan(n, 24, 24).route == "partition"
    assert K.midrank_plan(n + 1, 24, 24).route == "direct"
    with pytest.raises(ValueError):
        K.midrank_plan(n + 1, 24, 24, "partition")


def _pack(lohi1, row, cl, bucket):
    """``pack_item``."""
    return (int(lohi1) | ((int(row) & (K.PART_BUCKET_ROWS - 1)) << 31) | (int(cl) << 42)
            | (int(bucket) << 45))


@pytest.mark.parametrize("n,k,ld,kind", [(5000, 10, 10, "ties"), (4097, 3, 5, "few"),
                                         (2048, 9, 9, "normal"), (6500, 16, 20, "constant")])
def test_midrank_partition_replays_the_plain_ranks(n, k, ld, kind):
    """The partition route's two passes in numpy: each block's items by
    bucket, runs appended to their (group, bucket) regions in an arbitrary
    block order, every region full, each bucket placed by its items' rows
    and written as rows of 8 columns: the slice equal to the plain ranks."""
    rng = np.random.default_rng(n + k)
    X = torch.from_numpy(_columns(rng, n, k, kind))
    want = K.midranks_plain(X).numpy()
    ss, order = (a.numpy() for a in torch.sort(X.T.contiguous(), dim=1))
    G, B = -(-k // K.PART_GROUP_COLS), -(-n // K.PART_BUCKET_ROWS)
    cap = K.PART_BUCKET_ROWS * K.PART_GROUP_COLS
    lohi = np.stack([_emulate_column(ss[c], K.PART_SPAN, K.PART_WARP_SPAN) for c in range(k)])
    buf = np.full((G, B, cap), -1, np.int64)
    cursors = np.zeros((G, B), np.int64)
    blocks = [(s, g) for g in range(G) for s in range(-(-n // K.PART_SPAN))]
    for s, g in [blocks[i] for i in rng.permutation(len(blocks))]:
        seg0 = s * K.PART_SPAN
        items = []
        for cl in range(min(K.PART_GROUP_COLS, k - g * K.PART_GROUP_COLS)):
            c = g * K.PART_GROUP_COLS + cl
            for p in range(seg0, min(n, seg0 + K.PART_SPAN)):
                row = int(order[c, p])
                items.append(_pack(lohi[c, p], row, cl, row // K.PART_BUCKET_ROWS))
        items = [items[i] for i in rng.permutation(len(items))]  # the cursors' order is free
        for b in range(B):
            run = [it for it in items if it >> 45 == b]
            base = cursors[g, b]
            cursors[g, b] += len(run)
            buf[g, b, base:base + len(run)] = run
    out = np.full((n, ld), -1.0, np.float32)
    for g in range(G):
        gc = min(K.PART_GROUP_COLS, k - g * K.PART_GROUP_COLS)
        for b in range(B):
            rows = min(K.PART_BUCKET_ROWS, n - b * K.PART_BUCKET_ROWS)
            assert cursors[g, b] == rows * gc
            tile = np.full((K.PART_BUCKET_ROWS, K.PART_GROUP_COLS), np.nan, np.float32)
            for it in buf[g, b, :rows * gc]:
                it = int(it)
                tile[(it >> 31) & (K.PART_BUCKET_ROWS - 1), (it >> 42) & 7] = \
                    _midrank_f32(it & 0x7FFFFFFF)
            r0, c0 = b * K.PART_BUCKET_ROWS, g * K.PART_GROUP_COLS
            out[r0:r0 + rows, c0:c0 + gc] = tile[:rows, :gc]
    assert np.array_equal(out[:, :k], want) and (out[:, k:] == -1.0).all()


def test_midranks_into_a_slice_on_the_cpu():
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.integers(0, 9, size=(500, 4)).astype(np.float32))
    wide = torch.full((500, 7), -1.0)
    got = K.midranks(X, out=wide[:, 2:6])
    assert got.data_ptr() == wide[:, 2:6].data_ptr()
    assert torch.equal(wide[:, 2:6], K.midranks_plain(X))
    assert bool((wide[:, [0, 1, 6]] == -1.0).all())
    with pytest.raises(ValueError):
        K.midranks(X, out=torch.empty((500, 5)))


# ---------------------------------------------------------------------------
# K-AF
# ---------------------------------------------------------------------------
def _quarter_turns(p, S):
    """{warp s: [(lane, turn, quarter, chunk)]} of a row cut over S warps,
    as ``dot_head_kernel``'s ``chunk_of`` gives them."""
    nq = L.HEAD_QUARTERS // S
    C = -(-p // 4)
    Cq = -(-C // L.HEAD_QUARTERS)
    items = -(-Cq // 32) * nq
    out = {}
    for s in range(S):
        out[s] = [(lane, t, s + (t % nq) * S, (s + (t % nq) * S) * Cq + lane + 32 * (t // nq))
                  for lane in range(32) for t in range(items)
                  if lane + 32 * (t // nq) < Cq
                  and (s + (t % nq) * S) * Cq + lane + 32 * (t // nq) < C]
    return out


@pytest.mark.parametrize("p", [0, 1, 3, 4, 7, 10, 16, 33, 127, 128, 129, 1000, 1023, 1024, 1027,
                               4096, 5001])
def test_head_quarters_take_every_chunk_once_in_a_fixed_order(p):
    C = -(-p // 4)
    Cq = -(-C // L.HEAD_QUARTERS)
    orders = []
    for S in (1, 2, 4):
        turns = _quarter_turns(p, S)
        chunks = sorted(m for s in turns for (_, _, _, m) in turns[s])
        assert chunks == list(range(C))
        # a chunk's quarter and lane, and its place in its lane's chain
        order = {}
        for s, items in turns.items():
            for lane, t, q, m in items:
                assert q == m // Cq and lane == (m - q * Cq) % 32
                order[m] = (q, lane, (m - q * Cq) // 32)
        orders.append(order)
    assert orders[0] == orders[1] == orders[2]


def _butterfly(v, lanes):
    """``warp_sum`` over groups of ``lanes`` lanes (xor lanes / 2, ..., 1)."""
    v = v.astype(np.float32)
    o = lanes // 2
    while o:
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
        o //= 2
    return v


@pytest.mark.parametrize("p", range(1, L.HEAD_NARROW_MAX + 1))
def test_head_lane_groups_sum_as_a_warp_a_row(p):
    """The lane groups' sums: a row on the power of two of lanes at or above
    p, 32 / lanes rows a warp, the products (one FMA onto 0) summed by the
    group's butterfly, equal to the warp-a-row butterfly of the parent
    kernel on the same products (the lanes past p hold 0)."""
    assert L.head_plan(1000, p, 1, SM_COUNTS[0], "binary").split == 32  # a warp a row
    plan = L.head_plan(1 << 20, p, 1, SM_COUNTS[0], "binary")
    lanes = plan.split
    assert plan.entry == "lane_groups" and lanes >= p and lanes & (lanes - 1) == 0
    assert lanes == 1 or lanes // 2 < p
    assert plan.rows_per_block == L.HEAD_WARPS * (32 // lanes) * plan.batches
    rng = np.random.default_rng(p)
    X = rng.normal(size=(32 // lanes, p)).astype(np.float32)
    w = rng.normal(size=p).astype(np.float32)
    prods = (X.astype(np.float64) * w).astype(np.float32)
    group = np.zeros(32, np.float32)
    for r in range(32 // lanes):
        group[r * lanes:r * lanes + p] = prods[r]
    got = _butterfly(group, lanes)
    for r in range(32 // lanes):
        alone = np.zeros(32, np.float32)
        alone[:p] = prods[r]
        assert got[r * lanes] == _butterfly(alone, 32)[0]


def _emulate_head(X, w, b, S):
    """The dot head's z in float32 as the kernel sums it at S warps a row:
    each lane's FMA chain of a quarter, a butterfly a quarter, the quarters
    in order, then the intercept."""
    n, p = X.shape
    f32 = np.float32
    z = np.empty(n, f32)
    turns = _quarter_turns(p, S)
    for r in range(n):
        acc = np.zeros((L.HEAD_QUARTERS, 32), f32)
        for s in range(S):
            for lane, t, q, m in sorted(turns[s], key=lambda x: (x[0], x[1])):
                for j in range(4 * m, min(4 * m + 4, p)):
                    acc[q, lane] = f32(np.float64(X[r, j]) * np.float64(w[j])
                                       + np.float64(acc[q, lane]))
        quarter = []
        for q in range(L.HEAD_QUARTERS):
            v = acc[q].copy()
            for o in (16, 8, 4, 2, 1):
                v = (v + v[np.arange(32) ^ o]).astype(f32)
            quarter.append(v[0])
        z[r] = f32(f32(f32(f32(quarter[0] + quarter[1]) + quarter[2]) + quarter[3]) + f32(b))
    return z


def _emulate_groups(X, w, b):
    """The lane groups' z: the products summed by a warp's butterfly, + b."""
    z = np.empty(X.shape[0], np.float32)
    for r in range(X.shape[0]):
        v = np.zeros(32, np.float32)
        v[:X.shape[1]] = (X[r].astype(np.float64) * w).astype(np.float32)
        z[r] = _butterfly(v, 32)[0]
    return (z + np.float32(b)).astype(np.float32)


@pytest.mark.parametrize("p", [1, 10, 16, 32, 33, 85, 300])
def test_head_emulated_sums_hold_the_plain_head(p):
    """The entry hangs on p alone (so a row's answer on the batch neither),
    the quarters' order on the warps a row neither; both within float32
    sums of the plain head."""
    rng = np.random.default_rng(p)
    X = rng.normal(size=(6, p)).astype(np.float32)
    w = (rng.normal(size=p) / np.sqrt(p)).astype(np.float32)
    b = np.float32(0.3)
    entries = {L.head_plan(n, p, 1, sms, mode).entry for n in (1, 64, 1024, 1 << 20)
               for sms in SM_COUNTS for mode in ("binary", "linear")}
    assert entries == {"lane_groups" if p <= L.HEAD_NARROW_MAX else "quarters"}
    if p <= L.HEAD_NARROW_MAX:
        z = _emulate_groups(X, w, b)
    else:
        zs = [_emulate_head(X, w, b, S) for S in (1, 2, 4)]
        assert np.array_equal(zs[0], zs[1]) and np.array_equal(zs[0], zs[2])
        z = zs[0]
    want = L.predict_head_plain(torch.from_numpy(X), torch.from_numpy(w),
                                torch.tensor([b]), "linear")[0].numpy()
    np.testing.assert_allclose(z, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("mode", ["binary", "linear", "softmax"])
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 300, 527, 528, 1000, 1024, 1056, 4097,
                               1 << 18, (1 << 20) + 3])
@pytest.mark.parametrize("p", [0, 1, 10, 16, 32, 33, 127, 255, 256, 1024, 5000])
def test_head_plan_covers_every_row_once(sms, mode, n, p):
    k = 26 if mode == "softmax" else 1
    plan = L.head_plan(n, p, k, sms, mode)
    S = plan.split
    assert plan.entry == ("softmax" if mode == "softmax" else
                          "lane_groups" if 1 <= p <= L.HEAD_NARROW_MAX else "quarters")
    groups = -(-n // plan.rows_per_block)
    assert 1 <= plan.blocks <= groups
    assert plan.entry == "lane_groups" or plan.batches == 1
    if plan.entry == "softmax":
        assert S == 1 and plan.rows_per_block == L.HEAD_WARPS and plan.blocks <= 4096
    elif plan.entry == "lane_groups":
        assert S >= p and S & (S - 1) == 0 and plan.blocks <= sms * 8
        assert S == (32 if n <= L.HEAD_WARPS * sms * 8 else 1 << (p - 1).bit_length())
        # four row sets a warp below 32 lanes a row; at 32 only where one
        # set a warp would overfill the card's blocks
        one_set = L.HEAD_WARPS * (32 // S)
        assert plan.batches == (L.HEAD_GROUP_BATCHES if S < 32 or n > one_set * sms * 8 else 1)
        assert plan.rows_per_block == one_set * plan.batches
    else:
        assert S in (1, 2, 4) and plan.rows_per_block * S == L.HEAD_WARPS
        assert plan.blocks <= sms * 8
        # split only where the rows leave the card short of a block an SM
        # and each warp keeps two chunks a lane
        if S > 1:
            assert n * S // 2 < sms * L.HEAD_WARPS and -(-p // 4) >= 64 * S
        if S < 4 and n * S < sms * L.HEAD_WARPS:
            assert -(-p // 4) < 64 * 2 * S
    if groups <= 1 << 12:
        seen = np.zeros(groups * plan.rows_per_block, np.int64)
        for block in range(plan.blocks):
            for g in range(block, groups, plan.blocks):
                seen[g * plan.rows_per_block:(g + 1) * plan.rows_per_block] += 1
        assert (seen[:n] == 1).all()


def test_head_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        L.head_plan(0, 10, 1, 132, "binary")
    with pytest.raises(ValueError):
        L.head_plan(10, 10, 1, 132, "probit")
    with pytest.raises(ValueError):
        L.head_plan(10, 10, 1, 0, "linear")
