"""Inputs that the port's CPU tests and its card tests share; this module
holds no test. It imports numpy and the port only, so the card tests can
import it where JAX is not installed."""
import numpy as np

K16_TILE = 1024        # rows a block of K16's grid (csrc/band_partition.cu)
PARTITION_CASES = ["band_edges", "uneven_samples", "ragged_m", "cap_cut"]


def partition_rows(rng, valid, m, bands, cap0=None):
    """Random level-0 rows for the band partition: coords [B, M, 3] int32
    (valid[b] rows of sample b, then -1 padding) on a grid of `bands` bands
    of 64 y-rows with a halo of 8, F = 4 feature rows, and the band spec
    (cap0 defaults to M: no overflow)."""
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    b = len(valid)
    coords = np.stack([rng.integers(0, 4, (b, m)),
                       rng.integers(0, 64 * bands, (b, m)),
                       rng.integers(0, 32, (b, m))], -1).astype(np.int32)
    coords[np.arange(m)[None] >= np.asarray(valid)[:, None]] = -1
    rows = rng.normal(size=(b, m, 4)).astype(np.float32)
    spec = ss.BandSpec(bands, 64, 8, (cap0 or max(m, 1), 8, 8, 8))
    return coords, rows, spec


def partition_case(case):
    """The band partition's edge cases over 4 bands: band_edges rows with y
    on every band's lo - 1, lo, hi - 1 and hi, padding between them;
    uneven_samples three samples of 700, 300 and 0 rows; ragged_m one row
    more than a tile; cap_cut a level-0 cap that drops members. Returns
    (coords, rows, spec)."""
    rng = np.random.default_rng(PARTITION_CASES.index(case))
    if case == "band_edges":
        coords, rows, spec = partition_rows(rng, [300, 300], 300, 4)
        edges = sorted({y for s in range(4)
                        for y in (64 * s - 9, 64 * s - 8, 64 * s + 71,
                                  64 * s + 72) if 0 <= y < 256})
        coords[:, :len(edges), 1] = edges
        coords[:, len(edges)::7] = -1
        return coords, rows, spec
    if case == "uneven_samples":
        return partition_rows(rng, [700, 300, 0], 700, 4)
    if case == "ragged_m":
        return partition_rows(rng, [K16_TILE + 1, 900], K16_TILE + 1, 4)
    return partition_rows(rng, [1500, 1200], 1500, 4, cap0=200)


# K9's cases: (config, kind). "edges": two samples, padding rows between
# the voxels and voxels on the grid's first and last rows and columns,
# each twice; "empty_sample": the second sample all padding; "at_cap_b1":
# one sample of max_voxels rows; "past_last_corner": a corner table cut to
# the anchors of the lower-left quarter, so that cells past the last
# corner row and column hold voxels
K9_CASES = {"tiny_edges": ("tiny_config", "edges"),
            "tiny_empty_sample": ("tiny_config", "empty_sample"),
            "car_edges": ("car_config", "edges"),
            "car_empty_sample": ("car_config", "empty_sample"),
            "car_at_cap_b1": ("car_config", "at_cap_b1"),
            "car_past_last_corner": ("car_config", "past_last_corner"),
            "multi_edges": ("multi_config", "edges"),
            "long_range_edges": ("long_range_config", "edges"),
            "car_tall_lattice": ("car_config", "tall_lattice")}


def k9_case(case):
    """(config, corner table [A, 4] int32, grid (H, W), coords [B, V, 3]
    int32) of a K9 case. The first sample's voxels lie in the lower half of
    the grid (the lower quarter where the table is cut to the lower-left
    quarter), so that some anchors pass the mask and some do not. The tall
    lattice adds a thin anchor at every grid row, so that the lattice has
    a row for each (more than K9's column scan holds in registers a
    chunk)."""
    from sassd_tpu_torch import config, serve
    from sassd_tpu_torch.data import kitti
    name, kind = K9_CASES[case]
    rng = np.random.default_rng(list(K9_CASES).index(case))
    cfg = getattr(config, name)()
    _, anchors_bv = kitti.build_anchors(cfg)
    corners = serve.anchor_corner_indices(
        anchors_bv, cfg.voxel.voxel_size, cfg.voxel.point_cloud_range,
        cfg.voxel.grid_size)
    d, h, w = cfg.sparse_shape
    if kind == "past_last_corner":
        corners = corners[(corners[:, 2] < w // 2) & (corners[:, 3] < h // 2)]
    if kind == "tall_lattice":
        ys = np.arange(h - 1, dtype=np.int32)
        thin = np.stack([np.full_like(ys, 10), ys, np.full_like(ys, 30),
                         ys + 1], 1)
        corners = np.concatenate([corners, thin])
    v = cfg.voxel.max_voxels
    coords = np.full((1 if kind == "at_cap_b1" else 2, v, 3), -1, np.int32)

    def fill(b, n, y_hi):
        coords[b, :n] = np.stack([rng.integers(0, d, n),
                                  rng.integers(0, y_hi, n),
                                  rng.integers(0, w, n)], 1)
    fill(0, v if kind == "at_cap_b1" else 2 * v // 3,
         h // 4 if kind == "past_last_corner" else h // 2)
    if kind != "at_cap_b1":
        if kind != "empty_sample":
            fill(1, v // 3, h)
        edge = [(y, x) for y in (0, h // 2, h - 1) for x in (0, w // 2, w - 1)]
        coords[0, :2 * len(edge), 1:] = edge + edge
        coords[0, 2 * len(edge)::7] = -1
    return cfg, corners, (h, w), coords


# K12's cases, each two samples: "faces" points exactly on each face of
# axis-aligned boxes (|lx| = w/2, |ly| = l/2, |dz| = h/2: inside) and one
# float32 step past them (outside); "overlap" points in two overlapping
# valid boxes (the first slot wins), the order reversed in the second
# sample; "invalid_first" invalid slots that hold the point before the
# valid winner; "no_valid_box" a first sample whose slots are all invalid;
# "all_padded" a first sample whose points are all padding; "full_slots"
# 64 valid slots; "interleaved" 64 slots, every other one invalid
K12_CASES = ["faces", "overlap", "invalid_first", "no_valid_box",
             "all_padded", "full_slots", "interleaved"]


def k12_case(case):
    """(points [2, N, 3] float32, points_valid [2, N] bool, gt_boxes [2, G,
    7] float32, gt_valid [2, G] bool, want [2, N] int) of a K12 case: random
    car-sized boxes with points around them, then the case's points placed
    by hand. want: the slot whose box a placed point must take (G: none),
    -1 for the random points."""
    rng = np.random.default_rng(100 + K12_CASES.index(case))
    g = 64 if case in ("full_slots", "interleaved") else 8
    n = 600
    gt = np.zeros((2, g, 7), np.float32)
    gt[..., 0] = rng.uniform(0.5, 12.0, (2, g))
    gt[..., 1] = rng.uniform(-6.0, 6.0, (2, g))
    gt[..., 2] = rng.uniform(-1.8, -1.5, (2, g))
    gt[..., 3:6] = rng.uniform([1.4, 3.2, 1.4], [1.9, 4.5, 1.8], (2, g, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (2, g))
    gv = rng.uniform(size=(2, g)) < 0.8
    if case == "full_slots":
        gv[:] = True
    if case == "interleaved":
        gv[:] = np.arange(g) % 2 == 1
    pick = rng.integers(0, g, (2, n))
    centre = np.take_along_axis(gt[..., :3], pick[..., None], 1)
    pts = (centre + rng.uniform([-2.5, -2.5, -0.5], [2.5, 2.5, 2.0],
                                (2, n, 3))).astype(np.float32)
    pv = rng.uniform(size=(2, n)) < 0.9
    want = np.full((2, n), -1, np.int64)

    def place(b, slot, box, points, slots):
        gt[b, slot] = box
        k = len(points)
        pts[b, :k] = points
        pv[b, :k] = True
        want[b, :k] = slots
    def up(a, b):                  # the next float32 after a towards b
        return np.nextafter(np.float32(a), np.float32(b))
    if case == "faces":
        # x in [-1, 1], y in [-2, 2], z in [-1, 1]: every face exact
        on = [(1, 0, 0), (-1, 0, 0), (0, 2, 0), (0, -2, 0), (0, 0, 1),
              (0, 0, -1), (1, 2, 1), (-1, -2, -1)]
        past = [(up(1, 2), 0, 0), (-up(1, 2), 0, 0), (0, up(2, 3), 0),
                (0, -up(2, 3), 0), (0, 0, up(1, 2)), (0, 0, -up(1, 2))]
        place(0, 0, (0, 0, -1, 2, 4, 2, 0), on + past,
              [0] * len(on) + [g] * len(past))
        gt[0, 1:, 0] += 20.0                 # the other boxes far away
        # x in [2.25, 3.75], y in [-2.5, 0.5], z in [-1.5, -0.5]
        on = [(3.75, -1, -1), (2.25, -1, -1), (3, 0.5, -1), (3, -2.5, -1),
              (3, -1, -0.5), (3, -1, -1.5)]
        past = [(up(3.75, 4), -1, -1), (up(2.25, 2), -1, -1),
                (3, np.float32(-1) + up(1.5, 2), -1),     # dy exact
                (3, -1, np.float32(-1) + up(0.5, 1))]     # dz exact
        place(1, 0, (3, -1, -1.5, 1.5, 3, 1, 0), on + past,
              [0] * len(on) + [g] * len(past))
        gt[1, 1:, 0] += 20.0
        gv[:, 0] = True
    elif case == "overlap":
        a, b = (0, 0, -1, 2, 4, 2, 0), (0.5, 0, -1, 2, 4, 2, 0.3)
        inside_both = [(0.2, 0.1, 0), (0.4, -0.5, 0.5), (0.3, 1.0, -0.5)]
        for s, (first, second) in enumerate(((a, b), (b, a))):
            place(s, 2, first, inside_both, [2] * 3)
            gt[s, 5] = second
            gv[s, 2] = gv[s, 5] = True
            gt[s, [i for i in range(g) if i not in (2, 5)], 0] += 20.0
    elif case == "invalid_first":
        box = (0, 0, -1, 2, 4, 2, 0.2)
        for s in range(2):
            for slot in (0, 1, 2, 4):
                gt[s, slot] = box
            gv[s, :5] = [False, False, False, True, True]
            gt[s, 3] = (0.3, 0, -1, 2, 4, 2, -0.1)
            place(s, 4, box, [(0.1, 0.2, 0), (-0.2, 0.5, 0.3)], [3, 3])
            gt[s, 5:, 0] += 20.0
    elif case == "no_valid_box":
        gv[0] = False
        want[0] = g
    elif case == "all_padded":
        pv[0] = False
        want[0] = g
    return pts, pv, gt, gv, want


# K13's transpose plans: "x_edges_w_odd" and "x_edges_w_even" level-0 rows
# on every face of the grid (x = 0 and x = W - 1 with W odd and with W even:
# a parent off the grid in x would alias the neighbouring y row); "cap_cut"
# output levels cut by their caps; "band_rows" four band rows, each output
# level clipped at its row's y limit as in the banded stage;
# "padded_between" padding rows between valid level-0 rows;
# "all_padded_sample" a second sample without rows
K13_CASES = ["x_edges_w_odd", "x_edges_w_even", "cap_cut", "band_rows",
             "padded_between", "all_padded_sample"]


def k13_case(case):
    """(the [B, M_L] int32 keys of levels 0-3 on the CPU, K7's plain
    version downsampling each into the next, the four level grids, the
    [B] int32 level-0 y limits or None) of a K13 case."""
    import torch
    from sassd_tpu_torch.ops import sparse as sp
    rng = np.random.default_rng(200 + K13_CASES.index(case))
    shape = (6, 10, 8) if case == "x_edges_w_even" else (6, 10, 9)
    b, n, caps, y_top = 2, 70, (120, 120, 120), None
    if case == "band_rows":
        shape, b = (6, 24, 9), 4
        y_top = torch.tensor([24, 19, 13, 7], dtype=torch.int32)
    if case == "cap_cut":
        caps = (20, 12, 3)
    d, h, w = shape
    keys = np.full((b, 80), sp.INVALID_KEY, np.int32)
    for i in range(b):
        z, y, x = (rng.integers(0, s, n) for s in shape)
        # every face: x = 0, x = W - 1, y = 0, y = H - 1, z = 0, z = D - 1
        x[:4], x[4:8], y[8:10], y[10:12] = 0, w - 1, 0, h - 1
        z[12:14], z[14:16] = 0, d - 1
        lin = np.unique((z * h + y) * w + x)[:n]
        keys[i, :len(lin)] = lin
    if case == "padded_between":
        keys[:, 1::4] = sp.INVALID_KEY
    if case == "all_padded_sample":
        keys[1] = sp.INVALID_KEY
    levels, shapes = [torch.from_numpy(keys)], [shape]
    for lvl in (1, 2, 3):
        levels.append(sp.downsample_keys_plain(
            levels[-1], shapes[-1], caps[lvl - 1],
            None if y_top is None else y_top >> lvl))
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    return levels, shapes, y_top


# K19's full grids: every cell of a grid with odd extents and of one with
# even extents, so that every z, y and x parity and every grid face meets
# each level's search
FULL_GRIDS = {"full_odd": (5, 7, 9), "full_even": (4, 6, 8)}


def full_grid_levels(case, m=None):
    """(the [2, M] int32 keys of levels 0-3 on the CPU, K7's plain version
    downsampling each into the next, the four level grids) of a FULL_GRIDS
    case: sample 0 holds every cell, sample 1 every other one. Every
    level's row is m long (default: the grid's cells), INVALID_KEY
    padded."""
    import torch
    from sassd_tpu_torch.ops import sparse as sp
    shape = FULL_GRIDS[case]
    total = int(np.prod(shape))
    m = m or total
    keys = np.full((2, m), sp.INVALID_KEY, np.int32)
    keys[0, :total] = np.arange(total)
    keys[1, :(total + 1) // 2] = np.arange(0, total, 2)
    levels, shapes = [torch.from_numpy(keys)], [shape]
    for _ in range(3):
        levels.append(sp.downsample_keys_plain(levels[-1], shapes[-1], m))
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    return levels, shapes


def invert_stride_plan(plan, m_in):
    """The transpose plan as the forward stride plan [B, 27, M_out]
    inverted, planT[k, plan[k, o]] = o, [B, 27, m_in] int32: an oracle for
    K13, which reads the output level's map instead."""
    import torch
    b, k, m_out = plan.shape
    p = plan.to(torch.int64)
    row = torch.arange(b * k, device=plan.device).reshape(b, k, 1) * m_in
    flat = torch.where(p >= 0, row + p, b * k * m_in)
    out = torch.full((b * k * m_in + 1,), -1, dtype=torch.int32,
                     device=plan.device)
    o = torch.arange(m_out, dtype=torch.int32, device=plan.device)
    out[flat.reshape(-1)] = o.repeat(b * k)
    return out[:b * k * m_in].view(b, k, m_in)


# K17's cases: a sequence of key sets that one carried index map is
# updated through, from the all -1 map (the previous keys all INVALID).
# "no_previous": a first scan; "empty_scan": a scan with no valid key
# after one with keys, then keys again; "overlap": scans that share half
# their keys; "identical": the same keys twice in a row; "at_cap": every
# row of the key array valid; "invalid_between": INVALID rows between
# valid ones and keys past the grid, which are ignored; "batch2": two
# samples with their own counts, one of them empty
K17_CASES = ["no_previous", "empty_scan", "overlap", "identical", "at_cap",
             "invalid_between", "batch2"]
K17_SHAPE = (5, 12, 13)
K17_INVALID = np.iinfo(np.int32).max


def k17_keys(rng, counts, m, total=None):
    """[len(counts), m] int32 rows of distinct ascending random keys on
    K17_SHAPE's grid, counts[i] valid in row i, INVALID padded."""
    total = total or int(np.prod(K17_SHAPE))
    out = np.full((len(counts), m), K17_INVALID, np.int32)
    for i, n in enumerate(counts):
        out[i, :n] = np.sort(rng.choice(total, n, replace=False))
    return out


def k17_case(case):
    """(shape_zyx, [[B, M] int32 keys of each scan in turn]) of a K17
    case; the index map after each update must equal the fresh map of
    that scan's keys."""
    rng = np.random.default_rng(K17_CASES.index(case))
    total = int(np.prod(K17_SHAPE))
    if case == "no_previous":
        seq = [k17_keys(rng, [90], 128)]
    elif case == "empty_scan":
        seq = [k17_keys(rng, [90], 128), k17_keys(rng, [0], 128),
               k17_keys(rng, [40], 128)]
    elif case == "overlap":
        a = k17_keys(rng, [120], 128)
        b = a.copy()
        b[0, 60:120] = np.sort(rng.choice(
            np.setdiff1d(np.arange(total), a[0, :120]), 60, replace=False))
        b[0, :120] = np.sort(b[0, :120])
        seq = [a, b, a]
    elif case == "identical":
        a = k17_keys(rng, [100], 128)
        seq = [a, a.copy(), k17_keys(rng, [30], 128)]
    elif case == "at_cap":
        seq = [k17_keys(rng, [128], 128), k17_keys(rng, [128], 128)]
    elif case == "invalid_between":
        seq = []
        for n in (70, 50):
            k = k17_keys(rng, [n], 128)
            k[0, 5:n:9] = K17_INVALID
            k[0, n:n + 3] = [total, total + 7, K17_INVALID - 1]
            seq.append(k)
    else:
        seq = [k17_keys(rng, [80, 0], 96), k17_keys(rng, [0, 60], 96),
               k17_keys(rng, [96, 50], 96)]
    return K17_SHAPE, seq
