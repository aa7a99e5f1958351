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
