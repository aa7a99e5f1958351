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
