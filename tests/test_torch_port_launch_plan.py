"""The launch plans of the port's CUDA kernels, checked on the CPU.

The kernels themselves run only on a card; their plans are pure functions
of the shapes (``launch_plan`` in each wrapper module), so the limits a
launch must respect and the coverage of the work are checked here: shared
memory and threads within a block's limits, bulk copies of 16-byte-aligned
sizes and offsets, and every window or query row taken exactly once.
"""

import importlib

import pytest

import chip_smoke

# the modules, not the wrappers the package exports under the same names
am = importlib.import_module("esc_tpu_torch.ops.kernels.codebook_argmin")
wa = importlib.import_module("esc_tpu_torch.ops.kernels.window_attention")

NUM_SMS = 132           # an H100 SXM
MAX_SMEM = 232448       # 227 KB, a block's shared memory
MAX_THREADS = 1024

# (G, heads, head dim) of every window-attention call of ESC-Base serving,
# 4 clips of 3 s, num_streams 1-6 (chip_smoke.main_path_calls)
MAIN_PATH_ATTENTION = [(4800, 3, 15), (2400, 6, 12), (1200, 12, 8),
                       (600, 24, 6), (300, 24, 8), (300, 24, 16),
                       (600, 12, 12), (1200, 6, 16), (2400, 3, 24)]
# G that is not a multiple of a grid or of the windows per tile
RAGGED = [(1, 3, 15), (7, 6, 12), (301, 24, 16), (301, 3, 24)]


def test_main_path_geometries_are_the_smoke_runs():
    got = set()
    for ns in range(1, 7):
        _, attn = chip_smoke.main_path_calls(chip_smoke.ESC_BASE,
                                             chip_smoke.BATCH,
                                             chip_smoke.CLIP, ns)
        got |= {(G, nh, hd) for G, nh, hd, _ in attn}
    assert got == set(MAIN_PATH_ATTENTION)


# widths beyond one window of all heads in shared memory, or heads wider
# than the all-heads kernel's registers take: heads split into groups
WIDE = [(300, 24, 32), (300, 16, 64), (300, 8, 128), (7, 8, 128),
        (301, 5, 40), (33, 2, 256), (9, 3, 33), (50, 7, 128)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("G,nh,hd", MAIN_PATH_ATTENTION + RAGGED)
def test_attention_plan(G, nh, hd, bf16, masked):
    p = wa.launch_plan(G, nh, hd, bf16, masked, NUM_SMS)
    assert p.heads == 0 and p.groups == 1  # every head in one block
    _check_all_heads_plan(p, G, nh, hd, bf16, masked)


def _check_all_heads_plan(p, G, nh, hd, bf16, masked):
    n, C = wa.WINDOW_TOKENS, nh * hd
    # limits of one block
    assert p.smem <= MAX_SMEM
    assert p.threads % 32 == 0 and 32 <= p.threads <= min(MAX_THREADS,
                                                         wa.MAX_THREADS)
    assert p.smem == wa._smem(p.windows, p.stages, p.in_pitch, p.out_pitch,
                              nh, masked)
    assert p.stages >= 1 and (p.stages == 2 or p.windows == 1)
    # bulk copies: one per tile into contiguous rows, or one per row into
    # padded rows; sizes, global offsets and shared offsets on 16 bytes
    assert p.row_bytes == 3 * C * (2 if bf16 else 4)
    if p.in_pitch == p.row_bytes:
        sizes = {min(p.windows, G - t * p.windows) * n * p.row_bytes
                 for t in range(p.tiles)}
        src = {t * p.windows * n * p.row_bytes for t in range(p.tiles)}
    else:
        assert p.in_pitch == p.row_bytes + 16 and p.row_bytes % 128 == 0
        sizes = {p.row_bytes}
        src = {r * p.row_bytes for r in range(G * n)}
        dst = {r * p.in_pitch for r in range(p.windows * n)}
        assert all(o % 16 == 0 for o in dst)
    assert all(s % 16 == 0 for s in sizes)
    assert all(o % 16 == 0 for o in src)
    # the mask: one copy of a 64-byte row per token row, into rows of
    # MASK_PITCH floats; what one tile's copies bring stays countable by an
    # mbarrier
    assert (n * 4) % 16 == 0 and (wa.MASK_PITCH * 4) % 16 == 0
    assert p.windows * n * (p.row_bytes + n * 4) < wa.MAX_BULK_BYTES
    stage = p.windows * n * p.in_pitch
    mask_stage = p.windows * n * wa.MASK_PITCH * 4 if masked else 0
    assert all((s * stage + t * mask_stage) % 16 == 0
               for s in range(p.stages + 1) for t in range(p.stages + 1))
    # rows of two different windows' k or v never start on one bank, and
    # the 16 output rows of a window never sit on fewer than 8 bank offsets
    assert p.in_pitch % 128 != 0
    assert len({(r * p.out_pitch) % 32 for r in range(n)}) >= 8
    # the output: one bulk store per tile from contiguous rows, or one per
    # row from padded rows; sizes and offsets on 16 bytes
    if p.out_pitch == C:
        stores = {(t * p.windows * n * C * 4,
                   min(p.windows, G - t * p.windows) * n * C * 4)
                  for t in range(p.tiles)}
        assert all(o % 16 == 0 and s % 16 == 0 for o, s in stores)
    else:
        assert p.out_pitch == C + 4 and C % 8 == 0
        assert (C * 4) % 16 == 0 and (p.out_pitch * 4) % 16 == 0
    # persistent blocks cover every tile, window and (window, head) pair
    # exactly once
    assert p.grid <= p.tiles and p.tiles == -(-G // p.windows)
    windows = [g for b in range(p.grid)
               for t in range(b, p.tiles, p.grid)
               for g in range(t * p.windows, min(G, (t + 1) * p.windows))]
    assert sorted(windows) == list(range(G))
    nwarps = p.threads // 32
    for nwin in {min(p.windows, G - t * p.windows) for t in range(p.tiles)}:
        pairs = sorted(q for w in range(nwarps)
                       for q in range(w, nwin * nh, nwarps))
        assert pairs == list(range(nwin * nh))
    # no warp idles on a full tile
    assert nwarps <= p.windows * nh


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("G,nh,hd", WIDE)
def test_attention_plan_wide(G, nh, hd, bf16, masked):
    p = wa.launch_plan(G, nh, hd, bf16, masked, NUM_SMS)
    if p.heads == 0:  # one window of all heads fits after all
        assert hd <= wa.MAX_REGISTER_HEAD_DIM
        _check_all_heads_plan(p, G, nh, hd, bf16, masked)
        return
    n, elem = wa.WINDOW_TOKENS, 2 if bf16 else 4
    # limits of one block, the kernel's layout of shared memory
    assert p.smem <= MAX_SMEM
    assert p.threads % 32 == 0 and 32 <= p.threads <= min(MAX_THREADS,
                                                         wa.MAX_THREADS)
    assert p.smem == wa._grouped_smem(p.windows, p.threads, p.in_pitch, nh,
                                      hd, masked)
    assert p.stages == 1 and p.out_pitch == 0
    assert 1 <= p.heads <= nh and p.groups == -(-nh // p.heads)
    # a buffer row holds the group's q, k and v segments, padded to 16
    # bytes; every segment and head slice starts on a multiple of hd
    assert p.in_pitch % 16 == 0 and p.in_pitch % 128 != 0
    assert p.in_pitch >= 3 * p.heads * hd * elem
    # the plain loads' unit divides every offset and length of a segment
    unit = next(u for u in (16, 8, 4, 2) if (hd * elem) % u == 0)
    C = nh * hd
    for h0 in range(0, nh, p.heads):
        seg = min(p.heads, nh - h0) * hd * elem
        assert seg % unit == 0 and (h0 * hd * elem) % unit == 0
    assert (3 * C * elem) % unit == 0 and (C * elem) % unit == 0
    # persistent blocks cover every (window, head) pair exactly once
    nwarps = p.threads // 32
    assert nwarps <= p.windows * p.heads  # no warp idles on a full unit
    assert p.tiles == -(-G // p.windows) and p.grid <= p.tiles * p.groups
    pairs = []
    for b in range(p.grid):
        for u in range(b, p.tiles * p.groups, p.grid):
            tile, grp = divmod(u, p.groups)
            g0, h0 = tile * p.windows, grp * p.heads
            nwin, hgl = min(p.windows, G - g0), min(p.heads, nh - h0)
            for w in range(nwarps):
                for q in range(w, nwin * hgl, nwarps):
                    pairs.append((g0 + q // hgl, h0 + q % hgl))
    assert sorted(pairs) == [(g, h) for g in range(G) for h in range(nh)]


@pytest.mark.parametrize("nh,hd", [(24, 32), (16, 64), (8, 128)])
def test_attention_plan_splits_heads_where_a_window_does_not_fit(nh, hd):
    p = wa.launch_plan(300, nh, hd, False, True, NUM_SMS)
    assert p.heads > 0 and p.groups > 1


def test_attention_plan_refuses_what_shared_memory_cannot_hold():
    # the padded bias of 256 heads alone exceeds a block's shared memory
    with pytest.raises(ValueError):
        wa.launch_plan(300, 256, 8, False, False, NUM_SMS)
    with pytest.raises(ValueError):
        wa.launch_plan(300, 2, wa.MAX_HEAD_DIM + 1, False, False, NUM_SMS)


@pytest.mark.parametrize("d", [6, 8, 12, 16, 32])
@pytest.mark.parametrize("K", [128, 1024])
@pytest.mark.parametrize("N", [1, 7, 600, 1200, 4801])
def test_argmin_plan(N, K, d):
    p = am.launch_plan(N, K, d, NUM_SMS)
    assert p.k_tile == K  # the whole codebook in one tile
    _check_argmin_plan(p, N, K, d)


def _check_argmin_plan(p, N, K, d):
    assert p.smem <= MAX_SMEM
    assert p.smem == am.smem_bytes(p.k_tile, d, p.rows)
    assert p.threads % 32 == 0 and 32 <= p.threads <= min(MAX_THREADS,
                                                         am.MAX_THREADS)
    assert 1 <= p.rows <= am.max_rows(d)
    # the codebook in tiles of k_tile codewords, each one bulk copy of its
    # 16-byte whole into the start of shared memory, the tail by plain
    # loads; every tile starts on 16 bytes
    assert 1 <= p.k_tile <= K and (p.k_tile == K or p.k_tile % 4 == 0)
    assert p.bulk_bytes % 16 == 0
    assert 0 <= p.k_tile * d * 4 - p.bulk_bytes < 16
    assert all((t0 * d * 4) % 16 == 0 for t0 in range(0, K, p.k_tile))
    # every row exactly once, no empty block
    rows = [b * p.rows + r for b in range(p.grid) for r in range(p.rows)
            if b * p.rows + r < N]
    assert rows == list(range(N))
    assert (p.grid - 1) * p.rows < N
    # every codeword scanned by exactly one thread, in increasing order
    # per thread across the tiles
    seen = {t: [] for t in range(p.threads)}
    for t0 in range(0, K, p.k_tile):
        nk = min(p.k_tile, K - t0)
        for t in range(p.threads):
            seen[t].extend(t0 + j for j in range(t, nk, p.threads))
    assert all(v == sorted(v) for v in seen.values())
    assert sorted(k for v in seen.values() for k in v) == list(range(K))


@pytest.mark.parametrize("N,K,d", [(600, 1024, 64), (600, 1024, 128),
                                   (600, 1024, 256), (4801, 1024, 64),
                                   (600, 4096, 8), (1, 4096, 8),
                                   (600, 1024, 57), (601, 1023, 65),
                                   (600, 8192, 8), (7, 1024, 256)])
def test_argmin_plan_k_tiles(N, K, d):
    p = am.launch_plan(N, K, d, NUM_SMS)
    fits = am.smem_bytes(K, d, p.rows) <= MAX_SMEM
    assert (p.k_tile == K) == fits
    _check_argmin_plan(p, N, K, d)


def test_argmin_plan_fills_the_card_at_the_main_path_shape():
    p = am.launch_plan(600, 1024, 8, NUM_SMS)
    assert NUM_SMS // 2 < p.grid <= NUM_SMS


def test_argmin_plan_refuses_what_shared_memory_cannot_hold():
    # not even 4 codewords of 60,000 floats fit
    with pytest.raises(ValueError):
        am.launch_plan(600, 1024, 60000, NUM_SMS)
