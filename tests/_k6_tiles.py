"""K6's tile loops emulated line for line with
`src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`: the
fp32 prefill's key range a block, the bf16 prefill's tiles a warp (its
ring start, skips and edge mask), the decode route's host tiles per split
and each split's tiles, and the pairs they multiply (`kernel_pairs`);
and the backward's (`csrc/flash_attention_bwd.cu`): the dQ launch's key
tiles a query tile, the dK/dV launch's query tiles a key tile, and the
(query tile, key tile) pairs each walks (`bwd_tile_pairs`,
`bwd_pairs`); and the saved-statistics route's (the `_wg` kernels of
that file): the dQ launch's key tiles a warpgroup of flattened rows
(`bwd_wg_dq_plan`) and the pairs it multiplies (`bwd_wg_dq_pairs`); its
dK/dV launch walks `bwd_query_tiles` a block of 64 keys, as the other
route's does, or, with a producer warp, a block of 128 keys and each
warpgroup's 64 (`bwd_ws_plan`).  Shared by tests/test_torch_window.py (the window's
ranges), tests/test_torch_launch.py and tests/test_torch_cuda.py (K6's
FLOP formulas) and tests/test_torch_flash_attention_bwd.py.  Imports
nothing.
"""

TILE = 64


def visible(pos, key, kv_len, causal, window):
    return key < kv_len and (not causal or key <= pos) and \
        (window <= 0 or pos - key < window)


def fp32_prefill_tiles(rho0, R, rows, G, q_offset, kv_len, causal, window):
    """`flash_attention_kernel`'s key tiles of the block at row rho0."""
    kv_end = kv_len
    if causal:
        last_row = min(rows - 1, rho0 + R - 1)
        kv_end = min(kv_end, q_offset + last_row // G + 1)
    kv_begin = 0
    if window > 0:
        first = q_offset + rho0 // G - window + 1
        if first > 0:
            kv_begin = first // TILE * TILE
    return list(range(kv_begin, max(kv_end, 0), TILE))


def bf16_prefill_plan(rho0, rows, G, q_offset, kv_len, causal, window, wg):
    """`flash_attention_kernel_bf16`'s tiles of the block at row rho0: for
    each unit (a 16-row warp, or a 64-row warpgroup with ``wg``), the
    tiles it multiplies and, per warp, whether each is masked."""
    R = 128
    kv_end = kv_len
    if causal:
        last_row = min(rows - 1, rho0 + R - 1)
        kv_end = min(kv_end, q_offset + last_row // G + 1)
    nkv = (kv_end - 1) // TILE + 1 if kv_end > 0 else 0
    j0 = 0
    if window > 0:
        first = q_offset + rho0 // G - window + 1
        if first > 0:
            j0 = first // TILE
    plan = []
    for warp in range(8):
        wr0 = warp * 16
        wpos_lo = q_offset + (rho0 + wr0) // G
        wpos_hi = q_offset + (rho0 + ((warp >> 2) * 64 + 63 if wg
                                      else wr0 + 15)) // G
        upos_lo = q_offset + (rho0 + ((warp >> 2) * 64 if wg else wr0)) // G
        tiles = []
        for j in range(j0, nkv):
            k0 = j * TILE
            if causal and k0 > wpos_hi:
                continue
            if window > 0 and k0 + TILE - 1 < upos_lo - window + 1:
                continue
            masked = (k0 + TILE > kv_len or (causal and k0 + TILE - 1 > wpos_lo)
                      or (window > 0 and k0 <= wpos_hi - window))
            tiles.append((k0, masked))
        plan.append((wr0, tiles))
    return plan


def host_tiles_per_split(Sq, q_offset, kv_len, causal, window, n_split):
    """`flash_attention_fwd`'s first tile, tile count and tiles per split
    of the decode route."""
    kv_end = kv_len
    if causal and q_offset + Sq < kv_end:
        kv_end = q_offset + Sq
    ntiles = (kv_end - 1) // TILE + 1 if kv_end > 0 else 0
    first = q_offset - window + 1
    t_lo = first // TILE if window > 0 and first > 0 else 0
    n = ntiles - t_lo if ntiles > t_lo else 0
    return t_lo, n, (n + n_split - 1) // n_split if n > 0 else 1


def decode_tiles_kernel(split, Sq, q_offset, kv_len, causal, window, tps):
    """`flash_attention_kernel_decode`'s tiles of one split."""
    kv_end = kv_len
    if causal and q_offset + Sq < kv_end:
        kv_end = q_offset + Sq
    ntiles = (kv_end - 1) // TILE + 1 if kv_end > 0 else 0
    t_lo = (q_offset - window + 1) // TILE \
        if window > 0 and q_offset - window + 1 > 0 else 0
    t0 = t_lo + split * tps
    return list(range(t0, min(t0 + tps, ntiles)))


def kernel_pairs(Sq, G, D, q_offset, kv_len, causal, window, bf16):
    """The (real row, key) pairs K6's loops multiply for one (batch, KV
    head): the decode route's one split (Sq·G <= 16), the fp32 prefill's
    blocks of 64 rows, the bf16 prefill's warps (blocks of 128 rows;
    warpgroups of 64 at D >= 64)."""
    rows, w = Sq * G, window or 0
    if rows <= 16:
        _, n, tps = host_tiles_per_split(Sq, q_offset, kv_len, causal, w, 1)
        tiles = decode_tiles_kernel(0, Sq, q_offset, kv_len, causal, w, tps)
        return rows * len(tiles) * TILE
    R = 128 if bf16 else 64
    total = 0
    for rho0 in range(0, rows, R):
        if not bf16:
            tiles = fp32_prefill_tiles(rho0, R, rows, G, q_offset, kv_len,
                                       causal, w)
            total += min(R, rows - rho0) * len(tiles) * TILE
            continue
        for wr0, tiles in bf16_prefill_plan(rho0, rows, G, q_offset, kv_len,
                                            causal, w, D >= 64):
            total += max(min(16, rows - rho0 - wr0), 0) * len(tiles) * TILE
    return total


def bwd_key_tiles(i0, Sq, q_offset, kv_len, causal, window):
    """`key_tiles` of flash_attention_bwd.cu: the dQ launch's key tiles
    [t_lo, t_hi) of the query tile at row i0."""
    i1 = i0 + TILE if i0 + TILE < Sq else Sq
    hi = kv_len
    if causal and q_offset + i1 < hi:
        hi = q_offset + i1
    lo = 0
    if window > 0 and q_offset + i0 - window + 1 > 0:
        lo = q_offset + i0 - window + 1
    t_lo = lo // TILE
    return t_lo, (hi + TILE - 1) // TILE if hi > lo else t_lo


def bwd_query_tiles(j0, Sq, q_offset, kv_len, causal, window):
    """`query_tiles` of flash_attention_bwd.cu: the dK/dV launch's query
    tiles [qt_lo, qt_hi) of the key tile at j0."""
    if j0 >= kv_len:
        return 0, 0
    i_min = j0 - q_offset if causal and j0 - q_offset > 0 else 0
    i_max = Sq
    if window > 0 and j0 + TILE - 1 + window - q_offset < i_max:
        i_max = j0 + TILE - 1 + window - q_offset
    if i_max <= i_min:
        return 0, 0
    return i_min // TILE, (i_max + TILE - 1) // TILE


def bwd_tile_pairs(Sq, Skv, q_offset, kv_len, causal, window, keys_side):
    """The (query tile, key tile) pairs the backward visits: the dQ
    launch's walk (each query tile's key tiles) or, with ``keys_side``, the
    dK/dV launch's (each key tile's query tiles; its grid covers Skv)."""
    w = window or 0
    if keys_side:
        return {(qt, j0 // TILE) for j0 in range(0, Skv, TILE)
                for qt in range(*bwd_query_tiles(j0, Sq, q_offset, kv_len,
                                                 causal, w))}
    return {(i0 // TILE, t) for i0 in range(0, Sq, TILE)
            for t in range(*bwd_key_tiles(i0, Sq, q_offset, kv_len, causal,
                                          w))}


def bwd_pairs(Sq, q_offset, kv_len, causal, window):
    """The (real query row, key) pairs the backward multiplies for one
    (batch, query head): each visited tile pair's real rows × TILE keys."""
    return sum(min(TILE, Sq - qt * TILE) * TILE for qt, _ in
               bwd_tile_pairs(Sq, 0, q_offset, kv_len, causal, window, False))


def bwd_wg_dq_plan(rho0, rows, G, q_offset, kv_len, causal, window):
    """`flash_bwd_dq_wg`'s tiles of the block at flattened row rho0: for
    each of its two warpgroups, its first row and the key tiles it
    multiplies."""
    R = 128
    kv_end = kv_len
    if causal:
        last_row = rows - 1 if rows - 1 < rho0 + R - 1 else rho0 + R - 1
        causal_end = q_offset + last_row // G + 1
        if causal_end < kv_end:
            kv_end = causal_end
    nkv = (kv_end - 1) // TILE + 1 if kv_end > 0 else 0
    j0 = 0
    if window > 0:
        first = q_offset + rho0 // G - window + 1
        if first > 0:
            j0 = first // TILE
    plan = []
    for wg in range(2):
        upos_lo = q_offset + (rho0 + wg * 64) // G
        upos_hi = q_offset + (rho0 + wg * 64 + 63) // G
        tiles = []
        for j in range(j0, nkv):
            k0 = j * TILE
            if causal and k0 > upos_hi:
                continue
            if window > 0 and k0 + TILE - 1 < upos_lo - window + 1:
                continue
            tiles.append(j)
        plan.append((rho0 + wg * 64, tiles))
    return plan


def bwd_ws_plan(j0, Sq, q_offset, kv_len, causal, window):
    """`flash_bwd_dkv_ws`'s walk of the block at key j0: its query tiles
    [lo, hi) (the span of its two warpgroups') and each warpgroup's own."""
    lo = hi = 0
    own = []
    for u in range(2):
        lu, hu = bwd_query_tiles(j0 + u * TILE, Sq, q_offset, kv_len, causal,
                                 window)
        own.append((lu, hu))
        if hu > lu:
            lo = lo if hi > lo and lo < lu else lu
            hi = max(hi, hu)
    return lo, hi, own


def bwd_wg_dq_pairs(Sq, G, q_offset, kv_len, causal, window):
    """The (real flattened row, key) pairs `flash_bwd_dq_wg` multiplies for
    one (batch, KV head)."""
    rows, w = Sq * G, window or 0
    return sum(max(min(64, rows - u0), 0) * TILE * len(tiles)
               for rho0 in range(0, rows, 128)
               for u0, tiles in bwd_wg_dq_plan(rho0, rows, G, q_offset,
                                               kv_len, causal, w))
