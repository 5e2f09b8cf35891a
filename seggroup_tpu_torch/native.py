"""ctypes bindings to the port's native host library, with numpy fallbacks
(seggroup_tpu/native.py).

The source, `csrc/seggroup_native.cpp`, is the JAX package's C++ copied
into the port. It is compiled at first use with the host's C++ compiler
into the gitignored `_build/` (`cuda_build.build_host`, named by a hash of
the source and the flags) and loaded with ctypes. Every entry point has a
numpy fallback that gives the same result; the library only makes the host
side faster.

Unlike the JAX loader, this one does not hide a failed build: the error is
kept (`load_error()`), the first fallback call warns with it, and
`available()` says which path runs. Nothing is built when the module is
imported.

`format_int_lines` (the label files' text) is the port's own: it has no
counterpart in the JAX package's C++."""

from __future__ import annotations

import contextlib
import ctypes
import threading
import warnings

import numpy as np

from seggroup_tpu_torch import cuda_build

SOURCE = cuda_build.CSRC / "seggroup_native.cpp"
STEM = "libseggroup_native"

_lib = None
_error: str | None = None
_warned = False
_forced_fallback = False
_lock = threading.Lock()


def _bind(lib) -> None:
    c_f32 = ctypes.POINTER(ctypes.c_float)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    c_i64 = ctypes.POINTER(ctypes.c_int64)
    c_char = ctypes.POINTER(ctypes.c_char)
    i64, f32, i32 = ctypes.c_int64, ctypes.c_float, ctypes.c_int32
    sig = {
        "grid_subsample": (i64, [c_f32, i64, f32, c_f32, c_i32]),
        "radius_neighbors": (None, [c_f32, i64, c_f32, i64, f32, i32, c_i32, c_i32]),
        "voxelize_rulebook": (i64, [c_i32, c_i32, i64, c_i32, c_i32]),
        "nearest_neighbor_map": (None, [c_f32, i64, c_f32, i64, f32, c_i32]),
        "connected_components_uf": (None, [c_i32, i64, i64, c_i32]),
        "subm_rulebook3": (None, [c_i32, i64, i64, c_i32]),
        "downsample_plan": (i64, [c_i32, i64, i64, c_i32, c_i32, c_i32]),
        "subm_windows": (i64, [c_i32, i64, i64, i64, c_i32, c_i32]),
        "elastic_interp": (None, [c_f32, i64, c_f32, f32, f32, c_f32, c_i32]),
        "voxelize_sorted": (i64, [c_f32, i64, f32, c_i32, c_i32, c_i32]),
        "format_int_lines": (i64, [c_i64, i64, c_char]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def get_lib():
    """The loaded library, built at the first call; None when the build or
    the load failed (the error stays in `load_error()`)."""
    global _lib, _error, _warned
    if _forced_fallback:
        return None
    with _lock:
        if _lib is None and _error is None:
            try:
                path, _ = cuda_build.build_host(SOURCE, STEM)
                lib = ctypes.CDLL(str(path))
                _bind(lib)
                _lib = lib
            except Exception as e:  # kept and reported, never swallowed
                _error = f"{type(e).__name__}: {e}"
        if _lib is None and not _warned:
            _warned = True
            warnings.warn(f"the native host library is not available, numpy fallbacks run: "
                          f"{_error}", RuntimeWarning, stacklevel=3)
        return _lib


def available() -> bool:
    """True when the C++ library runs, False when the numpy fallbacks do."""
    return get_lib() is not None


@contextlib.contextmanager
def numpy_fallbacks():
    """Inside the block every entry point runs its numpy fallback, the
    library loaded or not (to hold one against the other)."""
    global _forced_fallback
    _forced_fallback = True
    try:
        yield
    finally:
        _forced_fallback = False


def load_error() -> str | None:
    """Why the library did not load (the compiler's message), or None."""
    get_lib()
    return _error


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _f(a):
    return _ptr(a, ctypes.c_float)


def _i(a):
    return _ptr(a, ctypes.c_int32)


def _first_order_rank(key: np.ndarray):
    """(first index of each distinct key, rank of each row's key) with the
    distinct keys numbered in order of first appearance."""
    _, first_idx, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return first_idx[order], rank[inv.reshape(-1)]


def grid_subsample(points: np.ndarray, cell_size: float):
    """(n, 3) float32 -> (barycenters (m, 3), inverse (n,)), cells numbered
    in order of first appearance."""
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    lib = get_lib()
    if lib is not None:
        out_p = np.empty((n, 3), np.float32)
        inv = np.empty(n, np.int32)
        m = lib.grid_subsample(_f(points), n, cell_size, _f(out_p), _i(inv))
        return out_p[:m].copy(), inv
    ic = np.floor(points / np.float32(cell_size)).astype(np.int64)
    key = (ic[:, 0] * 2 ** 42) + (ic[:, 1] * 2 ** 21) + ic[:, 2]
    first, inv = _first_order_rank(key)
    sums = np.zeros((len(first), 3))
    np.add.at(sums, inv, points)
    cnt = np.bincount(inv, minlength=len(first))[:, None]
    return (sums / cnt).astype(np.float32), inv.astype(np.int32)


_CELL_STEPS = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dz in (-1, 0, 1)], np.int64)


def radius_neighbors(support: np.ndarray, queries: np.ndarray, radius: float, max_k: int):
    """(idx (nq, max_k) int32 with ns for empty, counts (nq,)): the support
    points within `radius` of each query, in the library's order (cells
    of the 3^3 block around the query's cell of size `radius` in (dx, dy,
    dz) order, each cell's points by index), the first max_k kept."""
    support = np.ascontiguousarray(support, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    ns, nq = len(support), len(queries)
    lib = get_lib()
    if lib is not None:
        idx = np.empty((nq, max_k), np.int32)
        cnt = np.empty(nq, np.int32)
        lib.radius_neighbors(_f(support), ns, _f(queries), nq, radius, max_k, _i(idx), _i(cnt))
        return idx, cnt
    r = np.float32(radius)
    r2 = r * r
    s_cell = np.floor(support / r).astype(np.int64)
    q_cell = np.floor(queries / r).astype(np.int64)
    idx = np.full((nq, max_k), ns, np.int32)
    cnt = np.zeros(nq, np.int32)
    for q in range(nq):
        dd = support - queries[q]
        d = dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1] + dd[:, 2] * dd[:, 2]
        step = s_cell - q_cell[q]
        near = np.all(np.abs(step) <= 1, axis=1) & (d <= r2)
        hits = np.nonzero(near)[0]
        group = ((step[hits] + 1) * np.array([9, 3, 1])).sum(1)
        hits = hits[np.lexsort((hits, group))][:max_k]
        idx[q, :len(hits)] = hits
        cnt[q] = len(hits)
    return idx, cnt


def voxelize_rulebook(coords: np.ndarray, batch: np.ndarray):
    """(n, 3) int32 + (n,) int32 -> (point2voxel (n,), voxel_coords (m, 4)
    rows (batch, x, y, z)), voxels numbered in order of first appearance."""
    coords = np.ascontiguousarray(coords, np.int32)
    batch = np.ascontiguousarray(batch, np.int32)
    n = len(coords)
    lib = get_lib()
    if lib is not None:
        p2v = np.empty(n, np.int32)
        vc = np.empty((n, 4), np.int32)
        m = lib.voxelize_rulebook(_i(coords), _i(batch), n, _i(p2v), _i(vc))
        return p2v, vc[:m].copy()
    key = (batch.astype(np.int64) << 48) ^ (coords[:, 0].astype(np.int64) * 2 ** 32
                                            + coords[:, 1].astype(np.int64) * 2 ** 16
                                            + coords[:, 2])
    first, p2v = _first_order_rank(key)
    vc = np.concatenate([batch[first][:, None], coords[first]], 1).astype(np.int32)
    return p2v.astype(np.int32), vc


def nearest_neighbor_map(verts: np.ndarray, resampled: np.ndarray, cell: float = 0.1):
    """(nv,) int32: the nearest resampled point of each vertex (the
    library searches a grid of `cell` ring by ring; the fallback all
    points, the first of equal distances)."""
    verts = np.ascontiguousarray(verts, np.float32)
    resampled = np.ascontiguousarray(resampled, np.float32)
    lib = get_lib()
    out = np.empty(len(verts), np.int32)
    if lib is not None:
        lib.nearest_neighbor_map(_f(verts), len(verts), _f(resampled), len(resampled), cell,
                                 _i(out))
        return out
    chunk = 4096
    for i in range(0, len(verts), chunk):
        dd = verts[i:i + chunk, None] - resampled[None]
        d = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] + dd[..., 2] * dd[..., 2]
        out[i:i + chunk] = d.argmin(1)
    return out


def _pack_bxyz(coords: np.ndarray) -> np.ndarray:
    """The library's 64-bit key: 16 bits a column of (b, x, y, z)."""
    c = coords.astype(np.int64) & 0xFFFF
    return (c[:, 0] << 48) | (c[:, 1] << 32) | (c[:, 2] << 16) | c[:, 3]


def subm_rulebook3(coords: np.ndarray, n: int, capacity: int) -> np.ndarray:
    """Kernel-3 submanifold rulebook over (capacity, 4) int32 coords with
    the first `n` rows valid (non-negative, below 2^14). Returns
    (capacity, 27) int32 neighbour rows, absent = capacity, offsets in
    kernel_offsets(3) order (sparse/conv.build_subm_rulebook)."""
    coords = np.ascontiguousarray(coords, np.int32)
    capacity, n = int(capacity), int(n)
    lib = get_lib()
    if lib is not None:
        out = np.empty((capacity, 27), np.int32)
        lib.subm_rulebook3(_i(coords), n, capacity, _i(out))
        return out
    out = np.full((capacity, 27), capacity, np.int32)
    if n == 0:
        return out
    c = coords[:n].astype(np.int64)
    keys = _pack_bxyz(c)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    for k, step in enumerate(_CELL_STEPS):
        q = c.copy()
        q[:, 1:] += step
        qk = _pack_bxyz(q)
        pos = np.minimum(np.searchsorted(sk, qk), n - 1)
        hit = np.all(q[:, 1:] >= 0, axis=1) & (sk[pos] == qk)
        out[:n, k] = np.where(hit, order[pos], capacity)
    return out


def subm_windows(rulebook: np.ndarray, tile: int, window: int):
    """Windowed-gather plan over a (capacity, 27) rulebook whose rows are in
    lexicographic coordinate order. Returns (win_base (capacity // tile,
    9), rb_win (3 * capacity, 9), overflow_count).

    rb_win is the dz-block-interleaved layout of the JAX package's Pallas
    kernel: rb_win[(t*3 + dz)*tile + i, g] = window-local index of query
    row t*tile + i for kernel offset k = g*3 + dz; == window marks absent.
    overflow_count > 0 means a real neighbour did not fit its window."""
    rulebook = np.ascontiguousarray(rulebook, np.int32)
    capacity = len(rulebook)
    n_tiles = capacity // tile
    lib = get_lib()
    if lib is not None:
        base = np.empty((n_tiles, 9), np.int32)
        rb_win = np.empty((3 * capacity, 9), np.int32)
        ovf = lib.subm_windows(_i(rulebook), capacity, tile, window, _i(base), _i(rb_win))
        return base, rb_win, int(ovf)
    m = capacity
    rb3 = rulebook.reshape(n_tiles, tile, 9, 3)
    present = rb3 < m
    lo = np.where(present, rb3, m).min(axis=(1, 3))  # (n_tiles, 9)
    base = np.where(lo == m, 0, lo & ~15).astype(np.int32)
    d = rb3 - base[:, None, :, None]
    fits = present & (d >= 0) & (d < window)
    local = np.where(fits, d, window).astype(np.int32)  # (nt, tile, 9, 3)
    ovf = int((present & ~fits).sum())
    rb_win = np.ascontiguousarray(local.transpose(0, 3, 1, 2).reshape(3 * capacity, 9))
    return base, rb_win, ovf


def downsample_plan(coords: np.ndarray, n: int, cap_out: int):
    """Stride-2 downsample plan: the unique halved coords of the first `n`
    rows in lexicographic order (sparse/conv.downsample_coords). Returns
    (out_coords (cap_out, 4), num_out (at most cap_out), out_row (n_in,),
    delta (n_in,)); rows from `n` on get out_row cap_out and delta 0."""
    coords = np.ascontiguousarray(coords, np.int32)
    n_in, n = len(coords), int(n)
    out_c = np.zeros((cap_out, 4), np.int32)
    out_row = np.full(n_in, cap_out, np.int32)
    delta = np.zeros(n_in, np.int32)
    lib = get_lib()
    if lib is not None:
        m = lib.downsample_plan(_i(coords), n, int(cap_out), _i(out_c), _i(out_row), _i(delta))
        return out_c, int(m), out_row, delta
    c = coords[:n]
    half = c.copy()
    half[:, 1:] >>= 1
    delta[:n] = (c[:, 1] & 1) * 4 + (c[:, 2] & 1) * 2 + (c[:, 3] & 1)
    uniq, inv = np.unique(half, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    m = min(len(uniq), cap_out)
    out_c[:m] = uniq[:m]
    out_row[:n] = np.where(inv < cap_out, inv, cap_out)
    return out_c, m, out_row, delta


def elastic_interp(coords: np.ndarray, mins: np.ndarray, granularity: float,
                   magnitude: float, noise: np.ndarray) -> np.ndarray:
    """Trilinear displacement of `coords` (n, 3) by a blurred noise grid
    (the interpolation half of elastic distortion): grid axis d has
    noise.shape[d] samples at spacing `granularity` from -granularity below
    `mins`. Returns coords + magnitude * noise(coords), float32 (the JAX
    package returns None without its library; the fallback here computes
    the library's float32 steps)."""
    out = np.ascontiguousarray(coords, np.float32).copy()
    mins = np.ascontiguousarray(mins, np.float32)
    noise = np.ascontiguousarray(noise, np.float32)
    dims = np.asarray(noise.shape[:3], np.int32)
    lib = get_lib()
    if lib is not None:
        lib.elastic_interp(_f(out), len(out), _f(mins), granularity, magnitude, _f(noise),
                           _i(dims))
        return out
    one = np.float32(1.0)
    inv_g = one / np.float32(granularity)
    f = np.maximum((out - mins) * inv_g + one, np.float32(0.0))
    i0 = np.minimum(np.floor(f).astype(np.int64), dims.astype(np.int64) - 2)
    w1 = f - i0.astype(np.float32)
    w0 = one - w1
    ix, iy, iz = i0[:, 0], i0[:, 1], i0[:, 2]

    def v(a, b, c):
        return noise[ix + a, iy + b, iz + c]  # (n, 3)

    wx0, wy0, wz0 = (w0[:, d:d + 1] for d in range(3))
    wx1, wy1, wz1 = (w1[:, d:d + 1] for d in range(3))
    val = (wx0 * (wy0 * (wz0 * v(0, 0, 0) + wz1 * v(0, 0, 1))
                  + wy1 * (wz0 * v(0, 1, 0) + wz1 * v(0, 1, 1)))
           + wx1 * (wy0 * (wz0 * v(1, 0, 0) + wz1 * v(1, 0, 1))
                    + wy1 * (wz0 * v(1, 1, 0) + wz1 * v(1, 1, 1))))
    return out + np.float32(magnitude) * val


def voxelize_sorted(points: np.ndarray, voxel_size: float):
    """Scene voxelisation: (n, 3) float -> (int_coords (m, 3) lex-sorted and
    shifted to start at 0, first (m,) least original index of each voxel's
    points, p2v (n,)). (The JAX package returns None without its library.)"""
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    lib = get_lib()
    if lib is not None:
        ic = np.empty((n, 3), np.int32)
        first = np.empty(n, np.int32)
        p2v = np.empty(n, np.int32)
        m = lib.voxelize_sorted(_f(points), n, voxel_size, _i(ic), _i(first), _i(p2v))
        return ic[:m].copy(), first[:m].copy(), p2v
    ic = np.floor(points / np.float32(voxel_size)).astype(np.int32)
    ic = (ic - ic.min(0)) if n else ic
    key = _pack_bxyz(np.concatenate([np.zeros((n, 1), np.int32), ic], 1))
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    out = np.stack([(uniq >> 32) & 0xFFFF, (uniq >> 16) & 0xFFFF, uniq & 0xFFFF], 1)
    return out.astype(np.int32), first.astype(np.int32), inv.reshape(-1).astype(np.int32)


def connected_components(edges: np.ndarray, n: int) -> np.ndarray:
    """(n,) int32: each node's least member index over an (E, 2) edge list."""
    edges = np.ascontiguousarray(edges, np.int32)
    lib = get_lib()
    if lib is not None:
        labels = np.empty(n, np.int32)
        lib.connected_components_uf(_i(edges), len(edges), n, _i(labels))
        return labels
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)], np.int32)


def format_int_lines(labels: np.ndarray) -> bytes:
    """A 1-D integer array as text, one decimal integer a line, each line
    ended by a newline: the bytes of "\\n".join(map(str, labels.tolist()))
    + "\\n", so b"\\n" for an empty array."""
    v = np.ascontiguousarray(labels, np.int64)
    if v.ndim != 1:
        raise ValueError(f"format_int_lines takes a 1-D array, not shape {v.shape}")
    n = len(v)
    lib = get_lib()
    if lib is not None:
        out = np.empty(21 * n + 1, np.uint8)  # the widest int64 and its newline
        m = lib.format_int_lines(_ptr(v, ctypes.c_int64), n, _ptr(out, ctypes.c_char))
        return out[:m].tobytes()
    if n == 0:
        return b"\n"
    neg = v < 0
    u = v.view(np.uint64)
    mag = np.where(neg, ~u + np.uint64(1), u)  # INT64_MIN's magnitude fits in uint64
    n_digits = np.ones(n, np.int64)
    for k in range(1, 20):
        n_digits += mag >= np.uint64(10 ** k)
    newline = np.cumsum(n_digits + neg + 1) - 1  # each line's last byte
    out = np.empty(int(newline[-1]) + 1, np.uint8)
    out[newline] = ord("\n")
    out[(newline - n_digits - 1)[neg]] = ord("-")
    for k in range(int(n_digits.max())):
        has = n_digits > k
        out[newline[has] - 1 - k] = (mag[has] % np.uint64(10)).astype(np.uint8) + ord("0")
        mag //= np.uint64(10)
    return out.tobytes()
