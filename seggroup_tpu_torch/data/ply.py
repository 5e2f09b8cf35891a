"""Minimal PLY reader/writer, binary little-endian and ascii
(seggroup_tpu/data/ply.py, copied whole: numpy only).

Replaces the reference's external `plyfile` dependency (seggroup/model.py:20)
and its vendored readers (kpconv/utils/ply.py, minkowski/lib/pc_utils.py).
Covers the subset ScanNet uses: vertex properties + triangular face lists.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Returns {'vertex': structured array, 'face': (F, 3) int32 (if present)}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a ply file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)] or 'face')
        while True:
            line = f.readline().strip().decode()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append([name, int(count), []])
            elif line.startswith("property list"):
                # e.g. property list uchar int vertex_indices
                _, _, cnt_t, idx_t, pname = line.split()
                elements[-1][2].append(("__list__", cnt_t, idx_t, pname))
            elif line.startswith("property"):
                _, typ, pname = line.split()
                elements[-1][2].append((pname, _TYPES[typ]))
            elif line == "end_header":
                break

        out: dict[str, np.ndarray] = {}
        if fmt == "ascii":
            for name, count, props in elements:
                rows = [f.readline().split() for _ in range(count)]
                if props and props[0][0] == "__list__":
                    out[name] = np.array(
                        [[int(x) for x in r[1:4]] for r in rows], np.int32
                    )
                else:
                    dt = np.dtype([(p, t) for p, t in props])
                    arr = np.zeros(count, dt)
                    for i, r in enumerate(rows):
                        for j, (p, _t) in enumerate(props):
                            arr[p][i] = float(r[j])
                    out[name] = arr
            return out

        endian = "<" if fmt == "binary_little_endian" else ">"
        for name, count, props in elements:
            if props and props[0][0] == "__list__":
                _, cnt_t, idx_t, _pname = props[0]
                cdt = np.dtype(endian + _TYPES[cnt_t])
                idt = np.dtype(endian + _TYPES[idx_t])
                faces = np.empty((count, 3), np.int32)
                # ScanNet faces are uniformly triangles: read in one block
                rec = np.dtype([("n", cdt), ("v", idt, (3,))])
                data = np.frombuffer(f.read(rec.itemsize * count), rec)
                if not (data["n"] == 3).all():
                    raise ValueError("non-triangular face encountered")
                faces[:] = data["v"]
                out[name] = faces
            else:
                dt = np.dtype([(p, endian + t) for p, t in props])
                out[name] = np.frombuffer(f.read(dt.itemsize * count), dt).copy()
        return out


def write_ply(path: str, vertex: np.ndarray | dict, faces: np.ndarray | None = None):
    """vertex: structured array or {'x':..,'y':..,...} dict of 1-D arrays."""
    if isinstance(vertex, dict):
        dt = np.dtype([(k, np.asarray(v).dtype.str.lstrip("<>")) for k, v in vertex.items()])
        arr = np.zeros(len(next(iter(vertex.values()))), dt)
        for k, v in vertex.items():
            arr[k] = v
        vertex = arr
    inv = {v: k for k, v in _TYPES.items()}
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(vertex)}\n".encode())
        for name in vertex.dtype.names:
            t = inv[vertex.dtype[name].str.lstrip("<>|=")]
            f.write(f"property {t} {name}\n".encode())
        if faces is not None:
            f.write(f"element face {len(faces)}\n".encode())
            f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(np.ascontiguousarray(vertex).tobytes())
        if faces is not None:
            rec = np.zeros(len(faces), np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
            rec["n"] = 3
            rec["v"] = faces
            f.write(rec.tobytes())
