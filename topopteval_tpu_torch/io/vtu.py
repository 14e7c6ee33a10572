"""Pure-NumPy VTK XML UnstructuredGrid (.vtu) reader and writer.

Copy of ``topopteval_tpu.io.vtu`` (the reference's ReadVTK/WriteVTK usage,
src/MeshImport/MeshImport.jl:34-48, src/ResultsExport/ResultsExport.jl:
25-92), so both packages read the same files into identical arrays.  The
reader lands coordinates, connectivity and field arrays as contiguous
NumPy arrays ready for one host→device copy.

Supported encodings (the bundled fixture meshes use appended raw data with
``header_type="UInt64"`` and ``vtkZLibDataCompressor`` — multi-block zlib
with UInt64 block headers — so that variant is first-class):

- ``format="appended"`` raw, compressed or not, UInt32/UInt64 headers
- ``format="binary"`` (base64 inline), compressed or not
- ``format="ascii"``
"""

from __future__ import annotations

import base64
import re
import zlib
from typing import Dict, Optional, Tuple
from xml.etree import ElementTree

import numpy as np

from ..mesh import Mesh, NODES_PER_CELL, VTK_CELL_IDS, VTK_ID_TO_TYPE
from ..utils.terminal import log, print_warning

_DTYPES = {
    "Int8": np.int8, "UInt8": np.uint8,
    "Int16": np.int16, "UInt16": np.uint16,
    "Int32": np.int32, "UInt32": np.uint32,
    "Int64": np.int64, "UInt64": np.uint64,
    "Float32": np.float32, "Float64": np.float64,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


class VTUFile:
    """Parsed .vtu file with lazily-decoded data arrays."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            blob = fh.read()
        xml_bytes, self._appended = _split_appended(blob)
        self.root = ElementTree.fromstring(xml_bytes)
        if self.root.tag != "VTKFile":
            raise ValueError(f"{path}: not a VTKFile")
        self.byte_order = self.root.get("byte_order", "LittleEndian")
        if self.byte_order != "LittleEndian":
            raise NotImplementedError("BigEndian VTU files are not supported")
        self.header_dtype = np.dtype(
            _DTYPES[self.root.get("header_type", "UInt32")])
        self.compressed = self.root.get("compressor") is not None
        if self.root.get("compressor") not in (None, "vtkZLibDataCompressor"):
            raise NotImplementedError(
                f"unsupported compressor {self.root.get('compressor')}")
        grid = self.root.find("UnstructuredGrid")
        if grid is None:
            raise ValueError(f"{path}: not an UnstructuredGrid VTU")
        self.piece = grid.find("Piece")
        if self.piece is None:
            raise ValueError(f"{path}: no Piece element")
        self.n_points = int(self.piece.get("NumberOfPoints"))
        self.n_cells = int(self.piece.get("NumberOfCells"))

    # -- section readers ----------------------------------------------------

    def points(self) -> np.ndarray:
        """Node coordinates [n_points, 3] float64."""
        da = self.piece.find("Points/DataArray")
        arr = self._decode(da)
        ncomp = int(da.get("NumberOfComponents", "3"))
        return arr.reshape(self.n_points, ncomp).astype(np.float64)

    def cells(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(connectivity, offsets, types) exactly as stored (0-based conn)."""
        section = self.piece.find("Cells")
        out = {}
        for da in section.findall("DataArray"):
            out[da.get("Name")] = self._decode(da)
        return (out["connectivity"].astype(np.int64),
                out["offsets"].astype(np.int64),
                out["types"].astype(np.int64))

    def _field_data(self, section_name: str) -> Dict[str, np.ndarray]:
        section = self.piece.find(section_name)
        data: Dict[str, np.ndarray] = {}
        if section is None:
            return data
        for da in section.findall("DataArray"):
            name = da.get("Name")
            arr = self._decode(da)
            ncomp = int(da.get("NumberOfComponents", "1"))
            if ncomp > 1:
                arr = arr.reshape(-1, ncomp)
            data[name] = arr
        return data

    def cell_data(self) -> Dict[str, np.ndarray]:
        return self._field_data("CellData")

    def point_data(self) -> Dict[str, np.ndarray]:
        return self._field_data("PointData")

    # -- decoding -----------------------------------------------------------

    def _decode(self, da) -> np.ndarray:
        dtype = np.dtype(_DTYPES[da.get("type")])
        fmt = da.get("format", "ascii")
        if fmt == "ascii":
            return np.array((da.text or "").split(), dtype=dtype)
        if fmt == "appended":
            offset = int(da.get("offset", "0"))
            return self._decode_block(self._appended, offset, dtype)
        if fmt == "binary":
            text = re.sub(rb"\s", b"", (da.text or "").encode())
            if not self.compressed:
                return self._decode_block(base64.b64decode(text), 0, dtype)
            return self._decode_inline_compressed(text, dtype)
        raise NotImplementedError(f"unknown DataArray format {fmt!r}")

    def _decode_inline_compressed(self, text: bytes, dtype) -> np.ndarray:
        """format="binary" + vtkZLibDataCompressor: VTK base64-encodes the
        (3+n_blocks)-word header and the compressed data as two SEPARATE
        streams concatenated in the element text — they cannot be decoded
        as one stream (each is padded to its own 3-byte quantum)."""
        hsize = self.header_dtype.itemsize

        def b64_len(nbytes: int) -> int:
            return 4 * ((nbytes + 2) // 3)

        # pass 1: decode just enough characters to read n_blocks
        probe = base64.b64decode(text[: b64_len(3 * hsize)][: len(text)
                                                            // 4 * 4])
        n_blocks = int(np.frombuffer(probe, self.header_dtype, 1, 0)[0])
        header_bytes = (3 + n_blocks) * hsize
        header_chars = b64_len(header_bytes)
        head = np.frombuffer(base64.b64decode(text[:header_chars]),
                             self.header_dtype, 3 + n_blocks, 0)
        csizes = head[3:]
        # pass 2: the data stream starts at the header stream's end
        buf = base64.b64decode(text[header_chars:])
        chunks = []
        pos = 0
        for cs in csizes.astype(np.int64):
            chunks.append(zlib.decompress(buf[pos:pos + cs]))
            pos += int(cs)
        raw = b"".join(chunks)
        return np.frombuffer(raw, dtype, len(raw) // dtype.itemsize)

    def _decode_block(self, buf: bytes, offset: int, dtype) -> np.ndarray:
        hsize = self.header_dtype.itemsize
        if not self.compressed:
            nbytes = int(np.frombuffer(buf, self.header_dtype, 1, offset)[0])
            start = offset + hsize
            return np.frombuffer(buf, dtype, nbytes // dtype.itemsize, start)
        # vtkZLibDataCompressor block layout:
        #   [n_blocks, block_size, last_block_size, csize_1..csize_n] headers
        #   followed by the concatenated zlib streams.
        head = np.frombuffer(buf, self.header_dtype, 3, offset)
        n_blocks = int(head[0])
        csizes = np.frombuffer(buf, self.header_dtype, n_blocks,
                               offset + 3 * hsize)
        data_start = offset + (3 + n_blocks) * hsize
        chunks = []
        pos = data_start
        for cs in csizes.astype(np.int64):
            chunks.append(zlib.decompress(buf[pos:pos + cs]))
            pos += int(cs)
        raw = b"".join(chunks)
        return np.frombuffer(raw, dtype, len(raw) // dtype.itemsize)


def _split_appended(blob: bytes) -> Tuple[bytes, bytes]:
    """Split file bytes into parseable XML and the raw appended payload."""
    m = re.search(rb"<AppendedData[^>]*>", blob)
    if m is None:
        return blob, b""
    enc_m = re.search(rb'encoding="([^"]+)"', m.group(0))
    encoding = (enc_m.group(1).decode() if enc_m else "raw")
    payload_start = blob.index(b"_", m.end()) + 1
    payload_end = blob.rindex(b"</AppendedData>")
    # NOTE: do not strip trailing "whitespace" — zlib streams may legally end
    # in 0x0a/0x20 bytes; offsets are relative to payload start so trailing
    # writer-inserted newlines before the close tag are harmless.
    payload = blob[payload_start:payload_end]
    if encoding == "base64":
        payload = base64.b64decode(re.sub(rb"\s", b"", payload))
    elif encoding != "raw":
        raise NotImplementedError(f"AppendedData encoding {encoding!r}")
    xml_bytes = blob[: m.end()] + b"</AppendedData></VTKFile>"
    return xml_bytes, payload


# ---------------------------------------------------------------------------
# High-level mesh import (reference: MeshImport.jl:20-164)
# ---------------------------------------------------------------------------

#: cell-data field names probed for cellsets, in reference order
#: (reference: MeshImport.jl:129-130)
CELLSET_FIELD_NAMES = ("CellEntityIds", "element_ids", "gmsh:physical",
                       "ElementId")

#: density field names probed, in reference order (MeshImport.jl:195-196)
DENSITY_FIELD_NAMES = ("density", "rho", "Density", "DENSITY", "volfrac",
                       "VolFrac", "vol_frac")


def read_vtu_mesh(path: str) -> Mesh:
    """Read a .vtu file into a homogeneous :class:`Mesh`.

    Follows the reference's dominant-cell-type rule: cells are grouped by
    VTK type and the grid is built from the most common type; other cells
    are dropped with a warning (reference: MeshImport.jl:63-121).
    Cellsets are imported from the first matching cell-data field
    (reference: MeshImport.jl:129-150).
    """
    vtu = VTUFile(path)
    points = vtu.points()
    connectivity, offsets, types = vtu.cells()

    type_ids, counts = np.unique(types, return_counts=True)
    known = [t for t in type_ids if int(t) in VTK_ID_TO_TYPE]
    unknown = [t for t in type_ids if int(t) not in VTK_ID_TO_TYPE]
    for t in unknown:
        print_warning(f"Unsupported VTK cell type: {int(t)}, skipping")
    if not known:
        raise ValueError("No supported cell types found in the mesh")
    dominant = int(max(known, key=lambda t: counts[list(type_ids).index(t)]))
    etype = VTK_ID_TO_TYPE[dominant]
    log(f"  Dominant cell type: {dominant}")

    sel = np.flatnonzero(types == dominant)
    k = NODES_PER_CELL[etype]
    starts = np.concatenate([[0], offsets[:-1]])
    # homogeneous selection -> vectorized gather of each cell's k node ids
    idx = starts[sel][:, None] + np.arange(k)[None, :]
    conn = connectivity[idx].astype(np.int32)
    log(f"  Created grid with {len(conn)} {etype} cells")

    cellsets: Dict[str, np.ndarray] = {}
    try:
        cdata = vtu.cell_data()
        for name in CELLSET_FIELD_NAMES:
            if name in cdata:
                ids = np.asarray(cdata[name]).reshape(-1)[sel]
                for uid in np.unique(ids):
                    members = np.flatnonzero(ids == uid)
                    if members.size:
                        key = f"cellset_{_fmt_id(uid)}"
                        cellsets[key] = members
                        log(f"  Added {key} with {members.size} cells")
                break
    except Exception as e:  # mirror reference's tolerant import
        print_warning(f"Could not import cell data: {e}")

    mesh = Mesh(points, conn, etype, cellsets=cellsets)
    log(f"Mesh imported successfully: {mesh.n_nodes} nodes, "
        f"{mesh.n_cells} elements")
    return mesh


def _fmt_id(uid) -> str:
    f = float(uid)
    return str(int(f)) if f.is_integer() else str(f)


def read_cell_density(path: str) -> np.ndarray:
    """Extract the per-cell density field from a .vtu file.

    Probes the same field names in the same order as the reference
    (reference: MeshImport.jl:177-215).
    """
    vtu = VTUFile(path)
    try:
        cdata = vtu.cell_data()
    except Exception as e:
        raise ValueError(f"No density data found in the mesh file: {e}")
    for name in DENSITY_FIELD_NAMES:
        if name in cdata:
            log(f"  Extracted density data from field '{name}'")
            return np.asarray(cdata[name], dtype=np.float64).reshape(-1)
    raise ValueError("No density data found in the mesh file")


# ---------------------------------------------------------------------------
# Writer (reference: ResultsExport.jl:25-92 via WriteVTK)
# ---------------------------------------------------------------------------

class VTUWriter:
    """Streaming .vtu writer: appended raw data, zlib, UInt64 headers —
    the same variant the bundled fixtures use, so our reader round-trips."""

    def __init__(self, mesh: Mesh, compress: bool = True):
        self.mesh = mesh
        self.compress = compress
        self.point_data: Dict[str, np.ndarray] = {}
        self.cell_data: Dict[str, np.ndarray] = {}

    def add_point_data(self, name: str, arr: np.ndarray) -> "VTUWriter":
        arr = np.asarray(arr)
        if arr.shape[0] != self.mesh.n_nodes:
            raise ValueError(f"point data {name!r} first dim must be n_nodes")
        self.point_data[name] = arr
        return self

    def add_cell_data(self, name: str, arr: np.ndarray) -> "VTUWriter":
        arr = np.asarray(arr)
        if arr.shape[0] != self.mesh.n_cells:
            raise ValueError(f"cell data {name!r} first dim must be n_cells")
        self.cell_data[name] = arr
        return self

    def write(self, path: str) -> str:
        if not path.endswith(".vtu"):
            path = path + ".vtu"
        m = self.mesh
        blocks: list = []   # raw bytes per DataArray, encoded later
        xml: list = []

        def data_array(arr: np.ndarray, name: Optional[str] = None) -> str:
            arr = np.ascontiguousarray(arr)
            dtname = _DTYPE_NAMES[arr.dtype]
            ncomp = arr.shape[1] if arr.ndim == 2 else 1
            offset = sum(len(b) for b in blocks)
            blocks.append(_encode_block(arr.tobytes(), self.compress))
            nm = f' Name="{name}"' if name else ""
            nc = f' NumberOfComponents="{ncomp}"' if arr.ndim == 2 else ""
            return (f'<DataArray type="{dtname}"{nm}{nc} '
                    f'format="appended" offset="{offset}"/>')

        comp = ' compressor="vtkZLibDataCompressor"' if self.compress else ""
        xml.append('<?xml version="1.0"?>')
        xml.append(f'<VTKFile type="UnstructuredGrid" version="1.0" '
                   f'byte_order="LittleEndian" header_type="UInt64"{comp}>')
        xml.append("<UnstructuredGrid>")
        xml.append(f'<Piece NumberOfPoints="{m.n_nodes}" '
                   f'NumberOfCells="{m.n_cells}">')

        xml.append("<Points>")
        xml.append(data_array(m.coords.astype(np.float64)))
        xml.append("</Points>")

        xml.append("<Cells>")
        xml.append(data_array(m.conn.astype(np.int64).reshape(-1),
                              "connectivity"))
        k = m.nodes_per_cell
        xml.append(data_array(
            (np.arange(1, m.n_cells + 1, dtype=np.int64) * k), "offsets"))
        xml.append(data_array(
            np.full(m.n_cells, VTK_CELL_IDS[m.element_type], dtype=np.uint8),
            "types"))
        xml.append("</Cells>")

        if self.point_data:
            xml.append("<PointData>")
            for name, arr in self.point_data.items():
                xml.append(data_array(arr, name))
            xml.append("</PointData>")
        if self.cell_data:
            xml.append("<CellData>")
            for name, arr in self.cell_data.items():
                xml.append(data_array(arr, name))
            xml.append("</CellData>")

        xml.append("</Piece>")
        xml.append("</UnstructuredGrid>")
        xml.append('<AppendedData encoding="raw">')

        with open(path, "wb") as fh:
            fh.write("\n".join(xml).encode())
            fh.write(b"\n_")
            for b in blocks:
                fh.write(b)
            fh.write(b"\n</AppendedData>\n</VTKFile>\n")
        return path


def _encode_block(raw: bytes, compress: bool) -> bytes:
    header_dtype = np.uint64
    if not compress:
        return np.array([len(raw)], dtype=header_dtype).tobytes() + raw
    block_size = 1 << 15  # 32768, WriteVTK/VTK default
    nblocks = max(1, (len(raw) + block_size - 1) // block_size)
    last = len(raw) - (nblocks - 1) * block_size
    comp = [zlib.compress(raw[i * block_size:(i + 1) * block_size])
            for i in range(nblocks)]
    head = np.array([nblocks, block_size, last] + [len(c) for c in comp],
                    dtype=header_dtype)
    return head.tobytes() + b"".join(comp)


def write_vtu(path: str, mesh: Mesh,
              point_data: Optional[Dict[str, np.ndarray]] = None,
              cell_data: Optional[Dict[str, np.ndarray]] = None) -> str:
    w = VTUWriter(mesh)
    for name, arr in (point_data or {}).items():
        w.add_point_data(name, arr)
    for name, arr in (cell_data or {}).items():
        w.add_cell_data(name, arr)
    return w.write(path)


def write_vtu_heterogeneous(path: str, coords: np.ndarray, cells,
                            compress: bool = True) -> str:
    """Write a mixed-element UnstructuredGrid: ``cells`` is a list of
    (vtk_type_id, node_id_list).  The .inp converter writes through it
    (the reference exports heterogeneous meshes via WriteVTK MeshCells,
    InpToVtu.jl:109-180)."""
    if not path.endswith(".vtu"):
        path = path + ".vtu"
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    conn = np.concatenate([np.asarray(c, dtype=np.int64)
                           for _, c in cells])
    sizes = np.array([len(c) for _, c in cells], dtype=np.int64)
    offsets = np.cumsum(sizes)
    types = np.array([t for t, _ in cells], dtype=np.uint8)

    blocks: list = []
    xml: list = []

    def data_array(arr, name=None):
        arr = np.ascontiguousarray(arr)
        dtname = _DTYPE_NAMES[arr.dtype]
        ncomp = arr.shape[1] if arr.ndim == 2 else 1
        offset = sum(len(b) for b in blocks)
        blocks.append(_encode_block(arr.tobytes(), compress))
        nm = f' Name="{name}"' if name else ""
        nc = f' NumberOfComponents="{ncomp}"' if arr.ndim == 2 else ""
        return (f'<DataArray type="{dtname}"{nm}{nc} '
                f'format="appended" offset="{offset}"/>')

    comp = ' compressor="vtkZLibDataCompressor"' if compress else ""
    xml.append('<?xml version="1.0"?>')
    xml.append(f'<VTKFile type="UnstructuredGrid" version="1.0" '
               f'byte_order="LittleEndian" header_type="UInt64"{comp}>')
    xml.append("<UnstructuredGrid>")
    xml.append(f'<Piece NumberOfPoints="{len(coords)}" '
               f'NumberOfCells="{len(cells)}">')
    xml.append("<Points>")
    xml.append(data_array(coords))
    xml.append("</Points>")
    xml.append("<Cells>")
    xml.append(data_array(conn, "connectivity"))
    xml.append(data_array(offsets, "offsets"))
    xml.append(data_array(types, "types"))
    xml.append("</Cells>")
    xml.append("</Piece>")
    xml.append("</UnstructuredGrid>")
    xml.append('<AppendedData encoding="raw">')
    with open(path, "wb") as fh:
        fh.write("\n".join(xml).encode())
        fh.write(b"\n_")
        for b in blocks:
            fh.write(b)
        fh.write(b"\n</AppendedData>\n</VTKFile>\n")
    return path
