"""GMSH .msh reader (v2.2 and v4.1, ASCII and binary), host-side I/O
(counterpart of ``topopteval_tpu.io.gmsh``; reference:
src/MeshImport/MeshImport.jl:28, ``FerriteGmsh.togrid``, which reads both
ASCII and binary).

It builds the same homogeneous dominant-type :class:`..mesh.Mesh` the VTU
path produces, and imports:

- **named physical groups** ($PhysicalNames): dominant-type groups
  become NAMED cellsets (plus the ``cellset_<tag>`` numeric aliases);
- **lower-dimensional physical groups** (surface tri/quad, curve line
  elements) as NAMED nodesets for BC selection through
  ``fem.bc.select_nodes_by_set`` (FerriteGmsh semantics);
- the tet10 and hex20 node orders, mapped from gmsh's onto VTK's;
- unsupported and other second-order element types are skipped with a
  warning.

ASCII sections are decoded with one vectorised ``np.fromstring`` each, so
a million-element file imports in seconds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..mesh import Mesh, NODES_PER_CELL
from ..utils.terminal import log, print_warning

#: GMSH element type id → our element type
_GMSH_TYPES = {
    1: "line2",
    2: "tri3",
    3: "quad4",
    4: "tet4",
    5: "hex8",
    11: "tet10",
    17: "hex20",
}

#: gmsh node order → internal (VTK) node order, applied to the raw
#: connectivity of the types whose orderings differ.  gmsh tet10 puts
#: edge (2,3) at slot 8 and (1,3) at slot 9 — VTK swaps them; gmsh
#: hex20 orders the 12 mid-edge nodes edge-lexicographically while VTK
#: walks bottom ring, top ring, then the vertical edges.
_GMSH_TO_VTK = {
    "tet10": np.array([0, 1, 2, 3, 4, 5, 6, 7, 9, 8]),
    "hex20": np.array([0, 1, 2, 3, 4, 5, 6, 7,
                       8, 11, 13, 9, 16, 18, 19, 17, 10, 12, 14, 15]),
}

#: topological dimension per our element type
_TYPE_DIM = {"line2": 1, "tri3": 2, "quad4": 2, "tet4": 3, "hex8": 3,
             "tet10": 3, "hex20": 3}

#: gmsh canonical node counts (for record-skipping of unsupported types)
_GMSH_NNODES = {15: 1, 1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5,
                8: 3, 9: 6, 10: 9, 11: 10, 12: 27, 13: 18, 14: 14,
                # second-order and higher standard gmsh types: records of
                # these are skipped with a warning, not rejected
                16: 8, 17: 20, 18: 15, 19: 13, 20: 9, 21: 10, 22: 12,
                23: 15, 24: 15, 25: 21, 26: 4, 27: 5, 28: 6, 29: 20,
                30: 35, 31: 56}

_SOLID = ("tet4", "hex8", "tet10", "hex20")


def _read_sections(path: str) -> Dict[str, List[str]]:
    sections: Dict[str, List[str]] = {}
    current = None
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if line.startswith("$End"):
                current = None
            elif line.startswith("$"):
                current = line[1:]
                sections[current] = []
            elif current is not None:
                sections[current].append(line)
    return sections


def _parse_physical_names(lines: List[str]) -> Dict[Tuple[int, int], str]:
    """$PhysicalNames body → {(dim, tag): name}."""
    out: Dict[Tuple[int, int], str] = {}
    if not lines:
        return out
    n = int(lines[0])
    for ln in lines[1: 1 + n]:
        parts = ln.split(None, 2)
        if len(parts) < 3:
            continue
        out[(int(parts[0]), int(parts[1]))] = parts[2].strip().strip('"')
    return out


def _ints(lines: List[str]) -> np.ndarray:
    """Vectorized decode of whitespace-separated integers."""
    if not lines:
        return np.zeros(0, np.int64)
    return np.fromstring(" ".join(lines), dtype=np.int64, sep=" ")


def _floats(lines: List[str]) -> np.ndarray:
    if not lines:
        return np.zeros(0, np.float64)
    return np.fromstring(" ".join(lines), dtype=np.float64, sep=" ")


def read_msh_mesh(path: str) -> Mesh:
    with open(path, "rb") as fh:
        head = fh.read(256)
    m = head.split(b"$MeshFormat", 1)
    if len(m) < 2:
        raise ValueError(f"{path}: not a GMSH .msh file")
    fmt_line = m[1].lstrip().splitlines()[0].split()
    version = float(fmt_line[0])
    binary = fmt_line[1] != b"0"
    if binary:
        coords, ids, elems, names = (_parse_v4_binary(path)
                                     if version >= 4.0
                                     else _parse_v2_binary(path))
    else:
        sec = _read_sections(path)
        names = _parse_physical_names(sec.get("PhysicalNames", []))
        if version >= 4.0:
            coords, ids, elems = _parse_v4(sec)
        else:
            coords, ids, elems = _parse_v2(sec)

    # gmsh node id → 0-based index lookup table
    ids = np.asarray(ids, np.int64)
    lut = np.full(int(ids.max()) + 1 if ids.size else 1, -1, np.int64)
    lut[ids] = np.arange(ids.size)

    # dominant-type rule, matching the VTU path (MeshImport.jl:92-121)
    counts = {t: len(v) for t, (v, _) in elems.items()}
    solid = {t: c for t, c in counts.items() if t in _SOLID}
    pool = solid or counts
    if not pool:
        raise ValueError("No supported cell types found in the mesh")
    etype = max(pool, key=pool.get)
    conn_raw, tags = elems[etype]
    conn = lut[np.asarray(conn_raw, np.int64)].astype(np.int32)
    if etype in _GMSH_TO_VTK:
        conn = conn[:, _GMSH_TO_VTK[etype]]

    dom_dim = _TYPE_DIM[etype]
    cellsets: Dict[str, np.ndarray] = {}
    tags = np.asarray(tags)
    for tag in np.unique(tags):
        members = np.flatnonzero(tags == tag)
        if members.size:
            cellsets[f"cellset_{int(tag)}"] = members
            name = names.get((dom_dim, int(tag)))
            if name:
                cellsets[name] = members

    # lower-dimensional element blocks → named node sets (surface/curve
    # physical groups; FerriteGmsh keeps these as facesets/nodesets)
    nodesets: Dict[str, np.ndarray] = {}
    for t2, (conn2, tags2) in elems.items():
        if t2 == etype or not len(conn2):
            continue
        c2 = lut[np.asarray(conn2, np.int64)]
        t2_dim = _TYPE_DIM[t2]
        tags2 = np.asarray(tags2)
        for tag in np.unique(tags2):
            sel = tags2 == tag
            nodes = np.unique(c2[sel])
            nodes = nodes[nodes >= 0]
            if not nodes.size:
                continue
            name = names.get((t2_dim, int(tag)),
                             f"{t2}_set_{int(tag)}")
            prev = nodesets.get(name)
            nodesets[name] = (nodes if prev is None
                              else np.union1d(prev, nodes))

    mesh = Mesh(coords, conn, etype, cellsets=cellsets,
                nodesets=nodesets)
    log(f"Mesh imported successfully: {mesh.n_nodes} nodes, "
        f"{mesh.n_cells} elements"
        + (f", {len(nodesets)} named node set(s)" if nodesets else ""))
    return mesh


def _parse_v2(sec):
    """v2.2 ASCII: vectorized — one fromstring over each section, then a
    light integer walk over record headers (the only per-record python
    work; node lists are sliced with one fancy index per type)."""
    lines = sec["Nodes"]
    n = int(lines[0])
    arr = _floats(lines[1: 1 + n]).reshape(n, 4)
    ids = arr[:, 0].astype(np.int64)
    coords = np.ascontiguousarray(arr[:, 1:4])

    elines = sec["Elements"]
    ne = int(elines[0])
    flat = _ints(elines[1: 1 + ne])
    # v2 ASCII records are one per line, so record boundaries come from
    # per-line token counts — no node-count table needed to walk the
    # stream, and records of ANY element type (known or not) parse
    tok = np.fromiter((len(ln.split()) for ln in elines[1: 1 + ne]),
                      np.int64, count=ne)
    starts = np.concatenate([[0], np.cumsum(tok[:-1])])
    gtypes = flat[starts + 1]
    ntags_a = flat[starts + 2]
    elems: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for g in np.unique(gtypes):
        etype = _GMSH_TYPES.get(int(g))
        if etype is None:
            print_warning(f"Unsupported GMSH element type: {int(g)}, "
                          "skipping")
            continue
        k = NODES_PER_CELL[etype]
        for nt in np.unique(ntags_a[gtypes == g]):
            sel = (gtypes == g) & (ntags_a == nt)
            s = starts[sel]
            nodes = flat[s[:, None] + 3 + int(nt)
                         + np.arange(k)[None, :]]
            phys = (flat[s + 3] if nt >= 1
                    else np.zeros(sel.sum(), np.int64))
            prev = elems.get(etype)
            if prev is None:
                elems[etype] = (nodes, phys)
            else:
                elems[etype] = (np.concatenate([prev[0], nodes]),
                                np.concatenate([prev[1], phys]))
    return coords, ids, elems


def _parse_entities_v4(sec) -> Dict[Tuple[int, int], int]:
    """$Entities → {(dim, entityTag): physicalTag} (first physical tag).

    The reference imports cell sets keyed by gmsh *physical* groups
    (FerriteGmsh behavior); the $Elements block only carries geometric
    entity tags, so this mapping is required whenever they differ.
    """
    phys: Dict[Tuple[int, int], int] = {}
    if "Entities" not in sec:
        return phys
    lines = sec["Entities"]
    counts = [int(x) for x in lines[0].split()]  # points curves surfs vols
    i = 1
    for dim, n in enumerate(counts):
        for _ in range(n):
            parts = lines[i].split()
            i += 1
            tag = int(parts[0])
            # points: tag x y z numPhys [...]; others: tag 6x bbox numPhys [...]
            np_idx = 4 if dim == 0 else 7
            if len(parts) > np_idx and int(parts[np_idx]) > 0:
                phys[(dim, tag)] = int(parts[np_idx + 1])
    return phys


def _parse_v4(sec):
    """v4.1 ASCII: block-uniform records → one fromstring + reshape per
    block (vectorized)."""
    lines = sec["Nodes"]
    head = lines[0].split()
    num_blocks = int(head[0])
    ids_l: List[np.ndarray] = []
    coords_l: List[np.ndarray] = []
    i = 1
    for _ in range(num_blocks):
        _, _, _, n_in_block = (int(x) for x in lines[i].split())
        i += 1
        ids_l.append(_ints(lines[i: i + n_in_block]))
        i += n_in_block
        coords_l.append(_floats(lines[i: i + n_in_block])
                        .reshape(n_in_block, 3))
        i += n_in_block
    coords = (np.concatenate(coords_l) if coords_l
              else np.zeros((0, 3)))
    ids = (np.concatenate(ids_l) if ids_l else np.zeros(0, np.int64))

    phys_map = _parse_entities_v4(sec)
    elines = sec["Elements"]
    num_blocks = int(elines[0].split()[0])
    elems: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    i = 1
    for _ in range(num_blocks):
        entity_dim, entity_tag, gtype, n_in_block = (
            int(x) for x in elines[i].split())
        i += 1
        etype = _GMSH_TYPES.get(gtype)
        if etype is None:
            print_warning(f"Unsupported GMSH element type: {gtype}, "
                          "skipping")
            i += n_in_block
            continue
        k = NODES_PER_CELL[etype]
        block = _ints(elines[i: i + n_in_block]).reshape(n_in_block,
                                                         1 + k)
        i += n_in_block
        # key cell sets by the physical group; fall back to the geometric
        # entity tag when no physical group is attached
        tag = phys_map.get((entity_dim, entity_tag), entity_tag)
        nodes = block[:, 1:]
        phys = np.full(n_in_block, tag, np.int64)
        prev = elems.get(etype)
        if prev is None:
            elems[etype] = (nodes, phys)
        else:
            elems[etype] = (np.concatenate([prev[0], nodes]),
                            np.concatenate([prev[1], phys]))
    return coords, ids, elems


# ---------------------------------------------------------------------------
# Binary parsers (MSH v2.2 and v4.1 binary, which FerriteGmsh reads too)
# ---------------------------------------------------------------------------


def _find_section(blob: bytes, name: str):
    """(payload_start, payload_end) byte offsets of a $NAME section."""
    tag = b"$" + name.encode()
    i = blob.find(tag + b"\n")
    if i < 0:
        i = blob.find(tag + b"\r\n")
        if i < 0:
            return None
    start = blob.index(b"\n", i) + 1
    end = blob.find(b"$End" + name.encode(), start)
    return start, end


def _read_line(blob: bytes, pos: int):
    end = blob.index(b"\n", pos)
    return blob[pos:end].decode().strip(), end + 1


def _names_from_blob(blob: bytes) -> Dict[Tuple[int, int], str]:
    """$PhysicalNames is ASCII text even in binary files."""
    span = _find_section(blob, "PhysicalNames")
    if span is None:
        return {}
    text = blob[span[0]:span[1]].decode(errors="replace")
    return _parse_physical_names(
        [ln.strip() for ln in text.splitlines() if ln.strip()])


def _parse_v2_binary(path: str):
    """MSH 2.2 file-type=1: ASCII section headers, binary records
    (int32 ids/tags, float64 coords), native endianness verified via the
    'one' integer in $MeshFormat."""
    blob = open(path, "rb").read()
    s, e = _find_section(blob, "MeshFormat")
    _, pos = _read_line(blob, s)
    one = np.frombuffer(blob, "<i4", 1, pos)[0]
    sw = "<" if one == 1 else ">"

    s, e = _find_section(blob, "Nodes")
    line, pos = _read_line(blob, s)
    n = int(line)
    rec = np.dtype([("id", sw + "i4"), ("xyz", sw + "f8", 3)])
    nodes = np.frombuffer(blob, rec, n, pos)
    coords = np.ascontiguousarray(nodes["xyz"], dtype=np.float64)
    ids = nodes["id"].astype(np.int64)

    s, e = _find_section(blob, "Elements")
    line, pos = _read_line(blob, s)
    ne = int(line)
    elems: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    read = 0
    while read < ne and pos < e:
        gtype, nfollow, ntags = np.frombuffer(blob, sw + "i4", 3, pos)
        pos += 12
        etype = _GMSH_TYPES.get(int(gtype))
        npc = NODES_PER_CELL.get(etype, 0)
        k = npc or _GMSH_NNODES.get(int(gtype))
        if k is None:
            raise NotImplementedError(
                f"binary .msh: unknown element type {int(gtype)}")
        rec_len = 1 + int(ntags) + k
        data = np.frombuffer(blob, sw + "i4",
                             int(nfollow) * rec_len, pos).reshape(
            int(nfollow), rec_len)
        pos += data.nbytes
        read += int(nfollow)
        if etype is None:
            print_warning(
                f"Unsupported GMSH element type: {int(gtype)}, skipping")
            continue
        phys = (data[:, 1].astype(np.int64) if ntags >= 1
                else np.zeros(int(nfollow), np.int64))
        nodes_b = data[:, 1 + int(ntags):].astype(np.int64)
        prev = elems.get(etype)
        if prev is None:
            elems[etype] = (nodes_b, phys)
        else:
            elems[etype] = (np.concatenate([prev[0], nodes_b]),
                            np.concatenate([prev[1], phys]))
    return coords, ids, elems, _names_from_blob(blob)


def _parse_v4_binary(path: str):
    """MSH 4.1 file-type=1: size_t block headers, float64 coords."""
    blob = open(path, "rb").read()
    s, e = _find_section(blob, "MeshFormat")
    line, pos = _read_line(blob, s)
    dsize = int(line.split()[2])
    one = np.frombuffer(blob, "<i4", 1, pos)[0]
    sw = "<" if one == 1 else ">"
    szt = sw + ("u8" if dsize == 8 else "u4")
    i4 = sw + "i4"

    phys_map: Dict[Tuple[int, int], int] = {}
    sec_ent = _find_section(blob, "Entities")
    if sec_ent:
        pos = sec_ent[0]
        counts = np.frombuffer(blob, szt, 4, pos)
        pos += 4 * dsize
        for dim, n in enumerate(int(x) for x in counts):
            for _ in range(n):
                tag = int(np.frombuffer(blob, i4, 1, pos)[0])
                pos += 4
                pos += (3 if dim == 0 else 6) * 8          # bbox doubles
                nphys = int(np.frombuffer(blob, szt, 1, pos)[0])
                pos += dsize
                if nphys > 0:
                    phys_map[(dim, tag)] = int(
                        np.frombuffer(blob, i4, 1, pos)[0])
                pos += 4 * nphys
                if dim > 0:
                    nb = int(np.frombuffer(blob, szt, 1, pos)[0])
                    pos += dsize + 4 * nb

    s, e = _find_section(blob, "Nodes")
    pos = s
    nblocks, total = (int(x) for x in np.frombuffer(blob, szt, 2, pos))
    pos += 4 * dsize
    ids_l: List[np.ndarray] = []
    coords_l: List[np.ndarray] = []
    for _ in range(nblocks):
        nin = int(np.frombuffer(blob, szt, 1, pos + 12)[0])
        pos += 12 + dsize
        ids_l.append(np.frombuffer(blob, szt, nin, pos).astype(np.int64))
        pos += nin * dsize
        coords_l.append(np.frombuffer(blob, sw + "f8", 3 * nin,
                                      pos).reshape(nin, 3))
        pos += nin * 24
    coords = (np.concatenate(coords_l) if coords_l
              else np.zeros((0, 3)))
    ids = (np.concatenate(ids_l) if ids_l else np.zeros(0, np.int64))

    s, e = _find_section(blob, "Elements")
    pos = s
    nblocks, total = (int(x) for x in np.frombuffer(blob, szt, 2, pos))
    pos += 4 * dsize
    elems: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for _ in range(nblocks):
        edim = int(np.frombuffer(blob, i4, 1, pos)[0])
        etag = int(np.frombuffer(blob, i4, 1, pos + 4)[0])
        gtype = int(np.frombuffer(blob, i4, 1, pos + 8)[0])
        nin = int(np.frombuffer(blob, szt, 1, pos + 12)[0])
        pos += 12 + dsize
        etype = _GMSH_TYPES.get(gtype)
        k = NODES_PER_CELL.get(etype) or _GMSH_NNODES.get(gtype)
        if k is None:
            raise NotImplementedError(
                f"binary .msh: unknown element type {gtype}")
        data = np.frombuffer(blob, szt, nin * (1 + k), pos).reshape(
            nin, 1 + k)
        pos += data.nbytes
        if etype is None:
            print_warning(
                f"Unsupported GMSH element type: {gtype}, skipping")
            continue
        tag = phys_map.get((edim, etag), etag)
        nodes_b = data[:, 1:].astype(np.int64)
        phys = np.full(nin, tag, np.int64)
        prev = elems.get(etype)
        if prev is None:
            elems[etype] = (nodes_b, phys)
        else:
            elems[etype] = (np.concatenate([prev[0], nodes_b]),
                            np.concatenate([prev[1], phys]))
    return coords, ids, elems, _names_from_blob(blob)
