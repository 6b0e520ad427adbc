"""Read-only VTR pose-graph model over rosbag2 sqlite storage. No ROS2.

A copy of ``mm_masking_tpu.data.pose_graph`` (numpy and the standard library
only), so that the port imports nothing of the JAX package.

Replaces the reference's `vtr3_pose_graph` package (an empty submodule in the
snapshot; behavior reconstructed from its call sites):

  * `Rosbag2GraphFactory(graph_dir).buildGraph()` + `graph.get_vertex((run,
    minor))` — `mm_masking/icp_weight_dataset.py:104-110`
  * `TemporalIterator(v_start)` yielding ``(vertex, edge)`` where the edge is
    the *incoming* temporal edge and `edge.from_id == INVALID_ID` marks an
    entry that must be skipped — `icp_weight_dataset.py:150-153`
  * `g_utils.get_closest_teach_vertex(vertex)` raising ``GraphError`` on a
    malformed graph ("repeat pass does not connect to teach vertex") —
    `icp_weight_dataset.py:156-163`
  * `vertex.get_data("pointmap_ptr").map_vid` → the teach vertex that holds
    the ``pointmap`` used as the localization map —
    `utils/extract_graph.py:45-48`
  * `vertex.stamp` in nanoseconds — `icp_weight_dataset.py:170`.

Storage model (documented reconstruction — the exact vtr3 serialization lives
in the unmounted submodule): a graph directory contains one or more rosbag2
`.db3` files (typically one per run, `run_000000/…`). Topics:

  * ``…vertexes`` — one message per vertex: {id: uint64, stamp ns}
  * ``…edges`` — {id, type (0 temporal / 1 spatial), from_id, to_id,
    t_to_from: float64[6]}
  * data streams (``…raw_point_cloud``, ``…filtered_point_cloud``,
    ``…pointmap``, ``…pointmap_ptr``) — rosbag message timestamp equals the
    owning vertex's stamp, which is how `get_data` associates them.

Vertex ids pack (run, minor) as ``run << 32 | minor`` (VTR's CombinedId).
``INVALID_ID = 2**64 - 1``.
"""
from __future__ import annotations

import dataclasses
import os
import os.path as osp
import sqlite3
import struct
from typing import Iterator

import numpy as np

from mm_masking_tpu_torch.data.convert import (
    CdrReader,
    Rosbag2Reader,
    _EDGE_TYPES,
    _VERTEX_TYPES,
    check_schema,
)

INVALID_ID = 2**64 - 1
TEMPORAL = 0
SPATIAL = 1


class GraphError(RuntimeError):
    """Malformed pose graph (mirrors vtr3_pose_graph's GraphError)."""


def vid_pack(run: int, minor: int) -> int:
    return (run << 32) | minor


def vid_unpack(vid: int) -> tuple[int, int]:
    return vid >> 32, vid & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Vertex:
    id: int  # packed (run << 32 | minor)
    stamp: int  # ns

    @property
    def run(self) -> int:
        return self.id >> 32

    @property
    def minor(self) -> int:
        return self.id & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Edge:
    id: int
    type: int  # TEMPORAL | SPATIAL
    from_id: int
    to_id: int
    t_to_from: np.ndarray  # se(3) twist (6,)


def parse_vertex_msg(buf: bytes) -> Vertex:
    r = CdrReader(buf)
    vid = r.uint64()
    sec = r.int32()
    nanosec = r.uint32()
    return Vertex(id=vid, stamp=sec * 1_000_000_000 + nanosec)


def parse_edge_msg(buf: bytes) -> Edge:
    r = CdrReader(buf)
    eid = r.uint64()
    etype = r.uint32()
    from_id = r.uint64()
    to_id = r.uint64()
    xi = r.float64_array(6)
    return Edge(id=eid, type=etype, from_id=from_id, to_id=to_id, t_to_from=xi)


def parse_pointmap_ptr_msg(buf: bytes):
    r = CdrReader(buf)
    return r.uint64()  # map_vid


def encode_vertex_msg(vid: int, stamp_ns: int) -> bytes:
    buf = bytearray(b"\x00\x01\x00\x00")
    buf += struct.pack("<Q", vid)
    buf += struct.pack("<iI", stamp_ns // 1_000_000_000, stamp_ns % 1_000_000_000)
    return bytes(buf)


def encode_edge_msg(eid: int, etype: int, from_id: int, to_id: int,
                    xi=None) -> bytes:
    buf = bytearray(b"\x00\x01\x00\x00")
    buf += struct.pack("<QIxxxxQQ", eid, etype, from_id, to_id)
    xi = np.zeros(6) if xi is None else np.asarray(xi, np.float64)
    buf += xi.astype("<f8").tobytes()
    return bytes(buf)


def encode_pointmap_ptr_msg(map_vid: int) -> bytes:
    return b"\x00\x01\x00\x00" + struct.pack("<Q", map_vid)


class PoseGraph:
    """In-memory pose graph: vertices, edges, and per-vertex data blobs."""

    def __init__(self):
        self.vertices: dict[int, Vertex] = {}
        self.edges: list[Edge] = []
        # stream name (suffix after the topic prefix) -> {vertex stamp: blob}
        self.data: dict[str, dict[int, bytes]] = {}
        # stream name -> recorded `topics.type` string (schema dispatch)
        self.data_type: dict[str, str] = {}
        self.skipped_files: list[str] = []

    # ------------------------------------------------------------------ load
    @classmethod
    def from_dir(cls, graph_dir: str) -> "PoseGraph":
        """Load every readable `.db3` under ``graph_dir``; corrupted files are
        recorded in ``skipped_files`` and skipped (the reference tolerates
        malformed graphs per-vertex, `icp_weight_dataset.py:157-163` — a
        per-file skip is the converter-level analog)."""
        g = cls()
        db_files = sorted(
            osp.join(root, f)
            for root, _, files in os.walk(graph_dir)
            for f in files
            if f.endswith(".db3")
        )
        if not db_files:
            raise FileNotFoundError(f"no rosbag2 .db3 files under {graph_dir}")
        for db in db_files:
            try:
                g._load_file(db)
            except (sqlite3.DatabaseError, ValueError, struct.error) as e:
                g.skipped_files.append(db)
                print(f"pose_graph: skipping unreadable bag {db}: {e}")
        return g

    def _load_file(self, db: str):
        reader = Rosbag2Reader(db)
        try:
            for topic in reader.topics():
                ttype = reader.topic_type.get(topic, "")
                if topic.endswith(("vertexes", "vertices")):
                    # Validate the recorded schema BEFORE decoding: an
                    # unexpected type string means the documented-guess CDR
                    # layout would silently mis-parse (UnknownSchemaError is
                    # not swallowed by from_dir's corrupt-file skip).
                    check_schema("vertex", _VERTEX_TYPES, ttype, topic)
                    for _, blob in reader.messages(topic):
                        v = parse_vertex_msg(blob)
                        self.vertices[v.id] = v
                elif topic.endswith("edges"):
                    check_schema("edge", _EDGE_TYPES, ttype, topic)
                    for _, blob in reader.messages(topic):
                        self._append_edge(parse_edge_msg(blob))
                else:
                    stream = topic.rsplit("/", 1)[-1]
                    dst = self.data.setdefault(stream, {})
                    self.data_type.setdefault(stream, ttype)
                    for ts, blob in reader.messages(topic):
                        dst[ts] = blob
        finally:
            reader.close()

    def _append_edge(self, e: Edge):
        self.edges.append(e)

    def add_edge(self, e: Edge):
        """Insert an edge and invalidate the adjacency caches (they are built
        lazily on first traversal; mutating ``edges`` directly after that
        would silently be ignored)."""
        self.edges.append(e)
        self._temporal_adj_cache = None
        self._spatial_adj_cache = None

    # ----------------------------------------------------------------- graph
    @property
    def number_of_vertices(self) -> int:
        return len(self.vertices)

    @property
    def number_of_edges(self) -> int:
        return len(self.edges)

    def runs(self) -> list[int]:
        return sorted({v.run for v in self.vertices.values()})

    def get_vertex(self, key) -> Vertex:
        vid = vid_pack(*key) if isinstance(key, tuple) else int(key)
        if vid not in self.vertices:
            raise GraphError(f"no vertex {vid_unpack(vid)} in graph")
        return self.vertices[vid]

    def get_data(self, v: Vertex, stream: str) -> bytes:
        """Data blob of ``stream`` owned by vertex ``v`` (matched by stamp).

        Topic names may carry pipeline prefixes (``radar_raw_point_cloud``);
        ``stream`` matches by suffix.
        """
        for name, msgs in self.data.items():
            if name.endswith(stream) and v.stamp in msgs:
                return msgs[v.stamp]
        raise GraphError(f"vertex {vid_unpack(v.id)} has no '{stream}' data")

    def get_data_typed(self, v: Vertex, stream: str) -> tuple[bytes, str]:
        """Like :meth:`get_data` but also returns the stream's recorded
        `topics.type` string for schema dispatch."""
        for name, msgs in self.data.items():
            if name.endswith(stream) and v.stamp in msgs:
                return msgs[v.stamp], self.data_type.get(name, "")
        raise GraphError(f"vertex {vid_unpack(v.id)} has no '{stream}' data")

    # ------------------------------------------------------------- iteration
    # Adjacency indices are built once on first use (convert_graph walks call
    # these per localization vertex — rebuilding per call makes the whole
    # conversion O(frames × edges)).
    # Caches are keyed on len(self.edges): `edges` is a public list callers
    # (and tests) append to directly, so a stale cache would silently ignore
    # edges added after the first traversal.
    @property
    def _temporal_adjacency(self):
        cached = getattr(self, "_temporal_adj_cache", None)
        if cached is None or cached[0] != len(self.edges):
            incoming: dict[int, Edge] = {}
            outgoing: dict[int, Edge] = {}
            for e in self.edges:
                if e.type == TEMPORAL:
                    incoming[e.to_id] = e
                    outgoing[e.from_id] = e
            cached = (len(self.edges), (incoming, outgoing))
            self._temporal_adj_cache = cached
        return cached[1]

    @property
    def _spatial_adjacency(self) -> dict[int, list[int]]:
        cached = getattr(self, "_spatial_adj_cache", None)
        if cached is None or cached[0] != len(self.edges):
            adj: dict[int, list[int]] = {}
            for e in self.edges:
                if e.type == SPATIAL:
                    adj.setdefault(e.from_id, []).append(e.to_id)
                    adj.setdefault(e.to_id, []).append(e.from_id)
            cached = (len(self.edges), adj)
            self._spatial_adj_cache = cached
        return cached[1]

    def temporal_iterator(self, v_start: Vertex) -> Iterator[tuple[Vertex, Edge]]:
        """Walk the temporal chain from ``v_start``, yielding ``(vertex,
        incoming_edge)``. The first yield carries a sentinel edge with
        ``from_id == INVALID_ID`` — callers skip it, exactly as the reference
        skips invalid-edge entries (`icp_weight_dataset.py:151-153`).
        """
        incoming, outgoing = self._temporal_adjacency

        sentinel = Edge(id=INVALID_ID, type=TEMPORAL, from_id=INVALID_ID,
                        to_id=v_start.id, t_to_from=np.zeros(6))
        yield v_start, incoming.get(v_start.id, sentinel)
        vid = v_start.id
        while vid in outgoing:
            e = outgoing[vid]
            vid = e.to_id
            if vid not in self.vertices:
                break
            yield self.vertices[vid], e

    def closest_teach_vertex(self, v: Vertex) -> Vertex:
        """Teach-run (run 0) vertex reachable from ``v`` via spatial edges.

        Follows the spatial-edge chain (repeat → … → teach); raises
        ``GraphError`` when the repeat vertex does not connect — the condition
        the reference catches and skips (`icp_weight_dataset.py:157-163`).
        """
        spatial = self._spatial_adjacency

        seen = {v.id}
        frontier = [v.id]
        while frontier:
            nxt = []
            for vid in frontier:
                for nb in spatial.get(vid, ()):
                    if nb in seen:
                        continue
                    seen.add(nb)
                    if nb in self.vertices and self.vertices[nb].run == 0:
                        return self.vertices[nb]
                    nxt.append(nb)
            frontier = nxt
        raise GraphError(
            "Graph is malformed, repeat pass does not connect to teach vertex."
        )
