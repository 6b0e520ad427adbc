"""Offline converter: VTR rosbag2 pose graphs → packed array shards. No ROS2.

A copy of ``mm_masking_tpu.data.convert`` (numpy and the standard library
only), so that the port imports nothing of the JAX package.

The reference reads its training data through a live ROS2 stack
(`Rosbag2GraphFactory` + rclpy deserialization,
`mm_masking/icp_weight_dataset.py:19-23,104-106`;
`utils/extract_pointcloud.py:10-36` shows the underlying sqlite + CDR access).
This module removes ROS2 from the runtime entirely (SURVEY.md §7.5): a
rosbag2 `.db3` file is plain sqlite, and messages are CDR-encoded blobs with a
fixed, documented layout — both readable with the standard library.

Provided pieces:
  * :class:`Rosbag2Reader` — topics/messages out of a rosbag2 sqlite file.
  * :class:`CdrReader` — minimal XCDR1 little-endian primitive reader
    (4-byte encapsulation header, aligned primitives).
  * :func:`parse_pointcloud2` — sensor_msgs/msg/PointCloud2 decoder returning a
    structured numpy array of the declared fields.
  * :func:`parse_vtr_pointcloud_msg` — the VTR wrapper message carrying
    ``point_cloud`` (PointCloud2 with x, y, z, normal_x, normal_y, normal_z
    fields — schema evidenced at `utils/extract_pointcloud.py:16-36`) and
    ``t_vertex_this`` (6-vector se(3) twist, `utils/extract_graph.py:13`).
  * :func:`convert_graph` — walk a pose graph's vertex topics and emit one
    ``.npz`` shard per localization frame + an ``index.json`` with max point
    counts (the converter-side equivalent of the reference's metadata.csv).

The exact VTR topic naming (`<prefix>raw_point_cloud`, `filtered_point_cloud`,
`pointmap`, `pointmap_ptr`) follows `utils/extract_graph.py:36-48`.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import sqlite3
import struct
from typing import Iterator

import numpy as np

_PC2_DTYPES = {
    1: ("int8", 1), 2: ("uint8", 1), 3: ("int16", 2), 4: ("uint16", 2),
    5: ("int32", 4), 6: ("uint32", 4), 7: ("float32", 4), 8: ("float64", 8),
}


class UnknownSchemaError(RuntimeError):
    """A recorded `topics.type` string does not match any schema this reader
    knows how to decode. Raised *instead of* guessing: the CDR layouts here are
    documented reconstructions (the vtr3 msg definitions live in unmounted
    submodules), so an unexpected type string means the bytes would be
    silently mis-parsed into garbage. The reference resolves types dynamically
    via rclpy (`mm_masking/utils/extract_pointcloud.py:16-36`
    — `get_message(type_of)`); without ROS2 the honest equivalent is an
    explicit registry + a loud refusal."""


def _type_tail(type_str: str | None) -> str:
    """Final path segment of a ROS type string ('pkg/msg/Name' → 'Name')."""
    return (type_str or "").rsplit("/", 1)[-1]


# Known type-name tails per schema. Empty string = bags recorded without type
# metadata (this repo's early synthetic bags) — decoded with the documented
# default layout.
_VERTEX_TYPES = frozenset({"", "Vertex", "VertexMsg"})
_EDGE_TYPES = frozenset({"", "Edge", "EdgeMsg"})
_PTR_TYPES = frozenset({"", "PtrMsg", "PointMapPtr", "PointmapPtr", "MapInfo"})
_VTR_CLOUD_TYPES = frozenset({"", "PointCloudMsg"})
_BARE_CLOUD_TYPES = frozenset({"PointCloud2"})


def check_schema(kind: str, known: frozenset, type_str: str | None,
                 topic: str = "?"):
    tail = _type_tail(type_str)
    if tail not in known:
        raise UnknownSchemaError(
            f"topic '{topic}' records type '{type_str}', which is not a "
            f"known {kind} schema (known tails: "
            f"{sorted(t for t in known if t)}). Refusing to decode with a "
            f"guessed layout — add the type to the registry in "
            f"mm_masking_tpu_torch/data/convert.py after verifying its CDR layout."
        )


class Rosbag2Reader:
    """Minimal rosbag2 sqlite3 reader (schema from `utils/extract_pointcloud.py`)."""

    def __init__(self, db_path: str):
        self.conn = sqlite3.connect(db_path)
        self.cursor = self.conn.cursor()
        rows = self.cursor.execute("SELECT id, name, type FROM topics").fetchall()
        self.topic_id = {name: id_ for id_, name, _ in rows}
        self.topic_type = {name: type_ for _, name, type_ in rows}

    def topics(self) -> list[str]:
        return list(self.topic_id)

    def messages(self, topic: str) -> Iterator[tuple[int, bytes]]:
        tid = self.topic_id[topic]
        for ts, data in self.cursor.execute(
            "SELECT timestamp, data FROM messages WHERE topic_id = ? "
            "ORDER BY timestamp", (tid,)
        ):
            yield ts, data

    def close(self):
        self.conn.close()


class CdrReader:
    """XCDR1 little-endian reader. The 4-byte encapsulation header
    {representation id, options} precedes the payload; alignment is relative
    to the payload start."""

    def __init__(self, buf: bytes):
        self.buf = buf
        if len(buf) < 4:
            raise ValueError(
                f"CDR blob of {len(buf)} bytes — shorter than the 4-byte "
                "encapsulation header; truncated or not a CDR payload"
            )
        rep_id = struct.unpack_from(">H", buf, 0)[0]
        if rep_id not in (0x0000, 0x0001, 0x0002, 0x0003):
            raise ValueError(f"unknown CDR representation 0x{rep_id:04x}")
        self.little = rep_id in (0x0001, 0x0003)
        self.pos = 4
        self._origin = 4

    def _align(self, size: int):
        off = (self.pos - self._origin) % size
        if off:
            self.pos += size - off

    def _prim(self, fmt: str, size: int):
        self._align(size)
        end = "<" if self.little else ">"
        val = struct.unpack_from(end + fmt, self.buf, self.pos)[0]
        self.pos += size
        return val

    def uint8(self): return self._prim("B", 1)
    def int8(self): return self._prim("b", 1)
    def uint16(self): return self._prim("H", 2)
    def int16(self): return self._prim("h", 2)
    def uint32(self): return self._prim("I", 4)
    def int32(self): return self._prim("i", 4)
    def uint64(self): return self._prim("Q", 8)
    def int64(self): return self._prim("q", 8)
    def float32(self): return self._prim("f", 4)
    def float64(self): return self._prim("d", 8)
    def boolean(self): return bool(self.uint8())

    def string(self) -> str:
        n = self.uint32()
        s = self.buf[self.pos : self.pos + n]
        self.pos += n
        return s.rstrip(b"\x00").decode("utf-8", errors="replace")

    def bytes_seq(self) -> bytes:
        n = self.uint32()
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def float64_array(self, n: int) -> np.ndarray:
        self._align(8)
        out = np.frombuffer(self.buf, dtype="<f8" if self.little else ">f8",
                            count=n, offset=self.pos)
        self.pos += 8 * n
        return out.astype(np.float64)

    def float64_seq(self) -> np.ndarray:
        n = self.uint32()
        return self.float64_array(n)


def parse_header(r: CdrReader) -> tuple[int, str]:
    """std_msgs/Header: builtin_interfaces/Time stamp {sec int32, nanosec
    uint32} + frame_id string."""
    sec = r.int32()
    nanosec = r.uint32()
    frame_id = r.string()
    return sec * 1_000_000_000 + nanosec, frame_id


def parse_pointcloud2(r: CdrReader) -> dict:
    """sensor_msgs/msg/PointCloud2 → {'stamp', 'frame_id', 'points'
    (structured array of the declared fields)}."""
    stamp, frame_id = parse_header(r)
    height = r.uint32()
    width = r.uint32()
    n_fields = r.uint32()
    fields = []
    for _ in range(n_fields):
        name = r.string()
        offset = r.uint32()
        datatype = r.uint8()
        count = r.uint32()
        fields.append((name, offset, datatype, count))
    is_bigendian = r.boolean()
    point_step = r.uint32()
    row_step = r.uint32()  # noqa: F841
    data = r.bytes_seq()
    is_dense = r.boolean()  # noqa: F841

    np_fields = {
        "names": [], "formats": [], "offsets": [], "itemsize": point_step,
    }
    for name, offset, datatype, count in fields:
        base, _ = _PC2_DTYPES[datatype]
        np_fields["names"].append(name)
        np_fields["formats"].append(base if count == 1 else (base, (count,)))
        np_fields["offsets"].append(offset)
    dtype = np.dtype(np_fields)
    if is_bigendian:
        dtype = dtype.newbyteorder(">")
    n_pts = height * width
    points = np.frombuffer(data, dtype=dtype, count=n_pts)
    return {"stamp": stamp, "frame_id": frame_id, "points": points}


def parse_vtr_pointcloud_msg(buf: bytes) -> dict:
    """VTR `PointCloudMsg`: {point_cloud: PointCloud2, t_vertex_this: {xi:
    float64[6]}} (field evidence: `utils/extract_graph.py:11-26`).

    Returns {'points' (N, 6) float32 [x y z nx ny nz], 'stamp', 'xi' (6,)}.
    """
    r = CdrReader(buf)
    pc = parse_pointcloud2(r)
    xi = r.float64_array(6)
    pts = pc["points"]
    cols = ["x", "y", "z", "normal_x", "normal_y", "normal_z"]
    arr = np.stack(
        [np.asarray(pts[c], dtype=np.float32) for c in cols], axis=-1
    )
    return {"points": arr, "stamp": pc["stamp"], "xi": np.asarray(xi)}


def parse_pointcloud_any(buf: bytes, type_str: str | None = None,
                         topic: str = "?") -> dict:
    """Type-dispatched point-cloud decode.

    * VTR wrapper types (``…/PointCloudMsg``, or untyped legacy bags) — the
      full :func:`parse_vtr_pointcloud_msg` layout with the trailing
      ``t_vertex_this`` twist.
    * bare ``sensor_msgs/msg/PointCloud2`` — the standard message with no VTR
      wrapper; ``xi`` is identity and missing normal fields decode as zeros
      (the `/vtr/filtered_point_cloud` topics of plain exports,
      `utils/extract_pointcloud.py:46-47`, are recorded this way).
    * anything else → :class:`UnknownSchemaError`.
    """
    tail = _type_tail(type_str)
    if tail in _BARE_CLOUD_TYPES:
        r = CdrReader(buf)
        pc = parse_pointcloud2(r)
        pts = pc["points"]
        cols = ["x", "y", "z", "normal_x", "normal_y", "normal_z"]
        have = pts.dtype.names or ()
        n = pts.shape[0]
        arr = np.stack(
            [
                np.asarray(pts[c], dtype=np.float32)
                if c in have
                else np.zeros(n, np.float32)
                for c in cols
            ],
            axis=-1,
        )
        return {"points": arr, "stamp": pc["stamp"], "xi": np.zeros(6)}
    check_schema("point-cloud", _VTR_CLOUD_TYPES | _BARE_CLOUD_TYPES,
                 type_str, topic)
    return parse_vtr_pointcloud_msg(buf)


def parse_localization_result(buf: bytes) -> dict:
    """VTR `LocalizationResult` message (the v1 GT-extraction path's input,
    `mm_masking/utils/extract_odo_gt.py:100-116`).

    Field layout reconstructed from the consuming scripts (the vtr3 msg
    definition lives in the unmounted submodule): ``timestamp`` (int64 ns,
    query scan), ``vertex_timestamp`` (int64 ns, map vertex),
    ``vertex_id`` (uint64), ``t_robot_vertex`` (float64[16] row-major 4×4).
    Only the first three are consumed by the reference's extractors.
    """
    r = CdrReader(buf)
    return {
        "timestamp": r.int64(),
        "vertex_timestamp": r.int64(),
        "vertex_id": r.uint64(),
        "T_robot_vertex": r.float64_array(16).reshape(4, 4),
    }


def encode_localization_result(timestamp_ns: int, vertex_timestamp_ns: int,
                               vertex_id: int, T_robot_vertex=None) -> bytes:
    """Inverse of :func:`parse_localization_result` (bag synthesis/tests)."""
    buf = bytearray(b"\x00\x01\x00\x00")
    buf += struct.pack("<qqQ", timestamp_ns, vertex_timestamp_ns, vertex_id)
    T = np.eye(4) if T_robot_vertex is None else np.asarray(T_robot_vertex)
    buf += T.astype("<f8").ravel().tobytes()
    return bytes(buf)


def se3_exp_np(xi: np.ndarray) -> np.ndarray:
    """Host-side exp map (same convention as geom.se3) for converter use."""
    rho, phi = xi[:3], xi[3:]
    theta = float(np.linalg.norm(phi))
    K = np.array(
        [[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]]
    )
    if theta < 1e-10:
        C = np.eye(3) + K
        J = np.eye(3) + 0.5 * K
    else:
        K2 = K @ K
        C = (
            np.eye(3)
            + np.sin(theta) / theta * K
            + (1 - np.cos(theta)) / theta**2 * K2
        )
        J = (
            np.eye(3)
            + (1 - np.cos(theta)) / theta**2 * K
            + (theta - np.sin(theta)) / theta**3 * K2
        )
    T = np.eye(4)
    T[:3, :3] = C
    T[:3, 3] = J @ rho
    return T


def _transformed_map_shard(map_msg: dict) -> dict:
    """Pointmap into its map-vertex frame by exp(xi); normals rotation-only
    (`utils/extract_graph.py:13-27`)."""
    T_m_v = se3_exp_np(map_msg["xi"])
    pts = map_msg["points"][:, :3] @ T_m_v[:3, :3].T + T_m_v[:3, 3]
    T_rot = se3_exp_np(np.concatenate([np.zeros(3), map_msg["xi"][3:]]))
    nrm = map_msg["points"][:, 3:6] @ T_rot[:3, :3].T
    return {
        "map_pc": np.concatenate([pts, nrm], axis=-1).astype(np.float32),
        "map_stamp": np.int64(map_msg["stamp"] // 1000),
    }


def _write_shard(out_dir: str, index: dict, shard: dict):
    name = f"frame_{int(shard['loc_stamp'])}.npz"
    np.savez_compressed(osp.join(out_dir, name), **shard)
    index["frames"].append(name)
    index["max_loc"] = max(index["max_loc"], shard["raw_pc"].shape[0])
    if "map_pc" in shard:
        index["max_map"] = max(index["max_map"], shard["map_pc"].shape[0])


def convert_graph(
    graph_dir: str,
    out_dir: str,
    msg_prefix: str = "radar_",
    limit: int = -1,
    repeat_run: int | None = None,
) -> dict:
    """Convert a VTR pose-graph rosbag2 directory into per-frame npz shards.

    When the bags carry graph structure (``vertexes``/``edges`` topics), this
    performs the reference's walk (`icp_weight_dataset.py:150-165`): iterate
    the repeat run's temporal chain from ``(repeat_run, 0)``, skip entries
    whose incoming edge is invalid, resolve each localization vertex's
    *closest teach vertex* via spatial edges, follow its ``pointmap_ptr`` to
    the map vertex, and pair the frame with *that* vertex's ``pointmap`` —
    frames under different teach vertices get different maps. Malformed
    vertices (no teach connection / missing data) are skipped with a log line,
    as are unreadable ``.db3`` files.

    Bags without graph topics fall back to flat stream pairing (raw[k] ↔
    filt[k] ↔ the file's single pointmap) — the layout simple exports use.

    Writes {raw_pc, filt_pc, map_pc(+normals), loc_stamp, map_stamp} shards +
    ``index.json`` (the metadata.csv equivalent); returns the index dict.
    """
    from mm_masking_tpu_torch.data.pose_graph import (
        INVALID_ID,
        GraphError,
        PoseGraph,
        parse_pointmap_ptr_msg,
    )

    os.makedirs(out_dir, exist_ok=True)
    graph = PoseGraph.from_dir(graph_dir)
    index = {"frames": [], "max_loc": 0, "max_map": 0}

    if graph.number_of_vertices > 0:
        run = repeat_run if repeat_run is not None else max(graph.runs())
        v_start = graph.get_vertex((run, 0))
        n_frames = 0
        for loc_v, e in graph.temporal_iterator(v_start):
            if limit > 0 and n_frames >= limit:
                break
            if e.from_id == INVALID_ID:
                continue
            try:
                teach_v = graph.closest_teach_vertex(loc_v)
                ptr_blob, ptr_type = graph.get_data_typed(
                    teach_v, "pointmap_ptr"
                )
                check_schema("pointmap_ptr", _PTR_TYPES, ptr_type,
                             "pointmap_ptr")
                map_vid = parse_pointmap_ptr_msg(ptr_blob)
                map_v = graph.get_vertex(map_vid)
                map_msg = parse_pointcloud_any(
                    *graph.get_data_typed(map_v, "pointmap"), topic="pointmap"
                )
                filt = parse_pointcloud_any(
                    *graph.get_data_typed(
                        loc_v, msg_prefix + "filtered_point_cloud"
                    ),
                    topic=msg_prefix + "filtered_point_cloud",
                )
                try:
                    raw = parse_pointcloud_any(
                        *graph.get_data_typed(
                            loc_v, msg_prefix + "raw_point_cloud"
                        ),
                        topic=msg_prefix + "raw_point_cloud",
                    )
                except GraphError:
                    raw = filt
            except GraphError as err:
                print(f"convert: skipping vertex {loc_v.id} — {err}")
                continue
            shard = {
                "raw_pc": raw["points"][:, :3],
                "filt_pc": filt["points"][:, :3],
                "loc_stamp": np.int64(filt["stamp"] // 1000),
                **_transformed_map_shard(map_msg),
            }
            _write_shard(out_dir, index, shard)
            n_frames += 1
    else:
        _convert_flat(graph_dir, out_dir, msg_prefix, limit, index)

    with open(osp.join(out_dir, "index.json"), "w") as f:
        json.dump(index, f)
    return index


def _convert_flat(graph_dir: str, out_dir: str, msg_prefix: str, limit: int,
                  index: dict):
    """Flat stream pairing for bags without vertex/edge topics."""
    db_files = sorted(
        osp.join(root, f)
        for root, _, files in os.walk(graph_dir)
        for f in files
        if f.endswith(".db3")
    )
    n_frames = 0
    for db in db_files:
        try:
            reader = Rosbag2Reader(db)
        except sqlite3.DatabaseError as e:
            print(f"convert: skipping unreadable bag {db}: {e}")
            continue
        names = reader.topics()
        raw_t = next(
            (t for t in names if t.endswith(msg_prefix + "raw_point_cloud")), None
        )
        filt_t = next(
            (t for t in names if t.endswith(msg_prefix + "filtered_point_cloud")),
            None,
        )
        map_t = next((t for t in names if t.endswith("pointmap")), None)
        if filt_t is None:
            reader.close()
            continue
        raws = list(reader.messages(raw_t)) if raw_t else []
        filts = list(reader.messages(filt_t))
        maps = list(reader.messages(map_t)) if map_t else []
        types = {
            t: reader.topic_type.get(t, "") for t in (raw_t, filt_t, map_t) if t
        }
        reader.close()
        if raws and len(raws) != len(filts):
            print(
                f"convert: {db} raw/filtered stream lengths differ "
                f"({len(raws)} vs {len(filts)}); using filtered for both"
            )
            raws = []

        map_msg = (
            parse_pointcloud_any(maps[0][1], types[map_t], topic=map_t)
            if maps else None
        )
        map_part = _transformed_map_shard(map_msg) if map_msg else {}
        for k, (ts, blob) in enumerate(filts):
            if limit > 0 and n_frames >= limit:
                break
            filt = parse_pointcloud_any(blob, types[filt_t], topic=filt_t)
            raw = (
                parse_pointcloud_any(raws[k][1], types[raw_t], topic=raw_t)
                if raws else filt
            )
            shard = {
                "raw_pc": raw["points"][:, :3],
                "filt_pc": filt["points"][:, :3],
                "loc_stamp": np.int64(filt["stamp"] // 1000),
                **map_part,
            }
            _write_shard(out_dir, index, shard)
            n_frames += 1
