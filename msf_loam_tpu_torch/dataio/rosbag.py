"""Pure-Python ROS1 bag (format 2.0) reader and writer, no ROS install.

The port's copy of the JAX package's ``dataio/rosbag.py`` (same bytes in,
same messages out; the writer emits the same files byte for byte). The
reference's primary input is a ROS v1 ``.bag`` replayed offline, carrying
``/velodyne_points`` (sensor_msgs/PointCloud2), ``/imu``
(sensor_msgs/Imu) and ``/odometry_gt`` (nav_msgs/Odometry). This module
parses that subset of the rosbag 2.0 container and of ROS1 message
serialization, and ``bag_to_npz`` converts a bag to the engine's npz bag
(:mod:`msf_loam_tpu_torch.dataio.npz_bag`).

Container format (http://wiki.ros.org/Bags/Format/2.0):
  ``#ROSBAG V2.0\n`` then length-prefixed records
  ``<hlen u32><header><dlen u32><data>`` where header is a sequence of
  ``<flen u32>name=value`` fields. Record ops: 0x03 bag header, 0x05 chunk
  (compression none|bz2, data = nested records), 0x07 connection,
  0x02 message data, 0x04 index data, 0x06 chunk info.

The reader walks records sequentially (no index required: truncated or
index-less bags still replay up to their last whole chunk), inflates
chunks, and yields typed messages for the three supported types. The
writer emits chunked bags (bag header, chunks, index and chunk-info
records) that this reader and stock ``rosbag`` accept.
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from msf_loam_tpu_torch.dataio.npz_bag import BagWriter, ImuMsg, OdomMsg, ScanMsg

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

POINTFIELD_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2",
                     5: "i4", 6: "u4", 7: "f4", 8: "f8"}


# ---------------------------------------------------------------------------
# low-level record framing
# ---------------------------------------------------------------------------

def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = _U32.unpack_from(buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1:]
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = _U32.unpack_from(buf, off)
        off += 4
        if off + hlen + 4 > n:
            return  # truncated tail — stop cleanly like rosbag reindex would
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = _U32.unpack_from(buf, off)
        off += 4
        if off + dlen > n:
            return
        yield header, buf[off:off + dlen]
        off += dlen


def _ros_time(raw: bytes) -> float:
    sec, nsec = struct.unpack("<II", raw)
    return sec + nsec * 1e-9


# ---------------------------------------------------------------------------
# ROS1 message deserialization (little-endian, no ROS)
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        (v,) = _U32.unpack_from(self.buf, self.off)
        self.off += 4
        return v

    def f64(self, n: int = 1) -> np.ndarray:
        v = np.frombuffer(self.buf, "<f8", count=n, offset=self.off)
        self.off += 8 * n
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s.decode("utf-8", "replace")

    def raw(self, n: int) -> bytes:
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def header_stamp(self) -> float:
        self.u32()                   # seq
        sec, nsec = self.u32(), self.u32()
        self.string()                # frame_id
        return sec + nsec * 1e-9


def parse_imu(data: bytes) -> ImuMsg:
    """sensor_msgs/Imu -> ImuMsg (acc, gyr; orientation ignored like the
    reference, msf_loam_node.cc:391-400 uses only acc/gyr)."""
    c = _Cursor(data)
    t = c.header_stamp()
    c.f64(4)                          # orientation (x,y,z,w)
    c.f64(9)
    gyr = c.f64(3).copy()
    c.f64(9)
    acc = c.f64(3).copy()
    c.f64(9)
    return ImuMsg(time=t, acc=acc, gyr=gyr)


def parse_odometry(data: bytes) -> OdomMsg:
    """nav_msgs/Odometry -> OdomMsg (pose only; wxyz quaternion order)."""
    c = _Cursor(data)
    t = c.header_stamp()
    c.string()                        # child_frame_id
    pos = c.f64(3).copy()
    qx, qy, qz, qw = c.f64(4)
    return OdomMsg(time=t, t=pos, q_wxyz=np.array([qw, qx, qy, qz]))


class PointCloud2:
    """Decoded sensor_msgs/PointCloud2: structured-array view over the
    raw buffer plus the named fields the SLAM ingest needs."""

    def __init__(self, data: bytes):
        c = _Cursor(data)
        self.time = c.header_stamp()
        self.height = c.u32()
        self.width = c.u32()
        n_fields = c.u32()
        self.fields: List[Tuple[str, int, int, int]] = []
        for _ in range(n_fields):
            name = c.string()
            offset = c.u32()
            datatype = c.u8()
            count = c.u32()
            self.fields.append((name, offset, datatype, count))
        self.is_bigendian = bool(c.u8())
        self.point_step = c.u32()
        self.row_step = c.u32()
        nbytes = c.u32()
        self._raw = c.raw(nbytes)
        self.is_dense = bool(c.u8())

    def field(self, name: str) -> Optional[np.ndarray]:
        """(N,) array for a named field, or None if absent."""
        for fname, offset, datatype, _count in self.fields:
            if fname == name:
                endian = ">" if self.is_bigendian else "<"
                dt = np.dtype({"names": [name],
                               "formats": [endian + POINTFIELD_DTYPES[datatype]],
                               "offsets": [offset],
                               "itemsize": self.point_step})
                n = self.height * self.width
                arr = np.frombuffer(self._raw, dtype=dt, count=n)
                return arr[name].copy()
        return None

    def to_scan(self) -> ScanMsg:
        """xyz (+ring if present) like the reference's pcl::fromROSMsg over
        PointXYZIRT (common.h:44-62). Missing ring -> zeros."""
        xs, ys, zs = self.field("x"), self.field("y"), self.field("z")
        xyz = np.stack([xs, ys, zs], axis=1).astype(np.float32)
        ring = self.field("ring")
        ring = (np.zeros(len(xyz), np.int32) if ring is None
                else ring.astype(np.int32))
        return ScanMsg(time=self.time, xyz=xyz, ring=ring)


# ---------------------------------------------------------------------------
# bag reading
# ---------------------------------------------------------------------------

MAGIC = b"#ROSBAG V2.0\n"

RosMsg = Union[ScanMsg, ImuMsg, OdomMsg]

_PARSERS = {
    "sensor_msgs/PointCloud2": lambda b: PointCloud2(b).to_scan(),
    "sensor_msgs/Imu": parse_imu,
    "nav_msgs/Odometry": parse_odometry,
}


def read_messages(path: str, topics: Optional[List[str]] = None,
                  raw: bool = False
                  ) -> Iterator[Tuple[str, float, RosMsg]]:
    """Yield (topic, record_time, parsed_msg) in file order for the three
    supported message types (others are skipped silently). With
    ``raw=True`` yield the serialized message bytes instead of parsing
    (field-level inspection, e.g. dataio/nsh_bag.validate_bag)."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"not a ROS bag v2.0: {path!r} starts {magic!r}")
        buf = f.read()

    conns: Dict[int, Tuple[str, str]] = {}   # conn id -> (topic, type)

    def handle(records) -> Iterator[Tuple[str, float, RosMsg]]:
        for header, data in records:
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                (cid,) = _U32.unpack(header[b"conn"])
                info = _parse_header(data)
                topic = header.get(b"topic", info.get(b"topic", b"")).decode()
                mtype = info.get(b"type", b"").decode()
                conns[cid] = (topic, mtype)
            elif op == OP_CHUNK:
                comp = header.get(b"compression", b"none").decode()
                if comp == "none":
                    inner = data
                elif comp == "bz2":
                    try:
                        inner = bz2.decompress(data)
                    except OSError:
                        # torn write / truncated download: stop at the
                        # last whole chunk, like a rosbag reindex would
                        import warnings
                        warnings.warn(f"corrupt bz2 chunk in {path!r}; "
                                      "stopping at last intact chunk")
                        return
                else:
                    raise ValueError(f"unsupported chunk compression {comp!r}"
                                     " (none|bz2 supported; lz4 requires the"
                                     " lz4 package)")
                yield from handle(_iter_records(inner))
            elif op == OP_MSG:
                (cid,) = _U32.unpack(header[b"conn"])
                topic, mtype = conns.get(cid, ("", ""))
                if topics is not None and topic not in topics:
                    continue
                parser = _PARSERS.get(mtype)
                if parser is None:
                    continue
                t_rec = _ros_time(header[b"time"])
                yield topic, t_rec, (data if raw else parser(data))
            # OP_BAG_HEADER / OP_INDEX / OP_CHUNK_INFO: skip

    yield from handle(_iter_records(buf))


def bag_to_npz(bag_path: str, out_path: str,
               cloud_topic: str = "/velodyne_points",
               imu_topic: str = "/imu",
               odom_topic: str = "/odometry_gt",
               latency: float = 0.0) -> Dict[str, int]:
    """Convert a ROS bag to the native npz-bag. ``latency`` re-stamps scan
    headers with a simulated sensor latency (the reference's 20 ms).
    Returns per-stream message counts."""
    w = BagWriter()
    counts = {"scan": 0, "imu": 0, "odom": 0}
    for topic, _t_rec, msg in read_messages(
            bag_path, topics=[cloud_topic, imu_topic, odom_topic]):
        if topic == cloud_topic and isinstance(msg, ScanMsg):
            w.add_scan(msg.time + latency, msg.xyz, msg.ring)
            counts["scan"] += 1
        elif topic == imu_topic and isinstance(msg, ImuMsg):
            w.add_imu(msg.time, msg.acc, msg.gyr)
            counts["imu"] += 1
        elif topic == odom_topic and isinstance(msg, OdomMsg):
            w.add_odom(msg.time, msg.t, msg.q_wxyz)
            counts["odom"] += 1
    w.save(out_path)
    return counts


# ---------------------------------------------------------------------------
# bag writing (round-trip fixture + ROS-ecosystem export)
# ---------------------------------------------------------------------------

def _field(name: bytes, value: bytes) -> bytes:
    body = name + b"=" + value
    return _U32.pack(len(body)) + body


def _record(fields: List[Tuple[bytes, bytes]], data: bytes) -> bytes:
    header = b"".join(_field(k, v) for k, v in fields)
    return _U32.pack(len(header)) + header + _U32.pack(len(data)) + data


def _time_bytes(t: float) -> bytes:
    sec = int(t)
    nsec = int(round((t - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec, nsec = sec + 1, nsec - 1_000_000_000
    return struct.pack("<II", sec, nsec)


def _ser_header(t: float, seq: int = 0, frame_id: bytes = b"") -> bytes:
    return (_U32.pack(seq) + _time_bytes(t)
            + _U32.pack(len(frame_id)) + frame_id)


def serialize_imu(msg: ImuMsg) -> bytes:
    zeros9 = np.zeros(9, "<f8").tobytes()
    return (_ser_header(msg.time)
            + np.array([0, 0, 0, 1], "<f8").tobytes() + zeros9
            + np.asarray(msg.gyr, "<f8").tobytes() + zeros9
            + np.asarray(msg.acc, "<f8").tobytes() + zeros9)


def serialize_odometry(msg: OdomMsg, frame_id: bytes = b"map") -> bytes:
    qw, qx, qy, qz = np.asarray(msg.q_wxyz, np.float64)
    cov36 = np.zeros(36, "<f8").tobytes()
    return (_ser_header(msg.time, frame_id=frame_id)
            + _U32.pack(0)                      # child_frame_id ""
            + np.asarray(msg.t, "<f8").tobytes()
            + np.array([qx, qy, qz, qw], "<f8").tobytes() + cov36
            + np.zeros(6, "<f8").tobytes() + cov36)


def serialize_pointcloud2(msg: ScanMsg, rel_time: Optional[np.ndarray] = None
                          ) -> bytes:
    """PointXYZIRT-style layout: x,y,z f32 @0/4/8, intensity f32 @12,
    ring u16 @16, time f32 @18 — the velodyne point layout the reference
    ingests (common.h:52-62)."""
    n = len(msg.xyz)
    point_step = 22
    buf = np.zeros((n, point_step), np.uint8)
    buf[:, 0:12] = np.ascontiguousarray(
        msg.xyz.astype("<f4")).view(np.uint8).reshape(n, 12)
    buf[:, 16:18] = np.ascontiguousarray(
        msg.ring.astype("<u2")).view(np.uint8).reshape(n, 2)
    if rel_time is not None:
        buf[:, 18:22] = np.ascontiguousarray(
            rel_time.astype("<f4")).view(np.uint8).reshape(n, 4)
    fields = [(b"x", 0, 7), (b"y", 4, 7), (b"z", 8, 7), (b"intensity", 12, 7),
              (b"ring", 16, 4), (b"time", 18, 7)]
    fbuf = b"".join(
        _U32.pack(len(name)) + name + _U32.pack(off) + bytes([dt])
        + _U32.pack(1) for name, off, dt in fields)
    data = buf.tobytes()
    return (_ser_header(msg.time, frame_id=b"velodyne")
            + _U32.pack(1) + _U32.pack(n)          # height=1, width=n
            + _U32.pack(len(fields)) + fbuf
            + b"\x00"                              # is_bigendian
            + _U32.pack(point_step) + _U32.pack(point_step * n)
            + _U32.pack(len(data)) + data
            + b"\x01")                             # is_dense


_TYPE_INFO = {
    "sensor_msgs/PointCloud2": b"1158d486dd51d683ce2f1be655c3c181",
    "sensor_msgs/Imu": b"6a62c6daae103f4ff57a132d6f95cec2",
    "nav_msgs/Odometry": b"cd5e73d190d741a2f92e81eda573aca7",
}


class RosbagWriter:
    """Spec-correct ROS1 bag writer for the three SLAM streams.

    Messages buffer in memory and land in one or more chunks (optionally
    bz2 — ``chunk_msgs`` splits into real multi-chunk bags like rosbag's
    768 KB chunking) with proper connection / index / chunk-info records
    at save()."""

    def __init__(self) -> None:
        self._msgs: List[Tuple[float, int, bytes]] = []   # (t, conn, bytes)
        self._conns: List[Tuple[str, str]] = []           # (topic, type)
        self._topic_conn: Dict[str, int] = {}

    def _conn_id(self, topic: str, mtype: str) -> int:
        if topic not in self._topic_conn:
            self._topic_conn[topic] = len(self._conns)
            self._conns.append((topic, mtype))
        return self._topic_conn[topic]

    def add_scan(self, msg: ScanMsg, topic: str = "/velodyne_points",
                 rel_time: Optional[np.ndarray] = None) -> None:
        cid = self._conn_id(topic, "sensor_msgs/PointCloud2")
        self._msgs.append((msg.time, cid, serialize_pointcloud2(msg, rel_time)))

    def add_imu(self, msg: ImuMsg, topic: str = "/imu") -> None:
        cid = self._conn_id(topic, "sensor_msgs/Imu")
        self._msgs.append((msg.time, cid, serialize_imu(msg)))

    def add_odom(self, msg: OdomMsg, topic: str = "/odometry_gt") -> None:
        cid = self._conn_id(topic, "nav_msgs/Odometry")
        self._msgs.append((msg.time, cid, serialize_odometry(msg)))

    def save(self, path: str, compression: str = "none",
             chunk_msgs: int = 0, sort: bool = True) -> None:
        """Write the bag. ``chunk_msgs`` > 0 splits messages into chunks of
        that many (real bags are multi-chunk; 0 = single chunk).
        ``sort=False`` preserves insertion order — used by robustness
        fixtures to write genuinely out-of-order bags."""
        msgs = sorted(self._msgs, key=lambda m: m[0]) if sort \
            else list(self._msgs)

        def conn_record(cid: int) -> bytes:
            topic, mtype = self._conns[cid]
            tb = topic.encode()
            info = (_field(b"topic", tb) + _field(b"type", mtype.encode())
                    + _field(b"md5sum", _TYPE_INFO[mtype])
                    + _field(b"message_definition", b""))
            return _record([(b"op", bytes([OP_CONNECTION])),
                            (b"conn", _U32.pack(cid)), (b"topic", tb)], info)

        n_per = chunk_msgs if chunk_msgs > 0 else max(1, len(msgs))
        groups = [msgs[i:i + n_per] for i in range(0, len(msgs), n_per)] \
            or [[]]

        out = bytearray()
        out += MAGIC
        # bag header record (padded to 4096-byte data like rosbag)
        bh_fields = [(b"op", bytes([OP_BAG_HEADER])),
                     (b"index_pos", _U64.pack(0)),
                     (b"conn_count", _U32.pack(len(self._conns))),
                     (b"chunk_count", _U32.pack(len(groups)))]
        bh_header = b"".join(_field(k, v) for k, v in bh_fields)
        pad = max(0, 4096 - len(bh_header) - 8)
        out += (_U32.pack(len(bh_header)) + bh_header
                + _U32.pack(pad) + b" " * pad)

        chunk_infos = []
        for gi, group in enumerate(groups):
            # connection records ride in the first chunk (rosbag layout);
            # a bytearray grows in place (bytes += bytes copies the whole
            # chunk a message: minutes for a 50 MB single-chunk bag)
            chunk_body = bytearray() if gi else bytearray(b"".join(
                conn_record(c) for c in range(len(self._conns))))
            index_pos_in_chunk: Dict[int, List[Tuple[float, int]]] = {}
            for t, cid, data in group:
                index_pos_in_chunk.setdefault(cid, []).append(
                    (t, len(chunk_body)))
                chunk_body += _record([(b"op", bytes([OP_MSG])),
                                       (b"conn", _U32.pack(cid)),
                                       (b"time", _time_bytes(t))], data)
            chunk_body = bytes(chunk_body)
            payload = bz2.compress(chunk_body) if compression == "bz2" \
                else chunk_body
            chunk_pos = len(out)
            out += _record([(b"op", bytes([OP_CHUNK])),
                            (b"compression", compression.encode()),
                            (b"size", _U32.pack(len(chunk_body)))], payload)
            # index data records after each chunk (one per connection)
            for cid, entries in index_pos_in_chunk.items():
                data = b"".join(_time_bytes(t) + _U32.pack(off)
                                for t, off in entries)
                out += _record([(b"op", bytes([OP_INDEX])),
                                (b"ver", _U32.pack(1)),
                                (b"conn", _U32.pack(cid)),
                                (b"count", _U32.pack(len(entries)))], data)
            ts = [t for t, _, _ in group] or [0.0]
            chunk_infos.append((chunk_pos, min(ts), max(ts),
                                index_pos_in_chunk))

        index_pos = len(out)
        for chunk_pos, t0, t1, idx in chunk_infos:
            ci_data = b"".join(_U32.pack(cid) + _U32.pack(len(e))
                               for cid, e in idx.items())
            out += _record([(b"op", bytes([OP_CHUNK_INFO])),
                            (b"ver", _U32.pack(1)),
                            (b"chunk_pos", _U64.pack(chunk_pos)),
                            (b"start_time", _time_bytes(t0)),
                            (b"end_time", _time_bytes(t1)),
                            (b"count", _U32.pack(len(idx)))], ci_data)
        # backpatch index_pos in the bag header (chunk-info section start)
        blob = bytes(out)
        ip_field = _field(b"index_pos", _U64.pack(0))
        fixed = blob.replace(ip_field,
                             _field(b"index_pos", _U64.pack(index_pos)), 1)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(fixed)
        os.replace(tmp, path)
