"""Live scan/IMU stream transport (socket) for online SLAM.

The port's copy of the JAX package's ``dataio/stream.py``: the same wire
bytes, so a producer of either package feeds a consumer of the other.

The reference's online mode consumes live ROS topics published by another
process (``msf_loam_node.cc:464-477`` subscribes /velodyne_points + /imu).
This is the transport analog without ROS: a producer process streams
length-prefixed binary messages over TCP (or a Unix socket), and
``run_slam --listen`` consumes them with the same backlog-shedding policy
as the wall-clock bag replay (drop scans when processing falls behind,
laser_mapping.cc:159-165).

Wire format (little-endian), one frame per message:
    magic   4s   b"MSF0"
    type    u8   1=scan 2=imu 3=odom 4=end
    length  u32  payload bytes
    payload      type-specific (below)

scan: f64 time, u32 n_points, n*3 f32 xyz, n u16 ring
imu:  f64 time, 3 f32 acc, 3 f32 gyr
odom: f64 time, 3 f32 t, 4 f32 q(wxyz)
end:  empty

The consumer runs a reader thread that drains the socket into an unbounded
queue; ``messages()`` yields (msg, dropped) where a scan is flagged
``dropped`` when a NEWER scan is already waiting in the backlog — the
stream equivalent of the reference's real-time drop (a live sensor always
outruns a stalled consumer; shedding keeps latency bounded instead of
letting the queue grow).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from msf_loam_tpu_torch.dataio.npz_bag import ImuMsg, OdomMsg, ScanMsg

MAGIC = b"MSF0"
T_SCAN, T_IMU, T_ODOM, T_END = 1, 2, 3, 4
_HDR = struct.Struct("<4sBI")

Msg = Union[ScanMsg, ImuMsg, OdomMsg]


def parse_address(addr: str) -> Tuple[int, object]:
    """'host:port' -> TCP, 'unix:/path' -> Unix domain socket."""
    if addr.startswith("unix:"):
        return socket.AF_UNIX, addr[5:]
    host, _, port = addr.rpartition(":")
    return socket.AF_INET, (host or "127.0.0.1", int(port))


def _encode(msg: Msg) -> bytes:
    if isinstance(msg, ScanMsg):
        xyz = np.ascontiguousarray(msg.xyz, np.float32)
        ring = np.ascontiguousarray(msg.ring, np.uint16)
        payload = struct.pack("<dI", float(msg.time), xyz.shape[0]) \
            + xyz.tobytes() + ring.tobytes()
        t = T_SCAN
    elif isinstance(msg, ImuMsg):
        payload = struct.pack("<d3f3f", float(msg.time),
                              *np.asarray(msg.acc, np.float32),
                              *np.asarray(msg.gyr, np.float32))
        t = T_IMU
    elif isinstance(msg, OdomMsg):
        q = np.asarray(msg.q_wxyz if msg.q_wxyz is not None
                       else [1.0, 0, 0, 0], np.float32)
        payload = struct.pack("<d3f4f", float(msg.time),
                              *np.asarray(msg.t, np.float32), *q)
        t = T_ODOM
    else:
        raise TypeError(type(msg))
    return _HDR.pack(MAGIC, t, len(payload)) + payload


def _decode(t: int, payload: bytes) -> Optional[Msg]:
    if t == T_SCAN:
        time_, n = struct.unpack_from("<dI", payload)
        off = struct.calcsize("<dI")
        xyz = np.frombuffer(payload, np.float32, n * 3, off).reshape(n, 3)
        ring = np.frombuffer(payload, np.uint16, n, off + n * 12)
        return ScanMsg(time=time_, xyz=xyz.copy(),
                       ring=ring.astype(np.int32))
    if t == T_IMU:
        vals = struct.unpack("<d3f3f", payload)
        return ImuMsg(time=vals[0], acc=np.asarray(vals[1:4], np.float32),
                      gyr=np.asarray(vals[4:7], np.float32))
    if t == T_ODOM:
        vals = struct.unpack("<d3f4f", payload)
        return OdomMsg(time=vals[0], t=np.asarray(vals[1:4], np.float32),
                       q_wxyz=np.asarray(vals[4:8], np.float32))
    return None  # T_END


class StreamWriter:
    """Producer side: connect and push messages (the live-sensor analog)."""

    def __init__(self, addr: str, connect_timeout: float = 30.0):
        import time as _time

        fam, target = parse_address(addr)
        deadline = _time.perf_counter() + connect_timeout
        while True:
            self.sock = socket.socket(fam, socket.SOCK_STREAM)
            self.sock.settimeout(max(0.5, connect_timeout))
            try:
                self.sock.connect(target)
                break
            except (ConnectionRefusedError, FileNotFoundError):
                # consumer not listening yet — retry until the deadline
                self.sock.close()
                if _time.perf_counter() > deadline:
                    raise
                _time.sleep(0.2)
        self.sock.settimeout(None)

    def send(self, msg: Msg) -> None:
        self.sock.sendall(_encode(msg))

    def close(self) -> None:
        try:
            self.sock.sendall(_HDR.pack(MAGIC, T_END, 0))
        except OSError:
            pass
        self.sock.close()


class StreamServer:
    """Consumer side: accept ONE producer and iterate its messages with
    backlog shedding on scans."""

    def __init__(self, addr: str, accept_timeout: float = 60.0):
        fam, target = parse_address(addr)
        self.listener = socket.socket(fam, socket.SOCK_STREAM)
        if fam == socket.AF_INET:
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(target)
        self.listener.listen(1)
        self.listener.settimeout(accept_timeout)
        self._q: "queue.Queue[Optional[Msg]]" = queue.Queue()
        self._conn: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        a = self.listener.getsockname()
        if isinstance(a, tuple):
            return f"{a[0]}:{a[1]}"
        return f"unix:{a}"

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("producer hung up mid-message")
            buf += chunk
        return buf

    def _reader(self) -> None:
        try:
            while True:
                hdr = self._read_exact(_HDR.size)
                magic, t, length = _HDR.unpack(hdr)
                if magic != MAGIC:
                    raise ConnectionError(f"bad magic {magic!r}")
                payload = self._read_exact(length) if length else b""
                if t == T_END:
                    break
                self._q.put(_decode(t, payload))
        except (ConnectionError, OSError):
            pass  # producer died: treat as end-of-stream
        finally:
            self._q.put(None)

    def messages(self, wait_eof: bool = False) -> Iterator[Tuple[Msg, bool]]:
        """Accept the producer and yield (msg, dropped). A scan is dropped
        (yielded with dropped=True, so the caller can count it) when the
        backlog already holds a newer scan — process only the freshest.

        ``wait_eof`` blocks until the producer finishes before yielding —
        a deterministic maximum-backlog drain (tests use it to pin the
        shedding policy without racing the reader thread)."""
        self._conn, _ = self.listener.accept()
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()
        if wait_eof:
            self._thread.join()
        pending: list = []
        done = False
        while not done or pending:
            # drain whatever is available without blocking
            while True:
                try:
                    m = self._q.get_nowait()
                except queue.Empty:
                    break
                if m is None:
                    done = True
                    break
                pending.append(m)
            if not pending:
                if done:
                    break
                m = self._q.get()           # block for the next message
                if m is None:
                    break
                pending.append(m)
                continue
            # shed stale scans: keep IMU/odom (cheap, needed for fusion),
            # drop every scan except the newest one in the backlog
            n_scans = sum(isinstance(m, ScanMsg) for m in pending)
            seen = 0
            batch, pending = pending, []
            for m in batch:
                if isinstance(m, ScanMsg):
                    seen += 1
                    yield m, seen < n_scans
                else:
                    yield m, False

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
        self.listener.close()


def stream_bag(bag, addr: str, speed: float = 1.0,
               realtime: bool = True) -> int:
    """Producer main: push a Bag's messages to ``addr``, wall-clock paced
    (a live sensor emits at its own rate regardless of the consumer)."""
    import time as _time

    w = StreamWriter(addr)
    n = 0
    t_wall0 = None
    t_msg0 = None
    try:
        for msg in bag.replay():
            if realtime:
                if t_wall0 is None:
                    t_wall0, t_msg0 = _time.perf_counter(), msg.time
                else:
                    lag = (msg.time - t_msg0) / speed - \
                        (_time.perf_counter() - t_wall0)
                    if lag > 0:
                        _time.sleep(lag)
            w.send(msg)
            n += 1
    finally:
        w.close()
    return n
