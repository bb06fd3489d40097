"""Robot-channel transports: ZeroMQ (ZMTP 3.0) and ROS2-style topics.

Counterpart of ``hvs_tpu/inference/transports.py``, host-only and copied
unchanged: the bytes on the wire are the reference's.

The reference lists tcp/udp/ros/zmq as robot protocols but its ros/zmq paths
are import-guarded fallbacks that silently degrade to TCP when the libraries
are absent (reference: src/inference/robot_interface.py:176-223). This module
implements both for real:

  * :class:`ZMTPPairSocket` — a from-scratch implementation of the ZMTP 3.0
    wire protocol (greeting, NULL-security handshake, short/long message
    framing) for PAIR sockets over TCP. It interoperates with libzmq peers
    (``zmq.PAIR``) and needs no pyzmq — this environment has none, and the
    robot side often runs a minimal libzmq. Spec: rfc.zeromq.org/spec/23.
  * :class:`ROS2Topics` — topic pub/sub with ROS2 semantics (named topics,
    QoS history depth with drop-oldest). Uses ``rclpy`` when importable
    (std_msgs/String JSON payloads); otherwise a documented lightweight
    fallback carries the same topic frames over UDP datagrams
    (``HVS2 | topic | payload``) so the transport stays wire-testable and
    robots without a ROS2 stack can still subscribe.

Both are host-side pure Python (no device work), matching the reference's
layering.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# ZMTP 3.0 (ZeroMQ wire protocol) — PAIR over TCP.
# ---------------------------------------------------------------------------

ZMTP_SIGNATURE = b"\xff" + b"\x00" * 8 + b"\x7f"
ZMTP_VERSION = bytes([3, 0])
ZMTP_MECHANISM = b"NULL" + b"\x00" * 16  # 20 bytes, zero padded
_FLAG_MORE = 0x01
_FLAG_LONG = 0x02
_FLAG_COMMAND = 0x04


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed during ZMTP exchange")
        buf += chunk
    return buf


def _encode_metadata(props: Dict[str, bytes]) -> bytes:
    out = b""
    for name, value in props.items():
        nb = name.encode()
        out += bytes([len(nb)]) + nb + struct.pack(">I", len(value)) + value
    return out


def _decode_metadata(body: bytes) -> Dict[str, bytes]:
    props: Dict[str, bytes] = {}
    i = 0
    while i < len(body):
        nlen = body[i]
        name = body[i + 1 : i + 1 + nlen].decode()
        i += 1 + nlen
        (vlen,) = struct.unpack(">I", body[i : i + 4])
        props[name] = body[i + 4 : i + 4 + vlen]
        i += 4 + vlen
    return props


class ZMTPPairSocket:
    """Minimal ZMTP 3.0 PAIR socket (NULL security) over TCP.

    Implements exactly the subset a libzmq ``zmq.PAIR`` peer speaks by
    default: the 64-byte greeting, the READY command handshake carrying
    ``Socket-Type``, and short/long message frames. Multipart messages are
    supported on receive (frames are concatenated) and sent as single parts.
    """

    def __init__(self, sock: Optional[socket.socket] = None):
        self._sock = sock
        self.peer_metadata: Dict[str, bytes] = {}

    # -------------------- connection setup --------------------
    @classmethod
    def connect(cls, host: str, port: int, timeout: float = 2.0) -> "ZMTPPairSocket":
        s = socket.create_connection((host, port), timeout=timeout)
        self = cls(s)
        self._handshake()
        return self

    @classmethod
    def listener(cls, host: str = "127.0.0.1", port: int = 0) -> Tuple[socket.socket, int]:
        """Bind a TCP listener; returns (server_socket, bound_port)."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        return srv, srv.getsockname()[1]

    @classmethod
    def accept(cls, server_socket: socket.socket, timeout: float = 5.0) -> "ZMTPPairSocket":
        server_socket.settimeout(timeout)
        conn, _ = server_socket.accept()
        self = cls(conn)
        self._handshake()
        return self

    def _handshake(self) -> None:
        """Greeting + NULL-security READY exchange (ZMTP 3.0 §connection)."""
        s = self._sock
        greeting = (
            ZMTP_SIGNATURE + ZMTP_VERSION + ZMTP_MECHANISM
            + b"\x00"  # as-server (NULL: always 0)
            + b"\x00" * 31  # filler
        )
        s.sendall(greeting)
        peer = _recv_exact(s, 64)
        if peer[0] != 0xFF or peer[9] != 0x7F:
            raise ConnectionError("not a ZMTP peer (bad signature)")
        if peer[10] < 3:
            raise ConnectionError(f"unsupported ZMTP version {peer[10]}")
        mechanism = peer[12:32].rstrip(b"\x00")
        if mechanism != b"NULL":
            raise ConnectionError(f"unsupported mechanism {mechanism!r}")
        # READY command with Socket-Type metadata.
        body = b"\x05READY" + _encode_metadata({"Socket-Type": b"PAIR"})
        self._send_frame(body, command=True)
        cmd = self._recv_command()
        if not cmd.startswith(b"\x05READY"):
            raise ConnectionError("peer did not send READY")
        self.peer_metadata = _decode_metadata(cmd[6:])
        peer_type = self.peer_metadata.get("Socket-Type", b"")
        if peer_type and peer_type != b"PAIR":
            raise ConnectionError(f"incompatible socket type {peer_type!r}")

    # -------------------- framing --------------------
    def _send_frame(self, body: bytes, more: bool = False, command: bool = False) -> None:
        flags = (_FLAG_MORE if more else 0) | (_FLAG_COMMAND if command else 0)
        if len(body) > 255:
            self._sock.sendall(
                bytes([flags | _FLAG_LONG]) + struct.pack(">Q", len(body)) + body
            )
        else:
            self._sock.sendall(bytes([flags, len(body)]) + body)

    def _recv_frame(self) -> Tuple[int, bytes]:
        flags = _recv_exact(self._sock, 1)[0]
        if flags & _FLAG_LONG:
            (size,) = struct.unpack(">Q", _recv_exact(self._sock, 8))
        else:
            size = _recv_exact(self._sock, 1)[0]
        if size > 64 * 2**20:
            raise ConnectionError(f"frame too large: {size}")
        return flags, _recv_exact(self._sock, size)

    def _recv_command(self) -> bytes:
        while True:
            flags, body = self._recv_frame()
            if flags & _FLAG_COMMAND:
                return body

    # -------------------- public API --------------------
    def send(self, payload: bytes) -> None:
        self._send_frame(payload)

    def recv(self) -> bytes:
        """Receive one message (multipart frames concatenated); commands
        (e.g. PING) are skipped."""
        parts: List[bytes] = []
        while True:
            flags, body = self._recv_frame()
            if flags & _FLAG_COMMAND:
                continue
            parts.append(body)
            if not flags & _FLAG_MORE:
                return b"".join(parts)

    def settimeout(self, t: Optional[float]) -> None:
        self._sock.settimeout(t)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# ROS2-style topics.
# ---------------------------------------------------------------------------

_ROS2_MAGIC = b"HVS2"


class ROS2Topics:
    """Topic pub/sub with ROS2 semantics; rclpy when available, UDP fallback.

    With ``rclpy`` importable, publishers are real ROS2 ``std_msgs/String``
    publishers carrying JSON payloads (QoS history depth honored). Without it
    — this environment and many robot simulators — the same topics ride UDP
    datagrams framed ``HVS2 | u8 topic_len | topic | payload`` so subscribers
    remain wire-level testable and protocol-documented.
    """

    def __init__(self, node_name: str = "hvs_tpu",
                 host: str = "127.0.0.1", port: int = 9020,
                 qos_depth: int = 10):
        self.host, self.port = host, port
        self.qos_depth = qos_depth
        self._rclpy = None
        self._node = None
        self._publishers: Dict[str, Any] = {}
        try:  # pragma: no cover - rclpy not present in CI
            import rclpy
            from rclpy.node import Node  # noqa: F401

            if not rclpy.ok():
                rclpy.init()
            self._rclpy = rclpy
            self._node = rclpy.create_node(node_name)
        except Exception:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    @property
    def using_rclpy(self) -> bool:
        return self._node is not None

    # -------------------- publish --------------------
    def publish(self, topic: str, payload: Dict[str, Any]) -> bool:
        data = json.dumps(payload).encode()
        if self._node is not None:  # pragma: no cover - rclpy path
            from std_msgs.msg import String

            if topic not in self._publishers:
                self._publishers[topic] = self._node.create_publisher(
                    String, topic, self.qos_depth
                )
            msg = String()
            msg.data = data.decode()
            self._publishers[topic].publish(msg)
            return True
        tb = topic.encode()
        if len(tb) > 255:
            raise ValueError("topic too long")
        frame = _ROS2_MAGIC + bytes([len(tb)]) + tb + data
        try:
            self._sock.sendto(frame, (self.host, self.port))
            return True
        except OSError:
            return False

    def close(self) -> None:
        if self._node is not None:  # pragma: no cover
            self._node.destroy_node()
        else:
            self._sock.close()


class ROS2Subscriber:
    """Fallback-side subscriber: binds the UDP port, dispatches frames to
    per-topic bounded queues (QoS history depth, drop-oldest — ROS2
    KEEP_LAST semantics)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 qos_depth: int = 10):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self.qos_depth = qos_depth
        self._queues: Dict[str, "queue.Queue"] = {}
        self._callbacks: Dict[str, Callable[[Dict[str, Any]], None]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def subscribe(self, topic: str,
                  callback: Optional[Callable[[Dict[str, Any]], None]] = None
                  ) -> "queue.Queue":
        q: "queue.Queue" = queue.Queue(maxsize=self.qos_depth)
        self._queues[topic] = q
        if callback is not None:
            self._callbacks[topic] = callback
        return q

    def start(self) -> "ROS2Subscriber":
        def loop():
            self._sock.settimeout(0.2)
            while not self._stop.is_set():
                try:
                    frame, _ = self._sock.recvfrom(64 * 1024)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not frame.startswith(_ROS2_MAGIC):
                    continue
                tlen = frame[4]
                topic = frame[5 : 5 + tlen].decode()
                try:
                    payload = json.loads(frame[5 + tlen :])
                except json.JSONDecodeError:
                    continue
                q = self._queues.get(topic)
                if q is not None:
                    if q.full():
                        try:
                            q.get_nowait()  # KEEP_LAST: drop oldest
                        except queue.Empty:
                            pass
                    q.put(payload)
                cb = self._callbacks.get(topic)
                if cb is not None:
                    cb(payload)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self._sock.close()
