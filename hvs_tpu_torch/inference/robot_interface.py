"""Robot command interface: safety-gated, rate-limited command channel.

Counterpart of ``hvs_tpu/inference/robot_interface.py``, host-only and
copied unchanged (the bytes on the wire are the reference's):

  * :class:`RobotConfig` / :class:`DetectionCommand` / :class:`RobotCommand` —
    typed configs and messages (reference :35-111).
  * :class:`RobotCommunication` — length-prefixed JSON over TCP or UDP
    (reference protocol :380-408,604-636), heartbeat thread (:638-675),
    rate-limited command queue with safety gating (:530-567), emergency stop
    (:517-528,743-774).
  * :class:`SafetyMonitor` — obstacle extraction from detections with
    per-class radii (:820-855), linear trajectory prediction + collision check
    against safety/emergency distances (:857-933).
  * :class:`CommandHandler` — named command registry (move/rotate/stop/follow/
    avoid, :954-1088).

All host-side Python — no device work here; conceptually portable from the
reference but written fresh for this framework's Detections type.
"""

from __future__ import annotations

import enum
import json
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class Protocol(str, enum.Enum):
    """Wire protocols (reference enum: robot_interface.py:35-63 lists
    tcp/udp/ros/zmq but only implements the first two — its ros/zmq paths
    silently fall back to TCP on ImportError, :192-223). Here all four are
    real: ZMQ speaks the ZMTP 3.0 wire protocol directly (no pyzmq needed,
    interoperates with libzmq PAIR peers) and ROS2 uses rclpy when present
    with a documented UDP topic-frame fallback
    (:mod:`hvs_tpu_torch.inference.transports`)."""

    TCP = "tcp"
    UDP = "udp"
    ROS2 = "ros2"
    ZMQ = "zmq"


@dataclass
class RobotConfig:
    """(reference: robot_interface.py:35-63)"""

    host: str = "127.0.0.1"
    port: int = 9000
    protocol: Protocol = Protocol.TCP
    max_linear_velocity: float = 0.5  # m/s
    max_angular_velocity: float = 1.0  # rad/s
    safety_distance_m: float = 1.0
    emergency_distance_m: float = 0.4
    command_rate_hz: float = 10.0
    heartbeat_interval_s: float = 1.0
    connect_timeout_s: float = 2.0
    ros2_topic: str = "/hvs/commands"  # command topic (ros2 protocol)
    ros2_qos_depth: int = 10


@dataclass
class DetectionCommand:
    """A detection-derived command suggestion (reference :90-100)."""

    action: str
    target_class: str
    confidence: float
    bearing_rad: float
    distance_m: float


@dataclass
class RobotCommand:
    """Wire-level robot command (reference :101-111)."""

    command: str
    linear_velocity: float = 0.0
    angular_velocity: float = 0.0
    params: Dict[str, Any] = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)

    def to_json(self) -> Dict[str, Any]:
        return {
            "command": self.command,
            "linear_velocity": self.linear_velocity,
            "angular_velocity": self.angular_velocity,
            "params": self.params,
            "timestamp": self.timestamp,
        }


HEADER = struct.Struct(">I")


def encode_message(payload: Dict[str, Any]) -> bytes:
    """Length-prefixed JSON (reference protocol :380-408)."""
    body = json.dumps(payload).encode()
    return HEADER.pack(len(body)) + body


def decode_message(sock: socket.socket) -> Optional[Dict[str, Any]]:
    header = _recv_exact(sock, HEADER.size)
    if header is None:
        return None
    (length,) = HEADER.unpack(header)
    if length > 16 * 2**20:
        raise ValueError(f"message too large: {length}")
    body = _recv_exact(sock, length)
    return json.loads(body) if body is not None else None


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class SafetyMonitor:
    """Obstacle tracking + collision prediction
    (reference: SafetyMonitor, robot_interface.py:820-933)."""

    # Approximate physical radii per class family (reference per-class radii).
    CLASS_RADII_M = {"person": 0.4, "car": 1.2, "bicycle": 0.5, "dog": 0.3,
                     "chair": 0.4, "couch": 0.9, "default": 0.5}

    def __init__(self, config: RobotConfig):
        self.config = config
        self.obstacles: List[Dict[str, float]] = []

    def update_from_detections(
        self, detections, depth_hint_m: Optional[np.ndarray] = None
    ) -> None:
        """Build obstacle list from a Detections result. Without depth, distance
        is estimated from box height (pinhole approximation)."""
        self.obstacles = []
        h_img, w_img = detections.image_size
        for i in range(len(detections)):
            x1, y1, x2, y2 = detections.boxes[i]
            name = detections.class_names[i]
            box_h = max(y2 - y1, 1.0)
            # Pinhole estimate: assume ~1.6m object at full frame height ~1m away.
            distance = (
                float(depth_hint_m[i]) if depth_hint_m is not None
                else 1.6 * h_img / (box_h * 1.6)
            )
            bearing = ((x1 + x2) / 2 - w_img / 2) / (w_img / 2) * (np.pi / 4)
            self.obstacles.append(
                {
                    "class": name,
                    "distance_m": distance,
                    "bearing_rad": float(bearing),
                    "radius_m": self.CLASS_RADII_M.get(
                        name, self.CLASS_RADII_M["default"]
                    ),
                }
            )

    def check_trajectory(
        self, linear_v: float, angular_v: float, horizon_s: float = 1.0, steps: int = 10
    ) -> Dict[str, Any]:
        """Predict a straight/arc trajectory and check clearance
        (reference: robot_interface.py:857-933)."""
        min_clearance = float("inf")
        worst = None
        for k in range(1, steps + 1):
            t = horizon_s * k / steps
            theta = angular_v * t
            x = linear_v * t * np.cos(theta / 2)
            y = linear_v * t * np.sin(theta / 2)
            for obs in self.obstacles:
                ox = obs["distance_m"] * np.cos(obs["bearing_rad"])
                oy = obs["distance_m"] * np.sin(obs["bearing_rad"])
                clearance = float(np.hypot(ox - x, oy - y)) - obs["radius_m"]
                if clearance < min_clearance:
                    min_clearance = clearance
                    worst = obs
        emergency = min_clearance < self.config.emergency_distance_m
        unsafe = min_clearance < self.config.safety_distance_m
        return {
            "safe": not unsafe,
            "emergency": emergency,
            "min_clearance_m": min_clearance,
            "obstacle": worst,
        }

    def gate_command(self, cmd: RobotCommand) -> RobotCommand:
        """Clamp velocities; zero them on predicted collision."""
        cmd.linear_velocity = float(
            np.clip(cmd.linear_velocity, -self.config.max_linear_velocity,
                    self.config.max_linear_velocity)
        )
        cmd.angular_velocity = float(
            np.clip(cmd.angular_velocity, -self.config.max_angular_velocity,
                    self.config.max_angular_velocity)
        )
        if cmd.linear_velocity != 0.0 or cmd.angular_velocity != 0.0:
            check = self.check_trajectory(cmd.linear_velocity, cmd.angular_velocity)
            if check["emergency"]:
                return RobotCommand("emergency_stop", params={"reason": "collision"})
            if not check["safe"]:
                cmd.linear_velocity *= 0.3  # slow down in the caution band
                cmd.params["safety_slowdown"] = True
        return cmd


class RobotCommunication:
    """Socket channel with heartbeat + rate-limited queue
    (reference: RobotCommunication, robot_interface.py:200-818)."""

    def __init__(self, config: RobotConfig = RobotConfig()):
        self.config = config
        self.safety = SafetyMonitor(config)
        self._sock: Optional[socket.socket] = None
        self._transport: Optional[Any] = None  # ZMTPPairSocket | ROS2Topics
        self._queue: "queue.Queue[RobotCommand]" = queue.Queue(maxsize=32)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self.emergency_stopped = False
        self.commands_sent = 0
        self.heartbeats_sent = 0

    # ------------------------------------------------------------------
    def connect(self) -> bool:
        try:
            if self.config.protocol == Protocol.TCP:
                s = socket.create_connection(
                    (self.config.host, self.config.port),
                    timeout=self.config.connect_timeout_s,
                )
                self._sock = s
            elif self.config.protocol == Protocol.UDP:
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.connect((self.config.host, self.config.port))
                self._sock = s
            elif self.config.protocol == Protocol.ZMQ:
                from .transports import ZMTPPairSocket

                self._transport = ZMTPPairSocket.connect(
                    self.config.host, self.config.port,
                    timeout=self.config.connect_timeout_s,
                )
            else:  # ROS2
                from .transports import ROS2Topics

                self._transport = ROS2Topics(
                    host=self.config.host, port=self.config.port,
                    qos_depth=self.config.ros2_qos_depth,
                )
            return True
        except (OSError, ConnectionError):
            self._sock = None
            self._transport = None
            return False

    def start(self) -> bool:
        if not self.connect():
            return False
        self._stop.clear()
        sender = threading.Thread(target=self._send_loop, daemon=True)
        heart = threading.Thread(target=self._heartbeat_loop, daemon=True)
        self._threads = [sender, heart]
        for t in self._threads:
            t.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads = []
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None
            if self._transport is not None:
                try:
                    self._transport.close()
                finally:
                    self._transport = None

    # ------------------------------------------------------------------
    def _send_raw(self, payload: Dict[str, Any]) -> bool:
        with self._lock:
            if self._transport is not None:
                from .transports import ROS2Topics, ZMTPPairSocket

                try:
                    if isinstance(self._transport, ZMTPPairSocket):
                        # ZMTP frames carry their own length — no prefix.
                        self._transport.send(json.dumps(payload).encode())
                    else:
                        self._transport.publish(self.config.ros2_topic, payload)
                    return True
                except (OSError, ConnectionError):
                    return False
            if self._sock is None:
                return False
            try:
                self._sock.sendall(encode_message(payload))
                return True
            except OSError:
                return False

    def _send_loop(self) -> None:
        min_interval = 1.0 / self.config.command_rate_hz
        last = 0.0
        while not self._stop.is_set():
            try:
                cmd = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if self.emergency_stopped and cmd.command not in ("emergency_stop", "reset"):
                continue  # only e-stop/reset pass after an emergency
            wait = min_interval - (time.time() - last)
            if wait > 0:
                time.sleep(wait)
            if self._send_raw({"type": "command", **cmd.to_json()}):
                self.commands_sent += 1
                last = time.time()

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            if self._send_raw({"type": "heartbeat", "timestamp": time.time()}):
                self.heartbeats_sent += 1
            self._stop.wait(self.config.heartbeat_interval_s)

    # ------------------------------------------------------------------
    def send_command(self, cmd: RobotCommand) -> bool:
        """Safety-gate and enqueue a command (reference :530-567)."""
        gated = self.safety.gate_command(cmd)
        if gated.command == "emergency_stop":
            return self.emergency_stop(gated.params.get("reason", "safety"))
        try:
            self._queue.put_nowait(gated)
            return True
        except queue.Full:
            return False

    def emergency_stop(self, reason: str = "manual") -> bool:
        """Immediate, queue-bypassing stop (reference :517-528,743-774)."""
        self.emergency_stopped = True
        return self._send_raw(
            {"type": "command", "command": "emergency_stop",
             "linear_velocity": 0.0, "angular_velocity": 0.0,
             "params": {"reason": reason}, "timestamp": time.time()}
        )

    def reset_emergency(self) -> None:
        self.emergency_stopped = False


class CommandHandler:
    """Named command registry (reference: CommandHandler,
    robot_interface.py:954-1088)."""

    def __init__(self, comm: RobotCommunication):
        self.comm = comm
        self.handlers: Dict[str, Callable[..., RobotCommand]] = {}
        for name in ("move", "rotate", "stop", "follow", "avoid"):
            self.handlers[name] = getattr(self, f"_cmd_{name}")

    def register(self, name: str, fn: Callable[..., RobotCommand]) -> None:
        self.handlers[name] = fn

    def execute(self, name: str, **kwargs) -> bool:
        if name not in self.handlers:
            raise KeyError(f"unknown command: {name}")
        return self.comm.send_command(self.handlers[name](**kwargs))

    # ---------------- built-ins ----------------
    def _cmd_move(self, linear: float = 0.2, angular: float = 0.0) -> RobotCommand:
        return RobotCommand("move", linear, angular)

    def _cmd_rotate(self, angular: float = 0.5) -> RobotCommand:
        return RobotCommand("rotate", 0.0, angular)

    def _cmd_stop(self) -> RobotCommand:
        return RobotCommand("stop", 0.0, 0.0)

    def _cmd_follow(self, bearing_rad: float = 0.0, distance_m: float = 2.0
                    ) -> RobotCommand:
        angular = float(np.clip(bearing_rad, -1.0, 1.0))
        linear = 0.3 if distance_m > 1.5 else 0.0
        return RobotCommand("follow", linear, angular,
                            params={"distance_m": distance_m})

    def _cmd_avoid(self, bearing_rad: float = 0.0) -> RobotCommand:
        # Turn away from the obstacle bearing.
        return RobotCommand("avoid", 0.1, -float(np.sign(bearing_rad)) * 0.5)


def commands_from_detections(detections) -> List[DetectionCommand]:
    """Per-class action policy (reference: integration_demo.py:186-196 —
    person -> approach/follow; vehicles & furniture -> avoid)."""
    avoid_classes = {"car", "bus", "truck", "motorcycle", "bicycle", "chair",
                     "couch", "dining table", "bed"}
    out = []
    h_img, w_img = detections.image_size
    for i in range(len(detections)):
        name = detections.class_names[i]
        x1, _, x2, y2 = detections.boxes[i]
        bearing = float(((x1 + x2) / 2 - w_img / 2) / (w_img / 2) * (np.pi / 4))
        distance = float(1.6 * h_img / max(y2 - detections.boxes[i][1], 1.0) / 1.6)
        action = "follow" if name == "person" else (
            "avoid" if name in avoid_classes else "observe"
        )
        out.append(
            DetectionCommand(action, name, float(detections.scores[i]), bearing,
                             distance)
        )
    return out
