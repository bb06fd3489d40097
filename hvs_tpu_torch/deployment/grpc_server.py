"""gRPC serving over the authored protobuf schema.

Counterpart of ``hvs_tpu/deployment/grpc_server.py``: the same service
(``hvs_tpu.RobotVisionService``, so a client of either package calls a
server of the other), registered through
``grpc.method_handlers_generic_handler`` (no grpcio-tools at run time):

  * DetectSingle — unary detect on encoded image bytes
  * DetectBatch — client stream -> server stream
  * StreamDetections — bidirectional streaming
  * HandleCommand — ping / get_status / switch_model / update_config / stop_stream

The messages are the package's own copy of the generated
``proto/robot_vision_pb2.py`` (byte-identical to the reference's, so both
can register ``robot_vision.proto`` in one process). The logic is
``service.DetectionService``'s; boxes and image sizes are in the client's
original pixels.
"""

from __future__ import annotations

import time
from concurrent import futures
from typing import Iterator

from .proto import robot_vision_pb2 as pb
from .service import DetectionService, source_hw

SERVICE_NAME = "hvs_tpu.RobotVisionService"


class RobotVisionService:
    """The service bound to an ``InferenceEngine``."""

    def __init__(self, engine):
        self.engine = engine
        self.core = DetectionService(engine)

    def _detect(self, request: pb.DetectRequest) -> pb.DetectResponse:
        from ..inference.preprocessing import decode_jpeg

        t0 = time.perf_counter()
        image = decode_jpeg(request.image, self.engine.image_size)
        original_hw = None if image is None else source_hw(request.image, image)
        fields = self.core.detect(image, original_hw, request.request_id,
                                  request.score_threshold, t0)
        detections = [pb.Detection(**d) for d in fields.pop("detections", [])]
        return pb.DetectResponse(detections=detections, **fields)

    # ---------------- rpc methods ----------------
    def DetectSingle(self, request: pb.DetectRequest, context) -> pb.DetectResponse:
        return self._detect(request)

    def DetectBatch(self, request_iterator: Iterator[pb.DetectRequest], context
                    ) -> Iterator[pb.DetectResponse]:
        for request in request_iterator:
            yield self._detect(request)

    def StreamDetections(self, request_iterator, context):
        self.core.streams_active += 1
        try:
            for request in request_iterator:
                if self.core.stop_streams.is_set():
                    break
                yield self._detect(request)
        finally:
            self.core.streams_active -= 1

    def HandleCommand(self, request: pb.CommandRequest, context) -> pb.CommandResponse:
        return pb.CommandResponse(**self.core.command(request.command, dict(request.params)))


def _generic_handler(service: RobotVisionService):
    """Register the methods without grpcio-tools-generated service stubs."""
    import grpc

    rpcs = {
        "DetectSingle": grpc.unary_unary_rpc_method_handler(
            service.DetectSingle,
            request_deserializer=pb.DetectRequest.FromString,
            response_serializer=pb.DetectResponse.SerializeToString,
        ),
        "DetectBatch": grpc.stream_stream_rpc_method_handler(
            service.DetectBatch,
            request_deserializer=pb.DetectRequest.FromString,
            response_serializer=pb.DetectResponse.SerializeToString,
        ),
        "StreamDetections": grpc.stream_stream_rpc_method_handler(
            service.StreamDetections,
            request_deserializer=pb.DetectRequest.FromString,
            response_serializer=pb.DetectResponse.SerializeToString,
        ),
        "HandleCommand": grpc.unary_unary_rpc_method_handler(
            service.HandleCommand,
            request_deserializer=pb.CommandRequest.FromString,
            response_serializer=pb.CommandResponse.SerializeToString,
        ),
    }
    return grpc.method_handlers_generic_handler(SERVICE_NAME, rpcs)


class RobotGRPCServer:
    """gRPC server with keepalive and message-size options."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 50051,
                 max_workers: int = 4, max_message_mb: int = 32):
        import grpc

        self.service = RobotVisionService(engine)
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_send_message_length", max_message_mb * 2**20),
                ("grpc.max_receive_message_length", max_message_mb * 2**20),
                ("grpc.keepalive_time_ms", 30_000),
                ("grpc.keepalive_timeout_ms", 10_000),
            ],
        )
        self.server.add_generic_rpc_handlers((_generic_handler(self.service),))
        self.address = f"{host}:{port}"
        self.port = self.server.add_insecure_port(self.address)

    def start(self) -> int:
        self.server.start()
        return self.port

    def stop(self, grace: float = 2.0) -> None:
        self.server.stop(grace).wait()

    def wait(self) -> None:
        self.server.wait_for_termination()


class RobotVisionClient:
    """Hand-written client for the service (tests and robot-side code)."""

    def __init__(self, address: str):
        import grpc

        self.channel = grpc.insecure_channel(address)
        self._detect = self.channel.unary_unary(
            f"/{SERVICE_NAME}/DetectSingle",
            request_serializer=pb.DetectRequest.SerializeToString,
            response_deserializer=pb.DetectResponse.FromString,
        )
        self._batch = self.channel.stream_stream(
            f"/{SERVICE_NAME}/DetectBatch",
            request_serializer=pb.DetectRequest.SerializeToString,
            response_deserializer=pb.DetectResponse.FromString,
        )
        self._command = self.channel.unary_unary(
            f"/{SERVICE_NAME}/HandleCommand",
            request_serializer=pb.CommandRequest.SerializeToString,
            response_deserializer=pb.CommandResponse.FromString,
        )

    def detect(self, image_bytes: bytes, request_id: str = "") -> pb.DetectResponse:
        return self._detect(pb.DetectRequest(image=image_bytes, request_id=request_id))

    def detect_batch(self, images: Iterator[bytes]):
        reqs = (pb.DetectRequest(image=b, request_id=str(i)) for i, b in enumerate(images))
        return self._batch(reqs)

    def command(self, command: str, **params) -> pb.CommandResponse:
        return self._command(
            pb.CommandRequest(command=command, params={k: str(v) for k, v in params.items()})
        )

    def close(self) -> None:
        self.channel.close()
