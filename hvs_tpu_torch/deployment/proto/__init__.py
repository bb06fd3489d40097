"""The gRPC schema (``robot_vision.proto``) and its generated messages, a
byte-identical copy of the reference's."""
