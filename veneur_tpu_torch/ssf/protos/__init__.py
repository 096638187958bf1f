"""Generated protobuf module for SSF (protoc --python_out of ssf.proto;
a copy of veneur_tpu/ssf/protos/ssf_pb2.py).

Nothing is imported here: `ssf_pb2` imports google.protobuf, so the
modules that handle a span import `veneur_tpu_torch.ssf.protos.ssf_pb2`
inside the function that needs it, and a DogStatsD-only server never
loads protobuf.
"""
