"""Generated protobuf modules (protoc --python_out of metric.proto and
forward.proto; copies of veneur_tpu/cluster/protos/, with forward_pb2
importing metric_pb2 from this package).

Nothing is imported here: the pb2 modules import google.protobuf, so
`cluster/wire.py` imports them, and a DogStatsD-only server, which never
reaches the wire, loads no protobuf.
"""
