# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: forward.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import metric_pb2 as metric__pb2  # registers metric.proto first


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rforward.proto\x12\nforwardrpc\x1a\x0cmetric.proto"\xd3\x01\n\x08Envelope\x12\x11\n\tsender_id\x18\x01 \x01(\t\x12\x14\n\x0cinterval_seq\x18\x02 \x01(\x04\x12\x13\n\x0bchunk_index\x18\x03 \x01(\r\x12\x13\n\x0bchunk_count\x18\x04 \x01(\r\x12\x19\n\x08trace_id\x18\x05 \x01(\x04R\x07traceId\x12\x17\n\x07span_id\x18\x06 \x01(\x04R\x06spanId\x12*\n\x11interval_close_ns\x18\x07 \x01(\x04R\x0fintervalCloseNs\x12\x14\n\x0cforward_kind\x18\x08 \x01(\r"\xa2\x01\n\nMetricList\x12!\n\x07metrics\x18\x01 \x03(\x0b2\x10.metricpb.Metric\x12&\n\x08envelope\x18\x02 \x01(\x0b2\x14.forwardrpc.Envelope\x121\n\x0fprefix_sketches\x18\x03 \x03(\x0b2\x18.forwardrpc.PrefixSketch\x12\x16\n\x0esketch_engines\x18\x04 \x01(\t"\x07\n\x05Empty"1\n\x0cPrefixSketch\x12\x0e\n\x06prefix\x18\x01 \x01(\t\x12\x11\n\tregisters\x18\x02 \x01(\x0c2{\n\x07Forward\x128\n\x0bSendMetrics\x12\x16.forwardrpc.MetricList\x1a\x11.forwardrpc.Empty\x126\n\rSendMetricsV2\x12\x10.metricpb.Metric\x1a\x11.forwardrpc.Empty(\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'forward_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
# @@protoc_insertion_point(module_scope)
