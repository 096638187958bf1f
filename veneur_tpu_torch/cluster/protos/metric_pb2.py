# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: metric.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cmetric.proto\x12\x08metricpb"\xd5\x02\n\x06Metric\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04tags\x18\x02 \x03(\t\x12\x1c\n\x04type\x18\x03 \x01(\x0e2\x0e.metricpb.Type\x12)\n\x07counter\x18\x04 \x01(\x0b2\x16.metricpb.CounterValueH\x00\x12%\n\x05gauge\x18\x05 \x01(\x0b2\x14.metricpb.GaugeValueH\x00\x12-\n\thistogram\x18\x06 \x01(\x0b2\x18.metricpb.HistogramValueH\x00\x12!\n\x03set\x18\x07 \x01(\x0b2\x12.metricpb.SetValueH\x00\x122\n\x0cstatus_check\x18\t \x01(\x0b2\x1a.metricpb.StatusCheckValueH\x00\x12\x1e\n\x05scope\x18\x08 \x01(\x0e2\x0f.metricpb.Scope\x12\x10\n\x08hostname\x18\n \x01(\tB\x07\n\x05value"\x1d\n\x0cCounterValue\x12\r\n\x05value\x18\x01 \x01(\x03"\x1b\n\nGaugeValue\x12\r\n\x05value\x18\x01 \x01(\x01"5\n\x0eHistogramValue\x12#\n\x08t_digest\x18\x01 \x01(\x0b2\x11.metricpb.TDigest"\x98\x01\n\x07TDigest\x12%\n\tcentroids\x18\x01 \x03(\x0b2\x12.metricpb.Centroid\x12\x0b\n\x03min\x18\x02 \x01(\x01\x12\x0b\n\x03max\x18\x03 \x01(\x01\x12\x0b\n\x03sum\x18\x04 \x01(\x01\x12\r\n\x05count\x18\x05 \x01(\x01\x12\x16\n\x0ereciprocal_sum\x18\x06 \x01(\x01\x12\x18\n\x10packed_centroids\x18\x07 \x01(\x0c"(\n\x08Centroid\x12\x0c\n\x04mean\x18\x01 \x01(\x01\x12\x0e\n\x06weight\x18\x02 \x01(\x01"!\n\x08SetValue\x12\x15\n\rhyper_log_log\x18\x01 \x01(\x0c"3\n\x10StatusCheckValue\x12\x0e\n\x06status\x18\x01 \x01(\x01\x12\x0f\n\x07message\x18\x02 \x01(\t*R\n\x04Type\x12\x0b\n\x07Counter\x10\x00\x12\t\n\x05Gauge\x10\x01\x12\r\n\tHistogram\x10\x02\x12\x07\n\x03Set\x10\x03\x12\x0f\n\x0bStatusCheck\x10\x04\x12\t\n\x05Timer\x10\x05*)\n\x05Scope\x12\t\n\x05Mixed\x10\x00\x12\t\n\x05Local\x10\x01\x12\n\n\x06Global\x10\x02b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'metric_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TYPE._serialized_start=743
  _TYPE._serialized_end=825
  _SCOPE._serialized_start=827
  _SCOPE._serialized_end=868
  _METRIC._serialized_start=27
  _METRIC._serialized_end=368
  _COUNTERVALUE._serialized_start=370
  _COUNTERVALUE._serialized_end=399
  _GAUGEVALUE._serialized_start=401
  _GAUGEVALUE._serialized_end=428
  _HISTOGRAMVALUE._serialized_start=430
  _HISTOGRAMVALUE._serialized_end=483
  _TDIGEST._serialized_start=485
  _TDIGEST._serialized_end=611
  _CENTROID._serialized_start=613
  _CENTROID._serialized_end=653
  _SETVALUE._serialized_start=655
  _SETVALUE._serialized_end=688
  _STATUSCHECKVALUE._serialized_start=690
  _STATUSCHECKVALUE._serialized_end=741
# @@protoc_insertion_point(module_scope)
