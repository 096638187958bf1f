"""The global tier's wire (counterpart of veneur_tpu/cluster/).

  wire.py   <-> the samplers' Metric()/Export()/Combine() conversions
              between engine exports and metricpb bytes

The forwarder, import server, proxy and discovery (ROADMAP queue A item
10.2) are not ported yet.
"""
