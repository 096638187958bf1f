"""Cluster tier: forwarding, import server, proxy, discovery
(counterpart of veneur_tpu/cluster/).

  wire.py      <-> the samplers' Metric()/Export()/Combine() conversions
                   between engine exports and metricpb bytes
  forward.py   <-> flusher.go's forwardGRPC / flushForward (client side)
  importsrv.py <-> importsrv/server.go (global veneur gRPC receive)
  proxy.py     <-> proxysrv/server.go + proxy.go (consistent-hash fanout)
  discovery.py <-> discovery.go / consul.go (Discoverer interface)
"""
