"""CF01 fixture: cfg plumbing missing at a sibling listener-start."""


class Bridge:
    def start_udp(self, host, port, n_readers, rcvbuf=0):
        pass

    def start_ssf_udp(self, host, port, n_readers, rcvbuf=0,
                      max_dgram=8192):
        pass


class Server:
    def __init__(self, cfg, bridge):
        self.cfg = cfg
        self.bridge = bridge

    def start(self):
        self.bridge.start_udp("0.0.0.0", 8126, 1,
                              rcvbuf=self.cfg.read_buffer_size_bytes)
        self.bridge.start_ssf_udp("0.0.0.0", 8128, 1,
                                  max_dgram=self.cfg.trace_max_length)
