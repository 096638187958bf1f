"""RS01 good fixture: the egress of rs01_bad.py through the resilience
layer. This docstring may name urlopen and insecure_channel."""

from veneur_tpu_torch.resilience import Egress, grpc_channel


def good_http_post(req):
    return Egress("http://collector").post(req)


def good_grpc_channel(address):
    return grpc_channel(address)
